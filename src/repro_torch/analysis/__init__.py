"""Correctness tooling of the PyTorch port (counterpart of
``repro.analysis``, DESIGN.md §14).

Ported so far: :mod:`repro_torch.analysis.trace_lint`, the offline linter of
captured ``ScheduleTrace`` JSON (``python -m repro_torch.analysis.lint_trace
x.json``).  The runtime sanitizer is not ported yet (``EngineCore`` raises
when asked for it), and the static ``codelint`` pass scans the reference
package only.
"""
from repro_torch.analysis.trace_lint import LintFinding, lint_trace

__all__ = ["LintFinding", "lint_trace"]
