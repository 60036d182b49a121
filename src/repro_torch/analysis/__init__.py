"""Correctness tooling of the PyTorch port (counterpart of
``repro.analysis``, DESIGN.md §14).

Three detectors, as in the reference:

  * :mod:`repro_torch.analysis.sanitizer` — runtime:
    ``EngineCore(sanitize=True)`` (or ``CACHEFLOW_SANITIZE=1``) checks every
    scheduling event against the engine's invariants and raises a
    :class:`~repro_torch.analysis.sanitizer.SanitizerViolation` at the first
    drift.
  * :mod:`repro_torch.analysis.trace_lint` — offline: lints a captured
    ``ScheduleTrace`` JSON (``python -m repro_torch.analysis.lint_trace
    x.json``).
  * :mod:`repro_torch.analysis.codelint` — static: the port's own AST rules
    (``python -m repro_torch.analysis.codelint``).

The engine imports the sanitizer only when sanitizing is on.
"""
from repro_torch.analysis.sanitizer import EngineSanitizer, SanitizerViolation
from repro_torch.analysis.trace_lint import LintFinding, lint_trace

__all__ = ["EngineSanitizer", "SanitizerViolation", "LintFinding",
           "lint_trace"]
