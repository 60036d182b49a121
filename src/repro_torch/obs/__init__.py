"""Observability of the PyTorch port (counterpart of ``repro.obs``,
DESIGN.md §15).

Ported so far: ``timeline`` — the Perfetto/Chrome trace-event exporter
(``python -m repro_torch.obs.timeline trace.json``).  The metrics registry
and the ``Telemetry`` hook are not ported yet (``EngineCore`` raises when
asked for telemetry).
"""
from repro_torch.obs.timeline import ops_to_chrome, trace_to_chrome

__all__ = ["ops_to_chrome", "trace_to_chrome"]
