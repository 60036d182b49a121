"""Observability of the PyTorch port (counterpart of ``repro.obs``,
DESIGN.md §15).

``registry`` — catalog-enforced counters/gauges/histograms
(:data:`METRIC_CATALOG`, the reference's, is the single source of metric
names; ``repro_torch.analysis.codelint`` checks every literal against it).
``telemetry`` — the opt-in :class:`Telemetry` hook ``EngineCore`` drives
(``telemetry=`` / ``CACHEFLOW_TELEMETRY=1`` / ``serve --telemetry``).
``spans`` — wall-clock spans at the served path's layer boundaries
(``with obs.span(name, rid):``; names in :data:`SPAN_CATALOG`), recorded on
``tel.spans`` while a :class:`Telemetry` is attached to ``EngineCore.run``.
``timeline`` — the Perfetto/Chrome trace-event exporter
(``python -m repro_torch.obs.timeline trace.json``).
"""
from repro_torch.obs.registry import (METRIC_CATALOG, SPAN_CATALOG, Counter,
                                      Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.spans import NULL_SPAN, SpanRecorder, span
from repro_torch.obs.telemetry import Telemetry, telemetry_env_enabled
from repro_torch.obs.timeline import ops_to_chrome, trace_to_chrome

__all__ = [
    "METRIC_CATALOG", "SPAN_CATALOG", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_SPAN", "SpanRecorder", "span", "Telemetry",
    "telemetry_env_enabled", "ops_to_chrome", "trace_to_chrome",
]
