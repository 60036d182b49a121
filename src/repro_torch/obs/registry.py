"""Engine-wide metrics registry of the PyTorch port (a copy of
``repro.obs.registry``, DESIGN.md §15).

Three primitive types, all driven by the ENGINE clock (virtual seconds in
sim, measured wall seconds in real mode — whatever ``EngineCore.run``'s
``now`` is):

  * :class:`Counter`   — monotone non-decreasing accumulator.
  * :class:`Gauge`     — last-value sample; when a timestamp is supplied the
    gauge additionally keeps its full ``(t, value)`` series, which is what
    the timeline exporter renders as Perfetto counter tracks.
  * :class:`Histogram` — fixed EXACT bucket boundaries declared in the
    catalog (never derived from data, so two runs' histograms always merge
    bucket-for-bucket); invariant: ``count == sum(bucket_counts)``.

Every metric name must be declared in :data:`METRIC_CATALOG` with its type,
label schema and owning layer — ``repro_torch.analysis.codelint`` statically
checks that every metric-name literal in the port is registered here (the same
pattern as the ``EVENT_KINDS`` trace-schema rule), and the registry enforces
the type and exact label keys at instantiation time.  Wall-clock span names
(``obs/spans.py``, the port's own, not the reference's) are declared the
same way in :data:`SPAN_CATALOG`.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

#: Exact-bucket boundaries shared by the latency histograms (seconds).
_LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                    60.0, 120.0)
#: Batch-size histogram boundaries (requests per admitted/decode batch).
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

#: The central metric catalog: name -> {type, labels, layer[, buckets]}.
#: ``layer`` names the module that owns the signal (mirrors DESIGN.md §14's
#: invariant catalog).  This dict is a PURE LITERAL — codelint parses it
#: from the AST, so no computed keys.
METRIC_CATALOG = {
    # ---- engine core (core/engine_core.py) ----
    "engine.queue_depth": {
        "type": "gauge", "labels": (), "layer": "core/engine_core"},
    "engine.active_requests": {
        "type": "gauge", "labels": (), "layer": "core/engine_core"},
    "engine.admitted_batch_size": {
        "type": "histogram", "labels": (), "layer": "core/engine_core",
        "buckets": _BATCH_BUCKETS},
    "engine.decode_batch_size": {
        "type": "histogram", "labels": (), "layer": "core/engine_core",
        "buckets": _BATCH_BUCKETS},
    "engine.admissions_total": {
        "type": "counter", "labels": (), "layer": "core/engine_core"},
    "engine.preemptions_total": {
        "type": "counter", "labels": ("mode",), "layer": "core/engine_core"},
    "engine.aborts_total": {
        "type": "counter", "labels": ("resource",),
        "layer": "core/engine_core"},
    "engine.gate_outcomes_total": {
        "type": "counter", "labels": ("outcome",),
        "layer": "core/engine_core"},
    "engine.prefetch_gate_total": {
        "type": "counter", "labels": ("outcome",),
        "layer": "core/engine_core"},
    "engine.dispatches_total": {
        "type": "counter", "labels": ("kind",), "layer": "core/engine_core"},
    "engine.decode_steps_total": {
        "type": "counter", "labels": (), "layer": "core/engine_core"},
    "engine.resource_busy_seconds": {
        "type": "gauge", "labels": ("resource",),
        "layer": "core/engine_core"},
    "engine.ttft_seconds": {
        "type": "histogram", "labels": (), "layer": "core/engine_core",
        "buckets": _LATENCY_BUCKETS},
    "engine.restore_seconds": {
        "type": "histogram", "labels": (), "layer": "core/engine_core",
        "buckets": _LATENCY_BUCKETS},
    "engine.phase_transitions_total": {
        "type": "counter", "labels": ("phase",),
        "layer": "core/engine_core"},
    # ---- restoration data path (core/datapath.py) ----
    "datapath.channel_gbps": {
        "type": "gauge", "labels": ("channel",), "layer": "core/datapath"},
    "datapath.channel_bytes_total": {
        "type": "counter", "labels": ("channel",), "layer": "core/datapath"},
    "datapath.kernel_launches_total": {
        "type": "counter", "labels": (), "layer": "core/datapath"},
    # ---- storage tiers (storage/placement.py, storage/chunkstore.py) ----
    "storage.tier_used_bytes": {
        "type": "gauge", "labels": ("tier",), "layer": "storage/placement"},
    "storage.tier_capacity_bytes": {
        "type": "gauge", "labels": ("tier",), "layer": "storage/placement"},
    "storage.events_total": {
        "type": "counter", "labels": ("event",),
        "layer": "storage/chunkstore"},
    "storage.bytes_total": {
        "type": "counter", "labels": ("op",), "layer": "storage/chunkstore"},
}


#: The engine loop's top-level ops that end by waiting for the device.
_SYNCED_OPS = ("engine.restore_compute", "engine.restore_load",
               "engine.suffix_prefill", "engine.decode_step")
_LOAD_OPS = ("engine.restore_load", "engine.restore_load_hit")

#: The span catalog (``obs/spans.py``): name -> {layer, parent, wait}.
#: ``parent`` holds the names a span may nest in, () for a top-level op of
#: the engine loop (a ``RealBackend`` call); ``wait`` marks a span in which
#: the host blocks until the device has run what it issued.  A PURE LITERAL
#: like METRIC_CATALOG: codelint's span-catalog rule parses its keys.
SPAN_CATALOG = {
    # ---- engine core (core/engine_core.py, RealBackend) ----
    "engine.admit": {"layer": "core/engine_core", "parent": (), "wait": False},
    "engine.restore_compute": {
        "layer": "core/engine_core", "parent": (), "wait": False},
    "engine.restore_load": {
        "layer": "core/engine_core", "parent": (), "wait": False},
    "engine.restore_load_hit": {
        "layer": "core/engine_core", "parent": (), "wait": False},
    "engine.restore_done": {
        "layer": "core/engine_core", "parent": (), "wait": False},
    "engine.suffix_prefill": {
        "layer": "core/engine_core", "parent": (), "wait": False},
    "engine.decode_step": {
        "layer": "core/engine_core", "parent": (), "wait": False},
    "engine.device_wait": {
        "layer": "core/engine_core", "parent": _SYNCED_OPS, "wait": True},
    # ---- executor (core/executor.py) ----
    "executor.compute": {
        "layer": "core/executor", "parent": ("engine.restore_compute",),
        "wait": False},
    "executor.prefill": {
        "layer": "core/executor", "parent": ("engine.suffix_prefill",),
        "wait": False},
    # a decode step's forward and token read: one each, of its rows (rid
    # None, count the rows), where the model decodes rows together; one each
    # a request (count None) on the per-request loop
    "executor.decode_forward": {
        "layer": "core/executor", "parent": ("engine.decode_step",),
        "wait": False},
    "executor.paged_write": {
        "layer": "core/executor",
        "parent": ("engine.decode_step", "engine.suffix_prefill"),
        "wait": False},
    "executor.token_read": {
        "layer": "core/executor",
        "parent": ("engine.decode_step", "engine.suffix_prefill"),
        "wait": True},
    # ---- model (models/transformer.py) ----
    # one MoE FFN call (count: its tokens), in whichever executor op ran the
    # layer
    "model.moe": {
        "layer": "models/moe",
        "parent": ("executor.decode_forward", "executor.compute", "executor.prefill"),
        "wait": False},
    # ---- restoration data path (core/datapath.py) ----
    "datapath.restore_op": {
        "layer": "core/datapath", "parent": _LOAD_OPS, "wait": False},
    "datapath.pack": {
        "layer": "core/datapath", "parent": ("datapath.restore_op",),
        "wait": False},
    "datapath.ring_wait": {
        "layer": "core/datapath", "parent": ("datapath.restore_op",),
        "wait": True},
    "datapath.put": {
        "layer": "core/datapath", "parent": ("datapath.restore_op",),
        "wait": False},
    "datapath.scatter": {
        "layer": "core/datapath", "parent": ("datapath.restore_op",),
        "wait": False},
    "datapath.promote": {
        "layer": "core/datapath", "parent": ("datapath.restore_op",),
        "wait": False},
    "datapath.measure_wait": {
        "layer": "core/datapath", "parent": ("datapath.restore_op",),
        "wait": True},
    # ---- chunk store (storage/chunkstore.py) ----
    "store.fetch": {
        "layer": "storage/chunkstore", "parent": _LOAD_OPS, "wait": False},
    "store.promote_staged": {
        "layer": "storage/chunkstore", "parent": ("datapath.promote",),
        "wait": False},
}


def _label_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator.  ``inc`` rejects negative deltas — a counter
    that can go down is a gauge wearing the wrong hat."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError(
                f"counter {self.name}: negative increment {delta}")
        self.value += delta


class Gauge:
    """Last-value sample; ``set(v, t=...)`` additionally appends to the
    gauge's ``(t, value)`` series (the timeline exporter's counter-track
    source).  Timestamps are engine-clock seconds."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self.series: List[Tuple[float, float]] = []

    def set(self, value: float, t: Optional[float] = None) -> None:
        self.value = float(value)
        if t is not None:
            self.series.append((float(t), float(value)))


class Histogram:
    """Fixed exact-boundary histogram: ``buckets`` are the declared upper
    bounds; observations land in the first bucket whose bound is >= value,
    or the overflow slot.  ``count == sum(bucket_counts)`` always."""

    def __init__(self, name: str, buckets: Iterable[float]):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(buckets)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError(
                f"histogram {self.name}: buckets must be sorted, non-empty")
        # one slot per declared bound + the overflow slot
        self.bucket_counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        self.bucket_counts[i] += 1
        self.count += 1
        self.sum += float(value)


class MetricsRegistry:
    """Catalog-enforced metric factory.

    ``counter(name, **labels)`` / ``gauge(...)`` / ``histogram(...)`` return
    the live instance for that (name, labels) cell, creating it on first
    use.  The name must be declared in :data:`METRIC_CATALOG` with the
    matching type, and the label KEYS must equal the catalog's label schema
    exactly — silent cardinality drift is how metric layers rot."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind: str, labels: Dict[str, str]):
        spec = METRIC_CATALOG.get(name)
        if spec is None:
            raise KeyError(f"metric {name!r} is not in METRIC_CATALOG")
        if spec["type"] != kind:
            raise TypeError(f"metric {name!r} is a {spec['type']}, "
                            f"requested as {kind}")
        if tuple(sorted(labels)) != tuple(sorted(spec["labels"])):
            raise ValueError(
                f"metric {name!r}: labels {sorted(labels)} != declared "
                f"schema {sorted(spec['labels'])}")
        key = _label_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            if kind == "counter":
                m = Counter(key)
            elif kind == "gauge":
                m = Gauge(key)
            else:
                m = Histogram(key, spec["buckets"])
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(name, "counter", labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(name, "gauge", labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get(name, "histogram", labels)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-JSON view: the exposition format ``ServingReport.telemetry``
        and ``serve --metrics-out`` carry.  Gauge series ride along so the
        timeline exporter can render counter tracks offline."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for key in sorted(self._metrics):
            m = self._metrics[key]
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = {
                    "value": m.value,
                    "series": [[t, v] for t, v in m.series]}
            else:
                out["histograms"][key] = {
                    "buckets": list(m.bounds),
                    "bucket_counts": list(m.bucket_counts),
                    "count": m.count, "sum": m.sum}
        return out
