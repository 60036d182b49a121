"""Opt-in engine telemetry: the observation twin of the sanitizer (a copy
of ``repro.obs.telemetry``).

``EngineCore(telemetry=True)`` (or ``CACHEFLOW_TELEMETRY=1`` in the
environment, or ``serve --telemetry``) attaches a :class:`Telemetry`
instance to the event loop.  Every hook in the engine is behind an
``if tel is not None`` guard, so the default-off path adds zero work —
and the hooks themselves are PURE OBSERVERS: they read loop state, never
mutate it, so a telemetry-enabled run is bit-identical to a disabled one
on ``EngineResult`` and ``ops_log`` (property-tested in
``tests/test_torch_telemetry.py``).

What it collects, on the engine clock (virtual seconds in sim, measured
wall seconds in real mode):

  * queue depth / active batch size as ``(t, value)`` series,
  * admitted- and decode-batch-size histograms,
  * benefit-gate and prefetch-gate outcomes, preempt/evict/abort counts,
  * per-resource busy seconds and (real mode) measured per-channel GB/s
    from the fused datapath's ``TransferStream`` counters,
  * storage-tier occupancy bytes and the hit/miss/promote/demote counters
    from whichever KV store the engine runs against,
  * per-request phase-transition timestamps
    (arrive → admit → restored → first_token → finish, plus
    preempt/resume), the raw material for the timeline's flow events,
  * on the wall clock, not the engine's: the spans of the served path's
    layer boundaries (``tel.spans``, ``obs/spans.py``), which real-mode
    sites record while this telemetry's run is on.

``snapshot()`` is the exposition API: a plain-JSON dict carried by
``ServingReport.telemetry``, written by ``serve --metrics-out`` and
consumed by the benchmarks.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.spans import SpanRecorder


def telemetry_env_enabled() -> bool:
    """The ``CACHEFLOW_TELEMETRY`` opt-in, same convention as the
    sanitizer's ``CACHEFLOW_SANITIZE``."""
    return os.environ.get(
        "CACHEFLOW_TELEMETRY", "0").lower() not in ("", "0", "false")


class Telemetry:
    """One engine run's metric collection.  Constructed fresh by
    ``EngineCore.run`` (or passed in pre-built); ``begin`` binds the core
    so run-end sweeps can read the KV store and datapath counters."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        self.spans = SpanRecorder()
        self.core = None
        # rid -> [[t, phase], ...] in engine order; phases are the
        # lifecycle edges: arrive, admit, preempt, resume, restored,
        # first_token, finish
        self.phases: Dict[str, List[list]] = {}
        self._arrival: Dict[str, float] = {}
        self._admit_t: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def begin(self, core) -> None:
        self.core = core

    def _phase(self, now: float, rid: str, phase: str) -> None:
        self.phases.setdefault(rid, []).append([now, phase])
        self.registry.counter(
            "engine.phase_transitions_total", phase=phase).inc()

    def _sample_queues(self, now: float, queued: int, active: int) -> None:
        self.registry.gauge("engine.queue_depth").set(queued, t=now)
        self.registry.gauge("engine.active_requests").set(active, t=now)

    def _sample_tiers(self, now: float) -> None:
        """Read-only tier-occupancy sample at a lifecycle edge (this is
        what the timeline renders as the HBM-bytes counter track)."""
        pc = getattr(self.core.kvstore, "core", None) if self.core else None
        tiers = getattr(pc, "tiers", None)
        if not tiers:
            return
        for name, tier in tiers.items():
            self.registry.gauge(
                "storage.tier_used_bytes", tier=name).set(tier.used, t=now)

    # ---- engine hooks (every call site is behind `if tel is not None`) --
    def on_arrive(self, now: float, rid: str, *, queued: int,
                  active: int) -> None:
        self._arrival[rid] = now
        self._phase(now, rid, "arrive")
        self._sample_queues(now, queued, active)

    def on_admit(self, now: float, rid: str, *, queued: int,
                 active: int) -> None:
        self._admit_t[rid] = now
        self._phase(now, rid, "admit")
        self.registry.counter("engine.admissions_total").inc()
        self.registry.histogram("engine.admitted_batch_size").observe(active)
        self._sample_queues(now, queued, active)
        self._sample_tiers(now)

    def on_dispatch(self, now: float, resource: str, op, dur: float) -> None:
        self.registry.counter("engine.dispatches_total", kind=op.kind).inc()

    def on_decode_dispatch(self, now: float, dur: float,
                           rids: List[str]) -> None:
        self.registry.counter("engine.decode_steps_total").inc()
        self.registry.histogram("engine.decode_batch_size").observe(len(rids))

    def on_gate(self, now: float, rid: str, allowed: bool) -> None:
        self.registry.counter(
            "engine.gate_outcomes_total",
            outcome="allowed" if allowed else "denied").inc()

    def on_prefetch_gate(self, now: float, rid: str, allowed: bool) -> None:
        self.registry.counter(
            "engine.prefetch_gate_total",
            outcome="allowed" if allowed else "denied").inc()

    def on_abort(self, now: float, resource: str, op) -> None:
        # resource label is the KIND (comp/io), not the instance — bounded
        # cardinality regardless of channel count
        kind = "io" if resource.startswith("io") else "comp"
        self.registry.counter("engine.aborts_total", resource=kind).inc()

    def on_preempt(self, now: float, rid: str, *, evict: bool,
                   aborted_ops: int) -> None:
        self.registry.counter(
            "engine.preemptions_total",
            mode="evict" if evict else "park").inc()
        if aborted_ops:
            # the victim's in-flight ops become waste the moment the claim
            # is released (their completion events just free the resource)
            self.registry.counter(
                "engine.aborts_total", resource="preempt").inc(aborted_ops)
        self._phase(now, rid, "preempt")
        self._sample_tiers(now)

    def on_resume(self, now: float, rid: str) -> None:
        self._phase(now, rid, "resume")

    def on_restore_done(self, now: float, rid: str) -> None:
        self._phase(now, rid, "restored")
        start = self._admit_t.get(rid)
        if start is not None:
            self.registry.histogram(
                "engine.restore_seconds").observe(now - start)
        self._sample_tiers(now)

    def on_first_token(self, now: float, rid: str) -> None:
        self._phase(now, rid, "first_token")
        arr = self._arrival.get(rid)
        if arr is not None:
            self.registry.histogram("engine.ttft_seconds").observe(now - arr)

    def on_finish(self, now: float, rid: str, *, queued: int,
                  active: int) -> None:
        self._phase(now, rid, "finish")
        self._sample_queues(now, queued, active)
        self._sample_tiers(now)

    # ------------------------------------------------------------------
    def on_run_end(self, result) -> None:
        """Run-end sweep: per-resource busy seconds from the ops log (a
        pure function of the result, so it matches the engine's own
        accounting), measured per-channel bandwidth from the datapath's
        transfer streams, and the storage layer's counters."""
        busy: Dict[str, float] = {}
        for t0, t1, resource, desc in result.ops_log:
            if not desc.endswith(":aborted"):
                busy[resource] = busy.get(resource, 0.0) + (t1 - t0)
        for resource in sorted(busy):
            self.registry.gauge(
                "engine.resource_busy_seconds",
                resource=resource).set(busy[resource])
        self._sweep_datapath()
        self._sweep_storage()

    def _sweep_datapath(self) -> None:
        """Real mode: the fused datapath's per-channel ``TransferStream``s
        carry measured bytes and seconds — the serve observable behind the
        paper's per-channel bandwidth claims."""
        dp = getattr(getattr(self.core, "backend", None), "executor", None)
        dp = getattr(dp, "datapath", None)
        if dp is None:
            return
        self.registry.counter(
            "datapath.kernel_launches_total").inc(dp.kernel_launches)
        for c, (stream, bw) in enumerate(zip(dp.streams, dp.bandwidths())):
            self.registry.counter(
                "datapath.channel_bytes_total",
                channel=str(c)).inc(stream.bytes_moved)
            if bw:
                self.registry.gauge(
                    "datapath.channel_gbps",
                    channel=str(c)).set(bw / 1e9)

    def _sweep_storage(self) -> None:
        ks = getattr(self.core, "kvstore", None)
        if ks is None:
            return
        events = self.registry.counter
        # shared placement core: tier occupancy + promote/demote/drop
        pc = getattr(ks, "core", None)
        tiers = getattr(pc, "tiers", None)
        if tiers:
            for name, tier in tiers.items():
                self.registry.gauge(
                    "storage.tier_used_bytes", tier=name).set(tier.used)
                self.registry.gauge(
                    "storage.tier_capacity_bytes",
                    tier=name).set(tier.capacity)
            events("storage.events_total",
                   event="promote").inc(pc.promotions)
            events("storage.events_total", event="demote").inc(pc.demotions)
            events("storage.events_total", event="drop").inc(pc.drops)
        for attr, label in (("io_hits", "hit"), ("store_misses", "miss"),
                            ("dedup_hits", "dedup_hit"), ("forks", "fork"),
                            ("fetches", "fetch"),
                            ("skipped_transfers", "skipped_transfer")):
            v = getattr(ks, attr, None)
            if v is not None:
                events("storage.events_total", event=label).inc(v)
        for attr, label in (("bytes_put", "put"),
                            ("bytes_transferred", "transferred")):
            v = getattr(ks, attr, None)
            if v is not None:
                events("storage.bytes_total", op=label).inc(v)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """The exposition API: plain-JSON metrics + per-request phase
        timestamps.  Carried by ``ServingReport.telemetry``, written by
        ``serve --metrics-out``, consumed by the benchmarks and the
        timeline exporter's counter tracks.  A ``"spans"`` key (the span
        tuples as lists, and the runs' clock anchors) only when a span was
        recorded, so a simulation's snapshot is the reference's."""
        out = {"metrics": self.registry.snapshot(),
               "phases": {rid: [list(p) for p in edges]
                          for rid, edges in sorted(self.phases.items())}}
        if self.spans:
            out["spans"] = {"records": [list(s) for s in self.spans],
                            "anchors": [list(a) for a in self.spans.anchors]}
        return out
