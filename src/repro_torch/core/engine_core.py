"""Backend-agnostic batched request-lifecycle engine core.

One event loop drives the paper's ``BatchScheduler`` (Algorithm 1) over a
batch of concurrent requests through their WHOLE serving lifecycle:

    RESTORING -> PREFILL -> DECODE -> DONE

  * RESTORING — the 3D two-pointer restoration of the cached prefix
    (per-stage compute resources + shared I/O channels, §3.3).
  * PREFILL   — one suffix-prefill op per pipeline stage (in stage order),
    competing FCFS with other requests' restoration chunks on the same
    stage compute; its completion is the request's FIRST TOKEN.
  * DECODE    — a recurring batched decode op on a dedicated decode-batch
    resource steps *all* decode-phase requests together, one token per
    step; the last step is the request's FINISH.

The loop owns every scheduling concern:

  * continuous-batching admission (``max_active``) — a slot is held for the
    whole lifecycle and freed at DECODE completion, not restore completion;
    a mid-flight retire refills its slot immediately, so arriving requests
    restore AGAINST the live decode batch (``admission="gang"`` is the
    run-to-completion baseline: the next batch joins only at batch close),
  * queued-request prefetch (``prefetch=True``) — idle channel time
    promotes the admission queue's chunks up a storage tier ahead of
    admission (the queue is a known lookahead window),
  * one compute resource per pipeline stage (chunk recomputes and suffix
    prefills serialize on the stage's chips),
  * ``io_channels`` shared transfer channels (contention = queueing, §3.3),
  * per-channel slowdown / failure injection (failed transfers release their
    claim and are rescheduled — restoration ops are idempotent),
  * ``TieredKVStore`` integration: per-request bandwidth lookup at dispatch
    time, LRU ``touch`` on admission and ``promote`` on restore completion.

What an op *costs* — virtual seconds from a ``CostModel`` or measured wall
seconds of real PyTorch execution — is delegated to a pluggable backend:

  * ``SimBackend``  — advances virtual time analytically; the discrete-event
    simulator (``RestorationSimulator``) is a thin facade over it.
  * ``RealBackend`` — executes each dispatched op on device through a
    ``RestorationExecutor`` and feeds measured (or synthetic, for
    interleaving tests) durations back into the same loop.

Because both backends run the *identical* admission/dispatch logic, the
simulator measures exactly the schedule whose correctness the real backend
proves — including multi-request interleavings across all phases.

Requests with ``new_len == 0`` and ``decode_len == 0`` are restoration-only:
their lifecycle collapses to RESTORING -> DONE and the loop behaves exactly
as the pre-lifecycle core (``RestorationSimulator`` / ``.restore()``).
"""
from __future__ import annotations

import heapq
import itertools
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.cost_model import CostModel
from repro_torch.core.plans import RequestPlan
from repro_torch.core.scheduler import BatchScheduler, ScheduledOp


@dataclass
class EngineRequest:
    """A request as the engine core sees it: identity, prefix length,
    arrival time, one RequestPlan per pipeline stage, its lifecycle extent
    — suffix tokens to prefill and output tokens to generate — and its SLO
    class: ``priority`` (higher = more urgent) and ``deadline`` (engine-
    clock instant the first token is wanted by; ``inf`` = best-effort).
    The engine's preemption policy compares these at admission pressure."""
    request_id: str
    n_tokens: int                   # prefix to restore
    arrival: float = 0.0
    plans: List[RequestPlan] = field(default_factory=list)  # one per stage
    new_len: int = 0                # fresh suffix tokens (0 = restore-only)
    decode_len: int = 0             # output tokens (first from prefill)
    priority: int = 0               # SLO class (preempt="priority")
    deadline: float = math.inf      # first-token SLO (preempt="deadline")


@dataclass
class EngineResult:
    restore_finish: Dict[str, float]
    restore_start: Dict[str, float]
    first_token: Dict[str, float]   # suffix prefill done (TTFT reference)
    finish: Dict[str, float]        # lifecycle complete (slot freed here)
    makespan: float
    compute_busy: float             # fraction of makespan, averaged over stages
    io_busy: float                  # fraction, averaged over channels
    decode_busy: float              # decode-batch resource busy fraction
    decode_steps: int               # batched decode steps executed
    ops_log: List[Tuple[float, float, str, str]]  # (start, end, resource, op-desc)
    # rid -> times its restoration was suspended (preempt="priority"|
    # "deadline"); aborted/preempted op time is EXCLUDED from the busy
    # fractions above and tagged ":aborted" in ops_log.
    preemptions: Dict[str, int] = field(default_factory=dict)
    # seconds during which a batched decode step and at least one
    # restoration op (chunk recompute / KV transfer / queued-request
    # prefetch) ran simultaneously — the steady-state decode/restoration
    # overlap continuous batching exists to create.  Derived from ops_log
    # (see :func:`decode_restore_overlap`), so replay stays bit-identical.
    overlap_decode_restore: float = 0.0


def _merge_intervals(intervals):
    out: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def decode_restore_overlap(ops_log) -> float:
    """Seconds during which a batched decode step and at least one
    restoration op — chunk recompute (``:c``), KV transfer (``:l``) or
    queued-request prefetch (``:pf``); suffix prefills and aborted ops
    excluded — were simultaneously in flight.  Zero in any schedule that
    drains the decode batch before restoring the next one (run-to-
    completion); strictly positive at continuous-batching steady state,
    where arriving requests restore against the live decode batch."""
    dec, rest = [], []
    for t0, t1, resource, desc in ops_log:
        if desc.endswith(":aborted"):
            continue
        if resource == "decode":
            dec.append((t0, t1))
            continue
        tag = desc.rsplit(":", 1)[-1]
        if tag == "pf" or (tag[:1] in ("c", "l") and tag[1:].isdigit()):
            rest.append((t0, t1))
    dec, rest = _merge_intervals(dec), _merge_intervals(rest)
    total, i, j = 0.0, 0, 0
    while i < len(dec) and j < len(rest):
        lo = max(dec[i][0], rest[j][0])
        hi = min(dec[i][1], rest[j][1])
        if lo < hi:
            total += hi - lo
        if dec[i][1] <= rest[j][1]:
            i += 1
        else:
            j += 1
    return total


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class EngineBackend:
    """Execution provider for the engine core.

    ``compute_secs`` / ``io_secs`` return the op's duration on the engine
    clock; a real backend additionally *executes* the op when asked for its
    duration (dispatch time), which is legal because claimed units are
    disjoint and per-plan claims serialize."""

    def admit(self, req: EngineRequest) -> None:
        """Called once when the request enters the active batch."""

    def compute_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        raise NotImplementedError

    def io_secs(self, op: ScheduledOp, req: EngineRequest,
                bandwidth: Optional[float]) -> float:
        raise NotImplementedError

    def io_channel_hint(self, channel: int) -> None:
        """Engine channel about to dispatch I/O ops.  A real backend routes
        the ops onto that channel's physical transfer stream (the fused
        datapath pins one host→device queue per channel); analytic/replay
        backends ignore it."""

    def io_hit_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        """Duration of a load whose chunks are already HBM-resident (dedup
        hit): no interconnect bytes move.  A real backend still executes
        the op (device-local copy into the live cache); the engine clock
        charges nothing."""
        return 0.0

    def io_secs_partial(self, op: ScheduledOp, req: EngineRequest,
                        bandwidth: Optional[float], missing: float) -> float:
        """Duration of a load only ``missing`` (0..1, bytes-weighted) of
        whose blocks actually cross the interconnect — block-granular
        residency: a partially evicted unit re-transfers just its missing
        blocks.  Default prices the transfer pro rata."""
        return self.io_secs(op, req, bandwidth) * missing

    def prefill_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        """Duration of one suffix-prefill stage op (kind == "prefill")."""
        raise NotImplementedError

    def decode_secs(self, reqs: List[EngineRequest]) -> float:
        """Duration of one batched decode step over every decode-phase
        request (sorted by arrival) — one generated token each."""
        raise NotImplementedError

    def io_benefit(self, plan: RequestPlan, unit: int,
                   bandwidth: Optional[float], slowdown: float = 1.0,
                   decode_load: int = 0) -> bool:
        """Marginal-benefit gate (§3.3); default = eager loading.
        ``slowdown`` is the CANDIDATE CHANNEL's duration multiplier — the
        gate must price the transfer at the channel the unit would actually
        ride, not the nominal kvstore/default bandwidth.  ``decode_load``
        is the size of the LIVE decode batch at gate time: at continuous-
        batching steady state the recompute alternative timeshares the
        chips with recurring decode steps, so it must be priced against a
        busy device, not an idle one."""
        return True

    def prefetch_secs(self, op: ScheduledOp, req: EngineRequest,
                      bandwidth: Optional[float]) -> float:
        """Duration of a queued-request prefetch (kind == "prefetch"): the
        admission queue is a known lookahead window, so idle channel time
        promotes a queued request's chunks up a tier — its admission-time
        restoration then starts from the faster tier."""
        raise NotImplementedError

    def prefetch_gate(self, req: EngineRequest) -> bool:
        """Replay hook: should this queued request be prefetched?  Live
        runs never ask — the engine consults its KV store directly (and
        records the answer); only a store-less replay delegates here."""
        return False

    def suspend(self, req: EngineRequest) -> None:
        """Called when the request's restoration is preempted: its
        partially-restored cache parks (NOT finalized) until resume."""

    def evict(self, req: EngineRequest) -> None:
        """Eviction-mode preemption (host memory tight): the partially-
        restored cache is DROPPED, not parked — restoration restarts from
        the KV store when the request is re-admitted."""

    def resume(self, req: EngineRequest) -> None:
        """Called when a preempted request re-enters the active batch."""

    def restore_done(self, req: EngineRequest) -> None:
        """Called once when every stage plan of the request is restored
        (before suffix prefill touches the cache)."""

    def request_done(self, req: EngineRequest) -> None:
        """Called once when the request's whole lifecycle completes."""


class SimBackend(EngineBackend):
    """Analytic durations from the CacheFlow cost model (virtual time)."""

    def __init__(self, cost: CostModel,
                 bw_override: Optional[Dict[str, float]] = None,
                 benefit_gate: bool = True):
        self.cost = cost
        self.bw_override = bw_override or {}
        self.benefit_gate = benefit_gate

    def _bw(self, rid: str, bandwidth: Optional[float]) -> float:
        if bandwidth is not None:
            return bandwidth
        return self.bw_override.get(rid, self.cost.io_bandwidth)

    def compute_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        lo, hi = op.layers
        frac = (hi - lo) / self.cost.cfg.num_layers
        t0, t1 = op.tokens
        f = self.cost.flops_recompute(t0, t1) * frac
        return f / (self.cost.hw.peak_flops * self.cost.mfu * self.cost.num_chips) \
            + self.cost.hw.kernel_overhead_s

    def io_secs(self, op: ScheduledOp, req: EngineRequest,
                bandwidth: Optional[float]) -> float:
        t0, t1 = op.tokens
        lo, hi = op.layers
        frac = (hi - lo) / self.cost.cfg.num_layers
        bytes_ = (t1 - t0) * self.cost.bytes_per_token() * frac
        return bytes_ / self._bw(op.request_id, bandwidth)

    def prefill_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        # same compute roofline as a restoration chunk: the suffix tokens
        # attend to the (restored) prefix, scaled to the stage's layer slice
        return self.compute_secs(op, req)

    def decode_secs(self, reqs: List[EngineRequest]) -> float:
        return self.cost.t_decode_step(
            [r.n_tokens + r.new_len for r in reqs])

    def prefetch_secs(self, op: ScheduledOp, req: EngineRequest,
                      bandwidth: Optional[float]) -> float:
        """Whole-prefix payload at the CURRENT tier's bandwidth (the store
        reports the queued request's tier at dispatch time; promotion to
        the faster tier happens when the transfer completes)."""
        t0, t1 = op.tokens
        return (t1 - t0) * self.cost.bytes_per_token() \
            / self._bw(op.request_id, bandwidth)

    def io_benefit(self, plan: RequestPlan, unit: int,
                   bandwidth: Optional[float], slowdown: float = 1.0,
                   decode_load: int = 0) -> bool:
        """Spend a channel on this unit only if the transfer finishes before
        compute alone could have covered the remaining span through it —
        otherwise loading delays completion (the channel pins the unit).
        The transfer is priced at the candidate channel's EFFECTIVE
        bandwidth (nominal / slowdown): a degraded channel must not pass a
        gate its real transfer time would fail.  With a LIVE decode batch
        (``decode_load`` > 0) the recompute alternative is priced against a
        busy device: recurring decode steps eat ``cost.decode_interference``
        of the restoration-compute throughput, so transfers that would lose
        to an idle device's recompute can still win at steady state."""
        if not self.benefit_gate:
            return True
        if not plan.plan.comp_enabled:
            return True               # load-only baselines: I/O is all they have
        tokens, layers = plan.io_unit_for_claim(unit)
        lo, hi = layers
        frac = (hi - lo) / self.cost.cfg.num_layers
        bw = self._bw(plan.request_id, bandwidth) / max(slowdown, 1e-12)
        t0, t1 = tokens
        io_secs = (t1 - t0) * self.cost.bytes_per_token() * frac / bw
        if plan.strategy == "token":
            span0 = plan.plan.comp_next * plan.chunk_size
            span1 = min(plan.n_tokens, (unit + 1) * plan.chunk_size)
            n_chunks = unit - plan.plan.comp_next + 1
            comp_secs = (self.cost.flops_recompute(span0, span1) * frac
                         / (self.cost.hw.peak_flops * self.cost.mfu
                            * self.cost.num_chips)
                         + n_chunks * self.cost.hw.kernel_overhead_s)
        else:
            n_layers = unit - plan.plan.comp_next + 1
            full = self.cost.flops_recompute(0, plan.n_tokens) / self.cost.cfg.num_layers
            comp_secs = (full * n_layers
                         / (self.cost.hw.peak_flops * self.cost.mfu
                            * self.cost.num_chips)
                         + self.cost.hw.kernel_overhead_s)
        if decode_load > 0 and self.cost.decode_interference > 0.0:
            comp_secs /= 1.0 - min(self.cost.decode_interference, 0.999)
        return io_secs < comp_secs


class RealBackend(EngineBackend):
    """Executes dispatched ops on device through a RestorationExecutor.

    Durations on the engine clock are measured wall seconds by default;
    ``dur_fn(op) -> secs`` overrides them (e.g. rng-drawn durations to
    property-test that *any* legal multi-request interleaving restores every
    cache correctly — the completion order, and hence all subsequent claims,
    follows the durations)."""

    def __init__(self, executor, *, dur_fn: Optional[Callable[[ScheduledOp], float]] = None,
                 verify: bool = False, verify_atol: Optional[float] = None):
        self.executor = executor
        self.dur_fn = dur_fn
        self.verify = verify
        # None = executor default; a quantized chunk store needs its
        # documented int8 tolerance on top of the recompute atol
        self.verify_atol = verify_atol
        # measured mode: the fused datapath blocks per load op and reports
        # the transfer wall seconds + per-channel bandwidth (io_secs below
        # charges those); synthetic durations keep it fully asynchronous
        dp = getattr(executor, "datapath", None)
        if dp is not None:
            dp.measure = dur_fn is None

    def admit(self, req: EngineRequest) -> None:
        with obs.span("engine.admit", req.request_id):
            self.executor.begin_restore(req.request_id, plans=req.plans)

    def _run_op(self, op: ScheduledOp) -> float:
        if self.dur_fn is not None:
            # synthetic schedule durations: no measurement needed, so let op
            # results chain asynchronously instead of syncing the whole cache
            self.executor.execute_op(op)
            return max(1e-12, float(self.dur_fn(op)))
        t0 = time.perf_counter()
        self.executor.execute_op(op)
        with obs.span("engine.device_wait", op.request_id):
            self.executor.sync()
        return max(1e-12, time.perf_counter() - t0)

    def compute_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        with obs.span("engine.restore_compute", op.request_id,
                      op.tokens[1] - op.tokens[0]):
            return self._run_op(op)

    def io_channel_hint(self, channel: int) -> None:
        # load ops dispatched next ride this engine channel's physical
        # transfer stream (one host→device queue per channel)
        self.executor.io_channel = channel

    def io_secs(self, op: ScheduledOp, req: EngineRequest,
                bandwidth: Optional[float]) -> float:
        with obs.span("engine.restore_load", op.request_id):
            wall = self._run_op(op)
        if self.dur_fn is None:
            # measured mode: charge the channel the datapath's measured
            # transfer seconds for THIS op (staging + dequant-scatter),
            # not the whole-cache sync wall time, so per-channel bandwidth
            # feeds back into the engine clock
            dp = getattr(self.executor, "datapath", None)
            secs = dp.pop_measured_secs() if dp is not None else None
            if secs is not None:
                return max(1e-12, secs)
        return wall

    def prefill_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        with obs.span("engine.suffix_prefill", op.request_id,
                      op.tokens[1] - op.tokens[0]):
            return self._run_op(op)

    def decode_secs(self, reqs: List[EngineRequest]) -> float:
        rids = [r.request_id for r in reqs]
        with obs.span("engine.decode_step", None, len(rids)):
            if self.dur_fn is not None:
                self.executor.decode_step_batch(rids)
                # the op carries the FULL participant list: a synthetic
                # duration may depend on batch composition
                # (CostModel.t_decode_step does)
                op = ScheduledOp("decode", rids[0], -1, 0, (0, len(rids)),
                                 (0, 0), batch=tuple(rids))
                return max(1e-12, float(self.dur_fn(op)))
            t0 = time.perf_counter()
            self.executor.decode_step_batch(rids)
            with obs.span("engine.device_wait"):
                self.executor.sync()
            return max(1e-12, time.perf_counter() - t0)

    def io_hit_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        # resident chunks: the load still executes (HBM-local copy into the
        # live cache) but occupies no transfer-channel time on the clock
        with obs.span("engine.restore_load_hit", op.request_id):
            self.executor.execute_op(op)
        dp = getattr(self.executor, "datapath", None)
        if dp is not None:
            dp.pop_measured_secs()     # device-local: nothing to charge
        return 0.0

    def io_secs_partial(self, op: ScheduledOp, req: EngineRequest,
                        bandwidth: Optional[float], missing: float) -> float:
        # the measured wall time already reflects only the missing blocks
        # moving (resident blocks fetch as device-local hits inside the
        # store) — no pro-rata scaling on top
        return self.io_secs(op, req, bandwidth)

    def prefetch_secs(self, op: ScheduledOp, req: EngineRequest,
                      bandwidth: Optional[float]) -> float:
        # the byte movement happens at completion (the engine promotes the
        # queued request through the chunk store); synthetic durations shape
        # the schedule for interleaving tests, measured mode charges the
        # host-side copy as near-instant background work
        if self.dur_fn is not None:
            return max(1e-12, float(self.dur_fn(op)))
        return 1e-9

    def suspend(self, req: EngineRequest) -> None:
        # park the partially-restored cache off-device; finalize_restore
        # (recurrent-state fix-up) must NOT run — restoration is incomplete
        self.executor.suspend_restore(req.request_id)

    def evict(self, req: EngineRequest) -> None:
        self.executor.drop_restore(req.request_id)

    def resume(self, req: EngineRequest) -> None:
        if self.executor.is_live(req.request_id):
            self.executor.resume_restore(req.request_id)
        else:
            # eviction-mode preemption dropped the live state: restoration
            # restarts on a fresh cache (plans were reset with it)
            self.executor.begin_restore(req.request_id, plans=req.plans)

    def restore_done(self, req: EngineRequest) -> None:
        # verify BEFORE prefill/decode append to the restored cache
        with obs.span("engine.restore_done", req.request_id):
            self.executor.finalize_restore(req.request_id)
            if self.verify:
                if self.verify_atol is not None:
                    self.executor.verify(req.request_id,
                                         atol=self.verify_atol)
                else:
                    self.executor.verify(req.request_id)


# ---------------------------------------------------------------------------
# Event loop
# ---------------------------------------------------------------------------


class EngineCore:
    """The single scheduling loop shared by simulated and real serving.

    stage_parallel=False models the paper's Fig. 7 ablation: stages restore
    sequentially (stage s waits for s-1) instead of concurrently via boundary
    activations.  max_active is the continuous-batching admission cap
    (0 = unlimited).  kvstore, when given, supplies per-request I/O bandwidth
    at dispatch time and gets ``touch``/``promote`` callbacks as requests are
    admitted / finish restoring.

    preempt is the admission-pressure policy when ``max_active`` is full:

      * "none"     — FCFS queueing (classic behavior): arrivals wait.
      * "priority" — an arrival with strictly higher ``priority`` than some
        still-RESTORING active request suspends the eligible victim with the
        SMALLEST remaining restoration (least marginal recompute saving —
        the dual of the §3.3 dispatch key) and takes its slot.
      * "deadline" — same, but eligibility is an earlier first-token
        ``deadline`` than the victim's (EDF).

    Suspension releases both pointers' claims (in-flight ops abort; their
    time is excluded from utilization) and parks the partially-restored
    cache; a freed slot re-admits the most urgent of {suspended, queued}
    and a resumed request continues from its completed units — restored
    exactly once, never restarted.  Only RESTORING-phase requests are
    preemptible: prefill/decode work is never rescinded.

    evict=True switches preemption to EVICTION mode (host memory tight):
    the victim's partially-restored cache is dropped instead of parked and
    its plans reset, so a re-admitted victim restarts restoration from the
    KV store — completed work is sacrificed to free memory.

    A kvstore exposing ``io_resident(rid, tokens, layers)`` additionally
    gates transfers on chunk residency: an I/O unit whose chunks already
    sit in device HBM (a dedup hit — another request restored the shared
    prefix, or the payload never left HBM) dispatches at ZERO channel cost
    (real backends still execute the device-local copy), and the benefit
    gate passes it unconditionally.

    admission picks the batching discipline:

      * "continuous" (default) — requests stream into and out of the batch
        every step: an arrival takes any free slot immediately, a slot freed
        by a mid-flight retire (DECODE completion) is refilled on the spot,
        so queued/arriving requests restore AGAINST the live decode batch
        on the shared compute/I/O resources.  The benefit gate prices the
        recompute alternative at the live decode load (``decode_load``).
      * "gang" — the run-to-completion baseline: arrivals only join at
        batch close.  The next gang (up to ``max_active``) is admitted when
        the current one fully drains, so cross-batch decode/restoration
        overlap is structurally zero.  Incompatible with preemption.

    prefetch=True uses idle channel time on the admission queue (a known
    lookahead window): a queued request whose prefix sits below
    ``promote_tier`` gets its chunks promoted up BEFORE admission, so
    admission-time restoration starts from the faster tier.  Each queued
    request is considered once (FCFS); the decision is recorded in traces
    (``prefetch_gate``) so replay re-derives it without the store."""

    PREEMPT_POLICIES = ("none", "priority", "deadline")
    ADMISSION_MODES = ("continuous", "gang")

    def __init__(self, backend: EngineBackend, *, stages: int = 1,
                 io_channels: int = 1, io_policy: str = "longest_remaining",
                 channel_slowdown: Optional[Dict[int, float]] = None,
                 channel_fail_at: Optional[Dict[int, float]] = None,
                 stage_parallel: bool = True, max_active: int = 0,
                 kvstore=None, promote_tier: str = "host",
                 preempt: str = "none", evict: bool = False,
                 admission: str = "continuous", prefetch: bool = False,
                 strict: bool = False, sanitize: Optional[bool] = None,
                 telemetry=None):
        if preempt not in self.PREEMPT_POLICIES:
            raise ValueError(f"unknown preempt policy {preempt!r}; "
                             f"known: {self.PREEMPT_POLICIES}")
        if admission not in self.ADMISSION_MODES:
            raise ValueError(f"unknown admission mode {admission!r}; "
                             f"known: {self.ADMISSION_MODES}")
        if admission == "gang" and preempt != "none":
            raise ValueError(
                "admission='gang' is the run-to-completion baseline — a "
                "closed batch has no admission pressure to preempt for; "
                "use admission='continuous' with preempt=...")
        self.backend = backend
        self.stages = stages
        self.io_channels = io_channels
        self.io_policy = io_policy
        self.slow = channel_slowdown or {}
        self.fail_at = channel_fail_at or {}
        self.stage_parallel = stage_parallel
        self.max_active = max_active
        self.kvstore = kvstore
        self.promote_tier = promote_tier
        self.preempt = preempt
        self.evict = evict
        self.admission = admission
        self.prefetch = prefetch
        self.strict = strict
        # opt-in runtime invariant sanitizer (repro_torch.analysis.sanitizer).
        # None defers to the CACHEFLOW_SANITIZE env var; every hook in the
        # loop is behind an `if san is not None` guard, so the default-off
        # path adds zero work (measured: benchmarks/restore_datapath.py).
        if sanitize is None:
            sanitize = os.environ.get(
                "CACHEFLOW_SANITIZE", "0").lower() not in ("", "0", "false")
        self.sanitize = bool(sanitize)
        # the sanitizer of the most recent run (its counters are the serve
        # observable); None when sanitizing is off
        self.last_sanitizer = None
        # opt-in telemetry (repro_torch.obs.telemetry), same convention as the
        # sanitizer: None defers to CACHEFLOW_TELEMETRY, True builds a fresh
        # Telemetry per run, or pass a prebuilt Telemetry instance.  Hooks
        # are pure observers behind `if tel is not None` guards, so the
        # off path costs nothing and the on path is bit-identical on
        # EngineResult/ops_log (tests/test_torch_telemetry.py).
        if telemetry is None:
            telemetry = os.environ.get(
                "CACHEFLOW_TELEMETRY", "0").lower() not in ("", "0", "false")
        self.telemetry = telemetry
        # the Telemetry of the most recent run (its snapshot is the serve
        # observable); None when telemetry is off
        self.last_telemetry = None

    def _bandwidth(self, rid: str) -> Optional[float]:
        if self.kvstore is None:
            return None
        return self.kvstore.bandwidth_for(rid)

    def _resident(self, rid: str, tokens, layers) -> bool:
        """Chunk-residency consult for the I/O pointer: True iff the whole
        unit is already device-resident and the transfer can be skipped."""
        ks = self.kvstore
        return (ks is not None and hasattr(ks, "io_resident")
                and ks.io_resident(rid, tokens, layers))

    def _missing_fraction(self, rid: str, tokens, layers) -> float:
        """Block-granular residency: the bytes-weighted fraction of the
        unit NOT on device.  Stores without block granularity (the sim
        store's whole-request placement) transfer the full unit."""
        ks = self.kvstore
        if ks is None or not hasattr(ks, "missing_fraction"):
            return 1.0
        return max(0.0, min(1.0, ks.missing_fraction(rid, tokens, layers)))

    # ------------------------------------------------------------------
    def run(self, requests: List[EngineRequest],
            trace: Optional["TraceRecorder"] = None) -> EngineResult:
        """Drive the batch to completion.  ``trace``, when given, is a
        ``repro_torch.core.trace.TraceRecorder`` that captures every
        scheduling decision as a replayable ``ScheduleTrace``.  With
        telemetry on, its span recorder is the current one for the run
        (``obs.span`` sites record into it) and is cleared when the run
        ends, by an exception too."""
        tel = None
        if self.telemetry:
            tel = self.telemetry if isinstance(self.telemetry, obs.Telemetry) \
                else obs.Telemetry()
            tel.begin(self)
        self.last_telemetry = tel
        prev = obs.spans.activate(tel.spans if tel is not None else None)
        try:
            return self._run(requests, trace, tel)
        finally:
            obs.spans.activate(prev)

    def _run(self, requests: List[EngineRequest],
             trace: Optional["TraceRecorder"], tel) -> EngineResult:
        empty = [r.request_id for r in requests if not r.plans]
        if empty:
            if self.strict:
                raise ValueError(
                    f"requests with zero plans cannot be scheduled: {empty}")
            requests = [r for r in requests if r.plans]

        now = 0.0
        san = None
        if self.sanitize:
            # lazy import: the analysis package never loads on the default
            # (sanitize=False) path
            from repro_torch.analysis.sanitizer import EngineSanitizer
            san = EngineSanitizer(self)
        self.last_sanitizer = san
        # the candidate channel's duration multiplier, set by the dispatch
        # loop before each next_io() pass so the benefit gate prices the
        # transfer at the channel it would actually ride (a 10x-degraded
        # channel must not pass a full-bandwidth gate)
        gate_slowdown = [1.0]

        def benefit(p: RequestPlan, u: int) -> bool:
            tokens, layers = p.io_unit_for_claim(u)
            if self._resident(p.request_id, tokens, layers):
                ok = True               # resident chunks transfer for free
            else:
                # priced against the LIVE decode batch, not an idle device:
                # at steady state recompute timeshares with decode steps
                ok = self.backend.io_benefit(p, u,
                                             self._bandwidth(p.request_id),
                                             slowdown=gate_slowdown[0],
                                             decode_load=len(decoding))
            if tel is not None:
                tel.on_gate(now, p.request_id, ok)
            if trace is not None:
                trace.record_gate(now, p.request_id, p.stage, u, ok,
                                  decode_load=len(decoding))
            return ok

        sched = BatchScheduler(io_policy=self.io_policy, benefit_fn=benefit)
        if trace is not None:
            trace.begin(self._trace_meta(), requests)
        counter = itertools.count()
        events: List[Tuple[float, int, str, object]] = []
        for r in requests:
            heapq.heappush(events, (r.arrival, next(counter), "arrive", r))
        for c, t in self.fail_at.items():
            heapq.heappush(events, (t, next(counter), "fail", c))

        comp_free = {s: True for s in range(self.stages)}
        io_free = {c: True for c in range(self.io_channels)}
        decode_free = True
        failed = set()
        busy_comp = {s: 0.0 for s in range(self.stages)}
        busy_io = {c: 0.0 for c in range(self.io_channels)}
        busy_decode = 0.0
        decode_steps = 0
        restore_finish: Dict[str, float] = {}
        restore_start: Dict[str, float] = {}
        first_token: Dict[str, float] = {}
        finish: Dict[str, float] = {}
        decoding: Dict[str, int] = {}   # rid -> decode steps remaining
        ops_log: List[Tuple[float, float, str, str]] = []
        reqs: Dict[str, EngineRequest] = {}
        pending: "deque[EngineRequest]" = deque()
        active: set = set()
        # preemption state: suspended requests (insertion-ordered), per-rid
        # preempt counts, the ops currently occupying a resource (rid ->
        # [op, resource, dur, ops_log index]) and the identities of
        # dispatched ops whose completion must be treated as an abort
        # (claim already released; resource frees, pointers do not move)
        suspended: Dict[str, EngineRequest] = {}
        preemptions: Dict[str, int] = {}
        outstanding: Dict[str, List[list]] = {}
        aborted_ids: set = set()
        # queued-request prefetch (admission-queue lookahead): rid ->
        # "done" | "resident" (already at/above promote_tier) | an inflight
        # record [c, op, dur, log_idx].  Each queued request is gated at
        # most once, so trace size stays bounded and replay re-derives the
        # same query sequence.  An inflight prefetch whose target is
        # admitted is ABORTED (channel freed, elapsed time becomes waste):
        # the half-done promotion can't serve restoration, and letting the
        # background transfer pin the channel would starve the foreground
        # loads it was meant to accelerate.
        prefetch_state: Dict[str, object] = {}
        if san is not None:
            san.bind(ops_log=ops_log, busy_comp=busy_comp, busy_io=busy_io)

        def stage_unblocked(op_stage: int, rid: str) -> bool:
            if self.stage_parallel:
                return True
            # sequential ablation: stage s may start only after stage s-1 done
            for s in range(op_stage):
                p = sched.plans.get((rid, s))
                if p is not None and not p.plan.done:
                    return False
            return True

        def try_prefetch(c: int) -> bool:
            """Idle channel + a known lookahead window (the admission
            queue): promote the oldest queued request still below
            ``promote_tier`` so its restoration starts from the faster
            tier.  Returns True iff a prefetch was dispatched on ``c``."""
            if not self.prefetch:
                return False
            for r in pending:
                rid = r.request_id
                if rid in prefetch_state:
                    continue
                if self.kvstore is not None and hasattr(self.kvstore, "tier_of"):
                    tier = self.kvstore.tier_of(rid)
                    ok = tier is not None \
                        and tier not in ("hbm", self.promote_tier)
                else:
                    # store-less replay: the recorded answer stands
                    ok = self.backend.prefetch_gate(r)
                if tel is not None:
                    tel.on_prefetch_gate(now, rid, ok)
                if trace is not None:
                    trace.record_prefetch_gate(now, rid, ok)
                if not ok:
                    prefetch_state[rid] = "resident"
                    continue
                op = ScheduledOp("prefetch", rid, -1, 0, (0, r.n_tokens),
                                 (0, 0))
                bw = self._bandwidth(rid)
                dur = self.backend.prefetch_secs(op, r, bw) \
                    * self.slow.get(c, 1.0)
                if san is not None:
                    san.on_dispatch(now, f"io{c}", op, dur)
                if tel is not None:
                    tel.on_dispatch(now, f"io{c}", op, dur)
                io_free[c] = False
                busy_io[c] += dur
                log_idx = len(ops_log)
                prefetch_state[rid] = [c, op, dur, log_idx]
                ops_log.append((now, now + dur, f"io{c}", f"{rid}:pf"))
                if trace is not None:
                    trace.record_dispatch(now, f"io{c}", op, dur, bw)
                heapq.heappush(events, (now + dur, next(counter),
                                        "prefetch_done", (c, op, dur, log_idx)))
                return True
            return False

        def dispatch():
            nonlocal decode_free, busy_decode, decode_steps
            # compute per stage.  A stage-blocked head request (sequential
            # ablation) is SKIPPED, not a reason to stop: other requests'
            # runnable ops on this stage must still dispatch.  Candidates are
            # phase-aware: restoration chunks and suffix-prefill ops compete
            # FCFS for the same stage compute (see BatchScheduler).
            for s in range(self.stages):
                blocked: set = set()
                while comp_free[s]:
                    op = sched.next_compute(stage=s, skip=blocked)
                    if op is None:
                        break
                    if op.kind == "compute" and \
                            not stage_unblocked(op.stage, op.request_id):
                        # release the claim; retry when upstream finishes
                        sched.plans[(op.request_id, op.stage)].plan.release_compute()
                        blocked.add((op.request_id, op.stage))
                        continue
                    r = reqs[op.request_id]
                    if op.kind == "prefill":
                        dur = self.backend.prefill_secs(op, r)
                        desc = f"{op.request_id}:p{op.unit}"
                    else:
                        restore_start.setdefault(op.request_id, now)
                        dur = self.backend.compute_secs(op, r)
                        desc = f"{op.request_id}:c{op.unit}"
                    if san is not None:
                        san.on_dispatch(now, f"comp{s}", op, dur)
                    if tel is not None:
                        tel.on_dispatch(now, f"comp{s}", op, dur)
                    comp_free[s] = False
                    busy_comp[s] += dur
                    log_idx = len(ops_log)
                    ops_log.append((now, now + dur, f"comp{s}", desc))
                    outstanding.setdefault(op.request_id, []).append(
                        [op, f"comp{s}", dur, log_idx])
                    if trace is not None:
                        trace.record_dispatch(now, f"comp{s}", op, dur, None)
                    heapq.heappush(events, (now + dur, next(counter),
                                            "comp_done", (s, op, dur)))
            # shared I/O channels (stage blockage is channel-independent, so
            # one skip set covers the whole pass)
            io_blocked: set = set()
            for c in range(self.io_channels):
                gate_slowdown[0] = self.slow.get(c, 1.0)
                self.backend.io_channel_hint(c)
                while io_free[c] and c not in failed:
                    op = sched.next_io(skip=io_blocked)
                    if op is None:
                        # no restoration transfer wants the channel: spend
                        # the idle time prefetching for the admission queue
                        try_prefetch(c)
                        break
                    if not stage_unblocked(op.stage, op.request_id):
                        sched.plans[(op.request_id, op.stage)].plan.release_io()
                        io_blocked.add((op.request_id, op.stage))
                        continue
                    r = reqs[op.request_id]
                    bw = self._bandwidth(op.request_id)
                    if self._resident(op.request_id, op.tokens, op.layers):
                        # dedup/HBM hit: the unit's chunks are already on
                        # device — no interconnect transfer, zero channel
                        # time (the channel frees at this same instant)
                        dur = self.backend.io_hit_secs(op, r)
                        if hasattr(self.kvstore, "note_io_hit"):
                            self.kvstore.note_io_hit(op.request_id,
                                                     op.tokens, op.layers)
                    else:
                        # block-granular pricing: only the unit's missing
                        # blocks ride the interconnect (partial eviction
                        # does not re-transfer the resident remainder)
                        frac = self._missing_fraction(op.request_id,
                                                      op.tokens, op.layers)
                        dur = self.backend.io_secs_partial(op, r, bw, frac) \
                            * self.slow.get(c, 1.0)
                    restore_start.setdefault(op.request_id, now)
                    if san is not None:
                        san.on_dispatch(now, f"io{c}", op, dur)
                    if tel is not None:
                        tel.on_dispatch(now, f"io{c}", op, dur)
                    io_free[c] = False
                    busy_io[c] += dur
                    log_idx = len(ops_log)
                    ops_log.append((now, now + dur, f"io{c}",
                                    f"{op.request_id}:l{op.unit}"))
                    outstanding.setdefault(op.request_id, []).append(
                        [op, f"io{c}", dur, log_idx])
                    if trace is not None:
                        trace.record_dispatch(now, f"io{c}", op, dur, bw)
                    heapq.heappush(events, (now + dur, next(counter),
                                            "io_done", (c, op, dur)))
            gate_slowdown[0] = 1.0
            # the decode-batch resource: one recurring step over EVERY
            # decode-phase request (continuous batching), one token each
            if decode_free and decoding:
                rids = sorted(decoding, key=lambda rid: sched.arrival_index[rid])
                dur = self.backend.decode_secs([reqs[rid] for rid in rids])
                if san is not None:
                    san.on_decode_dispatch(now, dur, rids)
                if tel is not None:
                    tel.on_decode_dispatch(now, dur, rids)
                decode_free = False
                busy_decode += dur
                decode_steps += 1
                ops_log.append((now, now + dur, "decode", ",".join(rids)))
                if trace is not None:
                    trace.record_decode(now, rids, dur)
                heapq.heappush(events, (now + dur, next(counter), "decode_done", rids))

        def admit(r: EngineRequest):
            st = prefetch_state.get(r.request_id)
            if isinstance(st, list):
                # the prefetch lost the race with admission: cancel it so
                # the channel serves this request's restoration instead
                c, op, dur, log_idx = st
                del prefetch_state[r.request_id]
                aborted_ids.add(id(op))
                io_free[c] = True
                busy_io[c] -= dur
                if san is not None:
                    san.on_abort(now, f"io{c}", op, rolled_back=dur)
                if tel is not None:
                    tel.on_abort(now, f"io{c}", op)
                t0, _, rn, desc = ops_log[log_idx]
                ops_log[log_idx] = (t0, now, rn, desc + ":aborted")
                if trace is not None:
                    trace.record_abort(now, f"io{c}", op)
            reqs[r.request_id] = r
            if san is not None:
                san.on_admit(now, r)
            active.add(r.request_id)
            if tel is not None:
                tel.on_admit(now, r.request_id, queued=len(pending),
                             active=len(active))
            sched.add_request(r.plans, priority=r.priority,
                              deadline=r.deadline)
            self.backend.admit(r)
            if trace is not None:
                trace.record_admit(now, r.request_id)
            if self.kvstore is not None:
                self.kvstore.touch(r.request_id)

        def urgency(r: EngineRequest):
            """Admission order under a preemption policy: most urgent first."""
            if self.preempt == "deadline":
                return (r.deadline, r.arrival)
            return (-r.priority, r.arrival)

        def suspend(vid: str):
            """Preempt a RESTORING request: abort its in-flight ops (their
            time becomes waste, not utilization), release every claim, park
            the cache — or DROP it (plans reset) in eviction mode — and
            free the admission slot."""
            active.discard(vid)
            suspended[vid] = reqs[vid]
            preemptions[vid] = preemptions.get(vid, 0) + 1
            recs = outstanding.pop(vid, [])
            if san is not None:
                san.on_suspend(now, vid, recs, self.evict)
            if tel is not None:
                tel.on_preempt(now, vid, evict=self.evict,
                               aborted_ops=len(recs))
            for op, resource, dur, log_idx in recs:
                # the resource stays physically occupied until the op's
                # completion event fires; completion then frees it WITHOUT
                # advancing pointers (the claim is released right here)
                aborted_ids.add(id(op))
                if resource.startswith("io"):
                    busy_io[int(resource[2:])] -= dur
                else:
                    busy_comp[int(resource[4:])] -= dur
                t0, t1, rn, desc = ops_log[log_idx]
                ops_log[log_idx] = (t0, t1, rn, desc + ":aborted")
            sched.preempt(vid, reset=self.evict)
            if self.evict:
                self.backend.evict(reqs[vid])
            else:
                self.backend.suspend(reqs[vid])
            if trace is not None:
                trace.record_preempt(now, vid)

        def resume(rid: str):
            """Re-admit a suspended request with all completed units intact."""
            r = suspended.pop(rid)
            if san is not None:
                san.on_resume(now, rid)
            if tel is not None:
                tel.on_resume(now, rid)
            active.add(rid)
            sched.resume(rid)
            self.backend.resume(r)
            if trace is not None:
                trace.record_resume(now, rid)
            if self.kvstore is not None:
                self.kvstore.touch(rid)

        def try_preempt(r: EngineRequest) -> bool:
            """Admission pressure: can arrival ``r`` take a slot by
            suspending a strictly less urgent, still-RESTORING request?
            Victim = eligible request with the smallest remaining
            restoration benefit (least recompute saving lost by pausing)."""
            victims = []
            for vid in active:
                if vid in restore_finish:
                    continue          # prefill/decode work is never rescinded
                v = reqs[vid]
                if self.preempt == "priority" and r.priority <= v.priority:
                    continue
                if self.preempt == "deadline" and r.deadline >= v.deadline:
                    continue
                victims.append((sched.remaining_restoration(vid),
                                -sched.arrival_index[vid], vid))
            if not victims:
                return False
            suspend(min(victims)[2])
            return True

        def refill():
            """A slot freed: re-admit the most urgent of {suspended, queued}.
            preempt="none" keeps the classic FCFS deque behavior.  Gang
            (run-to-completion) admission instead waits for batch close:
            the next gang joins only once the active set fully drains."""
            if self.admission == "gang":
                if active:
                    return
                while pending and (not self.max_active
                                   or len(active) < self.max_active):
                    admit(pending.popleft())
                return
            while pending or suspended:
                if self.max_active and len(active) >= self.max_active:
                    return
                if self.preempt == "none":
                    if not pending:
                        return
                    admit(pending.popleft())
                    continue
                best_s = min(suspended.values(), key=urgency, default=None)
                best_p = min(pending, key=urgency, default=None)
                if best_s is not None and (
                        best_p is None or urgency(best_s) <= urgency(best_p)):
                    resume(best_s.request_id)
                else:
                    pending.remove(best_p)
                    admit(best_p)

        def finish_request(rid: str):
            """Lifecycle complete: free the admission slot (continuous
            batching frees capacity at DECODE completion, not restore)."""
            finish[rid] = now
            if san is not None:
                san.on_finish(now, rid)
            active.discard(rid)
            if tel is not None:
                tel.on_finish(now, rid, queued=len(pending),
                              active=len(active))
            self.backend.request_done(reqs[rid])
            if trace is not None:
                trace.record_finish(now, rid)
            refill()

        def enter_decode(rid: str):
            """Transition out of PREFILL (or RESTORING when new_len == 0):
            queue the remaining output tokens for batched decode."""
            r = reqs[rid]
            steps = r.decode_len - (1 if r.new_len > 0 else 0)
            if steps > 0:
                decoding[rid] = steps
            else:
                finish_request(rid)

        def on_restored(rid: str):
            r = reqs[rid]
            restore_finish[rid] = now
            if san is not None:
                san.on_restore_done(now, rid)
            if tel is not None:
                tel.on_restore_done(now, rid)
            self.backend.restore_done(r)
            if trace is not None:
                trace.record_done(now, rid)
            if self.kvstore is not None:
                # restored KV is hot again: refresh LRU + pull it up
                self.kvstore.touch(rid)
                self.kvstore.promote(rid, self.promote_tier)
            if r.new_len > 0:
                sched.begin_prefill(rid, r.n_tokens, r.new_len)
            else:
                enter_decode(rid)

        def unregister(rid: str, op) -> Optional[list]:
            recs = outstanding.get(rid, ())
            for i, rec in enumerate(recs):
                if rec[0] is op:
                    del recs[i]
                    return rec
            return None

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if san is not None:
                san.on_event(now, kind)
            if kind == "arrive":
                r: EngineRequest = payload
                if tel is not None:
                    tel.on_arrive(now, r.request_id, queued=len(pending),
                                  active=len(active))
                if self.admission == "gang":
                    # run-to-completion baseline: arrivals only ever join
                    # at batch close, never a live batch
                    pending.append(r)
                    refill()
                elif self.max_active and len(active) >= self.max_active:
                    if self.preempt != "none" and try_preempt(r):
                        admit(r)
                    else:
                        pending.append(r)
                else:
                    admit(r)
            elif kind == "comp_done":
                s, op, dur = payload
                comp_free[s] = True
                if id(op) in aborted_ids:
                    # op of a preempted request: the kernel's time is already
                    # rolled back and the claim released; just free the stage
                    aborted_ids.discard(id(op))
                    if san is not None:
                        san.on_abort(now, f"comp{s}", op)
                    if trace is not None:
                        trace.record_abort(now, f"comp{s}", op)
                else:
                    unregister(op.request_id, op)
                    if san is not None:
                        san.on_complete(now, f"comp{s}", op)
                    restored = sched.complete(op)
                    if trace is not None:
                        trace.record_complete(now, f"comp{s}", op)
                    if op.kind == "prefill" and sched.prefill_done(op.request_id):
                        # last pipeline stage of the suffix done -> first token
                        first_token[op.request_id] = now
                        if tel is not None:
                            tel.on_first_token(now, op.request_id)
                        enter_decode(op.request_id)
                    elif restored is not None:
                        on_restored(restored)
            elif kind == "io_done":
                c, op, dur = payload
                io_free[c] = True
                if id(op) in aborted_ids:
                    aborted_ids.discard(id(op))
                    if san is not None:
                        san.on_abort(now, f"io{c}", op)
                    if trace is not None:
                        trace.record_abort(now, f"io{c}", op)
                elif c in failed:
                    # transfer died with its channel: release the claim (it
                    # reschedules), do NOT count the dead time as useful I/O
                    rec = unregister(op.request_id, op)
                    p = sched.plans[(op.request_id, op.stage)]
                    p.plan.release_io()
                    busy_io[c] -= dur
                    if san is not None:
                        san.on_abort(now, f"io{c}", op, rolled_back=dur,
                                     release_claim=True)
                    if tel is not None:
                        tel.on_abort(now, f"io{c}", op)
                    if rec is not None:
                        t0, t1, rn, desc = ops_log[rec[3]]
                        ops_log[rec[3]] = (t0, t1, rn, desc + ":aborted")
                    if trace is not None:
                        trace.record_abort(now, f"io{c}", op)
                else:
                    unregister(op.request_id, op)
                    if san is not None:
                        san.on_complete(now, f"io{c}", op)
                    restored = sched.complete(op)
                    if trace is not None:
                        trace.record_complete(now, f"io{c}", op)
                    if restored is not None:
                        on_restored(restored)
            elif kind == "fail":
                failed.add(payload)
                if trace is not None:
                    trace.record_fail(now, payload)
            elif kind == "decode_done":
                decode_free = True
                if san is not None:
                    san.on_decode_done(now)
                for rid in payload:
                    decoding[rid] -= 1
                    # decode-only lifecycles (new_len == 0): the first
                    # generated token IS the first token
                    if tel is not None and rid not in first_token:
                        tel.on_first_token(now, rid)
                    first_token.setdefault(rid, now)
                    if decoding[rid] <= 0:
                        del decoding[rid]
                        finish_request(rid)
            elif kind == "prefetch_done":
                c, op, dur, log_idx = payload
                rid = op.request_id
                if id(op) in aborted_ids:
                    # cancelled at admission: the channel was freed (and
                    # possibly re-dispatched) back then — nothing to do
                    aborted_ids.discard(id(op))
                    dispatch()
                    continue
                io_free[c] = True
                if c in failed:
                    # the channel died mid-prefetch: background work, so
                    # just roll the time back and allow a retry elsewhere
                    busy_io[c] -= dur
                    if san is not None:
                        san.on_abort(now, f"io{c}", op, rolled_back=dur)
                    if tel is not None:
                        tel.on_abort(now, f"io{c}", op)
                    t0, t1, rn, desc = ops_log[log_idx]
                    ops_log[log_idx] = (t0, t1, rn, desc + ":aborted")
                    prefetch_state.pop(rid, None)
                    if trace is not None:
                        trace.record_abort(now, f"io{c}", op)
                else:
                    prefetch_state[rid] = "done"
                    if san is not None:
                        san.on_complete(now, f"io{c}", op)
                    if self.kvstore is not None:
                        self.kvstore.promote(rid, self.promote_tier)
                    if trace is not None:
                        trace.record_complete(now, f"io{c}", op)
            dispatch()

        if self.strict and (pending or active or suspended):
            unfinished = sorted(active) + sorted(suspended) \
                + [r.request_id for r in pending]
            raise RuntimeError(
                f"engine core stalled before completion: {unfinished}")

        if san is not None:
            san.on_run_end(active=active, pending=pending,
                           suspended=suspended)
            if trace is not None and trace.trace is not None:
                for ev in trace.trace.events:
                    san.on_trace_event(ev)

        makespan = max(finish.values(), default=0.0) or 1e-12
        result = EngineResult(
            restore_finish=restore_finish,
            restore_start=restore_start,
            first_token=first_token,
            finish=finish,
            makespan=makespan,
            compute_busy=sum(busy_comp.values()) / (max(1, self.stages) * makespan),
            io_busy=sum(busy_io.values()) / (max(1, self.io_channels) * makespan),
            decode_busy=busy_decode / makespan,
            decode_steps=decode_steps,
            ops_log=ops_log,
            preemptions=preemptions,
            overlap_decode_restore=decode_restore_overlap(ops_log),
        )
        if tel is not None:
            tel.on_run_end(result)
        if trace is not None:
            trace.finish(result)
        return result

    def _trace_meta(self) -> dict:
        """Engine configuration a replay needs to rebuild this core.
        ``channel_slowdown`` is recorded for provenance only — replayed
        durations already include it."""
        return {
            "backend": type(self.backend).__name__,
            "stages": self.stages,
            "io_channels": self.io_channels,
            "io_policy": self.io_policy,
            "channel_slowdown": dict(self.slow),
            "channel_fail_at": dict(self.fail_at),
            "stage_parallel": self.stage_parallel,
            "max_active": self.max_active,
            "promote_tier": self.promote_tier,
            "preempt": self.preempt,
            "evict": self.evict,
            "admission": self.admission,
            "prefetch": self.prefetch,
        }


def interleaving_dur_fn(op_order: str,
                        rng: Optional[np.random.Generator] = None
                        ) -> Optional[Callable[[ScheduledOp], float]]:
    """Map the executor's historical ``op_order`` knob onto schedule
    durations for a RealBackend: the engine clock orders completions by
    duration, so biasing one op kind fast makes that pointer race ahead.
    Returns None for "measured" (use real wall timings)."""
    if op_order == "measured":
        return None
    rng = rng or np.random.default_rng(0)
    if op_order == "io_first":
        return lambda op: 1e-6 if op.kind == "load" else 1.0
    if op_order == "compute_first":
        return lambda op: 1e-6 if op.kind == "compute" else 1.0
    if op_order in ("random", "alternate"):
        return lambda op: float(rng.uniform(0.5, 1.5))
    raise ValueError(f"unknown op_order: {op_order}")
