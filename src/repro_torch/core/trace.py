"""Schedule capture & deterministic replay.

A copy of ``repro.core.trace``: the JSON schema is one contract for both
packages, so a trace saved by either loads and replays in the other.

Every engine-core run can be recorded as a :class:`ScheduleTrace` — the
complete sequence of scheduling decisions the event loop made: admissions,
marginal-benefit gate answers, dispatches (resource, op, duration,
bandwidth), completions, aborted transfers, channel failures and request
completions — plus the engine configuration and the request/plan specs
needed to rebuild the run from nothing.  Traces round-trip through JSON
losslessly (floats serialize via ``repr`` and parse back bit-equal).

Replay feeds a captured trace back through the *same* ``EngineCore`` loop
with a :class:`ReplayBackend` that pins every dispatched op's duration (and
every gate answer) to the recorded value.  Because the loop is deterministic
given durations — the event heap breaks ties by push order, the scheduler
sorts candidates on pure plan state — pinning durations reproduces the
original interleaving decision-for-decision.  The backend verifies this as
it goes: any op dispatched out of recorded order raises
:class:`ReplayDivergence` instead of silently drifting.

Replay is legal on either backend:

  * sim replay (no executor) — pure re-derivation; the resulting
    ``EngineResult`` must be bit-identical to the captured one.
  * real replay (``executor=``) — each dispatched op is *executed* on device
    through a ``RestorationExecutor`` while the engine clock follows the
    recorded durations.  Restoration ops are idempotent (loads copy ground
    truth, chunk recomputes are causal and claimed disjointly), so executing
    them under the captured interleaving — including re-executing transfers
    a channel failure aborted — restores every cache bit-exactly.

This turns the schedule into a first-class artifact: a production incident
captured from a ``SimBackend`` (or real) run can be re-executed on the real
backend to reproduce its exact interleaving.

Since schema v2 the capture covers the whole request lifecycle: suffix
prefill ops appear as regular ``dispatch`` events (op kind ``prefill``) and
every batched decode step is a ``decode_step`` event with its participant
list and pinned duration; ``finish`` marks lifecycle completion.  v1
(restoration-only) traces load by upgrade — their lifecycle extents are
zero, so replay reproduces the old restore-and-stop behavior exactly.

Schema v3 adds preemption (DESIGN.md §9): requests carry their SLO class
(``priority``/``deadline``), meta carries the ``preempt`` policy, and
``preempt``/``resume`` events mark restorations suspended under admission
pressure.  Replay does not pin those decisions — they re-derive
deterministically from the pinned durations and recorded priorities, and
the bit-identity check covers ``EngineResult.preemptions``.

Schema v5 covers continuous batching (DESIGN.md §11): meta carries the
``admission`` mode and ``prefetch`` flag, gate events carry the live
``decode_load`` the benefit was priced against, and two new capture points
pin the queued-request prefetch path — ``prefetch_gate`` events record the
tier check that decided whether a queued request's chunks were worth
promoting (the KV store is absent at replay time, so the answer must be
pinned), and prefetch transfers appear as ordinary ``dispatch`` events with
op kind ``prefetch``.  Admissions/retires were already step-granular
(``admit``/``finish`` events); v4 traces upgrade with
admission="continuous"/prefetch=False, which reproduces them exactly.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.engine_core import (EngineBackend, EngineCore, EngineRequest,
                                    EngineResult, decode_restore_overlap)
from repro_torch.core.plans import RequestPlan
from repro_torch.core.scheduler import ScheduledOp

#: Schema history:
#:   1 — restoration-only traces (pre-lifecycle): no ``new_len``/
#:       ``decode_len`` on requests, no ``decode_step``/``finish`` events.
#:       Loaded by upgrading: lifecycle extents default to zero, so the
#:       replayed lifecycle collapses to RESTORING -> DONE exactly as the
#:       v1 engine behaved.
#:   2 — full request lifecycle: requests carry ``new_len``/``decode_len``;
#:       ``dispatch`` events may carry ``prefill`` ops; new ``decode_step``
#:       (batched decode, pinned duration) and ``finish`` events.
#:   3 — preemption: requests carry ``priority``/``deadline`` (omitted when
#:       default), meta carries the ``preempt`` policy, and new ``preempt``/
#:       ``resume`` events mark restorations suspended/re-admitted under
#:       admission pressure; the result carries ``preemptions``.  v2 traces
#:       load by upgrading — no priorities and preempt="none" reproduce the
#:       FCFS-only admission exactly, so replay is unchanged.
#:   4 — storage eviction mode: meta carries the engine's ``evict`` flag
#:       (preemption DROPS the partially-restored cache and resets its
#:       plans instead of parking, so the victim restarts from the KV
#:       store).  No new events — ``preempt``/``resume`` cover both modes;
#:       replay re-derives the restart from the flag.  v3 traces upgrade
#:       with evict=False (park mode), reproducing their runs exactly.
#:   5 — continuous batching: meta carries the ``admission`` mode
#:       ("continuous"/"gang") and the ``prefetch`` flag; ``gate`` events
#:       carry ``decode_load`` (live decode batch size the benefit gate
#:       priced against; omitted when 0); new ``prefetch_gate`` events pin
#:       the is-it-below-the-promote-tier answer for queued-request
#:       prefetch, and prefetch transfers are ``dispatch`` events with op
#:       kind ``prefetch``.  v4 traces upgrade with admission="continuous"
#:       and prefetch=False — no prefetch decisions were taken and
#:       decode_load never changed a recorded gate answer, so replay is
#:       unchanged.
TRACE_VERSION = 5

#: The schema version table: every event ``kind`` a trace may legally
#: contain, mapped to the schema version that introduced it.  This is the
#: single registry the tooling checks against — ``analysis/trace_lint``
#: rejects events with unknown kinds (or kinds newer than the trace's own
#: version), and ``analysis/codelint`` statically verifies that every
#: ``kind=`` a :class:`TraceRecorder` method emits is registered here.
#: Adding a recorder method without a registry entry is a lint error by
#: design: an unregistered kind would silently round-trip through JSON but
#: mean nothing to replay or to the linter.
EVENT_KINDS: Dict[str, int] = {
    "admit": 1,
    "gate": 1,
    "dispatch": 1,
    "complete": 1,
    "abort": 1,
    "fail": 1,
    "done": 1,
    "decode_step": 2,
    "finish": 2,
    "preempt": 3,
    "resume": 3,
    "prefetch_gate": 5,
}

#: Fields required on each event kind (beyond ``kind``/``t``) — the shape
#: half of schema validity.  ``dispatch`` additionally carries ``duration``;
#: gates carry their answer.  Optional fields (``bandwidth``,
#: ``decode_load``, ``batch``) are omitted when absent and not listed.
EVENT_REQUIRED_FIELDS: Dict[str, tuple] = {
    "admit": ("request_id",),
    "gate": ("request_id", "stage", "unit", "allowed"),
    "dispatch": ("resource", "op", "duration"),
    "complete": ("resource", "op"),
    "abort": ("resource", "op"),
    "fail": ("channel",),
    "done": ("request_id",),
    "decode_step": ("requests", "duration"),
    "finish": ("request_id",),
    "preempt": ("request_id",),
    "resume": ("request_id",),
    "prefetch_gate": ("request_id", "allowed"),
}


class TraceVersionError(ValueError):
    """The trace's schema version is missing or unsupported."""


class ReplayDivergence(RuntimeError):
    """Replay dispatched an op (or asked a gate question) that does not match
    the captured trace — the schedule drifted from the recording."""


# ---------------------------------------------------------------------------
# Serializable trace
# ---------------------------------------------------------------------------


@dataclass
class TraceEvent:
    """One engine-core decision.  ``kind`` ∈ {admit, gate, dispatch,
    complete, abort, fail, done, decode_step, finish, preempt, resume,
    prefetch_gate}; unused fields stay None (and are dropped from the JSON
    form).  ``done`` marks restoration complete; ``finish`` marks the whole
    lifecycle complete (slot freed); ``preempt``/``resume`` mark a
    restoration suspended under admission pressure / re-admitted to a freed
    slot; ``prefetch_gate`` pins the promote-this-queued-request decision."""
    kind: str
    t: float
    resource: Optional[str] = None       # dispatch/complete/abort: comp{s}|io{c}
    op: Optional[dict] = None            # dispatch/complete/abort
    duration: Optional[float] = None     # dispatch/decode_step: pinned secs
    bandwidth: Optional[float] = None    # dispatch (I/O): dispatch-time bytes/s
    request_id: Optional[str] = None     # admit/done/finish/gate/prefetch_gate
    stage: Optional[int] = None          # gate
    unit: Optional[int] = None           # gate
    allowed: Optional[bool] = None       # gate/prefetch_gate
    channel: Optional[int] = None        # fail
    requests: Optional[List[str]] = None  # decode_step: batched rids (sorted)
    decode_load: Optional[int] = None    # gate: live decode batch size (v5)

    def to_dict(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(**d)


def op_to_dict(op: ScheduledOp) -> dict:
    return {"kind": op.kind, "request_id": op.request_id, "stage": op.stage,
            "unit": op.unit, "tokens": list(op.tokens),
            "layers": list(op.layers)}


def plan_to_dict(p: RequestPlan) -> dict:
    return {"request_id": p.request_id, "n_tokens": p.n_tokens,
            "chunk_size": p.chunk_size, "strategy": p.strategy,
            "layer_lo": p.layer_lo, "layer_hi": p.layer_hi, "stage": p.stage,
            "comp_enabled": p.plan.comp_enabled,
            "io_enabled": p.plan.io_enabled}


def plan_from_dict(d: dict) -> RequestPlan:
    p = RequestPlan(d["request_id"], d["n_tokens"], d["chunk_size"],
                    d["strategy"], d["layer_lo"], d["layer_hi"],
                    stage=d["stage"])
    p.plan.comp_enabled = d["comp_enabled"]
    p.plan.io_enabled = d["io_enabled"]
    return p


def result_to_dict(res: EngineResult) -> dict:
    return {"restore_finish": dict(res.restore_finish),
            "restore_start": dict(res.restore_start),
            "first_token": dict(res.first_token),
            "finish": dict(res.finish),
            "makespan": res.makespan,
            "compute_busy": res.compute_busy,
            "io_busy": res.io_busy,
            "decode_busy": res.decode_busy,
            "decode_steps": res.decode_steps,
            "ops_log": [list(e) for e in res.ops_log],
            "preemptions": dict(res.preemptions),
            "overlap_decode_restore": res.overlap_decode_restore}


def result_from_dict(d: dict) -> EngineResult:
    # v1 results predate the lifecycle: no first token was produced and the
    # lifecycle finished at restore completion
    ops_log = [tuple(e) for e in d["ops_log"]]
    overlap = d.get("overlap_decode_restore")
    if overlap is None:
        # pre-v5 results: the overlap is a pure function of the ops log, so
        # recompute it — bit-identity against a fresh replay still holds
        overlap = decode_restore_overlap(ops_log)
    return EngineResult(
        restore_finish=dict(d["restore_finish"]),
        restore_start=dict(d["restore_start"]),
        first_token=dict(d.get("first_token") or {}),
        finish=dict(d.get("finish") if d.get("finish") is not None
                    else d["restore_finish"]),
        makespan=d["makespan"], compute_busy=d["compute_busy"],
        io_busy=d["io_busy"],
        decode_busy=d.get("decode_busy", 0.0),
        decode_steps=d.get("decode_steps", 0),
        ops_log=ops_log,
        preemptions=dict(d.get("preemptions") or {}),
        overlap_decode_restore=overlap)


@dataclass
class ScheduleTrace:
    """A complete, replayable recording of one ``EngineCore.run``."""
    meta: dict = field(default_factory=dict)       # engine config + backend name
    requests: List[dict] = field(default_factory=list)
    events: List[TraceEvent] = field(default_factory=list)
    result: Optional[dict] = None                  # result_to_dict(EngineResult)
    version: int = TRACE_VERSION

    # -- views ----------------------------------------------------------
    def dispatches(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "dispatch"]

    def gates(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "gate"]

    def aborts(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "abort"]

    def prefills(self) -> List[TraceEvent]:
        return [e for e in self.events
                if e.kind == "dispatch" and e.op["kind"] == "prefill"]

    def decode_steps(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "decode_step"]

    def captured_result(self) -> Optional[EngineResult]:
        return result_from_dict(self.result) if self.result else None

    def preempts(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "preempt"]

    def resumes(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "resume"]

    def prefetch_gates(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "prefetch_gate"]

    def prefetches(self) -> List[TraceEvent]:
        return [e for e in self.events
                if e.kind == "dispatch" and e.op["kind"] == "prefetch"]

    def rebuild_requests(self) -> List[EngineRequest]:
        """Fresh EngineRequests (pointers at origin) from the recorded specs."""
        return [EngineRequest(r["request_id"], r["n_tokens"], r["arrival"],
                              [plan_from_dict(p) for p in r["plans"]],
                              new_len=r.get("new_len", 0),
                              decode_len=r.get("decode_len", 0),
                              priority=r.get("priority", 0),
                              deadline=r.get("deadline", math.inf))
                for r in self.requests]

    # -- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return {"version": self.version, "meta": self.meta,
                "requests": self.requests,
                "events": [e.to_dict() for e in self.events],
                "result": self.result}

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleTrace":
        version = d.get("version")
        if version is None:
            raise TraceVersionError(
                "trace has no schema version; refusing to guess its format")
        if version not in (1, 2, 3, 4, TRACE_VERSION):
            raise TraceVersionError(
                f"unsupported trace schema version {version}; this loader "
                f"reads versions 1-4 (upgraded) and {TRACE_VERSION}")
        # v1 (pre-lifecycle), v2 (pre-preemption), v3 (pre-eviction) and v4
        # (pre-continuous-batching) traces upgrade implicitly:
        # rebuild_requests and result_from_dict default the missing
        # lifecycle extents / priorities / preemption / overlap fields, and
        # missing meta keys replay as preempt="none", evict=False,
        # admission="continuous", prefetch=False — so v1 collapses to
        # RESTORING -> DONE and v2+ keep their exact recorded admission
        fail_at = d["meta"].get("channel_fail_at") or {}
        meta = dict(d["meta"])
        # JSON stringifies int dict keys; coerce them back
        meta["channel_fail_at"] = {int(k): v for k, v in fail_at.items()}
        slow = d["meta"].get("channel_slowdown") or {}
        meta["channel_slowdown"] = {int(k): v for k, v in slow.items()}
        return cls(meta=meta, requests=d["requests"],
                   events=[TraceEvent.from_dict(e) for e in d["events"]],
                   result=d.get("result"), version=TRACE_VERSION)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ScheduleTrace":
        return cls.from_dict(json.loads(s))

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))

    @classmethod
    def load(cls, path: str) -> "ScheduleTrace":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------


class TraceRecorder:
    """Collects engine-core callbacks into a :class:`ScheduleTrace`.

    Pass an instance as ``EngineCore.run(requests, trace=recorder)`` (or via
    the simulator / serving-engine facades); after the run ``recorder.trace``
    holds the finished trace."""

    def __init__(self):
        self.trace: Optional[ScheduleTrace] = None

    def begin(self, meta: dict, requests: List[EngineRequest]):
        def req_dict(r: EngineRequest) -> dict:
            d = {"request_id": r.request_id, "n_tokens": r.n_tokens,
                 "arrival": r.arrival,
                 "new_len": r.new_len, "decode_len": r.decode_len,
                 "plans": [plan_to_dict(p) for p in r.plans]}
            if r.priority:
                d["priority"] = r.priority
            if math.isfinite(r.deadline):    # inf is not strict JSON
                d["deadline"] = r.deadline
            return d

        self.trace = ScheduleTrace(meta=meta,
                                   requests=[req_dict(r) for r in requests])

    def _ev(self, **kw):
        self.trace.events.append(TraceEvent(**kw))

    def record_admit(self, t: float, rid: str):
        self._ev(kind="admit", t=t, request_id=rid)

    def record_gate(self, t: float, rid: str, stage: int, unit: int,
                    allowed: bool, decode_load: int = 0):
        self._ev(kind="gate", t=t, request_id=rid, stage=stage, unit=unit,
                 allowed=allowed,
                 decode_load=decode_load if decode_load else None)

    def record_prefetch_gate(self, t: float, rid: str, allowed: bool):
        self._ev(kind="prefetch_gate", t=t, request_id=rid, allowed=allowed)

    def record_dispatch(self, t: float, resource: str, op: ScheduledOp,
                        duration: float, bandwidth: Optional[float]):
        self._ev(kind="dispatch", t=t, resource=resource, op=op_to_dict(op),
                 duration=duration, bandwidth=bandwidth)

    def record_complete(self, t: float, resource: str, op: ScheduledOp):
        self._ev(kind="complete", t=t, resource=resource, op=op_to_dict(op))

    def record_abort(self, t: float, resource: str, op: ScheduledOp):
        self._ev(kind="abort", t=t, resource=resource, op=op_to_dict(op))

    def record_fail(self, t: float, channel: int):
        self._ev(kind="fail", t=t, channel=channel)

    def record_done(self, t: float, rid: str):
        self._ev(kind="done", t=t, request_id=rid)

    def record_decode(self, t: float, rids: List[str], duration: float):
        self._ev(kind="decode_step", t=t, requests=list(rids),
                 duration=duration)

    def record_finish(self, t: float, rid: str):
        self._ev(kind="finish", t=t, request_id=rid)

    def record_preempt(self, t: float, rid: str):
        self._ev(kind="preempt", t=t, request_id=rid)

    def record_resume(self, t: float, rid: str):
        self._ev(kind="resume", t=t, request_id=rid)

    def finish(self, result: EngineResult):
        self.trace.result = result_to_dict(result)


def capture(core: EngineCore, requests: List[EngineRequest]
            ) -> "tuple[EngineResult, ScheduleTrace]":
    """Run ``core`` over ``requests`` while recording; returns both the
    result and the finished trace."""
    rec = TraceRecorder()
    res = core.run(requests, trace=rec)
    return res, rec.trace


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


class ReplayBackend(EngineBackend):
    """Re-executes a captured trace with pinned durations.

    Every ``compute_secs``/``io_secs`` call consumes the next recorded
    dispatch (validating op identity) and returns its recorded duration;
    every ``io_benefit`` call consumes the next recorded gate answer.  With
    an ``executor`` the dispatched ops additionally run on device (real
    replay); without one the replay is purely analytic (sim replay).
    ``verify_atol`` (the port's addition, as ``RealBackend``'s): None is the
    executor's default tolerance; an executor restoring from a quantized
    chunk store needs its int8 tolerance on top.
    """

    def __init__(self, trace: ScheduleTrace, executor=None, *,
                 verify: bool = False, verify_atol: Optional[float] = None):
        self.trace = trace
        self.executor = executor
        self.verify = verify
        self.verify_atol = verify_atol
        self._dispatches = trace.dispatches()
        self._gates = trace.gates()
        self._decodes = trace.decode_steps()
        self._pgates = trace.prefetch_gates()
        self._di = 0
        self._gi = 0
        self._dci = 0
        self._pgi = 0

    # -- helpers --------------------------------------------------------
    def _pop_dispatch(self, op: ScheduledOp, execute: bool = True) -> float:
        if self._di >= len(self._dispatches):
            raise ReplayDivergence(
                f"replay dispatched {op} past the end of the trace "
                f"({len(self._dispatches)} recorded dispatches)")
        e = self._dispatches[self._di]
        self._di += 1
        rec = e.op
        got = (op.kind, op.request_id, op.stage, op.unit)
        want = (rec["kind"], rec["request_id"], rec["stage"], rec["unit"])
        if got != want:
            raise ReplayDivergence(
                f"replay dispatch #{self._di - 1} diverged: engine issued "
                f"{got}, trace recorded {want}")
        if self.executor is not None and execute:
            self.executor.execute_op(op)
        return e.duration

    # -- EngineBackend --------------------------------------------------
    def admit(self, req: EngineRequest) -> None:
        if self.executor is not None:
            self.executor.begin_restore(req.request_id, plans=req.plans)

    def compute_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        return self._pop_dispatch(op)

    def io_secs(self, op: ScheduledOp, req: EngineRequest,
                bandwidth: Optional[float]) -> float:
        return self._pop_dispatch(op)

    def io_secs_partial(self, op: ScheduledOp, req: EngineRequest,
                        bandwidth: Optional[float], missing: float) -> float:
        # recorded durations already priced the missing fraction at capture
        # time — replay pins them verbatim, no re-scaling
        return self._pop_dispatch(op)

    def prefill_secs(self, op: ScheduledOp, req: EngineRequest) -> float:
        return self._pop_dispatch(op)

    def prefetch_secs(self, op: ScheduledOp, req: EngineRequest,
                      bandwidth: Optional[float]) -> float:
        # tier promotion happens inside the KV store, which is absent at
        # replay time — pin the duration but execute nothing on device
        return self._pop_dispatch(op, execute=False)

    def prefetch_gate(self, req: EngineRequest) -> bool:
        if self._pgi >= len(self._pgates):
            raise ReplayDivergence(
                f"replay prefetch-gate query ({req.request_id}) past the "
                f"end of the trace ({len(self._pgates)} recorded)")
        e = self._pgates[self._pgi]
        self._pgi += 1
        if e.request_id != req.request_id:
            raise ReplayDivergence(
                f"replay prefetch gate #{self._pgi - 1} diverged: engine "
                f"asked about {req.request_id}, trace recorded "
                f"{e.request_id}")
        return e.allowed

    def decode_secs(self, reqs: List[EngineRequest]) -> float:
        rids = [r.request_id for r in reqs]
        if self._dci >= len(self._decodes):
            raise ReplayDivergence(
                f"replay issued a decode step over {rids} past the end of "
                f"the trace ({len(self._decodes)} recorded decode steps)")
        e = self._decodes[self._dci]
        self._dci += 1
        if e.requests != rids:
            raise ReplayDivergence(
                f"replay decode step #{self._dci - 1} diverged: engine "
                f"batched {rids}, trace recorded {e.requests}")
        if self.executor is not None:
            self.executor.decode_step_batch(rids)
        return e.duration

    def suspend(self, req: EngineRequest) -> None:
        # real replay must park/unpark exactly as the capture did so that
        # re-executed (previously aborted) ops see a live, unparked cache
        if self.executor is not None:
            self.executor.suspend_restore(req.request_id)

    def evict(self, req: EngineRequest) -> None:
        # eviction-mode capture: the victim's live state was dropped; the
        # replayed restart re-executes every unit onto a fresh cache
        if self.executor is not None:
            self.executor.drop_restore(req.request_id)

    def resume(self, req: EngineRequest) -> None:
        if self.executor is not None:
            if self.executor.is_live(req.request_id):
                self.executor.resume_restore(req.request_id)
            else:
                self.executor.begin_restore(req.request_id, plans=req.plans)

    def io_benefit(self, plan: RequestPlan, unit: int,
                   bandwidth: Optional[float], slowdown: float = 1.0,
                   decode_load: int = 0) -> bool:
        if self._gi >= len(self._gates):
            raise ReplayDivergence(
                f"replay gate query ({plan.request_id}, stage {plan.stage}, "
                f"unit {unit}) past the end of the trace")
        e = self._gates[self._gi]
        self._gi += 1
        if (e.request_id, e.stage, e.unit) != (plan.request_id, plan.stage,
                                               unit):
            raise ReplayDivergence(
                f"replay gate #{self._gi - 1} diverged: engine asked about "
                f"({plan.request_id}, {plan.stage}, {unit}), trace recorded "
                f"({e.request_id}, {e.stage}, {e.unit})")
        return e.allowed

    def restore_done(self, req: EngineRequest) -> None:
        if self.executor is not None:
            self.executor.finalize_restore(req.request_id)
            if self.verify:
                if self.verify_atol is not None:
                    self.executor.verify(req.request_id, atol=self.verify_atol)
                else:
                    self.executor.verify(req.request_id)

    # -- post-run check -------------------------------------------------
    def assert_exhausted(self):
        """Every recorded decision must have been replayed."""
        if self._di != len(self._dispatches):
            raise ReplayDivergence(
                f"replay consumed {self._di}/{len(self._dispatches)} "
                f"recorded dispatches")
        if self._gi != len(self._gates):
            raise ReplayDivergence(
                f"replay consumed {self._gi}/{len(self._gates)} "
                f"recorded gate answers")
        if self._dci != len(self._decodes):
            raise ReplayDivergence(
                f"replay consumed {self._dci}/{len(self._decodes)} "
                f"recorded decode steps")
        if self._pgi != len(self._pgates):
            raise ReplayDivergence(
                f"replay consumed {self._pgi}/{len(self._pgates)} "
                f"recorded prefetch-gate answers")


def replay_core(trace: ScheduleTrace, backend: EngineBackend,
                *, strict: bool = True) -> EngineCore:
    """EngineCore configured exactly as the captured run — except channel
    slowdowns, which are already folded into the recorded durations, and the
    KV store, whose bandwidths/gates were recorded at capture time."""
    m = trace.meta
    return EngineCore(
        backend, stages=m["stages"], io_channels=m["io_channels"],
        io_policy=m["io_policy"],
        channel_fail_at=dict(m.get("channel_fail_at") or {}),
        stage_parallel=m["stage_parallel"], max_active=m["max_active"],
        preempt=m.get("preempt", "none"), evict=m.get("evict", False),
        admission=m.get("admission", "continuous"),
        prefetch=m.get("prefetch", False),
        strict=strict)


def replay_trace(trace: ScheduleTrace, executor=None, *, verify: bool = False,
                 strict: bool = True, trace_out: Optional[TraceRecorder] = None,
                 verify_atol: Optional[float] = None) -> EngineResult:
    """Re-run a captured schedule decision-for-decision.

    Without ``executor``: sim replay; the returned ``EngineResult`` is
    bit-identical to ``trace.captured_result()``.  With ``executor``: each
    dispatched op executes on device under the recorded interleaving
    (``verify=True`` additionally checks every restored cache against its
    full-prefill ground truth, within ``verify_atol`` when given).  Raises
    :class:`ReplayDivergence` if the re-derived schedule ever departs from
    the recording.
    """
    backend = ReplayBackend(trace, executor, verify=verify,
                            verify_atol=verify_atol)
    core = replay_core(trace, backend, strict=strict)
    res = core.run(trace.rebuild_requests(), trace=trace_out)
    backend.assert_exhausted()
    return res
