"""Offline linter for captured ``ScheduleTrace`` JSON (DESIGN.md §14).

A copy of ``repro.analysis.trace_lint``.

``python -m repro_torch.analysis.lint_trace trace.json`` statically re-derives
the schedule a trace claims the engine executed — plan pointer state,
per-resource occupancy, admission slots, gate answers — and reports every
place the recorded event stream is internally inconsistent.  It loads any
schema version the repo has ever written (v1–v5, via the existing
upgrader), so it runs unchanged on ``--trace-out`` artifacts from old
benchmarks and on traces uploaded from failing CI runs.

Rules (each independently toggleable via ``rules=``):

  * ``schema``          — every event kind registered in
    ``trace.EVENT_KINDS`` (and no newer than the trace's own version),
    required fields present, op dicts well-formed, request ids known.
  * ``causality``       — monotone timestamps; completions/aborts match an
    outstanding dispatch on that resource and land at exactly
    ``dispatch_t + duration``; pointer state is legal (units claimed in
    two-pointer order, restored at most once, no dispatches for requests
    not admitted / suspended / already restored); ``done``/``finish`` only
    after the state they summarize.
  * ``channel-overlap`` — at most one op in flight per resource (stage
    compute, I/O channel, the decode-batch resource).
  * ``gate-inversion``  — under the ``longest_remaining`` policy, a
    dispatched load whose plan sorts strictly worse than another runnable
    candidate must be justified by that candidate's recorded ``gate``
    answer being False in the same dispatch pass; a skipped candidate that
    passed its gate (or was never asked) is a benefit-gate inversion.
  * ``slot-leak``       — the admitted set never exceeds ``max_active``,
    no double admission / finish of a non-admitted request, and a COMPLETE
    trace (one with a result) retires every admitted request.
  * ``starvation``      — an admitted, still-restoring, unsuspended
    request that makes no progress for longer than ``starvation_bound``
    engine-seconds (default: half the trace span) while the engine keeps
    dispatching other work.
  * ``prefetch-race``   — prefetch/admission race misaccounting: a
    prefetch still in flight when its target is admitted must abort (its
    completion afterwards is the race the engine claims cannot happen),
    prefetches only for requests gated True and not yet admitted, one
    prefetch gate per request per ATTEMPT (a re-gate is legitimate only
    after the previous attempt's transfer aborted, e.g. channel failure).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.trace import (EVENT_KINDS, EVENT_REQUIRED_FIELDS,
                              ScheduleTrace, plan_from_dict)
from repro_torch.core.plans import TwoPointerPlan

ALL_RULES = ("schema", "causality", "channel-overlap", "gate-inversion",
             "slot-leak", "starvation", "prefetch-race")

#: op kinds a dispatch/complete/abort event may carry (decode steps are
#: their own event kind and never appear as dispatches)
OP_KINDS = ("compute", "load", "prefill", "prefetch")


@dataclass
class LintFinding:
    rule: str
    message: str
    event_index: int        # index into trace.events; -1 = trace-level
    t: float = 0.0

    def __str__(self):
        return f"[{self.rule}] event {self.event_index} t={self.t:.6g}: " \
               f"{self.message}"


@dataclass
class _Inflight:
    """One op occupying a resource between its dispatch and completion."""
    key: Tuple[str, str, int, int]   # (kind, rid, stage, unit)
    ev_idx: int
    t: float
    dur: float
    abort_expected: bool = False     # preempted / cancelled mid-flight


def _op_key(op: dict) -> Tuple[str, str, int, int]:
    return (op["kind"], op["request_id"], op["stage"], op["unit"])


class _TraceLinter:
    def __init__(self, trace: ScheduleTrace, *,
                 raw_version: Optional[int] = None,
                 starvation_bound: Optional[float] = None,
                 rules=None):
        self.trace = trace
        self.raw_version = raw_version
        self.starvation_bound = starvation_bound
        self.rules = set(rules) if rules is not None else set(ALL_RULES)
        self.findings: List[LintFinding] = []
        meta = trace.meta
        self.max_active = meta.get("max_active", 0) or 0
        self.evict = meta.get("evict", False)
        self.io_policy = meta.get("io_policy", "longest_remaining")
        self.stage_parallel = meta.get("stage_parallel", True)
        # -- per-request static specs ----------------------------------
        self.known: set = set()
        self.priority: Dict[str, int] = {}
        self.deadline: Dict[str, float] = {}
        self.plans: Dict[Tuple[str, int], object] = {}
        for r in trace.requests:
            rid = r["request_id"]
            self.known.add(rid)
            self.priority[rid] = r.get("priority", 0)
            self.deadline[rid] = r.get("deadline", math.inf)
            for p in r.get("plans", ()):
                self.plans[(rid, p["stage"])] = plan_from_dict(p)
        # -- dynamic state ---------------------------------------------
        self.admitted: set = set()
        self.ever_admitted: set = set()
        self.suspended: set = set()
        self.restored: set = set()
        self.finished: set = set()
        self.admit_order: Dict[str, int] = {}
        self._admit_seq = 0
        self.inflight: Dict[str, _Inflight] = {}     # resource -> op
        self.completed_units: Dict[Tuple[str, int], set] = {}
        self.decode_end = -math.inf
        self.pf_gate_count: Dict[str, int] = {}
        self.pf_gate_ok: Dict[str, bool] = {}
        self.last_progress: Dict[str, float] = {}
        self.starved: set = set()
        self.prev_t = -math.inf

    # ------------------------------------------------------------------
    def flag(self, rule: str, i: int, t: float, msg: str):
        if rule in self.rules:
            self.findings.append(LintFinding(rule, msg, i, t))

    def run(self) -> List[LintFinding]:
        events = self.trace.events
        span = (events[-1].t - events[0].t) if len(events) > 1 else 0.0
        self._starve_after = self.starvation_bound \
            if self.starvation_bound is not None \
            else (0.5 * span if span > 0 else math.inf)
        for i, e in enumerate(events):
            if not self._check_schema(i, e):
                continue
            if e.t < self.prev_t:
                self.flag("causality", i, e.t,
                          f"{e.kind} at t={e.t!r} precedes the previous "
                          f"event's t={self.prev_t!r}")
            self.prev_t = max(self.prev_t, e.t)
            handler = getattr(self, f"_on_{e.kind}", None)
            if handler is not None:
                handler(i, e)
        self._finish()
        return self.findings

    # -- schema ---------------------------------------------------------
    def _check_schema(self, i: int, e) -> bool:
        if e.kind not in EVENT_KINDS:
            self.flag("schema", i, e.t,
                      f"unknown event kind {e.kind!r} (not in EVENT_KINDS)")
            return False
        if self.raw_version is not None \
                and EVENT_KINDS[e.kind] > self.raw_version:
            self.flag("schema", i, e.t,
                      f"event kind {e.kind!r} requires schema v"
                      f"{EVENT_KINDS[e.kind]} but the trace is v"
                      f"{self.raw_version}")
        ok = True
        for f in EVENT_REQUIRED_FIELDS.get(e.kind, ()):
            if getattr(e, f, None) is None:
                self.flag("schema", i, e.t,
                          f"{e.kind} event missing required field {f!r}")
                ok = False
        if ok and e.op is not None:
            missing = {"kind", "request_id", "stage", "unit"} - set(e.op)
            if missing:
                self.flag("schema", i, e.t,
                          f"op dict missing keys {sorted(missing)}")
                ok = False
            elif e.op["kind"] not in OP_KINDS:
                self.flag("schema", i, e.t,
                          f"unknown op kind {e.op['kind']!r}")
                ok = False
            elif e.op["request_id"] not in self.known:
                self.flag("schema", i, e.t,
                          f"op references unknown request "
                          f"{e.op['request_id']!r}")
                ok = False
        if ok and e.request_id is not None \
                and e.request_id not in self.known:
            self.flag("schema", i, e.t,
                      f"{e.kind} references unknown request "
                      f"{e.request_id!r}")
            ok = False
        return ok

    # -- helpers --------------------------------------------------------
    def _progress(self, rid: str, t: float):
        self.last_progress[rid] = t

    def _starvation_scan(self, i: int, t: float):
        if "starvation" not in self.rules or self._starve_after is math.inf:
            return
        for rid in self.admitted:
            if rid in self.restored or rid in self.starved:
                continue
            last = self.last_progress.get(rid)
            if last is not None and t - last > self._starve_after:
                self.starved.add(rid)
                self.flag("starvation", i, t,
                          f"{rid} admitted and restoring but made no "
                          f"progress for {t - last:.6g}s (bound "
                          f"{self._starve_after:.6g}s) while other work "
                          f"dispatched")

    def _release_rid(self, rid: str, i: int, t: float):
        """Preemption: every in-flight op of ``rid`` will abort; claims
        release now, plans reset in eviction mode."""
        for res, fl in self.inflight.items():
            if fl.key[1] == rid and fl.key[0] in ("compute", "load"):
                fl.abort_expected = True
        for (r, stage), p in self.plans.items():
            if r != rid:
                continue
            if self.evict:
                p.plan = TwoPointerPlan(p.plan.n_units,
                                        comp_enabled=p.plan.comp_enabled,
                                        io_enabled=p.plan.io_enabled)
                self.completed_units.pop((r, stage), None)
            else:
                p.plan.release_claims()

    # -- event handlers -------------------------------------------------
    def _on_admit(self, i: int, e):
        rid = e.request_id
        if rid in self.admitted:
            self.flag("slot-leak", i, e.t,
                      f"{rid} admitted while already active")
        for res, fl in self.inflight.items():
            if fl.key[0] == "prefetch" and fl.key[1] == rid \
                    and not fl.abort_expected:
                self.flag("prefetch-race", i, e.t,
                          f"{rid} admitted while its prefetch on {res} is "
                          f"still in flight with no abort recorded")
                fl.abort_expected = True
        self.admitted.add(rid)
        self.ever_admitted.add(rid)
        self.suspended.discard(rid)
        if rid not in self.admit_order:
            self.admit_order[rid] = self._admit_seq
            self._admit_seq += 1
        self._progress(rid, e.t)
        if self.max_active and len(self.admitted) > self.max_active:
            self.flag("slot-leak", i, e.t,
                      f"active set size {len(self.admitted)} exceeds "
                      f"max_active {self.max_active}")

    def _on_resume(self, i: int, e):
        rid = e.request_id
        if rid not in self.suspended:
            self.flag("slot-leak", i, e.t,
                      f"resume of {rid} which is not suspended")
        self.suspended.discard(rid)
        self.admitted.add(rid)
        self._progress(rid, e.t)
        if self.max_active and len(self.admitted) > self.max_active:
            self.flag("slot-leak", i, e.t,
                      f"active set size {len(self.admitted)} exceeds "
                      f"max_active {self.max_active} (resume)")

    def _on_preempt(self, i: int, e):
        rid = e.request_id
        if rid not in self.admitted:
            self.flag("slot-leak", i, e.t,
                      f"preempt of {rid} which is not active")
        self.admitted.discard(rid)
        self.suspended.add(rid)
        self._release_rid(rid, i, e.t)

    def _on_finish(self, i: int, e):
        rid = e.request_id
        if rid not in self.admitted:
            self.flag("slot-leak", i, e.t,
                      f"finish of {rid} which is not active")
        if rid in self.finished:
            self.flag("slot-leak", i, e.t, f"{rid} finished twice")
        self.admitted.discard(rid)
        self.finished.add(rid)

    def _on_done(self, i: int, e):
        rid = e.request_id
        for (r, stage), p in self.plans.items():
            if r == rid and not p.plan.done:
                self.flag("causality", i, e.t,
                          f"done for {rid} but stage {stage} has "
                          f"{p.plan.remaining_units} unrestored units")
        self.restored.add(rid)
        self._progress(rid, e.t)

    def _on_fail(self, i: int, e):
        pass   # channel failures manifest as aborts, matched per-op

    def _on_prefetch_gate(self, i: int, e):
        rid = e.request_id
        n = self.pf_gate_count.get(rid, 0) + 1
        self.pf_gate_count[rid] = n
        self.pf_gate_ok[rid] = bool(e.allowed)
        if n > 1:
            self.flag("prefetch-race", i, e.t,
                      f"{rid} prefetch-gated {n} times without an "
                      f"intervening aborted attempt (each queued request "
                      f"is gated at most once per attempt)")

    def _on_gate(self, i: int, e):
        self._gates_block = getattr(self, "_gates_block", [])
        self._gates_block.append((i, e))

    def _on_decode_step(self, i: int, e):
        if e.t < self.decode_end:
            self.flag("channel-overlap", i, e.t,
                      f"decode step at t={e.t!r} overlaps the previous "
                      f"step ending at t={self.decode_end!r}")
        self.decode_end = e.t + e.duration
        for rid in e.requests:
            if rid in self.finished:
                self.flag("causality", i, e.t,
                          f"decode step includes finished request {rid}")
            elif rid not in self.admitted:
                self.flag("slot-leak", i, e.t,
                          f"decode step includes non-admitted request "
                          f"{rid}")
            self._progress(rid, e.t)
        self._starvation_scan(i, e.t)

    def _on_dispatch(self, i: int, e):
        op = e.op
        key = _op_key(op)
        kind, rid, stage, unit = key
        held = self.inflight.get(e.resource)
        if held is not None:
            self.flag("channel-overlap", i, e.t,
                      f"dispatch of {key} on {e.resource} while {held.key} "
                      f"(dispatched at t={held.t!r}) is still in flight")
        if e.duration is not None and e.duration < 0:
            self.flag("causality", i, e.t,
                      f"dispatch of {key} with negative duration "
                      f"{e.duration!r}")
        if kind == "prefetch":
            if rid in self.admitted or rid in self.finished:
                self.flag("prefetch-race", i, e.t,
                          f"prefetch dispatched for {rid} which is already "
                          f"admitted")
            if not self.pf_gate_ok.get(rid, False):
                self.flag("prefetch-race", i, e.t,
                          f"prefetch dispatched for {rid} without a "
                          f"passing prefetch_gate")
        else:
            if rid not in self.admitted:
                self.flag("causality", i, e.t,
                          f"{kind} op for {rid} dispatched while not "
                          f"admitted")
            if rid in self.suspended:
                self.flag("causality", i, e.t,
                          f"{kind} op for {rid} dispatched while suspended")
            self._progress(rid, e.t)
        if kind in ("compute", "load"):
            if rid in self.restored:
                self.flag("causality", i, e.t,
                          f"{kind} op for {rid} dispatched after its "
                          f"restoration completed")
            p = self.plans.get((rid, stage))
            if p is None:
                self.flag("schema", i, e.t,
                          f"dispatch references unknown plan "
                          f"({rid}, stage {stage})")
            elif kind == "compute":
                if p.plan.comp_inflight is not None:
                    self.flag("causality", i, e.t,
                              f"compute pointer of ({rid}, {stage}) "
                              f"already in flight on unit "
                              f"{p.plan.comp_inflight}")
                elif unit != p.plan.comp_next:
                    self.flag("causality", i, e.t,
                              f"compute claimed unit {unit} of "
                              f"({rid}, {stage}); pointer is at "
                              f"{p.plan.comp_next}")
                if unit in self.completed_units.get((rid, stage), ()):
                    self.flag("causality", i, e.t,
                              f"unit {unit} of ({rid}, {stage}) "
                              f"re-dispatched after restoration")
                p.plan.comp_inflight = unit
            else:
                if p.plan.io_inflight is not None:
                    self.flag("causality", i, e.t,
                              f"I/O pointer of ({rid}, {stage}) already "
                              f"in flight on unit {p.plan.io_inflight}")
                elif unit != p.plan.io_next:
                    self.flag("causality", i, e.t,
                              f"load claimed unit {unit} of "
                              f"({rid}, {stage}); pointer is at "
                              f"{p.plan.io_next}")
                if unit in self.completed_units.get((rid, stage), ()):
                    self.flag("causality", i, e.t,
                              f"unit {unit} of ({rid}, {stage}) "
                              f"re-dispatched after restoration")
                if kind == "load":
                    self._check_inversion(i, e, p)
                p.plan.io_inflight = unit
        self.inflight[e.resource] = _Inflight(key, i, e.t,
                                              e.duration or 0.0)
        self._gates_block = []
        self._starvation_scan(i, e.t)

    def _on_complete(self, i: int, e):
        op = e.op
        key = _op_key(op)
        kind, rid, stage, unit = key
        fl = self.inflight.get(e.resource)
        if fl is None or fl.key != key:
            self.flag("causality", i, e.t,
                      f"complete of {key} on {e.resource}, which holds "
                      f"{fl.key if fl else 'nothing'}")
            return
        del self.inflight[e.resource]
        if fl.abort_expected:
            rule = "prefetch-race" if kind == "prefetch" else "causality"
            self.flag(rule, i, e.t,
                      f"{key} completed on {e.resource} but should have "
                      f"aborted (its request was "
                      f"{'admitted mid-prefetch' if kind == 'prefetch' else 'preempted mid-op'})")
            return
        if e.t != fl.t + fl.dur:
            self.flag("causality", i, e.t,
                      f"{key} completed at t={e.t!r}; dispatched at "
                      f"t={fl.t!r} with duration {fl.dur!r} (expected "
                      f"{fl.t + fl.dur!r})")
        if kind in ("compute", "load"):
            p = self.plans.get((rid, stage))
            done = self.completed_units.setdefault((rid, stage), set())
            if unit in done:
                self.flag("causality", i, e.t,
                          f"unit {unit} of ({rid}, {stage}) restored twice")
            done.add(unit)
            if p is not None:
                if kind == "compute":
                    if p.plan.comp_inflight == unit:
                        p.plan.comp_inflight = None
                        p.plan.comp_next = unit + 1
                        p.plan.comp_done += 1
                else:
                    if p.plan.io_inflight == unit:
                        p.plan.io_inflight = None
                        p.plan.io_next = unit - 1
                        p.plan.io_done += 1
            self._progress(rid, e.t)

    def _on_abort(self, i: int, e):
        op = e.op
        key = _op_key(op)
        kind, rid, stage, unit = key
        fl = self.inflight.get(e.resource)
        if fl is None or fl.key != key:
            self.flag("causality", i, e.t,
                      f"abort of {key} on {e.resource}, which holds "
                      f"{fl.key if fl else 'nothing'}")
            return
        del self.inflight[e.resource]
        if kind == "prefetch":
            # the attempt aborted mid-flight (channel failure, or cancel
            # on losing the race with admission): a still-queued request
            # may be re-gated on a later pass, so the gate budget resets
            self.pf_gate_count[rid] = 0
            self.pf_gate_ok[rid] = False
        p = self.plans.get((rid, stage))
        if p is not None:
            # claim release (no pointer movement) — a preempted request's
            # claims were already released at preempt time, so only clear
            # when this exact unit is still marked in flight
            if kind == "compute" and p.plan.comp_inflight == unit:
                p.plan.comp_inflight = None
            elif kind == "load" and p.plan.io_inflight == unit:
                p.plan.io_inflight = None

    # -- gate-inversion reconstruction ---------------------------------
    def _check_inversion(self, i: int, e, p):
        if "gate-inversion" not in self.rules:
            return
        if self.io_policy != "longest_remaining" or not self.stage_parallel:
            return
        # runnable candidates exactly as BatchScheduler.next_io filters
        cands = []
        for (rid, stage), q in self.plans.items():
            if rid not in self.admitted or rid in self.suspended:
                continue
            pl = q.plan
            if not (pl.io_enabled and not pl.done
                    and pl.io_inflight is None
                    and pl.io_next >= pl.comp_next
                    and not (pl.comp_inflight is not None
                             and pl.io_next <= pl.comp_inflight)):
                continue
            cands.append(q)
        if not cands:
            return
        head = min((r for r in self.admitted
                    if r not in self.restored and r not in self.suspended),
                   key=lambda r: self.admit_order.get(r, 1 << 30),
                   default=None)

        def sort_key(q):
            return (-self.priority.get(q.request_id, 0),
                    self.deadline.get(q.request_id, math.inf),
                    q.request_id != head,
                    -q.remaining_io_tokens(),
                    self.admit_order.get(q.request_id, 1 << 30))

        my_key = sort_key(p)
        block = [(gi, g) for gi, g in getattr(self, "_gates_block", [])
                 if g.t == e.t]
        for q in cands:
            if q is p or sort_key(q) >= my_key:
                continue
            want = (q.request_id, q.stage, q.plan.io_next)
            answer = None
            for _gi, g in block:
                if (g.request_id, g.stage, g.unit) == want:
                    answer = g.allowed
            if answer is None:
                self.flag("gate-inversion", i, e.t,
                          f"load {p.request_id}:{p.stage} dispatched while "
                          f"{want} sorts strictly better and was never "
                          f"gated this pass")
            elif answer:
                self.flag("gate-inversion", i, e.t,
                          f"load {p.request_id}:{p.stage} dispatched while "
                          f"{want} sorts strictly better AND passed its "
                          f"benefit gate — dispatched op has lower "
                          f"marginal benefit than a runnable skipped one")

    # -- end of trace ---------------------------------------------------
    def _finish(self):
        t = self.prev_t if self.prev_t > -math.inf else 0.0
        if self.trace.result is not None:
            leaked = self.ever_admitted - self.finished
            if leaked:
                self.flag("slot-leak", -1, t,
                          f"trace has a result but requests never retired "
                          f"(slot leak): {sorted(leaked)}")
            if self.suspended:
                self.flag("slot-leak", -1, t,
                          f"trace has a result but requests left "
                          f"suspended: {sorted(self.suspended)}")
            for res, fl in sorted(self.inflight.items()):
                if not fl.abort_expected:
                    self.flag("causality", -1, t,
                              f"{fl.key} still in flight on {res} at end "
                              f"of a completed trace")


def lint_trace(trace: ScheduleTrace, *, raw_version: Optional[int] = None,
               starvation_bound: Optional[float] = None,
               rules=None) -> List[LintFinding]:
    """Lint a loaded trace; returns findings (empty = clean).

    ``raw_version`` is the schema version of the file BEFORE the loader
    upgraded it (``ScheduleTrace.from_dict`` normalizes ``version`` to the
    current schema) — pass it to enable the kind-vs-version schema check.
    ``starvation_bound`` overrides the no-progress bound in engine seconds
    (default: half the trace's time span).  ``rules`` restricts checking
    to a subset of :data:`ALL_RULES`."""
    return _TraceLinter(trace, raw_version=raw_version,
                        starvation_bound=starvation_bound,
                        rules=rules).run()


def lint_trace_file(path: str, *, starvation_bound: Optional[float] = None,
                    rules=None) -> List[LintFinding]:
    """Load ``path`` (any supported schema version) and lint it."""
    import json
    with open(path) as f:
        d = json.load(f)
    trace = ScheduleTrace.from_dict(d)
    return lint_trace(trace, raw_version=d.get("version"),
                      starvation_bound=starvation_bound, rules=rules)
