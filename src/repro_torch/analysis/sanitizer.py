"""Runtime invariant sanitizer for the engine core of the PyTorch port (a
copy of ``repro.analysis.sanitizer``, DESIGN.md §14).

``EngineCore(sanitize=True)`` (or ``CACHEFLOW_SANITIZE=1`` in the
environment) attaches an :class:`EngineSanitizer` to the event loop.  Every
hook is behind an ``if san is not None`` guard in the engine, so the
disabled path costs nothing; enabled, the sanitizer re-derives the loop's
bookkeeping independently and raises a structured
:class:`SanitizerViolation` the moment the engine's state departs from it.

Invariant classes checked (the catalog the last eight PRs established):

  * **two-pointer claims** — no restoration unit in flight on both pointers
    (or twice on one), no unit restored twice across abort/preempt/resume
    cycles (eviction legitimately resets a request's completed units).
  * **channel occupancy** — every resource (stage compute, I/O channel, the
    decode-batch resource) holds at most one op; completions/aborts only
    free a resource that op actually occupied.
  * **virtual time** — event times are monotone; each op completes at
    exactly ``dispatch_t + duration`` (bit-equal floats — the loop's heap
    arithmetic is deterministic); aborted-op rollback is exact: the
    sanitizer mirrors every busy-time add/subtract in engine order and the
    mirror must equal the engine's accounting bit-for-bit at run end.
  * **admission slots** — the active set never exceeds ``max_active``, no
    double admission, finishes/preemptions only remove requests that were
    admitted (conservation under continuous refill and preemption).
  * **block pool** — ``BlockPool.audit()`` refcount conservation, and every
    CoW ``copy()`` leaves the parent block's bytes bit-identical (checked
    by wrapping the pool's copy primitive while sanitizing).  The pool's
    blocks are tensors on its device, so the check snapshots them with
    ``clone()`` and compares with ``torch.equal`` there: one device sync a
    checked copy, paid only while sanitizing.
  * **storage byte conservation** — ``ChunkStore.audit()`` /
    ``PlacementCore.audit()`` at every restore completion and at run end,
    so tier-transition accounting drift is caught at the event that caused
    it.
  * **trace schema** — events recorded while sanitizing must carry a
    ``kind`` registered in ``repro_torch.core.trace.EVENT_KINDS``.

Violations carry the offending tail of the engine's ``ops_log`` so the
failing schedule window is in the exception, not just a counter.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.profiler import SanitizerCounters

#: ops_log entries attached to a violation (the schedule window that led
#: up to the failure).
WINDOW = 16


class SanitizerViolation(AssertionError):
    """An engine invariant broke.  ``check`` names the invariant class,
    ``t`` is the engine-clock instant, ``window`` the tail of the
    ``ops_log`` at the moment of failure."""

    def __init__(self, check: str, message: str, *, t: float = 0.0,
                 window: Optional[List[tuple]] = None):
        self.check = check
        self.t = t
        self.window = list(window or [])
        tail = "\n".join(f"    {w}" for w in self.window)
        super().__init__(
            f"[{check}] t={t:.6g}: {message}" +
            (f"\n  ops_log window:\n{tail}" if tail else ""))


class EngineSanitizer:
    """Independent re-derivation of the engine loop's bookkeeping.

    Constructed by ``EngineCore.run`` when sanitizing; ``bind`` hands it
    references to the loop's live accounting structures so run-end
    conservation checks compare against the engine's actual state (the
    mirror is maintained by the hooks in the same order the engine mutates
    its own, so float sums match bit-exactly)."""

    def __init__(self, core, counters: Optional[SanitizerCounters] = None):
        self.core = core
        self.counters = counters or SanitizerCounters()
        self.last_t = -math.inf
        self.ops_log: List[tuple] = []          # rebound in bind()
        # resource -> (op, desc) currently occupying it
        self.resource_busy: Dict[str, tuple] = {}
        # id(op) -> (resource, t_dispatch, duration) for exact-completion
        self.op_info: Dict[int, Tuple[str, float, float]] = {}
        # (rid, stage) -> {unit: "compute"|"load"} in-flight claims
        self.inflight: Dict[Tuple[str, int], Dict[int, str]] = {}
        # (rid, stage) -> completed unit set
        self.completed: Dict[Tuple[str, int], set] = {}
        self.active: set = set()
        self.suspended_set: set = set()
        self.finished: set = set()
        # (rid, stage) -> unit count, captured at admission (the plan
        # geometry the restore-completeness check needs)
        self.plan_units: Dict[Tuple[str, int], int] = {}
        # mirrors of the engine's busy accounting (same adds/subtracts in
        # the same order => bit-exact comparison at run end)
        self.busy_comp_mirror: Dict[int, float] = {}
        self.busy_io_mirror: Dict[int, float] = {}
        self.busy_decode_mirror = 0.0
        self._engine_busy = None     # (busy_comp, busy_io) references
        self._pool = None
        self._orig_copy = None

    # ------------------------------------------------------------------
    def bind(self, *, ops_log, busy_comp, busy_io):
        """Attach the engine loop's live structures (called once at run
        start, before any event)."""
        self.ops_log = ops_log
        self._engine_busy = (busy_comp, busy_io)
        self.busy_comp_mirror = {s: 0.0 for s in busy_comp}
        self.busy_io_mirror = {c: 0.0 for c in busy_io}
        pool = getattr(self.core.kvstore, "pool", None)
        if pool is not None:
            self._install_cow_check(pool)

    def _violate(self, check: str, message: str, t: Optional[float] = None):
        raise SanitizerViolation(
            check, message, t=self.last_t if t is None else t,
            window=self.ops_log[-WINDOW:])

    # -- block pool -----------------------------------------------------
    def _install_cow_check(self, pool):
        """Wrap the pool's CoW primitive: a ``copy(bid)`` must leave the
        parent block's bytes bit-identical (the whole point of CoW — a
        fork that mutates its parent corrupts every sibling)."""
        self._pool = pool
        self._orig_copy = pool.copy
        san = self

        def checked_copy(bid: int) -> int:
            # clone(): read() returns views into the pool's slabs, and the
            # snapshot must not change along with the parent; the compare
            # stays on the pool's device
            before = {f: v.clone() for f, v in pool.read(bid).items()}
            new = san._orig_copy(bid)
            after = pool.read(bid)
            for f, b in before.items():
                if not torch.equal(b, after[f]):
                    san._violate(
                        "cow-parent-mutated",
                        f"pool.copy({bid}) changed parent field {f!r}")
            for f, b in before.items():
                if not torch.equal(b, pool.read(new)[f]):
                    san._violate(
                        "cow-copy-diverged",
                        f"pool.copy({bid}) -> {new}: field {f!r} does not "
                        f"match the parent bytes")
            san.counters.cow_checks += 1
            san._note_refcounts()
            return new

        pool.copy = checked_copy

    def _note_refcounts(self):
        if self._pool is not None and self._pool.refcounts:
            hw = max(self._pool.refcounts)
            if hw > self.counters.pool_refcount_hw:
                self.counters.pool_refcount_hw = hw

    def _audit_stores(self):
        """Byte-conservation audits at tier transitions: the materialized
        store (``ChunkStore.audit`` covers ``PlacementCore.audit`` +
        ``BlockPool.audit``), or the sim store's placement core directly."""
        ks = self.core.kvstore
        if ks is None:
            return
        target = ks if hasattr(ks, "audit") else getattr(ks, "core", None)
        if target is None or not hasattr(target, "audit"):
            return
        try:
            target.audit()
        except AssertionError as e:
            self._violate("store-audit", f"{type(ks).__name__} accounting "
                          f"drift: {e}")
        self.counters.audits += 1
        self._note_refcounts()

    # -- event hooks ----------------------------------------------------
    def on_event(self, now: float, kind: str):
        self.counters.events += 1
        if now < self.last_t:
            self._violate("time-monotonic",
                          f"event {kind!r} at t={now!r} precedes "
                          f"t={self.last_t!r}", t=now)
        self.last_t = now

    def on_dispatch(self, now: float, resource: str, op, dur: float):
        """A compute/load/prefill/prefetch op placed on ``resource``."""
        self.counters.dispatches += 1
        if dur < 0:
            self._violate("negative-duration",
                          f"{op.kind} op {op.request_id}:{op.unit} "
                          f"dispatched with duration {dur!r}")
        held = self.resource_busy.get(resource)
        if held is not None:
            self._violate("channel-occupancy",
                          f"{resource} already occupied by {held[1]} when "
                          f"{op.kind} {op.request_id}:{op.unit} dispatched")
        desc = f"{op.kind}:{op.request_id}:s{op.stage}:u{op.unit}"
        self.resource_busy[resource] = (op, desc)
        self.op_info[id(op)] = (resource, now, dur)
        self._mirror_add(resource, dur)
        if op.kind in ("compute", "load"):
            self.counters.claims += 1
            key = (op.request_id, op.stage)
            units = self.inflight.setdefault(key, {})
            other = units.get(op.unit)
            if other is not None:
                who = "both pointers" if other != op.kind \
                    else f"the {op.kind} pointer twice"
                self._violate("double-claim",
                              f"unit {op.unit} of {key} claimed by {who}")
            if op.unit in self.completed.get(key, ()):
                self._violate("double-restore",
                              f"unit {op.unit} of {key} re-dispatched after "
                              f"it was already restored")
            units[op.unit] = op.kind
        if op.kind != "prefetch" and op.request_id not in self.active:
            self._violate("inactive-dispatch",
                          f"{op.kind} op for {op.request_id} dispatched "
                          f"while not admitted")

    def on_decode_dispatch(self, now: float, dur: float, rids):
        self.counters.dispatches += 1
        held = self.resource_busy.get("decode")
        if held is not None:
            self._violate("channel-occupancy",
                          f"decode step over {list(rids)} dispatched while "
                          f"a step over {held[1]} is in flight")
        self.resource_busy["decode"] = (None, ",".join(rids))
        self.busy_decode_mirror += dur

    def on_decode_done(self, now: float):
        if "decode" not in self.resource_busy:
            self._violate("channel-occupancy",
                          "decode_done with no decode step in flight")
        del self.resource_busy["decode"]
        self.counters.completions += 1

    def on_complete(self, now: float, resource: str, op):
        """Non-aborted completion: the op frees its resource and, for
        restoration kinds, its unit moves from in-flight to restored."""
        self.counters.completions += 1
        self._free_resource(resource, op, "complete")
        info = self.op_info.pop(id(op), None)
        if info is not None:
            _, t0, dur = info
            if now != t0 + dur:
                self._violate("completion-time",
                              f"{op.kind} {op.request_id}:{op.unit} on "
                              f"{resource} completed at t={now!r}, expected "
                              f"dispatch {t0!r} + duration {dur!r}")
        if op.kind in ("compute", "load"):
            key = (op.request_id, op.stage)
            units = self.inflight.get(key, {})
            if units.get(op.unit) != op.kind:
                self._violate("unclaimed-complete",
                              f"{op.kind} completion for unit {op.unit} of "
                              f"{key} that is not in flight on that pointer")
            del units[op.unit]
            done = self.completed.setdefault(key, set())
            if op.unit in done:
                self._violate("double-restore",
                              f"unit {op.unit} of {key} restored twice")
            done.add(op.unit)

    def on_abort(self, now: float, resource: str, op, *,
                 rolled_back: Optional[float] = None,
                 release_claim: bool = False):
        """An aborted op frees its resource.  ``rolled_back`` mirrors the
        engine subtracting the op's duration from the resource's busy time
        at THIS moment (channel failure / prefetch cancel); preempt-mode
        rollback already happened in :meth:`on_preempt`.  ``release_claim``
        returns the unit to the claimable pool (channel failure — the unit
        reschedules; preemption released claims at suspend time)."""
        self.counters.aborts += 1
        self._free_resource(resource, op, "abort")
        self.op_info.pop(id(op), None)
        if rolled_back is not None:
            self._mirror_add(resource, -rolled_back)
        if release_claim and op.kind in ("compute", "load"):
            self.inflight.get((op.request_id, op.stage), {}).pop(op.unit,
                                                                 None)

    def _free_resource(self, resource: str, op, what: str):
        held = self.resource_busy.get(resource)
        if held is None or held[0] is not op:
            desc = held[1] if held else "nothing"
            self._violate("channel-occupancy",
                          f"{what} of {op.kind} {op.request_id}:{op.unit} "
                          f"on {resource}, but {resource} holds {desc}")
        del self.resource_busy[resource]

    def _mirror_add(self, resource: str, dur: float):
        if resource.startswith("io"):
            self.busy_io_mirror[int(resource[2:])] += dur
        elif resource.startswith("comp"):
            self.busy_comp_mirror[int(resource[4:])] += dur

    # -- admission / preemption ----------------------------------------
    def on_admit(self, now: float, req):
        """``req`` is the EngineRequest being admitted (its plan geometry
        feeds the restore-completeness check)."""
        rid = req.request_id
        self.counters.admits += 1
        if rid in self.active:
            self._violate("slot-conservation",
                          f"{rid} admitted while already active")
        self.active.add(rid)
        self.suspended_set.discard(rid)
        for p in req.plans:
            self.plan_units[(rid, p.stage)] = p.plan.n_units
        self.note_active(len(self.active))
        if self.core.max_active and len(self.active) > self.core.max_active:
            self._violate("slot-overflow",
                          f"active batch {len(self.active)} exceeds "
                          f"max_active {self.core.max_active} "
                          f"(admitting {rid})")

    def on_suspend(self, now: float, rid: str, aborted_recs, evict: bool):
        """Preemption: mirror the engine's exact busy-time rollback for
        each in-flight op and release the sanitizer's claim state (evict
        additionally forgets completed units — the plans reset)."""
        self.counters.preemptions += 1
        if rid not in self.active:
            self._violate("slot-conservation",
                          f"preempt of {rid} which is not active")
        self.active.discard(rid)
        self.suspended_set.add(rid)
        for op, resource, dur, _li in aborted_recs:
            self._mirror_add(resource, -dur)
            # the resource stays physically occupied until the op's
            # completion event fires as an abort; only the claim releases
            self.inflight.get((op.request_id, op.stage), {}).pop(op.unit,
                                                                 None)
            self.op_info.pop(id(op), None)
        if evict:
            for key in list(self.completed):
                if key[0] == rid:
                    self.completed[key] = set()
            for key in list(self.inflight):
                if key[0] == rid:
                    self.inflight[key] = {}

    def on_resume(self, now: float, rid: str):
        self.counters.admits += 1
        if rid not in self.suspended_set:
            self._violate("slot-conservation",
                          f"resume of {rid} which is not suspended")
        self.suspended_set.discard(rid)
        if rid in self.active:
            self._violate("slot-conservation",
                          f"resume of {rid} which is already active")
        self.active.add(rid)
        self.note_active(len(self.active))
        if self.core.max_active and len(self.active) > self.core.max_active:
            self._violate("slot-overflow",
                          f"active batch {len(self.active)} exceeds "
                          f"max_active {self.core.max_active} "
                          f"(resuming {rid})")

    def on_finish(self, now: float, rid: str):
        self.counters.finishes += 1
        if rid not in self.active:
            self._violate("slot-conservation",
                          f"finish of {rid} which is not active")
        self.active.discard(rid)
        if rid in self.finished:
            self._violate("slot-conservation", f"{rid} finished twice")
        self.finished.add(rid)

    def on_restore_done(self, now: float, rid: str):
        """All stage plans of ``rid`` restored: every unit must be
        accounted for exactly once, and the stores must balance."""
        for (r, stage), n in self.plan_units.items():
            if r != rid:
                continue
            done = self.completed.get((r, stage), set())
            missing = set(range(n)) - done
            if missing:
                self._violate("restore-incomplete",
                              f"{rid} stage {stage} reported restored with "
                              f"units {sorted(missing)} never completed")
            if self.inflight.get((r, stage)):
                self._violate("restore-incomplete",
                              f"{rid} stage {stage} reported restored with "
                              f"units still in flight: "
                              f"{self.inflight[(r, stage)]}")
        self._audit_stores()

    # -- run end --------------------------------------------------------
    def on_run_end(self, *, active, pending, suspended):
        """Conservation at the end of the run: every resource free, busy
        accounting bit-equal to the mirror (exact abort rollback), slot
        sets consistent with the engine's, stores balanced."""
        if self.resource_busy:
            self._violate("channel-occupancy",
                          f"run ended with resources still occupied: "
                          f"{ {r: d for r, (_o, d) in self.resource_busy.items()} }")
        busy_comp, busy_io = self._engine_busy
        for s, v in busy_comp.items():
            if v != self.busy_comp_mirror.get(s):
                self._violate(
                    "rollback-exact",
                    f"comp{s} busy accounting {v!r} != mirrored "
                    f"{self.busy_comp_mirror.get(s)!r} (inexact abort "
                    f"rollback)")
        for c, v in busy_io.items():
            if v != self.busy_io_mirror.get(c):
                self._violate(
                    "rollback-exact",
                    f"io{c} busy accounting {v!r} != mirrored "
                    f"{self.busy_io_mirror.get(c)!r} (inexact abort "
                    f"rollback)")
        if set(active) != self.active:
            self._violate("slot-conservation",
                          f"engine active set {sorted(active)} != sanitizer "
                          f"view {sorted(self.active)}")
        if set(suspended) != self.suspended_set:
            self._violate("slot-conservation",
                          f"engine suspended set {sorted(suspended)} != "
                          f"sanitizer view {sorted(self.suspended_set)}")
        self._audit_stores()
        if self._pool is not None and self._orig_copy is not None:
            self._pool.copy = self._orig_copy

    # -- trace schema ---------------------------------------------------
    def on_trace_event(self, ev):
        """Schema validity of an event recorded while sanitizing: its kind
        must be registered in the schema version table."""
        from repro_torch.core.trace import EVENT_KINDS
        if ev.kind not in EVENT_KINDS:
            self._violate("trace-schema",
                          f"recorded event kind {ev.kind!r} is not "
                          f"registered in trace.EVENT_KINDS")

    def note_active(self, n: int):
        if n > self.counters.max_active:
            self.counters.max_active = n
