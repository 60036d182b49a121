"""Batch-aware 3D two-pointer scheduler (paper Algorithm 1), phase-aware.

The scheduler owns the plan state of every active request (per stage) and
answers two questions whenever a resource frees up:

  * ``next_io(stage/channel)``      — which request's I/O pointer advances?
    CacheFlow policy: the request with the LARGEST remaining restoration
    length (highest marginal recomputation saving, §3.3). Baselines: fifo /
    round-robin / shortest-first for the ablations.
  * ``next_compute(stage)``         — which request's compute pointer
    advances? Compute is batched round-robin (every request makes progress,
    Algorithm 1 line 10).

Beyond restoration, the scheduler generates *lifecycle* candidates: once a
request finishes restoring, ``begin_prefill`` registers its suffix-prefill
pipeline (one op per stage, in stage order — the forward pass threads the
pipeline), and ``next_compute`` arbitrates FCFS between restoration chunks
and prefill ops on the same stage compute resource. Batched decode runs on
its own resource and is driven by the engine core directly.

It is deliberately execution-agnostic: the discrete-event simulator and the
real executor both drive it, so the *same* scheduling decisions are
measured for performance and checked for correctness.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.plans import RequestPlan, TwoPointerPlan

IO_POLICIES = ("longest_remaining", "fifo", "shortest_remaining", "round_robin")


@dataclass
class ScheduledOp:
    kind: str            # "compute" | "load" | "prefill" | "decode"
    request_id: str
    stage: int
    unit: int
    tokens: Tuple[int, int]
    layers: Tuple[int, int]
    # decode steps only: the FULL participant list (arrival order), so
    # synthetic duration functions / per-op hooks see the true batch
    # composition instead of a fabricated batch of one (request_id is the
    # first participant for backward compatibility)
    batch: Tuple[str, ...] = ()


@dataclass
class PrefillPipeline:
    """Suffix-prefill state for one restored request: one op per pipeline
    stage, executed in stage order (stage s consumes stage s-1's boundary
    activations of the *suffix*, so the ops are sequentially dependent)."""
    tokens: Tuple[int, int]                 # (n_prefix, n_prefix + new_len)
    stages: List[Tuple[int, int, int]]      # (stage, layer_lo, layer_hi) asc
    next_idx: int = 0
    inflight: bool = False


@dataclass
class BatchScheduler:
    io_policy: str = "longest_remaining"
    # marginal-benefit gate (§3.3): only spend I/O on a unit if loading it
    # avoids more recomputation time than the transfer costs. None = eager.
    benefit_fn: object = None      # Callable[[RequestPlan, int], bool]
    plans: Dict[Tuple[str, int], RequestPlan] = field(default_factory=dict)
    # O(1) indexes so dispatch stays near O(B log B) at large batch sizes:
    # arrival sequence number per request (sort key + membership), plans
    # bucketed by stage (compute dispatch) and by request (request_done).
    arrival_index: Dict[str, int] = field(default_factory=dict)
    # SLO class per request (continuous arrivals): a higher-priority /
    # tighter-deadline request's transfers jump a congested channel queue —
    # its urgency leads the longest_remaining dispatch key.  Defaults
    # (priority 0, no deadline) reproduce the classic ordering exactly.
    priority: Dict[str, int] = field(default_factory=dict)
    deadline: Dict[str, float] = field(default_factory=dict)
    # requests preempted mid-restoration: claims released, no candidates
    # generated until resume() (engine-core preemption policy drives this)
    suspended: set = field(default_factory=set)
    _by_stage: Dict[int, "Dict[str, RequestPlan]"] = field(default_factory=dict)
    _by_rid: Dict[str, List[RequestPlan]] = field(default_factory=dict)
    _arrival_seq: int = 0
    _rr_io: int = 0
    _rr_comp: Dict[int, int] = field(default_factory=dict)
    # lifecycle state: suffix-prefill pipelines of requests CURRENTLY in the
    # prefill phase (pruned on completion so candidate scans stay bounded by
    # the in-phase population, not the whole batch)
    _prefill: Dict[str, PrefillPipeline] = field(default_factory=dict)
    _prefill_finished: set = field(default_factory=set)
    # O(log B) restoration-head index (ROADMAP open item): a lazy min-heap of
    # (arrival seq, rid) with fully-restored requests skipped on peek, so
    # ``next_io`` no longer rescans arrival_order × stages per dispatch.
    _head_heap: List[Tuple[int, str]] = field(default_factory=list)
    _restored: set = field(default_factory=set)

    # ------------------------------------------------------------------
    def add_request(self, plans: List[RequestPlan], *, priority: int = 0,
                    deadline: float = math.inf):
        rid = plans[0].request_id
        if rid not in self.arrival_index:
            self.arrival_index[rid] = self._arrival_seq
            heapq.heappush(self._head_heap, (self._arrival_seq, rid))
            self._arrival_seq += 1
        if priority:
            self.priority[rid] = priority
        if math.isfinite(deadline):
            self.deadline[rid] = deadline
        self._by_rid[rid] = list(plans)
        for p in plans:
            self.plans[(rid, p.stage)] = p
            self._by_stage.setdefault(p.stage, {})[rid] = p

    def remove_request(self, rid: str):
        # O(stages): every index is a dict/set keyed by rid (the head heap
        # drops its entry lazily on peek)
        self.arrival_index.pop(rid, None)
        self.priority.pop(rid, None)
        self.deadline.pop(rid, None)
        self._restored.discard(rid)
        self.suspended.discard(rid)
        self._prefill.pop(rid, None)
        self._prefill_finished.discard(rid)
        for p in self._by_rid.pop(rid, []):
            self.plans.pop((rid, p.stage), None)
            self._by_stage.get(p.stage, {}).pop(rid, None)

    # ------------------------------------------------------------------
    def _stage_plans(self, stage: int) -> List[RequestPlan]:
        return list(self._by_stage.get(stage, {}).values())

    def stages(self) -> List[int]:
        return sorted(s for s, d in self._by_stage.items() if d)

    def request_done(self, rid: str) -> bool:
        """All stage plans restored (restoration phase complete)."""
        if rid in self._restored:
            return True
        ps = self._by_rid.get(rid, ())
        return bool(ps) and all(p.plan.done for p in ps)

    def all_done(self) -> bool:
        return all(p.plan.done for p in self.plans.values())

    def remaining_restoration(self, rid: str) -> int:
        """Tokens' worth of KV still to restore across every stage plan —
        the request's remaining marginal recompute saving (§3.3).  The
        engine's preemption policy suspends the active request where this is
        SMALLEST (the dual of the largest-remaining dispatch key)."""
        return sum(p.remaining_io_tokens() for p in self._by_rid.get(rid, ()))

    # ------------------------------------------------------------------
    # Preempt / resume (engine-core admission pressure)
    # ------------------------------------------------------------------
    def preempt(self, rid: str, reset: bool = False):
        """Suspend a restoring request: release BOTH pointers' claims on
        every stage plan (the released units become claimable again — the
        plan state machine makes re-execution idempotent) and stop
        generating candidates for it until :meth:`resume`.  Completed units
        are untouched, so resumption continues rather than restarts —
        unless ``reset=True`` (engine-core EVICTION mode): every stage plan
        is rebuilt at its origin, because the partially-restored cache was
        dropped and restoration must restart from the KV store."""
        self.suspended.add(rid)
        for p in self._by_rid.get(rid, ()):
            if reset:
                p.plan = TwoPointerPlan(p.plan.n_units,
                                        comp_enabled=p.plan.comp_enabled,
                                        io_enabled=p.plan.io_enabled)
            else:
                p.plan.release_claims()

    def resume(self, rid: str):
        """Re-admit a suspended request: it competes for resources again
        from exactly the plan state it was suspended with."""
        self.suspended.discard(rid)
        if rid in self.arrival_index and rid not in self._restored:
            # the head heap may have lazily dropped its entry while it was
            # suspended; re-push (duplicates are harmless — lazy skip)
            heapq.heappush(self._head_heap, (self.arrival_index[rid], rid))

    def _restoration_head(self) -> Optional[str]:
        """Oldest admitted request still restoring — O(log B) amortized via
        the lazy heap (entries for restored/removed/suspended requests drop
        on peek; ``resume`` re-pushes its entry)."""
        h = self._head_heap
        while h and (h[0][1] in self._restored
                     or h[0][1] not in self.arrival_index
                     or h[0][1] in self.suspended):
            heapq.heappop(h)
        return h[0][1] if h else None

    # ------------------------------------------------------------------
    # Lifecycle: suffix prefill (phase-aware candidate generation)
    # ------------------------------------------------------------------
    def begin_prefill(self, rid: str, n_tokens: int, new_len: int):
        """Register the restored request's suffix-prefill pipeline: one op
        per stage over tokens [n_tokens, n_tokens + new_len), in stage
        order, competing FCFS with restoration chunks in next_compute."""
        plans = sorted(self._by_rid[rid], key=lambda p: p.stage)
        self._prefill[rid] = PrefillPipeline(
            (n_tokens, n_tokens + new_len),
            [(p.stage, p.layer_lo, p.layer_hi) for p in plans])

    def prefill_done(self, rid: str) -> bool:
        return rid in self._prefill_finished

    def _prefill_candidate(self, stage: int, skip) -> Optional[str]:
        best = None
        for rid, st in self._prefill.items():
            if st.inflight or rid in self.suspended:
                continue
            if st.stages[st.next_idx][0] != stage or (rid, stage) in skip:
                continue
            if best is None or self.arrival_index[rid] < self.arrival_index[best]:
                best = rid
        return best

    def _claim_prefill(self, rid: str) -> ScheduledOp:
        st = self._prefill[rid]
        s, lo, hi = st.stages[st.next_idx]
        st.inflight = True
        return ScheduledOp("prefill", rid, s, st.next_idx, st.tokens, (lo, hi))

    # ------------------------------------------------------------------
    # Algorithm 1 line 6: I/O channel assignment
    # ------------------------------------------------------------------
    def next_io(self, stage: Optional[int] = None,
                skip: "frozenset[Tuple[str, int]]" = frozenset()
                ) -> Optional[ScheduledOp]:
        """``skip``: (request_id, stage) pairs the caller already found
        stage-blocked this dispatch round — excluded so their claims are not
        immediately re-taken."""
        cands = [p for p in self.plans.values()
                 if (stage is None or p.stage == stage)
                 and (p.request_id, p.stage) not in skip
                 and p.request_id not in self.suspended]
        cands = [p for p in cands
                 if p.plan.io_enabled
                 and not p.plan.done and p.plan.io_inflight is None
                 and p.plan.io_next >= p.plan.comp_next
                 and not (p.plan.comp_inflight is not None
                          and p.plan.io_next <= p.plan.comp_inflight)]
        if not cands:
            return None
        if self.io_policy == "longest_remaining":
            # Batch-aware two-pointer priority (§3.3), operationalised for
            # FCFS chunked-prefill compute: (0) a strictly more urgent SLO
            # class (higher priority, then earlier first-token deadline)
            # jumps the channel queue — under continuous arrivals a
            # deadline-tight request must not wait behind a bulk request's
            # long restoration; then (1) the compute-head request's
            # transfers are on the TTFT critical path — serve them first;
            # (2) surplus channel time prefetches the request with the
            # largest remaining restoration (highest marginal recompute
            # saving under quadratic attention), which is what shrinks the
            # tail (paper Fig. 4 P90–P99).
            head = self._restoration_head()
            cands.sort(key=lambda p: (-self.priority.get(p.request_id, 0),
                                      self.deadline.get(p.request_id, math.inf),
                                      p.request_id != head,
                                      -p.remaining_io_tokens(),
                                      self.arrival_index[p.request_id]))
        elif self.io_policy == "shortest_remaining":
            cands.sort(key=lambda p: (p.remaining_io_tokens(),
                                      self.arrival_index[p.request_id]))
        elif self.io_policy == "fifo":
            cands.sort(key=lambda p: self.arrival_index[p.request_id])
        elif self.io_policy == "round_robin":
            self._rr_io += 1
            cands = cands[self._rr_io % len(cands):] + cands[:self._rr_io % len(cands)]
        for p in cands:
            if self.benefit_fn is not None and not self.benefit_fn(p, p.plan.io_next):
                continue
            unit = p.plan.claim_io()
            if unit is None:
                continue
            tokens, layers = p.io_unit_for_claim(unit)
            return ScheduledOp("load", p.request_id, p.stage, unit, tokens, layers)
        return None

    # ------------------------------------------------------------------
    # Algorithm 1 line 10: compute assignment. FCFS by default — chunked
    # prefill of the oldest unfinished request, matching continuous-batching
    # engines (round-robin / processor-sharing inflates mean TTFT).
    # ------------------------------------------------------------------
    compute_policy: str = "fifo"

    def next_compute(self, stage: int = 0,
                     skip: "frozenset[Tuple[str, int]]" = frozenset()
                     ) -> Optional[ScheduledOp]:
        plans = [p for p in self._stage_plans(stage)
                 if (p.request_id, p.stage) not in skip
                 and p.request_id not in self.suspended
                 and p.plan.comp_enabled
                 and not p.plan.done and p.plan.comp_inflight is None
                 and p.plan.comp_next <= p.plan.io_next
                 and not (p.plan.io_inflight is not None
                          and p.plan.comp_next >= p.plan.io_inflight)]
        prefill = self._prefill_candidate(stage, skip)
        if not plans:
            return self._claim_prefill(prefill) if prefill is not None else None
        plans.sort(key=lambda p: self.arrival_index[p.request_id])
        if self.compute_policy == "round_robin":
            p = plans[self._rr_comp.get(stage, 0) % len(plans)]
        else:
            p = plans[0]
        # phase-aware FCFS: a restored request's suffix prefill competes with
        # other requests' restoration chunks on this stage's compute resource
        if prefill is not None and \
                self.arrival_index[prefill] < self.arrival_index[p.request_id]:
            return self._claim_prefill(prefill)
        if self.compute_policy == "round_robin":
            # rotate only when the restoration plan actually gets the slot
            self._rr_comp[stage] = self._rr_comp.get(stage, 0) + 1
        unit = p.plan.claim_compute()
        if unit is None:
            return None
        if p.strategy == "token":
            tokens = p.unit_tokens(unit)
            layers = (p.layer_lo, p.layer_hi)
        else:
            tokens = (0, p.n_tokens)
            layers = p.unit_layers(unit)
        return ScheduledOp("compute", p.request_id, p.stage, unit, tokens, layers)

    # ------------------------------------------------------------------
    def complete(self, op: ScheduledOp) -> Optional[str]:
        """Advance the op's pointer.  Returns the request id iff THIS
        completion finished the request's restoration (all stage plans
        done) — the engine transitions exactly that request's phase instead
        of rescanning the whole active batch per event."""
        if op.kind == "prefill":
            st = self._prefill[op.request_id]
            st.inflight = False
            st.next_idx += 1
            if st.next_idx >= len(st.stages):
                # pipeline finished: prune so it stops costing candidate scans
                del self._prefill[op.request_id]
                self._prefill_finished.add(op.request_id)
            return None
        p = self.plans[(op.request_id, op.stage)]
        if op.kind == "compute":
            p.plan.complete_compute(op.unit)
        else:
            p.plan.complete_io(op.unit)
        # keep the restoration-head index current (O(stages), once per op)
        if p.plan.done and op.request_id not in self._restored \
                and all(q.plan.done for q in self._by_rid[op.request_id]):
            self._restored.add(op.request_id)
            return op.request_id
        return None
