"""Two-pointer restoration plans (paper §3.1).

A plan is a small state machine over *work units*:

  token-wise:  units are token chunks [c·C, (c+1)·C). The compute pointer
               claims chunks from the front (chunk recompute must be causal);
               the I/O pointer claims chunks from the back. Done when the
               pointers meet — the meeting point self-adapts to the actual
               compute/I-O rates, which is the essence of the design.
  layer-wise:  units are layers. Compute claims layers bottom-up (the forward
               pass produces layer KV as a byproduct); I/O claims top-down.
  3D:          one 2D plan per pipeline stage over its layer range; stages
               are independent given boundary activations (paper §3.2).

The plan only tracks claims/completions — *when* units run is the
scheduler's job. Invariants (property-tested):
  * compute and I/O never claim the same unit,
  * every unit is restored exactly once,
  * done ⇔ all units restored.

Claims are *releasable*: ``release_compute``/``release_io``/
``release_claims`` return an in-flight unit to the claimable pool without
advancing any pointer, so an aborted transfer (channel failure) or a
preempted request reschedules the exact same unit later — completion
counters never move on release, which is what keeps "every unit restored
exactly once" true across abort/preempt/resume cycles.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Unit = Tuple[str, int]   # ("compute"|"load", index)


@dataclass
class TwoPointerPlan:
    """Two-pointer claim machine over ``n_units`` units.

    Compute claims ascending from 0; I/O claims descending from n_units-1.
    """
    n_units: int
    comp_next: int = 0            # next unit compute would claim
    io_next: int = field(default=-1)
    comp_inflight: Optional[int] = None
    io_inflight: Optional[int] = None
    comp_done: int = 0            # units [0, comp_done) recomputed
    io_done: int = 0              # units [n-io_done, n) loaded
    comp_enabled: bool = True     # False => load-only baseline (LMCache)
    io_enabled: bool = True       # False => recompute-only baseline (vLLM)

    def __post_init__(self):
        if self.io_next < 0:
            self.io_next = self.n_units - 1

    # -- claims ---------------------------------------------------------
    def claim_compute(self) -> Optional[int]:
        if (not self.comp_enabled or self.comp_inflight is not None
                or self.comp_next > self.io_next):
            return None
        # never claim the unit I/O is currently transferring (symmetric to
        # claim_io's guard): when the pointers meet on unit u with the
        # transfer still in flight, claiming u here would restore it twice
        if self.io_inflight is not None and self.comp_next >= self.io_inflight:
            return None
        self.comp_inflight = self.comp_next
        return self.comp_next

    def claim_io(self) -> Optional[int]:
        if (not self.io_enabled or self.io_inflight is not None
                or self.io_next < self.comp_next):
            return None
        # never claim the unit compute is currently working on
        if self.comp_inflight is not None and self.io_next <= self.comp_inflight:
            return None
        self.io_inflight = self.io_next
        return self.io_next

    # -- releases (abort / preempt) -------------------------------------
    def release_compute(self):
        """Return the in-flight compute claim (if any) to the pool.  The
        pointer does not advance: the unit is claimed again verbatim on the
        next ``claim_compute``."""
        self.comp_inflight = None

    def release_io(self):
        """Return the in-flight I/O claim (if any) to the pool (aborted
        transfer / preemption); the unit reschedules idempotently."""
        self.io_inflight = None

    def release_claims(self):
        """Suspend: release BOTH pointers' claims.  Completed units are
        untouched, so a preempted plan resumes exactly where it left off."""
        self.release_compute()
        self.release_io()

    # -- completions ----------------------------------------------------
    def complete_compute(self, unit: int):
        assert self.comp_inflight == unit
        self.comp_inflight = None
        self.comp_next = unit + 1
        self.comp_done += 1

    def complete_io(self, unit: int):
        assert self.io_inflight == unit
        self.io_inflight = None
        self.io_next = unit - 1
        self.io_done += 1

    # -- state ----------------------------------------------------------
    @property
    def done(self) -> bool:
        return (self.comp_done + self.io_done >= self.n_units
                and self.comp_inflight is None and self.io_inflight is None)

    @property
    def remaining_units(self) -> int:
        return self.n_units - self.comp_done - self.io_done

    def restored_units(self) -> List[Tuple[str, int]]:
        out = [("compute", i) for i in range(self.comp_done)]
        out += [("load", self.n_units - 1 - i) for i in range(self.io_done)]
        return out


@dataclass
class RequestPlan:
    """Restoration plan for one request on one stage.

    strategy: "token" | "layer"; for token plans units are chunks of
    ``chunk_size`` tokens across layer range [layer_lo, layer_hi); for layer
    plans units are the layers themselves (over all n_tokens).
    """
    request_id: str
    n_tokens: int                  # cached prefix length to restore (N_c)
    chunk_size: int
    strategy: str
    layer_lo: int
    layer_hi: int
    stage: int = 0
    plan: Optional[TwoPointerPlan] = None

    def __post_init__(self):
        if self.plan is None:
            n = (math.ceil(self.n_tokens / self.chunk_size) if self.strategy == "token"
                 else self.layer_hi - self.layer_lo)
            self.plan = TwoPointerPlan(max(1, n))

    # -- unit -> token/layer ranges --------------------------------------
    def unit_tokens(self, unit: int) -> Tuple[int, int]:
        if self.strategy == "token":
            return (unit * self.chunk_size,
                    min(self.n_tokens, (unit + 1) * self.chunk_size))
        return (0, self.n_tokens)

    def unit_layers(self, unit: int) -> Tuple[int, int]:
        if self.strategy == "token":
            return (self.layer_lo, self.layer_hi)
        return (self.layer_lo + unit, self.layer_lo + unit + 1)

    def io_unit_for_claim(self, unit: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """(token range, layer range) an I/O claim covers. Unit indices map
        directly: token plans claim chunks, layer plans claim layers (the
        I/O pointer simply walks unit indices top-down)."""
        if self.strategy == "token":
            return self.unit_tokens(unit), (self.layer_lo, self.layer_hi)
        return (0, self.n_tokens), self.unit_layers(unit)

    # -- cost hooks (filled by scheduler/simulator via cost model) -------
    def remaining_io_tokens(self) -> int:
        """Tokens' worth of KV still to restore — the paper's priority key
        ("largest remaining length to restore")."""
        if self.strategy == "token":
            return self.plan.remaining_units * self.chunk_size
        frac = self.plan.remaining_units / max(1, self.layer_hi - self.layer_lo)
        return int(self.n_tokens * frac)


def make_request_plans(request_id: str, n_tokens: int, *, chunk_size: int,
                       l_delta: int, num_layers: int,
                       stage_bounds: Optional[List[Tuple[int, int]]] = None,
                       strategy: Optional[str] = None) -> List[RequestPlan]:
    """Algorithm 1 lines 1–4: pick strategy by L_Δ, build per-stage plans.

    stage_bounds: [(layer_lo, layer_hi)] per pipeline stage (3D dimension);
    None => single stage covering all layers.
    """
    if strategy is None:
        strategy = "token" if n_tokens >= l_delta else "layer"
    bounds = stage_bounds or [(0, num_layers)]
    return [RequestPlan(request_id, n_tokens, chunk_size, strategy, lo, hi, stage=s)
            for s, (lo, hi) in enumerate(bounds)]
