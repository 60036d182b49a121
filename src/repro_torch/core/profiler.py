"""Offline profiling for the adaptive strategy crossover L_Δ (paper Fig. 3)
plus the sanitizer's observable counters.

A copy of ``repro.core.profiler``.  Two profiling modes:
  * analytic — sweep the cost model's T_token(N) / T_layer(N) curves
    (what production deployments would tabulate per hardware SKU);
  * measured — time the executor's token-wise vs layer-wise restoration on
    its device (on a card, the crossover of the model as served; on the
    CPU, that the crossover exists and is content-agnostic).

:class:`SanitizerCounters` is the runtime sanitizer's
(``repro_torch.analysis.sanitizer``) running tally —
dispatch/claim/abort/preemption totals and high-water marks — surfaced by
``launch/serve.py --sanitize`` in the report.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from repro_torch.core.cost_model import CostModel
from repro_torch.core.executor import RestorationExecutor


@dataclass
class CrossoverProfile:
    lengths: List[int]
    t_token: List[float]
    t_layer: List[float]
    l_delta: int


def profile_analytic(cost: CostModel, lengths: Optional[List[int]] = None
                     ) -> CrossoverProfile:
    lengths = lengths or [2 ** i for i in range(7, 16)]
    t_tok = [cost.t_token_wise(n) for n in lengths]
    t_lay = [cost.t_layer_wise(n) for n in lengths]
    l_delta = next((n for n, tt, tl in zip(lengths, t_tok, t_lay) if tt <= tl),
                   lengths[-1])
    return CrossoverProfile(lengths, t_tok, t_lay, l_delta)


def profile_measured(executor: RestorationExecutor, make_inputs,
                     lengths: Optional[List[int]] = None, repeats: int = 2
                     ) -> CrossoverProfile:
    """Times real restoration, wall clock between two of the executor's
    ``sync()`` calls (which wait for the device).  ``compute_first`` lets
    the compute pointer race ahead, and with no chunk store in the executor
    a load copies ground truth, so this measures the compute-path shapes
    the paper's Fig. 3 is about."""
    lengths = lengths or [32, 64, 128, 256]
    t_tok, t_lay = [], []
    for n in lengths:
        inputs = make_inputs(n)
        rid = f"prof-{n}"
        executor.remember(rid, inputs)
        for strategy, acc in (("token", t_tok), ("layer", t_lay)):
            best = float("inf")
            for _ in range(repeats):
                executor.sync()
                t0 = time.perf_counter()
                executor.restore(rid, strategy=strategy,
                                 op_order="compute_first")
                executor.sync()
                best = min(best, time.perf_counter() - t0)
            acc.append(best)
    l_delta = next((n for n, tt, tl in zip(lengths, t_tok, t_lay) if tt <= tl),
                   lengths[-1])
    return CrossoverProfile(lengths, t_tok, t_lay, l_delta)


def utilization_report(sim_result) -> Dict[str, float]:
    return {"compute_busy": sim_result.compute_busy, "io_busy": sim_result.io_busy}


@dataclass
class SanitizerCounters:
    """What the runtime sanitizer saw during one ``EngineCore.run``.

    Pure observability (violations RAISE — a nonzero run of these counters
    is a healthy run, not a buggy one): totals per event class plus the
    high-water marks that size capacity — peak admitted batch and peak
    ``BlockPool`` block refcount (how hot the hottest shared prefix ran)."""
    events: int = 0            # engine events observed
    dispatches: int = 0        # ops placed on a resource (incl. decode steps)
    claims: int = 0            # restoration-unit claims (compute + I/O)
    completions: int = 0       # non-aborted op completions
    aborts: int = 0            # aborted transfers/ops (preempt, fail, race)
    preemptions: int = 0       # restorations suspended under pressure
    admits: int = 0            # admissions (incl. resumes)
    finishes: int = 0          # lifecycle completions
    max_active: int = 0        # admitted-batch high water
    pool_refcount_hw: int = 0  # BlockPool block refcount high water
    cow_checks: int = 0        # CoW copies verified parent-bits-unchanged
    audits: int = 0            # store/pool/placement audits executed

    def as_dict(self) -> Dict[str, int]:
        return asdict(self)
