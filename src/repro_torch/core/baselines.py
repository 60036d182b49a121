"""Baseline restoration strategies the paper compares against (§4.1).

Each baseline is expressed in the same plan/scheduler machinery so the
simulator and executor measure all systems identically:

  * vllm     — recomputation-only standard prefill (compute-bound extreme).
  * lmcache  — pure KV loading, no recomputation (I/O-bound extreme).
  * sglang   — HiCache-style storage-tier loading; modeled as load-only with
               layer-granular pipelining (loads stream top-down by layer).
  * cake     — per-request token-dimension hybrid two-pointer, but
               request-centric: FIFO I/O allocation, no batch awareness, no
               stage-parallel restoration.
  * cacheflow— the full system: adaptive token/layer strategy (L_Δ),
               longest-remaining-first batched I/O, stage-parallel 3D.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.plans import RequestPlan, TwoPointerPlan, make_request_plans

BASELINES = ("vllm", "lmcache", "sglang", "cake", "cacheflow", "cacheflow_2d")


def _mode_plan(plan: TwoPointerPlan, mode: str) -> TwoPointerPlan:
    """Restrict a two-pointer plan to compute-only or io-only."""
    if mode == "compute_only":
        plan.io_enabled = False
    elif mode == "io_only":
        plan.comp_enabled = False
    return plan


def make_baseline_plans(system: str, request_id: str, n_tokens: int, *,
                        chunk_size: int, l_delta: int, num_layers: int,
                        stage_bounds: Optional[List[Tuple[int, int]]] = None
                        ) -> List[RequestPlan]:
    if system in ("cacheflow", "cacheflow_2d"):
        bounds = stage_bounds if system == "cacheflow" else None
        return make_request_plans(request_id, n_tokens, chunk_size=chunk_size,
                                  l_delta=l_delta, num_layers=num_layers,
                                  stage_bounds=bounds)
    if system == "cake":
        # token-dimension hybrid, single-request optimal, no stage parallelism
        return make_request_plans(request_id, n_tokens, chunk_size=chunk_size,
                                  l_delta=0, num_layers=num_layers,
                                  stage_bounds=None, strategy="token")
    if system == "vllm":
        plans = make_request_plans(request_id, n_tokens, chunk_size=chunk_size,
                                   l_delta=0, num_layers=num_layers,
                                   strategy="token")
    elif system in ("lmcache", "sglang"):
        strategy = "token" if system == "lmcache" else "layer"
        plans = make_request_plans(request_id, n_tokens, chunk_size=chunk_size,
                                   l_delta=0, num_layers=num_layers,
                                   strategy=strategy)
    else:
        raise ValueError(system)
    mode = "compute_only" if system == "vllm" else "io_only"
    for p in plans:
        _mode_plan(p.plan, mode)
    return plans


def sim_kwargs(system: str) -> dict:
    """Scheduler/simulator settings per system."""
    if system == "cacheflow":
        return dict(io_policy="longest_remaining", stage_parallel=True)
    if system == "cacheflow_2d":
        return dict(io_policy="longest_remaining", stage_parallel=False)
    if system == "cake":
        return dict(io_policy="fifo", stage_parallel=False)
    return dict(io_policy="fifo", stage_parallel=False)


def plans_and_kwargs(system: str, request_id: str, n_tokens: int, *, chunk_size: int,
                     l_delta: int, num_layers: int,
                     stage_bounds: Optional[List[Tuple[int, int]]] = None):
    return (make_baseline_plans(system, request_id, n_tokens, chunk_size=chunk_size,
                                l_delta=l_delta, num_layers=num_layers,
                                stage_bounds=stage_bounds),
            sim_kwargs(system))
