"""Discrete-event simulator for batched, multi-stage KV restoration.

A copy of ``repro.core.simulator``: a thin facade over the shared
:mod:`repro_torch.core.engine_core` event loop with a
``SimBackend``: the *same* admission/dispatch logic that drives real
execution is driven here against the analytic cost model, so per-request
restore-finish times and resource busy fractions (the paper's Fig. 5
utilization numbers) are measured for exactly the schedule the real backend
proves correct.

Straggler/failure studies plug in via ``channel_slowdown`` /
``channel_fail_at``; tier-aware bandwidth via ``bw_override`` (static) or a
``kvstore`` (dispatch-time lookup + LRU touch/promote).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.cost_model import CostModel
from repro_torch.core.engine_core import (EngineCore, EngineRequest, EngineResult,
                                    SimBackend)

# Historical names: simulation call sites construct SimRequest/SimResult,
# which are literally the engine core's request/result types.
SimRequest = EngineRequest
SimResult = EngineResult


class RestorationSimulator:
    def __init__(self, cost: CostModel, *, stages: int = 1, io_channels: int = 1,
                 io_policy: str = "longest_remaining",
                 channel_slowdown: Optional[Dict[int, float]] = None,
                 channel_fail_at: Optional[Dict[int, float]] = None,
                 stage_parallel: bool = True,
                 bw_override: Optional[Dict[str, float]] = None,
                 max_active: int = 0, kvstore=None):
        """stage_parallel=False models the paper's Fig. 7 ablation: stages
        restore sequentially (stage s waits for s-1) instead of concurrently
        via boundary activations.

        bw_override: per-request I/O bandwidth (bytes/s) — the KV-store tier
        the payload lives in.  max_active: continuous-batching admission cap
        (0 = unlimited)."""
        self.cost = cost
        self.backend = SimBackend(cost, bw_override=bw_override)
        self.core = EngineCore(
            self.backend, stages=stages, io_channels=io_channels,
            io_policy=io_policy, channel_slowdown=channel_slowdown,
            channel_fail_at=channel_fail_at, stage_parallel=stage_parallel,
            max_active=max_active, kvstore=kvstore)

    def run(self, requests: List[SimRequest], trace=None) -> SimResult:
        """``trace``: optional ``TraceRecorder`` capturing the schedule for
        deterministic replay (see :mod:`repro_torch.core.trace`)."""
        return self.core.run(requests, trace=trace)
