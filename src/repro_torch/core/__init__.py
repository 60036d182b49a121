"""CacheFlow restoration core of the PyTorch port: plans, the batch
scheduler, the engine core, the boundary store, the restoration executor
and the fused datapath (counterparts of ``repro.core``)."""
from repro_torch.core.boundary import BoundaryStore, StoredRequest, stage_bounds  # noqa: F401
from repro_torch.core.engine_core import (EngineBackend, EngineCore,  # noqa: F401
                                          EngineRequest, EngineResult,
                                          RealBackend)
from repro_torch.core.executor import RestorationExecutor  # noqa: F401
from repro_torch.core.plans import RequestPlan, TwoPointerPlan, make_request_plans  # noqa: F401
from repro_torch.core.scheduler import BatchScheduler, ScheduledOp  # noqa: F401
