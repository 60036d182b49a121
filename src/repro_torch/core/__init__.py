"""CacheFlow restoration core of the PyTorch port: plans, the batch
scheduler, the engine core, the boundary store, the discrete-event
simulator, the restoration executor, the fused datapath, schedule capture
and replay, and the crossover profiler (counterparts of ``repro.core``)."""
from repro_torch.core.cost_model import CostModel  # noqa: F401
from repro_torch.core.boundary import BoundaryStore, StoredRequest, stage_bounds  # noqa: F401
from repro_torch.core.engine_core import (EngineBackend, EngineCore,  # noqa: F401
                                          EngineRequest, EngineResult,
                                          RealBackend, SimBackend,
                                          interleaving_dur_fn)
from repro_torch.core.executor import RestorationExecutor  # noqa: F401
from repro_torch.core.plans import RequestPlan, TwoPointerPlan, make_request_plans  # noqa: F401
from repro_torch.core.scheduler import BatchScheduler, ScheduledOp  # noqa: F401
from repro_torch.core.simulator import RestorationSimulator, SimRequest, SimResult  # noqa: F401
from repro_torch.core.trace import (ReplayBackend, ReplayDivergence,  # noqa: F401
                                    ScheduleTrace, TraceEvent, TraceRecorder,
                                    TraceVersionError, capture, replay_trace)
