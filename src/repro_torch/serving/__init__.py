from repro_torch.serving.engine import RealServingEngine, ServingReport, SimServingEngine  # noqa: F401
from repro_torch.serving.kvstore import TieredKVStore  # noqa: F401
from repro_torch.serving.request import Phase, Request  # noqa: F401
from repro_torch.serving.workloads import (WORKLOADS, agentic_tree,  # noqa: F401
                                           bursty_priority, fixed_length, generate,
                                           multi_tenant)
from repro_torch.storage import ChunkStore  # noqa: F401
