from repro_torch.serving.engine import RealServingEngine, ServingReport  # noqa: F401
from repro_torch.serving.request import Phase, Request  # noqa: F401
from repro_torch.storage import ChunkStore  # noqa: F401
