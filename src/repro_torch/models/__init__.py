from repro_torch.models.kvcache import init_cache, layer_slots  # noqa: F401
from repro_torch.models.model import Model, params_from_jax, resolve_device  # noqa: F401
