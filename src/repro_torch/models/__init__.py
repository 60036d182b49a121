from repro_torch.models.kvcache import cache_bytes, init_cache, layer_slots  # noqa: F401
from repro_torch.models.model import (Model, build_model, params_from_jax,  # noqa: F401
                                      resolve_device)
