from repro_torch.storage.chunkstore import (CHUNK_TIERS, ChunkStore,  # noqa: F401
                                            chunk_hash_chain)
from repro_torch.storage.placement import PlacementCore, Tier  # noqa: F401
