"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1) head_dim=256 d_ff=7680 vocab=256000.
Block pattern 1 local-attention : 2 RG-LRU  —  (rec, rec, attn) repeating.
Local attention window 2048 => sub-quadratic long-context decode.
"""
from repro_torch.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    norm="rmsnorm",
    activation="geglu",
    position="rope",
    attn_window=2048,
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560, conv1d_width=4,
                      block_pattern=("recurrent", "recurrent", "attention"),
                      num_rglru_heads=2560 // 128),
)
