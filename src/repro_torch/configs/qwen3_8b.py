"""Qwen3-8B — one of the paper's evaluation models [hf:Qwen/Qwen3-8B].

36L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=12288 vocab=151936, QK-norm.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12_288,
    vocab_size=151_936,
    activation="swiglu",
    position="rope",
    rope_theta=1_000_000.0,
    use_qk_norm=True,
)
