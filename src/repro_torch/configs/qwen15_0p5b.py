"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (MHA kv=16) head_dim=64 d_ff=2816 vocab=151936, QKV bias.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    activation="swiglu",
    position="rope",
    use_qkv_bias=True,
    tie_embeddings=True,
)
