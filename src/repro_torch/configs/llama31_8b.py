"""Llama-3.1-8B — one of the paper's evaluation models [hf:meta-llama/Llama-3.1-8B].

32L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=128256.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    activation="swiglu",
    position="rope",
    rope_theta=500_000.0,
)
