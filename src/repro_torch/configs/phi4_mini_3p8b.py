"""Phi-4-mini 3.8B [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) head_dim=128 d_ff=8192 vocab=200064.
RoPE + SwiGLU + GQA, no biases.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    activation="swiglu",
    position="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
