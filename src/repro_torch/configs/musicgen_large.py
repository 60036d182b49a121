"""MusicGen-large [arXiv:2306.05284; hf].

Decoder-only transformer over EnCodec tokens:
48L d_model=2048 32H (MHA kv=32) head_dim=64 d_ff=8192 vocab=2048.
LayerNorm + GELU + sinusoidal positions.  EnCodec frontend is a STUB —
``input_specs`` feeds precomputed frame embeddings (B, S, d_model).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    norm="layernorm",
    activation="gelu",
    position="sinusoidal",
    input_mode="embeddings",
)
