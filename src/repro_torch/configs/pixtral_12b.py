"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified].

Backbone only (mistral-nemo 12B): 40L d_model=5120 32H (GQA kv=8)
head_dim=128 d_ff=14336 vocab=131072.  The pixtral-ViT frontend is a STUB —
``input_specs`` feeds precomputed patch embeddings (B, S, d_model).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    activation="swiglu",
    position="rope",
    rope_theta=1_000_000.0,
    input_mode="embeddings",
)
