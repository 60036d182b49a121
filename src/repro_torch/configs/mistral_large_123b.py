"""Mistral-Large-Instruct-2407 123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L d_model=12288 96H (GQA kv=8) head_dim=128 d_ff=28672 vocab=32768.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    activation="swiglu",
    position="rope",
    rope_theta=1_000_000.0,
)
