"""Qwen3-30B-A3B (MoE, 3B active) — one of the paper's evaluation models.

48L d_model=2048 32H (GQA kv=4) head_dim=128 vocab=151936.
MoE: 128 routed experts, top-8, expert_d_ff=768, no shared experts.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    activation="swiglu",
    position="rope",
    rope_theta=1_000_000.0,
    use_qk_norm=True,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768),
)
