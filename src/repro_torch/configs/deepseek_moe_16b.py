"""DeepSeekMoE 16B [arXiv:2401.06066; hf].

28L d_model=2048 16H (MHA kv=16) head_dim=128 vocab=102400.
Fine-grained MoE: 2 shared + 64 routed, top-6, expert_d_ff=1408;
first layer dense d_ff=10944.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10_944,        # dense first layer
    vocab_size=102_400,
    activation="swiglu",
    position="rope",
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared_experts=2, shared_d_ff=2 * 1408,
                  first_k_dense=1, dense_d_ff=10_944),
)
