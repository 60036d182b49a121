"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

60L d_model=5120 128H MLA(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64,
v=128) vocab=102400.  MoE: 2 shared + 160 routed experts, top-6,
expert_d_ff=1536; first layer dense d_ff=12288.
"""
from repro_torch.config import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: all heads share the compressed kv cache
    head_dim=128,
    d_ff=12_288,        # dense layers
    vocab_size=102_400,
    activation="swiglu",
    position="rope",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, expert_d_ff=1536,
                  num_shared_experts=2, shared_d_ff=2 * 1536,
                  first_k_dense=1, dense_d_ff=12_288),
)
