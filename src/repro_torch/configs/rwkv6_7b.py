"""RWKV-6 "Finch" 7B [arXiv:2404.05892; hf].

32L d_model=4096 (attention-free, head_size=64 => 64 wkv heads)
d_ff=14336 vocab=65536.  Data-dependent decay via LoRA.
"""
from repro_torch.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,        # wkv heads = d_model / head_size
    num_kv_heads=0,      # attention-free: no KV cache
    head_dim=64,
    d_ff=14_336,
    vocab_size=65_536,
    norm="layernorm",
    activation="gelu",   # channel-mix uses squared-relu-ish; gelu stand-in for the MLP shape
    position="none",
    rwkv=RWKVConfig(head_size=64, decay_lora_rank=64, tokenshift_lora_rank=32),
)
