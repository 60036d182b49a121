"""Shared by the benchmark's CPU tests (imported before ``bench``): the
repository root and ``src`` on the path, and tiny configurations in the
format of ``bench/configs``."""
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def tiny(name: str = "qwen3-8b") -> dict:
    """The ``qwen3-8b`` configuration file (with ``name="qwen3-30b-a3b"``
    the MoE keys of that model added) cut to a CPU-sized model: float32,
    2 layers of width 64, 4 query heads over 2 KV heads of 16, vocabulary
    256 (MoE: 8 experts, top 2, width 32); chunks of 32 tokens; an
    unquantized store, so that a sound run reads the reference's logits to
    float32 rounding (``test_reference.py`` holds the int8 tier apart)."""
    cfg = copy.deepcopy(json.loads((ROOT / "bench" / "configs" / "qwen3-8b.json").read_text()))
    hf = cfg["hf"]
    if name == "qwen3-30b-a3b":
        # the published MoE keys of Qwen/Qwen3-30B-A3B's config.json
        cfg.update(name=name, port_arch=name)
        hf.update(model_type="qwen3_moe", num_experts=128, num_experts_per_tok=8,
                  moe_intermediate_size=768, norm_topk_prob=True, decoder_sparse_step=1)
        cfg["port_fields"].update(num_experts="moe.num_experts",
                                  num_experts_per_tok="moe.top_k",
                                  moe_intermediate_size="moe.expert_d_ff")
    hf.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, intermediate_size=96,
              vocab_size=256, torch_dtype="float32")
    if "num_experts" in hf:
        hf.update(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32)
    cfg["engine"].update(chunk_size=32, l_delta=64, host_tier_bytes=1 << 30, quant="none")
    cfg["serve"].update(prefix_cap=200, warmup={"prefix_len": 70, "turns": [[20, 3], [5, 2]]})
    cfg["check"] = {"min_tokens": 16, "limits": {"logit_gap": 1e-3, "logit_rms": 1e-3}}
    return cfg


def mix(**kw) -> dict:
    """The ``chat_cold`` mix cut to the tiny model: 2 clients over 3
    sessions, short turns."""
    m = json.loads((ROOT / "bench" / "traffic" / "chat_cold.json").read_text())
    m.update(clients=2, sessions=3, turns=6, ramp=2, queue=6, new_len=[4, 24],
             decode_len=[2, 6])
    m.update(kw)
    return m
