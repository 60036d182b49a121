"""Plain PyTorch forward of one chip's share of Qwen3-MoE
(``Qwen/Qwen3-30B-A3B``) under expert parallelism, in float32 with TF32
off.

It is the published model in every part but one, its one departure: each
MoE layer holds a contiguous share of the routed experts, ``[first, first
+ held)``, ``held`` the length of the layer's expert stacks and ``first``
the configuration's ``experts_first`` (0 when absent: chip 0).  The router
keeps its published width: a softmax over all ``num_experts``, the top-k
probabilities (ties towards the lower expert index) renormalised over the
k (``norm_topk_prob``).  Of a token's k experts only the held ones run,
and their SwiGLU outputs, summed by those weights, are the layer's FFN
output; the experts held on other chips add nothing here, as on a chip
whose exchange with the others is left out.  With every expert held it is
the whole published model.

Attention, norms, rotary positions and the unembedding are those of the
uncut reference beside this file (``qwen3.py``), loaded from its path; so
are the layout of the weights it reads and the control: ``precision="fp8"``
takes every product that the configuration states in bfloat16 through
float8 (e4m3) operands.  It imports nothing of the program.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch


def _uncut():
    path = Path(__file__).with_name("qwen3.py")
    spec = importlib.util.spec_from_file_location("qwen3_reference_uncut", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


base = _uncut()


def moe_share_ffn(pr, p: dict, h, top_k: int, first: int):
    """The held experts' part of a MoE layer: the router over all experts,
    every token's top k renormalised, the held experts of them run."""
    held = p["w_up"].shape[0]
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e_of = vals[:, :top_k], idx[:, :top_k]
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in torch.unique(e_of).tolist():
        if not first <= e < first + held:
            continue
        rows, slot = (e_of == e).nonzero(as_tuple=True)
        wg, wu, wd = (pr.weight(p[n][e - first]) for n in ("w_gate", "w_up", "w_down"))
        y = base.swiglu(pr, h[rows], wg, wu, wd)
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def logits(hf: dict, weights: dict, ids: torch.Tensor, first_row: int, *,
           precision: str = "f32", block: int = 512, keys=None) -> torch.Tensor:
    """Float32 logits (len(ids) - first_row, vocab) of rows ``first_row``
    onwards, for token ids ``ids`` (S,) on the weights' device (the
    interface of ``qwen3.logits``).  A list ``keys`` receives each layer's
    (k, v), (S, Hkv, Dh) after rotation."""
    base.strict_f32()
    pr = base.Products(precision)
    eps, theta = hf["rms_norm_eps"], hf["rope_theta"]
    hq, hkv, dh = hf["num_attention_heads"], hf["num_key_value_heads"], hf["head_dim"]
    first = hf.get("experts_first", 0)
    s = ids.shape[0]
    pos = torch.arange(s, device=ids.device)
    x = weights["embed"][ids.long()].float()
    for p in weights["layers"]:
        a = p["attn"]
        h = base.rms(x, p["norm1"]["scale"], eps)
        q = pr.mm(h, pr.weight(a["wq"])).reshape(s, hq, dh)
        k = pr.mm(h, pr.weight(a["wk"])).reshape(s, hkv, dh)
        v = pr.mm(h, pr.weight(a["wv"])).reshape(s, hkv, dh)
        q = base.rope(base.rms(q, a["q_norm"], 1e-6), pos, theta)
        k = base.rope(base.rms(k, a["k_norm"], 1e-6), pos, theta)
        if keys is not None:
            keys.append((k, v))
        x = x + pr.mm(base.attention(q, k, v, block), pr.weight(a["wo"]))
        del q, k, v
        h = base.rms(x, p["norm2"]["scale"], eps)
        if "moe" in p:
            x = x + moe_share_ffn(pr, p["moe"], h, hf["num_experts_per_tok"], first)
        else:
            x = x + base.dense_ffn(pr, p["mlp"], h, 8 * block)
        del h
    x = base.rms(x[first_row:], weights["final_norm"]["scale"], eps)
    return pr.mm(x, pr.weight(weights["unembed"]))
