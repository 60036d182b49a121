"""Plain PyTorch forward of Qwen3 (dense, ``Qwen/Qwen3-8B``) and Qwen3-MoE
(``Qwen/Qwen3-30B-A3B``), in float32 with TF32 off.

It follows the published architecture: RMSNorm before attention and FFN,
q/k/v projections without bias, a per-head RMSNorm of q and k (eps 1e-6),
rotary positions on split halves (``rope_theta``), grouped-query causal
attention, a SwiGLU FFN, or in the MoE model a softmax router whose top-k
probabilities are renormalised (``norm_topk_prob``), ties broken towards
the lower expert index, and the routed experts' SwiGLU outputs summed by
those weights.  No kernel, cache or batching: the whole sequence goes
through one layer at a time (each layer's weights cast to float32 there and
dropped after), the attention in blocks of query rows and the FFN in blocks
of tokens, so that it fits beside the served model's weights.

It reads the weights in the layout the benchmark made them in (a dict per
layer, products as ``x @ w``) and token ids; it imports nothing of the
program and takes nothing the program made.

``precision="fp8"`` is the control: every product that the configuration
states in bfloat16 takes its operands through float8 (e4m3) first, the
weight scaled per output column and the activation per row, the product
then in float32 — the step below bfloat16 that would tempt a later change.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def strict_f32():
    """Float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x through float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Products:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """(in, out) or (E, in, out) weight in float32 (per output column
        through fp8 in the control)."""
        w = w.float()
        return _fp8(w, dim=-2) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (rows, in) @ w (in, out) with w already from ``weight``."""
        return (_fp8(x, dim=-1) if self.fp8 else x) @ w


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, Dh), rotated halves."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float32) / dh)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int):
    """Causal GQA: q (S, Hq, Dh), k/v (S, Hkv, Dh) -> (S, Hq·Dh)."""
    s, hq, dh = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)       # (Hq, S, Dh)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1)
    out = torch.empty((s, hq, dh), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(dh)
    for a in range(0, s, block):
        b = min(s, a + block)
        sc = torch.matmul(qt[:, a:b], k[:, :b].transpose(1, 2)) * scale
        mask = torch.arange(b, device=q.device)[None, :] > \
            torch.arange(a, b, device=q.device)[:, None]
        sc.masked_fill_(mask, float("-inf"))
        out[a:b] = torch.matmul(torch.softmax(sc, dim=-1), v[:, :b]).transpose(0, 1)
    return out.reshape(s, hq * dh)


def swiglu(pr: Products, x, wg, wu, wd):
    return pr.mm(torch.nn.functional.silu(pr.mm(x, wg)) * pr.mm(x, wu), wd)


def dense_ffn(pr: Products, p: dict, h, block: int):
    wg, wu, wd = (pr.weight(p[n]) for n in ("w_gate", "w_up", "w_down"))
    return torch.cat([swiglu(pr, h[a:a + block], wg, wu, wd)
                      for a in range(0, h.shape[0], block)])


def moe_ffn(pr: Products, p: dict, h, top_k: int):
    """Softmax router (float32 as published), top-k renormalised, every
    token through its k experts."""
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e_of = vals[:, :top_k], idx[:, :top_k]
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in torch.unique(e_of).tolist():
        rows, slot = (e_of == e).nonzero(as_tuple=True)
        wg, wu, wd = (pr.weight(p[n][e]) for n in ("w_gate", "w_up", "w_down"))
        y = swiglu(pr, h[rows], wg, wu, wd)
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def logits(hf: dict, weights: dict, ids: torch.Tensor, first_row: int, *,
           precision: str = "f32", block: int = 512, keys=None) -> torch.Tensor:
    """Float32 logits (len(ids) - first_row, vocab) of rows ``first_row``
    onwards, for token ids ``ids`` (S,) on the weights' device.  A list
    ``keys`` receives each layer's (k, v), (S, Hkv, Dh) after rotation."""
    strict_f32()
    pr = Products(precision)
    eps, theta = hf["rms_norm_eps"], hf["rope_theta"]
    hq, hkv, dh = hf["num_attention_heads"], hf["num_key_value_heads"], hf["head_dim"]
    s = ids.shape[0]
    pos = torch.arange(s, device=ids.device)
    x = weights["embed"][ids.long()].float()
    for p in weights["layers"]:
        a = p["attn"]
        h = rms(x, p["norm1"]["scale"], eps)
        q = pr.mm(h, pr.weight(a["wq"])).reshape(s, hq, dh)
        k = pr.mm(h, pr.weight(a["wk"])).reshape(s, hkv, dh)
        v = pr.mm(h, pr.weight(a["wv"])).reshape(s, hkv, dh)
        q = rope(rms(q, a["q_norm"], 1e-6), pos, theta)
        k = rope(rms(k, a["k_norm"], 1e-6), pos, theta)
        if keys is not None:
            keys.append((k, v))
        x = x + pr.mm(attention(q, k, v, block), pr.weight(a["wo"]))
        del q, k, v
        h = rms(x, p["norm2"]["scale"], eps)
        if "moe" in p:
            x = x + moe_ffn(pr, p["moe"], h, hf["num_experts_per_tok"])
        else:
            x = x + dense_ffn(pr, p["mlp"], h, 8 * block)
        del h
    x = rms(x[first_row:], weights["final_norm"]["scale"], eps)
    return pr.mm(x, pr.weight(weights["unembed"]))
