"""RWKV-6 "Finch" block: data-dependent-decay time mix + channel mix.

Counterpart of ``repro.models.rwkv6``.  Time mix, per head (head size Dh,
state S in R^{Dh x Dh}):

    y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with data-dependent decay w_t = exp(-exp(w0 + tanh(x_w W1) W2)) in (0, 1)
and data-dependent token-shift mixing (the five-way "ddlerp" LoRA).  The
recurrence runs in the port's ``wkv6`` kernel on a CUDA tensor and in its
plain version on a CPU tensor; both step in time order, so a chunk carried
on from the previous chunk's state gives the same state as one pass over
both (what layer-wise restoration relies on).

Attention-free: no KV cache.  A layer's carried state is the wkv matrix per
head (f32) and the last token of each mix's input (the token shift); its
size does not depend on the prefix length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.rwkv6_scan import wkv6
from repro_torch.models.layers import dense_init

_MIX_NAMES = ("w", "k", "v", "r", "g")


def init_rwkv_block(cfg: ModelConfig, dtype, generator: torch.Generator) -> dict:
    """The reference's distributions; ``decay_base``, ``bonus_u``,
    ``mix_base``, ``cm_mix_k`` and ``cm_mix_r`` stay f32 whatever ``dtype``."""
    r = cfg.rwkv
    d = cfg.d_model
    h = d // r.head_size
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    return {
        # time-mix projections
        "w_r": dense_init((d, d), dtype, generator),
        "w_k": dense_init((d, d), dtype, generator),
        "w_v": dense_init((d, d), dtype, generator),
        "w_g": dense_init((d, d), dtype, generator),
        "w_o": dense_init((d, d), dtype, generator),
        # data-dependent decay LoRA
        "decay_base": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "decay_w1": dense_init((d, r.decay_lora_rank), dtype, generator),
        "decay_w2": dense_init((r.decay_lora_rank, d), dtype, generator),
        "bonus_u": normal((h, r.head_size), 0.1),
        # ddlerp token shift: base mixes + shared LoRA
        "mix_base": normal((len(_MIX_NAMES), d), 0.02),
        "mix_w1": dense_init((d, len(_MIX_NAMES) * r.tokenshift_lora_rank), dtype,
                             generator),
        "mix_w2": dense_init((len(_MIX_NAMES), r.tokenshift_lora_rank, d), dtype,
                             generator, in_axis=1),
        "ln_y_scale": torch.ones(d, dtype=dtype, device=dev),   # per-head groupnorm
        "ln_y_bias": torch.zeros(d, dtype=dtype, device=dev),
        # channel mix
        "cm_mix_k": normal((d,), 0.02),
        "cm_mix_r": normal((d,), 0.02),
        "cm_k": dense_init((d, cfg.d_ff), dtype, generator),
        "cm_v": dense_init((cfg.d_ff, d), dtype, generator),
        "cm_r": dense_init((d, d), dtype, generator),
    }


def _ddlerp(params: dict, x, x_prev, rank: int) -> dict:
    """Data-dependent five-way token-shift mix -> name -> mixed input."""
    xx = x_prev - x
    base = x + xx * params["mix_base"][_MIX_NAMES.index("w")].to(x.dtype)
    lora = torch.tanh(base @ params["mix_w1"].to(x.dtype))
    lora = lora.reshape(*x.shape[:-1], len(_MIX_NAMES), rank)
    deltas = torch.einsum("...nr,nrd->...nd", lora, params["mix_w2"].to(x.dtype))
    out = {}
    for i, name in enumerate(_MIX_NAMES):
        mu = params["mix_base"][i].to(x.dtype) + deltas[..., i, :]
        out[name] = x + xx * mu
    return out


def _shifted(x, shift_state):
    """The previous token of every position: the carried last token of the
    previous chunk, then x[:, :-1]."""
    return torch.cat([shift_state[:, None].to(x.dtype), x[:, :-1]], dim=1)


def time_mix(cfg: ModelConfig, params: dict, x, shift_state, wkv_state):
    """x (B, S, D); shift_state (B, D), the last token of the previous chunk;
    wkv_state (B, H, Dh, Dh) f32.  Returns (out, shift', wkv')."""
    rk = cfg.rwkv
    b, s, d = x.shape
    h, dh = d // rk.head_size, rk.head_size
    mixed = _ddlerp(params, x, _shifted(x, shift_state), rk.tokenshift_lora_rank)
    r = (mixed["r"] @ params["w_r"].to(x.dtype)).reshape(b, s, h, dh)
    k = (mixed["k"] @ params["w_k"].to(x.dtype)).reshape(b, s, h, dh)
    v = (mixed["v"] @ params["w_v"].to(x.dtype)).reshape(b, s, h, dh)
    g = F.silu(mixed["g"] @ params["w_g"].to(x.dtype))
    dec = params["decay_base"].float() + (
        torch.tanh(mixed["w"] @ params["decay_w1"].to(x.dtype)).float()
        @ params["decay_w2"].float())
    w = torch.exp(-torch.exp(dec)).reshape(b, s, h, dh)            # (0, 1)
    y, wkv_state = wkv6(r.float().contiguous(), k.float().contiguous(),
                        v.float().contiguous(), w.contiguous(),
                        params["bonus_u"].float().contiguous(),
                        wkv_state.float().contiguous())
    # per-head groupnorm (population variance, as jnp's var)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = y.reshape(b, s, d).to(x.dtype)
    y = y * params["ln_y_scale"].to(x.dtype) + params["ln_y_bias"].to(x.dtype)
    out = (y * g) @ params["w_o"].to(x.dtype)
    return out, x[:, -1], wkv_state


def channel_mix(cfg: ModelConfig, params: dict, x, shift_state):
    """Finch channel mix: relu(x_k W_k)^2 W_v gated by sigmoid(x_r W_r).
    Returns (out, shift')."""
    xx = _shifted(x, shift_state) - x
    x_k = x + xx * params["cm_mix_k"].to(x.dtype)
    x_r = x + xx * params["cm_mix_r"].to(x.dtype)
    k = torch.square(torch.relu(x_k @ params["cm_k"].to(x.dtype)))
    kv = k @ params["cm_v"].to(x.dtype)
    out = torch.sigmoid(x_r @ params["cm_r"].to(x.dtype)) * kv
    return out, x[:, -1]
