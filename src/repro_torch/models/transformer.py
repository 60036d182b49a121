"""Per-layer blocks (pre-norm residual) shared by the stack in ``model.py``.

Counterpart of ``repro.models.transformer`` for dense attention, RG-LRU
and RWKV-6 layers.  Restoration recompute steps and single-token decode
are the same path with C = chunk or C = 1; a recurrent layer carries its
state (conv tail, h) from one chunk to the next, an RWKV layer its token
shifts and wkv matrix.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


def init_layer(cfg: ModelConfig, layer_idx: int, dtype,
               generator: torch.Generator) -> dict:
    kind = cfg.layer_kinds()[layer_idx]
    dev = generator.device
    p = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev),
         "norm2": init_norm(cfg.norm, cfg.d_model, dtype, dev)}
    if kind == "attention":
        p["attn"] = attn.init_attention(cfg, dtype, generator)
    elif kind == "recurrent":
        p["rglru"] = rglru_mod.init_rglru_block(cfg, dtype, generator)
    elif kind == "rwkv":
        p["rwkv"] = rwkv_mod.init_rwkv_block(cfg, dtype, generator)
        return p  # rwkv blocks have no separate MLP (channel mix is inside)
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.activation, dtype, generator)
    return p


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    return apply_mlp(p["mlp"], h, cfg.activation)


def attention_layer_cached(cfg: ModelConfig, p: dict, x, positions,
                           layer_cache: dict):
    """layer_cache: {"k","v","kpos"} views of THIS layer's cache slot,
    updated in place.  Returns (x', layer_cache)."""
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    a, k, v, kpos = attn.attention_chunk(cfg, p["attn"], h, positions,
                                         layer_cache["k"], layer_cache["v"],
                                         layer_cache["kpos"])
    x = x + a
    h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    return x + _ffn(cfg, p, h), {"k": k, "v": v, "kpos": kpos}


def recurrent_layer_full(cfg: ModelConfig, p: dict, x, conv_tail, h0):
    """RG-LRU layer over a chunk from state (conv_tail, h0).  Returns
    (x', conv_tail', h_last)."""
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    r, conv_tail, h_last = rglru_mod.rglru_full(cfg, p["rglru"], h, conv_tail, h0)
    x = x + r
    h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    return x + _ffn(cfg, p, h), conv_tail, h_last


def rwkv_layer_full(cfg: ModelConfig, p: dict, x, shift_tm, shift_cm, wkv):
    """RWKV-6 layer over a chunk from state (token shifts, wkv).  Returns
    (x', shift_tm', shift_cm', wkv')."""
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    t, shift_tm, wkv = rwkv_mod.time_mix(cfg, p["rwkv"], h, shift_tm, wkv)
    x = x + t
    h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    c, shift_cm = rwkv_mod.channel_mix(cfg, p["rwkv"], h, shift_cm)
    return x + c, shift_tm, shift_cm, wkv
