"""Per-layer blocks (pre-norm residual) shared by the stack in ``model.py``.

Counterpart of ``repro.models.transformer`` for attention (GQA or MLA),
RG-LRU and RWKV-6 layers, each with a dense or MoE FFN.
``attention_layer_full`` is the whole-sequence attention layer (training,
``Model.forward``, ``prefill``); restoration recompute steps and
single-token decode are the same path with C = chunk or C = 1
(``attention_layer_cached``); ``attention_layer_rows`` decodes one token
of many requests, each over its own cache.  A recurrent layer carries its
state (conv tail, h) from one chunk to the next, an RWKV layer its token
shifts and wkv matrix; their ``*_full`` blocks serve both paths.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
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
        p["attn"] = (mla_mod.init_mla(cfg, dtype, generator) if cfg.mla is not None
                     else attn.init_attention(cfg, dtype, generator))
    elif kind == "recurrent":
        p["rglru"] = rglru_mod.init_rglru_block(cfg, dtype, generator)
    elif kind == "rwkv":
        p["rwkv"] = rwkv_mod.init_rwkv_block(cfg, dtype, generator)
        return p  # rwkv blocks have no separate MLP (channel mix is inside)
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    # FFN: MoE from layer first_k_dense on, dense (dense_d_ff) before it
    if cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense:
        p["moe"] = moe_mod.init_moe(cfg, dtype, generator)
    else:
        d_ff = (cfg.moe.dense_d_ff if (cfg.moe is not None and cfg.moe.dense_d_ff)
                else cfg.d_ff)
        p["mlp"] = init_mlp(cfg.d_model, d_ff, cfg.activation, dtype, generator)
    return p


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor, dropless: bool = True,
         moe_groups: int = 0, want_aux: bool = True):
    """(y, aux): the MoE's load-balancing loss (an f32 tensor; None without
    ``want_aux``), or 0.0 for a dense FFN (no device op for a loss nothing
    reads).  ``moe_groups`` is ``apply_moe``'s ``num_groups``.  A MoE call
    is one ``model.moe`` span, its count the tokens of h (B, S, D)."""
    if "moe" in p:
        with obs.span("model.moe", None, h.shape[0] * h.shape[1]):
            return moe_mod.apply_moe(p["moe"], h, cfg, num_groups=moe_groups,
                                     dropless=dropless, want_aux=want_aux)
    return apply_mlp(p["mlp"], h, cfg.activation), 0.0


def attention_layer_full(cfg: ModelConfig, p: dict, x, positions, *,
                         dropless: bool = True, moe_groups: int = 0, backend: str = "auto"):
    """Whole-sequence attention layer (MHA/GQA or MLA) with its dense or MoE
    FFN; positions (B, S) on x's device.  Returns (x', cache entry for the
    whole sequence — {"k", "v"} or {"ckv"} —, aux)."""
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a, ckv = mla_mod.mla_full(cfg, p["attn"], h, positions, backend)
        entry = {"ckv": ckv}
    else:
        a, (k, v) = attn.attention_full(cfg, p["attn"], h, positions, backend)
        entry = {"k": k, "v": v}
    x = x + a
    h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    f, aux = _ffn(cfg, p, h, dropless, moe_groups)
    return x + f, entry, aux


def attention_layer_cached(cfg: ModelConfig, p: dict, x, positions,
                           layer_cache: dict, *, dropless: bool = True,
                           moe_groups: int = 0):
    """layer_cache: {"k","v","kpos"} or, with MLA, {"ckv","kpos"} views of
    THIS layer's cache slot, updated in place.  Returns (x', layer_cache)."""
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a, ckv, kpos = mla_mod.mla_chunk(cfg, p["attn"], h, positions,
                                         layer_cache["ckv"], layer_cache["kpos"])
        new_cache = {"ckv": ckv, "kpos": kpos}
    else:
        a, k, v, kpos = attn.attention_chunk(cfg, p["attn"], h, positions,
                                             layer_cache["k"], layer_cache["v"],
                                             layer_cache["kpos"])
        new_cache = {"k": k, "v": v, "kpos": kpos}
    x = x + a
    h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    f, _ = _ffn(cfg, p, h, dropless, moe_groups, want_aux=False)
    return x + f, new_cache


def attention_layer_rows(cfg: ModelConfig, p: dict, x, pos_dev, positions, views, *,
                         dropless: bool = True, moe_groups: int = 0):
    """One decode token of each of B requests through an attention layer:
    x (B, 1, D), the rows' positions on x's device (B, 1) and on the host,
    ``views[r]`` row r's views of THIS layer's cache slot, updated in place
    (``attention.attention_rows``, ``mla.mla_rows``).  The norms, the
    projections and the FFN run once for the B rows.  Returns x'."""
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    rows = mla_mod.mla_rows if cfg.mla is not None else attn.attention_rows
    x = x + rows(cfg, p["attn"], h, pos_dev, positions, views)
    h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    return x + _ffn(cfg, p, h, dropless, moe_groups, want_aux=False)[0]


def recurrent_layer_full(cfg: ModelConfig, p: dict, x, conv_tail, h0):
    """RG-LRU layer over a chunk from state (conv_tail, h0).  Returns
    (x', conv_tail', h_last)."""
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    r, conv_tail, h_last = rglru_mod.rglru_full(cfg, p["rglru"], h, conv_tail, h0)
    x = x + r
    h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    return x + _ffn(cfg, p, h)[0], conv_tail, h_last


def rwkv_layer_full(cfg: ModelConfig, p: dict, x, shift_tm, shift_cm, wkv):
    """RWKV-6 layer over a chunk from state (token shifts, wkv).  Returns
    (x', shift_tm', shift_cm', wkv')."""
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    t, shift_tm, wkv = rwkv_mod.time_mix(cfg, p["rwkv"], h, shift_tm, wkv)
    x = x + t
    h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    c, shift_cm = rwkv_mod.channel_mix(cfg, p["rwkv"], h, shift_cm)
    return x + c, shift_tm, shift_cm, wkv
