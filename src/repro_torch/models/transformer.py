"""Per-layer blocks (pre-norm residual) shared by the stack in ``model.py``.

Counterpart of ``repro.models.transformer``, the cached-chunk entry point
of dense attention layers: restoration recompute steps and single-token
decode are the same path with C = chunk or C = 1.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


def init_layer(cfg: ModelConfig, dtype, generator: torch.Generator) -> dict:
    dev = generator.device
    return {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev),
            "norm2": init_norm(cfg.norm, cfg.d_model, dtype, dev),
            "attn": attn.init_attention(cfg, dtype, generator),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                            generator)}


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
