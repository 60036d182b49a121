"""GQA attention over a chunk of tokens against a kpos-addressed cache.

Counterpart of ``repro.models.attention`` (the chunked path only: the
restoration recompute step, suffix prefill and decode).  Queries of a chunk
attend to [cache || chunk] and the chunk's KV is written into the cache.
On a CUDA tensor the attention runs in the port's hand-written kernels —
``flash_prefill`` for a chunk of C > 1 tokens, ``flash_decode`` for C = 1;
on a CPU tensor their plain versions run.

Positions live on the host: they are known there, the kernels take the
query offset as a launch argument, and the cache slots they address are
plain slices — so nothing here waits on the device for an index.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models.layers import apply_rope, dense_init, rms_head_norm


def init_attention(cfg: ModelConfig, dtype, generator: torch.Generator) -> dict:
    d, hq, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device
    p = {"wq": dense_init((d, hq * dh), dtype, generator),
         "wk": dense_init((d, hk * dh), dtype, generator),
         "wv": dense_init((d, hk * dh), dtype, generator),
         "wo": dense_init((hq * dh, d), dtype, generator)}
    if cfg.use_qkv_bias:
        p["bq"] = torch.zeros(hq * dh, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(hk * dh, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(hk * dh, dtype=dtype, device=dev)
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(dh, dtype=dtype, device=dev)
    return p


def project_qkv(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor):
    """x: (B, S, D); positions (B, S) on x's device -> q (B,S,Hq,Dh),
    k/v (B,S,Hk,Dh), RoPE applied."""
    b, s, _ = x.shape
    hq, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.use_qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, s, hk, dh)
    v = v.reshape(b, s, hk, dh)
    if cfg.use_qk_norm:
        q = rms_head_norm(q, params["q_norm"])
        k = rms_head_norm(k, params["k_norm"])
    if cfg.position == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_chunk(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kpos: torch.Tensor):
    """Chunk queries attend to [cache || chunk]; chunk KV is written back.

    x: (B, C, D) chunk activations; positions: (B, C) int host tensor of
    consecutive absolute positions shared by the batch rows.
    k_cache/v_cache: (B, S_cache, Hk, Dh) views of the layer's cache slot;
    kpos: (S_cache,) slot positions.  The three are updated IN PLACE (the
    reference returns updated copies) and returned with the output.
    """
    b, c, _ = x.shape
    s_cache = k_cache.shape[1]
    if positions.device.type != "cpu":
        raise ValueError("attention_chunk: positions live on the host")
    p0 = int(positions[0, 0])
    want = torch.arange(p0, p0 + c, dtype=positions.dtype).expand(b, c)
    if not torch.equal(positions, want):
        raise ValueError("attention_chunk: positions must be consecutive and "
                         "shared by the batch rows")
    dev = x.device
    pos_dev = torch.arange(p0, p0 + c, dtype=torch.int32, device=dev).expand(b, c)
    q, k, v = project_qkv(cfg, params, x, pos_dev)
    # --- write chunk KV into the cache (ring buffer if windowed) ---
    if cfg.attn_window:
        slot = pos_dev[0] % s_cache
        k_cache[:, slot] = k.to(k_cache.dtype)
        v_cache[:, slot] = v.to(v_cache.dtype)
        kpos[slot] = pos_dev[0]
    else:
        k_cache[:, p0:p0 + c] = k.to(k_cache.dtype)
        v_cache[:, p0:p0 + c] = v.to(v_cache.dtype)
        kpos[p0:p0 + c] = pos_dev[0]
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    kc, vc = k_cache.to(q.dtype), v_cache.to(q.dtype)
    if c == 1:
        out = flash_decode(q[:, 0].contiguous(), kc, vc, kpos, p0, scale=scale,
                           window=cfg.attn_window)[:, None]
    else:
        out = flash_prefill(q.contiguous(), kc, vc, kpos, p0, scale=scale,
                            window=cfg.attn_window)
    out = out.reshape(b, c, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), k_cache, v_cache, kpos
