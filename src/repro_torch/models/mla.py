"""DeepSeek-V2 Multi-head Latent Attention (MLA).

Counterpart of ``repro.models.mla``.  ``mla_full`` is the whole-sequence
path (training, ``Model.forward`` and ``prefill``): it decompresses
per-head K/V and runs the masked softmax, or the blocked online softmax of
``attention.gqa_flash`` for long sequences, in plain products.
``mla_chunk`` serves restoration recompute steps, suffix prefill and
decode, ``mla_rows`` one decode token of many requests at once, each over
its own cache.  The cache stores one row per token
and layer: the compressed latent ``c_kv`` (kv_lora_rank) and the shared
rotary key (qk_rope_head_dim), ``[c_kv || k_rope]`` — the row the I/O
pointer moves.  Attention is **absorbed**: W_uk folds into the query and
W_uv into the output, so scores and values are taken against the latents
and no per-head K/V of the cache is ever built.  As in the reference these
are plain products (einsums), not a hand-written kernel.

The chunk's latents are written into the cache at their absolute
positions (no ring) and in place; positions live on the host, as in
``attention.py``.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.constraints import write_slots
from repro_torch.models.attention import _is_dtensor, gqa_flash, use_flash
from repro_torch.models.layers import apply_norm, apply_rope, dense_init, init_norm

NEG_INF = -1e30


def init_mla(cfg: ModelConfig, dtype, generator: torch.Generator) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = generator.device
    p = {}
    if m.q_lora_rank > 0:
        p["wq_a"] = dense_init((d, m.q_lora_rank), dtype, generator)
        p["q_norm"] = init_norm("rmsnorm", m.q_lora_rank, dtype, dev)
        p["wq_b"] = dense_init((m.q_lora_rank, h * qk_dim), dtype, generator)
    else:
        p["wq"] = dense_init((d, h * qk_dim), dtype, generator)
    p["wkv_a"] = dense_init((d, m.kv_lora_rank + m.qk_rope_head_dim), dtype, generator)
    p["kv_norm"] = init_norm("rmsnorm", m.kv_lora_rank, dtype, dev)
    p["wkv_b"] = dense_init((m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
                            dtype, generator)
    p["wo"] = dense_init((h * m.v_head_dim, d), dtype, generator)
    return p


def _project_q(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, D), positions (B, S) on x's device -> q_nope (B,S,H,nope),
    q_rope (B,S,H,rope) rotated."""
    m = cfg.mla
    b, s, _ = x.shape
    if m.q_lora_rank > 0:
        ql = x @ params["wq_a"].to(x.dtype)
        ql = apply_norm("rmsnorm", params["q_norm"], ql, cfg.norm_eps)
        q = ql @ params["wq_b"].to(x.dtype)
    else:
        q = x @ params["wq"].to(x.dtype)
    q = q.reshape(b, s, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def compress_kv(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """x -> [c_kv (normalised) || k_rope (rotated)]: (B, S, lora + rope),
    what the cache stores and restoration I/O moves."""
    m = cfg.mla
    kv = x @ params["wkv_a"].to(x.dtype)
    c_kv, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = apply_norm("rmsnorm", params["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return torch.cat([c_kv, k_rope], dim=-1)


def _uk_uv(cfg: ModelConfig, params: dict, dtype):
    """W_uk (lora, H, nope) and W_uv (lora, H, v) out of wkv_b."""
    m = cfg.mla
    wkv_b = params["wkv_b"].to(dtype).reshape(m.kv_lora_rank, cfg.num_heads,
                                              m.qk_nope_head_dim + m.v_head_dim)
    return wkv_b[..., :m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim:]


def mla_full(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
             backend: str = "auto"):
    """Full causal MLA: x (B,S,D), positions (B,S) int on x's device.
    Returns (out (B,S,D), the latent row [c_kv || k_rope] (B,S,lora+rope)
    for caching)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _project_q(cfg, params, x, positions)
    ckv = compress_kv(cfg, params, x, positions)
    c_kv, k_rope = ckv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    kv = (c_kv @ params["wkv_b"].to(x.dtype)).reshape(
        b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, m.qk_rope_head_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    if use_flash(backend, s):
        out = gqa_flash(q, k, v, positions, positions, scale, 0)
    else:
        sc = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
        mask = positions[:, :, None] >= positions[:, None, :]
        sc = torch.where(mask[:, None], sc, NEG_INF)
        p = torch.softmax(sc, dim=-1).to(x.dtype)
        out = torch.einsum("bhst,bthd->bshd", p, v)
    out = out.reshape(b, s, h * m.v_head_dim)
    return out @ params["wo"].to(x.dtype), ckv


def mla_chunk(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
              ckv_cache: torch.Tensor, kpos: torch.Tensor):
    """Absorbed chunk / decode attention over the latent cache.

    x: (B, C, D); positions: (B, C) int host tensor of consecutive absolute
    positions shared by the batch rows; ckv_cache: (B, S_cache, lora + rope)
    view of the layer's cache slot; kpos: (S_cache,).  The chunk's latents
    and positions are written IN PLACE at slots positions[0] (the reference
    returns updated copies).  Returns (out, ckv_cache, kpos)."""
    b, c, _ = x.shape
    if positions.device.type != "cpu":
        raise ValueError("mla_chunk: positions live on the host")
    p0 = int(positions[0, 0])
    if not torch.equal(positions, torch.arange(p0, p0 + c, dtype=positions.dtype).expand(b, c)):
        raise ValueError("mla_chunk: positions must be consecutive and shared by "
                         "the batch rows")
    pos_dev = torch.arange(p0, p0 + c, dtype=torch.int32, device=x.device).expand(b, c)
    q_nope, q_rope = _project_q(cfg, params, x, pos_dev)
    ckv = compress_kv(cfg, params, x, pos_dev).to(ckv_cache.dtype)
    if _is_dtensor(ckv_cache):          # on a mesh: through the shards holding the slots
        write_slots(ckv_cache, 1, range(p0, p0 + c), ckv)
        write_slots(kpos, 0, range(p0, p0 + c), pos_dev[0])
        out = _attend_latent(cfg, params, q_nope, q_rope, pos_dev, ckv_cache.to(x.dtype),
                             kpos)
    else:
        out = _write_and_attend(cfg, params, q_nope, q_rope, pos_dev, ckv, ckv_cache, kpos,
                               p0)
    return out @ params["wo"].to(x.dtype), ckv_cache, kpos


def _write_and_attend(cfg: ModelConfig, params: dict, q_nope, q_rope, pos_dev, ckv,
                     ckv_cache, kpos, p0: int):
    """One request's chunk of C latents ``ckv`` (B, C, lora + rope) written
    at slots p0.. of its cache (B, S, lora + rope) and kpos (S,), IN PLACE,
    then the absorbed attention over the cache (:func:`_attend_latent`,
    before ``wo``): (B, C, H · v_head_dim)."""
    c = ckv.shape[1]
    ckv_cache[:, p0:p0 + c] = ckv.to(ckv_cache.dtype)
    kpos[p0:p0 + c] = pos_dev[0]
    return _attend_latent(cfg, params, q_nope, q_rope, pos_dev,
                          ckv_cache.to(q_nope.dtype), kpos)


def mla_attend_absorbed(cfg: ModelConfig, params: dict, q_nope, q_rope, positions,
                        lat, kpos):
    """Absorbed attention over a (read-only) latent cache view ``lat``
    (B, T, lora + rope) with slot positions ``kpos`` (T,), -1 empty.
    Scores sum in the compute dtype, scale and softmax in f32, and the
    probabilities are cast back before P·c_kv, as the reference."""
    out = _attend_latent(cfg, params, q_nope, q_rope, positions, lat, kpos)
    return out @ params["wo"].to(q_nope.dtype)


def _attend_latent(cfg: ModelConfig, params: dict, q_nope, q_rope, positions, lat,
                   kpos):
    """:func:`mla_attend_absorbed` up to ``wo``: (B, C, H · v_head_dim)."""
    m = cfg.mla
    b, c = q_nope.shape[:2]
    x_dtype = q_nope.dtype
    c_kv, k_rope = lat.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    w_uk, w_uv = _uk_uv(cfg, params, x_dtype)
    q_lat = torch.einsum("bchd,lhd->bchl", q_nope, w_uk)          # (B,C,H,lora)
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    sc = torch.einsum("bchl,btl->bhct", q_lat, c_kv)
    sc = sc + torch.einsum("bchd,btd->bhct", q_rope, k_rope)
    sc = sc.float() * scale
    kp = kpos[None, None, None, :]
    mask = (kp <= positions[:, None, :, None]) & (kp >= 0)
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(x_dtype)
    o_lat = torch.einsum("bhct,btl->bchl", p, c_kv)                 # latent space
    out = torch.einsum("bchl,lhd->bchd", o_lat, w_uv)
    return out.reshape(b, c, cfg.num_heads * m.v_head_dim)


def mla_rows(cfg: ModelConfig, params: dict, x: torch.Tensor, pos_dev: torch.Tensor,
             positions, views):
    """One decode token for each of B requests, each over its own latent
    cache: x (B, 1, D), pos_dev (B, 1) on x's device, ``positions`` the same
    as host ints, ``views[r]`` {"ckv", "kpos"} views of row r's layer slot,
    written IN PLACE at the row's position.  The projections and ``wo`` run
    once for the B rows, the absorbed attention row by row.  Returns
    (B, 1, D)."""
    q_nope, q_rope = _project_q(cfg, params, x, pos_dev)
    ckv = compress_kv(cfg, params, x, pos_dev)
    out = torch.cat([_write_and_attend(cfg, params, q_nope[r:r + 1], q_rope[r:r + 1],
                                      pos_dev[r:r + 1], ckv[r:r + 1], view["ckv"],
                                      view["kpos"], p0)
                     for r, (view, p0) in enumerate(zip(views, positions))])
    return out @ params["wo"].to(x.dtype)
