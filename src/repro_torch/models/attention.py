"""GQA / MQA / windowed attention: the full-sequence path and the chunked
path against a kpos-addressed cache, and the decode of many requests'
tokens in one pass (``attention_rows``).

Counterpart of ``repro.models.attention``.  The chunked path is the
restoration recompute step, suffix prefill and decode: queries of a chunk
attend to [cache || chunk] and the chunk's KV is written into the cache.
On a CUDA tensor it runs in the port's hand-written kernels —
``flash_prefill`` for a chunk of C > 1 tokens, ``flash_decode`` for C = 1;
on a CPU tensor their plain versions run.

The full-sequence path (``attention_full``: training, ``Model.forward``
and ``Model.prefill``) is plain products in the activation dtype, as the
reference computes it outside any Pallas kernel: the masked softmax over
(S, S) scores, or above ``FLASH_THRESHOLD`` keys (or with
``backend="flash"``) the blocked online softmax over key blocks.  Training
runs in f32, which the attention kernels (bf16) do not take.

Positions live on the host: they are known there, the kernels take the
query offset as a launch argument, and the cache slots they address are
plain slices — so nothing here waits on the device for an index.

On a mesh (DTensor parameters and cache, under ``use_mesh``) the chunk's KV
is written through the shards that hold its slots and each rank's kernel
gets its own shards (``_attend``): the same kernels, on local tensors.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.collectives import lse_decode_attention
from repro_torch.distributed.constraints import (ambient_mesh, axis_size, constrain,
                                                 local_call, merge_dims, split_dim,
                                                 write_slots)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models.layers import apply_rope, dense_init, rms_head_norm

NEG_INF = -1e30
FLASH_THRESHOLD = 8192        # the blocked form above this many keys
FLASH_BLOCK = 1024


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
    q = split_dim(q, -1, (hq, dh))
    k = split_dim(k, -1, (hk, dh))
    v = split_dim(v, -1, (hk, dh))
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
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    if c == 1 and not _is_dtensor(k_cache):
        out = _decode_row(cfg, q[:, 0], k[:, 0], v[:, 0], k_cache, v_cache, kpos, p0,
                         scale)
        return (out.reshape(b, c, cfg.num_heads * cfg.head_dim) @ params["wo"].to(x.dtype),
                k_cache, v_cache, kpos)
    # --- write chunk KV into the cache (ring buffer if windowed) ---
    if _is_dtensor(k_cache):
        slots = [(p0 + i) % s_cache if cfg.attn_window else p0 + i for i in range(c)]
        write_slots(k_cache, 1, slots, k.to(k_cache.dtype))
        write_slots(v_cache, 1, slots, v.to(v_cache.dtype))
        write_slots(kpos, 0, slots, torch.arange(p0, p0 + c, dtype=torch.int32, device=dev))
    elif cfg.attn_window:
        slot = pos_dev[0] % s_cache
        k_cache[:, slot] = k.to(k_cache.dtype)
        v_cache[:, slot] = v.to(v_cache.dtype)
        kpos[slot] = pos_dev[0]
    else:
        k_cache[:, p0:p0 + c] = k.to(k_cache.dtype)
        v_cache[:, p0:p0 + c] = v.to(v_cache.dtype)
        kpos[p0:p0 + c] = pos_dev[0]
    kc, vc = k_cache.to(q.dtype), v_cache.to(q.dtype)
    out = _attend(cfg, q, kc, vc, kpos, p0, scale)
    out = merge_dims(out, b, c, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), k_cache, v_cache, kpos


def _decode_row(cfg: ModelConfig, q, k, v, k_cache, v_cache, kpos, p0: int,
               scale: float):
    """One decode token over one request's cache: its K, V and position
    written at slot ``p0`` (the ring slot if windowed), then ``flash_decode``
    over the slot.  q (B, Hq, Dh), k/v (B, Hk, Dh); k_cache/v_cache
    (B, S, Hk, Dh) and kpos (S,) are updated IN PLACE.  Returns (B, Hq, Dh)."""
    slot = p0 % k_cache.shape[1] if cfg.attn_window else p0
    k_cache[:, slot] = k.to(k_cache.dtype)
    v_cache[:, slot] = v.to(v_cache.dtype)
    kpos[slot] = p0
    return flash_decode(q.contiguous(), k_cache.to(q.dtype).contiguous(),
                        v_cache.to(q.dtype).contiguous(), kpos, p0, scale=scale,
                        window=cfg.attn_window)


def attention_rows(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   pos_dev: torch.Tensor, positions, views):
    """One decode token for each of B requests, each over its own cache.

    x: (B, 1, D); pos_dev: (B, 1) int positions on x's device, ``positions``
    the same as host ints; ``views[r]``: {"k", "v", "kpos"} views of row
    r's layer slot ((1, S_r, Hk, Dh), (S_r,)), its own length, updated IN
    PLACE.  The projections run once for the B rows; each row goes through
    ``_decode_row`` on its own cache.  Returns (B, 1, D)."""
    b = x.shape[0]
    q, k, v = project_qkv(cfg, params, x, pos_dev)
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    out = torch.cat([_decode_row(cfg, q[r:r + 1, 0], k[r:r + 1, 0], v[r:r + 1, 0],
                                view["k"], view["v"], view["kpos"], p0, scale)
                     for r, (view, p0) in enumerate(zip(views, positions))])
    return out.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ params["wo"].to(x.dtype)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _kernel(q, k, v, kpos, p0: int, scale: float, window: int):
    """q (B, C, Hq, Dh) over the cache slot: ``flash_decode`` for C = 1,
    ``flash_prefill`` above."""
    if q.shape[1] == 1:
        return flash_decode(q[:, 0].contiguous(), k.contiguous(), v.contiguous(),
                            kpos.contiguous(), p0, scale=scale, window=window)[:, None]
    return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(), kpos.contiguous(),
                         p0, scale=scale, window=window)


def _attend(cfg: ModelConfig, q, kc, vc, kpos, p0: int, scale: float):
    """The chunk's attention in the kernels.  On a mesh (DTensor cache) each
    rank's kernel gets its own shards: with kv-heads over "model" (the
    cache's rule where they divide it) each rank attends its heads, q's
    matching heads moved over "model"; a cache sharded along its sequence
    decodes through ``lse_decode_attention`` (each rank's slots, an LSE
    combine) and a prefill chunk attends the slot gathered over "model"
    (a counted all-gather).  Batch rows stay over ("pod", "data")."""
    if not _is_dtensor(kc):
        return _kernel(q, kc, vc, kpos, p0, scale, cfg.attn_window)
    mesh = ambient_mesh()
    msize = axis_size(mesh, "model")
    heads = cfg.num_kv_heads % msize == 0
    if not heads and q.shape[1] == 1:
        return lse_decode_attention(q, kc, vc, kpos, p0, scale=scale,
                                    window=cfg.attn_window)
    spec = (("pod", "data"), None, "model" if heads else None, None)
    return local_call(lambda *t: _kernel(*t, p0, scale, cfg.attn_window),
                      [(q, spec), (kc, spec), (vc, spec), (kpos, (None,))], (0,))


# ---------------------------------------------------------------------------
# Full-sequence path (train / prefill)
# ---------------------------------------------------------------------------


def gqa_scores_naive(q, k, v, mask, scale):
    """q (B,S,Hq,Dh), k/v (B,T,Hk,Dh), mask (B,S,T) or (S,T) bool ->
    (B,S,Hq,Dv).  Scores scaled and softmaxed in f32, the probabilities
    cast back to q's dtype before P·V, as the reference."""
    b, s, hq, dh = q.shape
    hk = k.shape[2]
    qg = split_dim(q, 2, (hk, hq // hk))
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, hq, v.shape[-1])


def gqa_flash(q, k, v, q_pos, k_pos, scale, window: int, block: int = FLASH_BLOCK):
    """Online-softmax attention over key blocks of ``block``: q (B,S,Hq,Dh),
    k (B,T,Hk,Dh), v (B,T,Hk,Dv), q_pos (B,S) and k_pos (B,T) int (k_pos < 0
    marks an empty slot).  The reference's ``_gqa_flash``: the same
    sharding constraints, running max, sum and accumulator in f32, the
    probabilities cast to q's dtype before P·V."""
    # on a mesh: heads over "model" when they divide it, else queries over
    # it with the KV replicated (the reference's constraints; no-ops off-mesh)
    mesh = ambient_mesh()
    msize = axis_size(mesh, "model") if mesh is not None else 1
    bax = ("pod", "data")
    heads = msize > 1 and q.shape[2] % msize == 0
    rows = not heads and msize > 1 and q.shape[1] > 1 and q.shape[1] % msize == 0
    hq, hk = q.shape[2], k.shape[2]
    qpr, g = hq // msize, hq // hk
    groups = heads and (hk % msize == 0 or g % qpr == 0 or qpr % g == 0)
    if _is_dtensor(q) and (groups or rows):
        # each rank runs the block loop on its own rows or query heads, the
        # latter with the KV heads they group with (its shard where the KV
        # heads divide "model", else its heads' slice of the gathered KV):
        # the work has no cross-rank term, and DTensor would propagate every
        # block's products anew (and gather a head split it cannot shard)
        kvh = "model" if groups and hk % msize == 0 else None
        first, last = 0, None
        if groups and kvh is None:
            r = mesh.get_local_rank("model")
            first, last = r * qpr // g, ((r + 1) * qpr - 1) // g + 1
        qs = (bax, None, "model", None) if groups else (bax, "model", None, None)
        kvs = (bax, None, kvh, None)
        return local_call(
            lambda qq, kk, vv, qp, kp: gqa_flash(qq, kk[:, :, first:last], vv[:, :, first:last],
                                                 qp, kp, scale, window, block),
            [(q, qs), (k, kvs), (v, kvs), (q_pos, (bax, qs[1])), (k_pos, (bax, None))], (0,))
    if heads:
        q = constrain(q, bax, None, "model", None)
        k = constrain(k, bax, None, "model", None)
        v = constrain(v, bax, None, "model", None)
    elif rows:
        q = constrain(q, bax, "model", None, None)
        k = constrain(k, bax, None, None, None)
        v = constrain(v, bax, None, None, None)
    b, s, hq, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hk
    if t % block:
        pad = block - t % block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        t += pad
    qg = split_dim(q, 2, (hk, g))
    m = torch.full((b, hk, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, hk, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, hk, g, dv), dtype=torch.float32, device=q.device)
    for lo in range(0, t, block):
        kc, vc, pc = k[:, lo:lo + block], v[:, lo:lo + block], k_pos[:, lo:lo + block]
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kc).float() * scale
        valid = (pc[:, None, :] <= q_pos[:, :, None]) & (pc[:, None, :] >= 0)
        if window > 0:
            valid &= pc[:, None, :] > q_pos[:, :, None] - window
        sc = torch.where(valid[:, None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), vc).float()
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    den = torch.clamp_min(den, 1e-30)
    out = acc / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, hq, dv).to(q.dtype)


def use_flash(backend: str, s: int) -> bool:
    """The reference's choice: the blocked form when asked for, or above
    FLASH_THRESHOLD keys."""
    if backend not in ("auto", "flash"):
        raise ValueError(f"unknown attention backend {backend!r}")
    return backend == "flash" or (backend == "auto" and s > FLASH_THRESHOLD)


def attention_full(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   positions: torch.Tensor, backend: str = "auto"):
    """Causal self-attention over the whole sequence (windowed if the config
    says so).  x (B,S,D); positions (B,S) int on x's device.  Returns
    (out (B,S,D), (k, v)) — callers keep k/v when building a cache."""
    q, k, v = project_qkv(cfg, params, x, positions)
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    b, s = x.shape[:2]
    if use_flash(backend, s):
        out = gqa_flash(q, k, v, positions, positions, scale, cfg.attn_window)
    else:
        i, j = positions[:, :, None], positions[:, None, :]
        mask = j <= i
        if cfg.attn_window:
            mask &= j > i - cfg.attn_window
        out = gqa_scores_naive(q, k, v, mask, scale)
    out = merge_dims(out, b, s, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), (k, v)
