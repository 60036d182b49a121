"""Causal GQA flash attention of a query chunk over a kpos-addressed cache.

Counterpart of ``repro.kernels.flash_prefill`` with the model's masking:
query i sits at ``q_offset + i``; key slot j is visible iff
``0 <= kpos[j] <= q_offset + i`` (and ``kpos[j] > q_offset + i - window``).
The reference kernel's ``kv_len`` mask is the case ``kpos[j] = j`` for
``j < kv_len``, else -1.  A row with no visible slot gets a uniform softmax
over all S slots, as the finite -1e30 mask of the reference gives it.

The kernel packs the G query heads of a KV head into M tiles of
``M_TILE`` (query row, head) pairs; one block per (M tile, KV head, split
of the cache, batch row).  Where the M tiles alone leave SMs idle, the plan
(:func:`_plan`) splits the cache, the blocks write f32 partials (m, l, acc)
and a second kernel combines them (``csrc/flash_prefill.cu``).  One
wrapper call is one counted launch.

On ``meta`` tensors the wrapper takes the same checks and returns an empty
``meta`` output of the CUDA route's shape and dtype, launching nothing (the
dry run's route).  On both routes a call is noted to an active
``repro_torch.launch.op_cost`` analysis with its products
(:func:`_products`).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.launch import op_cost

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)   # head dims the kernel is built for
M_TILE = 64                  # (row, head) pairs a block: FP_M in flash_prefill.cu
TILE = 64                    # slots a key tile: FP_BK in flash_prefill.cu
FILL = 15 / 16               # share of the SMs the M tiles must fill unsplit
BLOCK_TILES = 2              # a block's own cost in key tiles (see _plan)


@functools.lru_cache(maxsize=None)
def _plan(b: int, hkv: int, sq: int, g: int, s: int,
          sm_count: int) -> tuple[int, int, int]:
    """(M tile, n_split, slots per split) for q (b, sq, hkv * g, Dh) over
    s cache slots.  The M tiles alone are b * hkv * ceil(sq * g / M_TILE)
    blocks; where they fill at least FILL of the SMs the cache is not split
    (every split costs f32 partials and a combine).  Otherwise the cache is
    cut into splits of whole TILE-slot tiles (the last one ragged).  A
    block holds an SM by itself (its shared memory), so a call lasts about
    waves x (tiles per split + BLOCK_TILES), BLOCK_TILES being a block's
    own cost (Q, the kpos pass, its partials and their combine) in tiles:
    take the least of that, and among equals the fewest splits."""
    tiles = -(-s // TILE)
    blocks = b * hkv * -(-sq * g // M_TILE)
    if blocks >= FILL * sm_count:
        return M_TILE, 1, tiles * TILE
    best = None
    for want in range(1, tiles + 1):
        per = -(-tiles // want)
        n = -(-tiles // per)
        cost = -(-blocks * n // sm_count) * (per + BLOCK_TILES)
        if best is None or (cost, n) < best[0]:
            best = ((cost, n), per)
    (_, n), per = best
    return M_TILE, n, per * TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _products(q_shape, k_shape) -> int:
    """2 per multiply-add of the function's products, QKᵀ and PV, over
    every (query row, slot) pair, as the plain version computes them:
    4·B·Sq·Hq·S·Dh for q (B, Sq, Hq, Dh) over k (B, S, Hkv, Dh)."""
    b, sq, hq, dh = q_shape
    return 4 * b * sq * hq * k_shape[1] * dh


def flash_prefill_plain(q, k, v, kpos, q_offset: int, *, scale: float,
                        window: int = 0):
    """q (B, Sq, Hq, Dh); k/v (B, S, Hkv, Dh); kpos (S,) int32.  Scores and
    softmax in f32, probabilities cast to the value dtype before P.V, as the
    model's chunk attention does.  Returns (B, Sq, Hq, Dh) in q's dtype."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kp = kpos.to(q.device)[None, :]
    mask = (kp <= q_pos) & (kp >= 0)
    if window > 0:
        mask &= kp > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(b, sq, hq, dh)


def flash_prefill(q, k, v, kpos, q_offset: int, *, scale: float,
                  window: int = 0):
    """The kernel on a CUDA tensor (bf16, Dh 64, 128 or 256, Hq a multiple of
    Hkv), the plain version on a CPU tensor, an empty output on ``meta``."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, kpos, q_offset, scale=scale,
                                   window=window)
    _build.refuse_dtensor("flash_prefill", q, k, v, kpos)
    # layout, types and shapes before device: refused whatever they lie on
    if not all(t.is_contiguous() for t in (q, k, v, kpos)):
        raise ValueError("flash_prefill: q, k, v and kpos must be contiguous "
                         "(the CUDA kernel addresses dense rows)")
    b, sq, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("flash_prefill: the CUDA kernel takes bf16 q/k/v")
    if kpos.dtype != torch.int32 or tuple(kpos.shape) != (s,):
        raise ValueError("flash_prefill: the CUDA kernel takes kpos as int32 of "
                         "shape (S,)")
    if (dh not in HEAD_DIMS or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != dh or hq % hkv or sq == 0 or s == 0):
        raise ValueError(f"flash_prefill: the CUDA kernel does not take q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} (Dh 64, 128 or 256, "
                         f"Hq a multiple of Hkv)")
    _build.require_cuda("flash_prefill", q, k, v, kpos, meta=True)
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_prefill: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if op_cost.ACTIVE is not None:
        op_cost.note("flash_prefill", _products(q.shape, k.shape),
                     _build.nbytes(q, k, v, kpos, out))
    if q.device.type == "meta":
        return out
    _, n_split, split_slots = _plan(b, hkv, sq, hq // hkv, s,
                                    _sm_count(q.device.index))
    m = l = acc = 0
    if n_split > 1:
        # f32 partials of every (row, query head, split): acc, then m, then l
        rows = b * sq * hq * n_split
        part = torch.empty(rows * (dh + 2), dtype=torch.float32, device=q.device)
        acc, m, l = (t.data_ptr() for t in (part[:rows * dh],
                                            part[rows * dh:rows * (dh + 1)],
                                            part[rows * (dh + 1):]))
    rc = _build.lib().flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        out.data_ptr(), m, l, acc, b, sq, s, hq, hkv, dh, int(q_offset),
        int(window), n_split, split_slots, float(scale), _build.stream_of(q))
    _build.check_launch("flash_prefill", rc)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
