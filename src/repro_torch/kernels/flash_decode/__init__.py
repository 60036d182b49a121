"""GQA decode attention: one query token per row over a kpos-addressed
cache (counterpart of ``repro.kernels.flash_decode``).  Slot j is visible
iff ``0 <= kpos[j] <= q_pos`` (and ``kpos[j] > q_pos - window``), so ring
buffers work exactly.

The kernel splits the cache: one block per (split, KV head, batch row)
writes f32 partials (m, l, acc) of its split for all the KV head's query
heads, and a second kernel combines them (``csrc/flash_decode.cu``).  One
wrapper call is one counted launch of the two.

``flash_decode_partials`` runs the same split and the combine in its
partials mode: each row's merged f32 partial (acc unnormalised, m, l) over
the slots it was given, which a sequence-sharded decode combines across
ranks (``repro_torch.distributed.collectives.lse_decode_attention``).

On ``meta`` tensors both wrappers take the same checks and return empty
``meta`` outputs of the CUDA route's shapes and dtypes, launching nothing
(the dry run's route).  On both routes a call is noted to an active
``repro_torch.launch.op_cost`` analysis with its products
(:func:`_products`)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.launch import op_cost

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)   # head dims the kernel is built for
TILE = 32                    # slots per tile: FD_TILE in flash_decode.cu
BLOCKS_PER_SM = 4            # what the split plan aims at (see _split_plan)


@functools.lru_cache(maxsize=None)
def _split_plan(b: int, hkv: int, s: int, sm_count: int) -> tuple[int, int]:
    """Cut S slots into n_split splits of whole TILE-slot tiles (the last
    one ragged), one block per (split, KV head, batch row).  An SM runs
    BLOCKS_PER_SM blocks about as fast as one (the tile loop is bound by
    latency), so the call lasts about tiles per split x max(BLOCKS_PER_SM,
    blocks on the busiest SM): take the least of that over at most twice
    BLOCKS_PER_SM blocks per SM, and among equals the block count nearest
    BLOCKS_PER_SM per SM.  Returns (slots per split, n_split)."""
    tiles = -(-s // TILE)
    rows = b * hkv
    target = BLOCKS_PER_SM * sm_count
    best = None
    for n in range(1, min(tiles, -(-2 * target // rows)) + 1):
        per = -(-tiles // n)
        n = -(-tiles // per)
        busiest = max(BLOCKS_PER_SM, -(-rows * n // sm_count))
        key = (per * busiest, abs(rows * n - target))
        if best is None or key < best[0]:
            best = (key, per, n)
    return best[1] * TILE, best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _products(q_shape, k_shape) -> int:
    """2 per multiply-add of the function's products, QKᵀ and PV, over
    every slot: 4·B·Hq·S·Dh for q (B, Hq, Dh) over k (B, S, Hkv, Dh)."""
    b, hq, dh = q_shape
    return 4 * b * hq * k_shape[1] * dh


def flash_decode_plain(q, k, v, kpos, q_pos: int, *, scale: float,
                       window: int = 0):
    """q (B, Hq, Dh); k/v (B, S, Hkv, Dh); kpos (S,) int32.  All in f32,
    as ``flash_decode_ref``.  Returns (B, Hq, Dh) in q's dtype."""
    b, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    kp = kpos.to(q.device)
    valid = (kp >= 0) & (kp <= q_pos)
    if window > 0:
        valid &= kp > q_pos - window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(b, hq, dh).to(q.dtype)


def flash_decode_partials_plain(q, k, v, kpos, q_pos: int, *, scale: float,
                                window: int = 0):
    """The reference's ``_partial_decode`` on (B, Hq, Dh) queries, in f32:
    (acc (B, Hq, Dh) unnormalised, m (B, Hq), l (B, Hq)).  Masked scores
    are the finite NEG_INF, so a row with no visible slot has m = NEG_INF,
    l = S and acc = the sum of V."""
    b, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    kp = kpos.to(q.device)
    valid = (kp >= 0) & (kp <= q_pos)
    if window > 0:
        valid &= kp > q_pos - window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return acc.reshape(b, hq, v.shape[-1]), m.reshape(b, hq), p.sum(dim=-1).reshape(b, hq)


def _check(name, q, k, v, kpos):
    """The kernel's refusals (layout, types and shapes before device:
    refused whatever they lie on)."""
    _build.refuse_dtensor(name, q, k, v, kpos)
    if not all(t.is_contiguous() for t in (q, k, v, kpos)):
        raise ValueError(f"{name}: q, k, v and kpos must be contiguous "
                         "(the kernel addresses dense (B, S, Hkv, Dh) rows)")
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q/k/v")
    if kpos.dtype != torch.int32 or tuple(kpos.shape) != (s,):
        raise ValueError(f"{name}: the CUDA kernel takes kpos as int32 of "
                         "shape (S,)")
    if (dh not in HEAD_DIMS or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != dh or hq % hkv):
        raise ValueError(f"{name}: the CUDA kernel does not take q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} (Dh 64, 128 or 256, "
                         f"Hq a multiple of Hkv)")
    _build.require_cuda(name, q, k, v, kpos, meta=True)
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")


def _split_scratch(q, k):
    """(split_slots, n_split, m, l, acc): the split plan and the f32
    partials of every (row, query head, split)."""
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    split_slots, n_split = _split_plan(b, hkv, s, _sm_count(q.device.index))
    rows = b * hq * n_split
    part = torch.empty(rows * (dh + 2), dtype=torch.float32, device=q.device)
    acc, m, l = part[:rows * dh], part[rows * dh:rows * (dh + 1)], part[rows * (dh + 1):]
    return split_slots, n_split, m, l, acc


def flash_decode(q, k, v, kpos, q_pos: int, *, scale: float, window: int = 0):
    """The kernel on a CUDA tensor (bf16, Dh 64, 128 or 256, Hq a multiple of
    Hkv), the plain version on a CPU tensor, an empty output on ``meta``."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kpos, q_pos, scale=scale,
                                  window=window)
    _check("flash_decode", q, k, v, kpos)
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if op_cost.ACTIVE is not None:
        op_cost.note("flash_decode", _products(q.shape, k.shape),
                     _build.nbytes(q, k, v, kpos, out))
    if q.device.type == "meta":
        return out
    split_slots, n_split, m, l, acc = _split_scratch(q, k)
    rc = _build.lib().flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(), b, s, hq,
        hkv, dh, int(q_pos), int(window), n_split, split_slots, float(scale),
        _build.stream_of(q))
    _build.check_launch("flash_decode", rc)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_partials(q, k, v, kpos, q_pos: int, *, scale: float,
                          window: int = 0):
    """(acc, m, l) in f32 as :func:`flash_decode_partials_plain`: the split
    kernel and the combine in its partials mode on a CUDA tensor (what
    :func:`flash_decode` takes), the plain version on a CPU tensor, empty
    outputs on ``meta``."""
    if q.device.type == "cpu":
        return flash_decode_partials_plain(q, k, v, kpos, q_pos, scale=scale,
                                           window=window)
    _check("flash_decode_partials", q, k, v, kpos)
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty(b * hq * (dh + 2), dtype=torch.float32, device=q.device)
    acc_o = out[:b * hq * dh].view(b, hq, dh)
    m_o = out[b * hq * dh:b * hq * (dh + 1)].view(b, hq)
    l_o = out[b * hq * (dh + 1):].view(b, hq)
    if op_cost.ACTIVE is not None:
        op_cost.note("flash_decode_partials", _products(q.shape, k.shape),
                     _build.nbytes(q, k, v, kpos, out))
    if q.device.type == "meta":
        return acc_o, m_o, l_o
    split_slots, n_split, m, l, acc = _split_scratch(q, k)
    rc = _build.lib().flash_decode_partials_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        acc_o.data_ptr(), m_o.data_ptr(), l_o.data_ptr(), m.data_ptr(),
        l.data_ptr(), acc.data_ptr(), b, s, hq, hkv, dh, int(q_pos), int(window),
        n_split, split_slots, float(scale), _build.stream_of(q))
    _build.check_launch("flash_decode_partials", rc)
    flash_decode_partials.launches += 1
    return acc_o, m_o, l_o


flash_decode_partials.launches = 0
