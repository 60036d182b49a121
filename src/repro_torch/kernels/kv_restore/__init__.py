"""Fused restoration dequant-scatter (counterpart of
``repro.kernels.kv_restore``): one launch per load op, every attention
field in the same launch.

``kv_restore_scatter`` takes per-field 3D cache views ``(A, S, C_f)``
(token axis 1, channels flattened last), the op's packed staging buffers
``(A, T, C_f)`` and optional per-chunk scales ``(ceil(T / cs), C_f)``, and
writes tokens ``[t0, t0 + T)`` of slots ``[slot_lo, slot_lo + n_slots)``
with the dequantized (or raw-copied) payload.  Rows past S are dropped.
The caches are updated IN PLACE (the reference returns updated copies).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def _span(cache, staged, t0, slot_lo, n_slots):
    a, s, _c = cache.shape
    ns = a - slot_lo if n_slots is None else n_slots
    rows = min(staged.shape[1], s - t0)
    if rows <= 0 or slot_lo < 0 or slot_lo + ns > a or ns <= 0:
        raise ValueError(f"kv_restore: empty or out-of-range span (t0 {t0}, "
                         f"T {staged.shape[1]}, S {s}, slots {slot_lo}+{ns} "
                         f"of {a})")
    return ns, rows


def kv_restore_plain(caches, staged, scales=None, *, t0: int, slot_lo: int = 0,
                     n_slots=None, chunk_size: int = 0):
    """The plain version: f32 multiply + one cast, or a raw copy."""
    sc = scales if scales is not None else [None] * len(caches)
    for cache, x, s in zip(caches, staged, sc):
        ns, rows = _span(cache, x, t0, slot_lo, n_slots)
        src = x[slot_lo:slot_lo + ns, :rows]
        if s is not None:
            srep = s.float().repeat_interleave(chunk_size, dim=0)[:rows]
            dec = (src.float() * srep[None]).to(cache.dtype)
        else:
            dec = src.to(cache.dtype)
        cache[slot_lo:slot_lo + ns, t0:t0 + rows] = dec
    return list(caches)


def kv_restore_scatter(caches, staged, scales=None, *, t0: int,
                       slot_lo: int = 0, n_slots=None, chunk_size: int):
    """The kernel on CUDA tensors (bf16 or f32 caches; staged int8 with
    scales, else the cache dtype), the plain version on CPU tensors."""
    caches, staged = list(caches), list(staged)
    if caches[0].device.type == "cpu":
        return kv_restore_plain(caches, staged, scales, t0=t0, slot_lo=slot_lo,
                                n_slots=n_slots, chunk_size=chunk_size)
    nf = len(caches)
    scales = list(scales) if scales is not None else None
    _build.require_cuda("kv_restore", *caches, *staged, *(scales or []))
    dtype = caches[0].dtype
    if dtype not in _build.DTYPE_CODES or not 1 <= nf <= 4:
        raise ValueError("kv_restore: 1-4 bf16/f32 cache fields")
    a, s, _ = caches[0].shape
    t = staged[0].shape[1]
    ns, rows = _span(caches[0], staged[0], t0, slot_lo, n_slots)
    want = torch.int8 if scales is not None else dtype
    chans = []
    for f in range(nf):
        c = caches[f].shape[2]
        if (caches[f].dtype != dtype or caches[f].shape[:2] != (a, s)
                or staged[f].dtype != want
                or tuple(staged[f].shape) != (a, t, c)):
            raise ValueError(f"kv_restore: field {f} has cache "
                             f"{tuple(caches[f].shape)} {caches[f].dtype}, "
                             f"staged {tuple(staged[f].shape)} "
                             f"{staged[f].dtype}")
        if scales is not None and (
                scales[f].dtype != torch.float32
                or tuple(scales[f].shape) != (-(-t // chunk_size), c)):
            raise ValueError("kv_restore: scales must be f32 "
                             "(ceil(T / chunk_size), C)")
        chans.append(c)
    # the pointer arrays stay referenced here for the whole call
    ptrs = ctypes.c_void_p * nf
    cache_p = ptrs(*[x.data_ptr() for x in caches])
    staged_p = ptrs(*[x.data_ptr() for x in staged])
    scales_p = None if scales is None else ptrs(*[x.data_ptr() for x in scales])
    chans_p = (ctypes.c_int * nf)(*chans)

    def addr(arr):
        return None if arr is None else ctypes.addressof(arr)

    rc = _build.lib().kv_restore(
        nf, addr(cache_p), addr(staged_p), addr(scales_p), addr(chans_p),
        s, t, t0, slot_lo, ns, rows, max(1, chunk_size),
        _build.DTYPE_CODES[dtype], _build.stream_of(caches[0]))
    _build.check_launch("kv_restore", rc)
    kv_restore_scatter.launches += 1
    return caches


kv_restore_scatter.launches = 0
