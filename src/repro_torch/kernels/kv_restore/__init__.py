"""Fused restoration dequant-scatter (counterpart of
``repro.kernels.kv_restore``): one launch per load op, every attention
field in the same launch.

``kv_restore_scatter`` takes per-field 3D cache views ``(A, S, C_f)``
(token axis 1, channels flattened last), the op's packed staging buffers
``(A, T, C_f)`` and optional per-chunk scales ``(ceil(T / cs), C_f)``, and
writes tokens ``[t0, t0 + T)`` of slots ``[slot_lo, slot_lo + n_slots)``
with the dequantized (or raw-copied) payload.  Rows past S are dropped.
The caches are updated IN PLACE (the reference returns updated copies).

The kernel's body is the decode routine of ``csrc/dequant_rows.cuh``,
which ``kv_dequantize`` (``repro_torch.kernels.kv_quant``) shares: a thread
owns 16 channels of a row (16-byte accesses, the chunk's scales held in
registers) over a few consecutive rows, on a grid of (row tiles, slots,
fields); the lanes of a row swap their bf16 results by shuffles so that a
warp's stores are contiguous.  :func:`rows_plan` mirrors the launch the C
side picks.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# csrc/dequant_rows.cuh's constants
NT = 256                     # threads a block
MAXF = 4                     # fields a launch
RPT = 4                      # rows a thread, at most (twice that for raw rows)
TARGET_BLOCKS = 132          # a block for each of an H100's SMs


class RowsPlan(NamedTuple):
    unit: int                # channels a thread's unit: 16 (16-byte accesses) or 1
    rpt: int                 # consecutive rows a thread
    tiles: int               # row tiles (grid.x)
    grid: tuple              # (row tiles, slots, fields)
    threads: int             # threads a block
    lanes: tuple             # row lanes a tile of each field


def row_lanes(c: int, unit: int) -> int:
    """csrc `row_lanes`: NT threads over min(units a row, NT) columns."""
    return NT // min(c // unit, NT)


def rows_plan(chans, rows: int, n_slots: int, aligned: bool = True,
              quant: bool = True) -> RowsPlan:
    """The launch csrc/dequant_rows.cuh `rows_plan` picks for ``rows`` rows
    of ``n_slots`` slots of fields of ``chans`` channels.  16-channel units
    when every C is a multiple of 16 and ``aligned`` (every pointer and slot
    stride 16-byte aligned), else one channel a unit.  Rows a thread: RPT
    for int8 rows (``quant``), 2 * RPT for raw ones, halved down to 1 while
    the grid holds fewer than TARGET_BLOCKS blocks."""
    chans = tuple(int(c) for c in chans)
    if not 1 <= len(chans) <= MAXF or min(chans) < 1 or rows < 1 or n_slots < 1:
        raise ValueError(f"dequant_rows: empty or too many fields ({chans}, "
                         f"rows {rows}, slots {n_slots})")
    unit = 16 if aligned and all(c % 16 == 0 for c in chans) else 1

    def tiles(rpt):
        return max(-(-rows // (row_lanes(c, unit) * rpt)) for c in chans)

    rpt = RPT if quant else 2 * RPT
    while rpt > 1 and tiles(rpt) * n_slots * len(chans) < TARGET_BLOCKS:
        rpt //= 2
    return RowsPlan(unit, rpt, tiles(rpt), (tiles(rpt), n_slots, len(chans)), NT,
                    tuple(row_lanes(c, unit) for c in chans))


def aligned16(ptrs, slot_strides) -> bool:
    """csrc `launch`'s test: every pointer and every slot stride (bytes)
    a multiple of 16."""
    return all(p % 16 == 0 for p in ptrs) and all(s % 16 == 0 for s in slot_strides)


def _span(cache, staged, t0, slot_lo, n_slots):
    a, s, _c = cache.shape
    ns = a - slot_lo if n_slots is None else n_slots
    rows = min(staged.shape[1], s - t0)
    if rows <= 0 or slot_lo < 0 or slot_lo + ns > a or ns <= 0:
        raise ValueError(f"kv_restore: empty or out-of-range span (t0 {t0}, "
                         f"T {staged.shape[1]}, S {s}, slots {slot_lo}+{ns} "
                         f"of {a})")
    return ns, rows


def _check(caches, staged, scales, chunk_size):
    """Channels of each field; raises on fields the kernel does not take."""
    nf = len(caches)
    dtype = caches[0].dtype
    if dtype not in _build.DTYPE_CODES or not 1 <= nf <= MAXF or len(staged) != nf:
        raise ValueError("kv_restore: 1-4 bf16/f32 cache fields")
    a, s, _ = caches[0].shape
    t = staged[0].shape[1]
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
                or tuple(scales[f].shape) != (-(-t // max(1, chunk_size)), c)):
            raise ValueError("kv_restore: scales must be f32 "
                             "(ceil(T / chunk_size), C)")
        chans.append(c)
    return chans


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


def kv_restore_plan(caches, staged, scales=None, *, t0: int, slot_lo: int = 0,
                    n_slots=None, chunk_size: int) -> RowsPlan:
    """The plan the kernel launches for this call (on any device)."""
    chans = _check(caches, staged, scales, chunk_size)
    ns, rows = _span(caches[0], staged[0], t0, slot_lo, n_slots)
    esz = caches[0].element_size()
    a, s, _ = caches[0].shape
    t = staged[0].shape[1]
    in_esz = 1 if scales is not None else esz
    ptrs = [x.data_ptr() + t0 * c * esz for x, c in zip(caches, chans)]
    ptrs += [x.data_ptr() for x in staged] + [x.data_ptr() for x in scales or []]
    strides = [s * c * esz for c in chans] + [t * c * in_esz for c in chans]
    return rows_plan(chans, rows, ns, aligned16(ptrs, strides), scales is not None)


def kv_restore_scatter(caches, staged, scales=None, *, t0: int,
                       slot_lo: int = 0, n_slots=None, chunk_size: int):
    """The kernel on CUDA tensors (bf16 or f32 caches; staged int8 with
    scales, else the cache dtype), the plain version on CPU tensors."""
    caches, staged = list(caches), list(staged)
    scales = list(scales) if scales is not None else None
    chans = _check(caches, staged, scales, chunk_size)
    if caches[0].device.type == "cpu":
        return kv_restore_plain(caches, staged, scales, t0=t0, slot_lo=slot_lo,
                                n_slots=n_slots, chunk_size=chunk_size)
    _build.refuse_dtensor("kv_restore", *caches, *staged, *(scales or []))
    nf = len(caches)
    _build.require_cuda("kv_restore", *caches, *staged, *(scales or []))
    a, s, _ = caches[0].shape
    t = staged[0].shape[1]
    ns, rows = _span(caches[0], staged[0], t0, slot_lo, n_slots)
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
        _build.DTYPE_CODES[caches[0].dtype], _build.stream_of(caches[0]))
    _build.check_launch("kv_restore", rc)
    kv_restore_scatter.launches += 1
    return caches


kv_restore_scatter.launches = 0
