"""Per-channel int8 KV quantizer (counterpart of ``repro.kernels.kv_quant``).

Channel = the LAST axis; each channel's scale is the absmax over every other
axis, ``max(absmax, 1e-12) / 127``, and ``q = clip(round_half_even(x / s),
-127, 127)`` by a true divide.  Dequantize is one f32 multiply and one cast;
its kernel is the decode routine ``csrc/dequant_rows.cuh`` shares with
``kv_restore``, and takes every field of a transfer run in one launch.

The quantizer is one launch of thread-block clusters (``csrc/kv_quant.cu``):
each block of a cluster owns a slab of rows and reduces its per-channel
maxima, the blocks swap them through distributed shared memory, then each
quantizes its cluster's share of its slab.  Every cluster reduces all the
rows, so the clusters need not meet.  ``quant_plan`` picks the cluster size,
the clusters, the rows a block and whether the slab stays in shared memory.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_restore import MAXF, RowsPlan, aligned16, rows_plan

# csrc/kv_quant.cu's constants
NT = 512                     # threads a block
STAGES = 4                   # bulk copies (and mbarriers) a slab is cut into
SMEM_OPTIN = _build.SMEM_OPTIN
CLUSTER = 8                  # blocks a cluster: the portable size, the default
MAX_CLUSTER = 16             # the non-portable size an H100 schedules
# Clusters a launch, and blocks a launch, at most: 12 clusters of 8 were
# among the fastest in `chip_smoke.py --quant-sweep` (H100); at 128 blocks
# some clusters wait for SMs and the launch slows by 40%.
CLUSTERS = 12
MAX_BLOCKS = 96


class QuantPlan(NamedTuple):
    n: int                   # blocks in a cluster
    clusters: int            # clusters in the launch (each quantizes 1/clusters of the rows)
    rows_per: int            # rows a block (the last ranks may hold fewer, or none)
    slab: bool               # rows held in shared memory, else re-read from L2
    vec: int                 # elements a unit: 16 bytes, or 1 (scalar)
    smem: int                # dynamic shared memory a block (bytes)


def _smem_bytes(c: int, slab_bytes: int) -> int:
    """csrc/kv_quant.cu `layout`: amax, scale and inv (C words each), STAGES
    mbarriers, then the slab at a 128-byte boundary."""
    mbar = -(-12 * c // 8) * 8
    return -(-(mbar + 8 * STAGES) // 128) * 128 + slab_bytes


def quant_plan(r: int, c: int, esz: int, aligned: bool = True, n: int | None = None,
               slab: bool | None = None, clusters: int | None = None) -> QuantPlan:
    """The launch for x viewed as (r, c) with ``esz``-byte elements.

    Rows of whole 16-byte units at 16-byte aligned pointers go by units
    (``vec`` = 16 / esz); anything else one element at a time, re-read.
    Unforced, the cluster has CLUSTER blocks and holds its slabs in shared
    memory if they fit, else MAX_CLUSTER blocks if theirs fit, else
    MAX_CLUSTER blocks re-reading their rows.  Up to CLUSTERS clusters, no
    more than MAX_BLOCKS blocks in all and none whose share of a rank's rows
    would be empty.  ``n``, ``slab`` and ``clusters`` force the cluster
    size, the branch and the clusters (``chip_smoke.py --quant-sweep``); a
    forced slab that does not fit raises."""
    if r < 1 or c < 1:
        raise ValueError(f"kv_quantize: empty view ({r}, {c})")
    vec = 16 // esz if (c * esz) % 16 == 0 and aligned else 1

    def fits(n_: int) -> bool:
        return _smem_bytes(c, -(-r // n_) * c * esz) <= SMEM_OPTIN

    if n is None:
        n = CLUSTER if vec > 1 and slab is not False and fits(CLUSTER) else MAX_CLUSTER
    if not 1 <= n <= MAX_CLUSTER:
        raise ValueError(f"kv_quantize: cluster of {n} blocks (1-{MAX_CLUSTER})")
    if slab is None:
        slab = vec > 1 and fits(n)
    elif slab and (vec == 1 or not fits(n)):
        raise ValueError(f"kv_quantize: no slab branch for ({r}, {c}) x {esz} B "
                         f"over {n} blocks")
    rows_per = -(-r // n)
    smem = _smem_bytes(c, rows_per * c * esz if slab else 0)
    if smem > SMEM_OPTIN:
        raise ValueError(f"kv_quantize: {c} channels need {smem} B of shared memory")
    row_groups = -(-rows_per // (NT // min(c // vec, NT)))   # csrc: rl_n rows a group
    if clusters is None:
        clusters = max(1, min(CLUSTERS, MAX_BLOCKS // n, row_groups))
    if not 1 <= clusters * n <= 1024:
        raise ValueError(f"kv_quantize: {clusters} clusters of {n} blocks")
    return QuantPlan(n, clusters, rows_per, slab, vec, smem)


def kv_quantize_plain(x):
    """x: float tensor, any rank >= 1.  Returns (q int8 of x's shape,
    scales f32 of shape (x.shape[-1],))."""
    xf = x.float()
    absmax = xf.abs().amax(dim=tuple(range(x.ndim - 1)))
    # tensor / tensor: a true divide on every device (a Python-scalar
    # divisor may become a reciprocal multiply)
    scales = absmax.clamp(min=1e-12) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(xf / scales), -127, 127).to(torch.int8)
    return q, scales


def kv_dequantize_plain(q, scales, dtype=torch.bfloat16, *, chunk_size=None):
    """One f32 multiply and one cast.  A tensor q with scales (C,), or a
    run: lists of (A, T, C_f) codes and (ceil(T / chunk_size), C_f) scales,
    decoded a chunk at a time with that chunk's row of scales (a list of
    (A, n_c, C_f) chunks a field)."""
    if isinstance(q, torch.Tensor):
        return (q.float() * scales.float()).to(dtype)
    return [[(x[:, c0:c0 + chunk_size].float() * s[c0 // chunk_size].float()).to(dtype)
             for c0 in range(0, x.shape[1], chunk_size)] for x, s in zip(q, scales)]


def kv_quantize(x, *, plan: QuantPlan | None = None):
    """The one-launch cluster kernel on a CUDA tensor (bf16 or f32,
    contiguous), the plain version on a CPU tensor.  ``plan`` replaces
    :func:`quant_plan`'s choice for x (``chip_smoke.py --quant-sweep``)."""
    if x.device.type == "cpu":
        return kv_quantize_plain(x)
    _build.refuse_dtensor("kv_quantize", x)
    _build.require_cuda("kv_quantize", x)
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"kv_quantize: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    r = x.numel() // c
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(c, dtype=torch.float32, device=x.device)
    p = plan or quant_plan(r, c, x.element_size(),
                           aligned=(x.data_ptr() | q.data_ptr()) % 16 == 0)
    rc = _build.lib().kv_quantize(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), r, c,
        _build.DTYPE_CODES[x.dtype], p.n, p.clusters, p.rows_per, int(p.slab), p.vec,
        _build.stream_of(x))
    _build.check_launch("kv_quantize", rc)
    kv_quantize.launches += 1
    return q, scales


def _dequant_shapes(q, scales, dtype, chunk_size):
    """(A, T, chans, cs) of a call, as one run; raises on what the kernel
    does not take.  A tensor q (any shape) with scales (C,) is one chunk:
    A = 1, T = its rows."""
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"kv_dequantize: output dtype {dtype} (bf16 or f32)")
    if isinstance(q, torch.Tensor):
        c = q.shape[-1] if q.dim() else 0
        if (q.dtype != torch.int8 or c < 1 or q.numel() < 1 or scales.dtype != torch.float32
                or tuple(scales.shape) != (c,)):
            raise ValueError("kv_dequantize: takes int8 q and f32 scales (C,)")
        return 1, q.numel() // c, [c], q.numel() // c
    if not 1 <= len(q) <= MAXF or len(scales) != len(q) or not chunk_size or chunk_size < 1:
        raise ValueError(f"kv_dequantize: a run of 1-{MAXF} fields, each with its "
                         "scales, and a chunk_size")
    a, t = q[0].shape[:2]
    chans = []
    for x, s in zip(q, scales):
        if (x.dtype != torch.int8 or x.dim() != 3 or x.shape[:2] != (a, t) or a < 1
                or t < 1 or not x[0].is_contiguous()):
            raise ValueError(f"kv_dequantize: run field {tuple(x.shape)} {x.dtype}: "
                             "int8 (A, T, C) with rows contiguous")
        if s.dtype != torch.float32 or tuple(s.shape) != (-(-t // chunk_size), x.shape[2]):
            raise ValueError(f"kv_dequantize: run scales {tuple(s.shape)} {s.dtype}: "
                             f"f32 (ceil(T / chunk_size), C) = ({-(-t // chunk_size)}, "
                             f"{x.shape[2]})")
        chans.append(x.shape[2])
    return a, t, chans, chunk_size


def _dequant_views(q, scales, a, t, chans):
    """The run form of a call: lists of (A, T, C_f) codes and (n, C_f) scales."""
    if isinstance(q, torch.Tensor):
        return [q.reshape(a, t, chans[0])], [scales.reshape(1, chans[0])]
    return list(q), list(scales)


def kv_dequantize_plan(q, scales, dtype=torch.bfloat16, *, chunk_size=None) -> RowsPlan:
    """The plan the kernel launches for this call (on any device; the
    outputs are fresh, so aligned)."""
    a, t, chans, cs = _dequant_shapes(q, scales, dtype, chunk_size)
    qs, ss = _dequant_views(q, scales, a, t, chans)
    esz = torch.empty((), dtype=dtype).element_size()
    ptrs = [x.data_ptr() for x in qs + ss]
    strides = [x.stride(0) for x in qs] + [k * cs * c * esz for c in chans for k in (1, a)]
    return rows_plan(chans, t, a, aligned16(ptrs, strides))


def kv_dequantize(q, scales, dtype=torch.bfloat16, *, chunk_size=None):
    """Inverse of :func:`kv_quantize` (lossy): the kernel on CUDA tensors,
    the plain version on CPU tensors.

    ``q`` a tensor (any shape, channels last) with ``scales`` (C,): one
    chunk, returns one tensor of q's shape.  ``q`` a list of (A, T, C_f)
    int8 views whose rows are contiguous (any slot stride: a run's columns
    of a staging buffer) with ``scales`` a list of per-chunk
    (ceil(T / chunk_size), C_f) f32: a transfer run, every field in one
    launch; returns for each field its chunks, (A, n_c, C_f) each: views of
    one fresh chunk-major buffer, so each chunk but a ragged last one is
    contiguous, as the pool copies it."""
    a, t, chans, cs = _dequant_shapes(q, scales, dtype, chunk_size)
    run = not isinstance(q, torch.Tensor)
    dev = (q[0] if run else q).device
    if dev.type == "cpu":
        return kv_dequantize_plain(q, scales, dtype, chunk_size=chunk_size)
    _build.refuse_dtensor("kv_dequantize", *(q if run else [q]),
                          *(scales if run else [scales]))
    qs, ss = _dequant_views(q, scales, a, t, chans)
    _build.require_cuda("kv_dequantize", *ss, *qs, contiguous=False)
    _build.require_cuda("kv_dequantize", *ss, *([] if run else [q]))
    outs = [torch.empty((-(-t // cs), a, cs, c), dtype=dtype, device=dev) for c in chans]
    nf = len(qs)
    ptrs = ctypes.c_void_p * nf
    # the pointer arrays stay referenced here for the whole call
    out_p = ptrs(*[x.data_ptr() for x in outs])
    q_p = ptrs(*[x.data_ptr() for x in qs])
    s_p = ptrs(*[x.data_ptr() for x in ss])
    chans_p = (ctypes.c_int * nf)(*chans)
    qss_p = (ctypes.c_longlong * nf)(*[x.stride(0) for x in qs])
    rc = _build.lib().kv_dequantize(
        nf, ctypes.addressof(out_p), ctypes.addressof(q_p), ctypes.addressof(s_p),
        ctypes.addressof(chans_p), ctypes.addressof(qss_p), a, t, cs,
        _build.DTYPE_CODES[dtype], _build.stream_of(ss[0]))
    _build.check_launch("kv_dequantize", rc)
    kv_dequantize.launches += 1
    if run:
        kv_dequantize.run_launches += 1
        return [[o[k // cs, :, :min(cs, t - k)] for k in range(0, t, cs)] for o in outs]
    return outs[0].view(q.shape)


kv_quantize.launches = 0
kv_dequantize.launches = 0
kv_dequantize.run_launches = 0    # of those, the run form (a transfer run's promotion)
