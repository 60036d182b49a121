"""Per-channel int8 KV quantizer (counterpart of ``repro.kernels.kv_quant``).

Channel = the LAST axis; each channel's scale is the absmax over every other
axis, ``max(absmax, 1e-12) / 127``, and ``q = clip(round_half_even(x / s),
-127, 127)`` by a true divide.  Dequantize is one f32 multiply and one cast.

The quantizer is one launch of thread-block clusters (``csrc/kv_quant.cu``):
each block of a cluster owns a slab of rows and reduces its per-channel
maxima, the blocks swap them through distributed shared memory, then each
quantizes its cluster's share of its slab.  Every cluster reduces all the
rows, so the clusters need not meet.  ``quant_plan`` picks the cluster size,
the clusters, the rows a block and whether the slab stays in shared memory.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

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


def kv_dequantize_plain(q, scales, dtype=torch.bfloat16):
    return (q.float() * scales.float()).to(dtype)


def kv_quantize(x, *, plan: QuantPlan | None = None):
    """The one-launch cluster kernel on a CUDA tensor (bf16 or f32,
    contiguous), the plain version on a CPU tensor.  ``plan`` replaces
    :func:`quant_plan`'s choice for x (``chip_smoke.py --quant-sweep``)."""
    if x.device.type == "cpu":
        return kv_quantize_plain(x)
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


def kv_dequantize(q, scales, dtype=torch.bfloat16):
    """Inverse of :func:`kv_quantize` (lossy): the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return kv_dequantize_plain(q, scales, dtype)
    _build.require_cuda("kv_dequantize", q, scales)
    c = q.shape[-1]
    if (q.dtype != torch.int8 or scales.dtype != torch.float32
            or tuple(scales.shape) != (c,) or dtype not in _build.DTYPE_CODES):
        raise ValueError("kv_dequantize: takes int8 q, f32 scales (C,) and a "
                         "bf16/f32 output dtype")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    rc = _build.lib().kv_dequantize(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), q.numel() // c, c,
        _build.DTYPE_CODES[dtype], _build.stream_of(q))
    _build.check_launch("kv_dequantize", rc)
    kv_dequantize.launches += 1
    return out


kv_quantize.launches = 0
kv_dequantize.launches = 0
