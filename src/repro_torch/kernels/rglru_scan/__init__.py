"""RG-LRU gated linear recurrence ``h_t = exp(log_a_t) * h_{t-1} + b_t``
(counterpart of ``repro.kernels.rglru_scan``), with the TPU kernel's
interface ``(log_a, b, h0) -> (h, h_last)``.

Two CUDA kernels (``csrc/rglru_scan.cu``), picked by :func:`rglru_plan`: a
one-step kernel for decode (S = 1) and, for S >= 2, a time-tiled kernel
whose blocks each own a strip of ``C`` channels and stream ``log_a`` and
``b`` through a ring of shared-memory stages in tiles of ``T`` steps.
Both step the recurrence in time order with the plain version's arithmetic
(``expf``, a multiply, then an add), so they are bit-exact with
:func:`rglru_scan_plain` and one call equals chained calls.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SMEM_OPTIN = _build.SMEM_OPTIN
STEP_NT = 64                 # csrc: threads a block of the one-step kernel
TILE_NT = 256                # csrc: threads a block of the tiled kernel
OUTB = 2                     # csrc: output tiles of the tiled kernel
CSTAGES = 2                  # csrc: chain stages of the tiled kernel
# The tiled kernel's variants (channels a strip, steps a tile, ring stages):
# C in (16, 32, 64), T in (32, 64) and 2 or 4 stages, but for (64, 64, 4),
# which needs 235,648 bytes of shared memory; each built with 16-byte copies
# and stores.  TILE is the one the plan picks, the fastest at S = 256 and 64
# in `chip_smoke.py --rglru-sweep` (H100), and the only one also built with
# 4-byte copies, for unaligned calls.  (Eight stages gained nothing there.)
TILE_VARIANTS = tuple((c, t, st) for c in (16, 32, 64) for t in (32, 64) for st in (2, 4)
                      if (c, t, st) != (64, 64, 4))
TILE = (16, 32, 4)
_BUILT = {(*v, 4) for v in TILE_VARIANTS} | {(*TILE, 1)}


class RglruPlan(NamedTuple):
    kernel: str              # "step" (S = 1) or "tile"
    c: int                   # channels a block (the tiled kernel's strip)
    t: int                   # steps a tile (1 for the one-step kernel)
    stages: int              # ring stages (0 for the one-step kernel)
    vec: int                 # floats a copy and a store: 4 (16 bytes) or 1
    smem: int                # dynamic shared memory a block (bytes)
    grid: tuple              # blocks
    threads: int             # threads a block


def _smem_bytes(c: int, t: int, stages: int) -> int:
    """csrc/rglru_scan.cu `tile_smem_bytes`: 2 * (stages + CSTAGES + OUTB)
    mbarriers, then at a 128-byte boundary the ring's log_a and b tiles, t x c
    f32 each, and the chain stages' a and b and the output tiles, c rows of
    t + 4 f32 each."""
    barriers = -(-8 * 2 * (stages + CSTAGES + OUTB) // 128) * 128
    return barriers + 4 * (2 * stages * t * c + (2 * CSTAGES + OUTB) * c * (t + 4))


def rglru_plan(bsz: int, s: int, w: int, aligned: bool = True, *,
               variant=None) -> RglruPlan:
    """The launch for (bsz, s, w).  ``aligned``: w % 4 == 0 and every
    pointer 16-byte aligned.  S = 1 takes the one-step kernel, S >= 2 the
    tiled kernel as TILE; both move 16 bytes at a time when aligned, else 4.
    ``variant`` (one of TILE_VARIANTS) forces the tiled kernel, at any S
    (``chip_smoke.py --rglru-sweep``)."""
    if bsz < 1 or s < 1 or w < 1:
        raise ValueError(f"rglru_scan: empty shape (B {bsz}, S {s}, W {w})")
    if bsz > 65535:
        raise ValueError(f"rglru_scan: {bsz} batch rows (at most 65535)")
    vec = 4 if aligned and w % 4 == 0 else 1
    if variant is None and s == 1:
        return RglruPlan("step", vec * STEP_NT, 1, 0, vec, 0,
                         (-(-bsz * w // (vec * STEP_NT)),), STEP_NT)
    c, t, st = variant or TILE
    if (c, t, st, vec) not in _BUILT:
        raise ValueError(f"rglru_scan: no tiled kernel built as {(c, t, st)} with "
                         f"{4 * vec}-byte copies")
    smem = _smem_bytes(c, t, st)
    if smem > SMEM_OPTIN:
        raise ValueError(f"rglru_scan: {smem} B of shared memory a block")
    return RglruPlan("tile", c, t, st, vec, smem, (-(-w // c), bsz), TILE_NT)


def rglru_scan_plain(log_a, b, h0):
    """log_a/b (B, S, W) f32, h0 (B, W) f32 -> (h (B, S, W), h_last (B, W)).
    Steps the recurrence in time order in f32, a multiply then an add per
    step (no fused multiply-add), as the kernels do."""
    a = torch.exp(log_a.float())
    b = b.float()
    h = h0.float()
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def _shape(log_a, b, h0) -> tuple[int, int, int]:
    """(B, S, W) of f32 log_a, b (B, S, W) and h0 (B, W) with S >= 1."""
    if not (log_a.dtype == b.dtype == h0.dtype == torch.float32):
        raise ValueError("rglru_scan: the kernels take f32 log_a, b and h0")
    if (log_a.dim() != 3 or tuple(b.shape) != tuple(log_a.shape)
            or tuple(h0.shape) != (log_a.shape[0], log_a.shape[2]) or log_a.shape[1] < 1):
        raise ValueError(f"rglru_scan: unsupported shapes log_a {tuple(log_a.shape)}"
                         f" b {tuple(b.shape)} h0 {tuple(h0.shape)}")
    return tuple(log_a.shape)


def rglru_scan(log_a, b, h0, *, variant=None):
    """The kernels on CUDA tensors (f32, contiguous): the one-step kernel
    when S == 1, else the tiled kernel, as :func:`rglru_plan` picks
    (``variant`` forces the tiled kernel's build); the plain version on CPU
    tensors."""
    if log_a.device.type == "cpu":
        return rglru_scan_plain(log_a, b, h0)
    bsz, s, w = _shape(log_a, b, h0)
    _build.require_cuda("rglru_scan", log_a, b, h0)
    h = torch.empty_like(b)
    h_last = torch.empty_like(h0)     # never a view of h: callers keep it as state
    ptrs = (log_a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
            h_last.data_ptr())
    p = rglru_plan(bsz, s, w, all(x % 16 == 0 for x in ptrs), variant=variant)
    if p.kernel == "step":
        rc = _build.lib().rglru_scan_step_f32(*ptrs, bsz * w, p.vec, _build.stream_of(log_a))
        _build.check_launch("rglru_scan (one step)", rc)
        rglru_scan.step_launches += 1
    else:
        rc = _build.lib().rglru_scan_f32(*ptrs, bsz, s, w, p.c, p.t, p.stages, p.vec,
                                         _build.stream_of(log_a))
        _build.check_launch("rglru_scan", rc)
    rglru_scan.launches += 1
    rglru_scan.launches_by_len[s] += 1
    return h, h_last


rglru_scan.launches = 0          # every call that launched a kernel
rglru_scan.step_launches = 0     # of those, the one-step kernel's
rglru_scan.launches_by_len = collections.Counter()   # launches by S
