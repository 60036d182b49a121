"""Int8 error-feedback gradient compression for the cross-pod all-reduce
(counterpart of ``repro.training.compression``).

Multi-pod training reduces gradients over the slow "pod" dim.  Each rank
compresses to int8 with per-block scales before the collective and keeps
the quantisation residual locally (error feedback, Karimireddy et al.,
2019).  On the wire the f32 all-reduce becomes an int8 all-gather of the
blocks plus an f32 all-gather of the scales (1/BLOCK of the size) and a
local sum: about 4x fewer bytes.

Rounding is half to even in both packages (``torch.round``,
``jnp.round``), and every division is a true division, so
``compress_decompress`` is bit-equal to the reference's, and a card's
result to the CPU's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

BLOCK = 1024


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once: on CUDA a Python-number divisor becomes a
    multiply by its rounded reciprocal, which can differ in the last bit."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. x: flat f32 (padded to BLOCK)."""
    blocks = x.reshape(-1, BLOCK)
    scale = _div(blocks.abs().amax(dim=1, keepdim=True), 127.0) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)


def _padded(x: torch.Tensor, residual: Optional[torch.Tensor]):
    flat = x.float().reshape(-1)
    if residual is not None:
        flat = flat + residual.reshape(-1)
    n = flat.shape[0]
    return flat, n, F.pad(flat, (0, (-n) % BLOCK))


def compress_decompress(x: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """Local quantise -> dequantise round trip with error feedback.
    Returns (x_hat, new_residual)."""
    flat, n, padded = _padded(x, residual)
    q, s = _quantize(padded)
    xh = _dequantize(q, s)[:n]
    return xh.reshape(x.shape).to(x.dtype), (flat - xh).reshape(x.shape)


def error_feedback_psum(x: torch.Tensor, group=None,
                        residual: Optional[torch.Tensor] = None):
    """Compressed mean over ``group`` (default: the whole world): an int8
    all-gather of the blocks and an f32 all-gather of their scales, each
    rank's dequantised blocks summed in rank order, over the world size.
    Returns (mean, new_residual)."""
    flat, n, padded = _padded(x, residual)
    q, s = _quantize(padded)
    world = dist.get_world_size(group)
    q_all = torch.empty((world * q.shape[0], BLOCK), dtype=q.dtype, device=q.device)
    s_all = torch.empty((world * s.shape[0], 1), dtype=s.dtype, device=s.device)
    dist.all_gather_into_tensor(q_all, q, group=group)
    dist.all_gather_into_tensor(s_all, s, group=group)
    q_all, s_all = q_all.view(world, *q.shape), s_all.view(world, *s.shape)
    summed = q_all[0].float() * s_all[0]
    for r in range(1, world):
        summed = summed + q_all[r].float() * s_all[r]
    mean = _div(summed.reshape(-1)[:n], float(world))
    local_hat = _dequantize(q, s)[:n]
    new_residual = (flat[:n] - local_hat).reshape(x.shape)
    return mean.reshape(x.shape).to(x.dtype), new_residual
