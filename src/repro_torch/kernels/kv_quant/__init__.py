"""Per-channel int8 KV quantizer (counterpart of ``repro.kernels.kv_quant``).

Channel = the LAST axis; each channel's scale is the absmax over every other
axis, ``max(absmax, 1e-12) / 127``, and ``q = clip(round_half_even(x / s),
-127, 127)`` by a true divide.  Dequantize is one f32 multiply and one cast.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


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


def kv_quantize(x):
    """The two-pass kernel (absmax, quantize) on a CUDA tensor (bf16 or
    f32), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return kv_quantize_plain(x)
    _build.require_cuda("kv_quantize", x)
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"kv_quantize: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    r = x.numel() // c
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(c, dtype=torch.float32, device=x.device)
    amax = torch.empty(c, dtype=torch.int32, device=x.device)   # u32 bits
    rc = _build.lib().kv_quantize(
        x.data_ptr(), amax.data_ptr(), q.data_ptr(), scales.data_ptr(), r, c,
        _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
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
