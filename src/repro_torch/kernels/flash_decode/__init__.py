"""GQA decode attention: one query token per row over a kpos-addressed
cache (counterpart of ``repro.kernels.flash_decode``).  Slot j is visible
iff ``0 <= kpos[j] <= q_pos`` (and ``kpos[j] > q_pos - window``), so ring
buffers work exactly."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


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


def flash_decode(q, k, v, kpos, q_pos: int, *, scale: float, window: int = 0):
    """The kernel on a CUDA tensor (bf16, Dh 128, Hq/Hkv <= 8), the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kpos, q_pos, scale=scale,
                                  window=window)
    _build.require_cuda("flash_decode", q, k, v, kpos)
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("flash_decode: the kernel takes bf16 q/k/v")
    if kpos.dtype != torch.int32 or tuple(kpos.shape) != (s,):
        raise ValueError("flash_decode: kpos must be int32 of shape (S,)")
    if (dh != 128 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh
            or hq % hkv or hq // hkv > 8):
        raise ValueError(f"flash_decode: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} (Dh 128, Hq/Hkv <= 8)")
    out = torch.empty_like(q)
    rc = _build.lib().flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        out.data_ptr(), b, s, hq, hkv, int(q_pos), int(window), float(scale),
        _build.stream_of(q))
    _build.check_launch("flash_decode", rc)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
