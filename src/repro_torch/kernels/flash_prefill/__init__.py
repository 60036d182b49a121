"""Causal GQA flash attention of a query chunk over a kpos-addressed cache.

Counterpart of ``repro.kernels.flash_prefill`` with the model's masking:
query i sits at ``q_offset + i``; key slot j is visible iff
``0 <= kpos[j] <= q_offset + i`` (and ``kpos[j] > q_offset + i - window``).
The reference kernel's ``kv_len`` mask is the case ``kpos[j] = j`` for
``j < kv_len``, else -1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (128, 256)       # head dims the kernel is built for


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
    """The kernel on a CUDA tensor (bf16, Dh 128 or 256, Hq a multiple of
    Hkv), the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, kpos, q_offset, scale=scale,
                                   window=window)
    _build.require_cuda("flash_prefill", q, k, v, kpos)
    b, sq, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("flash_prefill: the kernel takes bf16 q/k/v")
    if kpos.dtype != torch.int32 or tuple(kpos.shape) != (s,):
        raise ValueError("flash_prefill: kpos must be int32 of shape (S,)")
    if (dh not in HEAD_DIMS or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != dh or hq % hkv):
        raise ValueError(f"flash_prefill: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} (Dh 128 or 256, Hq a multiple "
                         f"of Hkv)")
    out = torch.empty_like(q)
    rc = _build.lib().flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        out.data_ptr(), b, sq, s, hq, hkv, dh, int(q_offset), int(window),
        float(scale), _build.stream_of(q))
    _build.check_launch("flash_prefill", rc)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
