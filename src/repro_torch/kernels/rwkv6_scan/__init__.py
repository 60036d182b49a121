"""RWKV-6 wkv recurrence (counterpart of ``repro.kernels.rwkv6_scan``), with
the TPU kernel's interface ``(r, k, v, w, u, s0) -> (y, s_last)``:

    y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_SIZE = 64               # the head size the kernel is built for


def wkv6_plain(r, k, v, w, u, s0):
    """r/k/v/w (B, S, H, Dh) f32, u (H, Dh), s0 (B, H, Dh, Dh) -> (y (B, S,
    H, Dh), s_last (B, H, Dh, Dh)).  Steps the recurrence in time order in
    f32, as the reference's ``wkv_scan_ref``; the state update is a product,
    a product and a sum per element (no fused multiply-add), as the kernel
    does."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    uk = u.float()[None] * k                   # (B, S, H, Dh)
    s = s0.float()
    y = torch.empty_like(r)
    for t in range(r.shape[1]):
        r_t, v_t = r[:, t], v[:, t]
        bonus = (r_t * uk[:, t]).sum(-1, keepdim=True)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", r_t, s) + bonus * v_t
        s = s * w[:, t, :, :, None] + k[:, t, :, :, None] * v_t[:, :, None, :]
    return y, s


def wkv6(r, k, v, w, u, s0):
    """The kernel on CUDA tensors (f32, contiguous, head size 64), the plain
    version on CPU tensors."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    _build.require_cuda("wkv6", r, k, v, w, u, s0)
    bsz, s, h, dh = r.shape
    if not all(t.dtype == torch.float32 for t in (r, k, v, w, u, s0)):
        raise ValueError("wkv6: the kernel takes f32 r, k, v, w, u and s0")
    if (dh != HEAD_SIZE or s < 1
            or any(tuple(t.shape) != (bsz, s, h, dh) for t in (k, v, w))
            or tuple(u.shape) != (h, dh) or tuple(s0.shape) != (bsz, h, dh, dh)):
        raise ValueError(f"wkv6: unsupported shapes r {tuple(r.shape)} u "
                         f"{tuple(u.shape)} s0 {tuple(s0.shape)} (head size "
                         f"{HEAD_SIZE} only)")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v, w must be 16-byte aligned")
    y = torch.empty_like(r)
    s_last = torch.empty_like(s0)
    rc = _build.lib().wkv6_f32(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_last.data_ptr(), bsz, s, h,
        _build.stream_of(r))
    _build.check_launch("wkv6", rc)
    wkv6.launches += 1
    return y, s_last


wkv6.launches = 0
