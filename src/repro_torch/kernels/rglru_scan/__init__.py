"""RG-LRU gated linear recurrence ``h_t = exp(log_a_t) * h_{t-1} + b_t``
(counterpart of ``repro.kernels.rglru_scan``), with the TPU kernel's
interface ``(log_a, b, h0) -> (h, h_last)``."""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _build


def rglru_scan_plain(log_a, b, h0):
    """log_a/b (B, S, W) f32, h0 (B, W) f32 -> (h (B, S, W), h_last (B, W)).
    Steps the recurrence in time order in f32, a multiply then an add per
    step (no fused multiply-add), as the kernel does."""
    a = torch.exp(log_a.float())
    b = b.float()
    h = h0.float()
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def rglru_scan(log_a, b, h0):
    """The kernel on a CUDA tensor (f32, contiguous), the plain version on a
    CPU tensor."""
    if log_a.device.type == "cpu":
        return rglru_scan_plain(log_a, b, h0)
    _build.require_cuda("rglru_scan", log_a, b, h0)
    bsz, s, w = log_a.shape
    if not (log_a.dtype == b.dtype == h0.dtype == torch.float32):
        raise ValueError("rglru_scan: the kernel takes f32 log_a, b and h0")
    if tuple(b.shape) != (bsz, s, w) or tuple(h0.shape) != (bsz, w) or s < 1:
        raise ValueError(f"rglru_scan: unsupported shapes log_a {tuple(log_a.shape)}"
                         f" b {tuple(b.shape)} h0 {tuple(h0.shape)}")
    h = torch.empty_like(b)
    h_last = torch.empty_like(h0)
    rc = _build.lib().rglru_scan_f32(
        log_a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
        h_last.data_ptr(), bsz, s, w, _build.stream_of(log_a))
    _build.check_launch("rglru_scan", rc)
    rglru_scan.launches += 1
    rglru_scan.launches_by_len[s] += 1
    return h, h_last


rglru_scan.launches = 0
rglru_scan.launches_by_len = collections.Counter()   # launches by S
