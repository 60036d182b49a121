"""RWKV-6 wkv recurrence (counterpart of ``repro.kernels.rwkv6_scan``), with
the TPU kernel's interface ``(r, k, v, w, u, s0) -> (y, s_last)``:

    y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Two CUDA kernels (``csrc/wkv6.cu``): a one-step kernel for decode (S = 1)
and a chunked kernel for S >= 2 that walks the sequence in chunks of
``CHUNK`` steps and builds every decay factor as a product of decays.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _build

HEAD_SIZE = 64               # the head size the kernels are built for
# The chunked kernel's variants, (steps a chunk, state columns a block,
# state columns a lane); CHUNKED is the one the wrapper launches, the
# fastest in `chip_smoke.py --wkv-sweep`.  A chunk of 64 would hold 128
# partial scores a lane and about 225 KB of shared memory.
CHUNKED_VARIANTS = ((16, 32, 2), (16, 32, 1), (16, 64, 2), (16, 16, 1), (32, 32, 2))
CHUNKED = (16, 32, 2)
CHUNK = CHUNKED[0]           # steps a chunk


def wkv6_plain(r, k, v, w, u, s0, dtype=torch.float32):
    """r/k/v/w (B, S, H, Dh), u (H, Dh), s0 (B, H, Dh, Dh) -> (y (B, S, H,
    Dh), s_last (B, H, Dh, Dh)) in ``dtype``.  Steps the recurrence in time
    order, as the reference's ``wkv_scan_ref``; the state update is a
    product, a product and a sum per element (no fused multiply-add), as
    the one-step kernel does.  ``dtype=torch.float64`` gives the answer the
    chunked kernel is held to."""
    r, k, v, w = (a.to(dtype) for a in (r, k, v, w))
    uk = u.to(dtype)[None] * k                 # (B, S, H, Dh)
    s = s0.to(dtype)
    y = torch.empty_like(r)
    for t in range(r.shape[1]):
        r_t, v_t = r[:, t], v[:, t]
        bonus = (r_t * uk[:, t]).sum(-1, keepdim=True)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", r_t, s) + bonus * v_t
        s = s * w[:, t, :, :, None] + k[:, t, :, :, None] * v_t[:, :, None, :]
    return y, s


def wkv6_chunked_plain(r, k, v, w, u, s0, chunk: int = CHUNK):
    """The chunked kernel's algorithm in plain f32 torch (tests and
    ``chip_smoke.py`` only).  Chunks of ``chunk`` steps start at the call's
    first step; within a chunk starting at c0 with state S_in, every decay
    factor is a product of decays (no logarithm, no exponential, so w = 0
    and strong decay need no special case):

        A[t]    = prod_{c0 <= m < t} w_m          A_end = A[last] w_last
        D[t, j] = prod_{j < m < t} w_m            (j < t)
        E[j]    = prod_{j < m <= last} w_m
        y_t     = (r_t A_t)^T S_in + sum_{j<t} (sum_i r_t D[t,j] k_j) v_j
                  + (r_t . (u k_t)) v_t
        S_out   = diag(A_end) S_in + sum_j (k_j E_j) v_j^T

    A ragged last chunk runs only its valid steps."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u, s = u.float(), s0.float()
    y = torch.empty_like(r)
    for c0 in range(0, r.shape[1], chunk):
        rc, kc, vc, wc = (a[:, c0:c0 + chunk] for a in (r, k, v, w))
        n = rc.shape[1]
        pre = torch.cumprod(wc, dim=1)                      # prod_{m <= t}
        a = torch.cat([torch.ones_like(pre[:, :1]), pre[:, :-1]], dim=1)
        suf = torch.cumprod(wc.flip(1), dim=1).flip(1)      # prod_{m >= j}
        e = torch.cat([suf[:, 1:], torch.ones_like(suf[:, :1])], dim=1)
        d = rc.new_zeros(rc.shape[0], n, n, *rc.shape[2:])  # (B, t, j, H, Dh)
        for t in range(1, n):
            d[:, t, :t - 1] = d[:, t - 1, :t - 1] * wc[:, t - 1, None]
            d[:, t, t - 1] = 1.0
        scores = torch.einsum("bthi,btjhi,bjhi->bhtj", rc, d, kc)
        bonus = (rc * u[None, None] * kc).sum(-1, keepdim=True)
        y[:, c0:c0 + n] = (torch.einsum("bthi,bhiv->bthv", rc * a, s)
                           + torch.einsum("bhtj,bjhv->bthv", scores, vc)
                           + bonus * vc)
        s = (pre[:, -1, :, :, None] * s
             + torch.einsum("bjhi,bjhv->bhiv", kc * e, vc))
    return y, s


def wkv6(r, k, v, w, u, s0, *, variant=CHUNKED):
    """The kernels on CUDA tensors (f32, contiguous, head size 64): the
    one-step kernel when S == 1, else the chunked kernel built as
    ``variant`` (one of ``CHUNKED_VARIANTS``); the plain version on CPU
    tensors."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    if not all(t.is_contiguous() for t in (r, k, v, w, u, s0)):
        raise ValueError("wkv6: the CUDA kernels take contiguous r, k, v, w, u "
                         "and s0")
    if not all(t.dtype == torch.float32 for t in (r, k, v, w, u, s0)):
        raise ValueError("wkv6: the CUDA kernels take f32 r, k, v, w, u and s0")
    bsz, s, h, dh = r.shape
    if (dh != HEAD_SIZE or s < 1
            or any(tuple(t.shape) != (bsz, s, h, dh) for t in (k, v, w))
            or tuple(u.shape) != (h, dh) or tuple(s0.shape) != (bsz, h, dh, dh)):
        raise ValueError(f"wkv6: the CUDA kernels take head size {HEAD_SIZE} "
                         f"only; unsupported shapes r {tuple(r.shape)} u "
                         f"{tuple(u.shape)} s0 {tuple(s0.shape)}")
    if tuple(variant) not in CHUNKED_VARIANTS:
        raise ValueError(f"wkv6: no chunked CUDA kernel variant {variant}; "
                         f"built: {CHUNKED_VARIANTS}")
    _build.require_cuda("wkv6", r, k, v, w, u, s0)
    if any(t.data_ptr() % 16 for t in (r, k, v, w, u, s0)):
        raise ValueError("wkv6: r, k, v, w, u and s0 must be 16-byte aligned")
    y = torch.empty_like(r)
    s_last = torch.empty_like(s0)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_last.data_ptr())
    if s == 1:
        rc = _build.lib().wkv6_step_f32(*ptrs, bsz, h, _build.stream_of(r))
        _build.check_launch("wkv6 (one step)", rc)
        wkv6.step_launches += 1
    else:
        rc = _build.lib().wkv6_f32(*ptrs, bsz, s, h, *variant, _build.stream_of(r))
        _build.check_launch("wkv6", rc)
    wkv6.launches += 1
    wkv6.launches_by_len[s] += 1
    return y, s_last


wkv6.launches = 0                # every call that launched a kernel
wkv6.step_launches = 0           # of those, the one-step kernel's
wkv6.launches_by_len = collections.Counter()   # launches by S
