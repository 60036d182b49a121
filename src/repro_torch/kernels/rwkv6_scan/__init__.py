"""RWKV-6 wkv recurrence (counterpart of ``repro.kernels.rwkv6_scan``), with
the TPU kernel's interface ``(r, k, v, w, u, s0) -> (y, s_last)``:

    y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Two CUDA kernels (``csrc/wkv6.cu``): a one-step kernel for decode (S = 1)
and a chunked kernel for S >= 2 that walks the sequence in chunks of
``CHUNK`` steps and builds every decay factor as a product of decays.  Each
is built for head sizes 64 (rwkv6-7b) and 32 (its reduced config).

The gradient runs through :class:`Wkv6Scan`, whose backward is a kernel of
its own (``csrc/wkv6_bwd.cu``, :func:`wkv6_backward`), chunk-parallel over
chunks of ``BWD_CHUNK`` steps.  A first launch carries the state S forward
and its gradient G back (G after the last step = ds_last) from chunk to
chunk, column block by column block, and saves them at the chunk
boundaries; per chunk, with S_in before it, G_out after it and products of
decays only (A_t, B_t: the decays before and after step t in the chunk;
A_end: all of them):

    S_out = diag(A_end) S_in  + sum_j (k_j B_j) v_j^T
    G_in  = diag(A_end) G_out + sum_t (r_t A_t) dy_t^T       (ds0 = chunk 0's)

A second launch then takes every chunk at once, each from its own rows,
S_in and G_out: the gradients of the step-by-step walk, with
beta_t = v_t . dy_t, S_{t-1} and G_t the states inside the chunk,

    dr_t = S_{t-1} dy_t + u k_t beta_t
    dk_t = G_t v_t + u r_t beta_t
    dv_t = G_t^T k_t + (r_t . (u * k_t)) dy_t
    dw_t = rowsum(G_t * S_{t-1})
    du   = sum over batch and time of r_t k_t beta_t

written through S_in dy^T, G_out v^T, v dy^T and the chunk's decay
products, never through S_{t-1} or G_t (:func:`wkv6_backward_plain` spells
them out); a last launch sums du over the chunks.

:func:`wkv6` routes through :class:`Wkv6Scan` whenever a gradient is
wanted, on the card and on the CPU alike (there the plain versions run,
:func:`wkv6_backward_plain` being the backward kernel's algorithm).

On ``meta`` tensors the forward and backward wrappers take the same checks
and return empty ``meta`` outputs of the CUDA route's shapes and dtypes,
launching nothing (the dry run's route).  On both routes a call is noted
to an active ``repro_torch.launch.op_cost`` analysis with its products
(:func:`_products`, :func:`_backward_products`).
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _build
from repro_torch.launch import op_cost

HEAD_SIZES = (32, 64)        # the head sizes the kernels are built for
# The chunked kernel's variants, (steps a chunk, state columns a block,
# state columns a lane); CHUNKED is the one the wrapper launches, the
# fastest in `chip_smoke.py --wkv-sweep`.  A chunk of 64 would hold 128
# partial scores a lane and about 225 KB of shared memory.
CHUNKED_VARIANTS = ((16, 32, 2), (16, 32, 1), (16, 64, 2), (16, 16, 1), (32, 32, 2))
CHUNKED = (16, 32, 2)
CHUNK = CHUNKED[0]           # steps a chunk
CHUNKED_32 = (16, 32, 2)     # the chunked kernel's one build at head size 32
BWD_CHUNK = 16               # csrc/wkv6_bwd.cu BC: steps a chunk of the backward
BWD_THREADS = 256            # csrc/wkv6_bwd.cu BNT: threads a block of its chunk pass


def _products(shape) -> int:
    """2 per multiply-add of the step form's state products for r (B, S, H,
    Dh): each step reads y out (S_{t-1}ᵀ r_t) and adds the rank-one update
    (k_t v_tᵀ), Dh² multiply-adds each: 4·B·S·H·Dh²."""
    bsz, s, h, dh = shape
    return 4 * bsz * s * h * dh * dh


def _backward_products(shape) -> int:
    """2 per multiply-add of the step-form backward's state products: S_t
    rebuilt (k_t v_tᵀ), G carried back (r_t dy_tᵀ), dr_t = S_{t-1} dy_t, dk_t
    = G_t v_t, dv_t = G_tᵀ k_t and dw_t = rowsum(G_t ⊙ S_{t-1}), Dh²
    multiply-adds each: 12·B·S·H·Dh²."""
    return 3 * _products(shape)


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


def _decays(wc):
    """Decay products of a chunk's w (B, n, H, Dh): A[t] = prod_{q<t} w_q,
    Bt[t] = prod_{t<q} w_q, A_end = prod_q w_q, and D (B, t, j, H, Dh) =
    prod_{j<q<t} w_q below the diagonal, 0 on and above it."""
    pre = torch.cumprod(wc, dim=1)                          # prod_{q <= t}
    a = torch.cat([torch.ones_like(pre[:, :1]), pre[:, :-1]], dim=1)
    suf = torch.cumprod(wc.flip(1), dim=1).flip(1)          # prod_{q >= t}
    bt = torch.cat([suf[:, 1:], torch.ones_like(suf[:, :1])], dim=1)
    n = wc.shape[1]
    d = wc.new_zeros(wc.shape[0], n, n, *wc.shape[2:])
    for t in range(1, n):
        d[:, t, :t - 1] = d[:, t - 1, :t - 1] * wc[:, t - 1, None]
        d[:, t, t - 1] = 1.0
    return a, bt, pre[:, -1], d


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
        a, e, a_end, d = _decays(wc)
        scores = torch.einsum("bthi,btjhi,bjhi->bhtj", rc, d, kc)
        bonus = (rc * u[None, None] * kc).sum(-1, keepdim=True)
        y[:, c0:c0 + n] = (torch.einsum("bthi,bhiv->bthv", rc * a, s)
                           + torch.einsum("bhtj,bjhv->bthv", scores, vc)
                           + bonus * vc)
        s = (a_end[..., None] * s
             + torch.einsum("bjhi,bjhv->bhiv", kc * e, vc))
    return y, s


def _check(name, r, k, v, w, u, s0, *more):
    """The kernels take contiguous f32 tensors of a head size Dh in
    HEAD_SIZES on one CUDA device, 16-byte aligned: r, k, v, w (and ``more``
    of their shape) (B, S, H, Dh), u (H, Dh), s0 (B, H, Dh, Dh).  Returns
    (B, S, H, Dh)."""
    ins = (r, k, v, w, u, s0, *more)
    _build.refuse_dtensor(name, *ins)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name}: the CUDA kernels take contiguous r, k, v, w, u "
                         "and s0")
    if not all(t.dtype == torch.float32 for t in ins):
        raise ValueError(f"{name}: the CUDA kernels take f32 r, k, v, w, u and s0")
    bsz, s, h, dh = r.shape
    if (dh not in HEAD_SIZES or s < 1
            or any(tuple(t.shape) != (bsz, s, h, dh) for t in (k, v, w, *more))
            or tuple(u.shape) != (h, dh) or tuple(s0.shape) != (bsz, h, dh, dh)):
        raise ValueError(f"{name}: the CUDA kernels take head sizes {HEAD_SIZES} "
                         f"only; unsupported shapes r {tuple(r.shape)} u "
                         f"{tuple(u.shape)} s0 {tuple(s0.shape)}")
    _build.require_cuda(name, *ins, meta=True)
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError(f"{name}: r, k, v, w, u and s0 must be 16-byte aligned")
    return bsz, s, h, dh


def _forward(r, k, v, w, u, s0, variant):
    """The forward kernels on CUDA tensors, the plain version on CPU ones,
    empty outputs on ``meta``."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    built = CHUNKED_VARIANTS if r.shape[-1] == 64 else (CHUNKED_32,)
    variant = built[0] if variant is None else tuple(variant)
    if variant not in built:
        raise ValueError(f"wkv6: no chunked CUDA kernel variant {variant} at head "
                         f"size {r.shape[-1]}; built: {built}")
    bsz, s, h, dh = _check("wkv6", r, k, v, w, u, s0)
    y = torch.empty_like(r)
    s_last = torch.empty_like(s0)
    if op_cost.ACTIVE is not None:
        op_cost.note("wkv6", _products(r.shape),
                     _build.nbytes(r, k, v, w, u, s0, y, s_last))
    if r.device.type == "meta":
        return y, s_last
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_last.data_ptr())
    if s == 1:
        rc = _build.lib().wkv6_step_f32(*ptrs, bsz, h, dh, _build.stream_of(r))
        _build.check_launch("wkv6 (one step)", rc)
        wkv6.step_launches += 1
    else:
        rc = _build.lib().wkv6_f32(*ptrs, bsz, s, h, dh, *variant, _build.stream_of(r))
        _build.check_launch("wkv6", rc)
    wkv6.launches += 1
    wkv6.launches_by_len[s] += 1
    return y, s_last


def wkv6(r, k, v, w, u, s0, *, variant=None):
    """The kernels on CUDA tensors (f32, contiguous, head size 32 or 64):
    the one-step kernel when S == 1, else the chunked kernel built as
    ``variant`` (at head size 64 one of ``CHUNKED_VARIANTS``, CHUNKED by
    default; at 32 CHUNKED_32); the plain version on CPU tensors; empty
    outputs on ``meta``.  Where a gradient is wanted, through
    :class:`Wkv6Scan`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, s0)):
        return Wkv6Scan.apply(r, k, v, w, u, s0, variant)
    return _forward(r, k, v, w, u, s0, variant)


wkv6.launches = 0                # every forward call that launched a kernel
wkv6.step_launches = 0           # of those, the one-step kernel's
wkv6.launches_by_len = collections.Counter()   # forward launches by S
wkv6.backward_launches = 0       # calls of the backward kernel (apart from those)


def wkv6_backward_plain(r, k, v, w, u, s0, dy, ds_last=None, dtype=torch.float32,
                        chunk: int = BWD_CHUNK):
    """The backward kernel's algorithm in plain torch, in ``dtype`` (tests
    and ``chip_smoke.py``; nothing on the card's path calls it), chunks of
    ``chunk`` steps from the call's first step.  The state at each chunk
    start from a forward walk over chunks, the state's gradient at each chunk
    end from a reverse walk (the module docstring's S_out and G_in), then
    every chunk on its own from those two and its rows (per row i,
    elementwise; D[t, j] = prod_{j<q<t} w_q, F[t, m] = D[m, t]):

        SdY = S_in dy_t   GV = G_out v_t   VdY[j, t] = v_j . dy_t
        dr_t = A_t SdY_t + sum_{j<t} D[t,j] k_j VdY[j,t] + u k_t beta_t
        dk_t = B_t GV_t  + sum_{m>t} F[t,m] r_m VdY[t,m] + u r_t beta_t
        dv_t = G_out^T (k_t B_t) + sum_{m>t} P[m,t] dy_m + bonus_t dy_t,
               P[m,t] = sum_i r_m[i] F[t,m,i] k_t[i]
        dw_t = A_t B_t <G_out[i], S_in[i]> + A_t sum_{m>t} F[t,m] r_m SdY_m
               + B_t sum_{j<t} D[t,j] k_j GV_j + sum_{j<t} D[t,j] k_j X[t,j],
               X[t,j] = sum_{m>t} F[t,m] r_m VdY[j,m]

    No factor divides by w.  ``ds_last`` None is a zero gradient.  Returns
    (dr, dk, dv, dw, du, ds0) in ``dtype``."""
    r, k, v, w, dy = (a.to(dtype) for a in (r, k, v, w, dy))
    u, s = u.to(dtype), s0.to(dtype)
    n = r.shape[1]
    bounds = [(c0, min(c0 + chunk, n)) for c0 in range(0, n, chunk)]
    decays = [_decays(w[:, c0:c1]) for c0, c1 in bounds]
    starts = []
    for (c0, c1), (_a, bt, a_end, _d) in zip(bounds, decays):
        starts.append(s)
        s = (a_end[..., None] * s
             + torch.einsum("bjhi,bjhx->bhix", k[:, c0:c1] * bt, v[:, c0:c1]))
    g = torch.zeros_like(s) if ds_last is None else ds_last.to(dtype)
    ends = [None] * len(bounds)
    for ci in reversed(range(len(bounds))):
        (c0, c1), (a, _bt, a_end, _d) = bounds[ci], decays[ci]
        ends[ci] = g
        g = (a_end[..., None] * g
             + torch.einsum("bthi,bthx->bhix", r[:, c0:c1] * a, dy[:, c0:c1]))
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for (c0, c1), (a, bt, _a_end, d), s_in, g_out in zip(bounds, decays, starts, ends):
        rc, kc, vc, wc, dyc = (x[:, c0:c1] for x in (r, k, v, w, dy))
        sdy = torch.einsum("bhix,bthx->bthi", s_in, dyc)       # (S_in dY^T)[i, t]
        gv = torch.einsum("bhix,bthx->bthi", g_out, vc)        # (G_out V^T)[i, t]
        vdy = torch.einsum("bjhx,bthx->bhjt", vc, dyc)         # v_j . dy_t
        beta = torch.einsum("bthx,bthx->bth", vc, dyc)[..., None]
        bonus = (rc * u * kc).sum(-1, keepdim=True)
        kd = d * kc[:, None]                                   # [t, j] = D[t, j] k_j
        rf = d.transpose(1, 2) * rc[:, None]                   # [t, m] = D[m, t] r_m
        x = torch.einsum("btmhi,bhjm->btjhi", rf, vdy)         # X[t, j]
        dr[:, c0:c1] = (a * sdy + torch.einsum("btjhi,bhjt->bthi", kd, vdy)
                        + u * kc * beta)
        dk[:, c0:c1] = (bt * gv + torch.einsum("btmhi,bhtm->bthi", rf, vdy)
                        + u * rc * beta)
        p = torch.einsum("btmhi,bthi->bhmt", rf, kc)           # P[m, t]
        dv[:, c0:c1] = (torch.einsum("bhix,bthi->bthx", g_out, kc * bt)
                        + torch.einsum("bhmt,bmhx->bthx", p, dyc) + bonus * dyc)
        gs = (g_out * s_in).sum(-1)[:, None]                   # <G_out[i], S_in[i]>
        dw[:, c0:c1] = (a * bt * gs + a * torch.einsum("btmhi,bmhi->bthi", rf, sdy)
                        + bt * torch.einsum("btjhi,bjhi->bthi", kd, gv)
                        + (kd * x).sum(2))
        du = du + (rc * kc * beta).sum((0, 1))
    return dr, dk, dv, dw, du, g


def bwd_scratch_shapes(bsz: int, s: int, h: int, dh: int) -> dict:
    """The backward kernel's scratch (f32), nc = ceil(S / BWD_CHUNK):
    ``states`` [0] the state at each chunk start (chunks 1 .. nc - 1
    written), [1] its gradient at each chunk end (chunks 0 .. nc - 2);
    ``du_part`` each chunk's part of du."""
    nc = -(-s // BWD_CHUNK)
    return {"states": (2, bsz, h, nc, dh, dh), "du_part": (bsz, nc, h, dh)}


def wkv6_backward(r, k, v, w, u, s0, dy, ds_last=None):
    """The backward kernel on CUDA tensors (as :func:`wkv6` takes them, with
    dy like r and ds_last like s0 or None for a zero gradient), the plain
    version in f32 on CPU tensors, empty outputs on ``meta``.  Returns (dr,
    dk, dv, dw, du, ds0)."""
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, v, w, u, s0, dy, ds_last)
    bsz, s, h, dh = _check("wkv6_backward", r, k, v, w, u, s0, dy)
    if ds_last is not None:
        _check("wkv6_backward", r, k, v, w, u, ds_last)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du, ds0 = torch.empty_like(u), torch.empty_like(s0)
    if op_cost.ACTIVE is not None:
        op_cost.note("wkv6_backward", _backward_products(r.shape),
                     _build.nbytes(r, k, v, w, u, s0, dy, *([] if ds_last is None else [ds_last]),
                                   dr, dk, dv, dw, du, ds0))
    if r.device.type == "meta":
        return dr, dk, dv, dw, du, ds0
    states, du_part = (torch.empty(shape, dtype=torch.float32, device=r.device)
                       for shape in bwd_scratch_shapes(bsz, s, h, dh).values())
    rc = _build.lib().wkv6_bwd_f32(
        *(t.data_ptr() for t in (r, k, v, w, u, s0, dy)),
        None if ds_last is None else ds_last.data_ptr(),
        *(t.data_ptr() for t in (dr, dk, dv, dw, du, ds0, states, du_part)),
        bsz, s, h, dh, _build.stream_of(r))
    _build.check_launch("wkv6_backward", rc)
    wkv6.backward_launches += 1
    return dr, dk, dv, dw, du, ds0


class Wkv6Scan(torch.autograd.Function):
    """``wkv6`` with gradients: the forward kernels forward, the backward
    kernel backward (the plain versions on CPU tensors).  A gradient that
    does not reach ``y`` or ``s_last`` arrives as None (zero)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, variant=None):
        ctx.set_materialize_grads(False)
        y, s_last = _forward(r, k, v, w, u, s0, variant)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return y, s_last

    @staticmethod
    def backward(ctx, dy, ds_last):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        ds_last = None if ds_last is None else ds_last.contiguous()
        grads = wkv6_backward(r, k, v, w, u, s0, dy, ds_last)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None)
