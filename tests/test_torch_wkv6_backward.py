"""The wkv6 gradient: ``wkv6_backward_plain``, the backward CUDA kernel's
algorithm in plain torch (the state at chunk starts from a forward walk over
chunks, its gradient at chunk ends from a reverse walk, then every chunk on
its own through products of decays), against autograd of ``wkv6_plain`` and
``jax.vjp`` of the reference's ``wkv_scan_ref``; ``Wkv6Scan``'s wiring on
CPU tensors; the backward wrapper's checks and constants.

Inputs as ``tests/test_torch_wkv6.py`` draws them: r, k, v, dy ~ N(0, 1),
w = exp(-exp(N(mu, 1))) with every 997th entry 0 (mu = -6, the model's
``decay_base``, and mu = 0, strong decay), u ~ 0.1 N(0, 1), s0 and ds_last
~ N(0, 1); S = 1, 16 (one whole chunk of BWD_CHUNK = 16), 37 (a ragged
last chunk), 40 and 64; head sizes 64 and 32; chunks of 1, 3, 16, 64 and
100 steps at S = 64.

Tolerances, each ``max |got - want| <= tol * max |want|`` per gradient:
F64_TOL = 1e-12 for the plain backward in f64 against autograd of the f64
scan (the same products in other orders: measured below 1e-15); REF_TOL =
2e-6 for the f32 plain backward against ``jax.vjp`` of the reference's f32
scan (each lands up to 5.6e-7 from the f64 answer at S <= 256); F32_TOL =
1e-6 for ``Wkv6Scan`` against autograd of the f32 plain scan.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.rwkv6 import wkv_scan_ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (BWD_CHUNK, BWD_THREADS, Wkv6Scan,  # noqa: E402
                                            bwd_scratch_shapes, wkv6, wkv6_backward,
                                            wkv6_backward_plain, wkv6_plain)

F64_TOL = 1e-12
REF_TOL = 2e-6
F32_TOL = 1e-6
H, DH = 2, 64
NAMES = ("r", "k", "v", "w", "u", "s0")


def _inputs(s, mu, seed=0, b=2, dh=DH):
    """r, k, v, w, u, s0, dy, ds_last as numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, H, dh)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, H, dh)) + mu)).astype(np.float32)
    w.reshape(-1)[::997] = 0.0
    u = (0.1 * rng.standard_normal((H, dh))).astype(np.float32)
    s0 = rng.standard_normal((b, H, dh, dh)).astype(np.float32)
    dy = rng.standard_normal((b, s, H, dh)).astype(np.float32)
    ds_last = rng.standard_normal((b, H, dh, dh)).astype(np.float32)
    return r, k, v, w, u, s0, dy, ds_last


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _autograd(ins, dy, ds_last, dtype):
    """Autograd of wkv6_plain in ``dtype``: (dr, dk, dv, dw, du, ds0), an
    input no output reaches (w at S = 1 without ds_last) a zero gradient."""
    ts = [_t(a, dtype).requires_grad_(True) for a in ins]
    y, last = wkv6_plain(*ts, dtype=dtype)
    outs, grads = [y], [_t(dy, dtype)]
    if ds_last is not None:
        outs.append(last)
        grads.append(_t(ds_last, dtype))
    got = torch.autograd.grad(outs, ts, grads, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(ts, got)]


@pytest.mark.parametrize("s", [1, 16, 37, 40, 64])
@pytest.mark.parametrize("mu", [-6.0, 0.0])
@pytest.mark.parametrize("with_ds_last", [False, True])
def test_backward_plain_f64_is_autograd_of_the_scan(s, mu, with_ds_last):
    """In f64 the plain backward is autograd of the f64 scan (within
    F64_TOL) for every gradient, with zeros in w and s0 != 0; in f32 it is
    within REF_TOL of that answer."""
    r, k, v, w, u, s0, dy, ds_last = _inputs(s, mu, seed=7 * s - int(mu))
    assert (w == 0).any()
    ds = ds_last if with_ds_last else None
    want = _autograd((r, k, v, w, u, s0), dy, ds, torch.float64)
    got = wkv6_backward_plain(*(_t(a) for a in (r, k, v, w, u, s0, dy)),
                              None if ds is None else _t(ds), dtype=torch.float64)
    got32 = wkv6_backward_plain(*(_t(a) for a in (r, k, v, w, u, s0, dy)),
                                None if ds is None else _t(ds))
    for name, g, g32, wt in zip(NAMES, got, got32, want):
        assert g.dtype == torch.float64 and g32.dtype == torch.float32
        assert g.shape == wt.shape, name
        assert _rel(g, wt) <= F64_TOL, name
        assert bool(torch.isfinite(g32).all()) and _rel(g32, wt) <= REF_TOL, name


@pytest.mark.parametrize("s", [1, 16, 37, 40, 64])
@pytest.mark.parametrize("mu", [-6.0, 0.0])
def test_backward_plain_matches_the_reference_vjp(s, mu):
    """``jax.vjp`` of the reference's sequential ``wkv_scan_ref`` in f32, fed
    dy and ds_last, against the f32 plain backward: within REF_TOL."""
    r, k, v, w, u, s0, dy, ds_last = _inputs(s, mu, seed=100 + s)
    _, vjp = jax.vjp(wkv_scan_ref, *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds_last)))
    got = wkv6_backward_plain(*(_t(a) for a in (r, k, v, w, u, s0, dy, ds_last)))
    for name, g, wt in zip(NAMES, got, want):
        assert _rel(g, np.asarray(wt)) <= REF_TOL, name


@pytest.mark.parametrize("chunk", [1, 3, 16, 64, 100])
@pytest.mark.parametrize("mu", [-6.0, 0.0])
def test_backward_plain_is_autograd_of_the_scan_at_any_chunk(chunk, mu):
    """Chunks of 1 step, 3 (a ragged last chunk at S = 64), 16, 64 (one
    chunk) and 100 (one chunk longer than the call): in f64 every gradient
    within F64_TOL of autograd of the f64 scan, with zeros in w, s0 and
    ds_last drawn."""
    r, k, v, w, u, s0, dy, ds_last = _inputs(64, mu, seed=300 + chunk - int(mu))
    assert (w == 0).any()
    want = _autograd((r, k, v, w, u, s0), dy, ds_last, torch.float64)
    got = wkv6_backward_plain(*(_t(a) for a in (r, k, v, w, u, s0, dy, ds_last)),
                              dtype=torch.float64, chunk=chunk)
    for name, g, wt in zip(NAMES, got, want):
        assert _rel(g, wt) <= F64_TOL, (name, chunk)


@pytest.mark.parametrize("mu", [-6.0, 0.0])
def test_backward_plain_at_head_size_32_matches_the_reference_vjp(mu):
    """Head size 32 (the reduced rwkv6-7b's, which trains on the card) at S
    = 37: the f32 plain backward within REF_TOL of ``jax.vjp`` of the
    reference's scan."""
    r, k, v, w, u, s0, dy, ds_last = _inputs(37, mu, seed=500, dh=32)
    _, vjp = jax.vjp(wkv_scan_ref, *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds_last)))
    got = wkv6_backward_plain(*(_t(a) for a in (r, k, v, w, u, s0, dy, ds_last)))
    for name, g, wt in zip(NAMES, got, want):
        assert g.shape == tuple(wt.shape), name
        assert _rel(g, np.asarray(wt)) <= REF_TOL, name


def test_kernel_constants_and_scratch_match_the_wrapper():
    """The chunk and thread counts ``csrc/wkv6_bwd.cu`` is compiled with
    (its BC and BNT) are the wrapper's BWD_CHUNK and BWD_THREADS; the
    scratch the wrapper allocates at (1, 4096, 64, 64) is the note's: the
    state and its gradient at every chunk boundary, and du's part of every
    chunk."""
    src = (Path(rwkv6_scan.__file__).resolve().parents[2] / "csrc" / "wkv6_bwd.cu").read_text()
    consts = {name: int(val) for name, val in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["BC"], consts["BNT"]) == (BWD_CHUNK, BWD_THREADS)
    assert f"nc = ceil(S / {BWD_CHUNK})" in src
    nc = -(-4096 // BWD_CHUNK)
    assert bwd_scratch_shapes(1, 4096, 64, 64) == {"states": (2, 1, 64, nc, 64, 64),
                                                   "du_part": (1, nc, 64, 64)}


def test_backward_plain_chunks_cover_a_ragged_tail_and_all_zero_decay():
    """w = 0 everywhere over a ragged last chunk: each S_{t-1} is the
    previous outer product, so the rebuilt states need no division; ds0 is
    r_0 dy_0^T alone (no gradient reaches s0 through S_0)."""
    s = 2 * BWD_CHUNK + 5
    r, k, v, _, u, s0, dy, ds_last = _inputs(s, 0.0, seed=7)
    w = np.zeros_like(r)
    want = _autograd((r, k, v, w, u, s0), dy, ds_last, torch.float64)
    got = wkv6_backward_plain(*(_t(a) for a in (r, k, v, w, u, s0, dy, ds_last)),
                              dtype=torch.float64)
    for name, g, wt in zip(NAMES, got, want):
        assert _rel(g, wt) <= F64_TOL, name
    assert torch.equal(got[5], _t(r[:, 0], torch.float64)[..., None]
                       * _t(dy[:, 0], torch.float64)[..., None, :])


def _cpu_grads(fn, ins, keep, need):
    """Gradients of sum(out[keep] * weight) w.r.t. the inputs flagged in
    ``need`` (the rest do not require a gradient)."""
    ts = [_t(a).requires_grad_(bool(n)) for a, n in zip(ins, need)]
    outs = fn(*ts)
    g = torch.Generator().manual_seed(5)
    loss = sum((outs[i] * torch.randn(outs[i].shape, generator=g)).sum() for i in keep)
    wanted = [t for t in ts if t.requires_grad]
    got = torch.autograd.grad(loss, wanted, allow_unused=True)
    return ts, [torch.zeros_like(t) if x is None else x for t, x in zip(wanted, got)]


@pytest.mark.parametrize("keep", [(0,), (1,), (0, 1)])
def test_function_on_cpu_matches_autograd_of_the_plain_scan(keep):
    """``Wkv6Scan`` on CPU tensors with only y, only s_last or both reaching
    the loss (the unused output's gradient arrives as None): every gradient
    within F32_TOL of autograd through ``wkv6_plain``; the forward equal to
    the plain version's."""
    ins = _inputs(40, -1.0, seed=9)[:6]
    need = (True,) * 6
    _, got = _cpu_grads(lambda *t: Wkv6Scan.apply(*t), ins, keep, need)
    _, want = _cpu_grads(wkv6_plain, ins, keep, need)
    for name, g, wt in zip(NAMES, got, want):
        assert _rel(g, wt) <= F32_TOL, (name, keep)
    with torch.no_grad():
        y, last = Wkv6Scan.apply(*(_t(a) for a in ins))
        yp, lastp = wkv6_plain(*(_t(a) for a in ins))
    assert torch.equal(y, yp) and torch.equal(last, lastp)


def test_function_returns_no_gradient_where_none_is_wanted():
    """Inputs that do not require a gradient (u, s0, as in training, where
    the state starts at zero) get none; ``wkv6`` routes through the
    Function only when a gradient is wanted."""
    ins = _inputs(20, -6.0, seed=2)[:6]
    need = (True, True, True, True, False, False)
    ts, got = _cpu_grads(wkv6, ins, (0, 1), need)
    assert len(got) == 4 and all(t.grad is None for t in ts)
    _, want = _cpu_grads(wkv6_plain, ins, (0, 1), need)
    for name, g, wt in zip(NAMES, got, want):
        assert _rel(g, wt) <= F32_TOL, name
    y, _ = wkv6(*(_t(a).requires_grad_(i == 0) for i, a in enumerate(ins)))
    assert type(y.grad_fn).__name__ == "Wkv6ScanBackward"
    y, _ = wkv6(*(_t(a) for a in ins))
    assert y.grad_fn is None


def test_backward_wrapper_checks_before_launching():
    """The device branch (meta tensors take its checks, then the meta
    route: empty gradients of the inputs' shapes) refuses dy of another
    shape, f64 inputs and tensors off one device."""
    shapes = [(1, 3, 2, 64)] * 4 + [(2, 64), (1, 2, 64, 64), (1, 3, 2, 64)]
    metas = [torch.zeros(s, device="meta") for s in shapes]
    with pytest.raises(ValueError, match="unsupported shapes"):
        wkv6_backward(*metas[:6], torch.zeros(1, 4, 2, 64, device="meta"))
    with pytest.raises(ValueError, match="f32"):
        wkv6_backward(*metas[:6], metas[6].double())
    with pytest.raises(ValueError, match="CUDA device"):
        wkv6_backward(*metas[:6], torch.zeros(1, 3, 2, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        wkv6_backward(*metas, torch.zeros(1, 2, 64, 64))
    before = wkv6.backward_launches
    for ds_last in (None, torch.zeros(1, 2, 64, 64, device="meta")):
        grads = wkv6_backward(*metas, ds_last)
        assert [(g.device.type, tuple(g.shape)) for g in grads] == [
            ("meta", s) for s in shapes[:6]]
    assert wkv6.backward_launches == before
