"""The port's wkv recurrence: ``wkv6_chunked_plain``, the chunked CUDA
kernel's algorithm in plain torch, against an f64 sequential scan and the
reference's ``wkv_scan_ref``; the wrapper's dispatch and refusals.

The chunked form builds every decay factor as a product of decays (no
logarithm, no exponential).  It is held at the decays the model draws,
``w = exp(-exp(N(mu, 1)))`` with mu = -6 (the model's ``decay_base``), -1
and 0, with exact zeros planted in ``w`` (``exp(-exp(x))`` underflows to 0
for x > 4.64), at S = 1, 40 (ragged), 64 and 256.

Tolerance: ``max |got - f64| <= 1e-6 * max |f64|`` for y and s_last, the
bound ``chip_smoke.py`` holds the CUDA kernel to on the card.  The f32
sequential scan itself lands 1e-7 to 7e-7 from f64 at these sizes; the
product form as close.  Chained calls at multiples of the chunk equal one
pass by ``torch.equal``.

The reference's own chunked scan (``repro.models.rwkv6.wkv_scan_chunked``)
factors the decay as ``e^{cum_ex[t]} e^{min(-cum[j], 60)}`` and is wrong
wherever a chunk's cumulative log-decay falls below -60; a test records it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.rwkv6 import wkv_scan_chunked, wkv_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (CHUNK, CHUNKED, CHUNKED_VARIANTS,  # noqa: E402
                                            wkv6, wkv6_chunked_plain, wkv6_plain)

TOL = 1e-6
H, DH = 2, 64


def _inputs(s, mu, seed=0, b=1, zeros=True):
    """r, k, v ~ N(0, 1), w = exp(-exp(N(mu, 1))) with every 997th entry
    set to 0, u ~ 0.1 N(0, 1), s0 ~ N(0, 1); numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, H, DH)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, H, DH)) + mu)).astype(np.float32)
    if zeros:
        w.reshape(-1)[::997] = 0.0
    u = (0.1 * rng.standard_normal((H, DH))).astype(np.float32)
    s0 = rng.standard_normal((b, H, DH, DH)).astype(np.float32)
    return r, k, v, w, u, s0


def _scan64(r, k, v, w, u, s0):
    """The recurrence in numpy f64, step by step: the answer."""
    r, k, v, w, u, s = (np.asarray(a, np.float64) for a in (r, k, v, w, u, s0))
    y = np.empty_like(r)
    for t in range(r.shape[1]):
        bonus = (r[:, t] * u[None] * k[:, t]).sum(-1, keepdims=True)
        y[:, t] = np.einsum("bhk,bhkv->bhv", r[:, t], s) + bonus * v[:, t]
        s = s * w[:, t, :, :, None] + k[:, t, :, :, None] * v[:, t, :, None, :]
    return y, s


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("s", [1, 40, 64, 256])
@pytest.mark.parametrize("mu", [-6.0, -1.0, 0.0])
def test_chunked_plain_matches_f64_and_reference(mu, s):
    """The product form within 1e-6 of the f64 scan on y and s_last, never
    NaN, with zeros in w; within 1e-6 of the reference's sequential
    ``wkv_scan_ref`` (f32) as well."""
    ins = _inputs(s, mu, seed=int(10 * s - mu))
    assert (ins[3] == 0).any()
    y, last = wkv6_chunked_plain(*(_t(a) for a in ins))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(last).all())
    want_y, want_last = _scan64(*ins)
    assert _rel(y, want_y) <= TOL
    assert _rel(last, want_last) <= TOL
    ref_y, ref_last = wkv_scan_ref(*(jnp.asarray(a) for a in ins))
    assert _rel(y, np.asarray(ref_y)) <= TOL
    assert _rel(last, np.asarray(ref_last)) <= TOL


@pytest.mark.parametrize("mu", [-6.0, 0.0])
def test_wkv6_plain_f64_is_the_scan(mu):
    """``wkv6_plain(dtype=float64)``, the oracle ``chip_smoke.py`` holds the
    chunked kernel to, is the f64 scan; the f32 plain version is within
    the tolerance of it too."""
    ins = _inputs(96, mu, seed=3)
    y, last = wkv6_plain(*(_t(a) for a in ins), dtype=torch.float64)
    assert y.dtype == last.dtype == torch.float64
    want_y, want_last = _scan64(*ins)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=1e-12 * np.abs(want_y).max())
    np.testing.assert_allclose(last.numpy(), want_last, rtol=0,
                               atol=1e-12 * np.abs(want_last).max())
    y32, last32 = wkv6_plain(*(_t(a) for a in ins))
    assert _rel(y32, want_y) <= TOL and _rel(last32, want_last) <= TOL


def test_chunked_plain_all_zero_decay():
    """w = 0 at every step: S_t = k_t v_t^T, so s_last is the last outer
    product; no NaN anywhere (a logarithm of w would give one)."""
    r, k, v, _, u, s0 = _inputs(40, 0.0, seed=4)
    w = np.zeros_like(r)
    y, last = wkv6_chunked_plain(*(_t(a) for a in (r, k, v, w, u, s0)))
    assert bool(torch.isfinite(y).all())
    want_y, want_last = _scan64(r, k, v, w, u, s0)
    assert _rel(y, want_y) <= TOL and _rel(last, want_last) <= TOL
    np.testing.assert_allclose(last.numpy(), k[:, -1, :, :, None] * v[:, -1, :, None, :],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("chunk,s,cuts", [
    (16, 96, (32,)), (16, 96, (16, 64)), (16, 88, (48,)),   # 88: a ragged last chunk
    (32, 128, (64,)), (32, 72, (32,)),
])
def test_chunked_plain_chained_equals_one_pass(chunk, s, cuts):
    """One pass equals calls chained through s_last at multiples of the
    chunk, by ``torch.equal`` on y and s_last: chunks start at a call's
    first step and depend only on their own inputs and S_in."""
    assert all(c % chunk == 0 for c in cuts)
    r, k, v, w, u, s0 = (_t(a) for a in _inputs(s, -1.0, seed=5))
    y, last = wkv6_chunked_plain(r, k, v, w, u, s0, chunk=chunk)
    ys, state = [], s0
    for lo, hi in zip((0,) + cuts, cuts + (s,)):
        part, state = wkv6_chunked_plain(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                                         w[:, lo:hi], u, state, chunk=chunk)
        ys.append(part)
    assert torch.equal(last, state)
    assert torch.equal(y, torch.cat(ys, dim=1))


@pytest.mark.parametrize("mu,faulty", [(-3.0, False), (0.0, True)])
def test_reference_chunked_scan_fails_under_strong_decay(mu, faulty):
    """The reference's ``wkv_scan_chunked`` (64-step chunks, the model path
    at S >= 128 with S % 64 == 0) clips the factor e^{-cum[j]} at e^60: at
    N(0, 1) decays a chunk's cumulative log-decay falls far below -60 and
    its y is off by more than 0.5 of max |y|, while ``wkv_scan_ref`` and
    the port's product form agree with the f64 scan.  At N(-3, 1) decays
    (cumulative minimum about -8) all agree.  Nothing in the reference
    changes for it."""
    ins = _inputs(128, mu, seed=7, zeros=False)
    want_y, want_last = _scan64(*ins)
    j_ins = [jnp.asarray(a) for a in ins]
    logw = np.log(ins[3].astype(np.float64)).reshape(1, 2, 64, H, DH).sum(2)
    assert (logw.min() < -60) == faulty
    chunked_y, _ = wkv_scan_chunked(*j_ins)
    err = _rel(np.asarray(chunked_y), want_y)
    assert (err > 0.5) if faulty else (err <= 1e-5)
    ref_y, ref_last = wkv_scan_ref(*j_ins)
    port_y, port_last = wkv6_chunked_plain(*(_t(a) for a in ins))
    for y, last in ((np.asarray(ref_y), np.asarray(ref_last)), (port_y, port_last)):
        assert _rel(y, want_y) <= TOL and _rel(last, want_last) <= TOL


@pytest.mark.parametrize("s", [1, 40])
def test_wkv6_on_cpu_runs_the_plain_version(s):
    """On CPU tensors the wrapper is the sequential plain version, bit for
    bit, and counts no launch of either kernel."""
    ins = [_t(a) for a in _inputs(s, -1.0, seed=8)]
    before = (wkv6.launches, wkv6.step_launches, dict(wkv6.launches_by_len))
    y, last = wkv6(*ins)
    want_y, want_last = wkv6_plain(*ins)
    assert torch.equal(y, want_y) and torch.equal(last, want_last)
    assert (wkv6.launches, wkv6.step_launches, dict(wkv6.launches_by_len)) == before


def test_chunk_divides_the_serve_calls():
    """The default chunk divides the executor's chunk (256) and the serve's
    suffix (64), so layer-wise recompute in ``remember``'s chunks rebuilds
    the same state bit for bit; every built variant's chunk divides 64."""
    assert CHUNKED in CHUNKED_VARIANTS and CHUNK == CHUNKED[0]
    assert 256 % CHUNK == 0 and 64 % CHUNK == 0
    for c, nj, cpt in CHUNKED_VARIANTS:
        assert 64 % c == 0 and 64 % nj == 0 and cpt in (1, 2, 4)
        # 256 threads: 4..16 lanes per pair of score columns and per state
        # column; whole steps of y a lane
        g = 256 * cpt // nj
        assert 4 <= 256 // c <= 16 and 4 <= g <= 16 and (c * cpt // g) % cpt == 0


def _meta(s=4, dh=DH, dtype=torch.float32):
    m = dict(device="meta", dtype=dtype)
    return [torch.empty(1, s, H, dh, **m) for _ in range(4)] + [
        torch.empty(H, dh, **m), torch.empty(1, H, dh, dh, **m)]


def _strided_v(t):
    t[2] = t[2].transpose(-1, -2).contiguous().transpose(-1, -2)
    return t


REFUSALS = {
    # name: (inputs, keyword arguments, the message)
    "v_strided": (lambda: _strided_v(_meta()), {}, "contiguous"),
    "f64": (lambda: _meta(dtype=torch.float64), {}, "f32"),
    # head size 32 is built with one chunked variant only
    "dh_32": (lambda: _meta(dh=32), {"variant": (16, 64, 2)}, "no chunked CUDA kernel"),
    "dh_48": (lambda: _meta(dh=48), {}, "head sizes"),
    "s_0": (lambda: _meta(s=0), {}, "unsupported shapes"),
    "chunk_64": (_meta, {"variant": (64, 32, 2)}, "no chunked CUDA kernel"),
    "cols_8": (_meta, {"variant": (16, 8, 1)}, "no chunked CUDA kernel"),
    # meta is the dry run's route; meta beside a host tensor is refused
    "not_cuda": (lambda: _meta()[:5] + [torch.empty(1, H, DH, DH)], {}, "one CUDA device"),
}


@pytest.mark.parametrize("which", sorted(REFUSALS))
def test_wrapper_refuses_before_launch(which):
    """Strided, mistyped, unsupported or non-CUDA inputs on a non-CPU device
    are refused before any launch is counted."""
    build, kw, msg = REFUSALS[which]
    before = (wkv6.launches, wkv6.step_launches)
    with pytest.raises(ValueError, match=msg):
        wkv6(*build(), **kw)
    assert (wkv6.launches, wkv6.step_launches) == before
