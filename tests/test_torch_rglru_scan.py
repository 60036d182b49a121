"""The port's RG-LRU scan: ``rglru_plan`` (which kernel, strips, time tiles,
shared memory), a plain-torch walk of the tiled CUDA kernel's strips and
tiles held to ``rglru_scan_plain`` by ``torch.equal``, chained calls against
one pass, the reference (``rglru_scan_ref`` and the interpret-mode Pallas
kernel), and the wrapper's refusals.

Both CUDA kernels step ``h_t = exp(log_a_t) * h_{t-1} + b_t`` in time order
with the plain version's arithmetic (an exponential, a multiply, then an
add), so the walk is held to equality, as ``chip_smoke.py`` holds the
kernels on the card.  Against the reference's associative scan the port is
held to ``ATOL``, the bound ``tests/test_torch_hybrid.py`` holds it to.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan import ops as j_rglru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import (CSTAGES, OUTB, SMEM_OPTIN, STEP_NT,  # noqa: E402
                                            TILE, TILE_VARIANTS, rglru_plan, rglru_scan,
                                            rglru_scan_plain)

ATOL = 1e-5
WIDTHS = (1, 96, 128, 2558, 2560)
LENGTHS = (1, 2, 40, 64, 256, 300)


def _inputs(b, s, w, seed=0):
    """log_a in [-0.5, 0) as the gates give, b and h0 ~ N(0, 1); numpy f32."""
    rng = np.random.default_rng(seed)
    log_a = (-0.5 * rng.random((b, s, w))).astype(np.float32)
    bt = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return log_a, bt, h0


def _t(a):
    return torch.from_numpy(np.array(a))


def _layout_bytes(c, t, stages):
    """The tiled kernel's dynamic shared memory, from its layout: a full and
    an empty mbarrier (8 bytes each) for every ring stage, chain stage and
    output tile, padded to 128 bytes; then the ring's log_a and b tiles, t
    rows of c f32; then the chain stages' a and b and the output tiles,
    transposed: c rows of t + 4 f32 (the 4 spreads the banks)."""
    barriers = 8 * 2 * (stages + CSTAGES + OUTB)
    ring = 2 * stages * t * c
    transposed = (2 * CSTAGES + OUTB) * c * (t + 4)
    return (barriers + 127) // 128 * 128 + 4 * (ring + transposed)


def _tiled_walk(log_a, b, h0, plan):
    """The tiled kernel's work in plain torch: block (x, y) owns channels
    [x C, min(x C + C, W)) of batch row y and walks time in tiles of T
    steps, taking the exponential of a tile before running the chain over
    it, a multiply then an add a step."""
    bsz, s, w = log_a.shape
    h = torch.empty_like(b)
    h_last = torch.empty_like(h0)
    gx, gy = plan.grid
    for y in range(gy):
        for x in range(gx):
            lo, hi = x * plan.c, min(x * plan.c + plan.c, w)
            hv = h0[y, lo:hi].clone()
            for t0 in range(0, s, plan.t):
                t1 = min(t0 + plan.t, s)
                a = torch.exp(log_a[y, t0:t1, lo:hi])
                for t in range(t1 - t0):
                    hv = a[t] * hv + b[y, t0 + t, lo:hi]
                    h[y, t0 + t, lo:hi] = hv
            h_last[y, lo:hi] = hv
    return h, h_last


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("bsz", [1, 2])
def test_plan_covers_every_element_once(bsz, w, s):
    """S = 1 takes the one-step kernel, whose units cover the B * W
    elements once; S >= 2 the tiled kernel, whose (strip, batch row, time
    tile) cells cover (B, S, W) once.  A width that is not a multiple of 4
    takes 4-byte copies, any other 16-byte ones; shared memory is the
    mirrored layout and within what a block may opt into."""
    plan = rglru_plan(bsz, s, w, aligned=w % 4 == 0)
    assert plan.vec == (4 if w % 4 == 0 else 1)
    if s == 1:
        assert plan.kernel == "step" and plan.threads == STEP_NT and plan.smem == 0
        n = bsz * w
        assert n % plan.vec == 0
        hits = np.zeros(n, np.int64)
        for i in range(plan.grid[0] * plan.threads):
            hits[i * plan.vec:min(i * plan.vec + plan.vec, n)] += 1
        assert (hits == 1).all()
        return
    assert plan.kernel == "tile" and (plan.c, plan.t, plan.stages) == TILE
    assert plan.smem == _layout_bytes(plan.c, plan.t, plan.stages) <= SMEM_OPTIN
    gx, gy = plan.grid
    assert gy == bsz and (gx - 1) * plan.c < w <= gx * plan.c
    hits = np.zeros((bsz, s, w), np.int64)
    for y in range(gy):
        for x in range(gx):
            for t0 in range(0, s, plan.t):
                hits[y, t0:t0 + plan.t, x * plan.c:x * plan.c + plan.c] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("variant", TILE_VARIANTS)
def test_every_variant_fits_and_is_forced(variant):
    """Each built variant of the tiled kernel fits a block's shared memory,
    and forcing one takes the tiled kernel even at S = 1; unaligned inputs
    exist only for TILE."""
    for s in (1, 256):
        plan = rglru_plan(1, s, 2560, variant=variant)
        assert plan.kernel == "tile" and (plan.c, plan.t, plan.stages) == variant
        assert plan.smem == _layout_bytes(*variant) <= SMEM_OPTIN
    if variant == TILE:
        assert rglru_plan(1, 64, 2560, aligned=False, variant=variant).vec == 1
    else:
        with pytest.raises(ValueError, match="no tiled kernel"):
            rglru_plan(1, 64, 2560, aligned=False, variant=variant)


@pytest.mark.parametrize("args", [(1, 0, 2560), (0, 4, 2560), (1, 4, 0), (65536, 4, 8)])
def test_plan_refuses_empty_or_oversized(args):
    with pytest.raises(ValueError, match="rglru_scan"):
        rglru_plan(*args)


@pytest.mark.parametrize("bsz,s,w", [(1, 300, 2558), (2, 40, 96), (2, 64, 128),
                                     (1, 2, 1), (2, 256, 2560)])
def test_tiled_walk_equals_plain(bsz, s, w):
    """The tiled kernel's order of work (an exponential of each tile, then
    the chain) gives the plain version's h and h_last bit for bit, ragged
    last tile and strip included."""
    log_a, bt, h0 = (_t(a) for a in _inputs(bsz, s, w, seed=s + w))
    plan = rglru_plan(bsz, s, w, aligned=w % 4 == 0)
    if s == 1:
        plan = rglru_plan(bsz, s, w, variant=TILE)
    h, h_last = _tiled_walk(log_a, bt, h0, plan)
    want_h, want_last = rglru_scan_plain(log_a, bt, h0)
    assert torch.equal(h, want_h) and torch.equal(h_last, want_last)


@pytest.mark.parametrize("bsz,w,bw", [(1, 128, 128), (2, 96, 64)])
def test_chained_calls_equal_one_pass_and_reference(bsz, w, bw):
    """256 + 256 chained calls of the wrapper equal one 512-step call by
    ``torch.equal``; both are within ATOL of the reference's
    ``rglru_scan_ref`` and of its interpret-mode kernel (time blocks of 256,
    channel blocks of ``bw``)."""
    log_a, bt, h0 = _inputs(bsz, 512, w, seed=9)
    la, b_, h0_ = _t(log_a), _t(bt), _t(h0)
    h, h_last = rglru_scan(la, b_, h0_)
    h1, mid = rglru_scan(la[:, :256].contiguous(), b_[:, :256].contiguous(), h0_)
    h2, last2 = rglru_scan(la[:, 256:].contiguous(), b_[:, 256:].contiguous(), mid)
    assert torch.equal(h, torch.cat([h1, h2], dim=1)) and torch.equal(h_last, last2)
    j_in = [jnp.asarray(a) for a in (log_a, bt, h0)]
    for backend in ("ref", "interpret"):
        want_h, want_last = j_rglru_ops.rglru_scan(*j_in, backend=backend, bs=256, bw=bw)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=0, atol=ATOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last), rtol=0, atol=ATOL)


@pytest.mark.parametrize("s", [1, 40])
def test_wrapper_on_cpu_runs_the_plain_version(s):
    """On CPU tensors the wrapper is the plain version, bit for bit, counts
    no launch of either kernel, and returns h_last as a tensor of its own."""
    ins = [_t(a) for a in _inputs(2, s, 96, seed=3)]
    before = (rglru_scan.launches, rglru_scan.step_launches,
              dict(rglru_scan.launches_by_len))
    h, h_last = rglru_scan(*ins)
    want_h, want_last = rglru_scan_plain(*ins)
    assert torch.equal(h, want_h) and torch.equal(h_last, want_last)
    assert h_last.untyped_storage().data_ptr() != h.untyped_storage().data_ptr()
    assert (rglru_scan.launches, rglru_scan.step_launches,
            dict(rglru_scan.launches_by_len)) == before


def _meta(b=1, s=4, w=32, dtype=torch.float32, h0_w=None):
    m = dict(device="meta", dtype=dtype)
    return [torch.empty(b, s, w, **m), torch.empty(b, s, w, **m),
            torch.empty(b, w if h0_w is None else h0_w, **m)]


REFUSALS = {
    # name: (inputs, the message)
    "f64": (lambda: _meta(dtype=torch.float64), "f32"),
    "bf16": (lambda: _meta(dtype=torch.bfloat16), "f32"),
    "s_0": (lambda: _meta(s=0), "shapes"),
    "h0_width": (lambda: _meta(h0_w=16), "shapes"),
    "b_shape": (lambda: [_meta()[0], torch.empty(1, 5, 32, device="meta"),
                         _meta()[2]], "shapes"),
    "log_a_2d": (lambda: [torch.empty(4, 32, device="meta"), torch.empty(4, 32, device="meta"),
                          torch.empty(4, device="meta")], "shapes"),
    # meta is the dry run's route; meta beside a host tensor is refused
    "not_cuda": (lambda: [*_meta()[:2], torch.empty(1, 32)], "CUDA"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrapper_refusals(name):
    """Off the CPU the wrapper takes f32 (B, S, W) log_a and b with S >= 1
    and h0 (B, W), on one CUDA device (or all on meta); it raises before
    any launch."""
    make, msg = REFUSALS[name]
    before = (rglru_scan.launches, rglru_scan.step_launches)
    with pytest.raises(ValueError, match=msg):
        rglru_scan(*make())
    assert (rglru_scan.launches, rglru_scan.step_launches) == before
