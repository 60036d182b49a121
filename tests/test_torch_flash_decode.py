"""The split-over-the-cache design of the port's ``flash_decode`` kernel,
held on the CPU:

* ``_split_plan`` cuts the cache into whole tiles, no more splits than
  tiles, and reaches at least two blocks per SM where the tiles allow it;
* the kernel's two passes — per-split (m, l, acc), then the combine — are
  written out here in f32 and held against the port's plain version and
  the JAX reference (``ref`` and interpret mode) within ATOL = 1e-5 (f32
  sums in another order), on a windowed ring, with whole splits masked,
  with every split but one masked, and with no slot visible at all (the
  combine then gives the mean of V over every slot, as the reference's
  finite -1e30 mask does);
* the same two passes at Dh 64 (qwen1.5-0.5b) and at the dense configs'
  query groups G = 1, 3, 8 and 12 (the kernel pads G to 4, 10 or 16 warps);
* the wrapper refuses a non-contiguous q, k, v or kpos, and a Dh other than
  64, 128 or 256, before it launches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import flash_decode_attention  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    BLOCKS_PER_SM, TILE, _split_plan, flash_decode, flash_decode_plain)

ATOL = 1e-5
SM_COUNT = 132


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("hkv", [1, 8])
@pytest.mark.parametrize("s", [1, 15, 16, 592, 2048, 4176, 8192])
def test_split_plan_tiles_the_cache(s, hkv, b):
    per, n = _split_plan(b, hkv, s, SM_COUNT)
    tiles = -(-s // TILE)
    assert per % TILE == 0 and per > 0
    assert 1 <= n <= tiles
    bounds = [(i * per, min(s, (i + 1) * per)) for i in range(n)]
    # the splits cover [0, S) in order, each non-empty, with no overlap
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
    # every split but the last is a whole number of tiles
    assert all((hi - lo) % TILE == 0 for lo, hi in bounds[:-1])
    # at least two blocks per SM wherever the tiles allow, and never more
    # than twice BLOCKS_PER_SM on the busiest SM unless the rows alone put
    # them there
    blocks = b * hkv * n
    assert blocks >= min(2 * SM_COUNT, b * hkv * tiles)
    assert n == 1 or -(-blocks // SM_COUNT) <= 2 * BLOCKS_PER_SM


def two_pass(q, k, v, kpos, q_pos, *, scale, window, split_slots):
    """The kernel's arithmetic in f32: each split's running max m, sum l and
    unnormalised acc for every query head (m = -inf, l = 0, acc = 0 where no
    slot of the split is visible), then out = sum_s e^{m_s-M} acc_s /
    max(sum_s e^{m_s-M} l_s, 1e-30), or the mean of V over all S slots of
    the KV head where every split has m = -inf."""
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    valid = (kpos >= 0) & (kpos <= q_pos)
    if window > 0:
        valid &= kpos > q_pos - window
    ms, ls, accs = [], [], []
    for lo in range(0, s, split_slots):
        hi = min(s, lo + split_slots)
        sc = torch.einsum("bkgd,btkd->bkgt", qg, k[:, lo:hi].float()) * scale
        sc = torch.where(valid[lo:hi], sc, torch.full_like(sc, -torch.inf))
        m = sc.amax(-1)                                       # (b, hkv, g)
        p = torch.where(valid[lo:hi], torch.exp(sc - m[..., None].nan_to_num(
            neginf=0.0)), torch.zeros_like(sc))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p, v[:, lo:hi].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    big = m.amax(0)
    w = torch.where(m == -torch.inf, torch.zeros_like(m),
                    torch.exp(m - big.nan_to_num(neginf=0.0)))
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0).clamp_min(1e-30)[..., None]
    mean_v = v.float().sum(1) * (1.0 / s)                     # (b, hkv, d)
    out = torch.where((big == -torch.inf)[..., None], mean_v[:, :, None], out)
    return out.reshape(b, hq, dh), m


S = 13 * TILE - 8      # 13 tiles, the last one ragged
CASES = {
    # (window, kpos builder, q_pos); slots no query sees hold V = 100
    "ring_window": (48, lambda s: s + 60 - ((60 - np.arange(s)) % s), S + 60),
    "whole_splits_masked": (0, lambda s: np.where(np.arange(s) < 300,
                                                  np.arange(s), -1), 180),
    "all_but_one_split_masked": (0, np.arange, 10),
    # q_pos below every kpos: no slot visible, the mean of V over all S
    "no_visible_slot": (0, lambda s: np.arange(s) + 50, 10),
}


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_pass_matches_plain_and_reference(case, backend):
    (window, kp_fn, q_pos), s = CASES[case], S
    rng = np.random.default_rng(5)
    b, hq, hkv, dh = 2, 6, 2, 32
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    kpos = kp_fn(s).astype(np.int32)
    seen = (kpos >= 0) & (kpos <= q_pos) & ((window <= 0) | (kpos > q_pos - window))
    if seen.any():
        v[:, ~seen] = 100.0
    # a small card so the cache is cut into 13 splits of one tile
    split_slots, n_split = _split_plan(b, hkv, s, sm_count=32)
    assert (split_slots, n_split) == (TILE, 13)
    tq, tk, tv, tkp = (torch.from_numpy(a) for a in (q, k, v, kpos))
    got, m = two_pass(tq, tk, tv, tkp, q_pos, scale=dh ** -0.5, window=window,
                      split_slots=split_slots)
    masked = int((m[:, 0, 0, 0] == -torch.inf).sum())
    if case == "ring_window":
        assert 0 < masked < n_split
    elif case == "whole_splits_masked":
        assert masked == n_split - -(-(q_pos + 1) // TILE)
    elif case == "all_but_one_split_masked":
        assert masked == n_split - 1
    else:
        assert masked == n_split
    plain = flash_decode_plain(tq, tk, tv, tkp, q_pos, scale=dh ** -0.5,
                               window=window)
    want = flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(kpos), q_pos, scale=dh ** -0.5,
                                  window=window, backend=backend, bk=24)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert float(got.abs().max()) < 10.0     # no V = 100 slot was attended


@pytest.mark.parametrize("g", [1, 3, 8, 12])
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_pass_dh64_and_dense_groups(case, g):
    (window, kp_fn, q_pos), s = CASES[case], S
    rng = np.random.default_rng(7)
    b, hkv, dh = 1, 2, 64
    q = rng.standard_normal((b, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    kpos = kp_fn(s).astype(np.int32)
    seen = (kpos >= 0) & (kpos <= q_pos) & ((window <= 0) | (kpos > q_pos - window))
    if seen.any():
        v[:, ~seen] = 100.0
    split_slots, n_split = _split_plan(b, hkv, s, sm_count=32)
    assert n_split > 1
    tq, tk, tv, tkp = (torch.from_numpy(a) for a in (q, k, v, kpos))
    got, _ = two_pass(tq, tk, tv, tkp, q_pos, scale=dh ** -0.5, window=window,
                      split_slots=split_slots)
    plain = flash_decode_plain(tq, tk, tv, tkp, q_pos, scale=dh ** -0.5,
                               window=window)
    want = flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(kpos), q_pos, scale=dh ** -0.5,
                                  window=window, backend="ref", bk=24)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert float(got.abs().max()) < 10.0


@pytest.mark.parametrize("dh,accepted", [(64, True), (96, False), (128, True),
                                         (192, False), (256, True)])
def test_wrapper_takes_dh_64_128_256(dh, accepted):
    """On the meta device a taken Dh passes the shape checks and takes the
    meta route (an empty output of q's shape and dtype, no launch); any
    other Dh is refused by name."""
    dev, bf = "meta", torch.bfloat16
    t = [torch.empty(1, 4, dh, device=dev, dtype=bf),
         torch.empty(1, 64, 2, dh, device=dev, dtype=bf),
         torch.empty(1, 64, 2, dh, device=dev, dtype=bf),
         torch.empty(64, device=dev, dtype=torch.int32)]
    before = flash_decode.launches
    if accepted:
        out = flash_decode(*t, 63, scale=0.1)
        assert (out.device.type, out.shape, out.dtype) == ("meta", t[0].shape, bf)
    else:
        with pytest.raises(ValueError, match="does not take q"):
            flash_decode(*t, 63, scale=0.1)
    assert flash_decode.launches == before


@pytest.mark.parametrize("which", ["q", "k", "v", "kpos"])
def test_wrapper_refuses_non_contiguous(which):
    """A transposed view on a non-CPU tensor is refused before any launch
    (the kernel addresses dense (B, S, Hkv, Dh) rows)."""
    dev = "meta"
    t = {"q": torch.empty(1, 4, 128, device=dev, dtype=torch.bfloat16),
         "k": torch.empty(1, 64, 2, 128, device=dev, dtype=torch.bfloat16),
         "v": torch.empty(1, 64, 2, 128, device=dev, dtype=torch.bfloat16),
         "kpos": torch.empty(64, device=dev, dtype=torch.int32)}
    x = t[which]
    t[which] = (x.transpose(-1, -2).contiguous().transpose(-1, -2) if x.dim() > 1
                else torch.empty(128, device=dev, dtype=torch.int32)[::2])
    assert not t[which].is_contiguous()
    before = flash_decode.launches
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(t["q"], t["k"], t["v"], t["kpos"], 63, scale=0.1)
    assert flash_decode.launches == before
