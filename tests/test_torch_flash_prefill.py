"""The packed-GQA design of the port's ``flash_prefill`` kernel, held on the
CPU:

* ``_plan`` cuts the cache into whole tiles with no overlap, covers every
  (query row, head) pair with M tiles, splits only where the M tiles leave
  SMs idle, and then takes the cheapest split by its cost model;
* the kernel's decomposition — pairs i * G + g packed into M tiles, splits
  of the cache, each 64-slot tile classified dead, full or partial from
  kpos against the block's span of query positions, an online softmax in
  the log2 domain, the combine, and the mean of V for a row with no
  visible slot — is written out here in f32 and held against the port's
  plain version, the model path's attention (the masked softmax of
  ``attention_chunk``) and the JAX kernel ``flash_prefill_attention``
  (``ref`` and interpret mode) within ATOL = 1e-5 (f32 sums in another
  order);
* the wrapper refuses strided, mistyped and unsupported inputs before it
  launches.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import flash_prefill_attention  # noqa: E402
from repro.models.attention import _gqa_scores_naive  # noqa: E402
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    BLOCK_TILES, FILL, M_TILE, TILE, _plan, flash_prefill, flash_prefill_plain)

ATOL = 1e-5
SM_COUNT = 132


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("s", [64, 592, 2048, 4176])
@pytest.mark.parametrize("hkv", [1, 8])
@pytest.mark.parametrize("g", [1, 4, 10])
@pytest.mark.parametrize("sq", [64, 200, 256])
def test_plan_tiles_the_cache_and_fills_the_card(sq, g, hkv, s, b):
    m_tile, n, per = _plan(b, hkv, sq, g, s, SM_COUNT)
    tiles = -(-s // TILE)
    # whole pairs: M tiles of 16-pair warps cover the sq * g pairs once
    assert m_tile == M_TILE and m_tile % 16 == 0
    m_tiles = -(-sq * g // m_tile)
    assert (m_tiles - 1) * m_tile < sq * g <= m_tiles * m_tile
    # the splits cover [0, S) in order, each non-empty, with no overlap;
    # all but the last are whole tiles
    assert per % TILE == 0 and 1 <= n <= tiles
    bounds = [(i * per, min(s, (i + 1) * per)) for i in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
    # no split where the M tiles fill the card; else the least waves x
    # (tiles a split + a block's own cost), the fewest splits among equals
    unsplit = b * hkv * m_tiles
    if unsplit >= FILL * SM_COUNT:
        assert n == 1
        return

    def cost(k):
        per_k = -(-tiles // k)
        return -(-unsplit * -(-tiles // per_k) // SM_COUNT) * (per_k + BLOCK_TILES)
    assert (cost(n), n) == min((cost(k), -(-tiles // -(-tiles // k))) for k in range(1, tiles + 1))
    # a grid that fills at most half the card is split wherever it can be,
    # and then reaches half the SMs wherever the tiles allow
    if 2 * unsplit <= SM_COUNT and tiles >= 2:
        assert n >= 2
        assert unsplit * n >= min(SM_COUNT // 2, unsplit * tiles)


def test_plan_at_the_serve_shapes():
    """qwen3-8b's 256-row chunk fills the card unsplit; the hybrid's chunk
    and both 64-row suffix chunks split the cache."""
    assert _plan(1, 8, 256, 4, 4096, SM_COUNT)[1] == 1
    assert _plan(1, 1, 256, 10, 2048, SM_COUNT)[1] > 1
    assert _plan(1, 8, 64, 4, 4176, SM_COUNT)[1] > 1
    assert _plan(1, 1, 64, 10, 2048, SM_COUNT)[1] > 1


def _visible(kp, qpos, window):
    ok = (kp >= 0) & (kp <= qpos)
    if window > 0:
        ok &= kp > qpos - window
    return ok


def mirror(q, k, v, kpos, q_offset, *, scale, window, sm_count):
    """The kernel's arithmetic in f32, block by block.  Returns the output
    and counts of dead / full / partial tiles and of splits a block skipped
    whole."""
    b, sq, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    m_tile, n_split, per = _plan(b, hkv, sq, g, s, sm_count)
    sl2 = scale / math.log(2.0)
    w_uniform = float(torch.tensor(1.0 / s).to(q.dtype))
    out = torch.empty_like(q)
    stats = dict(dead=0, full=0, partial=0, dead_splits=0, n_split=n_split)
    npairs = sq * g
    for bi in range(b):
        for kh in range(hkv):
            for p0 in range(0, npairs, m_tile):
                pairs = torch.arange(p0, min(npairs, p0 + m_tile))
                rows, heads = pairs // g, kh * g + pairs % g
                qp = q[bi, rows, heads].float()                     # (P, dh)
                qpos = q_offset + rows
                q_min, q_max = int(qpos[0]), int(qpos[-1])
                parts = []
                for sp in range(n_split):
                    lo, hi = sp * per, min(s, (sp + 1) * per)
                    m = torch.full((len(pairs),), -torch.inf)
                    l = torch.zeros(len(pairs))
                    acc = torch.zeros(len(pairs), dh)
                    live = 0
                    for t0 in range(lo, hi, TILE):
                        t1 = min(hi, t0 + TILE)
                        kp = kpos[t0:t1]
                        any_ = (kp >= 0) & (kp <= q_max)
                        all_ = (kp >= 0) & (kp <= q_min)
                        if window > 0:
                            any_ &= kp > q_min - window
                            all_ &= kp > q_max - window
                        if not bool(any_.any()):
                            stats["dead"] += 1
                            continue
                        live += 1
                        full = bool(all_.all()) and t1 - t0 == TILE
                        stats["full" if full else "partial"] += 1
                        sc = qp @ k[bi, t0:t1, kh].float().T
                        if not full:
                            sc = torch.where(_visible(kp[None], qpos[:, None], window),
                                             sc, torch.full_like(sc, -torch.inf))
                        mn = torch.maximum(m, sc.amax(1) * sl2)
                        base = torch.where(mn == -torch.inf, torch.zeros_like(mn), mn)
                        c = torch.exp2(m - base)
                        p = torch.exp2(sc * sl2 - base[:, None])
                        l = l * c + p.sum(1)
                        acc = acc * c[:, None] + p.to(q.dtype).float() @ v[bi, t0:t1, kh].float()
                        m = mn
                    stats["dead_splits"] += live == 0
                    parts.append((m, l, acc))
                ms = torch.stack([x[0] for x in parts])
                big = ms.amax(0)
                if n_split == 1:
                    o = parts[0][2] / parts[0][1].clamp_min(1e-30)[:, None]
                else:
                    w = torch.where(ms == -torch.inf, torch.zeros_like(ms),
                                    torch.exp2(ms - big.nan_to_num(neginf=0.0)))
                    num = sum(w[i][:, None] * parts[i][2] for i in range(n_split))
                    den = sum(w[i] * parts[i][1] for i in range(n_split))
                    o = num / den.clamp_min(1e-30)[:, None]
                mean_v = v[bi, :, kh].float().sum(0) * w_uniform
                o = torch.where((big == -torch.inf)[:, None], mean_v[None], o)
                out[bi, rows, heads] = o.to(q.dtype)
    return out, stats


def ring_kpos(s, q_last):
    j = np.arange(s)
    return q_last - ((q_last - j) % s)


def _linear(kv_len):
    return lambda s: np.where(np.arange(s) < kv_len, np.arange(s), -1)


def _stale(s, q_last, lo, hi):
    """A ring after q_last, the slots holding positions lo..hi one turn
    older (outside every window)."""
    def fn(_s):
        kp = ring_kpos(s, q_last)
        kp[(kp >= lo) & (kp <= hi)] -= s
        return kp
    return fn


# name: (b, sq, s, q_offset, window, kpos builder, kv_len or None when the
# cache is a ring no index mask can state)
CASES = {
    "ragged": (2, 37, 300, 263, 0, _linear(300), 300),
    "whole_splits_skipped": (1, 40, 600, 100, 0, _linear(600), 600),
    "window_dead_tiles": (1, 30, 330, 300, 150, _linear(330), 330),
    "rows_before_every_key": (2, 30, 200, -5, 0, _linear(200), 200),
    "windows_past_the_cache": (1, 30, 192, 110, 16, _linear(100), 100),
    "ring_stale_slots": (1, 20, 128, 281, 64, _stale(128, 300, 250, 262), None),
    "ring_windows_all_stale": (1, 20, 128, 281, 16, _stale(128, 300, 266, 290), None),
}
MASKED_ROWS = {"rows_before_every_key", "windows_past_the_cache",
               "ring_windows_all_stale"}


def _inputs(case, g, hkv=2, dh=32):
    b, sq, s, q_off, window, kp_fn, kv_len = CASES[case]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, sq, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    kpos = kp_fn(s).astype(np.int32)
    qpos = q_off + np.arange(sq)
    seen = _visible(kpos[None], qpos[:, None], window)          # (sq, s)
    if case not in MASKED_ROWS:
        v[:, ~seen.any(0)] = 100.0    # slots no query may see
    return q, k, v, kpos, q_off, window, kv_len, seen


def _check_stats(case, stats, seen):
    if case in MASKED_ROWS:
        assert not seen.all(1).all() and (~seen.any(1)).any()
    if case == "whole_splits_skipped":
        assert stats["n_split"] > 1 and stats["dead_splits"] > 0
    if case in ("whole_splits_skipped", "window_dead_tiles"):
        assert stats["dead"] > 0 and stats["full"] > 0


@pytest.mark.parametrize("sm_count", [8, 32])
@pytest.mark.parametrize("g", [4, 10])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_matches_plain_and_model_path(case, g, sm_count):
    q, k, v, kpos, q_off, window, _, seen = _inputs(case, g)
    scale = q.shape[-1] ** -0.5
    tq, tk, tv, tkp = (torch.from_numpy(a) for a in (q, k, v, kpos))
    got, stats = mirror(tq, tk, tv, tkp, q_off, scale=scale, window=window,
                        sm_count=sm_count)
    if sm_count == 32:
        _check_stats(case, stats, seen)
    plain = flash_prefill_plain(tq, tk, tv, tkp, q_off, scale=scale, window=window)
    # the model path: attention_chunk's mask over kpos, its masked softmax
    mask = jnp.asarray(seen)
    model = _gqa_scores_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask, scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(model), rtol=0, atol=ATOL)
    # no V = 100 slot was attended by a row that sees a slot
    assert float(got[:, seen.any(1)].abs().max()) < 10.0


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("g", [4, 10])
@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][6] is not None))
def test_mirror_matches_reference_kernel(case, g, backend):
    """Against the JAX kernel with its index mask (kpos[j] = j below kv_len).
    Interpret mode skips whole key blocks past the causal edge, so a row
    with no visible slot averages V over the blocks it did not skip, not
    over all S: there it is held to ``ref`` only (ROADMAP.md, reference
    facts)."""
    q, k, v, kpos, q_off, window, kv_len, seen = _inputs(case, g)
    scale = q.shape[-1] ** -0.5
    tq, tk, tv, tkp = (torch.from_numpy(a) for a in (q, k, v, kpos))
    got, _ = mirror(tq, tk, tv, tkp, q_off, scale=scale, window=window,
                    sm_count=32)
    want = np.asarray(flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, kv_len,
        scale=scale, window=window, backend=backend, bq=16, bk=64))
    rows = seen.any(1) if backend == "interpret" else np.ones(len(seen), bool)
    np.testing.assert_allclose(got.numpy()[:, rows], want[:, rows], rtol=0, atol=ATOL)


def _meta_inputs(dh=128):
    dev, bf = "meta", torch.bfloat16
    return {"q": torch.empty(1, 16, 8, dh, device=dev, dtype=bf),
            "k": torch.empty(1, 64, 2, dh, device=dev, dtype=bf),
            "v": torch.empty(1, 64, 2, dh, device=dev, dtype=bf),
            "kpos": torch.empty(64, device=dev, dtype=torch.int32)}


def _strided(x):
    if x.dim() == 1:
        return torch.empty(2 * x.numel(), device=x.device, dtype=x.dtype)[::2]
    return x.transpose(-1, -2).contiguous().transpose(-1, -2)


REFUSALS = {
    # name: (inputs, the message)
    "q_strided": (lambda t: {**t, "q": _strided(t["q"])}, "contiguous"),
    "k_strided": (lambda t: {**t, "k": _strided(t["k"])}, "contiguous"),
    "v_strided": (lambda t: {**t, "v": _strided(t["v"])}, "contiguous"),
    "kpos_strided": (lambda t: {**t, "kpos": _strided(t["kpos"])}, "contiguous"),
    "q_f32": (lambda t: {**t, "q": t["q"].float()}, "bf16"),
    "v_f16": (lambda t: {**t, "v": t["v"].half()}, "bf16"),
    "kpos_int64": (lambda t: {**t, "kpos": t["kpos"].long()}, "int32"),
    "dh_64": (lambda t: _meta_inputs(64), "Dh 128 or 256"),
    "dh_192": (lambda t: _meta_inputs(192), "Dh 128 or 256"),
}


@pytest.mark.parametrize("which", sorted(REFUSALS))
def test_wrapper_refuses_before_launch(which):
    """Strided, mistyped or unsupported inputs on a non-CPU device are
    refused before any launch is counted."""
    build, msg = REFUSALS[which]
    t = build(_meta_inputs())
    before = flash_prefill.launches
    with pytest.raises(ValueError, match=msg):
        flash_prefill(t["q"], t["k"], t["v"], t["kpos"], 48, scale=0.1)
    assert flash_prefill.launches == before
