"""The one-launch cluster quantizer (``csrc/kv_quant.cu``) emulated on the
CPU, and the int8 store's tail-chunk demotion.

The kernel cannot run here, so its decomposition is emulated in f32 torch
from the wrapper's own plan (``quant_plan``): rows split into N rank slabs,
each rank's per-channel |x| maxima (an empty rank gives 0), the max over
ranks, one IEEE divide a channel for the scale and its reciprocal, then
y = x * inv rounded half to even by adding 1.5 * 2^23 and reading the low
byte of the sum's bits, with a unit of channels redone by the true divide
when any y lies within 2^-14 of a half-integer.  The emulation must equal
``kv_quantize_plain`` by ``torch.equal`` and the JAX reference (``ref``)
byte for byte; against the reference's interpret-mode Pallas kernel it is
held within one ulp of a scale, the quirk ROADMAP.md records.  Inputs come
from numpy seeds.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kv_quant import kv_quantize as j_quant  # noqa: E402
from repro.storage import ChunkStore as JChunkStore  # noqa: E402
import repro_torch.storage.chunkstore as chunkstore  # noqa: E402
from repro_torch.kernels import kv_quant  # noqa: E402
from repro_torch.kernels.kv_quant import (MAX_BLOCKS, MAX_CLUSTER, NT, SMEM_OPTIN,  # noqa: E402
                                          STAGES, kv_dequantize, kv_dequantize_plain,
                                          kv_quantize, kv_quantize_plain, quant_plan)
from repro_torch.storage import ChunkStore  # noqa: E402

BF16 = ml_dtypes.bfloat16
MAGIC = 12582912.0           # 1.5 * 2^23
NEAR_TIE = 0.5 - 2.0 ** -14


def _t(a) -> "torch.Tensor":
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: "torch.Tensor") -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _bytes_eq(got, want):
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def emulate(x: "torch.Tensor", n=None, slab=None):
    """The cluster kernel's arithmetic on the plan the wrapper would launch:
    (q int8 of x's shape, scales f32 (C,), the plan)."""
    c = x.shape[-1]
    r = x.numel() // c
    p = quant_plan(r, c, x.element_size(), n=n, slab=slab)
    x2 = x.reshape(r, c).float()
    parts = []
    for rank in range(p.n):
        rows = x2[rank * p.rows_per:(rank + 1) * p.rows_per]
        parts.append(rows.abs().amax(0) if len(rows) else torch.zeros(c))
    amax = torch.stack(parts).amax(0)
    scales = amax.clamp(min=1e-12) / torch.full_like(amax, 127.0)
    inv = torch.ones_like(scales) / scales
    y = x2 * inv                                # |y| <= 127 (1 + 2^-23): no clip
    t = y + torch.tensor(MAGIC, dtype=torch.float32)
    near = ~((y - (t - torch.tensor(MAGIC, dtype=torch.float32))).abs() <= NEAR_TIE)
    fast = (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)
    slow = torch.clamp(torch.round(x2 / scales), -127, 127).to(torch.int8)
    unit_near = near.reshape(r, c // p.vec, p.vec).any(-1, keepdim=True)
    unit_near = unit_near.expand(r, c // p.vec, p.vec).reshape(r, c)
    q = torch.where(unit_near, slow, fast)
    return q.reshape(x.shape), scales, p


def _kv(rng, shape, dtype, scale=2.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(dtype)


def _case(name):
    """(x, forced cluster size or None) for each named case."""
    rng = np.random.default_rng(sum(name.encode()))
    if name.startswith("n"):                    # N = 1, 4, 8, 16 forced
        return _kv(rng, (4, 1, 16, 2, 128), BF16), int(name[1:])
    if name == "ragged_last_slab":              # R 45 over 8 ranks: 6 a rank, the last 3
        return _kv(rng, (3, 1, 15, 1, 128), BF16), 8
    if name == "r_below_n":                     # R 5 over 16 ranks: 11 empty
        return _kv(rng, (5, 128), BF16), 16
    if name == "tail_chunk":
        return _kv(rng, (4, 1, 10, 2, 128), BF16), None
    if name == "zero_channel":                  # the 1e-12 clamp
        x = _kv(rng, (4, 1, 16, 2, 128), BF16)
        x[..., 5] = 0
        return x, None
    if name == "ties":                          # scale 1: x / s = x exactly
        x = rng.integers(-126, 127, (64, 128)).astype(np.float32)
        x += np.where(rng.random((64, 128)) < 0.5, 0.5, 0.0).astype(np.float32)
        x = np.clip(x, -126.5, 126.5)
        x[0] = 127.0
        return x.astype(BF16), None
    if name == "f32":
        return _kv(rng, (4, 1, 16, 2, 128), np.float32), None
    if name == "absmax_last_row_last_rank":     # R 64 over 8: row 63 on rank 7
        x = _kv(rng, (64, 128), BF16, scale=1.0)
        x[-1, ::3] = 40.0
        return x, None
    if name == "reread_f32":                    # 295 KB a rank at N 16: re-read
        return _kv(rng, (36, 1, 32, 8, 128), np.float32), None
    if name == "scalar_c12":                    # 24-byte rows: one element at a time
        return _kv(rng, (7, 3, 12), BF16), None
    raise KeyError(name)


CASES = ["n1", "n4", "n8", "n16", "ragged_last_slab", "r_below_n", "tail_chunk",
         "zero_channel", "ties", "f32", "absmax_last_row_last_rank", "reread_f32",
         "scalar_c12"]


@pytest.mark.parametrize("name", CASES)
def test_emulation_equals_plain_and_reference(name):
    x, n = _case(name)
    xt = _t(x)
    q, s, p = emulate(xt, n=n)
    qp, sp = kv_quantize_plain(xt)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    qj, sj = j_quant(jnp.asarray(x), backend="ref")
    _bytes_eq(q, qj)
    _bytes_eq(s, sj)
    assert kv_quantize(xt)[0].equal(qp)          # the CPU wrapper is the plain version
    if name == "reread_f32":
        assert not p.slab and p.n == MAX_CLUSTER
    if name == "scalar_c12":
        assert p.vec == 1 and not p.slab
    if name == "r_below_n":
        assert p.rows_per == 1 and p.n * p.rows_per > x.shape[0]
    if name == "ties":
        assert float(s[0]) == 1.0
        half = (np.abs(x.astype(np.float32)) % 1) == 0.5
        assert half.sum() > 100                  # ties go to even
        xf = torch.from_numpy(x.astype(np.float32))
        assert torch.equal(q.float()[torch.from_numpy(half)],
                           torch.round(xf)[torch.from_numpy(half)])
    if name == "zero_channel":
        assert float(s[5]) == np.float32(1e-12) / np.float32(127) and not q[..., 5].any()


@pytest.mark.parametrize("name", ["n8", "ragged_last_slab", "r_below_n", "tail_chunk",
                                  "zero_channel", "ties", "f32",
                                  "absmax_last_row_last_rank", "scalar_c12"])
def test_emulation_against_interpret_kernel(name):
    """The reference's Pallas kernel in interpret mode: scales within one
    ulp, codes within one step where a scale differs and equal elsewhere."""
    x, n = _case(name)
    q, s, _ = emulate(_t(x), n=n)
    qj, sj = j_quant(jnp.asarray(x), backend="interpret")
    sj = np.asarray(sj)
    ulps = np.abs(s.numpy().view(np.int32).astype(np.int64)
                  - sj.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert dq.max() <= 1
    assert not dq[..., ulps == 0].any()


PLAN_SHAPES = [(r, c, esz, aligned)
               for r in (1, 5, 15, 16, 17, 576, 4608, 4609, 9216, 18432, 73728)
               for c in (12, 64, 128, 256, 1000)
               for esz in (2, 4)
               for aligned in (True, False)]


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_properties(esz, aligned):
    for r, c, e, a in PLAN_SHAPES:
        if (e, a) != (esz, aligned):
            continue
        p = quant_plan(r, c, esz, aligned)
        assert 1 <= p.n <= MAX_CLUSTER
        covered = np.zeros(r, np.int64)
        for rank in range(p.n):
            covered[rank * p.rows_per:(rank + 1) * p.rows_per] += 1
        assert (covered == 1).all() and p.n * p.rows_per >= r
        assert p.smem <= SMEM_OPTIN
        assert p.smem == kv_quant._smem_bytes(c, p.rows_per * c * esz if p.slab else 0)
        units = (c * esz) % 16 == 0 and aligned
        assert p.vec == (16 // esz if units else 1)
        slab_bytes = kv_quant._smem_bytes(c, -(-r // p.n) * c * esz)
        assert p.slab == (units and slab_bytes <= SMEM_OPTIN)
        # 8 ranks unless their slabs would not fit; re-read at the widest
        fits8 = kv_quant._smem_bytes(c, -(-r // 8) * c * esz) <= SMEM_OPTIN
        assert p.n == (8 if units and fits8 else MAX_CLUSTER)
        assert 1 <= p.clusters and p.n * p.clusters <= MAX_BLOCKS
        _kernel_rows_cover(r, c, p)


def _kernel_rows_cover(r, c, p):
    """The kernel's own split (csrc/kv_quant.cu): a rank's stages, and each
    cluster's share of the rank's rows, are whole groups of rl_n rows; the
    stages hold every row once in at most STAGES copies, and the clusters'
    shares quantize every row once."""
    rl_n = NT // min(c // p.vec, NT)

    def groups(a, b):
        return -(-(-(-a // b)) // rl_n) * rl_n
    for rank in range(p.n):
        rows = max(0, min(p.rows_per, r - rank * p.rows_per))
        stage_rows = max(rl_n, groups(rows, STAGES))
        assert -(-rows // stage_rows) <= STAGES
        share = groups(rows, p.clusters)
        seen = np.zeros(rows, np.int64)
        for k in range(p.clusters):
            lo = min(rows, k * share)
            seen[lo:min(rows, lo + share)] += 1
        assert (seen == 1).all()


def test_plan_at_the_serve_shape_and_forced():
    """One 16-token chunk of qwen3-8b's 36 layers: 8 ranks of 576 rows, the
    slab in shared memory; 32 tokens need 16 ranks; f32 at 32 tokens does
    not fit and re-reads.  Forcing a slab that cannot fit raises."""
    p = quant_plan(36 * 16 * 8, 128, 2)
    assert (p.n, p.rows_per, p.slab, p.vec) == (8, 576, True, 8)
    assert p.smem == 1664 + 576 * 256
    for esz, slab in ((2, True), (4, False)):
        p = quant_plan(36 * 32 * 8, 128, esz)
        assert (p.n, p.rows_per, p.slab) == (16, 576, slab)
    for n, slab in ((4, False), (8, True), (8, False), (16, True), (16, False)):
        for k in (1, 2, 4, 8):
            p = quant_plan(4608, 128, 2, n=n, slab=slab, clusters=k)
            assert (p.n, p.slab, p.clusters) == (n, slab, k)
            _kernel_rows_cover(4608, 128, p)
    with pytest.raises(ValueError):
        quant_plan(4608, 128, 2, n=4, slab=True)      # 295 KB a block
    with pytest.raises(ValueError):
        quant_plan(4608, 12, 2, slab=True)            # no 16-byte units
    with pytest.raises(ValueError):
        quant_plan(16, 128, 2, n=17)


def test_wrapper_refuses_a_tensor_off_the_card():
    """Off the CPU the wrapper launches the kernel or raises: a meta tensor
    raises before any launch is counted."""
    before = kv_quantize.launches
    with pytest.raises(ValueError):
        kv_quantize(torch.empty(16, 128, device="meta"))
    assert kv_quantize.launches == before


def test_hbm_tail_chunk_demotion_is_contiguous_and_matches_reference(monkeypatch):
    """An int8 store on the HBM tier demotes a 40-token request's tail chunk
    (tokens 32-40 of a 16-token block): the quantizer receives contiguous
    tensors only, and the host encoding equals the JAX store's byte for
    byte."""
    rng = np.random.default_rng(7)
    n = 40
    k, v = (_kv(rng, (2, 1, n, 2, 32), BF16) for _ in range(2))
    kpos = np.broadcast_to(np.arange(n, dtype=np.int32), (2, n)).copy()
    toks = rng.integers(0, 512, (1, n)).astype(np.int32)
    js = JChunkStore(chunk_size=16, quant="int8", default_tier="hbm")
    ts = ChunkStore(chunk_size=16, quant="int8", default_tier="hbm", device="cpu")
    js.put_request("r", jnp.asarray(toks), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                           "kpos": jnp.asarray(kpos)})
    ts.put_request("r", _t(toks), {"k": _t(k), "v": _t(v), "kpos": _t(kpos)})
    seen = []

    def recorder(x):
        seen.append(x.is_contiguous())
        return kv_quantize(x)
    monkeypatch.setattr(chunkstore, "kv_quantize", recorder)
    key = ts.requests["r"][-1]
    assert key == js.requests["r"][-1] and ts.chunks[key].tokens == (32, 40)
    assert not ts.device_view(key)["k"].is_contiguous()     # what the store holds
    js._move(key, "hbm", "host")
    ts._move(key, "hbm", "host")
    assert seen == [True, True]
    want, got = js.chunks[key].reprs["host"], ts.chunks[key].reprs["host"]
    _bytes_eq(got["kpos"], want["kpos"])
    for f in ("k", "v"):
        _bytes_eq(got[f]["q"], want[f]["q"])
        _bytes_eq(got[f]["scales"], want[f]["scales"])
    assert ts.max_scale == js.max_scale


@pytest.mark.parametrize("tail", [16, 10])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_run_dequant_equals_per_chunk_calls(dtype, tail):
    """One run-form kv_dequantize over a transfer run's columns of a staging
    buffer (5 chunks of 16 tokens, the last full or 10 tokens: a strided
    view) with per-chunk scales returns each field's chunks, each equal to
    a kv_dequantize_plain call on that chunk's codes and its row of scales,
    bit for bit, also in the (A, 1, n, H, Dh) shape the datapath hands the
    pool."""
    rng = np.random.default_rng(21 + tail)
    a, c, cs, chunks_n = 6, 256, 16, 5
    t = (chunks_n - 1) * cs + tail
    buf = [_t(rng.integers(-127, 128, (a, chunks_n * cs, c)).astype(np.int8)) for _ in range(2)]
    scales = [_t((rng.random((chunks_n, c)) * 0.05).astype(np.float32)) for _ in range(2)]
    q = [x[:, :t] for x in buf]
    assert q[0].is_contiguous() == (tail == cs)
    calls = kv_dequantize.launches
    got = kv_dequantize(q, scales, dtype, chunk_size=cs)
    assert kv_dequantize.launches == calls            # CPU tensors: the plain version
    for chunks, x, s in zip(got, q, scales):
        assert len(chunks) == chunks_n
        for ch, g in enumerate(chunks):
            part = slice(ch * cs, min(t, (ch + 1) * cs))
            want = kv_dequantize_plain(x[:, part].contiguous(), s[ch], dtype)
            assert g.shape == (a, part.stop - part.start, c) and g.dtype == dtype
            assert torch.equal(g, want)
            assert torch.equal(g.reshape(a, 1, -1, 2, c // 2), want.reshape(a, 1, -1, 2, c // 2))


def test_dequantize_refuses_off_card_and_wrong_scales():
    """Off the CPU the wrapper launches the kernel or raises: meta tensors
    raise before a launch is counted, in both forms; scales of the wrong
    shape raise in both forms on any device."""
    before = (kv_dequantize.launches, kv_dequantize.run_launches)
    q = torch.zeros(4, 16, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        kv_dequantize(q.to("meta"), torch.ones(128, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kv_dequantize([q.to("meta")], [torch.ones(1, 128, device="meta")], chunk_size=16)
    with pytest.raises(ValueError, match="scales"):
        kv_dequantize(q, torch.ones(129))
    with pytest.raises(ValueError, match="scales"):
        kv_dequantize([q], [torch.ones(2, 128)], chunk_size=16)
    with pytest.raises(ValueError):
        kv_dequantize(q, torch.ones(128), torch.float16)
    assert (kv_dequantize.launches, kv_dequantize.run_launches) == before
