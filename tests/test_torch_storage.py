"""PyTorch port vs the JAX reference: int8 KV quantizer, fused restore
scatter and the chunk store — all BIT-EXACT.

Quantize is f32 true divide + round half to even + clip, dequantize one f32
multiply + one cast, the scatter a copy or that dequant: no reduction order
or transcendental differs between the libraries, so codes, scales, restored
bytes and store payloads must be identical.  Inputs come from numpy seeds;
the JAX kernels run through their ``ref.py`` oracles and, where shapes
allow, in interpret mode.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kv_quant import kv_dequantize as j_dequant  # noqa: E402
from repro.kernels.kv_quant import kv_quantize as j_quant  # noqa: E402
from repro.kernels.kv_restore.ref import kv_restore_ref  # noqa: E402
from repro.storage import ChunkStore as JChunkStore  # noqa: E402
from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize  # noqa: E402
from repro_torch.kernels.kv_restore import kv_restore_scatter  # noqa: E402
from repro_torch.storage import ChunkStore  # noqa: E402

BF16 = ml_dtypes.bfloat16


def _np(t: "torch.Tensor") -> np.ndarray:
    """Exact numpy view of a torch tensor (bf16 -> ml_dtypes bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _t(a) -> "torch.Tensor":
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _eq(got, want):
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _kv(rng, shape, dtype):
    return (rng.standard_normal(shape) * 2.5).astype(np.float32).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_kv_quantize_bit_exact(dtype):
    """Against the reference's quantizer on the CPU (its ref.py path; the
    jitted Pallas path may fold ``/ 127`` into a reciprocal multiply)."""
    rng = np.random.default_rng(0)
    x = _kv(rng, (4, 1, 8, 2, 32), dtype)
    qj, sj = j_quant(jnp.asarray(x))
    qt, st = kv_quantize(_t(x))
    _eq(qt, qj)
    _eq(st, sj)


@pytest.mark.parametrize("out", [np.float32, BF16])
@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_kv_dequantize_bit_exact(out, backend):
    rng = np.random.default_rng(5)
    q = rng.integers(-127, 128, (4, 1, 8, 2, 32)).astype(np.int8)
    s = (rng.random(32) * 0.1).astype(np.float32)
    tdt = torch.float32 if out == np.float32 else torch.bfloat16
    _eq(kv_dequantize(_t(q), _t(s), tdt),
        j_dequant(jnp.asarray(q), jnp.asarray(s), jnp.dtype(out), backend=backend))


def test_kv_quantize_rounds_half_to_even():
    """absmax 127 gives scale 1 exactly, so x / s = x: ties must go to even
    (2.5 -> 2, -3.5 -> -4, 0.5 -> 0), as jnp.round does."""
    x = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5]], np.float32).T
    q, s = kv_quantize(_t(x))
    assert float(s[0]) == 1.0
    assert q[:, 0].tolist() == [127, 2, -4, 0, 0, 2]
    qj, _ = j_quant(jnp.asarray(x))
    _eq(q, qj)


def _restore_case(rng, dtype, quant, *, a=4, s=40, c=64, t=24, cs=8):
    caches = [_kv(rng, (a, s, c), dtype) for _ in range(2)]
    if quant:
        staged = [rng.integers(-127, 128, (a, t, c)).astype(np.int8) for _ in range(2)]
        scales = [(rng.random((t // cs, c)) * 0.1).astype(np.float32) for _ in range(2)]
    else:
        staged = [_kv(rng, (a, t, c), dtype) for _ in range(2)]
        scales = None
    return caches, staged, scales


@pytest.mark.parametrize("case", ["raw_f32", "raw_bf16", "int8_bf16", "int8_f32",
                                  "slot_subspan", "rows_past_s"])
def test_kv_restore_bit_exact(case):
    rng = np.random.default_rng(1)
    dtype = np.float32 if case.endswith("f32") else BF16
    quant = case.startswith("int8") or case in ("slot_subspan", "rows_past_s")
    caches, staged, scales = _restore_case(rng, dtype, quant)
    t0, slot_lo, n_slots = 8, 0, None
    if case == "slot_subspan":
        slot_lo, n_slots = 1, 2
    if case == "rows_past_s":
        t0 = 24                                    # 24 + 24 > S = 40: clipped
    want = [kv_restore_ref(jnp.asarray(cj), jnp.asarray(x),
                           None if scales is None else jnp.asarray(sc),
                           t0=t0, slot_lo=slot_lo, n_slots=n_slots, chunk_size=8)
            for cj, x, sc in zip(caches, staged, scales or [None, None])]
    got = [_t(c) for c in caches]
    out = kv_restore_scatter(got, [_t(x) for x in staged],
                             None if scales is None else [_t(s) for s in scales],
                             t0=t0, slot_lo=slot_lo, n_slots=n_slots, chunk_size=8)
    for g, o, w in zip(got, out, want):
        assert o is g                              # updated in place
        _eq(g, w)


def _cache_pair(rng, n, dtype):
    """A prefix cache (2 layers, B 1, n tokens, 2 KV heads, Dh 32) as the
    reference's arrays and the port's tensors."""
    k = _kv(rng, (2, 1, n, 2, 32), dtype)
    v = _kv(rng, (2, 1, n, 2, 32), dtype)
    kpos = np.broadcast_to(np.arange(n, dtype=np.int32), (2, n)).copy()
    j = {"k": jnp.asarray(k), "v": jnp.asarray(v), "kpos": jnp.asarray(kpos)}
    t = {"k": _t(k), "v": _t(v), "kpos": _t(kpos)}
    return j, t


def _payload_eq(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _payload_eq(got[key], want[key])
    else:
        _eq(got, want)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_chunkstore_packed_round_trip_bit_exact(quant, tier, dtype):
    """put -> fetch_range_packed payloads, then fetch (promotion to HBM and
    the decoded device view), byte-identical to the reference store, with
    the same accounting."""
    rng = np.random.default_rng(2)
    n = 28                                         # tail chunk of 4 tokens
    cj, ct = _cache_pair(rng, n, dtype)
    toks = rng.integers(0, 512, (1, n)).astype(np.int32)
    js = JChunkStore(chunk_size=8, quant=quant, default_tier=tier)
    ts = ChunkStore(chunk_size=8, quant=quant, default_tier=tier, device="cpu")
    assert js.put_request("r", jnp.asarray(toks), cj) == \
        ts.put_request("r", _t(toks), ct)
    pj = js.fetch_range_packed("r", 0, n)
    pt = ts.fetch_range_packed("r", 0, n)
    assert [p[:3] + p[4:] for p in pj] == [p[:3] + p[4:] for p in pt]
    for a, b in zip(pt, pj):
        _payload_eq(a[3], b[3])
    for key in js.requests["r"]:
        _payload_eq(ts.fetch(key), js.fetch(key))
        _payload_eq(ts.fetch(key), js.fetch(key))     # now an hbm hit
    for attr in ("puts", "fetches", "io_hits", "bytes_put", "bytes_transferred",
                 "store_misses"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert ts.max_scale == js.max_scale
    ts.audit()
