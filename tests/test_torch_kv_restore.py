"""The I/O pointer's decode routine (``csrc/dequant_rows.cuh``), shared by
``kv_restore`` and ``kv_dequantize``, checked on the CPU.

The kernels cannot run here, so the launch they pick is mirrored by
``rows_plan`` and checked for coverage (every field, slot, row and
16-channel group written exactly once; the scalar instance exactly where a
channel count or a pointer rules out 16-byte accesses), and the routine's
decomposition is walked in plain torch from that plan: each thread's rows
of its unit columns, cut at chunk boundaries, each chunk with its own row
of scales.  The walk must equal the plain versions by ``torch.equal`` and
the JAX reference's ``kv_restore_ref`` and ref-backend ``kv_dequantize``
byte for byte.  ``RestoreDatapath.restore_op`` must dequantize an int8
transfer run in one call and promote pool blocks byte-identical to a
per-chunk decode.  Inputs come from numpy seeds.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kv_quant import kv_dequantize as j_dequant  # noqa: E402
from repro.kernels.kv_restore.ref import kv_restore_ref  # noqa: E402
import repro_torch.core.datapath as datapath  # noqa: E402
from repro_torch.core.datapath import RestoreDatapath  # noqa: E402
from repro_torch.kernels.kv_quant import (kv_dequantize, kv_dequantize_plain,  # noqa: E402
                                          kv_dequantize_plan)
from repro_torch.kernels.kv_restore import (NT, RPT, TARGET_BLOCKS,  # noqa: E402
                                            kv_restore_plain, kv_restore_plan,
                                            kv_restore_scatter, rows_plan)
from repro_torch.storage import ChunkStore  # noqa: E402

BF16 = ml_dtypes.bfloat16
TDT = {np.float32: torch.float32, BF16: torch.bfloat16}


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


def coverage(plan, chans, rows):
    """How often the plan's grid writes each (field, row, unit column):
    csrc `dequant_rows`' index arithmetic over every block and thread of
    one slot (every slot's blocks are the same)."""
    out = []
    tid = np.arange(plan.threads)
    for c in chans:
        g = c // plan.unit
        cl_n = min(g, plan.threads)
        rl_n = plan.threads // cl_n
        cl, rl = tid % cl_n, tid // cl_n
        counts = np.zeros((rows, g), np.int64)
        for bx in range(plan.tiles):
            r_lo = (bx * rl_n + rl) * plan.rpt
            r_hi = np.minimum(rows, r_lo + plan.rpt)
            live = rl < rl_n
            for k in range(plan.rpt):
                r = r_lo + k
                ok = live & (r < r_hi)
                for j in range(-(-g // cl_n)):
                    u = cl + j * cl_n
                    sel = ok & (u < g)
                    np.add.at(counts, (r[sel], u[sel]), 1)
        out.append(counts)
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c", [16, 1000, 1024, 2048])
def test_plan_covers_every_unit_once(c, aligned):
    """rows 1-300 of 3 slots of two fields: each (field, slot, row, unit
    column) once; 16-channel units exactly when C % 16 == 0 and aligned."""
    for rows in range(1, 301):
        p = rows_plan([c, c], rows, 3, aligned=aligned, quant=True)
        assert p.unit == (16 if aligned and c % 16 == 0 else 1)
        assert p.grid == (p.tiles, 3, 2) and p.threads == NT
        assert p.rpt in (1, 2, 4)
        if p.rpt < RPT:                         # halved only where the grid was short
            assert -(-rows // (p.lanes[0] * 2 * p.rpt)) * 3 * 2 < TARGET_BLOCKS
        for counts in coverage(p, [c, c], rows):
            assert counts.shape == (rows, c // p.unit)
            assert (counts == 1).all(), (rows, p)


def test_plan_rows_a_thread_and_mixed_fields():
    """Rows a thread: RPT for int8 rows (twice that raw) while the grid has
    TARGET_BLOCKS blocks, else halved down to 1; fields of different widths
    share one grid, each covered once."""
    serve = rows_plan([1024, 1024], 256, 18)            # the serve's load op
    assert (serve.unit, serve.rpt, serve.grid) == (16, 4, (16, 18, 2))
    raw = rows_plan([1024, 1024], 256, 18, quant=False)  # its raw copy
    assert (raw.rpt, raw.grid) == (8, (8, 18, 2))
    run = rows_plan([1024, 1024], 128, 36)              # a run of 8 chunks
    assert (run.rpt, run.grid) == (4, (8, 36, 2))
    one = rows_plan([128], 4608, 1)                     # one chunk, (C,) scales
    assert (one.unit, one.rpt, one.grid) == (16, 1, (144, 1, 1))
    for p in (serve, raw, run, one):
        assert p.tiles * p.grid[1] * p.grid[2] >= TARGET_BLOCKS
    mixed = rows_plan([1024, 512, 48], 77, 2)
    assert mixed.lanes == (4, 8, 85) and mixed.rpt == 1
    for c, counts in zip([1024, 512, 48], coverage(mixed, [1024, 512, 48], 77)):
        assert (counts == 1).all(), c
    with pytest.raises(ValueError):
        rows_plan([1024] * 5, 16, 1)
    with pytest.raises(ValueError):
        rows_plan([1024], 0, 1)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 16, 24, 32, 64, 96, 256, 320, 512])
def test_shuffled_bf16_stores_write_each_word_once(g):
    """csrc `Unit::store`'s shuffled bf16 stores, for a row of g 16-channel
    units: lanes of a group (32, or all g when 32 is a multiple of g; none
    otherwise) each store 16-byte word v = k * size + idx of the group's
    segment on store k, taken from half v & 1 of lane first + (v >> 1).  Every
    word of the row is written once, with the bytes of its own unit and
    half, and no shuffle reads a lane outside its group."""
    cl_n = min(g, NT)
    size = 32 if g % 32 == 0 else g if 32 % g == 0 else 0
    written = {}
    for u in range(g):
        if not size:                        # a lane's own two words
            for half in (0, 1):
                written.setdefault(2 * u + half, []).append((u, half))
            continue
        idx = (u % cl_n) % size             # the lane's place in its group
        first = u - idx                     # the unit of the group's first lane
        assert first % size == 0
        for k in (0, 1):
            v = k * size + idx
            assert v >> 1 < size            # the source lane is in the group
            written.setdefault(2 * first + v, []).append((first + (v >> 1), v & 1))
    assert sorted(written) == list(range(2 * g))
    for word, who in written.items():
        assert who == [(word // 2, word % 2)]


def walk(plan, place, ins, scales, slot_lo, rows, cs):
    """The routine's decomposition in plain torch: for each block (row tile,
    slot, field) and row lane of the plan, the lane's consecutive rows of
    every unit column, cut where a chunk ends, each piece decoded with its
    chunk's row of scales (one f32 multiply, one cast) or copied into
    ``place(field, slot, chunk, r0, r1)``, the output's rows [r0, r1) of
    that chunk (csrc: at out + ch * out_cs + (r - ch * cs) * C)."""
    for f, x in enumerate(ins):
        cl_n = min(x.shape[2] // plan.unit, plan.threads)
        rl_n = plan.threads // cl_n
        for bx in range(plan.tiles):
            for by in range(plan.grid[1]):
                slot = slot_lo + by
                for rl in range(rl_n):
                    r = (bx * rl_n + rl) * plan.rpt
                    r_hi = min(rows, r + plan.rpt)
                    while r < r_hi:
                        ch = r // cs
                        end = min(r_hi, (ch + 1) * cs)
                        out = place(f, slot, ch, r, end)
                        if scales is None:
                            out[:] = x[slot, r:end]
                        else:
                            out[:] = (x[slot, r:end].float() * scales[f][ch]).to(out.dtype)
                        r = end


def _restore_inputs(name):
    """(caches, staged, scales or None, kw) of a named restore case."""
    rng = np.random.default_rng(sum(name.encode()))
    dtype = np.float32 if "f32" in name else BF16
    a, s, c, t, cs = 4, 64, 64, 48, 16
    t0, slot_lo, n_slots = 16, 0, None
    if name == "ragged_chunk":                 # 40 rows: the last chunk 8 of 16
        t = 40
    if name == "rows_past_s":                  # 48 rows from t0 40 of S 64: 24 land
        t0 = 40
    if name == "scalar_c1000":
        c, t = 1000, 20
    if name == "slot_subspan":
        slot_lo, n_slots = 1, 2
    caches = [_t((rng.standard_normal((a, s, c)) * 2).astype(np.float32).astype(dtype))
              for _ in range(2)]
    if name.startswith("raw"):
        staged = [_t((rng.standard_normal((a, t, c)) * 2).astype(np.float32).astype(dtype))
                  for _ in range(2)]
        scales = None
    else:
        staged = [_t(rng.integers(-127, 128, (a, t, c)).astype(np.int8)) for _ in range(2)]
        scales = [_t((rng.random((-(-t // cs), c)) * 0.1).astype(np.float32))
                  for _ in range(2)]
    return caches, staged, scales, dict(t0=t0, slot_lo=slot_lo, n_slots=n_slots,
                                        chunk_size=cs)


RESTORE_CASES = ["int8_bf16", "int8_f32", "raw_bf16", "raw_f32", "ragged_chunk",
                 "rows_past_s", "scalar_c1000", "slot_subspan"]


@pytest.mark.parametrize("name", RESTORE_CASES)
def test_restore_walk_equals_plain_and_reference(name):
    caches, staged, scales, kw = _restore_inputs(name)
    plan = kv_restore_plan(caches, staged, scales, **kw)
    assert plan.unit == (1 if name == "scalar_c1000" else 16)
    t0, s = kw["t0"], caches[0].shape[1]
    rows = min(staged[0].shape[1], s - t0)
    got = [x.clone() for x in caches]
    walk(plan, lambda f, slot, ch, r0, r1: got[f][slot, t0 + r0:t0 + r1], staged, scales,
         kw["slot_lo"], rows, kw["chunk_size"])
    want = kv_restore_plain([x.clone() for x in caches], staged, scales, **kw)
    # the reference takes whole chunks: a ragged staging buffer is padded
    # with zero rows, and its cache cut at t0 + rows so that they drop
    cs, end = kw["chunk_size"], t0 + rows
    for g, w, cache, x, sc in zip(got, want, caches, staged, scales or [None, None]):
        pad = np.zeros((x.shape[0], -x.shape[1] % cs, x.shape[2]), _np(x).dtype)
        ref = kv_restore_ref(jnp.asarray(_np(cache[:, :end])),
                             jnp.asarray(np.concatenate([_np(x), pad], axis=1)),
                             None if sc is None else jnp.asarray(_np(sc)), **kw)
        assert torch.equal(g, w)
        _bytes_eq(g[:, :end], ref)
        assert torch.equal(g[:, end:], cache[:, end:])
    # the wrapper (its plain version here) writes the same bits, in place
    out = kv_restore_scatter(caches, staged, scales, **kw)
    for o, x, w in zip(out, caches, want):
        assert o is x and torch.equal(o, w)


def _run_views(rng, a=6, chunks=5, tail=7, c=64, cs=16, pad=1):
    """A staging buffer of a run (A, chunks * cs + pad * cs, C) int8, the
    run's columns as strided views (the last chunk ragged: ``tail`` rows),
    and per-chunk scales (chunks, C)."""
    t_full = (chunks + pad) * cs
    t = (chunks - 1) * cs + tail
    buf = [_t(rng.integers(-127, 128, (a, t_full, c)).astype(np.int8)) for _ in range(2)]
    scales = [_t((rng.random((chunks, c)) * 0.1).astype(np.float32)) for _ in range(2)]
    return [x[:, :t] for x in buf], scales, t, cs


@pytest.mark.parametrize("out", [np.float32, BF16])
def test_run_dequant_walk_equals_plain_and_reference(out):
    """The run form of kv_dequantize: its walk over strided views of a run's
    columns equals kv_dequantize_plain by torch.equal and, chunk by chunk,
    the reference's ref-backend kv_dequantize byte for byte."""
    rng = np.random.default_rng(11)
    q, scales, t, cs = _run_views(rng)
    assert not q[0].is_contiguous()
    dtype = TDT[out]
    plan = kv_dequantize_plan(q, scales, dtype, chunk_size=cs)
    assert plan.unit == 16 and plan.grid[1:] == (6, 2)
    # chunk-major, as the kernel writes it: chunk ch of slot a at [ch, a]
    bufs = [torch.full((scales[0].shape[0], x.shape[0], cs, x.shape[2]), float("nan"),
                       dtype=dtype) for x in q]
    walk(plan, lambda f, slot, ch, r0, r1: bufs[f][ch, slot, r0 - ch * cs:r1 - ch * cs],
         q, scales, 0, t, cs)
    want = kv_dequantize_plain(q, scales, dtype, chunk_size=cs)
    for buf, w, x, s in zip(bufs, want, q, scales):
        assert len(w) == s.shape[0]
        for ch, chunk in enumerate(w):
            got = buf[ch, :, :chunk.shape[1]]
            assert torch.equal(got, chunk)
            part = slice(ch * cs, min(t, (ch + 1) * cs))
            _bytes_eq(got, j_dequant(jnp.asarray(_np(x[:, part])), jnp.asarray(_np(s[ch])),
                                     jnp.dtype(out), backend="ref"))


def test_one_chunk_dequant_walk_equals_plain():
    """The one-chunk form ((R, C) with (C,) scales) is a run of one slot and
    one chunk: its walk at the store's chunk shape equals the plain version."""
    rng = np.random.default_rng(12)
    q = _t(rng.integers(-127, 128, (6, 1, 16, 2, 128)).astype(np.int8))
    s = _t((rng.random(128) * 0.1).astype(np.float32))
    plan = kv_dequantize_plan(q, s)
    assert (plan.unit, plan.grid) == (16, (plan.tiles, 1, 1))
    rows = q.numel() // 128
    got = torch.zeros(1, rows, 128, dtype=torch.bfloat16)
    walk(plan, lambda f, slot, ch, r0, r1: got[slot, r0:r1], [q.reshape(1, rows, 128)],
         [s[None]], 0, rows, rows)
    assert torch.equal(got.view(q.shape), kv_dequantize_plain(q, s))
    assert torch.equal(kv_dequantize(q, s), kv_dequantize_plain(q, s))


def test_scalar_instance_exactly_where_16_bytes_are_ruled_out():
    """The plans of real calls: 16-channel units for aligned views of C % 16
    == 0 (a run's strided columns included), one channel a unit for C 1000,
    a staging view 4 bytes off alignment, a slot stride off 16 bytes and
    scales off alignment."""
    rng = np.random.default_rng(13)
    q, scales, t, cs = _run_views(rng)
    assert kv_dequantize_plan(q, scales, chunk_size=cs).unit == 16
    off = torch.zeros(4 + q[0].numel(), dtype=torch.int8)[4:].view(q[0].shape)
    assert kv_dequantize_plan([off, q[1]], scales, chunk_size=cs).unit == 1
    odd = torch.zeros(6 * (t * 64 + 4), dtype=torch.int8).as_strided(
        (6, t, 64), (t * 64 + 4, 64, 1))
    assert kv_dequantize_plan([odd, q[1]], scales, chunk_size=cs).unit == 1
    s_off = torch.zeros(1 + scales[0].numel())[1:].view(scales[0].shape)
    assert kv_dequantize_plan(q, [s_off, scales[1]], chunk_size=cs).unit == 1
    caches, staged, sc, kw = _restore_inputs("int8_bf16")
    assert kv_restore_plan(caches, staged, sc, **kw).unit == 16
    shifted = torch.zeros(4 + staged[0].numel(), dtype=torch.int8)[4:].view(staged[0].shape)
    assert kv_restore_plan(caches, [shifted, staged[1]], sc, **kw).unit == 1
    assert kv_restore_plan(*_restore_inputs("scalar_c1000")[:3],
                           **_restore_inputs("scalar_c1000")[3]).unit == 1


def test_wrappers_refuse_off_card_tensors_and_wrong_scales():
    rng = np.random.default_rng(14)
    q, scales, t, cs = _run_views(rng)
    caches, staged, sc, kw = _restore_inputs("int8_bf16")
    before = (kv_restore_scatter.launches, kv_dequantize.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kv_dequantize([x.to("meta") for x in q], [s.to("meta") for s in scales],
                      chunk_size=cs)
    with pytest.raises(ValueError, match="CUDA"):
        kv_restore_scatter([x.to("meta") for x in caches], [x.to("meta") for x in staged],
                           [s.to("meta") for s in sc], **kw)
    bad = {"one row short": [s[:-1] for s in scales],
           "per-channel only": [s[0] for s in scales],
           "f64": [s.double() for s in scales]}
    for name, wrong in bad.items():
        with pytest.raises(ValueError, match="scales"):
            kv_dequantize(q, wrong, chunk_size=cs)
    with pytest.raises(ValueError):
        kv_dequantize(q, scales)                           # a run needs its chunk_size
    with pytest.raises(ValueError):
        kv_dequantize([x.transpose(1, 2) for x in q], scales, chunk_size=cs)
    with pytest.raises(ValueError, match="scales"):
        kv_dequantize(q[0][0], scales[0])                  # one chunk takes (C,)
    with pytest.raises(ValueError, match="scales"):
        kv_restore_scatter(caches, staged, [s[:-1] for s in sc], **kw)
    assert (kv_restore_scatter.launches, kv_dequantize.launches) == before


def test_restore_op_dequantizes_a_run_once_and_promotes_per_chunk_bits(monkeypatch):
    """An int8 store on the host tier restores a 3-layer, 70-token prefix
    (four 16-token chunks and a 6-token tail) through
    RestoreDatapath.restore_op: one transfer run, one kv_dequantize call on
    the run's strided columns, and every chunk's promoted pool block equal
    byte for byte to that chunk's own decode."""
    rng = np.random.default_rng(15)
    a, n, hkv, dh, cs = 3, 70, 2, 32, 16
    k, v = (_t((rng.standard_normal((a, 1, n, hkv, dh)) * 2).astype(np.float32)
               .astype(BF16)) for _ in range(2))
    kpos = torch.arange(n, dtype=torch.int32).expand(a, n).contiguous()
    toks = torch.from_numpy(rng.integers(0, 512, (1, n)).astype(np.int32))
    store = ChunkStore(chunk_size=cs, quant="int8", default_tier="host", device="cpu")
    keys = store.put_request("r", toks, {"k": k, "v": v, "kpos": kpos})
    host = {key: store.chunks[key].reprs["host"] for key in keys}
    calls = []

    def counting(q, scales, dtype=torch.bfloat16, **kw):
        calls.append((len(q), tuple(q[0].shape), q[0].is_contiguous()))
        return kv_dequantize(q, scales, dtype, **kw)
    monkeypatch.setattr(datapath, "kv_dequantize", counting)
    cache = {"k": torch.zeros(a, 1, 80, hkv, dh, dtype=torch.bfloat16),
             "v": torch.zeros(a, 1, 80, hkv, dh, dtype=torch.bfloat16),
             "kpos": torch.full((a, 80), -1, dtype=torch.int32)}
    dp = RestoreDatapath(device="cpu")
    dp.restore_op(cache, store.fetch_range_packed("r", 0, n), store=store,
                  slot_span=(0, a))
    assert dp.kernel_launches == dp.runs == 1
    assert calls == [(2, (a, n, hkv * dh), False)]     # the run's columns, strided
    assert torch.equal(cache["kpos"][:, :n], kpos)
    for key in keys:
        assert store.core.tier_of(key) == "hbm"
        t0, t1 = store.chunks[key].tokens
        view = store.device_view(key)
        for f, arr in (("k", k), ("v", v)):
            want = kv_dequantize_plain(host[key][f]["q"], host[key][f]["scales"])
            assert torch.equal(view[f], want)
            assert torch.equal(cache[f][:, :, t0:t1], want)
        assert torch.equal(view["kpos"], kpos[:, t0:t1])
