"""The port's second slice against the JAX reference: RecurrentGemma's RG-LRU
layers and local (windowed, ring-buffer) attention, restoration of
attention KV together with recurrent state, and the serving engine.

Reduced recurrentgemma-2b on the CPU in f32: 6 layers (rec, rec, attn) x 2,
window 64, 4 query heads on 1 KV head (G 4), head_dim 32, lru_width 128 in
2 RG-LRU heads.  Inputs are drawn with numpy from a seed and fed to both
packages; weights come from the reference's ``Model.init`` through
``params_from_jax``.  The reference runs as its own tests run it on the
CPU: the RG-LRU kernel in interpret mode and through its ``ref`` oracle,
and the model under ``backend="auto"``, whose recurrence is an associative
scan — so the port's sequential scan agrees with it to rounding, not bit
for bit.

Tolerances: ATOL = 1e-5 for layers, kernels' plain versions, caches and
snapshots (two libraries' f32 exp/rsqrt/tanh and summation orders differ in
the last bits, and the associative scan sums in another order than the
sequential one); LOGIT_ATOL = 1e-4 for logits after the whole stack and
the 512-way tied unembedding; positions (kpos), ops logs and greedy tokens
exact.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.engine_core as j_core  # noqa: E402
import repro_torch.core.engine_core as t_core  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import RestorationExecutor as JExecutor  # noqa: E402
from repro.kernels.flash_decode import flash_decode_attention  # noqa: E402
from repro.kernels.rglru_scan import ops as j_rglru_ops  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.serving import RealServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RestorationExecutor  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.models.kvcache import grow_cache, park_cache, unpark_cache  # noqa: E402
from repro_torch.serving import RealServingEngine, Request  # noqa: E402

ARCH = "recurrentgemma-2b"
ATOL = 1e-5
LOGIT_ATOL = 1e-4
N = 40                       # restoration prefix (< the 64-token window)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    cfg_j = jax_get_config(ARCH).reduced()
    jm = build_model(cfg_j)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg_t = get_config(ARCH).reduced()
    tm = Model(cfg_t, device="cpu")
    tp = params_from_jax(_tree_np(jp), device="cpu")
    return dict(cfg=cfg_t, jm=jm, jp=jp, tm=tm, tp=tp)


def _rec_params(pair, i=0):
    """Layer i's params in both packages (the reference unrolls a hybrid:
    every layer is in prefix_layers)."""
    return _tree_np(pair["jp"]["prefix_layers"][i]), pair["tp"]["layers"][i]


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    a, b = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.layer_kinds() == b.layer_kinds()
    assert a.param_counts() == b.param_counts()
    assert a.state_bytes() == b.state_bytes()


def test_init_layout_and_f32_lam(pair):
    """Model.init: the converted reference's tree shapes, per layer kind;
    the RG-LRU ``lam`` stays f32 under bf16 parameters, both from init and
    through params_from_jax."""
    cfg, tm, tp = pair["cfg"], pair["tm"], pair["tp"]
    assert "scan_layers" not in pair["jp"]
    assert len(pair["jp"]["prefix_layers"]) == cfg.num_layers
    mine = tm.init(torch.Generator().manual_seed(0))
    assert mine.keys() == tp.keys() and len(mine["layers"]) == cfg.num_layers
    for kind, a, b in zip(cfg.layer_kinds(), mine["layers"], tp["layers"]):
        assert ("rglru" in a) == (kind == "recurrent") == ("attn" not in a)
        for blk in a:
            for name in a[blk]:
                assert a[blk][name].shape == b[blk][name].shape, (blk, name)
    bf = Model(cfg, param_dtype=torch.bfloat16, device="cpu")
    p16 = bf.init(torch.Generator().manual_seed(0))
    rec = p16["layers"][0]["rglru"]
    assert rec["lam"].dtype == torch.float32 and rec["w_x"].dtype == torch.bfloat16
    # a^c of the initial decay lies in [0.9, 0.999] (Griffin appendix)
    a_c = torch.exp(-torch.nn.functional.softplus(rec["lam"]) * 8.0)
    assert float(a_c.min()) >= 0.9 ** 2 - 1e-6 and float(a_c.max()) <= 0.999 ** 2 + 1e-6
    conv = params_from_jax(_tree_np(pair["jp"]), dtype=torch.bfloat16, device="cpu")
    assert conv["layers"][0]["rglru"]["lam"].dtype == torch.float32
    assert conv["layers"][0]["rglru"]["gate_a"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The scan kernel's plain version and the recurrent block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [40, 48])
@pytest.mark.parametrize("backend", ["interpret", "ref"])
def test_rglru_scan_plain_matches_reference(backend, s):
    """h0 != 0; time blocks of 16 that do (48) and do not (40) divide S,
    channel blocks of 64 that do not divide W.  h_last is held to the
    reference's last h: with a ragged last time block the reference kernel
    steps on through the block's padding rows, so its own h_last is NaN in
    interpret mode (and wrong on a TPU) — a fault of the reference that the
    port does not copy."""
    rng = np.random.default_rng(5)
    b, w = 2, 96
    log_a = -0.5 * rng.random((b, s, w)).astype(np.float32)
    bt = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    want_h, want_last = j_rglru_ops.rglru_scan(jnp.asarray(log_a), jnp.asarray(bt),
                                               jnp.asarray(h0), backend=backend,
                                               bs=16, bw=64)
    before = rglru_scan.launches
    h, last = rglru_scan(_t(log_a), _t(bt), _t(h0))
    assert rglru_scan.launches == before          # the plain version, no launch
    _close(h, want_h)
    _close(last, np.asarray(want_h)[:, -1])
    if backend == "ref" or s % 16 == 0:
        _close(last, want_last)


@pytest.mark.parametrize("fn", ["rglru_full", "recurrent_layer_full"])
def test_recurrent_block_matches_reference(pair, fn):
    """A chunk from a non-zero state: conv tail and h0 from numpy."""
    cfg = pair["cfg"]
    jp, tp = _rec_params(pair, 1)
    rng = np.random.default_rng(6)
    w, k = cfg.rglru.lru_width, cfg.rglru.conv1d_width
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    tail = rng.standard_normal((2, k - 1, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    if fn == "rglru_full":
        want = j_rglru.rglru_full(cfg, jp["rglru"], jnp.asarray(x), jnp.asarray(tail),
                                  jnp.asarray(h0))
        got = t_rglru.rglru_full(cfg, tp["rglru"], _t(x), _t(tail), _t(h0))
    else:
        want = j_tfm.recurrent_layer_full(cfg, jp, jnp.asarray(x), jnp.asarray(tail),
                                          jnp.asarray(h0))
        got = t_tfm.recurrent_layer_full(cfg, tp, _t(x), _t(tail), _t(h0))
    for g_, w_ in zip(got, want):
        _close(g_, w_)


# ---------------------------------------------------------------------------
# Windowed attention on a wrapped ring cache
# ---------------------------------------------------------------------------


def _ring(s, q_pos):
    """Slot j holds the latest position p <= q_pos with p % s == j."""
    j = np.arange(s)
    return (q_pos - (q_pos - j) % s).astype(np.int32)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_windowed_attention_on_wrapped_ring(kind):
    """The ring of a 64-slot windowed cache after it wrapped: a chunk at
    positions 100..107 (written to slots 36..43 first, as attention_chunk
    does) and a decode step at 130, window 64, a few slots left stale one
    ring turn back.  Port's plain versions vs the model's chunk attention
    (masked softmax) and the reference decode kernel."""
    rng = np.random.default_rng(7)
    b, s, hq, hkv, dh, win = 1, 64, 4, 1, 32, 64
    scale = dh ** -0.5
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    if kind == "prefill":
        c, p0 = 8, 100
        kpos = _ring(s, p0 + c - 1)
        kpos[[3, 50]] -= s                        # stale: outside every window
        q = rng.standard_normal((b, c, hq, dh)).astype(np.float32)
        qp = p0 + np.arange(c)
        mask = ((kpos[None] >= 0) & (kpos[None] <= qp[:, None])
                & (kpos[None] > qp[:, None] - win))
        want = j_attn._gqa_scores_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(mask), scale)
        got = flash_prefill(_t(q), _t(k), _t(v), _t(kpos), p0, scale=scale, window=win)
    else:
        qp = 130
        kpos = _ring(s, qp)
        kpos[[5, 40]] -= s
        q = rng.standard_normal((b, hq, dh)).astype(np.float32)
        want = flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(kpos), qp, scale=scale, window=win,
                                      backend="interpret", bk=16)
        got = flash_decode(_t(q), _t(k), _t(v), _t(kpos), qp, scale=scale, window=win)
    _close(got, want)


# ---------------------------------------------------------------------------
# Model entry points and caches
# ---------------------------------------------------------------------------


def _cache_to_torch(cache):
    return {f: _t(a) for f, a in cache.items()}


def _assert_cache(got, want, atol=ATOL):
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["kpos"].numpy(), np.asarray(want["kpos"]))
    for f in got:
        if f != "kpos":
            assert got[f].dtype == (torch.float32 if f == "lru" else got["k"].dtype)
            _close(got[f], want[f], atol)


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both packages after prefill_chunk of 24 tokens into a 40-token cache."""
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    toks = np.random.default_rng(4).integers(0, 512, (1, 24)).astype(np.int32)
    jl_, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jm.init_cache(1, 40), 0)
    tl_, tc = tm.prefill_chunk(tp, _t(toks), tm.init_cache(1, 40), 0)
    return dict(jl=jl_, jc=jc, tl=tl_, tc=tc)


@pytest.mark.parametrize("entry", ["prefill_chunk", "layer_chunk_recurrent",
                                   "layer_chunk_attention", "decode_step"])
def test_model_entry_points_match_reference(pair, prefilled, entry):
    """prefill_chunk over an empty cache; layer_chunk of one layer of each
    kind over the prefilled cache; decode_step (C = 1) through all six."""
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    jc, tc = prefilled["jc"], prefilled["tc"]
    if entry == "prefill_chunk":
        _close(prefilled["tl"], prefilled["jl"])
        _assert_cache(tc, jc)
        return
    if entry == "decode_step":
        tok = np.argmax(np.asarray(prefilled["jl"]), axis=-1).astype(np.int32)
        jd, jc2 = jm.decode_step(jp, jnp.asarray(tok), jc, 24)
        td, tc2 = tm.decode_step(tp, _t(tok), _cache_to_torch(jc), 24)
        _close(td, jd)
        _assert_cache(tc2, jc2)
        return
    i = 1 if entry == "layer_chunk_recurrent" else 2
    x = np.random.default_rng(8).standard_normal((1, 8, 128)).astype(np.float32)
    pos = np.arange(24, 32, dtype=np.int32)[None]
    jx, jc2 = jm.layer_chunk(jp, i, jnp.asarray(x), jnp.asarray(pos), jc)
    tx, tc2 = tm.layer_chunk(tp, i, _t(x), _t(pos), _cache_to_torch(jc))
    _close(tx, jx)
    _assert_cache(tc2, jc2)


def test_cache_helpers_carry_recurrent_state(pair, prefilled):
    """init_cache's recurrent fields; grow_cache, park_cache and unpark_cache
    carry conv/lru unchanged (length-free state)."""
    cfg, tm = pair["cfg"], pair["tm"]
    c0 = tm.init_cache(1, 40)
    n_rec = cfg.layer_kinds().count("recurrent")
    assert tuple(c0["conv"].shape) == (n_rec, 1, cfg.rglru.conv1d_width - 1, 128)
    assert tuple(c0["lru"].shape) == (n_rec, 1, 128) and c0["lru"].dtype == torch.float32
    assert tuple(c0["k"].shape) == (2, 1, 40, 1, 32)
    tc = prefilled["tc"]
    grown = grow_cache(cfg, tc, 100)
    assert grown["k"].shape[2] == cfg.attn_window      # capped at the ring size
    back = unpark_cache(park_cache(grown), "cpu")
    for f in ("conv", "lru"):
        assert torch.equal(grown[f], tc[f]) and torch.equal(back[f], tc[f])


# ---------------------------------------------------------------------------
# Restoration: attention KV + recurrent state, token- and layer-wise
# ---------------------------------------------------------------------------


def _remembered(pair, stages):
    inputs = np.random.default_rng(9).integers(0, 512, (1, N)).astype(np.int32)
    jx = JExecutor(pair["jm"], pair["jp"], chunk_size=8, stages=stages)
    tx = RestorationExecutor(pair["tm"], pair["tp"], chunk_size=8, stages=stages)
    jx.remember("req", jnp.asarray(inputs))
    tx.remember("req", _t(inputs))
    return jx, tx


def test_state_snapshots_are_copies(pair):
    """Every (stage, chunk) snapshot keeps that chunk's state: snapshot
    (0, 0) equals the reference's, and differs from the end of the prefix
    (it did not alias the live cache that the later chunks updated)."""
    jx, tx = _remembered(pair, 2)
    tsn = tx.store.get("req").state_snapshots
    jsn = jx.store.get("req").state_snapshots
    assert set(tsn) == set(jsn)
    for key in [(0, 0), (1, 2), (1, N // 8 - 1)]:
        for f in ("conv", "lru"):
            _close(tsn[key][f], jsn[key][f])
    assert not torch.equal(tsn[(0, 0)]["lru"], tsn[(0, N // 8 - 1)]["lru"])


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("strategy", ["token", "layer"])
def test_restoration_matches_reference(pair, strategy, stages):
    """Restore in both packages with the same plans and op order: the port
    verifies (KV and conv/lru) and its restored cache equals the
    reference's restored cache."""
    jx, tx = _remembered(pair, stages)
    jx.restore("req", strategy=strategy, op_order="alternate")
    tx.restore("req", strategy=strategy, op_order="alternate")
    errs = tx.verify("req")
    jx.verify("req")
    assert set(errs) == {"k", "v", "kpos", "conv", "lru"}
    assert max(errs.values()) <= ATOL
    _assert_cache(tx.live_cache("req"), jx.live_cache("req"))


# ---------------------------------------------------------------------------
# The slice end to end: both serving engines, ring wrapping in decode
# ---------------------------------------------------------------------------

# prefix 16 restores layer-wise (< l_delta), 48 token-wise; 48 + 8 new + 16
# output tokens run past the 64-slot window, so decode wraps the ring
REQS = [("a", 0.0, 16), ("b", 0.0, 48)]
ENGINE_KW = dict(system="cacheflow", stages=2, chunk_size=16, l_delta=32,
                 max_batch=2, kvstore=None)


@contextlib.contextmanager
def _capture_results(module, sink):
    orig = module.EngineCore.run

    def run(self, *a, **kw):
        res = orig(self, *a, **kw)
        sink.append(res)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module.EngineCore, "run", run)
        yield


@pytest.fixture(scope="module")
def served(pair):
    je = JEngine(pair["jm"], pair["jp"], **ENGINE_KW)
    te = RealServingEngine(pair["tm"], pair["tp"], device="cpu", **ENGINE_KW)
    # the port draws its inputs with torch; parity needs the reference's
    te._inputs = lambda n: torch.from_numpy(np.array(je._inputs(n)))
    out = {}
    for tag, eng, req_cls, mod in (("jax", je, JRequest, j_core),
                                   ("torch", te, Request, t_core)):
        sink = []
        reqs = [req_cls(rid, t, n, 8, decode_len=16) for rid, t, n in REQS]
        with _capture_results(mod, sink):
            rep = eng.serve(reqs, verify=True, op_order="alternate")
        out[tag] = dict(eng=eng, rep=rep, res=sink[0])
    return out


def test_serve_schedule_identical(served):
    j, t = served["jax"], served["torch"]
    assert t["res"].ops_log == j["res"].ops_log
    assert t["rep"].ttfts == j["rep"].ttfts
    assert t["res"].decode_steps == j["res"].decode_steps
    live = t["eng"].executor._live
    assert {rid: live[rid]["plans"][0].strategy for rid in live} == \
        {"a": "layer", "b": "token"}


def test_serve_outputs_match(served):
    je, te = served["jax"]["eng"], served["torch"]["eng"]
    for rid, _, n in REQS:
        oj, ot = je.executor.outputs(rid), te.executor.outputs(rid)
        assert ot["tokens"] == oj["tokens"] and len(ot["tokens"]) == 16
        np.testing.assert_allclose(ot["first_logits"].numpy(),
                                   np.asarray(oj["first_logits"]),
                                   rtol=0, atol=LOGIT_ATOL)
    # the 48-token request's decode ran past the window: its ring wrapped
    kpos = te.executor.live_cache("b")["kpos"]
    assert int(kpos.max()) == 48 + 8 + 16 - 2 and int(kpos.min()) > 0


def test_serve_restored_state_verified(served):
    """serve(verify=True) raised on mismatch; every request verified KV and
    recurrent state, and the stored ground truth matches the reference's."""
    je, te = served["jax"]["eng"], served["torch"]["eng"]
    assert set(te.executor.verify_errs) == {rid for rid, _, _ in REQS}
    for rid, _, _ in REQS:
        errs = te.executor.verify_errs[rid]
        assert set(errs) == {"k", "v", "kpos", "conv", "lru"}
        assert max(errs.values()) <= ATOL
        ref = te.executor.store.get(rid).kv_reference
        jref = je.executor.store.get(rid).kv_reference
        _assert_cache(ref, jref)
