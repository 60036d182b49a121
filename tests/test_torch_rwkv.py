"""The port's third slice against the JAX reference: RWKV-6 "Finch" layers
(data-dependent decay time mix with the wkv recurrence, channel mix), their
O(1) carried state (wkv matrix per head, two token shifts), layer-wise
restoration of an attention-free model, and the serving engine.

Reduced rwkv6-7b on the CPU in f32: 4 layers, d_model 128, 4 wkv heads of
32, d_ff 256, vocab 512.  Inputs are drawn with numpy from a seed and fed to
both packages; weights come from the reference's ``Model.init`` through
``params_from_jax``.  The reference runs as its own tests run it on the
CPU: the wkv kernel in interpret mode and through its ``ref`` oracle, and
the model under ``backend="auto"``, whose time mix takes the sequential
scan below 128 steps and the chunked scan (parallel within 64-step chunks)
at 128 — so the port's sequential recurrence agrees with it to rounding,
not bit for bit.

Tolerances, each ``max |port - reference| <= TOL * max(1, max |reference|)``:
TOL = 1e-5 for layers, the kernel's plain version, states and caches (two
libraries' f32 exp/tanh/rsqrt and summation orders differ in the last bits;
the wkv state reaches ~30 here, so its bound is relative); LOGIT_TOL = 1e-4
for logits after the whole stack and the 512-way unembedding.  Ops logs,
plans and greedy tokens exact; chained calls of the plain recurrence equal
one call bit for bit; the port's restored state equals what its own
``remember`` built bit for bit (verify errors exactly 0).
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
from repro.kernels.rwkv6_scan import ops as j_wkv_ops  # noqa: E402
from repro.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import rwkv6 as j_rwkv  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.serving import RealServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RestorationExecutor  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_plain  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.models import rwkv6 as t_rwkv  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.models.kvcache import grow_cache, park_cache, unpark_cache  # noqa: E402
from repro_torch.models.model import F32_LEAVES  # noqa: E402
from repro_torch.serving import RealServingEngine, Request  # noqa: E402

ARCH = "rwkv6-7b"
TOL = 1e-5
LOGIT_TOL = 1e-4
N = 48                       # restoration prefix: 3 chunks of 16
STATE = ("wkv", "shift_tm", "shift_cm")
RWKV_F32 = ("decay_base", "bonus_u", "mix_base", "cm_mix_k", "cm_mix_r")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    bound = tol * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


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


def _layer_params(pair, i=0):
    """Layer i's params in both packages (the reference stacks the uniform
    RWKV stack in scan_layers)."""
    return _tree_np(pair["jm"].layer_params(pair["jp"], i)), pair["tp"]["layers"][i]


def _state(cfg, rng, b=2):
    """Non-zero carried state: token shifts and a wkv matrix per head."""
    hs = cfg.rwkv.head_size
    h = cfg.d_model // hs
    return (rng.standard_normal((b, cfg.d_model)).astype(np.float32),
            rng.standard_normal((b, cfg.d_model)).astype(np.float32),
            rng.standard_normal((b, h, hs, hs)).astype(np.float32))


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    a, b = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.layer_kinds() == b.layer_kinds() == ("rwkv",) * a.num_layers
    assert a.param_counts() == b.param_counts()
    assert a.state_bytes() == b.state_bytes()


def test_init_layout_and_f32_leaves(pair):
    """Model.init gives the converted reference's tree (no MLP: the channel
    mix is inside the block); the five f32 leaves stay f32 under bf16
    parameters, both from init and through params_from_jax."""
    cfg, tm, tp = pair["cfg"], pair["tm"], pair["tp"]
    assert "prefix_layers" not in pair["jp"] or not pair["jp"]["prefix_layers"]
    assert len(tp["layers"]) == cfg.num_layers
    mine = tm.init(torch.Generator().manual_seed(0))
    assert mine.keys() == tp.keys() and len(mine["layers"]) == cfg.num_layers
    for a, b in zip(mine["layers"], tp["layers"]):
        assert set(a) == set(b) == {"norm1", "norm2", "rwkv"}
        for blk in a:
            assert a[blk].keys() == b[blk].keys()
            for name in a[blk]:
                assert a[blk][name].shape == b[blk][name].shape, (blk, name)
    assert set(RWKV_F32) <= set(F32_LEAVES)
    p16 = Model(cfg, param_dtype=torch.bfloat16, device="cpu").init(
        torch.Generator().manual_seed(0))
    conv = params_from_jax(_tree_np(pair["jp"]), dtype=torch.bfloat16, device="cpu")
    for tree in (p16, conv):
        blk = tree["layers"][1]["rwkv"]
        for name, t in blk.items():
            want = torch.float32 if name in RWKV_F32 else torch.bfloat16
            assert t.dtype == want, name
    # the decay starts at exp(-exp(-6)) ~ 0.9975 per step before the LoRA
    assert torch.all(p16["layers"][0]["rwkv"]["decay_base"] == -6.0)


# ---------------------------------------------------------------------------
# The wkv kernel's plain version
# ---------------------------------------------------------------------------


def _wkv_inputs(rng, b, s, h, dh):
    r, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3))
    # the model's decay: exp(-exp(.)) of normal inputs, in (0, 1)
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, dh)))).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, dh))).astype(np.float32)
    s0 = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("s", [40, 48])
@pytest.mark.parametrize("backend", ["interpret", "ref"])
def test_wkv6_plain_matches_reference(backend, s):
    """s0 != 0; time blocks of 16 that do (48) and do not (40) divide S.
    s_last is held to the sequential reference: with a ragged last block the
    reference kernel steps on through the block's padding rows, so its own
    s_last is NaN in interpret mode (and wrong on a TPU) — a fault of the
    reference that the port does not copy."""
    rng = np.random.default_rng(5)
    ins = _wkv_inputs(rng, 2, s, 2, 32)
    want_y, want_last = j_wkv_ops.wkv6(*(jnp.asarray(a) for a in ins),
                                       backend=backend, bs=16)
    _, seq_last = wkv6_ref(*(jnp.asarray(a) for a in ins))
    before = wkv6.launches
    y, last = wkv6(*(_t(a) for a in ins))
    assert wkv6.launches == before          # the plain version, no launch
    _close(y, want_y)
    _close(last, seq_last)
    if backend == "ref" or s % 16 == 0:
        _close(last, want_last)


def test_wkv6_chained_equals_one_pass():
    """The recurrence carried across calls: one pass over 48 steps equals
    calls over 16 and 32 chained through s_last, bit for bit — what lets
    layer-wise recompute (one pass over the prefix) reproduce the state
    that chunked prefill built."""
    ins = [_t(a) for a in _wkv_inputs(np.random.default_rng(6), 1, 48, 2, 32)]
    r, k, v, w, u, s0 = ins
    y, last = wkv6_plain(*ins)
    y1, mid = wkv6_plain(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u, s0)
    y2, last2 = wkv6_plain(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u, mid)
    assert torch.equal(last, last2)
    assert torch.equal(y, torch.cat([y1, y2], dim=1))


# ---------------------------------------------------------------------------
# The RWKV block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [16, 128])
@pytest.mark.parametrize("fn", ["time_mix", "channel_mix", "rwkv_layer_full"])
def test_rwkv_block_matches_reference(pair, fn, s):
    """A chunk from non-zero token shifts and wkv state.  At S = 16 the
    reference's time mix steps its sequential scan, at S = 128 its chunked
    scan."""
    cfg = pair["cfg"]
    jp, tp = _layer_params(pair, 1)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    stm, scm, wkv = _state(cfg, rng)
    if fn == "time_mix":
        want = j_rwkv.time_mix(cfg, jp["rwkv"], jnp.asarray(x), jnp.asarray(stm),
                               jnp.asarray(wkv))
        got = t_rwkv.time_mix(cfg, tp["rwkv"], _t(x), _t(stm), _t(wkv))
    elif fn == "channel_mix":
        want = j_rwkv.channel_mix(cfg, jp["rwkv"], jnp.asarray(x), jnp.asarray(scm))
        got = t_rwkv.channel_mix(cfg, tp["rwkv"], _t(x), _t(scm))
    else:
        want = j_tfm.rwkv_layer_full(cfg, jp, jnp.asarray(x), jnp.asarray(stm),
                                     jnp.asarray(scm), jnp.asarray(wkv))
        got = t_tfm.rwkv_layer_full(cfg, tp, _t(x), _t(stm), _t(scm), _t(wkv))
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


# ---------------------------------------------------------------------------
# Model entry points and caches
# ---------------------------------------------------------------------------


def _cache_to_torch(cache):
    return {f: _t(a) for f, a in cache.items()}


def _assert_cache(got, want, tol=TOL):
    assert got.keys() == want.keys() == set(STATE)
    for f in got:
        assert got[f].dtype == torch.float32          # f32 model: every field
        _close(got[f], want[f], tol)


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both packages after prefill_chunk of 24 tokens."""
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    toks = np.random.default_rng(4).integers(0, 512, (1, 24)).astype(np.int32)
    jl_, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jm.init_cache(1, 40), 0)
    tl_, tc = tm.prefill_chunk(tp, _t(toks), tm.init_cache(1, 40), 0)
    return dict(jl=jl_, jc=jc, tl=tl_, tc=tc)


@pytest.mark.parametrize("entry", ["prefill_chunk", "layer_chunk", "decode_step"])
def test_model_entry_points_match_reference(pair, prefilled, entry):
    """prefill_chunk over an empty cache; layer_chunk of one layer over the
    prefilled state; decode_step (C = 1) through all four layers."""
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    jc = prefilled["jc"]
    if entry == "prefill_chunk":
        _close(prefilled["tl"], prefilled["jl"], LOGIT_TOL)
        _assert_cache(prefilled["tc"], jc)
        return
    if entry == "decode_step":
        tok = np.argmax(np.asarray(prefilled["jl"]), axis=-1).astype(np.int32)
        jd, jc2 = jm.decode_step(jp, jnp.asarray(tok), jc, 24)
        td, tc2 = tm.decode_step(tp, _t(tok), _cache_to_torch(jc), 24)
        _close(td, jd, LOGIT_TOL)
        _assert_cache(tc2, jc2)
        return
    x = np.random.default_rng(8).standard_normal((1, 8, 128)).astype(np.float32)
    pos = np.arange(24, 32, dtype=np.int32)[None]
    jx, jc2 = jm.layer_chunk(jp, 2, jnp.asarray(x), jnp.asarray(pos), jc)
    tx, tc2 = tm.layer_chunk(tp, 2, _t(x), _t(pos), _cache_to_torch(jc))
    _close(tx, jx)
    _assert_cache(tc2, jc2)


def test_cache_helpers_carry_rwkv_state(pair, prefilled):
    """init_cache's RWKV fields (wkv f32, token shifts in the compute dtype);
    grow_cache, park_cache and unpark_cache carry them unchanged
    (length-free state)."""
    cfg, tm = pair["cfg"], pair["tm"]
    c0 = tm.init_cache(1, 40)
    assert set(c0) == set(STATE)
    assert tuple(c0["wkv"].shape) == (4, 1, 4, 32, 32) and c0["wkv"].dtype == torch.float32
    for f in ("shift_tm", "shift_cm"):
        assert tuple(c0[f].shape) == (4, 1, 128)
    c16 = Model(cfg, compute_dtype=torch.bfloat16, device="cpu").init_cache(1, 40)
    assert c16["wkv"].dtype == torch.float32 and c16["shift_tm"].dtype == torch.bfloat16
    tc = prefilled["tc"]
    grown = grow_cache(cfg, tc, 100)
    back = unpark_cache(park_cache(grown), "cpu")
    for f in STATE:
        assert torch.equal(grown[f], tc[f]) and torch.equal(back[f], tc[f])


# ---------------------------------------------------------------------------
# Restoration: layer-wise only
# ---------------------------------------------------------------------------


def _remembered(pair, stages):
    inputs = np.random.default_rng(9).integers(0, 512, (1, N)).astype(np.int32)
    jx = JExecutor(pair["jm"], pair["jp"], chunk_size=16, stages=stages)
    tx = RestorationExecutor(pair["tm"], pair["tp"], chunk_size=16, stages=stages)
    jx.remember("req", jnp.asarray(inputs))
    tx.remember("req", _t(inputs))
    return jx, tx


@pytest.mark.parametrize("stages", [1, 2])
def test_layerwise_restoration_matches_reference(pair, stages):
    """Both packages remember the same prefix and restore it with the same
    plans and op order; a token-wise request is turned layer-wise (token
    pointers do not apply to an attention-free model).  The port's restored
    state equals what its own ``remember`` built bit for bit (layer-wise
    recompute runs remember's chunks) and the reference's to rounding; the
    snapshots it stored equal the reference's."""
    jx, tx = _remembered(pair, stages)
    for key, snap in tx.store.get("req").state_snapshots.items():
        for f in STATE:
            _close(snap[f], jx.store.get("req").state_snapshots[key][f])
    plans = tx.make_plans("req", l_delta=0, strategy="token")
    assert [p.strategy for p in plans] == ["layer"] * stages
    jx.restore("req", strategy="token", op_order="alternate")
    tx.restore("req", strategy="token", op_order="alternate")
    errs = tx.verify("req")
    jx.verify("req")
    assert errs == {f: 0.0 for f in STATE}
    _assert_cache(tx.live_cache("req"), jx.live_cache("req"))


# ---------------------------------------------------------------------------
# The slice end to end: both serving engines
# ---------------------------------------------------------------------------

# prefix 16 is below l_delta and 48 above it: a model with attention would
# restore 48 token-wise; an attention-free one restores both layer-wise
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


def test_serve_schedule_identical_and_layerwise(served):
    """Identical ops logs and decode steps; every stage plan of every
    request layer-wise, the 48-token prefix past l_delta included."""
    j, t = served["jax"], served["torch"]
    assert t["res"].ops_log == j["res"].ops_log
    assert t["rep"].ttfts == j["rep"].ttfts
    assert t["res"].decode_steps == j["res"].decode_steps
    live = t["eng"].executor._live
    assert {rid: sorted({p.strategy for p in live[rid]["plans"].values()})
            for rid in live} == {"a": ["layer"], "b": ["layer"]}


def test_serve_outputs_match(served):
    je, te = served["jax"]["eng"], served["torch"]["eng"]
    for rid, _, _ in REQS:
        oj, ot = je.executor.outputs(rid), te.executor.outputs(rid)
        assert ot["tokens"] == oj["tokens"] and len(ot["tokens"]) == 16
        _close(ot["first_logits"], oj["first_logits"], LOGIT_TOL)


def test_serve_restored_state_verified(served):
    """serve(verify=True) raised on mismatch; every request verified the
    three RWKV state fields exactly, and the stored ground truth matches the
    reference's."""
    je, te = served["jax"]["eng"], served["torch"]["eng"]
    assert set(te.executor.verify_errs) == {rid for rid, _, _ in REQS}
    for rid, _, _ in REQS:
        assert te.executor.verify_errs[rid] == {f: 0.0 for f in STATE}
        _assert_cache(te.executor.store.get(rid).kv_reference,
                      je.executor.store.get(rid).kv_reference)
