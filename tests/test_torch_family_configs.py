"""The MoE, MLA and embedding-input configs, held to the JAX reference on
the CPU: qwen3-30b-a3b (MoE, no shared expert, qk-norm, G 2),
deepseek-moe-16b (MoE with a shared expert after a dense first layer),
deepseek-v2-236b (MLA with its latent cache, then MoE), pixtral-12b
(embedding input, RoPE) and musicgen-large (embedding input, sinusoidal
positions, LayerNorm and GELU).  Each runs ``.reduced()`` in f32 with the
reference's weights (``params_from_jax``) and inputs made with numpy from a
seed.

* The chunk (C > 1 over an empty cache), suffix prefill (C > 1 over a
  filled one) and decode (C = 1) entry points give the reference's logits
  and cache fields (k/v, or ckv) within 1e-5, kpos exactly.
* A one-request token-wise ``RealServingEngine`` serve from a chunk store
  (both pointers restore, then suffix prefill and decode) gives the
  reference's ops log and dispatch counts, and verifies.  The three token
  models also give its greedy tokens.  The two embedding models feed decode
  a pseudo-embedding drawn from a generator seeded with the position, which
  cannot equal JAX's bits, so their decode tokens are not compared; their
  first-token logits (suffix prefill over identical inputs) are, within
  1e-5.  deepseek-v2-236b is served once more from an int8 store, so its
  576-channel-wide row at full width (here 48) goes through the quantizer,
  the transfer run and the dequantizing scatter.
* Token- and layer-wise restoration of a remembered prefix verifies on
  every one of the five, as ``tests/test_restoration.py`` does for the
  reference.
* The store kernels at the full-width rows these configs give them (k/v
  rows of 512 channels, the 576-channel latent): ``rows_plan`` and
  ``quant_plan`` cover every row and unit once in 16-byte units, and the
  kernels' decompositions walked in plain torch equal their plain
  versions by ``torch.equal``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import ChunkStore as JChunkStore  # noqa: E402
from repro.serving import RealServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RestorationExecutor  # noqa: E402
from repro_torch.kernels.kv_quant import (kv_dequantize_plain, kv_dequantize_plan,  # noqa: E402
                                          kv_quantize_plain, quant_plan)
from repro_torch.kernels.kv_restore import (kv_restore_plain, kv_restore_plan,  # noqa: E402
                                            rows_plan)
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.serving import ChunkStore, RealServingEngine, Request  # noqa: E402
from test_torch_kv_quant import _kernel_rows_cover, emulate  # noqa: E402
from test_torch_kv_restore import coverage, walk  # noqa: E402
from test_torch_serving import _capture_results, j_core, t_core  # noqa: E402

ATOL = 1e-5
# arch -> the cache fields of its attention layers
ARCHS = {
    "qwen3-30b-a3b": ("k", "v"),
    "deepseek-moe-16b": ("k", "v"),
    "deepseek-v2-236b": ("ckv",),
    "pixtral-12b": ("k", "v"),
    "musicgen-large": ("k", "v"),
}


def _make_pair(arch):
    cfg_j = jax_get_config(arch).reduced()
    cfg_t = get_config(arch).reduced()
    jm = build_model(cfg_j)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return dict(arch=arch, cfg=cfg_t, jm=jm, jp=jax.tree.map(jnp.asarray, tree),
                tm=Model(cfg_t, device="cpu"), tp=params_from_jax(tree, device="cpu"))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    return _make_pair(request.param)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _inputs(cfg, rng, n):
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
    return rng.normal(size=(1, n, cfg.d_model)).astype(np.float32)


def _assert_cache(tc, jc, fields):
    assert sorted(tc) == sorted(fields + ("kpos",))
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    for f in fields:
        _close(tc[f], jc[f])


def test_params_convert_to_the_ports_layout(pair):
    """The converted tree has the port's own ``init`` structure and shapes,
    no embed table for an embedding-input model, the dense first layer of
    the DeepSeek configs, and the same parameter count."""
    cfg, tp = pair["cfg"], pair["tp"]
    own = pair["tm"].init(torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(tp) == shapes(own)
    assert ("embed" in tp) == (cfg.input_mode == "tokens")
    kinds = ["moe" if "moe" in p else "mlp" for p in tp["layers"]]
    first_dense = cfg.moe.first_k_dense if cfg.moe is not None else cfg.num_layers
    assert kinds == ["mlp"] * first_dense + ["moe"] * (cfg.num_layers - first_dense)
    assert pair["tm"].num_params(tp) == pair["jm"].num_params(pair["jp"])


def test_chunk_suffix_and_decode_logits_match_reference(pair):
    """The reference's entry points run under ``jax.jit`` (one compile of
    the whole stack instead of one per operation: the same model, seconds
    instead of tens of seconds on the MoE configs)."""
    jm, jp, tm, tp, cfg = pair["jm"], pair["jp"], pair["tm"], pair["tp"], pair["cfg"]
    fields = ARCHS[pair["arch"]]
    rng = np.random.default_rng(4)
    x = _inputs(cfg, rng, 24)
    prefill_chunk, decode_step = jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(1, 40), tm.init_cache(1, 40)
    jl_, jc = prefill_chunk(jp, jnp.asarray(x), jc, 0)
    tl_, tc = tm.prefill_chunk(tp, torch.from_numpy(x), tc, 0)
    _close(tl_, jl_)
    _assert_cache(tc, jc, fields)
    suffix = _inputs(cfg, rng, 8)
    jl_, jc = prefill_chunk(jp, jnp.asarray(suffix), jc, 24)
    tl_, tc = tm.prefill_chunk(tp, torch.from_numpy(suffix), tc, 24)
    _close(tl_, jl_)
    _assert_cache(tc, jc, fields)
    if cfg.input_mode == "tokens":
        step = np.argmax(np.asarray(jl_), axis=-1).astype(np.int32)
        assert int(torch.argmax(tl_, dim=-1)[0]) == int(step[0])
    else:
        step = rng.normal(size=(1, cfg.d_model)).astype(np.float32)
    jd, jc = decode_step(jp, jnp.asarray(step), jc, 32)
    td, tc = tm.decode_step(tp, torch.from_numpy(step), tc, 32)
    _close(td, jd)
    _assert_cache(tc, jc, fields)


ENGINE_KW = dict(system="cacheflow", stages=2, chunk_size=16, l_delta=32,
                 max_batch=2, io_channels=1, datapath="fused")


def _serve_both(pair, quant):
    js = JChunkStore(chunk_size=8, quant=quant, default_tier="host")
    je = JEngine(pair["jm"], pair["jp"], kvstore=js, **ENGINE_KW)
    ts = ChunkStore(chunk_size=8, quant=quant, default_tier="host", device="cpu")
    te = RealServingEngine(pair["tm"], pair["tp"], kvstore=ts, device="cpu", **ENGINE_KW)
    te._inputs = lambda n: torch.from_numpy(np.array(je._inputs(n)))
    reps, results = {}, {}
    for tag, eng, req, mod in (("jax", je, JRequest, j_core), ("torch", te, Request, t_core)):
        sink = []
        with _capture_results(mod, sink):
            reps[tag] = eng.serve([req("a", 0.0, 32, 8, decode_len=3)], verify=True,
                                  op_order="alternate")
        results[tag] = sink[0]
    assert results["torch"].ops_log == results["jax"].ops_log
    assert reps["torch"].ttfts == reps["jax"].ttfts
    assert te.datapath.kernel_launches == je.datapath.kernel_launches
    assert te.executor.load_dispatches == je.executor.load_dispatches
    assert te.datapath.resident_copies == je.datapath.resident_copies
    assert te.executor.fused_loads == je.executor.fused_loads > 0
    assert te.executor._live["a"]["plans"][0].strategy == "token"
    errs = te.executor.verify_errs["a"]
    assert sorted(errs) == sorted(ARCHS[pair["arch"]] + ("kpos",))
    assert errs["kpos"] == 0.0
    return je, te


def test_short_serve_same_schedule_and_outputs(pair):
    """One token-wise request from an unquantized chunk store (synthetic
    durations, so both engines take the same decisions).  Greedy tokens of
    the token models; the first-token logits of every model."""
    je, te = _serve_both(pair, "none")
    t_out, j_out = te.executor.outputs("a"), je.executor.outputs("a")
    _close(t_out["first_logits"], j_out["first_logits"])
    assert len(t_out["tokens"]) == 3
    assert t_out["tokens"][0] == j_out["tokens"][0]
    if pair["cfg"].input_mode == "tokens":
        assert t_out["tokens"] == j_out["tokens"]


def test_mla_serve_from_an_int8_store():
    """deepseek-v2-236b's latent rows through the int8 store: the same
    schedule and launches as the reference, verified within the store's
    quantization tolerance."""
    je, te = _serve_both(_make_pair("deepseek-v2-236b"), "int8")
    assert te.kvstore.quant == "int8" and te.executor.verify_errs["a"]["ckv"] > 0
    assert te.datapath.kernel_launches > 0


@pytest.mark.parametrize("strategy", ["token", "layer"])
def test_restoration_matches_prefill(pair, strategy):
    cfg = pair["cfg"]
    ex = RestorationExecutor(pair["tm"], pair["tp"], chunk_size=8, stages=1)
    ex.remember("req", torch.from_numpy(_inputs(cfg, np.random.default_rng(5), 40)))
    ex.restore("req", strategy=strategy, op_order="alternate")
    errs = ex.verify("req")
    assert sorted(errs) == sorted(ARCHS[pair["arch"]] + ("kpos",))


# ---------------------------------------------------------------------------
# The store kernels at the widths these configs give them: qwen3-30b-a3b's
# k/v rows of 4 x 128 = 512 channels (48 slots), deepseek-v2-236b's latent
# row of 512 + 64 = 576 channels (36 sixteen-channel units)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,fields", [(512, 2), (576, 1)])
def test_rows_plan_covers_the_family_widths(c, fields):
    """Rows 1-300 of 2 slots (and the serve's 256-row op over 24 of 48
    slots / 2 of 4): each (field, row, unit) once, in 16-channel units."""
    for rows in list(range(1, 301, 7)) + [256]:
        p = rows_plan([c] * fields, rows, 2)
        assert p.unit == 16
        for counts in coverage(p, [c] * fields, rows):
            assert counts.shape == (rows, c // 16) and (counts == 1).all(), (rows, p)
    serve = rows_plan([c] * fields, 256, 24 if fields == 2 else 2)
    assert serve.unit == 16 and serve.grid[1:] == (24 if fields == 2 else 2, fields)


@pytest.mark.parametrize("shape", [(48, 1, 16, 4, 128), (4, 1, 16, 576), (60, 1, 16, 576),
                                   (4, 1, 10, 576)])
def test_quant_plan_and_walk_at_the_family_chunks(shape):
    """qwen3-30b-a3b's 16-token chunk of one field (C 128 over 3072 rows),
    deepseek-v2-236b's latent chunk at the served depth (4 layers), at full
    depth (60) and its 10-token tail: the plan covers every row once in
    16-byte units from slabs that fit, and the kernel's arithmetic walked in
    torch equals the plain version by ``torch.equal``."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.standard_normal(shape) * 2.5).astype(np.float32)).bfloat16()
    c = shape[-1]
    r = x.numel() // c
    p = quant_plan(r, c, 2)
    assert p.vec == 8 and p.slab and p.n * p.rows_per >= r
    _kernel_rows_cover(r, c, p)
    q, s, _ = emulate(x)
    qp, sp = kv_quantize_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("c,fields,slots", [(512, 2, 48), (576, 1, 4)])
def test_restore_and_dequantize_walks_at_the_family_widths(c, fields, slots):
    """kv_restore (int8 and raw) and the run form of kv_dequantize walked
    from their plans at C 512 / 576 equal their plain versions."""
    rng = np.random.default_rng(c)
    s_len, t, cs, t0 = 96, 40, 16, 32
    caches = [torch.from_numpy(rng.standard_normal((slots, s_len, c)).astype(np.float32))
              .bfloat16() for _ in range(fields)]
    q = [torch.from_numpy(rng.integers(-127, 128, (slots, t, c)).astype(np.int8))
         for _ in range(fields)]
    scl = [torch.from_numpy((rng.random((-(-t // cs), c)) * 0.1).astype(np.float32))
           for _ in range(fields)]
    raw = [torch.from_numpy(rng.standard_normal((slots, t, c)).astype(np.float32)).bfloat16()
           for _ in range(fields)]
    for staged, scales in ((q, scl), (raw, None)):
        kw = dict(t0=t0, slot_lo=0, n_slots=slots, chunk_size=cs)
        plan = kv_restore_plan(caches, staged, scales, **kw)
        assert plan.unit == 16
        got = [x.clone() for x in caches]
        walk(plan, lambda f, slot, ch, r0, r1: got[f][slot, t0 + r0:t0 + r1], staged,
             scales, 0, t, cs)
        want = kv_restore_plain([x.clone() for x in caches], staged, scales, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    plan = kv_dequantize_plan(q, scl, torch.bfloat16, chunk_size=cs)
    assert plan.unit == 16
    out = [[torch.empty(slots, min(cs, t - ch * cs), c, dtype=torch.bfloat16)
            for ch in range(-(-t // cs))] for _ in range(fields)]
    walk(plan, lambda f, slot, ch, r0, r1: out[f][ch][slot, r0 - ch * cs:r1 - ch * cs],
         q, scl, 0, t, cs)
    want = kv_dequantize_plain(q, scl, torch.bfloat16, chunk_size=cs)
    for o, w in zip(out, want):
        assert len(o) == len(w) and all(torch.equal(a, b) for a, b in zip(o, w))
