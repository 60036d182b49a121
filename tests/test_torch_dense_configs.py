"""The five dense configs the port added, held to the JAX reference on the
CPU: phi4-mini-3.8b (G 3, tied embeddings), qwen1.5-0.5b (head_dim 64, MHA,
QKV bias, tied embeddings), qwen1.5-110b (G 8, QKV bias),
mistral-large-123b (G 12) and llama3.1-8b (RoPE theta 500000).

Each runs ``.reduced()`` with overrides that keep its own trait.  Both
``init``s make the QKV biases zero, which would hide a fault in them, so the
test draws them from N(0, 0.5) with numpy and hands the same values to
both packages.  The chunk (C > 1 over an empty cache), suffix prefill (C > 1
over a filled one) and decode (C = 1) entry points give the reference's
logits and caches within ATOL = 1e-5 (f32 on the CPU: two libraries' f32
kernels differ in the last bits), kpos exactly; a short ``RealServingEngine``
serve from a chunk store (one token-wise request: both pointers restore,
then suffix prefill and decode; ``tests/test_torch_serving.py`` covers the
layer-wise plan on qwen3-8b) gives the reference's ops log, dispatch counts
and greedy tokens.  The reference's first serve of each model is mostly JAX
compiling it, so one request keeps the file near a minute alone.
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
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.serving import ChunkStore, RealServingEngine, Request  # noqa: E402
from test_torch_serving import _capture_results, j_core, t_core  # noqa: E402

ATOL = 1e-5
# arch -> .reduced() overrides that keep its trait (d_model 128)
OVERRIDES = {
    "phi4-mini-3.8b": dict(num_heads=6, num_kv_heads=2),
    "qwen1.5-0.5b": dict(num_heads=2, num_kv_heads=2, head_dim=64),
    "qwen1.5-110b": dict(num_heads=8, num_kv_heads=1),
    "mistral-large-123b": dict(num_heads=12, num_kv_heads=1),
    "llama3.1-8b": {},
}
# arch -> (G, head_dim, QKV bias, tied embeddings, RoPE theta)
TRAITS = {
    "phi4-mini-3.8b": (3, 32, False, True, 10_000.0),
    "qwen1.5-0.5b": (1, 64, True, True, 10_000.0),
    "qwen1.5-110b": (8, 32, True, False, 10_000.0),
    "mistral-large-123b": (12, 32, False, False, 1_000_000.0),
    "llama3.1-8b": (2, 32, False, False, 500_000.0),
}


def _with_biases(tree, rng):
    """The numpy tree with every bq/bk/bv drawn from N(0, 0.5)."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32)
                    if k in ("bq", "bk", "bv") else _with_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_biases(v, rng) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module", params=sorted(OVERRIDES))
def pair(request):
    arch = request.param
    cfg_j = jax_get_config(arch).reduced(**OVERRIDES[arch])
    cfg_t = get_config(arch).reduced(**OVERRIDES[arch])
    jm = build_model(cfg_j)
    tree = _with_biases(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                        np.random.default_rng(1))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = Model(cfg_t, device="cpu")
    tp = params_from_jax(tree, device="cpu")
    return dict(arch=arch, cfg=cfg_t, jm=jm, jp=jp, tm=tm, tp=tp)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _assert_cache(tc, jc):
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    for f in ("k", "v"):
        _close(tc[f], jc[f])


def test_reduced_config_keeps_its_trait(pair):
    cfg, arch = pair["cfg"], pair["arch"]
    g, dh, bias, tied, theta = TRAITS[arch]
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, cfg.use_qkv_bias,
            cfg.tie_embeddings, cfg.rope_theta) == (g, dh, bias, tied, theta)
    layer = pair["tp"]["layers"][0]
    biases = [layer["attn"][b] for b in ("bq", "bk", "bv") if b in layer["attn"]]
    assert len(biases) == (3 if bias else 0)
    assert all(float(b.abs().min()) > 0 for b in biases)
    assert ("unembed" in pair["tp"]) == (not tied)


def test_chunk_suffix_and_decode_logits_match_reference(pair):
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    vocab = pair["cfg"].vocab_size
    rng = np.random.default_rng(4)
    toks = rng.integers(0, vocab, (1, 24)).astype(np.int32)
    jc, tc = jm.init_cache(1, 40), tm.init_cache(1, 40)
    jl_, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jc, 0)
    tl_, tc = tm.prefill_chunk(tp, torch.from_numpy(toks), tc, 0)
    _close(tl_, jl_)
    _assert_cache(tc, jc)
    suffix = rng.integers(0, vocab, (1, 8)).astype(np.int32)
    jl_, jc = jm.prefill_chunk(jp, jnp.asarray(suffix), jc, 24)
    tl_, tc = tm.prefill_chunk(tp, torch.from_numpy(suffix), tc, 24)
    _close(tl_, jl_)
    _assert_cache(tc, jc)
    tok = np.argmax(np.asarray(jl_), axis=-1).astype(np.int32)
    assert int(torch.argmax(tl_, dim=-1)[0]) == int(tok[0])
    jd, jc = jm.decode_step(jp, jnp.asarray(tok), jc, 32)
    td, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, 32)
    _close(td, jd)
    _assert_cache(tc, jc)


ENGINE_KW = dict(system="cacheflow", stages=2, chunk_size=16, l_delta=32,
                 max_batch=2, io_channels=1, datapath="fused")


def test_short_serve_same_schedule_and_tokens(pair):
    """One token-wise request from an unquantized chunk store (synthetic
    durations, so both engines take the same decisions)."""
    js = JChunkStore(chunk_size=8, quant="none", default_tier="host")
    je = JEngine(pair["jm"], pair["jp"], kvstore=js, **ENGINE_KW)
    ts = ChunkStore(chunk_size=8, quant="none", default_tier="host", device="cpu")
    te = RealServingEngine(pair["tm"], pair["tp"], kvstore=ts, device="cpu", **ENGINE_KW)
    te._inputs = lambda n: torch.from_numpy(np.array(je._inputs(n)))
    reps, results = {}, {}
    for tag, eng, req, mod in (("jax", je, JRequest, j_core), ("torch", te, Request, t_core)):
        reqs = [req("a", 0.0, 32, 8, decode_len=3)]
        sink = []
        with _capture_results(mod, sink):
            reps[tag] = eng.serve(reqs, verify=True, op_order="alternate")
        results[tag] = sink[0]
    assert results["torch"].ops_log == results["jax"].ops_log
    assert reps["torch"].ttfts == reps["jax"].ttfts
    assert te.datapath.kernel_launches == je.datapath.kernel_launches
    assert te.executor.load_dispatches == je.executor.load_dispatches
    assert te.datapath.resident_copies == je.datapath.resident_copies
    assert te.executor.fused_loads == je.executor.fused_loads > 0
    tokens = te.executor.outputs("a")["tokens"]
    assert tokens == je.executor.outputs("a")["tokens"] and len(tokens) == 3
    assert te.executor.verify_errs["a"]["kpos"] == 0.0
    assert te.executor._live["a"]["plans"][0].strategy == "token"
