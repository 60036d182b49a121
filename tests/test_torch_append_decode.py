"""The reference's remaining model entry points in the port, held to the
JAX package on the CPU, f32, at reduced configs on converted weights
(``params_from_jax`` of the reference's ``Model.init``):

* append-buffer decode (``init_tail``, ``decode_step_append``): a prefix
  prefilled by both packages, then greedy steps whose new KV lands in a
  tail of W slots while attention runs over [cache || tail] — the logits of
  every step, the greedy tokens (equal) and the tail's fields after the
  last step; for qwen3-8b (GQA, ``flash_decode``'s plain version) and for
  deepseek-v2-236b (MLA, ``mla_attend_absorbed``) made uniform by
  ``first_k_dense=0`` in both packages; the port's append decode also
  against its own ``decode_step`` writing the same tokens into a grown
  cache; the refusal of configs that are not a uniform attention stack;
* ``Model(moe_groups=2)`` (``apply_moe``'s ``num_groups`` through the full
  and cached layers): ``forward`` logits and aux, and two ``prefill_chunk``
  calls, for qwen3-30b-a3b;
* the GShard one-hot dispatch (``DISPATCH = "einsum"``, the capacity path
  only), switched on in both packages' modules by ``monkeypatch``:
  ``moe_group`` and a capacity-path ``Model.forward``.

The reference's entry points run under ``jax.jit`` (a fresh function for
each, so no trace of another test's ``DISPATCH`` is reused); none reaches a
Pallas kernel.  Tolerances, ``max |port - reference| <= tol * max(1, max
|reference|)``: LOGIT_TOL = 1e-4 for logits after the stack (as
``tests/test_torch_forward.py``), TOL = 1e-5 for caches, tails and one MoE
layer's output, AUX_TOL = 1e-6 absolute for the aux loss; kpos and greedy
tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.kvcache import grow_cache  # noqa: E402

LOGIT_TOL = 1e-4
TOL = 1e-5
AUX_TOL = 1e-6
B, PREFIX, W, STEPS = 2, 24, 8, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    bound = tol * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _uniform(cfg):
    """deepseek-v2-236b's MLA stack without its dense first layer."""
    if cfg.moe is not None and cfg.moe.first_k_dense:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, first_k_dense=0))
    return cfg


def _pair(arch, change=lambda c: c, **model_kw):
    cfg_j, cfg_t = change(j_get_config(arch).reduced()), change(get_config(arch).reduced())
    jm = j_build(cfg_j, **model_kw)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(cfg_t, device="cpu", **model_kw)
    return cfg_t, jm, jax.tree.map(jnp.asarray, tree), tm, params_from_jax(tree, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b"])
def test_append_decode_matches_reference(arch):
    """Greedy steps into a tail of W slots after a PREFIX-token prefill:
    every step's logits within LOGIT_TOL and its greedy token equal; the
    tail's fields within TOL (kpos equal, the unwritten slots still -1)."""
    cfg, jm, jp, tm, tp = _pair(arch, _uniform)
    assert cfg.is_uniform
    x = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, PREFIX)).astype(np.int32)
    jlast, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(x))
    with torch.no_grad():
        tlast, tcache = tm.prefill(tp, torch.from_numpy(x))
    _close(tlast, jlast, LOGIT_TOL)
    jtail, ttail = jm.init_tail(B, W), tm.init_tail(B, W)
    assert set(ttail) == set(jtail)
    step = jax.jit(jm.decode_step_append)
    tok = np.asarray(jnp.argmax(jlast, axis=-1)).astype(np.int32)
    for i in range(STEPS):
        jl, jtail = step(jp, jnp.asarray(tok), jcache, jtail, i, PREFIX + i)
        with torch.no_grad():
            tl, ttail = tm.decode_step_append(tp, torch.from_numpy(tok), tcache, ttail, i,
                                              PREFIX + i)
        _close(tl, jl, LOGIT_TOL)
        jtok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), jtok), i
        tok = jtok
    for f in jtail:
        if f == "kpos":
            assert np.array_equal(ttail[f].numpy(), np.asarray(jtail[f]))
        else:
            _close(ttail[f], jtail[f])
    want_kpos = [PREFIX + i for i in range(STEPS)] + [-1] * (W - STEPS)
    assert ttail["kpos"].tolist() == [want_kpos] * cfg.num_layers


def test_append_decode_equals_decode_step_into_a_grown_cache():
    """The port's append decode over [cache || tail] against its own
    ``decode_step`` writing the same tokens into the prefix cache grown by
    W slots: logits within TOL and greedy tokens equal at every step; the
    prefix cache is left as it was."""
    cfg, _, _, tm, tp = _pair("qwen3-8b")
    x = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, PREFIX)))
    with torch.no_grad():
        last, cache = tm.prefill(tp, x)
        before = {f: t.clone() for f, t in cache.items()}
        grown = grow_cache(cfg, {f: t.clone() for f, t in cache.items()}, PREFIX + W)
        tail = tm.init_tail(B, W)
        tok = last.argmax(-1)
        for i in range(W):
            la, tail = tm.decode_step_append(tp, tok, cache, tail, i, PREFIX + i)
            ld, grown = tm.decode_step(tp, tok, grown, PREFIX + i)
            _close(la, ld)
            assert torch.equal(la.argmax(-1), ld.argmax(-1)), i
            tok = ld.argmax(-1)
    assert all(torch.equal(cache[f], before[f]) for f in before)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "recurrentgemma-2b", "rwkv6-7b"])
def test_append_decode_refuses_a_stack_that_is_not_uniform_attention(arch):
    """A dense first layer (deepseek-v2-236b as registered), a hybrid and
    an attention-free stack are refused before anything runs; the
    reference refuses the first by its assertion."""
    cfg = get_config(arch).reduced()
    tm = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="uniform attention stack"):
        tm.decode_step_append({}, torch.zeros(B, dtype=torch.long), {}, {}, 0, 0)
    if arch == "deepseek-v2-236b":
        jm = j_build(j_get_config(arch).reduced())
        with pytest.raises(AssertionError, match="uniform scan stack"):
            jm.decode_step_append({}, jnp.zeros((B,), jnp.int32), {}, {}, 0, 0)


def test_moe_groups_forward_and_prefill_chunk_match_reference():
    """qwen3-30b-a3b with ``moe_groups=2`` in both packages: ``forward``
    logits and aux (the groups' mean, unlike one group's), and two chunks
    of 8 through ``prefill_chunk`` (last logits and the cache)."""
    cfg, jm, jp, tm, tp = _pair("qwen3-30b-a3b", moe_groups=2)
    assert tm.moe_groups == 2
    x = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jl, jaux = jax.jit(lambda p, t: jm.forward(p, t))(jp, jnp.asarray(x))
    with torch.no_grad():
        tl, taux = tm.forward(tp, torch.from_numpy(x))
        _, aux_one = build_model(cfg, device="cpu").forward(tp, torch.from_numpy(x))
    _close(tl, jl, LOGIT_TOL)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    assert abs(float(aux_one) - float(taux)) > 10 * AUX_TOL
    jchunk = jax.jit(lambda p, t, c, s: jm.prefill_chunk(p, t, c, s))
    jcache, tcache = jm.init_cache(B, 16), tm.init_cache(B, 16)
    for c0 in (0, 8):
        jlast, jcache = jchunk(jp, jnp.asarray(x[:, c0:c0 + 8]), jcache, c0)
        with torch.no_grad():
            tlast, tcache = tm.prefill_chunk(tp, torch.from_numpy(x[:, c0:c0 + 8]), tcache, c0)
        _close(tlast, jlast, LOGIT_TOL)
    for f in ("k", "v"):
        _close(tcache[f], jcache[f])
    assert np.array_equal(tcache["kpos"].numpy(), np.asarray(jcache["kpos"]))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-30b-a3b"])
def test_einsum_dispatch_matches_reference(arch, monkeypatch):
    """``DISPATCH = "einsum"`` in both modules, on the capacity path at the
    reduced config's capacity 1.25 (cap 20 slots an expert for 64 tokens,
    so pairs drop): ``moe_group`` y within TOL and aux within AUX_TOL of the
    reference's ``_moe_group_einsum``, and within TOL of the port's own
    scatter dispatch; the dropless path is not switched."""
    monkeypatch.setattr(j_moe, "DISPATCH", "einsum")
    monkeypatch.setattr(t_moe, "DISPATCH", "einsum")
    cfg_j, cfg_t = j_get_config(arch).reduced(), get_config(arch).reduced()
    assert cfg_t.moe.capacity_factor == cfg_j.moe.capacity_factor > 0
    tree = jax.tree.map(np.asarray, j_moe.init_moe(jax.random.PRNGKey(3), cfg_j, jnp.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    x = np.random.default_rng(8).normal(size=(64, cfg_t.d_model)).astype(np.float32)
    jy, jaux = j_moe.moe_group(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), cfg_j.moe,
                               cfg_j.activation)
    ty, taux = t_moe.moe_group(tp, torch.from_numpy(x), cfg_t.moe, cfg_t.activation,
                               dropless=False)
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    dropless, _ = t_moe.moe_group(tp, torch.from_numpy(x), cfg_t.moe, cfg_t.activation)
    assert float((dropless - ty).abs().max()) > 1e-3       # some pairs were dropped
    monkeypatch.setattr(t_moe, "DISPATCH", "scatter")
    scatter, saux = t_moe.moe_group(tp, torch.from_numpy(x), cfg_t.moe, cfg_t.activation,
                                    dropless=False)
    _close(ty, scatter)
    assert abs(float(taux) - float(saux)) <= AUX_TOL


def test_einsum_dispatch_through_a_capacity_model_matches_reference(monkeypatch):
    """A ``moe_dropless=False`` model (the capacity path) of
    deepseek-moe-16b under ``DISPATCH = "einsum"`` in both packages:
    ``forward`` logits within LOGIT_TOL and aux within AUX_TOL."""
    monkeypatch.setattr(j_moe, "DISPATCH", "einsum")
    monkeypatch.setattr(t_moe, "DISPATCH", "einsum")
    cfg, jm, jp, tm, tp = _pair("deepseek-moe-16b", moe_dropless=False)
    x = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 32)).astype(np.int32)
    jl, jaux = jax.jit(lambda p, t: jm.forward(p, t))(jp, jnp.asarray(x))
    with torch.no_grad():
        tl, taux = tm.forward(tp, torch.from_numpy(x))
    _close(tl, jl, LOGIT_TOL)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL


def test_capacity_model_caches_through_the_capacity_path():
    """A ``moe_dropless=False`` model (deepseek-moe-16b) keeps the capacity
    path in its cached entry points, as the reference's: ``prefill_chunk``
    and ``decode_step`` logits within LOGIT_TOL of the reference's on the
    same weights and tokens, the cache's fields within LOGIT_TOL."""
    from repro.models.kvcache import init_cache as j_init_cache
    cfg, jm, jp, tm, tp = _pair("deepseek-moe-16b", moe_dropless=False)
    x = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jcache = j_init_cache(jm.cfg, B, 32, jnp.float32)
    jl, jcache = jax.jit(jm.prefill_chunk)(jp, jnp.asarray(x), jcache, 0)
    tcache = tm.init_cache(B, 32)
    with torch.no_grad():
        tl, tcache = tm.prefill_chunk(tp, torch.from_numpy(x), tcache, 0)
    _close(tl, jl, LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    jl, jcache = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jcache, 16)
    with torch.no_grad():
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache, 16)
    _close(tl, jl, LOGIT_TOL)
    for f in ("k", "v"):
        _close(tcache[f], jcache[f], LOGIT_TOL)
