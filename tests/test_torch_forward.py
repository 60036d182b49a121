"""The port's whole-sequence path (``Model.forward``, ``Model.prefill``,
``attention_full``, ``mla_full``, the MoE capacity path) held to the JAX
reference on the CPU, f32, at every reduced config of the registry, and
``Model.forward`` past the 8192 keys above which the attention is blocked.

Weights: the reference's ``Model.init`` (or ``init_attention`` /
``init_mla`` / ``init_moe``) as numpy, through ``params_from_jax``; inputs:
numpy from a seed.  The reference's model runs under ``jax.jit`` with
``backend="auto"``, as its own tests run it: its full path reaches no
Pallas kernel (the masked softmax, the blocked scan, ``lru_scan``, the wkv
scans), so neither does this file.

Tolerances, each ``max |port - reference| <= tol * max(1, max |reference|)``:
TOL = 1e-5 for one layer's output, caches and states (two libraries' f32
exp/rsqrt and summation orders differ in the last bits); LOGIT_TOL = 1e-4
for logits after the whole stack and the 512-way unembedding (the RWKV
stack lands 1e-5 from the reference: its chunked scan sums in another
order); AUX_TOL = 1e-6 absolute for the MoE aux loss; kpos exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import mla as j_mla  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import mla as t_mla  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.kvcache import grow_cache  # noqa: E402

TOL = 1e-5
LOGIT_TOL = 1e-4
AUX_TOL = 1e-6
B, S = 2, 16
# the reference's prefill/decode consistency test's archs
CONSISTENCY = ("qwen3-8b", "deepseek-moe-16b", "recurrentgemma-2b", "rwkv6-7b",
               "musicgen-large")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores, and small CPU ops slow down many times over when each
    process's thread pool spans them all."""
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


def _inputs(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    return rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=ALL_ARCHS)
def pair(request):
    arch = request.param
    cfg_j, cfg_t = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm = j_build(cfg_j)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    x = _inputs(cfg_t, 1)
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jaux = jax.jit(jm.forward)(jp, jnp.asarray(x))
    jlast, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(x))
    tm = build_model(cfg_t, device="cpu")
    tp = params_from_jax(tree, device="cpu")
    return dict(arch=arch, cfg=cfg_t, x=x, tm=tm, tp=tp, jl=jl, jaux=jaux,
                jlast=jlast, jcache=jcache, tree=tree)


def test_forward_logits_and_aux_match_reference(pair):
    with torch.no_grad():
        tl, taux = pair["tm"].forward(pair["tp"], torch.from_numpy(pair["x"]))
    assert tl.shape == (B, S, pair["cfg"].vocab_size)
    _close(tl, pair["jl"], LOGIT_TOL)
    assert abs(float(taux) - float(pair["jaux"])) <= AUX_TOL
    assert (float(taux) > 0) == (pair["cfg"].moe is not None)


def test_run_layer_full_matches_reference(pair):
    """Layer 0 alone from fresh state (attention, recurrent or RWKV by
    arch), as the reference's ``run_layer_full``: output and entry/state."""
    tm, tp = pair["tm"], pair["tp"]
    with torch.no_grad():
        x0 = tm.embed(tp, torch.from_numpy(pair["x"]), tm.positions_of(B, S))
        tx, tentry = tm.run_layer_full(tp, 0, x0, tm.positions_of(B, S))
    jm = j_build(j_get_config(pair["arch"]).reduced())
    jp = jax.tree.map(jnp.asarray, pair["tree"])
    jx, jentry = jm.run_layer_full(jp, 0, jnp.asarray(x0.numpy()),
                                   jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S)))
    _close(tx, jx)
    t_flat = list(tentry.values()) if isinstance(tentry, dict) else list(tentry)
    j_flat = list(jentry.values()) if isinstance(jentry, dict) else list(jentry)
    for got, want in zip(t_flat, j_flat, strict=True):
        _close(got, want)


def test_prefill_last_logits_and_cache_match_reference(pair):
    with torch.no_grad():
        last, cache = pair["tm"].prefill(pair["tp"], torch.from_numpy(pair["x"]))
    _close(last, pair["jlast"], LOGIT_TOL)
    assert sorted(cache) == sorted(pair["jcache"])
    for f, want in pair["jcache"].items():
        if f == "kpos":
            np.testing.assert_array_equal(cache[f].numpy(), np.asarray(want))
        else:
            _close(cache[f], want)


@pytest.mark.parametrize("arch", CONSISTENCY)
def test_prefill_decode_consistency(arch):
    """The reference's consistency check on the port alone: prefill's last
    logits equal forward's last; a decode step from the prefill cache gives
    the logits forward gives one token further (LOGIT_TOL)."""
    cfg = get_config(arch).reduced()
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_inputs(cfg, 2, S + 1))
    with torch.no_grad():
        full, _ = m.forward(p, x)
        last, cache = m.prefill(p, x[:, :S])
        _close(last, full[:, S - 1], LOGIT_TOL)
        nxt, _ = m.decode_step(p, x[:, S], grow_cache(cfg, cache, S + 1), S)
    _close(nxt, full[:, S], LOGIT_TOL)


def test_windowed_prefill_keeps_the_last_window_in_its_ring():
    """recurrentgemma-2b with a 6-token window over 16 tokens: the cache holds
    the last 6 tokens at slot pos % 6, as the reference's ring does."""
    cfg_j = dataclasses.replace(j_get_config("recurrentgemma-2b").reduced(), attn_window=6)
    cfg_t = dataclasses.replace(get_config("recurrentgemma-2b").reduced(), attn_window=6)
    jm = j_build(cfg_j)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    x = _inputs(cfg_t, 3)
    jlast, jcache = jax.jit(jm.prefill)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    with torch.no_grad():
        last, cache = build_model(cfg_t, device="cpu").prefill(
            params_from_jax(tree, device="cpu"), torch.from_numpy(x))
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    assert sorted(cache["kpos"][0].tolist()) == list(range(S - 6, S))
    for f in ("k", "v", "conv", "lru"):
        _close(cache[f], jcache[f])
    _close(last, jlast, LOGIT_TOL)


# ---------------------------------------------------------------------------
# attention_full, mla_full
# ---------------------------------------------------------------------------


def _attn_pair(window):
    cfg_j = dataclasses.replace(j_get_config("qwen3-8b").reduced(), attn_window=window)
    cfg_t = dataclasses.replace(get_config("qwen3-8b").reduced(), attn_window=window)
    tree = jax.tree.map(np.asarray, j_attn.init_attention(jax.random.PRNGKey(4), cfg_j,
                                                          jnp.float32))
    return cfg_j, cfg_t, tree


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("backend", ["auto", "flash"])
def test_attention_full_matches_reference(backend, window):
    """Both forms (the masked softmax under "auto" at 24 keys, the blocked
    online softmax under "flash": one padded 1024-key block), with and
    without a window, over positions offset by 5."""
    cfg_j, cfg_t, tree = _attn_pair(window)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 24, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 29, dtype=np.int32), (B, 24))
    jo, (jk, jv) = j_attn.attention_full(cfg_j, jax.tree.map(jnp.asarray, tree),
                                         jnp.asarray(x), jnp.asarray(pos), backend)
    to, (tk, tv) = t_attn.attention_full(
        cfg_t, {k: torch.from_numpy(np.array(v)) for k, v in tree.items()},
        torch.from_numpy(x), torch.from_numpy(pos.copy()), backend)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("window", [0, 8])
def test_blocked_attention_over_several_blocks_matches_reference(window):
    """``gqa_flash`` with 8-key blocks over 28 keys (a ragged last block) and
    kpos holes, against the reference's ``_gqa_flash`` at the same block."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(B, 12, 4, 32)).astype(np.float32)
    k = rng.normal(size=(B, 28, 2, 32)).astype(np.float32)
    v = rng.normal(size=(B, 28, 2, 32)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(16, 28, dtype=np.int32), (B, 12)).copy()
    k_pos = np.broadcast_to(np.arange(28, dtype=np.int32), (B, 28)).copy()
    k_pos[:, 3] = -1
    want = j_attn._gqa_flash(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)),
                             0.17, window, block=8)
    got = t_attn.gqa_flash(*(torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)),
                           0.17, window, block=8)
    _close(got, want)


@pytest.mark.parametrize("backend", ["auto", "flash"])
def test_mla_full_matches_reference(backend):
    cfg_j = j_get_config("deepseek-v2-236b").reduced()
    cfg_t = get_config("deepseek-v2-236b").reduced()
    tree = jax.tree.map(np.asarray, j_mla.init_mla(jax.random.PRNGKey(7), cfg_j,
                                                   jnp.float32))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, 20, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (B, 20)).copy()
    jo, jckv = j_mla.mla_full(cfg_j, jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                              jnp.asarray(pos), backend)
    to, tckv = t_mla.mla_full(cfg_t, jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                                  tree),
                              torch.from_numpy(x), torch.from_numpy(pos), backend)
    _close(to, jo)
    _close(tckv, jckv)


# ---------------------------------------------------------------------------
# MoE capacity path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-30b-a3b"])
@pytest.mark.parametrize("capacity", [0.5, 1.0, 1.25])
def test_moe_capacity_path_drops_what_the_reference_drops(arch, capacity):
    """``dropless=False`` at a capacity the reference drops pairs at: y and
    aux equal the reference's capacity path, which differs from dropless."""
    cfg_j = j_get_config(arch).reduced()
    moe_j = dataclasses.replace(cfg_j.moe, capacity_factor=capacity)
    moe_t = dataclasses.replace(get_config(arch).reduced().moe, capacity_factor=capacity)
    tree = jax.tree.map(np.asarray, j_moe.init_moe(jax.random.PRNGKey(9), cfg_j,
                                                   jnp.float32))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    x = np.random.default_rng(10).normal(size=(24, cfg_j.d_model)).astype(np.float32)
    jy, jaux = j_moe.moe_group(jp, jnp.asarray(x), moe_j, cfg_j.activation)
    jy_all, _ = j_moe.moe_group(jp, jnp.asarray(x),
                                dataclasses.replace(moe_j, capacity_factor=0.0),
                                cfg_j.activation)
    assert float(jnp.abs(jy - jy_all).max()) > 1e-3          # pairs were dropped
    ty, taux = t_moe.moe_group(tp, torch.from_numpy(x), moe_t, cfg_j.activation,
                               dropless=False)
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    ty_all, _ = t_moe.moe_group(tp, torch.from_numpy(x), moe_t, cfg_j.activation)
    _close(ty_all, jy_all)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b"])
def test_forward_past_the_blocked_threshold_matches_reference(arch):
    """``Model.forward`` over 8320 tokens, past the 8192 keys above which
    both packages take the blocked online softmax (GQA, and MLA's
    ``mla_full``), at one layer (deepseek-v2-236b's dense first layer):
    logits within LOGIT_TOL."""
    s = 8320
    cfg_j = dataclasses.replace(j_get_config(arch).reduced(), num_layers=1)
    cfg_t = dataclasses.replace(get_config(arch).reduced(), num_layers=1)
    jm = j_build(cfg_j)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(3).integers(0, cfg_t.vocab_size, (1, s)).astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tm = build_model(cfg_t, device="cpu")
    with torch.no_grad():
        tl, _ = tm.forward(params_from_jax(tree, device="cpu"), torch.from_numpy(x))
    assert tl.shape == (1, s, cfg_t.vocab_size)
    _close(tl, jl, LOGIT_TOL)
