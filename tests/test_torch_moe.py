"""The port's MoE FFN (``repro_torch.models.moe``) held to the reference's
(``repro.models.moe``) on the CPU, f32, at the reduced MoE configs: 8
experts, top-2, with one shared expert (deepseek-moe-16b) and with none
(qwen3-30b-a3b).  The same weights (the reference's ``init_moe``, handed
over as numpy) and the same inputs (numpy, from a seed) go through both.

* ``apply_moe`` and ``moe_group``: y within 1e-5, the aux loss within 1e-6,
  against the reference's dropless dispatch (capacity 0, as its ``Model``
  serves); the port's dispatch is dropless whatever the config's capacity;
* ``num_groups`` 2 against the reference's and against 1 (dropless groups
  give the same y; aux is the groups' mean);
* dropless row independence: a token's y alone equals its y in a batch;
* the order of tied routing probabilities: lower expert index first, as
  ``jax.lax.top_k`` gives it (``torch.topk`` leaves ties unordered);
* ``params_from_jax`` and ``Model.init`` keep the router in f32 under bf16;
* ``Model`` on a config with capacity 1.25: a chunk's logits equal those of
  the same tokens prefilled in two chunks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

ATOL, AUX_ATOL = 1e-5, 1e-6
ARCHS = {"deepseek-moe-16b": True, "qwen3-30b-a3b": False}   # arch -> shared expert


def _pair(arch, capacity=0.0):
    """The reduced configs, the reference's with ``capacity`` (0: dropless,
    as its ``Model`` serves), the port's as registered; one set of weights."""
    cfg_j = j_get_config(arch).reduced()
    cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe,
                                                               capacity_factor=capacity))
    cfg_t = get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, j_moe.init_moe(jax.random.PRNGKey(3), cfg_j,
                                                   jnp.float32))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    return cfg_j, cfg_t, jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_config_is_the_tested_shape(arch):
    cfg = get_config(arch).reduced()
    assert (cfg.moe.num_experts, cfg.moe.top_k) == (8, 2)
    assert bool(cfg.moe.num_shared_experts) == ARCHS[arch]
    assert ("shared" in _pair(arch)[3]) == ARCHS[arch]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_group_matches_reference(arch):
    cfg_j, cfg_t, jp, tp = _pair(arch)
    x = _x((24, cfg_t.d_model))
    jy, jaux = j_moe.moe_group(jp, jnp.asarray(x), cfg_j.moe, cfg_j.activation)
    ty, taux = t_moe.moe_group(tp, torch.from_numpy(x), cfg_t.moe, cfg_t.activation)
    _close(ty, jy)
    _close(taux, jaux, AUX_ATOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_group_is_dropless_whatever_the_capacity(arch):
    """At capacity 1.0 (cap = tokens·k/E) the reference drops the (token, k)
    pairs that overflow their expert; the port's dispatch, given the same
    config, keeps them all and equals the reference's dropless y."""
    cfg_j, _, jp, tp = _pair(arch)
    moe_1 = dataclasses.replace(cfg_j.moe, capacity_factor=1.0)
    x = _x((24, cfg_j.d_model))
    jy, _ = j_moe.moe_group(jp, jnp.asarray(x), cfg_j.moe, cfg_j.activation)
    jy_drop, _ = j_moe.moe_group(jp, jnp.asarray(x), moe_1, cfg_j.activation)
    assert float(jnp.abs(jy_drop - jy).max()) > 1e-3
    ty, _ = t_moe.moe_group(tp, torch.from_numpy(x),
                            dataclasses.replace(get_config(arch).reduced().moe,
                                                capacity_factor=1.0),
                            cfg_j.activation)
    _close(ty, jy)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("groups", [0, 2])
def test_apply_moe_matches_reference(arch, groups):
    cfg_j, cfg_t, jp, tp = _pair(arch)
    x = _x((2, 8, cfg_t.d_model), seed=1)
    jy, jaux = j_moe.apply_moe(jp, jnp.asarray(x), cfg_j, num_groups=groups)
    ty, taux = t_moe.apply_moe(tp, torch.from_numpy(x), cfg_t, num_groups=groups)
    assert ty.shape == (2, 8, cfg_t.d_model) and ty.dtype == torch.float32
    _close(ty, jy)
    _close(taux, jaux, AUX_ATOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_groups_of_the_sequence_give_the_same_y(arch):
    """Dropless, a token's routed output does not depend on its group."""
    _, cfg_t, _, tp = _pair(arch)
    x = torch.from_numpy(_x((2, 8, cfg_t.d_model), seed=2))
    y1, aux1 = t_moe.apply_moe(tp, x, cfg_t, num_groups=1)
    y2, aux2 = t_moe.apply_moe(tp, x, cfg_t, num_groups=2)
    _close(y2, y1, 1e-6)
    assert float(aux1) > 0 and float(aux2) > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dropless_row_independence(arch):
    """A token's y alone equals its y among 24 tokens (within 1e-6): what
    lets decode batch requests and chunked recompute repeat the prefill."""
    _, cfg_t, _, tp = _pair(arch)
    x = torch.from_numpy(_x((24, cfg_t.d_model), seed=3))
    y, _ = t_moe.moe_group(tp, x, cfg_t.moe, cfg_t.activation)
    for i in (0, 7, 23):
        yi, _ = t_moe.moe_group(tp, x[i:i + 1], cfg_t.moe, cfg_t.activation)
        _close(yi[0], y[i], 1e-6)


def test_top_k_tie_order_is_jax_order():
    rng = np.random.default_rng(4)
    # four distinct values over 16 columns: every row full of ties
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in (1, 2, 6, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = t_moe.top_k_lower_index_first(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_uniform_router_routes_to_the_lowest_experts(arch):
    """A zero router gives every expert probability 1/E: both packages
    route each token to experts 0 and 1, and agree on y."""
    cfg_j, cfg_t, jp, tp = _pair(arch)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x((6, cfg_t.d_model), seed=5)
    jy, _ = j_moe.moe_group(jp, jnp.asarray(x), cfg_j.moe, cfg_j.activation)
    ty, _ = t_moe.moe_group(tp, torch.from_numpy(x), cfg_t.moe, cfg_t.activation)
    _close(ty, jy)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], dim=-1)
    _, idx = t_moe.top_k_lower_index_first(probs, cfg_t.moe.top_k)
    assert idx.tolist() == [[0, 1]] * 6


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_router_stays_f32_under_bf16(arch):
    from repro.models import build_model
    cfg_j = j_get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, build_model(cfg_j).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(tree, dtype=torch.bfloat16, device="cpu")
    tm = Model(get_config(arch).reduced(), param_dtype=torch.bfloat16,
               compute_dtype=torch.bfloat16, device="cpu")
    ti = tm.init(torch.Generator().manual_seed(0))
    for params in (tp, ti):
        moe_layers = [p["moe"] for p in params["layers"] if "moe" in p]
        assert len(moe_layers) == get_config(arch).reduced().num_layers \
            - get_config(arch).reduced().moe.first_k_dense
        for p in moe_layers:
            assert p["router"].dtype == torch.float32
            assert p["w_up"].dtype == torch.bfloat16


def test_model_chunks_are_dropless():
    """``Model`` serves a config whose capacity (1.25) would drop pairs:
    eight tokens in one chunk give the last logits that the same tokens in
    two chunks of four give (within 1e-5), as restoration needs."""
    cfg = get_config("qwen3-30b-a3b").reduced()
    assert cfg.moe.capacity_factor > 0
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 8))
                         .astype(np.int32))
    la, _ = model.prefill_chunk(params, x, model.init_cache(1, 8), 0)
    _, cache = model.prefill_chunk(params, x[:, :4], model.init_cache(1, 8), 0)
    lb, _ = model.prefill_chunk(params, x[:, 4:], cache, 4)
    _close(lb, la)
