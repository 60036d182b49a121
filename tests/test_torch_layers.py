"""PyTorch port vs the JAX reference: config, layers, the plain versions of
the attention kernels, and the model's chunk entry points.

Inputs are drawn with numpy from a seed and fed to both packages; weights
come from the reference's ``Model.init`` through ``params_from_jax``.  The
JAX attention kernels run as the reference's own tests run them on the CPU:
in interpret mode and through their ``ref.py`` oracles.  Everything is f32
on the CPU; tolerance ATOL = 1e-5 (two libraries' f32 kernels differ in the
last bits of rsqrt/exp/sin and of summation order), positions (kpos) exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_decode import flash_decode_attention  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill_attention  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def pair():
    cfg_j = jax_get_config("qwen3-8b").reduced()
    jm = build_model(cfg_j)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg_t = get_config("qwen3-8b").reduced()
    tm = Model(cfg_t, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return dict(cfg=cfg_t, jm=jm, jp=jp, tm=tm, tp=tp)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    a, b = jax_get_config("qwen3-8b"), get_config("qwen3-8b")
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.kv_bytes_per_token() == b.kv_bytes_per_token()
    assert a.layer_kinds() == b.layer_kinds()
    assert a.param_counts() == b.param_counts()


def test_init_draws_reference_shapes_and_distributions(pair):
    """Model.init: same parameter tree shapes as the converted reference;
    dense weights truncated at 2 std of 1/sqrt(fan_in); norms are ones."""
    cfg, tm, tp = pair["cfg"], pair["tm"], pair["tp"]
    mine = tm.init(torch.Generator().manual_seed(0))
    assert mine.keys() == tp.keys() and len(mine["layers"]) == cfg.num_layers
    for a, b in zip(mine["layers"], tp["layers"]):
        for blk in a:
            for name in a[blk]:
                assert a[blk][name].shape == b[blk][name].shape, (blk, name)
    w = mine["layers"][0]["mlp"]["w_up"]
    std = cfg.d_model ** -0.5
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.05      # truncated-normal std
    assert abs(float(mine["embed"].std()) - 0.02) < 0.002
    assert torch.equal(mine["layers"][0]["norm1"]["scale"], torch.ones(cfg.d_model))


@pytest.mark.parametrize("fn", ["norm", "head_norm", "mlp", "rope"])
def test_layer_functions_match_reference(pair, fn):
    rng = np.random.default_rng(1)
    p = jax.tree.map(np.asarray, pair["jp"])["scan_layers"]
    layer0 = jax.tree.map(lambda a: a[0], p)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    if fn == "norm":
        scale = rng.standard_normal(128).astype(np.float32)
        want = jl.apply_norm("rmsnorm", {"scale": scale}, jnp.asarray(x), 1e-6)
        got = tl.apply_norm("rmsnorm", {"scale": _t(scale)}, _t(x), 1e-6)
    elif fn == "head_norm":
        xh = x.reshape(2, 5, 4, 32) * 3
        scale = rng.standard_normal(32).astype(np.float32)
        want = jl.rms_head_norm(jnp.asarray(xh), jnp.asarray(scale))
        got = tl.rms_head_norm(_t(xh), _t(scale))
    elif fn == "mlp":
        want = jl.apply_mlp(layer0["mlp"], jnp.asarray(x), "swiglu")
        got = tl.apply_mlp({k: _t(v) for k, v in layer0["mlp"].items()}, _t(x),
                           "swiglu")
    else:
        xh = x.reshape(2, 5, 4, 32)
        pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
        want = jl.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e6)
        got = tl.apply_rope(_t(xh), _t(pos), 1e6)
    _close(got, want)


@pytest.mark.parametrize("backend", ["interpret", "ref"])
@pytest.mark.parametrize("window", [0, 16])
def test_flash_prefill_plain_matches_reference(backend, window):
    """The reference's kv_len index mask is kpos[j] = j for j < kv_len."""
    rng = np.random.default_rng(2)
    b, sq, skv, hq, hkv, dh, q_off = 2, 40, 72, 4, 2, 32, 32
    q = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    kv_len = q_off + sq
    want = flash_prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   q_off, kv_len, scale=dh ** -0.5, window=window,
                                   backend=backend, bq=16, bk=16)
    kpos = np.where(np.arange(skv) < kv_len, np.arange(skv), -1).astype(np.int32)
    got = flash_prefill(_t(q), _t(k), _t(v), _t(kpos), q_off, scale=dh ** -0.5,
                        window=window)
    _close(got, want)


@pytest.mark.parametrize("backend", ["interpret", "ref"])
@pytest.mark.parametrize("window", [0, 20])
def test_flash_decode_plain_matches_reference(backend, window):
    """Ring-buffer kpos: empty slots (-1) and slots past q_pos are masked."""
    rng = np.random.default_rng(3)
    b, s, hq, hkv, dh, q_pos = 2, 48, 4, 2, 32, 40
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    kpos = rng.permutation(np.arange(-8, s - 8)).astype(np.int32)
    kpos[5] = 44                                   # a slot ahead of q_pos
    want = flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(kpos), q_pos, scale=dh ** -0.5,
                                  window=window, backend=backend, bk=16)
    got = flash_decode(_t(q), _t(k), _t(v), _t(kpos), q_pos, scale=dh ** -0.5,
                       window=window)
    _close(got, want)


def _cache_to_torch(cache):
    return {f: _t(a) for f, a in cache.items()}


def _assert_cache(got, want):
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["kpos"].numpy(), np.asarray(want["kpos"]))
    for f in ("k", "v"):
        _close(got[f], want[f])


def test_model_chunk_entry_points_match_reference(pair):
    """prefill_chunk (C > 1, over an empty cache), layer_chunk (one layer,
    chunk over a partly filled cache) and decode_step (C = 1): logits,
    activations and caches."""
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (1, 24)).astype(np.int32)
    jc = jm.init_cache(1, 40)
    tc = tm.init_cache(1, 40)
    jl_, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jc, 0)
    tl_, tc = tm.prefill_chunk(tp, _t(toks), tc, 0)
    _close(tl_, jl_)
    _assert_cache(tc, jc)

    x = rng.standard_normal((1, 8, 128)).astype(np.float32)
    pos = np.arange(24, 32, dtype=np.int32)[None]
    jx, jc2 = jm.layer_chunk(jp, 1, jnp.asarray(x), jnp.asarray(pos), jc)
    tx, tc2 = tm.layer_chunk(tp, 1, _t(x), _t(pos), _cache_to_torch(jc))
    _close(tx, jx)
    _assert_cache(tc2, jc2)

    tok = np.argmax(np.asarray(jl_), axis=-1).astype(np.int32)
    jd, jc3 = jm.decode_step(jp, jnp.asarray(tok), jc, 24)
    td, tc3 = tm.decode_step(tp, _t(tok), tc, 24)
    _close(td, jd)
    _assert_cache(tc3, jc3)
