"""The port's multi-head latent attention (``repro_torch.models.mla``) held
to the reference's (``repro.models.mla``) on the CPU, f32, at the reduced
deepseek-v2-236b (kv_lora 32, rope 16, nope 32, v 32, 4 heads), with both
query branches: the low-rank one (q_lora_rank 64, as the config) and the
direct one (q_lora_rank 0).  Same weights (the reference's ``init_mla`` as
numpy), same inputs (numpy, from a seed), tolerance 1e-5, kpos exact:

* ``compress_kv``: the [c_kv || k_rope] row the cache stores;
* ``mla_chunk`` over a latent cache whose slots past the filled prefix hold
  kpos -1, for a chunk (C 6) and then one decode token (C 1), two batch
  rows: the output, the written cache and kpos;
* ``mla_attend_absorbed`` over a cache with -1 holes inside the prefix.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import mla as j_mla  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mla as t_mla  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module", params=[64, 0], ids=["q_lora", "q_direct"])
def pair(request):
    cfg_j = j_get_config("deepseek-v2-236b").reduced()
    cfg_t = get_config("deepseek-v2-236b").reduced()
    cfg_j = dataclasses.replace(cfg_j, mla=dataclasses.replace(cfg_j.mla,
                                                               q_lora_rank=request.param))
    cfg_t = dataclasses.replace(cfg_t, mla=dataclasses.replace(cfg_t.mla,
                                                               q_lora_rank=request.param))
    tree = jax.tree.map(np.asarray, j_mla.init_mla(jax.random.PRNGKey(2), cfg_j,
                                                   jnp.float32))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jp=jax.tree.map(jnp.asarray, tree),
                tp=jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree),
                q_lora=request.param)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _lat_width(cfg):
    return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim


def test_param_tree_has_the_branch(pair):
    t_tree = t_mla.init_mla(pair["cfg_t"], torch.float32, torch.Generator().manual_seed(0))
    assert sorted(t_tree) == sorted(pair["tp"])
    for k in t_tree:
        want = pair["tp"][k]
        got = t_tree[k]
        shapes = ({n: tuple(v.shape) for n, v in got.items()} if isinstance(got, dict)
                  else tuple(got.shape))
        assert shapes == ({n: tuple(v.shape) for n, v in want.items()}
                          if isinstance(want, dict) else tuple(want.shape))
    assert ("wq_a" in t_tree) == (pair["q_lora"] > 0)


def test_compress_kv_matches_reference(pair):
    cfg = pair["cfg_t"]
    x = np.random.default_rng(0).normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 15, dtype=np.int32), (2, 10))
    want = j_mla.compress_kv(pair["cfg_j"], pair["jp"], jnp.asarray(x), jnp.asarray(pos))
    got = t_mla.compress_kv(cfg, pair["tp"], torch.from_numpy(x),
                            torch.from_numpy(np.array(pos)))
    assert got.shape == (2, 10, _lat_width(cfg))
    _close(got, want)


def test_mla_chunk_then_decode_matches_reference(pair):
    """Slots 0-7 filled (kpos 0-7), 8-23 empty (kpos -1); a 6-token chunk
    at 8, then one token at 14, written at their absolute positions."""
    cfg = pair["cfg_t"]
    rng = np.random.default_rng(1)
    s, b = 24, 2
    cache = np.zeros((b, s, _lat_width(cfg)), np.float32)
    cache[:, :8] = rng.normal(size=(b, 8, _lat_width(cfg)))
    kpos = np.full((s,), -1, np.int32)
    kpos[:8] = np.arange(8)
    jc, jk = jnp.asarray(cache), jnp.asarray(kpos)
    tc, tk = torch.from_numpy(cache.copy()), torch.from_numpy(kpos.copy())
    for p0, c in ((8, 6), (14, 1)):
        x = rng.normal(size=(b, c, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(p0, p0 + c, dtype=np.int32), (b, c))
        jo, jc, jk = j_mla.mla_chunk(pair["cfg_j"], pair["jp"], jnp.asarray(x),
                                     jnp.asarray(pos), jc, jk)
        to, tc2, tk2 = t_mla.mla_chunk(cfg, pair["tp"], torch.from_numpy(x),
                                       torch.from_numpy(np.array(pos)), tc, tk)
        assert tc2 is tc and tk2 is tk          # written in place
        _close(to, jo)
        _close(tc, jc)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert int((tk >= 0).sum()) == 15


def test_attend_absorbed_with_holes_matches_reference(pair):
    cfg = pair["cfg_t"]
    rng = np.random.default_rng(2)
    b, c, t, h = 1, 4, 20, cfg.num_heads
    m = cfg.mla
    q_nope = rng.normal(size=(b, c, h, m.qk_nope_head_dim)).astype(np.float32)
    q_rope = rng.normal(size=(b, c, h, m.qk_rope_head_dim)).astype(np.float32)
    lat = rng.normal(size=(b, t, _lat_width(cfg))).astype(np.float32)
    kpos = np.arange(t, dtype=np.int32)
    kpos[[3, 9, 10]] = -1
    pos = np.arange(12, 12 + c, dtype=np.int32)[None]
    want = j_mla.mla_attend_absorbed(pair["cfg_j"], pair["jp"], jnp.asarray(q_nope),
                                     jnp.asarray(q_rope), jnp.asarray(pos),
                                     jnp.asarray(lat), jnp.asarray(kpos))
    got = t_mla.mla_attend_absorbed(cfg, pair["tp"], torch.from_numpy(q_nope),
                                    torch.from_numpy(q_rope), torch.from_numpy(pos),
                                    torch.from_numpy(lat), torch.from_numpy(kpos))
    assert got.shape == (b, c, cfg.d_model)
    _close(got, want)


def test_mla_chunk_refuses_device_or_scattered_positions(pair):
    cfg = pair["cfg_t"]
    x = torch.zeros(1, 2, cfg.d_model)
    cache, kpos = torch.zeros(1, 8, _lat_width(cfg)), torch.full((8,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="consecutive"):
        t_mla.mla_chunk(cfg, pair["tp"], x, torch.tensor([[0, 2]], dtype=torch.int32),
                        cache, kpos)
