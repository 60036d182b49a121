"""A MoE layer that holds a share of the routed experts (``MoEConfig``'s
``experts_first`` / ``experts_held``: one chip's under expert parallelism),
on the CPU in f32 at the reduced MoE configs (8 experts, top 2).

* The shares of one layer's weights add up to the unsplit layer (1e-5):
  ``moe_group`` over [0, 4) plus [4, 8), and over three uneven shares; with
  a shared expert (``apply_moe``, deepseek-moe-16b) it is counted once.
  The aux loss is the unsplit layer's, bit for bit.
* With the default (all held) the layer is the dropless dispatch it was
  before shares existed, bit for bit, and its stacks keep E experts.
* Without ``want_aux`` (the serving layers) the output is unchanged bit
  for bit, with or without a share and groups, and the loss is None.
* A share is dropless (every pair routed to a held expert runs, against a
  token-by-token loop), row-independent, and breaks ties towards the lower
  expert index: a zero router sends every token to experts 0 and 1, so
  the share [0, 4) is the whole layer and [4, 8) gives exact zeros.
* Through the model: ``layer_chunk``'s chunk of 8 equals two chunks of 4,
  and ``decode_rows`` equals each row's ``decode_step``.
* A served run (``RealServingEngine``, an unquantized chunk store) records
  one ``model.moe`` span a MoE FFN call, under the executor's compute,
  prefill and decode forward, its count the call's tokens; the served
  tokens equal a telemetry-off run's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.kvcache import grow_cache  # noqa: E402
from repro_torch.serving import ChunkStore, RealServingEngine, Request  # noqa: E402

ATOL = 1e-5
STACKS = ("w_gate", "w_up", "w_down")


def _share_cfg(cfg, first, held):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, experts_first=first, experts_held=held))


def _layer(arch="qwen3-30b-a3b"):
    """The reduced config and its first MoE layer's weights."""
    cfg = get_config(arch).reduced()
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(3))
    i = cfg.moe.first_k_dense
    return cfg, params["layers"][i]["moe"]


def _cut(p, first, held):
    """The weights a share [first, first + held) holds: the router whole."""
    return {k: (v[first:first + held] if k in STACKS else v) for k, v in p.items()}


def _x(t, d, seed=0):
    return torch.randn((t, d), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("shares", [((0, 4), (4, 4)), ((0, 3), (3, 2), (5, 3))])
def test_shares_add_up_to_the_layer(shares):
    cfg, p = _layer()
    x = _x(24, cfg.d_model)
    want, aux = t_moe.moe_group(p, x, cfg.moe, cfg.activation)
    got = torch.zeros_like(want)
    for first, held in shares:
        moe = _share_cfg(cfg, first, held).moe
        y, a = t_moe.moe_group(_cut(p, first, held), x, moe, cfg.activation)
        assert torch.equal(a, aux)
        got += y
    assert float((got - want).abs().max()) <= ATOL


def test_shared_expert_counted_once():
    cfg, p = _layer("deepseek-moe-16b")
    assert "shared" in p
    x = _x(12, cfg.d_model, seed=1)[None]
    want, _ = t_moe.apply_moe(p, x, cfg)
    parts = [t_moe.apply_moe(_cut(p, f, h), x, _share_cfg(cfg, f, h))[0]
             for f, h in ((0, 4), (4, 4))]
    shared = t_moe.apply_mlp(p["shared"], x, cfg.activation)
    assert float((parts[0] + parts[1] - shared - want).abs().max()) <= ATOL


def _dropless_before_shares(params, x, moe, activation):
    """The dropless dispatch as it was before a layer could hold a share:
    every expert's (E, T, D) buffer, scattered, run and gathered."""
    t, d = x.shape
    e, k = moe.num_experts, moe.top_k
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    top_p, top_i = t_moe.top_k_lower_index_first(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_i.reshape(t * k)
    onehot = (flat_e[:, None] == torch.arange(e)).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0].long()
    buf = torch.zeros((e, t, d), dtype=x.dtype)
    buf.index_put_((flat_e, slot), x.repeat_interleave(k, dim=0))
    y_rep = t_moe._expert_ffn(params, buf, activation)[flat_e, slot]
    return (y_rep * top_p.reshape(t * k, 1)).reshape(t, k, d).sum(dim=1)


def test_default_is_the_unsplit_layer_bit_for_bit():
    cfg, p = _layer()
    assert cfg.moe.held_range == (0, 8) and p["w_up"].shape[0] == 8
    x = _x(24, cfg.d_model, seed=2)
    y, _ = t_moe.moe_group(p, x, cfg.moe, cfg.activation)
    assert torch.equal(y, _dropless_before_shares(p, x, cfg.moe, cfg.activation))
    # the full-size model's stacks: all 128 experts, or the 64 of a share
    full = get_config("qwen3-30b-a3b")
    for held, want in ((0, 128), (64, 64)):
        c = _share_cfg(full, 0, held)
        specs = Model(c, param_dtype=torch.bfloat16, device="meta").param_specs()
        moe = specs["layers"][0]["moe"]
        assert moe["router"].shape == (2048, 128) and moe["router"].dtype == torch.float32
        assert moe["w_gate"].shape == (want, 2048, 768)
        assert moe["w_down"].shape == (want, 768, 2048)


@pytest.mark.parametrize("share", [None, (2, 4)])
@pytest.mark.parametrize("groups", [0, 2])
def test_no_aux_wanted_leaves_the_output_bit_for_bit(share, groups):
    """``want_aux=False`` (the serving layers') issues no loss: the output
    is the layer's bit for bit, the loss None."""
    cfg, p = _layer()
    if share is not None:
        p, cfg = _cut(p, *share), _share_cfg(cfg, *share)
    x = _x(12, cfg.d_model, seed=7)[None]
    want, aux = t_moe.apply_moe(p, x, cfg, num_groups=groups)
    got, none = t_moe.apply_moe(p, x, cfg, num_groups=groups, want_aux=False)
    assert aux is not None and none is None
    assert torch.equal(got, want)


def test_share_bounds_and_capacity_refused():
    moe = get_config("qwen3-30b-a3b").moe
    for first, held in ((-1, 4), (100, 64), (0, 129)):
        with pytest.raises(ValueError):
            dataclasses.replace(moe, experts_first=first, experts_held=held)
    cfg, p = _layer()
    share = _share_cfg(cfg, 0, 4)
    with pytest.raises(ValueError, match="dropless"):
        t_moe.moe_group(_cut(p, 0, 4), _x(4, cfg.d_model), share.moe, cfg.activation,
                        dropless=False)


def _share_by_token(p, x, moe, first, held):
    """The share's output token by token: the router over all experts, the
    top k renormalised, each held one's SwiGLU added by its weight."""
    out = torch.zeros_like(x)
    for i in range(x.shape[0]):
        probs = torch.softmax(x[i] @ p["router"], dim=-1)
        vals, idx = torch.sort(probs, descending=True, stable=True)
        w = vals[:moe.top_k] / vals[:moe.top_k].sum()
        for wj, e in zip(w, idx[:moe.top_k].tolist()):
            if first <= e < first + held:
                j = e - first
                h = torch.nn.functional.silu(x[i] @ p["w_gate"][j]) * (x[i] @ p["w_up"][j])
                out[i] += wj * (h @ p["w_down"][j])
    return out


def test_share_is_dropless_and_row_independent():
    cfg, p = _layer()
    first, held = 2, 4
    moe = _share_cfg(cfg, first, held).moe
    q = _cut(p, first, held)
    x = _x(24, cfg.d_model, seed=4)
    y, _ = t_moe.moe_group(q, x, moe, cfg.activation)
    assert float((y - _share_by_token(q, x, moe, first, held)).abs().max()) <= ATOL
    for i in (0, 7, 23):
        yi, _ = t_moe.moe_group(q, x[i:i + 1], moe, cfg.activation)
        assert float((yi[0] - y[i]).abs().max()) <= 1e-6
    # 16 copies of a token that a held expert takes: all 16 of that
    # expert's pairs run, none dropped
    i = next(i for i in range(24) if float(y[i].abs().max()) > 0)
    same = x[i:i + 1].expand(16, -1).contiguous()
    ys, _ = t_moe.moe_group(q, same, moe, cfg.activation)
    assert float((ys - y[i]).abs().max()) <= 1e-6


def test_ties_route_to_the_lower_index():
    cfg, p = _layer()
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x(6, cfg.d_model, seed=5)
    want, _ = t_moe.moe_group(p, x, cfg.moe, cfg.activation)
    low, _ = t_moe.moe_group(_cut(p, 0, 4), x, _share_cfg(cfg, 0, 4).moe, cfg.activation)
    high, _ = t_moe.moe_group(_cut(p, 4, 4), x, _share_cfg(cfg, 4, 4).moe, cfg.activation)
    assert float((low - want).abs().max()) <= ATOL
    assert torch.equal(high, torch.zeros_like(high))


def _share_model(first=2, held=4):
    cfg = _share_cfg(get_config("qwen3-30b-a3b").reduced(), first, held)
    m = Model(cfg, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def test_layer_chunks_of_a_share_are_row_independent():
    m, params = _share_model()
    ids = torch.randint(0, m.cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(6))
    one, _ = m.prefill_chunk(params, ids, m.init_cache(1, 8), 0)
    cache = m.init_cache(1, 8)
    _, cache = m.prefill_chunk(params, ids[:, :4], cache, 0)
    two, _ = m.prefill_chunk(params, ids[:, 4:], cache, 4)
    assert float((one - two).abs().max()) <= ATOL * max(1.0, float(one.abs().max()))
    full, _ = m.prefill(params, ids)
    assert float((full - one).abs().max()) <= ATOL * max(1.0, float(one.abs().max()))


def test_decode_rows_with_a_share_equal_decode_step():
    m, params = _share_model()
    assert m.can_decode_rows([])
    gen = torch.Generator().manual_seed(1)
    caches, pos, toks = [], [], []
    for n in (5, 23, 11):
        logits, cache = m.prefill(params, torch.randint(0, m.cfg.vocab_size, (1, n),
                                                        generator=gen))
        caches.append(grow_cache(m.cfg, cache, n + 3))
        pos.append(n)
        toks.append(int(torch.argmax(logits[0])))
    single = [{f: a.clone() for f, a in c.items()} for c in caches]
    for _ in range(3):
        got = m.decode_rows(params, torch.tensor(toks, dtype=torch.int32), caches, pos)
        want = torch.cat([m.decode_step(params, torch.tensor([t], dtype=torch.int32),
                                        single[r], pos[r])[0]
                          for r, t in enumerate(toks)])
        assert float((got - want).abs().max()) <= ATOL * max(1.0, float(want.abs().max()))
        toks = torch.argmax(got, -1).tolist()
        pos = [p + 1 for p in pos]


ENGINE_KW = dict(system="cacheflow", stages=2, chunk_size=16, l_delta=32,
                 max_batch=2, io_channels=1, datapath="fused")
REQS = [("a", 0.0, 32), ("b", 0.0, 16), ("c", 0.05, 24)]
PARENTS = ("executor.decode_forward", "executor.compute", "executor.prefill")


def _serve(telemetry):
    m, params = _share_model()
    store = ChunkStore(chunk_size=8, quant="none", default_tier="host", device="cpu")
    eng = RealServingEngine(m, params, kvstore=store, device="cpu",
                            telemetry=telemetry, **ENGINE_KW)
    rep = eng.serve([Request(rid, t, n, 8, decode_len=3) for rid, t, n in REQS],
                    verify=True)
    return eng, rep


def test_moe_spans_under_their_parents_and_tokens_unchanged():
    on, rep = _serve(True)
    spans = rep.telemetry["spans"]["records"]
    layers = on.executor.model.cfg.num_layers
    moe = [s for s in spans if s[0] == "model.moe"]
    assert moe and obs.SPAN_CATALOG["model.moe"]["parent"] == PARENTS
    seen = set()
    for i, s in enumerate(spans):
        if s[0] not in PARENTS:
            continue
        kids = [c for c in spans if c[3] == i and c[0] == "model.moe"]
        assert all(s[1] <= c[1] and c[2] <= s[2] for c in kids)
        if s[0] == "executor.decode_forward":
            # one forward of the step's rows: every layer's FFN once for them
            assert [c[5] for c in kids] == [s[5]] * layers
        else:
            # the engine op's tokens through each of its layers: at once
            # (token-wise, a suffix prefill) or in chunks (layer-wise)
            tokens = spans[s[3]][5]
            total = sum(c[5] for c in kids)
            assert total % tokens == 0 and 1 <= total // tokens <= layers
            if s[0] == "executor.prefill":
                assert {c[5] for c in kids} == {8}          # the new turn
        seen.add(s[0])
    assert seen == set(PARENTS)
    assert all(spans[s[3]][0] in PARENTS for s in moe)
    off, rep_off = _serve(False)
    assert rep_off.telemetry is None
    for rid, _, _ in REQS:
        assert on.executor.outputs(rid)["tokens"] == off.executor.outputs(rid)["tokens"]
        assert torch.equal(on.executor.outputs(rid)["first_logits"],
                           off.executor.outputs(rid)["first_logits"])
