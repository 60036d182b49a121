"""One decode forward for all of a step's requests (``Model.decode_rows``).

* ``decode_rows`` over 4 rows holds each row's logits to that row's own
  ``Model.decode_step`` (B = 1) within TOL (f32, CPU) and gives the same
  greedy tokens and caches, over several steps, on ragged caches (other
  prefix lengths, rows that joined the batch at other steps, one at the
  first slot of its decode tail); for a reduced qwen3 (GQA, QK-norm), the
  same windowed (a ring the prefixes wrap), a dropless MoE (qwen3-30b-a3b)
  and MLA (deepseek-v2-236b, its first layer dense).
* One row equals ``decode_step`` bit for bit.
* ``Model.can_decode_rows`` refuses recurrent and RWKV stacks and a
  capacity-limited MoE.
* A served run (``RealServingEngine``, int8 chunk store) gives the same
  tokens and step logits through the batched path as through the
  per-request loop, with one ``executor.decode_forward`` of the step's
  rows a step; an RWKV stack keeps one forward a request.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.kvcache import grow_cache  # noqa: E402
from repro_torch.serving import ChunkStore, RealServingEngine, Request  # noqa: E402

TOL = 1e-5
# the rows' prefix lengths, and the steps each decodes alone before the
# rows decode together (row 0 then sits at the first slot of its tail)
PREFIX = (5, 23, 11, 30)
ALONE = (0, 1, 3, 2)
STEPS = 4

CONFIGS = {
    "qwen3": ("qwen3-8b", {}),
    "qwen3_window": ("qwen3-8b", {"attn_window": 16}),
    "moe": ("qwen3-30b-a3b", {}),
    "mla": ("deepseek-v2-236b", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name, **overrides):
    m = Model(get_config(name).reduced(**overrides), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _clone(cache):
    return {f: a.clone() for f, a in cache.items()}


def _rows(m, params):
    """Each row's (cache, next position, next token) after its prefill and
    its steps alone."""
    gen = torch.Generator().manual_seed(1)
    rows = []
    for n, alone in zip(PREFIX, ALONE):
        ids = torch.randint(0, m.cfg.vocab_size, (1, n), generator=gen)
        logits, cache = m.prefill(params, ids)
        cache = grow_cache(m.cfg, cache, n + alone + STEPS)
        pos = n
        for _ in range(alone):
            tok = torch.argmax(logits, -1).to(torch.int32)
            logits, cache = m.decode_step(params, tok, cache, pos)
            pos += 1
        rows.append((cache, pos, int(torch.argmax(logits[0]))))
    return rows


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_rows_match_decode_step(case):
    name, overrides = CONFIGS[case]
    m, params = _model(name, **overrides)
    assert m.can_decode_rows([])
    rows = _rows(m, params)
    if overrides.get("attn_window"):
        # the ring wraps: a prefix longer than the window
        assert max(PREFIX) > rows[0][0]["kpos"].shape[1]
    batched = [_clone(c) for c, _, _ in rows]
    single = [_clone(c) for c, _, _ in rows]
    pos = [p for _, p, _ in rows]
    toks = [t for _, _, t in rows]
    for _ in range(STEPS):
        got = m.decode_rows(params, torch.tensor(toks, dtype=torch.int32), batched, pos)
        assert got.shape == (len(rows), m.cfg.vocab_size)
        want = []
        for r in range(len(rows)):
            lg, single[r] = m.decode_step(params, torch.tensor([toks[r]], dtype=torch.int32),
                                          single[r], pos[r])
            want.append(lg)
        want = torch.cat(want)
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= TOL * scale
        assert torch.argmax(got, -1).tolist() == torch.argmax(want, -1).tolist()
        toks = torch.argmax(got, -1).tolist()
        pos = [p + 1 for p in pos]
    for b, s in zip(batched, single):
        assert torch.equal(b["kpos"], s["kpos"])
        for f in b:
            if f != "kpos":
                assert float((b[f] - s[f]).abs().max()) <= TOL


@pytest.mark.parametrize("case", ["qwen3", "mla"])
def test_one_row_is_decode_step(case):
    """The one-row step: bit for bit the B = 1 forward, cache included."""
    name, overrides = CONFIGS[case]
    m, params = _model(name, **overrides)
    cache, pos, tok = _rows(m, params)[1]
    a, b = _clone(cache), _clone(cache)
    tok = torch.tensor([tok], dtype=torch.int32)
    got = m.decode_rows(params, tok, [a], [pos])
    want, _ = m.decode_step(params, tok, b, pos)
    assert torch.equal(got, want)
    for f in a:
        assert torch.equal(a[f], b[f])


@pytest.mark.parametrize("name,kw", [("recurrentgemma-2b", {}), ("rwkv6-7b", {}),
                                     ("qwen3-30b-a3b", {"moe_dropless": False})])
def test_per_request_stacks(name, kw):
    m = Model(get_config(name).reduced(), device="cpu", **kw)
    assert not m.can_decode_rows([])


# ---------------------------------------------------------------------------
# Served: the executor's decode step
# ---------------------------------------------------------------------------

ENGINE_KW = dict(system="cacheflow", stages=2, chunk_size=16, l_delta=32,
                 max_batch=3, io_channels=1, datapath="fused")
REQS = [("a", 0.0, 32, 6), ("b", 0.0, 16, 5), ("c", 0.01, 48, 7)]


def _serve(m, params, *, rows: bool, telemetry: bool = True, kvstore: bool = True):
    store = (ChunkStore(chunk_size=8, quant="int8", default_tier="host", device="cpu")
             if kvstore else None)
    eng = RealServingEngine(m, params, kvstore=store, device="cpu",
                            telemetry=telemetry, **ENGINE_KW)
    if not rows:
        m.can_decode_rows = lambda caches: False
    try:
        rep = eng.serve([Request(rid, t, n, 8, decode_len=d) for rid, t, n, d in REQS],
                        verify=True, op_order="alternate")
    finally:
        m.__dict__.pop("can_decode_rows", None)
    return eng, rep.telemetry["spans"]["records"]


def _decode_children(spans, name):
    """For each ``engine.decode_step``: its count and its ``name`` children."""
    out = []
    for i, s in enumerate(spans):
        if s[0] == "engine.decode_step":
            out.append((s[5], [c for c in spans if c[3] == i and c[0] == name]))
    return out


def test_served_rows_equal_per_request_loop():
    m, params = _model("qwen3-8b")
    eng_rows, spans = _serve(m, params, rows=True)
    eng_loop, loop_spans = _serve(m, params, rows=False)
    steps = _decode_children(spans, "executor.decode_forward")
    assert max(n for n, _ in steps) > 1          # the batch held several rows
    for n, fwd in steps:
        assert len(fwd) == 1 and fwd[0][4] is None and fwd[0][5] == n
    for n, fwd in _decode_children(loop_spans, "executor.decode_forward"):
        assert len(fwd) == n and all(f[5] is None for f in fwd)
    for rid, _, _, d in REQS:
        a, b = eng_rows.executor.outputs(rid), eng_loop.executor.outputs(rid)
        assert a["tokens"] == b["tokens"] and len(a["tokens"]) == d
        assert torch.equal(a["first_logits"], b["first_logits"])
        assert len(a["step_logits"]) == len(b["step_logits"])
        for x, y in zip(a["step_logits"], b["step_logits"]):
            assert x.shape == y.shape == (1, m.cfg.vocab_size)
            # each row its own storage, not a view of the step's logits
            assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
            assert float((x - y).abs().max()) <= TOL * max(1.0, float(y.abs().max()))


def test_rwkv_keeps_a_forward_a_request():
    m, params = _model("rwkv6-7b")
    _, spans = _serve(m, params, rows=True, kvstore=False)
    steps = _decode_children(spans, "executor.decode_forward")
    assert max(n for n, _ in steps) > 1
    for n, fwd in steps:
        assert len(fwd) == n
        assert all(f[4] is not None and f[5] is None for f in fwd)
    for n, reads in _decode_children(spans, "executor.token_read"):
        assert len(reads) == n
