"""Operation and byte counts against the program's own product count
(``launch/op_cost.py``'s ``dot_flops``) and against the keys each kernel
launch of a served request really sees."""
import pytest
import torch

from bench_fixtures import mix, tiny  # first: the repository on the path
from bench import flops, inputs, serve, tracing, weights


def test_bound_is_chip_smokes():
    """``chip_smoke.py``'s ``bound`` in seconds: the longer of the bytes
    at 3.35 TB/s and the products at 989 TFLOP/s."""
    assert flops.bound_s(3.35e9, 0) == pytest.approx(1e-3)
    assert flops.bound_s(0, 989e9) == pytest.approx(1e-3)
    assert flops.bound_s(3.35e9, 2 * 989e9) == pytest.approx(2e-3)


def test_kv_restore_bytes():
    """An int8 load of 18 slots x 40 rows of 1024 channels in two fields,
    chunks of 16: bf16 written and a float32 scale per chunk and channel
    read, the L2-warm staged rows not counted; a raw (resident) bf16 run
    counts its writes."""
    f, b = flops.kv_restore(18, 40, (1024, 1024), 1, 2, 16, True)
    assert f == 0 and b == 18 * 40 * 2048 * 2 + 3 * 2048 * 4
    assert flops.kv_restore(18, 40, (1024,), 2, 2, 16, False)[1] == 18 * 40 * 1024 * 2


def _model(name):
    cfg = tiny(name)
    model = serve.Model(serve.port_config(cfg), device="cpu")
    return cfg, model, weights.make(model.param_specs(), 3, torch.device("cpu"))


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-30b-a3b"])
def test_model_flops_match_dot_flops(name):
    """A decode step over a cache of exactly pos + 1 slots, and a chunk of
    rows over a cache its last row fills: the program's dispatched
    products equal ours, once its attention over every slot (the plain
    kernels' einsums) and the dropless MoE's products over all E experts
    are taken off."""
    from repro_torch.launch import op_cost
    cfg, model, params = _model(name)
    shape = flops.Shape.of(cfg["hf"])
    waste = 6 * (shape.experts - shape.top_k) * shape.d * shape.expert_ff * shape.layers
    pos = 37
    cache = model.init_cache(1, pos + 1)
    _, got = op_cost.analyze(model.decode_step, params, torch.tensor([5]), cache, pos)
    assert got["dot_flops"] - waste == shape.span(pos, pos + 1, 0, shape.layers, 1)
    p0, c = 20, 12
    cache = model.init_cache(1, p0 + c)
    ids = torch.arange(c)[None] % shape.vocab
    _, got = op_cost.analyze(model.prefill_chunk, params, ids, cache, p0)
    full = 4 * shape.hq * shape.dh * c * (p0 + c) * shape.layers
    mine = shape.span(p0, p0 + c, 0, shape.layers, 1)
    causal = shape.attention(p0, c) * shape.layers
    assert got["dot_flops"] - c * waste - full == mine - causal


def test_kernel_counts_see_the_keys_the_cache_holds():
    """Every flash_prefill and flash_decode launch of served requests
    (restoration from the host tier, suffix prefill, decode) sees exactly
    p + 1 valid keys at query position p, which is what ``bench.flops``
    counts."""
    from repro_torch.models import attention
    cfg = tiny("qwen3-8b")
    plan = inputs.plan(mix(), cfg, 4)
    system = serve.build(cfg, plan.clients, 4, torch.device("cpu"))
    eng = system["engine"]
    serve.remember_pool(system, plan, 4, cfg["hf"]["vocab_size"])
    seen = []
    spy = tracing.Spy()
    prefill, decode = attention.flash_prefill, attention.flash_decode

    def count(kpos, p):
        return int(((kpos >= 0) & (kpos <= p)).sum())

    def checked_prefill(q, k, v, kpos, q_offset, **kw):
        seen.append(all(count(kpos, q_offset + i) == q_offset + i + 1
                        for i in range(q.shape[1])))
        return prefill(q, k, v, kpos, q_offset, **kw)

    def checked_decode(q, k, v, kpos, q_pos, **kw):
        seen.append(count(kpos, q_pos) == q_pos + 1)
        return decode(q, k, v, kpos, q_pos, **kw)

    attention.flash_prefill, attention.flash_decode = checked_prefill, checked_decode
    try:
        with spy.installed():
            serve.serve_call(eng, serve.requests_of([plan.turn(k) for k in range(3)], "r"),
                             serve.Stamps())
    finally:
        attention.flash_prefill, attention.flash_decode = prefill, decode
    assert seen and all(seen)
    n_pf, n_dec = len(spy.launches["flash_prefill"]), len(spy.launches["flash_decode"])
    assert n_pf + n_dec == len(seen) and n_pf and n_dec
    for b, sq, hq, hkv, dh, q0, esz in spy.launches["flash_prefill"]:
        want = 4 * b * hq * dh * sum(q0 + i + 1 for i in range(sq))
        assert flops.flash_prefill(b, sq, hq, hkv, dh, q0, esz)[0] == want
