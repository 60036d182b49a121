"""The plain reference against the port on the CPU, reduced configurations
in float32: the cache the port's ``remember`` stores and its restoration
restores, the first-token logits of the suffix prefill and every decode
step's logits, all through the serving engine's own path."""
import pytest
import torch

from bench_fixtures import tiny  # first: the repository on the path
from bench import inputs, serve, weights
from bench.reference import qwen3


def _serve_one(cfg, prefix, new, dec):
    """One request forked from a remembered session, served by the engine."""
    system = serve.build(cfg, 1, 11, torch.device("cpu"))
    eng = system["engine"]
    ids = torch.from_numpy(inputs.token_ids(11, prefix, cfg["hf"]["vocab_size"], 0))
    eng.executor.remember("session-0", ids[None])
    req = serve.Request("r-0", 0.0, prefix, new, decode_len=dec,
                        meta={"fork_of": "session-0"})
    eng.serve([req], verify=False)
    return system, ids, req


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-30b-a3b"])
def test_reference_matches_port(name, quant):
    """From an unquantized store the port's logits are the reference's to
    float32 rounding; from the int8 host tier the restored keys and values
    carry the store's quantization error and the logits move with it."""
    cfg = tiny(name)
    cfg["engine"]["quant"] = quant
    prefix, new, dec = 150, 20, 6
    system, ids, req = _serve_one(cfg, prefix, new, dec)
    ex = system["engine"].executor
    out = ex.outputs("r-0")
    suffix = torch.from_numpy(inputs.suffix_ids(11, new, cfg["hf"]["vocab_size"]))
    served = torch.tensor(out["tokens"])
    seq = torch.cat([ids.long(), suffix.long(), served[:-1]])
    keys = []
    ref = qwen3.logits(cfg["hf"], system["params"], seq, prefix + new - 1, keys=keys)
    port = torch.cat([out["first_logits"].float()]
                     + [s.float() for s in out["step_logits"]])
    assert port.shape == ref.shape == (dec, cfg["hf"]["vocab_size"])
    atol = 2e-5 if quant == "none" else 2e-2
    assert torch.allclose(port, ref, atol=atol, rtol=0), (port - ref).abs().max()
    # the restored prefix cache (int8 from the host tier) and the stored
    # ground truth, layer by layer, against the reference's keys and values
    stored = ex.store.get("session-0").kv_reference
    live = ex.live_cache("r-0")
    tol = 2e-5 + system["store"].quant_tolerance()
    for slot, (k, v) in enumerate(keys):
        for field, want in (("k", k), ("v", v)):
            truth = stored[field][slot, 0, :prefix].float()
            assert torch.allclose(truth, want[:prefix], atol=2e-5, rtol=0)
            got = live[field][slot, 0, :prefix].float()
            assert (got - want[:prefix]).abs().max() <= tol


def test_fp8_control_differs():
    """The control's products are not the reference's: float8 operands
    move the logits by far more than float32 rounding."""
    cfg = tiny("qwen3-8b")
    w = weights.make(serve.Model(serve.port_config(cfg), device="cpu").param_specs(), 5,
                     torch.device("cpu"))
    ids = torch.from_numpy(inputs.token_ids(5, 40, cfg["hf"]["vocab_size"], 0)).long()
    a = qwen3.logits(cfg["hf"], w, ids, 30)
    b = qwen3.logits(cfg["hf"], w, ids, 30, precision="fp8")
    assert (a - b).abs().max() > 1e-3
