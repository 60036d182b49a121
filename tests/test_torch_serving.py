"""The slice end to end: the reference's ``RealServingEngine`` against the
port's, on the same weights and inputs, serving from a chunk store through
the fused datapath with two-pointer restoration (token- and layer-wise
plans, two pipeline stages), suffix prefill and greedy decode.

Durations are synthetic (``op_order="alternate"``), so both engine cores
take the same decisions: the ops logs must be identical, as must the
datapath's dispatch counts and the store's accounting.  Restored caches
pass ``verify`` in both.  Greedy tokens are bit-exact; first-token logits
agree to 1e-4 (f32 on the CPU).
"""
import contextlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.engine_core as j_core  # noqa: E402
import repro_torch.core.engine_core as t_core  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import ChunkStore as JChunkStore  # noqa: E402
from repro.serving import RealServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.serving import ChunkStore, RealServingEngine, Request  # noqa: E402

LOGIT_ATOL = 1e-4
# prefixes 32 (token-wise, >= l_delta) and 16 (layer-wise); "c" repeats
# "a"'s length, so it gets the same tokens and the store dedups its chunks
REQS = [("a", 0.0, 32), ("b", 0.0, 16), ("c", 0.05, 32)]
ENGINE_KW = dict(system="cacheflow", stages=2, chunk_size=16, l_delta=32,
                 max_batch=2, io_channels=1, datapath="fused")


@contextlib.contextmanager
def _capture_results(module, sink):
    orig = module.EngineCore.run

    def run(self, *a, **kw):
        res = orig(self, *a, **kw)
        sink.append(res)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module.EngineCore, "run", run)
        yield


def _serve(quant):
    cfg_j = jax_get_config("qwen3-8b").reduced()
    jm = build_model(cfg_j)
    jp = jm.init(jax.random.PRNGKey(0))
    js = JChunkStore(chunk_size=8, quant=quant, default_tier="host")
    je = JEngine(jm, jp, kvstore=js, **ENGINE_KW)
    tm = Model(get_config("qwen3-8b").reduced(), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ts = ChunkStore(chunk_size=8, quant=quant, default_tier="host", device="cpu")
    te = RealServingEngine(tm, tp, kvstore=ts, device="cpu", **ENGINE_KW)
    # the port draws its inputs with torch; parity needs the reference's
    te._inputs = lambda n: torch.from_numpy(np.array(je._inputs(n)))
    out = {}
    for tag, eng, req_cls, mod in (("jax", je, JRequest, j_core),
                                   ("torch", te, Request, t_core)):
        sink = []
        reqs = [req_cls(rid, t, n, 8, decode_len=3) for rid, t, n in REQS]
        with _capture_results(mod, sink):
            rep = eng.serve(reqs, verify=True, op_order="alternate")
        out[tag] = dict(eng=eng, rep=rep, res=sink[0], store=eng.kvstore)
    return out


@pytest.fixture(scope="module", params=["none", "int8"])
def served(request):
    return _serve(request.param)


def test_schedule_identical(served):
    j, t = served["jax"], served["torch"]
    assert t["res"].ops_log == j["res"].ops_log
    assert t["rep"].ttfts == j["rep"].ttfts
    assert t["res"].decode_steps == j["res"].decode_steps
    assert {r: p[0].strategy for r, p in _plans(t).items()} == \
        {"a": "token", "b": "layer", "c": "token"}


def _plans(side):
    live = side["eng"].executor._live
    return {rid: [live[rid]["plans"][s] for s in sorted(live[rid]["plans"])]
            for rid in live}


def test_datapath_and_store_accounting_equal(served):
    j, t = served["jax"], served["torch"]
    je, te = j["eng"], t["eng"]
    assert te.datapath.kernel_launches == je.datapath.kernel_launches > 0
    assert te.datapath.resident_copies == je.datapath.resident_copies
    assert sum(s.puts for s in te.datapath.streams) == \
        sum(s.puts for s in je.datapath.streams)
    assert te.executor.load_dispatches == je.executor.load_dispatches
    assert te.executor.fused_loads == je.executor.fused_loads > 0
    for attr in ("puts", "fetches", "io_hits", "dedup_hits", "bytes_transferred",
                 "skipped_transfers", "store_misses"):
        assert getattr(t["store"], attr) == getattr(j["store"], attr), attr
    t["store"].audit()


def test_outputs_match(served):
    je, te = served["jax"]["eng"], served["torch"]["eng"]
    for rid, _, _ in REQS:
        oj, ot = je.executor.outputs(rid), te.executor.outputs(rid)
        assert ot["tokens"] == oj["tokens"] and len(ot["tokens"]) == 3
        np.testing.assert_allclose(ot["first_logits"].numpy(),
                                   np.asarray(oj["first_logits"]),
                                   rtol=0, atol=LOGIT_ATOL)


def test_restored_caches_verified(served):
    """serve(verify=True) raised on mismatch; the port also records the
    worst error per field, and restored caches agree with the reference's
    restored caches."""
    je, te = served["jax"]["eng"], served["torch"]["eng"]
    assert set(te.executor.verify_errs) == {rid for rid, _, _ in REQS}
    quant = served["torch"]["store"].quant
    for rid, _, n in REQS:
        ref = te.executor.store.get(rid).kv_reference
        jref = je.executor.store.get(rid).kv_reference
        np.testing.assert_array_equal(ref["kpos"].numpy(), np.asarray(jref["kpos"]))
        np.testing.assert_allclose(ref["k"].numpy(), np.asarray(jref["k"]),
                                   rtol=0, atol=1e-5)
        errs = te.executor.verify_errs[rid]
        assert errs["kpos"] == 0.0
        if quant == "none":
            assert errs["k"] <= 1e-5 and errs["v"] <= 1e-5
