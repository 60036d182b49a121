"""Ported engine paths the slice's parity run does not reach, checked on the
port alone (CPU, reduced qwen3-8b, f32, random weights):

* preemption (suspend parks the cache in host tensors, resume returns it)
  restores every cache exactly and leaves outputs as an unpreempted run;
* the legacy per-chunk load path and the ground-truth fallback (no chunk
  store) restore the same bits as the fused datapath;
* an O(1) session fork restores from the parent's chunks with no prefill.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import ChunkStore, RealServingEngine, Request  # noqa: E402


@pytest.fixture(scope="module")
def mp():
    m = Model(get_config("qwen3-8b").reduced(), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _engine(mp, store=None, **kw):
    m, params = mp
    kw = dict(system="cacheflow", stages=2, chunk_size=8, device="cpu") | kw
    return RealServingEngine(m, params, kvstore=store, **kw)


def _reqs():
    return [Request("bg", 0.0, 48, 8, decode_len=3, priority=0),
            Request("hi", 0.3, 16, 8, decode_len=3, priority=1),
            Request("bg2", 0.4, 40, 8, decode_len=3, priority=0)]


def _outputs(eng, reqs):
    return {r.request_id: eng.executor.outputs(r.request_id) for r in reqs}


def test_preempted_requests_match_unpreempted_run(mp):
    eng = _engine(mp, max_batch=1, preempt="priority")
    reqs = _reqs()
    rep = eng.serve(reqs, verify=True, op_order="random",
                    rng=np.random.default_rng(3))
    assert sum(rep.preemptions.values()) > 0, "scenario produced no preemption"
    base = _engine(mp)
    base_reqs = _reqs()
    base.serve(base_reqs, verify=True, op_order="alternate")
    got, want = _outputs(eng, reqs), _outputs(base, base_reqs)
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        torch.testing.assert_close(got[rid]["first_logits"],
                                   want[rid]["first_logits"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", ["legacy", "ground_truth"])
def test_other_load_paths_restore_fused_bits(mp, path):
    """quant="none": the legacy per-chunk copies, and the ground-truth
    fallback when no store is attached, restore the bits the fused
    datapath restores — all equal to the full-prefill reference."""
    def run(store, datapath):
        eng = _engine(mp, store, system="lmcache", datapath=datapath)
        reqs = [Request("r", 0.0, 40, 8, decode_len=2)]
        eng.serve(reqs, verify=True, op_order="alternate")
        return eng

    fused = run(ChunkStore(chunk_size=8, default_tier="host", device="cpu"), "fused")
    other = run(ChunkStore(chunk_size=8, default_tier="host", device="cpu")
                if path == "legacy" else None, "legacy")
    assert fused.executor.fused_loads > 0
    assert other.executor.fused_loads == 0
    if path == "legacy":
        assert other.executor.legacy_loads > 0
        assert other.executor.load_dispatches > fused.executor.load_dispatches
    ref = fused.executor.store.get("r").kv_reference
    for eng in (fused, other):
        cache = eng.executor.live_cache("r")
        n = ref["kpos"].shape[1]
        for f in ref:
            sl = cache[f][:, :n] if f == "kpos" else cache[f][:, :, :n]
            assert torch.equal(sl, ref[f]), f


def test_fork_restores_parent_chunks_without_prefill(mp):
    store = ChunkStore(chunk_size=8, default_tier="host", device="cpu")
    eng = _engine(mp, store)
    eng.serve([Request("p", 0.0, 32, 8, decode_len=2)], verify=True,
              op_order="alternate")
    puts = store.puts
    eng.serve([Request("c", 0.0, 32, 8, decode_len=2, meta={"fork_of": "p"})],
              verify=True, op_order="alternate")
    assert store.forks == 1 and store.puts == puts       # no new chunks
    assert eng.executor.outputs("c")["tokens"] == eng.executor.outputs("p")["tokens"]
    store.audit()
