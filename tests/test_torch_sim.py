"""The simulation engine of the port against the JAX package's: the paper's
traffic mixes (``serving/workloads.py``), ``SimServingEngine`` with its
``TieredKVStore``, and ``RestorationSimulator``.

All of it is framework-free Python and numpy in both packages, so the port
must repeat the reference's arithmetic exactly: the same seed gives the same
``Request`` lists, bit for bit, and the same requests give
``ServingReport``s equal field by field with ``==`` on floats (tolerance 0).
"""
import dataclasses
import math

import pytest

pytest.importorskip("torch")

import repro.serving.workloads as j_wl  # noqa: E402
import repro_torch.serving.workloads as t_wl  # noqa: E402
from repro.config import HARDWARE as J_HARDWARE  # noqa: E402
from repro.config import IO_BANDWIDTHS as J_IO  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import CostModel as JCostModel  # noqa: E402
from repro.core import RestorationSimulator as JSimulator  # noqa: E402
from repro.core.baselines import BASELINES  # noqa: E402
from repro.core.baselines import make_baseline_plans as j_plans  # noqa: E402
from repro.core.engine_core import EngineRequest as JEngineRequest  # noqa: E402
from repro.serving import SimServingEngine as JSimEngine  # noqa: E402
from repro.serving import TieredKVStore as JTiered  # noqa: E402
from repro_torch.config import GBPS, HARDWARE, IO_BANDWIDTHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import CostModel, RestorationSimulator  # noqa: E402
from repro_torch.core.baselines import make_baseline_plans  # noqa: E402
from repro_torch.core.engine_core import EngineRequest  # noqa: E402
from repro_torch.serving import SimServingEngine, TieredKVStore  # noqa: E402

ARCHS = ("qwen3-8b", "recurrentgemma-2b", "rwkv6-7b")


def same(a, b) -> bool:
    """``a == b`` all the way down, NaN equal to NaN (no tolerance)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def request_fields(r) -> dict:
    d = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    d["phase"] = r.phase.name          # each package has its own Phase enum
    return d


def test_hardware_tables_equal():
    assert HARDWARE.keys() == J_HARDWARE.keys()
    for k in HARDWARE:
        assert dataclasses.asdict(HARDWARE[k]) == dataclasses.asdict(J_HARDWARE[k])
    assert IO_BANDWIDTHS == J_IO and GBPS == 1e9 / 8


WORKLOAD_CALLS = [(f"generate-{w}", lambda m, s, w=w: m.generate(w, 40, seed=s))
                  for w in j_wl.WORKLOADS] + [
    ("bursty_priority", lambda m, s: m.bursty_priority(40, seed=s, burst_size=4,
                                                       burst_every=2.0)),
    ("multi_tenant", lambda m, s: m.multi_tenant(40, seed=s)),
    ("agentic_tree", lambda m, s: m.agentic_tree(40, seed=s)),
    ("fixed_length", lambda m, s: m.fixed_length(12, 3000)),
]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("call", WORKLOAD_CALLS, ids=[n for n, _ in WORKLOAD_CALLS])
def test_workloads_identical(call, seed):
    _, fn = call
    assert t_wl.WORKLOADS == j_wl.WORKLOADS
    jr, tr = fn(j_wl, seed), fn(t_wl, seed)
    assert len(tr) == len(jr) > 0
    for a, b in zip(tr, jr):
        fa, fb = request_fields(a), request_fields(b)
        assert fa == fb
        # bit for bit: the same numpy scalar types, not just equal values
        assert {k: type(v) for k, v in fa.items()} == {k: type(v) for k, v in fb.items()}


def _report(pkg, arch, system, *, workload="swe_bench", n=24, seed=0, hw="h100",
            bw="10Gbps", store_kw=None, decode_len=None, **kw):
    wl, cfg_of, hwt, iot, store_cls, eng_cls = (
        (j_wl, j_get_config, J_HARDWARE, J_IO, JTiered, JSimEngine) if pkg == "jax" else
        (t_wl, get_config, HARDWARE, IO_BANDWIDTHS, TieredKVStore, SimServingEngine))
    reqs = wl.generate(workload, n, seed=seed)
    for r in reqs if decode_len is not None else ():
        r.decode_len = decode_len
    store = store_cls(remote_bw=iot[bw], **(store_kw or {}))
    eng = eng_cls(cfg_of(arch), hwt[hw], io_bandwidth=iot[bw], system=system,
                  stages=2, max_batch=kw.pop("max_batch", 8), kvstore=store, **kw)
    rep = eng.run(reqs)
    return rep, store, reqs


def _assert_reports_equal(arch, system, **kw):
    jr, js, jq = _report("jax", arch, system, **dict(kw))
    tr, ts, tq = _report("torch", arch, system, **dict(kw))
    for f in dataclasses.fields(jr):
        assert same(getattr(tr, f.name), getattr(jr, f.name)), f.name
    assert ts.io_hits == js.io_hits
    assert ts.placement == js.placement
    assert [request_fields(r) for r in tq] == [request_fields(r) for r in jq]
    return tr


@pytest.mark.parametrize("system", BASELINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sim_engine_reports_equal(arch, system):
    rep = _assert_reports_equal(arch, system)
    assert rep.stats["completed"] == 24


OPTION_CASES = {
    # the verify skill's preemption smoke, with eviction
    "preempt_priority_evict": dict(workload="bursty_priority", preempt="priority",
                                   evict=True, kv_tier="remote", max_batch=2,
                                   decode_len=8, hw="tpu_v5e"),
    "admission_gang": dict(workload="multi_tenant", admission="gang", max_batch=3),
    "prefetch": dict(workload="multi_tenant", kv_tier="remote", prefetch=True,
                     max_batch=3),
    "io_channels_2": dict(io_channels=2),
    "kv_tier_remote": dict(kv_tier="remote", store_kw=dict(quant="int8")),
    "channel_fail_at": dict(io_channels=2, kv_tier="remote", channel_fail_at={1: 2.0}),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sim_engine_option_reports_equal(arch, case):
    rep = _assert_reports_equal(arch, "cacheflow", **OPTION_CASES[case])
    if case == "preempt_priority_evict" and arch == "qwen3-8b":
        assert sum(rep.preemptions.values()) > 0


def test_tiered_kvstore_equal():
    """Puts past the HBM and host capacities cascade demotions; touches,
    promotions and evictions move the same entries in both packages."""
    ops = [("put", f"r{i}", (i + 1) * 7e8, "hbm" if i % 2 else "host") for i in range(9)]
    ops += [("touch", "r1"), ("promote", "r0", "hbm"), ("evict", "r3"),
            ("put", "big", 3e9, "hbm"), ("promote", "r2", "host")]
    stores = [JTiered(hbm_cap=4e9, host_cap=6e9, quant="int8"),
              TieredKVStore(hbm_cap=4e9, host_cap=6e9, quant="int8")]
    for st in stores:
        for op, *a in ops:
            getattr(st, op)(*a)
    js, ts = stores
    assert ts.placement == js.placement
    rids = sorted(js._raw)
    assert [ts.tier_of(r) for r in rids] == [js.tier_of(r) for r in rids]
    assert [ts.bandwidth_for(r) for r in rids] == [js.bandwidth_for(r) for r in rids]
    assert {n: (t.used, list(t.lru.items())) for n, t in ts.tiers.items()} == \
        {n: (t.used, list(t.lru.items())) for n, t in js.tiers.items()}
    for attr in ("demotions", "promotions", "drops"):
        assert getattr(ts.core, attr) == getattr(js.core, attr), attr
    assert js.core.demotions > 0


def test_restoration_simulator_equal():
    """Three requests, two stages, two channels, a straggler channel and a
    per-request bandwidth override: the same EngineResult."""
    def run(cost_cls, sim_cls, req_cls, plans, hw, io, cfg):
        cost = cost_cls(cfg, hw["h100"], io["10Gbps"], mfu=0.45)
        reqs = [req_cls(rid, n, t, plans("cacheflow", rid, n, chunk_size=512,
                                         l_delta=2048, num_layers=cfg.num_layers,
                                         stage_bounds=[(0, 18), (18, 36)]))
                for rid, n, t in (("a", 6000, 0.0), ("b", 1500, 0.1), ("c", 9000, 0.2))]
        sim = sim_cls(cost, stages=2, io_channels=2, channel_slowdown={1: 3.0},
                      bw_override={"b": 40 * 1e9 / 8}, max_active=2)
        return sim.run(reqs)
    jres = run(JCostModel, JSimulator, JEngineRequest, j_plans, J_HARDWARE, J_IO,
               j_get_config("qwen3-8b"))
    tres = run(CostModel, RestorationSimulator, EngineRequest, make_baseline_plans,
               HARDWARE, IO_BANDWIDTHS, get_config("qwen3-8b"))
    # each package has its own EngineResult class: compare field by field
    assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
    assert len(tres.restore_finish) == 3
