"""Schedule capture and replay across the two packages.

The ``ScheduleTrace`` JSON is one contract: a trace captured by either
package has the same JSON as the other's capture of the same run, loads in
both (schema v1-v5, by the same upgrades), replays analytically bit for bit
in both, and replays through either package's ``RestorationExecutor`` with
``verify=True`` and an identical ``ops_log``.  Greedy tokens of a replay
equal those of the run it replays (same weights, same inputs, same
schedule).  Divergent or unversioned traces raise the same errors; the
trace linter gives the same findings; the Perfetto exporter the same
document.
"""
import copy
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis.lint_trace as j_lint_cli  # noqa: E402
import repro.analysis.trace_lint as j_lint  # noqa: E402
import repro.core.trace as j_trace  # noqa: E402
import repro.obs.timeline as j_timeline  # noqa: E402
import repro.serving.workloads as j_wl  # noqa: E402
import repro_torch.analysis.lint_trace as t_lint_cli  # noqa: E402
import repro_torch.analysis.trace_lint as t_lint  # noqa: E402
import repro_torch.core.trace as t_trace  # noqa: E402
import repro_torch.obs.timeline as t_timeline  # noqa: E402
import repro_torch.serving.workloads as t_wl  # noqa: E402
from repro.config import HARDWARE as J_HW  # noqa: E402
from repro.config import IO_BANDWIDTHS as J_IO  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import CostModel as JCost  # noqa: E402
from repro.core import EngineCore as JCore  # noqa: E402
from repro.core import EngineRequest as JReq  # noqa: E402
from repro.core import RestorationExecutor as JExecutor  # noqa: E402
from repro.core import SimBackend as JSimBackend  # noqa: E402
from repro.core.baselines import make_baseline_plans as j_plans  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import RealServingEngine as JRealEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SimServingEngine as JSimEngine  # noqa: E402
from repro.serving import TieredKVStore as JTiered  # noqa: E402
from repro_torch.config import HARDWARE, IO_BANDWIDTHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import CostModel, EngineCore, EngineRequest  # noqa: E402
from repro_torch.core import RestorationExecutor, SimBackend  # noqa: E402
from repro_torch.core.baselines import make_baseline_plans  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.serving import RealServingEngine, Request  # noqa: E402
from repro_torch.serving import SimServingEngine, TieredKVStore  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "golden_trace_preempt.json"

# each package's own classes, by side
SIDES = {
    "jax": dict(trace=j_trace, wl=j_wl, cfg=j_get_config, hw=J_HW, io=J_IO,
                tiered=JTiered, sim=JSimEngine, cost=JCost, core=JCore, req=JReq,
                sim_backend=JSimBackend, plans=j_plans, lint=j_lint,
                lint_cli=j_lint_cli, timeline=j_timeline),
    "torch": dict(trace=t_trace, wl=t_wl, cfg=get_config, hw=HARDWARE,
                  io=IO_BANDWIDTHS, tiered=TieredKVStore, sim=SimServingEngine,
                  cost=CostModel, core=EngineCore, req=EngineRequest,
                  sim_backend=SimBackend, plans=make_baseline_plans, lint=t_lint,
                  lint_cli=t_lint_cli, timeline=t_timeline),
}
OTHER = {"jax": "torch", "torch": "jax"}


def result_dict(res) -> dict:
    """An EngineResult of either package as plain data."""
    return dataclasses.asdict(res)


# ---------------------------------------------------------------------------
# Sim captures: same JSON, bit-for-bit analytic replay in both packages
# ---------------------------------------------------------------------------

SIM_CASES = {
    "swe_bench_channel_fail": dict(workload="swe_bench", io_channels=2,
                                   kv_tier="remote", fail=True),
    "bursty_preempt_evict": dict(workload="bursty_priority", preempt="priority",
                                 evict=True, kv_tier="remote", max_batch=2,
                                 decode_len=8, hw="tpu_v5e"),
    "multi_tenant_prefetch": dict(workload="multi_tenant", kv_tier="remote",
                                  prefetch=True, max_batch=2, hw="tpu_v5e"),
}


def sim_capture(side, workload, *, hw="h100", decode_len=None, fail=False,
                max_batch=8, **kw):
    s = SIDES[side]

    def run(fail_at):
        reqs = s["wl"].generate(workload, 16, seed=3)
        for r in reqs if decode_len is not None else ():
            r.decode_len = decode_len
        eng = s["sim"](s["cfg"]("qwen3-8b"), s["hw"][hw],
                       io_bandwidth=s["io"]["10Gbps"], stages=2,
                       max_batch=max_batch, kvstore=s["tiered"](),
                       channel_fail_at=fail_at, **kw)
        rec = s["trace"].TraceRecorder()
        eng.run(reqs, trace=rec)
        return rec.trace

    trace = run(None)
    if fail:
        # channel 1 dies in the middle of its first transfer
        t0, t1 = next((a, b) for a, b, res, _ in trace.captured_result().ops_log
                      if res == "io1")
        trace = run({1: (t0 + t1) / 2})
    return trace


@pytest.fixture(scope="module", params=sorted(SIM_CASES))
def sim_traces(request):
    kw = SIM_CASES[request.param]
    return request.param, {side: sim_capture(side, **kw) for side in SIDES}


def test_sim_capture_same_json(sim_traces):
    name, traces = sim_traces
    assert traces["torch"].to_json() == traces["jax"].to_json()
    t = traces["jax"]
    if name == "swe_bench_channel_fail":
        assert t.aborts() and any(e.kind == "fail" for e in t.events)
    if name == "bursty_preempt_evict":
        assert t.preempts() and t.resumes()
    if name == "multi_tenant_prefetch":
        assert t.prefetch_gates() and t.prefetches()


@pytest.mark.parametrize("captured_by", sorted(SIDES))
def test_sim_capture_replays_in_both(sim_traces, captured_by):
    _, traces = sim_traces
    doc = traces[captured_by].to_json()
    results = {}
    for side in SIDES:
        mod = SIDES[side]["trace"]
        loaded = mod.ScheduleTrace.from_json(doc)
        res = mod.replay_trace(loaded)
        assert res == loaded.captured_result()
        results[side] = result_dict(res)
    assert results["torch"] == results["jax"]


# ---------------------------------------------------------------------------
# Schema upgrades (v1, v2, the committed golden v5 trace)
# ---------------------------------------------------------------------------


def _v1_doc(side) -> dict:
    """As tests/test_lifecycle.py::test_trace_v1_loads_by_upgrade."""
    s = SIDES[side]
    cost = s["cost"](s["cfg"]("qwen3-8b"), s["hw"]["h100"], s["io"]["10Gbps"], mfu=0.45)
    plans = s["plans"]("cacheflow", "r", 4_000, chunk_size=512, l_delta=0,
                       num_layers=cost.cfg.num_layers)
    core = s["core"](s["sim_backend"](cost), stages=1, io_channels=1, strict=True)
    _, trace = s["trace"].capture(core, [s["req"]("r", 4_000, 0.0, plans)])
    d = trace.to_dict()
    d["version"] = 1
    for r in d["requests"]:
        del r["new_len"], r["decode_len"]
    for f in ("first_token", "finish", "decode_busy", "decode_steps"):
        del d["result"][f]
    return d


def _v2_doc(side) -> dict:
    """As tests/test_preemption.py::test_trace_v2_loads_by_upgrade."""
    s = SIDES[side]
    cost = s["cost"](s["cfg"]("qwen3-8b"), s["hw"]["h100"], s["io"]["10Gbps"], mfu=0.45)

    def req(rid, n, arrival=0.0):
        plans = s["plans"]("cacheflow", rid, n, chunk_size=512, l_delta=0,
                           num_layers=cost.cfg.num_layers)
        return s["req"](rid, n, arrival, plans, new_len=128, decode_len=8)
    reqs = [req("bg0", 30_000), req("bg1", 28_000), req("hi0", 1_000, 0.5),
            req("hi1", 1_200, 0.5)]
    core = s["core"](s["sim_backend"](cost), stages=1, io_channels=1,
                     max_active=2, strict=True)
    _, trace = s["trace"].capture(core, reqs)
    d = trace.to_dict()
    d["version"] = 2
    del d["meta"]["preempt"]
    del d["result"]["preemptions"]
    for r in d["requests"]:
        r.pop("priority", None)
        r.pop("deadline", None)
    return d


UPGRADES = {"v1": _v1_doc, "v2": _v2_doc,
            "golden_v5": lambda side: json.loads(GOLDEN.read_text())}


@pytest.mark.parametrize("case", sorted(UPGRADES))
def test_upgraded_traces_load_alike_and_replay(case):
    docs = {side: UPGRADES[case](side) for side in SIDES}
    assert json.dumps(docs["torch"]) == json.dumps(docs["jax"])
    loaded = {side: SIDES[side]["trace"].ScheduleTrace.from_dict(copy.deepcopy(docs[side]))
              for side in SIDES}
    assert loaded["torch"].to_dict() == loaded["jax"].to_dict()
    assert loaded["torch"].version == t_trace.TRACE_VERSION == j_trace.TRACE_VERSION
    replays = {}
    for side, tr in loaded.items():
        res = SIDES[side]["trace"].replay_trace(tr)
        assert res == tr.captured_result()
        replays[side] = result_dict(res)
    assert replays["torch"] == replays["jax"]


def test_event_registries_equal():
    assert t_trace.EVENT_KINDS == j_trace.EVENT_KINDS
    assert t_trace.EVENT_REQUIRED_FIELDS == j_trace.EVENT_REQUIRED_FIELDS


# ---------------------------------------------------------------------------
# Errors: ReplayDivergence and TraceVersionError in the same cases
# ---------------------------------------------------------------------------


def _swap_dispatches(d):
    disp = [e for e in d["events"] if e["kind"] == "dispatch"]
    j = next(k for k, e in enumerate(disp) if e["op"] != disp[0]["op"])
    disp[0]["op"], disp[j]["op"] = disp[j]["op"], disp[0]["op"]


def _truncate(d):
    disp = [i for i, e in enumerate(d["events"]) if e["kind"] == "dispatch"]
    d["events"] = d["events"][:disp[len(disp) // 2]]


def _tamper_decode(d):
    step = next(e for e in d["events"] if e["kind"] == "decode_step"
                and len(e["requests"]) > 1)
    step["requests"] = step["requests"][::-1]


def _extra_dispatch(d):
    d["events"].append(copy.deepcopy(next(e for e in d["events"]
                                          if e["kind"] == "dispatch")))


def _drop_gate(d):
    d["events"].remove(next(e for e in d["events"] if e["kind"] == "gate"))


def _version(v):
    def mutate(d):
        if v is None:
            del d["version"]
        else:
            d["version"] = v
    return mutate


ERROR_CASES = {
    "swapped_dispatches": (_swap_dispatches, "ReplayDivergence"),
    "truncated": (_truncate, "ReplayDivergence"),
    "decode_participants": (_tamper_decode, "ReplayDivergence"),
    "unreplayed_dispatch": (_extra_dispatch, "ReplayDivergence"),
    "dropped_gate": (_drop_gate, "ReplayDivergence"),
    "version_99": (_version(99), "TraceVersionError"),
    "version_0": (_version(0), "TraceVersionError"),
    "no_version": (_version(None), "TraceVersionError"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_raised_alike(case):
    mutate, exc = ERROR_CASES[case]
    base = sim_capture("jax", "multi_tenant", kv_tier="remote", max_batch=3)
    assert base.gates() and len(base.decode_steps()) > 1
    d = base.to_dict()
    mutate(d)
    messages = {}
    for side in SIDES:
        mod = SIDES[side]["trace"]
        with pytest.raises(getattr(mod, exc)) as err:
            mod.replay_trace(mod.ScheduleTrace.from_dict(copy.deepcopy(d)))
        messages[side] = str(err.value)
    assert messages["torch"] == messages["jax"]


# ---------------------------------------------------------------------------
# The trace linter: same findings on valid and broken traces
# ---------------------------------------------------------------------------


def _first(t, kind, pred=lambda e: True):
    return next(e for e in t.events if e.kind == kind and pred(e))


def _m_unknown_kind(t):
    _first(t, "admit").kind = "warp"


def _m_missing_op(t):
    _first(t, "dispatch").op = None


def _m_time_regression(t):
    t.events[len(t.events) // 2].t = -1.0


def _m_completion_time(t):
    _first(t, "complete", lambda e: e.op["kind"] in ("compute", "load")).t += 1e-9


def _m_channel_overlap(t):
    d = _first(t, "dispatch")
    dup = copy.deepcopy(d)
    t.events.insert(t.events.index(d) + 1, dup)


def _m_dropped_finish(t):
    t.events.remove(_first(t, "finish"))


def _m_admit_over_cap(t):
    t.meta["max_active"] = 1


LINT_MUTANTS = {"clean": None, "unknown_kind": _m_unknown_kind,
                "missing_op": _m_missing_op, "time_regression": _m_time_regression,
                "completion_time": _m_completion_time,
                "channel_overlap": _m_channel_overlap,
                "dropped_finish": _m_dropped_finish,
                "admit_over_cap": _m_admit_over_cap}


def _findings(side, trace, **kw):
    return [(f.rule, f.message, f.event_index, f.t)
            for f in SIDES[side]["lint"].lint_trace(trace, **kw)]


@pytest.mark.parametrize("mutant", sorted(LINT_MUTANTS))
def test_lint_same_findings(sim_traces, mutant):
    _, traces = sim_traces
    doc = traces["jax"].to_json()
    found = {}
    for side in SIDES:
        t = SIDES[side]["trace"].ScheduleTrace.from_json(doc)
        if LINT_MUTANTS[mutant] is not None:
            LINT_MUTANTS[mutant](t)
        found[side] = _findings(side, t)
    assert found["torch"] == found["jax"]
    assert bool(found["torch"]) == (mutant != "clean")


def _crafted(side, events, requests, meta=None):
    """As tests/test_sanitizer.py's hand-made gate-inversion, starvation
    and prefetch-race traces."""
    mod = SIDES[side]["trace"]
    base = {"max_active": 4, "evict": False, "io_policy": "longest_remaining",
            "stage_parallel": True}
    base.update(meta or {})
    return mod.ScheduleTrace(meta=base, requests=requests,
                             events=[mod.TraceEvent(**e) for e in events])


def _plan_d(rid, n):
    return {"request_id": rid, "n_tokens": n, "chunk_size": 8, "strategy": "token",
            "layer_lo": 0, "layer_hi": 4, "stage": 0, "comp_enabled": True,
            "io_enabled": True}


def _op_d(kind, rid, unit, stage=0):
    return {"kind": kind, "request_id": rid, "stage": stage, "unit": unit,
            "tokens": [0, 8], "layers": [0, 4]}


def _crafted_cases():
    two = [{"request_id": "big", "plans": [_plan_d("big", 64)]},
           {"request_id": "small", "plans": [_plan_d("small", 16)]}]
    inversion = [dict(kind="admit", t=0.0, request_id="big"),
                 dict(kind="admit", t=0.0, request_id="small"),
                 dict(kind="dispatch", t=0.0, resource="io0",
                      op=_op_d("load", "small", 1), duration=1.0)]
    starve = [dict(kind="admit", t=0.0, request_id="big"),
              dict(kind="admit", t=0.0, request_id="small")]
    t = 0.0
    for u in range(7, 1, -1):
        starve.append(dict(kind="dispatch", t=t, resource="io0",
                           op=_op_d("load", "big", u), duration=2.0))
        t += 2.0
        starve.append(dict(kind="complete", t=t, resource="io0",
                           op=_op_d("load", "big", u)))
    pf = _op_d("prefetch", "q", 0, stage=-1)
    race = [dict(kind="prefetch_gate", t=0.0, request_id="q", allowed=True),
            dict(kind="dispatch", t=0.0, resource="io0", op=pf, duration=5.0),
            dict(kind="admit", t=2.0, request_id="q"),
            dict(kind="complete", t=5.0, resource="io0", op=dict(pf))]
    q = [{"request_id": "q", "plans": [_plan_d("q", 16)]}]
    return {"gate_inversion": (inversion, two, {}),
            "starvation": (starve, two, dict(starvation_bound=3.0)),
            "prefetch_race": (race, q, {})}


@pytest.mark.parametrize("case", ["gate_inversion", "starvation", "prefetch_race"])
def test_lint_same_findings_crafted(case):
    events, requests, kw = _crafted_cases()[case]
    found = {side: _findings(side, _crafted(side, copy.deepcopy(events),
                                            copy.deepcopy(requests)), **kw)
             for side in SIDES}
    assert found["torch"] == found["jax"]
    assert case.replace("_", "-") in {f[0] for f in found["torch"]}


def test_lint_cli_exit_codes_alike(tmp_path, capsys):
    clean = tmp_path / "clean.json"
    clean.write_text(GOLDEN.read_text())
    broken = json.loads(GOLDEN.read_text())
    broken["events"].remove(next(e for e in broken["events"] if e["kind"] == "finish"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(broken))
    unversioned = dict(broken)
    del unversioned["version"]
    nover = tmp_path / "nover.json"
    nover.write_text(json.dumps(unversioned))
    for path, code in ((clean, 0), (bad, 1), (nover, 2)):
        outs = {}
        for side in SIDES:
            assert SIDES[side]["lint_cli"].main([str(path), "--json"]) == code
            outs[side] = capsys.readouterr()
        assert outs["torch"].out == outs["jax"].out


# ---------------------------------------------------------------------------
# The Perfetto exporter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strip_result", [False, True])
def test_timeline_same_document(sim_traces, strip_result):
    _, traces = sim_traces
    docs = {}
    for side in SIDES:
        t = SIDES[side]["trace"].ScheduleTrace.from_json(traces["jax"].to_json())
        if strip_result:
            t.result = None      # rebuilt from the pinned dispatch durations
        doc = SIDES[side]["timeline"].trace_to_chrome(t)
        # the one difference: each names its own module as the source
        assert doc["otherData"].pop("source") == SIDES[side]["timeline"].__name__
        docs[side] = doc
    assert json.dumps(docs["torch"]) == json.dumps(docs["jax"])
    assert len(docs["torch"]["traceEvents"]) > 0


def test_timeline_cli(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(GOLDEN.read_text())
    out = {}
    for side in SIDES:
        dst = tmp_path / f"{side}.json"
        assert SIDES[side]["timeline"].main([str(path), "-o", str(dst)]) == 0
        doc = json.loads(dst.read_text())
        doc["otherData"].pop("source")
        out[side] = doc
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# Real replays across the packages (reduced qwen3-8b, f32, CPU)
# ---------------------------------------------------------------------------

LENS = {"a": 40, "b": 24, "c": 32}
NEW, DECODE = {"a": 8, "b": 8, "c": 8}, {"a": 4, "b": 3, "c": 4}


@pytest.fixture(scope="module")
def models():
    cfg_j = j_get_config("qwen3-8b").reduced()
    jm = build_model(cfg_j)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("qwen3-8b").reduced(), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _inputs(cfg, seed=11):
    rng = np.random.default_rng(seed)
    toks = {rid: rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
            for rid, n in LENS.items()}
    suffix = {rid: rng.integers(0, cfg.vocab_size, (1, NEW[rid])).astype(np.int32)
              for rid in LENS}
    return toks, suffix


def _executor(side, models, trace, toks, suffix):
    """A fresh executor of ``side`` holding every traced request's ground
    truth and suffix, on the same weights and numpy inputs."""
    jm, jp, tm, tp = models
    chunk = {p["chunk_size"] for r in trace.requests for p in r["plans"]}.pop()
    stages = trace.meta["stages"]
    if side == "jax":
        ex, conv = JExecutor(jm, jp, chunk_size=chunk, stages=stages), jnp.asarray
    else:
        ex = RestorationExecutor(tm, tp, chunk_size=chunk, stages=stages)

        def conv(a):
            return torch.from_numpy(np.array(a))
    for r in trace.requests:
        rid = r["request_id"]
        ex.remember(rid, conv(toks[rid]))
        if r.get("new_len", 0) or r.get("decode_len", 0):
            ex.set_suffix(rid, conv(suffix[rid]) if r.get("new_len") else None,
                          decode_len=r.get("decode_len", 0))
    return ex


def _replay_real(side, models, trace_doc, toks, suffix):
    mod = SIDES[side]["trace"]
    trace = mod.ScheduleTrace.from_json(trace_doc)
    ex = _executor(side, models, trace, toks, suffix)
    res = mod.replay_trace(trace, ex, verify=True)     # verify raises on mismatch
    assert res.ops_log == trace.captured_result().ops_log
    assert res.restore_finish == trace.captured_result().restore_finish
    return res, {rid: ex.outputs(rid)["tokens"] for rid in LENS}


def test_reference_sim_trace_with_failure_replays_on_both_executors(models):
    cfg = j_get_config("qwen3-8b").reduced()
    cost = JCost(cfg, J_HW["h100"], J_IO["10Gbps"], mfu=0.45)
    bounds = [(0, cfg.num_layers // 2), (cfg.num_layers // 2, cfg.num_layers)]

    def reqs():
        return [JReq(rid, n, 0.0, j_plans("cacheflow", rid, n, chunk_size=8, l_delta=16,
                                          num_layers=cfg.num_layers, stage_bounds=bounds),
                     new_len=NEW[rid], decode_len=DECODE[rid])
                for rid, n in LENS.items()]
    kw = dict(stages=2, io_channels=2, strict=True)
    dry = JCore(JSimBackend(cost, benefit_gate=False), **kw).run(reqs())
    t0, t1 = next((a, b) for a, b, res, _ in dry.ops_log if res == "io1")
    core = JCore(JSimBackend(cost, benefit_gate=False), channel_fail_at={1: (t0 + t1) / 2},
                 **kw)
    _, trace = j_trace.capture(core, reqs())
    assert trace.aborts() and trace.decode_steps()
    toks, suffix = _inputs(cfg)
    tokens = {side: _replay_real(side, models, trace.to_json(), toks, suffix)[1]
              for side in SIDES}
    assert tokens["torch"] == tokens["jax"]


def test_real_captures_replay_across_packages(models):
    """The reference's real capture replays on the port's executor and the
    port's real capture on the reference's, each with verify and the
    captured ops_log; the replays' greedy tokens equal the captures'."""
    jm, jp, tm, tp = models
    kw = dict(system="cacheflow", stages=2, chunk_size=8, l_delta=16, max_batch=2)
    je = JRealEngine(jm, jp, **kw)
    te = RealServingEngine(tm, tp, device="cpu", **kw)
    for side, eng, req_cls in (("jax", je, JRequest), ("torch", te, Request)):
        rec = SIDES[side]["trace"].TraceRecorder()
        reqs = [req_cls(rid, 0.0, n, NEW[rid], decode_len=DECODE[rid])
                for rid, n in LENS.items()]
        eng.serve(reqs, verify=True, trace=rec)
        assert rec.trace.prefills() and rec.trace.decode_steps()
        toks = {rid: np.asarray(eng._inputs(n)) for rid, n in LENS.items()}
        suffix = {rid: np.asarray(eng._inputs(NEW[rid])) for rid in LENS}
        captured = {rid: eng.executor.outputs(rid)["tokens"] for rid in LENS}
        _, replayed = _replay_real(OTHER[side], models, rec.trace.to_json(), toks, suffix)
        assert replayed == captured
