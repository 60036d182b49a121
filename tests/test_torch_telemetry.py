"""The port's metrics registry and telemetry (``repro_torch.obs``) against the
reference's (``repro.obs``).

* ``METRIC_CATALOG`` is the reference's, and the port's registry enforces it
  alike (unknown names, wrong types, label drift, negative increments,
  exact-bucket histograms).
* Telemetry is a pure observer: a telemetry-on run gives the telemetry-off
  run's ``EngineResult`` and ``ops_log`` bit for bit (fuzz), and its
  snapshot equals the reference's on the same schedule.
* The serve CLI's ``--metrics-out`` snapshot and ``--timeline-out`` file of
  a simulation equal the reference CLI's byte for byte (the timeline names
  its own module as source), and the report inlines the counters.
* A CPU ``--real`` int8 serve counts ``datapath.kernel_launches_total`` as
  the ``RestoreDatapath`` it ran (``kernel_launches``), the ``CACHEFLOW_TELEMETRY``
  opt-in works and the serving report carries the snapshot.
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

import repro.launch.serve as j_serve  # noqa: E402
import repro.obs as j_obs  # noqa: E402
import repro_torch.launch.serve as t_serve  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
from repro_torch.config import HARDWARE, IO_BANDWIDTHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.trace import result_to_dict  # noqa: E402
from repro_torch.serving import Request, SimServingEngine  # noqa: E402
from test_torch_sanitizer import PKGS, _mk_req, _rng_backend  # noqa: E402

OBS = {"jax": j_obs, "torch": t_obs}


def test_catalog_equals_reference():
    assert t_obs.METRIC_CATALOG == j_obs.METRIC_CATALOG
    assert list(t_obs.METRIC_CATALOG) == list(j_obs.METRIC_CATALOG)


@pytest.mark.parametrize("side", sorted(OBS))
def test_registry_enforces_catalog(side):
    reg = OBS[side].MetricsRegistry()
    with pytest.raises(KeyError):
        reg.counter("engine.warp_core_breaches")
    with pytest.raises(TypeError):
        reg.gauge("engine.admissions_total")             # declared a counter
    with pytest.raises(ValueError):
        reg.counter("engine.dispatches_total")           # missing its label
    with pytest.raises(ValueError):
        reg.counter("engine.admissions_total", kind="x")  # extra label
    a = reg.counter("engine.dispatches_total", kind="load")
    assert a is reg.counter("engine.dispatches_total", kind="load")
    assert a is not reg.counter("engine.dispatches_total", kind="compute")
    c = reg.counter("engine.admissions_total")
    c.inc()
    c.inc(2.5)
    with pytest.raises(ValueError):
        c.inc(-1.0)
    g = reg.gauge("engine.queue_depth")
    g.set(3)
    g.set(5, t=1.5)
    assert (c.value, g.value, g.series) == (3.5, 5.0, [(1.5, 5.0)])


@pytest.mark.property
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_fuzz_histogram_equals_reference(seed):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 200.0, size=int(rng.integers(1, 100)))
    snaps = {}
    for side, obs in OBS.items():
        reg = obs.MetricsRegistry()
        h = reg.histogram("engine.ttft_seconds")
        for v in values:
            h.observe(float(v))
        assert h.count == len(values) == sum(h.bucket_counts)
        snaps[side] = reg.snapshot()
    assert snaps["torch"] == snaps["jax"]


# ---------------------------------------------------------------------------
# Telemetry observes and changes nothing
# ---------------------------------------------------------------------------


def _run(pkg, seed, *, telemetry):
    rng = np.random.default_rng(seed)
    stages = int(rng.integers(1, 3))
    bounds = [(0, 2), (2, 4)] if stages == 2 else None
    policy = ["none", "priority", "deadline"][int(rng.integers(0, 3))]
    evict = policy != "none" and bool(rng.integers(0, 2))
    io_channels = int(rng.integers(1, 3))
    use_store = bool(rng.integers(0, 2))
    kvstore = pkg.TieredKVStore() if use_store else None
    fail = ({int(rng.integers(0, io_channels)): float(rng.uniform(0.5, 3.0))}
            if int(rng.integers(0, 3)) == 0 else None)
    reqs = []
    for i in range(int(rng.integers(3, 8))):
        n = int(rng.integers(16, 160))
        plans = pkg.plans("cacheflow", f"r{i}", n, chunk_size=8, l_delta=0,
                          num_layers=4, stage_bounds=bounds)
        reqs.append(pkg.core.EngineRequest(
            f"r{i}", n, arrival=float(rng.uniform(0, 3.0)), plans=plans,
            new_len=int(rng.integers(0, 3)) * 16,
            decode_len=int(rng.integers(0, 5)),
            priority=int(rng.integers(0, 3)),
            deadline=float(rng.uniform(0.5, 20.0))))
        if kvstore is not None:
            kvstore.put(f"r{i}", n * 1024, tier="remote")
    core = pkg.core.EngineCore(
        _rng_backend(pkg, seed), stages=stages, io_channels=io_channels,
        max_active=int(rng.integers(1, 4)), preempt=policy, evict=evict,
        prefetch=use_store and bool(rng.integers(0, 2)), kvstore=kvstore,
        channel_fail_at=fail, telemetry=telemetry)
    return core.run(reqs), core


@pytest.mark.property
@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_fuzz_telemetry_bit_identical_and_equal_to_reference(seed):
    torch_pkg = PKGS["torch"]
    res_off, core_off = _run(torch_pkg, seed, telemetry=False)
    res_on, core_on = _run(torch_pkg, seed, telemetry=True)
    assert result_to_dict(res_off) == result_to_dict(res_on)
    assert res_off.ops_log == res_on.ops_log
    assert core_off.last_telemetry is None
    tel = core_on.last_telemetry
    assert isinstance(tel, t_obs.Telemetry)
    snap = tel.snapshot()
    assert snap["metrics"]["counters"]["engine.admissions_total"] >= len(res_on.finish)
    assert set(snap["phases"]) == set(res_on.finish)
    json.dumps(snap, allow_nan=False)
    _, j_core = _run(PKGS["jax"], seed, telemetry=True)
    assert snap == j_core.last_telemetry.snapshot()


def test_engine_env_var_opt_in(monkeypatch):
    pkg = PKGS["torch"]
    monkeypatch.setenv("CACHEFLOW_TELEMETRY", "1")
    core = pkg.core.EngineCore(_rng_backend(pkg, 3), stages=1, io_channels=1)
    assert core.telemetry
    core.run([_mk_req(pkg, "r0")])
    assert isinstance(core.last_telemetry, t_obs.Telemetry)
    monkeypatch.setenv("CACHEFLOW_TELEMETRY", "0")
    assert not pkg.core.EngineCore(_rng_backend(pkg, 3), stages=1,
                                   io_channels=1).telemetry


def test_serving_report_carries_telemetry(monkeypatch):
    monkeypatch.delenv("CACHEFLOW_TELEMETRY", raising=False)
    cfg = get_config("qwen3-8b")
    reqs = [Request(f"r{i}", 0.2 * i, prefix_len=4096, new_len=128, decode_len=2)
            for i in range(3)]
    rep = SimServingEngine(cfg, HARDWARE["h100"], io_bandwidth=IO_BANDWIDTHS["10Gbps"],
                           stages=2, max_batch=2, telemetry=True).run(reqs)
    assert rep.telemetry["metrics"]["counters"]["engine.admissions_total"] == 3
    assert len(rep.telemetry["phases"]) == 3
    rep2 = SimServingEngine(cfg, HARDWARE["h100"], io_bandwidth=IO_BANDWIDTHS["10Gbps"],
                            stages=2, max_batch=2).run(
        [Request("s0", 0.0, prefix_len=4096, new_len=128, decode_len=2)])
    assert rep2.telemetry is None


# ---------------------------------------------------------------------------
# The serve CLI's snapshot and timeline files
# ---------------------------------------------------------------------------


def _cli(side, argv, monkeypatch, capsys):
    capsys.readouterr()
    if side == "jax":
        monkeypatch.setattr(sys, "argv", ["serve"] + list(argv))
        j_serve.main()
    else:
        t_serve.main(list(argv))
    return capsys.readouterr().out


SIM_CASES = {
    "swe_bench": ["--workload", "swe_bench", "--requests", "24"],
    "bursty_preempt_evict": ["--workload", "bursty_priority", "--preempt", "priority",
                             "--max-active", "2", "--requests", "24", "--decode-len", "8",
                             "--kv-tier", "remote", "--evict"],
    "prefetch_int8": ["--workload", "multi_tenant", "--requests", "24", "--kv-tier",
                      "remote", "--prefetch", "--max-batch", "2", "--kv-quant", "int8"],
    "llama_two_channels": ["--arch", "llama3.1-8b", "--requests", "16", "--io-channels",
                           "2", "--system", "cacheflow_2d"],
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_metrics_and_timeline_files_same_as_reference(case, tmp_path, monkeypatch,
                                                          capsys):
    files = {}
    for side in ("jax", "torch"):
        m, t = tmp_path / f"{side}.m.json", tmp_path / f"{side}.t.json"
        out = _cli(side, SIM_CASES[case] + ["--hardware", "h100", "--sanitize",
                                            "--metrics-out", str(m), "--timeline-out",
                                            str(t)], monkeypatch, capsys)
        files[side] = (out, m.read_text(), json.loads(t.read_text()))
    for doc in (files["jax"][2], files["torch"][2]):
        doc["otherData"].pop("source")
    assert files["torch"] == files["jax"]
    report = json.loads(files["torch"][0])
    assert report["telemetry"]["counters"] == json.loads(files["torch"][1])["metrics"]["counters"]
    assert report["sanitizer"]["finishes"] == report["lifecycle"]["completed"]
    assert any(e["name"].startswith("tier_bytes:") for e in files["torch"][2]["traceEvents"]
               if e.get("ph") == "C")


def test_real_cpu_int8_counts_the_datapath_launches(tmp_path, monkeypatch, capsys):
    """CACHEFLOW_TELEMETRY=1 on a CPU --real int8 serve: the report's
    telemetry counts the kernel launches the RestoreDatapath counted."""
    monkeypatch.setenv("CACHEFLOW_TELEMETRY", "1")
    m = tmp_path / "m.json"
    rep = json.loads(_cli("torch", ["--real", "--device", "cpu", "--requests", "3",
                                    "--decode-len", "2", "--kv-quant", "int8",
                                    "--metrics-out", str(m)], monkeypatch, capsys))
    counters = rep["telemetry"]["counters"]
    assert rep["datapath"]["kernel_launches"] > 0
    assert counters["datapath.kernel_launches_total"] == rep["datapath"]["kernel_launches"]
    assert counters["engine.admissions_total"] == 3
    snap = json.loads(m.read_text())
    assert snap["metrics"]["counters"] == counters
    assert snap["metrics"]["gauges"]["storage.tier_used_bytes{tier=host}"]["series"]
