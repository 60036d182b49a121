"""The port's serve CLI (``python -m repro_torch.launch.serve``) against the
reference's (``python -m repro.launch.serve``), and the crossover profiler.

Sim mode and analytic replay are the same framework-free arithmetic in both
packages, so on the same argv (``--hardware`` given, since the defaults
differ) the port must print the same report, byte for byte.  Real mode runs
the reduced model in f32 on the CPU (``--device cpu``): its report has the
reference's keys, its trace replays on the device and analytically.  Flags
whose module is not ported yet exit with an error naming the module.
"""
import contextlib
import io
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve as j_serve  # noqa: E402
import repro_torch.launch.serve as t_serve  # noqa: E402
from repro.config import HARDWARE as J_HW  # noqa: E402
from repro.config import IO_BANDWIDTHS as J_IO  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import CostModel as JCost  # noqa: E402
from repro.core.profiler import profile_analytic as j_profile_analytic  # noqa: E402
from repro_torch.config import HARDWARE, IO_BANDWIDTHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import CostModel, RestorationExecutor  # noqa: E402
from repro_torch.core.profiler import (CrossoverProfile, profile_analytic,  # noqa: E402
                                       profile_measured)
from repro_torch.models import Model  # noqa: E402


@pytest.fixture
def cli(monkeypatch, capsys):
    """run(side, argv) -> stdout of that package's serve CLI, in process;
    the reference's main() reads sys.argv, the port's takes argv."""
    def run(side, argv):
        capsys.readouterr()
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["serve"] + list(argv))
            j_serve.main()
        else:
            t_serve.main(list(argv))
        return capsys.readouterr().out
    return run


SIM_ARGV = {
    "swe_bench": ["--workload", "swe_bench", "--requests", "24", "--hardware", "h100"],
    "lmsys_vllm_40g": ["--workload", "lmsys_chat", "--requests", "16", "--system",
                       "vllm", "--bandwidth", "40Gbps", "--hardware", "tpu_v5e"],
    "wildchat_2d_int8": ["--workload", "wildchat", "--requests", "16", "--system",
                         "cacheflow_2d", "--io-channels", "2", "--kv-quant", "int8",
                         "--hardware", "a100"],
    "bursty_preempt": ["--workload", "bursty_priority", "--preempt", "priority",
                       "--max-active", "2", "--requests", "24", "--decode-len", "8",
                       "--kv-tier", "remote", "--evict", "--hardware", "tpu_v5e"],
    "multi_tenant_prefetch": ["--workload", "multi_tenant", "--requests", "24",
                              "--kv-tier", "remote", "--prefetch", "--max-batch", "2",
                              "--hardware", "tpu_v5e"],
    "multi_tenant_gang": ["--workload", "multi_tenant", "--requests", "24",
                          "--kv-tier", "remote", "--admission", "gang",
                          "--hardware", "h100"],
    "rwkv_sglang": ["--arch", "rwkv6-7b", "--workload", "agentic_tree", "--requests",
                    "16", "--system", "sglang", "--hardware", "h100", "--seed", "3"],
    "recurrentgemma_cake": ["--arch", "recurrentgemma-2b", "--requests", "16",
                            "--system", "cake", "--stages", "1", "--hardware", "l40s"],
}


@pytest.mark.parametrize("case", sorted(SIM_ARGV))
def test_sim_report_same_as_reference(cli, case):
    out = cli("torch", SIM_ARGV[case])
    assert out == cli("jax", SIM_ARGV[case])
    rep = json.loads(out)
    assert rep["lifecycle"]["completed"] > 0
    if case == "bursty_preempt":
        assert rep["preemptions"] > 0


@pytest.mark.parametrize("case", ["swe_bench", "bursty_preempt", "multi_tenant_prefetch"])
def test_capture_replay_and_timeline_same_as_reference(cli, case, tmp_path):
    """--trace-out writes the same trace from both CLIs; --replay of it
    prints the same report in both (and equals the capture: each CLI exits
    otherwise); --timeline-out, at capture and at replay, the same
    document but for its source module."""
    traces, timelines = {}, {}
    for side in ("jax", "torch"):
        tr, tl = tmp_path / f"{side}.trace.json", tmp_path / f"{side}.timeline.json"
        cli(side, SIM_ARGV[case] + ["--trace-out", str(tr), "--timeline-out", str(tl)])
        traces[side] = tr.read_text()
        doc = json.loads(tl.read_text())
        doc["otherData"].pop("source")
        timelines[side] = doc
    assert traces["torch"] == traces["jax"]
    assert timelines["torch"] == timelines["jax"]
    path = str(tmp_path / "torch.trace.json")
    replays = {side: cli(side, ["--replay", path, "--timeline-out",
                                str(tmp_path / f"{side}.replay.timeline.json")])
               for side in ("jax", "torch")}
    assert replays["torch"] == replays["jax"]
    assert json.loads(replays["torch"])["mode"] == "replay-sim"


def test_replay_refuses_edited_trace(cli, tmp_path):
    path = tmp_path / "t.json"
    cli("torch", SIM_ARGV["swe_bench"] + ["--trace-out", str(path)])
    d = json.loads(path.read_text())
    d["result"]["makespan"] += 1.0
    path.write_text(json.dumps(d))
    for side in ("jax", "torch"):
        with pytest.raises(SystemExit, match="diverged from the captured"):
            cli(side, ["--replay", str(path)])


def _keys(d):
    """The nested key structure of a report (values differ run to run)."""
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


@pytest.fixture(scope="module")
def reference_real(tmp_path_factory):
    """The reference CLI's real mode on the same argv (reduced, f32): its
    report, and the path of its captured trace."""
    trace = tmp_path_factory.mktemp("ref") / "real.json"
    argv = ["--real", "--requests", "2", "--kv-quant", "int8", "--trace-out", str(trace)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["serve"] + argv)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            j_serve.main()
    return json.loads(buf.getvalue()), trace


def test_real_cpu_runs_replays_and_has_reference_keys(cli, tmp_path, reference_real):
    trace = tmp_path / "real.json"
    rep = json.loads(cli("torch", ["--real", "--device", "cpu", "--requests", "2",
                                   "--kv-quant", "int8", "--trace-out", str(trace)]))
    assert _keys(rep) == _keys(reference_real[0])
    assert rep["mode"] == "real" and rep["lifecycle"]["completed"] == 2
    assert rep["datapath"]["fused_loads"] > 0
    meta = json.loads(trace.read_text())["meta"]
    assert meta["arch"] == "qwen3-8b"
    # on the device (verify on: the replay raises on a mismatch) ...
    real = json.loads(cli("torch", ["--replay", str(trace), "--real", "--device", "cpu"]))
    # ... and analytically (the CLI exits unless it equals the capture)
    sim = json.loads(cli("torch", ["--replay", str(trace)]))
    assert real["mode"] == "replay-real" and sim["mode"] == "replay-sim"
    for k in ("requests", "dispatches", "prefills", "decode_steps", "makespan",
              "compute_busy", "io_busy", "decode_busy"):
        assert real[k] == sim[k], k
    assert real["prefills"] > 0 and real["decode_steps"] > 0


def test_reference_real_trace_replays_in_port_cli(cli, reference_real):
    """The reference CLI's real capture, replayed by the port's CLI on the
    CPU (each package re-prefills its own inputs; verify is on) and
    analytically: both report the captured schedule."""
    rep, trace = reference_real
    real = json.loads(cli("torch", ["--replay", str(trace), "--real", "--device", "cpu"]))
    sim = json.loads(cli("torch", ["--replay", str(trace)]))
    assert real["mode"] == "replay-real"
    assert real["decode_steps"] == sim["decode_steps"] > 0
    assert real["makespan"] == sim["makespan"]
    assert sim["compute_busy"] == rep["compute_busy"]


@pytest.mark.parametrize("arch,store", [("rwkv6-7b", True), ("recurrentgemma-2b", False)])
def test_real_cpu_chunk_store_as_reference(cli, arch, store):
    """As the reference: a chunk store (and its report blocks) exactly
    where the config has no attention window — rwkv6-7b (attention-free)
    takes one, recurrentgemma-2b's windowed caches do not."""
    rep = json.loads(cli("torch", ["--real", "--device", "cpu", "--arch", arch,
                                   "--requests", "2", "--decode-len", "2"]))
    assert ("storage" in rep) == ("datapath" in rep) == store
    assert rep["lifecycle"]["completed"] == 2


REAL_FLAGS = {
    "preempt_evict": ["--preempt", "priority", "--evict", "--max-batch", "1",
                      "--kv-tier", "remote"],
    "gang": ["--admission", "gang", "--max-batch", "2"],
    "prefetch": ["--prefetch", "--max-batch", "1", "--kv-tier", "remote"],
    "io_channels_2": ["--io-channels", "2"],
    "datapath_legacy": ["--datapath", "legacy"],
    "store_dir_int8": ["--kv-tier", "remote", "--kv-quant", "int8", "--store-dir", "{dir}"],
}


@pytest.mark.parametrize("case", sorted(REAL_FLAGS))
def test_real_cpu_engine_flags(cli, tmp_path, case):
    """Each engine and store flag of real mode reaches the port's engine,
    store and datapath: three requests complete, verified."""
    argv = [a.replace("{dir}", str(tmp_path)) for a in REAL_FLAGS[case]]
    rep = json.loads(cli("torch", ["--real", "--device", "cpu", "--requests", "3",
                                   "--decode-len", "2"] + argv))
    assert rep["lifecycle"]["completed"] == 3
    assert rep["datapath"]["mode"] == ("legacy" if case == "datapath_legacy" else "fused")
    if case == "io_channels_2":
        assert rep["datapath"]["channels"] == 2
    if case == "store_dir_int8":
        assert list(tmp_path.glob("*.npz"))


def test_replay_real_refuses_foreign_geometry(cli, tmp_path):
    """A paper-scale sim trace does not fit the reduced model, and a trace
    of another arch is refused by name."""
    path = tmp_path / "sim.json"
    cli("torch", SIM_ARGV["swe_bench"] + ["--trace-out", str(path)])
    with pytest.raises(SystemExit, match="does not fit"):
        cli("torch", ["--replay", str(path), "--real", "--device", "cpu"])
    with pytest.raises(SystemExit, match="captured on arch 'qwen3-8b'"):
        cli("torch", ["--replay", str(path), "--real", "--device", "cpu",
                      "--arch", "rwkv6-7b"])


@pytest.mark.parametrize("argv,env,module", [
    (["--sanitize"], {}, "repro_torch.analysis.sanitizer"),
    ([], {"CACHEFLOW_SANITIZE": "1"}, "repro_torch.analysis.sanitizer"),
    (["--telemetry"], {}, "repro_torch.obs.telemetry"),
    (["--metrics-out", "m.json"], {}, "repro_torch.obs.telemetry"),
    ([], {"CACHEFLOW_TELEMETRY": "1"}, "repro_torch.obs.telemetry"),
    (["--real", "--device", "cpu", "--sanitize"], {}, "repro_torch.analysis.sanitizer"),
])
def test_unported_flags_raise_naming_their_module(cli, monkeypatch, argv, env, module):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=module.replace(".", r"\.")):
        cli("torch", ["--requests", "4"] + argv)


def test_gang_with_preemption_refused_alike(cli):
    argv = ["--admission", "gang", "--preempt", "priority", "--hardware", "h100"]
    msgs = {}
    for side in ("jax", "torch"):
        with pytest.raises(SystemExit) as err:
            cli(side, argv)
        msgs[side] = str(err.value)
    assert msgs["torch"] == msgs["jax"]


# ---------------------------------------------------------------------------
# The crossover profiler (paper Fig. 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,hw,bw", [("qwen3-8b", "h100", "10Gbps"),
                                        ("qwen3-8b", "tpu_v5e", "40Gbps"),
                                        ("rwkv6-7b", "a100", "80Gbps")])
def test_profile_analytic_equal(arch, hw, bw):
    j = j_profile_analytic(JCost(j_get_config(arch), J_HW[hw], J_IO[bw]))
    t = profile_analytic(CostModel(get_config(arch), HARDWARE[hw], IO_BANDWIDTHS[bw]))
    assert (t.lengths, t.t_token, t.t_layer, t.l_delta) == \
        (j.lengths, j.t_token, j.t_layer, j.l_delta)
    assert t.l_delta in t.lengths


def test_profile_measured_on_cpu():
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu")
    ex = RestorationExecutor(model, model.init(torch.Generator().manual_seed(0)),
                             chunk_size=8, stages=2)
    gen = torch.Generator().manual_seed(1)
    lengths = [16, 32, 64]
    prof = profile_measured(
        ex, lambda n: torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                                    dtype=torch.int32),
        lengths=lengths, repeats=1)
    assert isinstance(prof, CrossoverProfile)
    assert prof.lengths == lengths and prof.l_delta in lengths
    assert len(prof.t_token) == len(prof.t_layer) == 3
    assert all(t > 0 for t in prof.t_token + prof.t_layer)
    # the first length where token-wise is no slower, else the last
    want = next((n for n, a, b in zip(lengths, prof.t_token, prof.t_layer) if a <= b),
                lengths[-1])
    assert prof.l_delta == want
    for n in lengths:
        ex.verify(f"prof-{n}")          # each timed restore left a verified cache
