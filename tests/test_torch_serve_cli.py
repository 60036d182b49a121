"""The port's serve CLI (``python -m repro_torch.launch.serve``) against the
reference's (``python -m repro.launch.serve``), and the crossover profiler.

Sim mode and analytic replay are the same framework-free arithmetic in both
packages, so on the same argv (``--hardware`` given, since the defaults
differ) the port must print the same report, byte for byte.  Real mode runs
the reduced model in f32 on the CPU (``--device cpu``): its report has the
reference's keys, its trace replays on the device and analytically.  The
opt-ins (``--sanitize``, ``--telemetry``, ``--metrics-out`` and their
environment switches) print the reference's report in sim mode, and run
with no violation in real mode; every arch of the registry simulates as in
the reference and builds in the port; ``--real --device cpu`` serves the
MoE, MLA and embedding-input configs, and on a card a config whose bf16
weights exceed its free memory exits naming the bytes.
"""
import contextlib
import dataclasses
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


OPT_INS = {
    "sanitize": (["--sanitize"], {}),
    "env_sanitize": ([], {"CACHEFLOW_SANITIZE": "1"}),
    "telemetry": (["--telemetry"], {}),
    "metrics_out": (["--metrics-out", "{dir}/m.json"], {}),
    "env_telemetry": ([], {"CACHEFLOW_TELEMETRY": "1"}),
    "sanitize_telemetry_metrics": (["--sanitize", "--telemetry", "--metrics-out",
                                    "{dir}/m.json"], {}),
}


@pytest.mark.parametrize("case", sorted(OPT_INS))
def test_opt_ins_sim_report_same_as_reference(cli, monkeypatch, tmp_path, case):
    """The opt-ins run (they used to exit): the port's sim report, with its
    sanitizer and telemetry blocks, and its --metrics-out snapshot equal the
    reference's byte for byte."""
    argv, env = OPT_INS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        out = cli(side, ["--requests", "4", "--hardware", "h100"]
                  + [a.replace("{dir}", str(d)) for a in argv])
        snap = (d / "m.json").read_text() if (d / "m.json").exists() else None
        outs[side] = (out, snap)
    assert outs["torch"] == outs["jax"]
    rep = json.loads(outs["torch"][0])
    assert ("sanitizer" in rep) == ("sanitize" in case)
    assert ("telemetry" in rep) == (case not in ("sanitize", "env_sanitize"))
    if "sanitize" in case:
        assert rep["sanitizer"]["finishes"] == rep["lifecycle"]["completed"] == 4


def _counter_fields():
    from repro.core.profiler import SanitizerCounters
    return {f: None for f in SanitizerCounters().as_dict()}


@pytest.mark.parametrize("case", ["sanitize", "env_sanitize", "sanitize_telemetry_metrics",
                                  "env_telemetry"])
def test_opt_ins_real_cpu(cli, monkeypatch, tmp_path, reference_real, case):
    """``--real --device cpu`` under the opt-ins: the reference's report
    keys plus the sanitizer's counters (the reference's fields) and the
    telemetry counters; the sanitizer raised no violation (it raises)."""
    argv, env = OPT_INS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rep = json.loads(cli("torch", ["--real", "--device", "cpu", "--requests", "3",
                                   "--decode-len", "2", "--kv-quant", "int8"]
                         + [a.replace("{dir}", str(tmp_path)) for a in argv]))
    want = _keys(reference_real[0])
    if "sanitize" in case:
        want["sanitizer"] = _counter_fields()
    keys = _keys(rep)
    if "telemetry" in rep:
        assert rep["telemetry"]["counters"]["engine.admissions_total"] == 3
        keys.pop("telemetry")
    assert keys == want
    assert rep["lifecycle"]["completed"] == 3
    if "sanitize" in case:
        assert rep["sanitizer"]["finishes"] == 3 and rep["sanitizer"]["audits"] > 0


ALL_ARCHS = ["phi4-mini-3.8b", "mistral-large-123b", "qwen1.5-0.5b", "qwen1.5-110b",
             "pixtral-12b", "deepseek-v2-236b", "deepseek-moe-16b", "recurrentgemma-2b",
             "rwkv6-7b", "musicgen-large", "qwen3-8b", "llama3.1-8b", "qwen3-30b-a3b"]


def test_registry_equals_reference():
    from repro.configs import list_archs as j_list_archs
    from repro_torch.configs import list_archs
    assert list_archs() == j_list_archs() == ALL_ARCHS
    for arch in ALL_ARCHS:
        port = dataclasses.asdict(get_config(arch))
        if port["moe"] is not None:
            # the port's MoE layer may hold a share of the experts, which the
            # reference's cannot; every registered config holds them all
            assert (port["moe"].pop("experts_first"), port["moe"].pop("experts_held")) \
                == (0, 0)
        assert port == dataclasses.asdict(j_get_config(arch))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_sim_report_every_arch_same_as_reference(cli, arch):
    argv = ["--arch", arch, "--requests", "8", "--hardware", "h100"]
    out = cli("torch", argv)
    assert out == cli("jax", argv)
    assert json.loads(out)["lifecycle"]["completed"] == 8


FAMILY_ARCHS = ["qwen3-30b-a3b", "deepseek-moe-16b", "deepseek-v2-236b", "pixtral-12b",
                "musicgen-large"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_real_cpu_serves_the_moe_mla_and_embedding_configs(cli, arch):
    """``--real --device cpu`` serves each MoE, MLA and embedding-input
    config (``.reduced()``, f32) from its chunk store, every restored cache
    verified, with the report keys of the reference's real mode."""
    rep = json.loads(cli("torch", ["--real", "--device", "cpu", "--arch", arch,
                                   "--requests", "2", "--decode-len", "2"]))
    assert rep["mode"] == "real" and rep["lifecycle"]["completed"] == 2
    assert rep["datapath"]["fused_loads"] > 0 and "storage" in rep


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_registry_config_builds(arch):
    from repro_torch.models import Model
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == cfg.num_layers
    assert ("embed" in params) == (cfg.input_mode == "tokens")


def test_real_on_a_card_refuses_deepseek_v2_by_free_memory(cli, monkeypatch):
    """deepseek-v2-236b at full depth: 471 GB of bf16 weights against an
    80 GB card's free memory, refused before anything is allocated."""
    import repro_torch.models.model as model_mod
    monkeypatch.setattr(model_mod, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (79_000_000_000,
                                                                    80_000_000_000))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "an 80 GB card")
    weights = 2 * get_config("deepseek-v2-236b").param_counts()["total"]
    assert 460e9 < weights < 480e9
    with pytest.raises(SystemExit, match=f"take {weights} bytes"):
        cli("torch", ["--real", "--arch", "deepseek-v2-236b"])


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "mistral-large-123b"])
def test_real_on_a_card_refuses_weights_past_its_free_memory(cli, monkeypatch, arch):
    """Before anything is allocated: the bf16 weights (2 bytes a parameter)
    against what the card has free, here an 80 GB card's."""
    import repro_torch.models.model as model_mod
    monkeypatch.setattr(model_mod, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (79_000_000_000,
                                                                    80_000_000_000))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "an 80 GB card")
    weights = 2 * get_config(arch).param_counts()["total"]
    assert 200e9 < weights < 260e9
    with pytest.raises(SystemExit, match=f"take {weights} bytes"):
        cli("torch", ["--real", "--arch", arch])


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
