"""The ``qwen3-30b-a3b`` configuration (one chip's expert-parallel share,
from an unquantized host tier), its reference and its two metrics, on the
CPU at a tiny size.

* The file is the published model at full width with 64 of its 128
  experts a layer held, served from the bf16 tier, in the benchmark's
  cell.
* Cut to a tiny size (float32, 8 experts of which 4 held, top 2), it
  serves through ``serve.build`` from the unquantized store and matches
  ``bench/reference/qwen3_moe_share.py`` to float32 rounding, chip 0's
  share and chip 1's alike; the reference's shares of a layer add up to
  the uncut reference's layer, and holding every expert it is the uncut
  reference.
* A run of the cut file is correct, and its float8 control reads above
  the file's own limits; so does a run with its timed path broken
  underneath by each fault of ``test_bench_faults.py`` (a token altered
  where it is produced, a restoration step that returns the cache
  unchanged, half of a decode batch left out), judged by the file's own
  limits.
* ``moe.issue_share`` and ``moe.decode_share`` read hand-built spans with
  known answers, None without the ``model.moe`` spans (a program that has
  none), and a CPU traced run.
"""
import json
import time
from types import SimpleNamespace

import pytest
import torch

from bench_fixtures import ROOT, mix  # first: the repository on the path
from bench import inputs, load_file, run, serve, weights
from bench.reference import qwen3
from test_bench_faults import alter_token, half_batch, unchanged_restore

NAME = "qwen3-30b-a3b"
CELL = f"{NAME}.chat_cold"
SHARE = load_file("bench/reference/qwen3_moe_share.py")


def _file():
    return json.loads((ROOT / "bench" / "configs" / f"{NAME}.json").read_text())


def tiny_share(first: int = 0) -> dict:
    """The configuration file cut to a CPU-sized model as the benchmark's
    other CPU tests cut theirs (float32, 2 layers of width 64, 4 query
    heads over 2 KV heads of 16, vocabulary 256, chunks of 32), its MoE to
    8 experts, top 2, width 32, of which the 4 from ``first`` are held; the
    file's unquantized store and limits kept."""
    cfg = _file()
    cfg["hf"].update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=16, intermediate_size=96,
                     vocab_size=256, torch_dtype="float32", num_experts=8,
                     num_experts_per_tok=2, moe_intermediate_size=32, experts_held=4,
                     experts_first=first)
    cfg["port_fields"]["experts_first"] = "moe.experts_first"
    cfg["engine"].update(chunk_size=32, l_delta=64, host_tier_bytes=1 << 30)
    cfg["serve"].update(prefix_cap=200, warmup={"prefix_len": 70, "turns": [[20, 3], [5, 2]]})
    cfg["check"]["min_tokens"] = 16
    return cfg


def test_file_is_the_published_model_as_a_share():
    cfg = _file()
    hf = cfg["hf"]
    assert (hf["num_hidden_layers"], hf["hidden_size"], hf["num_attention_heads"],
            hf["num_key_value_heads"], hf["head_dim"], hf["vocab_size"]) \
        == (48, 2048, 32, 4, 128, 151936)
    assert (hf["num_experts"], hf["num_experts_per_tok"], hf["moe_intermediate_size"],
            hf["norm_topk_prob"], hf["decoder_sparse_step"]) == (128, 8, 768, True, 1)
    assert hf["experts_held"] == 64 and list(cfg["reduced"]) == ["experts_held"]
    assert set(cfg["check"]["limits"]) == {"logit_gap", "logit_rms", "logit_err"}
    assert cfg["engine"]["quant"] == "none"
    assert cfg["reference"] == "bench/reference/qwen3_moe_share.py"
    pcfg = serve.port_config(cfg)
    assert pcfg.num_layers == 48 and pcfg.moe.held_range == (0, 64)
    assert (pcfg.moe.num_experts, pcfg.moe.top_k, pcfg.moe.expert_d_ff) == (128, 8, 768)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in spec["configs"] if c["name"] == NAME)
    assert conf["file"] == f"bench/configs/{NAME}.json" and conf["reduced"] == ["experts_held"]
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (NAME, "chat_cold", 1)
    for m in ("moe.issue_share", "moe.decode_share"):
        assert next(x for x in spec["per_layer"] if x["name"] == m)["workloads"] == [CELL]


@pytest.mark.parametrize("first", [0, 4])
def test_share_serves_and_matches_reference(first):
    """One request forked from a remembered session, restored from the
    unquantized host tier, prefilled and decoded: its logits are the
    reference's to float32 rounding, and so is the restored cache."""
    cfg = tiny_share(first)
    prefix, new, dec = 150, 20, 6
    system = serve.build(cfg, 1, 11, torch.device("cpu"))
    assert system["cfg"].moe.held_range == (first, 4)
    assert system["params"]["layers"][0]["moe"]["w_up"].shape[0] == 4
    eng, vocab = system["engine"], cfg["hf"]["vocab_size"]
    ids = torch.from_numpy(inputs.token_ids(11, prefix, vocab, 0))
    eng.executor.remember("session-0", ids[None])
    eng.serve([serve.Request("r-0", 0.0, prefix, new, decode_len=dec,
                             meta={"fork_of": "session-0"})], verify=False)
    out = eng.executor.outputs("r-0")
    suffix = torch.from_numpy(inputs.suffix_ids(11, new, vocab))
    seq = torch.cat([ids.long(), suffix.long(), torch.tensor(out["tokens"][:-1])])
    keys = []
    ref = SHARE.logits(cfg["hf"], system["params"], seq, prefix + new - 1, keys=keys)
    port = torch.cat([out["first_logits"]] + out["step_logits"]).float()
    assert port.shape == ref.shape == (dec, vocab)
    assert float((port - ref).abs().max()) <= 2e-5
    live = eng.executor.live_cache("r-0")
    for slot, (k, v) in enumerate(keys):
        for field, want in (("k", k), ("v", v)):
            got = live[field][slot, 0, :prefix].float()
            assert float((got - want[:prefix]).abs().max()) <= 2e-5


def test_reference_shares_add_up_to_the_uncut_reference():
    cfg = tiny_share()
    hf = dict(cfg["hf"], experts_held=8)
    w = weights.make(serve.Model(serve.port_config(cfg | {"hf": hf}),
                                 device="cpu").param_specs(), 5, torch.device("cpu"))
    p = w["layers"][0]["moe"]
    h = torch.randn((12, 64), generator=torch.Generator().manual_seed(2))
    pr = qwen3.Products("f32")
    whole = qwen3.moe_ffn(pr, p, h, 2)
    parts = sum(SHARE.moe_share_ffn(pr, {k: v[f:f + 4] if k != "router" else v
                                         for k, v in p.items()}, h, 2, f)
                for f in (0, 4))
    assert float((parts - whole).abs().max()) <= 1e-6
    ids = torch.from_numpy(inputs.token_ids(5, 40, 256, 0)).long()
    assert torch.equal(SHARE.logits(hf, w, ids, 30), qwen3.logits(hf, w, ids, 30))


def test_run_is_correct_and_control_exceeds_the_files_limits():
    cfg = tiny_share()
    limits = _file()["check"]["limits"]
    cfg["check"]["min_tokens"] = 1000            # every request of the window
    out = run.run_cell(cfg, mix(decode_len=[20, 30]), 3_000_000_019, 6.0, trace=False,
                       device=torch.device("cpu"), t_process=time.perf_counter(),
                       control=True)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    sound, _ = run.report(spec, CELL, cfg, out, trace=False)
    ctl, _ = run.report(spec, CELL, cfg, out, trace=False, numbers=out["control_numbers"])
    assert sound["correct"] and not ctl["correct"]
    assert set(sound["checks"]) == set(limits)
    assert any(out["control_numbers"][k] > lim for k, lim in limits.items())
    for k, lim in limits.items():
        assert out["numbers"][k] <= lim


@pytest.mark.parametrize("fault", [alter_token, unchanged_restore, half_batch])
def test_fault_is_not_correct_by_the_files_limits(fault):
    """An altered token leaves the served logits the reference's (it is
    teacher-forced on the served tokens): ``logit_gap`` alone sees it."""
    cfg = tiny_share()
    assert cfg["check"]["limits"] == _file()["check"]["limits"]
    out = run.run_cell(cfg, mix(decode_len=[10, 12]), 3_000_000_007, 4.0, trace=False,
                       device=torch.device("cpu"), t_process=time.perf_counter(),
                       tamper=fault)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    result, _ = run.report(spec, CELL, cfg, out, trace=False)
    assert out["attempted"] > 0 and not result["correct"]


S = 1_000_000_000           # ns a second
# (name, t0_ns, t1_ns, parent index, request id, count); the window is
# [1 s, 2 s]
SPANS = [
    ("engine.restore_compute", 1.00 * S, 1.30 * S, -1, "r1", 256),
    ("executor.compute", 1.00 * S, 1.30 * S, 0, "r1", None),
    ("model.moe", 1.05 * S, 1.15 * S, 1, None, 256),
    ("model.moe", 1.20 * S, 1.25 * S, 1, None, 256),
    ("engine.decode_step", 1.40 * S, 1.80 * S, -1, None, 2),
    ("executor.decode_forward", 1.40 * S, 1.60 * S, 4, None, 2),
    ("model.moe", 1.45 * S, 1.50 * S, 5, None, 2),
    ("model.moe", 1.52 * S, 1.55 * S, 5, None, 2),
    ("executor.token_read", 1.60 * S, 1.80 * S, 4, None, 2),
    # outside the window
    ("engine.decode_step", 2.10 * S, 2.30 * S, -1, None, 1),
    ("executor.decode_forward", 2.10 * S, 2.20 * S, 9, None, 1),
    ("model.moe", 2.11 * S, 2.19 * S, 10, None, 1),
]
EXPECTED = {
    # 0.10 + 0.05 + 0.05 + 0.03 s of 1 s
    "moe.issue_share": 23.0,
    # 0.08 s of the 0.2-s forward in the window
    "moe.decode_share": 40.0,
}


def _stamps(spans):
    return SimpleNamespace(spans=[tuple(int(v) if isinstance(v, float) else v
                                        for v in s) for s in spans])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_moe_reader_known_answer(name):
    ctx = {"stamps": _stamps(SPANS), "t0": 1.0, "t1": 2.0}
    assert load_file(f"bench/metrics/{name}.py").read(ctx) \
        == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_moe_reader_none_without_moe_spans(name):
    """No spans attribute, none recorded, spans but no ``model.moe`` (the
    program before this layer had one, or a dense model), or all outside
    the window."""
    read = load_file(f"bench/metrics/{name}.py").read
    for stamps in (SimpleNamespace(), _stamps([]),
                   _stamps([s for s in SPANS if s[0] != "model.moe"]),
                   _stamps([(n, a + 5 * S, b + 5 * S, p, r, c) for n, a, b, p, r, c in SPANS])):
        assert read({"stamps": stamps, "t0": 1.0, "t1": 2.0}) is None


def test_traced_run_reads_the_moe_spans():
    cfg = tiny_share()
    out = run.run_cell(cfg, mix(), 3_000_000_023, 6.0, trace=True,
                       device=torch.device("cpu"), t_process=time.perf_counter())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    result, _ = run.report(spec, CELL, cfg, out, trace=True)
    got = result["metrics"]
    assert 0 < got["moe.issue_share"]["value"] < 100
    assert 0 < got["moe.decode_share"]["value"] < 100
    assert got["model.decode_rows_per_forward"]["value"] >= 1
    assert out["spy"].launches["kv_restore"]
