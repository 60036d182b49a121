"""A run with its timed path broken underneath comes out not correct.

The harness's look for a card is skipped and the rest of a run driven on
the CPU at a tiny size, the closed loop of two clients with a window of
two seconds (float32 program, so a sound run reads a gap of 0 and the tiny
configuration's limit is 1e-3): once sound, then once for
each fault a serving cell can have — a token altered where it is produced,
a restoration step that returns the cache unchanged, half of a decode
batch left out.  The cells run on one card, so no exchange between chips
can be left out."""
import json
import time

import pytest
import torch

from bench_fixtures import ROOT, mix, tiny  # first: the repository on the path
from bench import run

WINDOW_S = 4.0


def _run(name, tamper=None):
    cfg = tiny(name)
    # outputs long enough that the two clients' decodes always overlap
    out = run.run_cell(cfg, mix(decode_len=[10, 12]), 3_000_000_007, WINDOW_S, trace=False,
                       device=torch.device("cpu"), t_process=time.perf_counter(),
                       tamper=tamper)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    result, _ = run.report(spec, f"{name}.chat_cold", cfg, out, trace=False)
    return result


def alter_token(system):
    ex = system["engine"].executor
    step = ex.decode_step_batch

    def decode_step_batch(rids):
        step(rids)
        toks = ex._live[rids[0]]["tokens_out"]
        toks[-1] = (toks[-1] + 1) % system["cfg"].vocab_size
    ex.decode_step_batch = decode_step_batch


def unchanged_restore(system):
    system["engine"].executor._exec_load = lambda op: None


def half_batch(system):
    ex = system["engine"].executor
    step = ex.decode_step_batch
    ex.decode_step_batch = lambda rids: step(rids[:max(1, len(rids) // 2)])


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-30b-a3b"])
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}


@pytest.mark.parametrize("fault", [alter_token, unchanged_restore, half_batch])
def test_fault_is_not_correct(fault):
    assert not _run("qwen3-8b", fault)["correct"]


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-30b-a3b"])
def test_control_is_not_correct(name):
    """The control — the reference in float8 in the program's place — reads
    every number above the limit that a sound run keeps (tiny size), and
    ``report`` judges it not correct."""
    cfg = tiny(name)
    cfg["check"]["min_tokens"] = 1000        # every request of the window
    out = run.run_cell(cfg, mix(decode_len=[20, 30]), 3_000_000_011, WINDOW_S, trace=False,
                       device=torch.device("cpu"), t_process=time.perf_counter(),
                       control=True)
    for key, limit in cfg["check"]["limits"].items():
        assert out["numbers"][key] <= limit < out["control_numbers"][key]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    sound, _ = run.report(spec, f"{name}.chat_cold", cfg, out, trace=False)
    ctl, _ = run.report(spec, f"{name}.chat_cold", cfg, out, trace=False,
                        numbers=out["control_numbers"])
    assert sound["correct"] and not ctl["correct"]


def test_traced_run_reads_the_layers():
    """``--trace 1``'s path on the CPU: the counters' metrics read, the
    device's (no CUDA events here) left out rather than read as 0."""
    cfg = tiny("qwen3-8b")
    out = run.run_cell(cfg, mix(), 3_000_000_013, WINDOW_S, trace=True,
                       device=torch.device("cpu"), t_process=time.perf_counter())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    result, _ = run.report(spec, "qwen3-8b.chat_cold", cfg, out, trace=True)
    got = set(result["metrics"])
    assert {"engine.ttft_p50_s", "engine.requests_per_s", "engine.clock_ratio",
            "sched.io_token_share",
            "sched.decode_batch_mean", "model.mfu", "device.peak_mem_gb"} <= got
    assert not got & {"device.idle_share", "flash_prefill_roofline",
                      "flash_decode_roofline", "kv_restore_roofline"}
    assert out["spy"].launches["flash_decode"] and out["trace"]["busy_s"] == 0
