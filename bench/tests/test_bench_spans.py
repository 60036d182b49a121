"""The readers of the program's wall-clock spans, on hand-built spans with
known answers, and on a program that records none (the readers then return
None)."""
import json
import time
from types import SimpleNamespace

import pytest
import torch

from bench_fixtures import ROOT, mix, tiny  # first: the repository on the path
from bench import load_file, run

S = 1_000_000_000           # ns a second
# (name, t0_ns, t1_ns, parent index, request id, count), in opening order;
# the window is [1 s, 2 s]
SPANS = [
    ("engine.restore_load", 1.10 * S, 1.30 * S, -1, "r1", None),
    ("datapath.restore_op", 1.12 * S, 1.28 * S, 0, None, 100),
    ("datapath.pack", 1.13 * S, 1.17 * S, 1, None, 100),
    ("datapath.ring_wait", 1.17 * S, 1.18 * S, 1, None, None),
    ("datapath.measure_wait", 1.25 * S, 1.27 * S, 1, None, None),
    ("engine.device_wait", 1.28 * S, 1.29 * S, 0, "r1", None),
    ("engine.decode_step", 1.40 * S, 1.80 * S, -1, None, 2),
    ("executor.decode_forward", 1.40 * S, 1.50 * S, 6, "r1", None),
    ("executor.token_read", 1.50 * S, 1.55 * S, 6, "r1", None),
    ("executor.decode_forward", 1.55 * S, 1.75 * S, 6, "r2", None),
    ("executor.token_read", 1.75 * S, 1.80 * S, 6, "r2", None),
    ("engine.suffix_prefill", 1.85 * S, 1.90 * S, -1, "r2", 64),
    # outside the window
    ("engine.decode_step", 2.10 * S, 2.20 * S, -1, None, 1),
    ("executor.decode_forward", 2.10 * S, 2.19 * S, 12, "r1", None),
    ("engine.restore_compute", 0.50 * S, 0.70 * S, -1, "r2", 32),
]
ADMIT = {"r1": 0.90, "r2": 0.40, "r3": 1.95}
FIRST = {"r1": 1.35, "r2": 1.90, "r3": 2.50}
EXPECTED = {
    # waits 0.01 + 0.02 + 0.01 + 0.05 + 0.05 s of 1 s
    "engine.device_wait_share": 14.0,
    # top-level spans 0.2 + 0.4 + 0.05 s of 1 s
    "engine.loop_share": 35.0,
    # r1: 1 - 0.2 / 0.45; r2: 1 - (0.2 + 0.05) / 1.5, its restore before
    # the window counted; r3's first token after the window
    "sched.ttft_wait_share": 100.0 * ((1 - 0.2 / 0.45) + (1 - 0.25 / 1.5)) / 2,
    # forwards of 100 and 200 ms in the window
    "model.decode_issue_ms_p50": 150.0,
    # 0.04 s packing of a 0.16 s load op
    "datapath.pack_share": 25.0,
}


def _ctx(stamps):
    return {"stamps": stamps, "t0": 1.0, "t1": 2.0}


def _read(name, ctx):
    return load_file(f"bench/metrics/{name}.py").read(ctx)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_known_answer(name):
    stamps = SimpleNamespace(spans=[tuple(int(v) if isinstance(v, float) else v
                                          for v in s) for s in SPANS],
                             admit=ADMIT, first=FIRST)
    assert _read(name, _ctx(stamps)) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_none_without_spans(name):
    """A program without spans (the attribute absent, as on a program that
    has none, or nothing recorded), or spans all outside the window."""
    for stamps in (SimpleNamespace(admit=ADMIT, first=FIRST),
                   SimpleNamespace(spans=[], admit=ADMIT, first=FIRST),
                   SimpleNamespace(spans=[(n, a + 5 * S, b + 5 * S, p, r, c)
                                          for n, a, b, p, r, c in SPANS[:12]],
                                   admit={}, first={})):
        assert _read(name, _ctx(stamps)) is None


def test_pack_share_none_without_load_ops():
    stamps = SimpleNamespace(spans=[s for s in SPANS if not s[0].startswith("datapath.")],
                             admit=ADMIT, first=FIRST)
    assert _read("datapath.pack_share", _ctx(stamps)) is None
    assert _read("engine.device_wait_share", _ctx(stamps)) == pytest.approx(11.0)


def test_traced_run_reads_the_spans():
    """``--trace 1``'s path on the CPU at the tiny size: the program's spans
    are recorded in the window and all five readers read them."""
    cfg = tiny("qwen3-8b")
    out = run.run_cell(cfg, mix(), 3_000_000_017, 4.0, trace=True,
                       device=torch.device("cpu"), t_process=time.perf_counter())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    result, _ = run.report(spec, "qwen3-8b.chat_cold", cfg, out, trace=True)
    got = result["metrics"]
    assert set(EXPECTED) <= set(got)
    assert 0 < got["engine.loop_share"]["value"] < 100
    # the tiny pool's loads are mostly HBM hits, which pack nothing
    assert 0 <= got["datapath.pack_share"]["value"] < 100
    assert got["model.decode_issue_ms_p50"]["value"] > 0


def test_waits_are_the_catalogs():
    """The wait spans the device-wait share sums are those the program's
    catalog marks as waits."""
    from repro_torch.obs import SPAN_CATALOG
    waits = load_file("bench/metrics/engine.device_wait_share.py").WAITS
    assert set(waits) == {n for n, spec in SPAN_CATALOG.items() if spec["wait"]}
