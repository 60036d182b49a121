"""The reader of ``model.decode_rows_per_forward``: the mean rows of the
window's ``executor.decode_forward`` spans, a span without a count read as
one row, and None on a program that records no spans."""
import json
import time
from types import SimpleNamespace

import pytest
import torch

from bench_fixtures import ROOT, mix, tiny  # first: the repository on the path
from bench import load_file, run

S = 1_000_000_000           # ns a second; the window is [1 s, 2 s]
NAME = "model.decode_rows_per_forward"


def _read(spans):
    stamps = SimpleNamespace(spans=spans, admit={}, first={})
    return load_file(f"bench/metrics/{NAME}.py").read({"stamps": stamps, "t0": 1.0, "t1": 2.0})


def _fwd(t0, rid, count):
    return ("executor.decode_forward", int(t0 * S), int((t0 + 0.05) * S), 0, rid, count)


@pytest.mark.parametrize("spans, rows", [
    # one forward a request, as a program without the batched path records
    ([_fwd(1.1, "r1", None), _fwd(1.2, "r2", None)], 1.0),
    # forwards of 3 and 4 rows and one count-less forward; one of 8 rows
    # outside the window and spans of other names not counted
    ([_fwd(1.1, None, 3), _fwd(1.3, None, 4), _fwd(1.5, "r1", None), _fwd(2.1, None, 8),
      ("executor.token_read", int(1.2 * S), int(1.25 * S), 0, None, 5)], 8 / 3),
], ids=["countless", "batched"])
def test_known_answer(spans, rows):
    assert _read(spans) == pytest.approx(rows, rel=1e-12)


@pytest.mark.parametrize("stamps", [
    SimpleNamespace(admit={}, first={}),                  # no spans attribute
    SimpleNamespace(spans=[], admit={}, first={}),        # nothing recorded
    SimpleNamespace(spans=[_fwd(2.5, None, 4)], admit={}, first={}),   # outside
], ids=["absent", "empty", "outside"])
def test_none_without_forwards(stamps):
    assert load_file(f"bench/metrics/{NAME}.py").read(
        {"stamps": stamps, "t0": 1.0, "t1": 2.0}) is None


def test_traced_run_reads_rows():
    """``--trace 1``'s path on the CPU at the tiny size: the metric is in the
    result line and reads at least one row a forward."""
    cfg = tiny("qwen3-8b")
    out = run.run_cell(cfg, mix(), 3_000_000_019, 4.0, trace=True,
                       device=torch.device("cpu"), t_process=time.perf_counter())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    result, _ = run.report(spec, "qwen3-8b.chat_cold", cfg, out, trace=True)
    assert result["metrics"][NAME]["value"] >= 1
