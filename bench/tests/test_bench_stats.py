"""Percentiles, rates and the union-of-intervals idle share."""
import numpy as np
import pytest

import bench_fixtures  # noqa: F401  (the repository on the path)
from bench import stats


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100):
        xs = rng.random(n).tolist()
        for q in (10, 50, 90):
            assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_request_metrics_over_every_request():
    """Requests in the window [1, 4]: TTFT of every first token in it, TPOT
    and the request rate of every request that finished in it, the token
    rate of every first token and decode dispatch in it."""
    admit = {"a": 0.0, "b": 1.0, "c": 2.0, "d": 3.0, "e": 0.0}
    first = {"a": 0.5, "b": 2.0, "c": 2.25, "d": 3.5, "e": 0.25}
    finish = {"a": 1.5, "b": 4.0, "c": 3.25, "e": 0.75}
    out = {"a": 3, "b": 5, "c": 1, "e": 2}
    decodes = [(0.5, [("e", 0)]), (1.25, [("a", 0), ("b", 0)]), (3.0, [("b", 1)]),
               (3.75, [("b", 2), ("d", 0)]), (4.5, [("d", 1)])]
    m = stats.request_metrics(admit, first, finish, out, decodes, 1.0, 4.0)
    assert m["done"] == ["a", "b", "c"] and m["requests_per_s"] == 1.0
    assert sorted(m["ttft"]) == [0.25, 0.5, 1.0] and m["ttft_p50_s"] == 0.5
    assert sorted(m["tpot"]) == [0.5, 0.5]          # c served one token
    assert m["tpot_p50_ms"] == 500.0
    assert m["output_tokens_per_s"] == (3 + 5) / 3.0
    # a request that never finished is not counted as completed
    del finish["c"]
    assert stats.request_metrics(admit, first, finish, out, decodes, 1.0, 4.0)["completed"] == 2


def test_union_counts_overlap_once():
    ivs = [(0, 4), (1, 2), (3, 6), (8, 9), (8.5, 10)]
    assert stats.union_length(ivs) == 8
    # a per-stream sum would count (1, 2), (3, 4) and (8.5, 9) twice
    assert sum(b - a for a, b in ivs) == 10.5


def test_idle_gaps_longest_first():
    ivs = [(2, 3), (0, 1), (6, 7)]
    assert stats.idle_gaps(ivs, 0, 10) == [(3, 6), (7, 10), (1, 2)]
    assert stats.idle_gaps([], 0, 1) == [(0, 1)]
