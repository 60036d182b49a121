"""The generator's draws: fixed by the seed, the same sizes for every seed."""
import numpy as np

from bench_fixtures import mix, tiny  # first: the repository on the path
from bench import inputs


def test_same_seed_same_plan():
    m, cfg = mix(), tiny()
    a, b = inputs.plan(m, cfg, 2**31 + 7), inputs.plan(m, cfg, 2**31 + 7)
    assert (a.prefix_lens, a.session_order, a.turns) == (b.prefix_lens, b.session_order, b.turns)
    assert np.array_equal(inputs.token_ids(9, 50, 256, 3), inputs.token_ids(9, 50, 256, 3))


def test_seeds_share_sizes_not_order():
    m, cfg = mix(sessions=12, turns=40), tiny()
    plans = [inputs.plan(m, cfg, s) for s in (1, 2, 3_000_000_001)]
    for p in plans[1:]:
        assert p.prefix_lens == plans[0].prefix_lens
        assert sorted(p.turns) == sorted(plans[0].turns)
        assert sorted(p.session_order) == list(range(12))
    assert plans[0].turns != plans[1].turns
    assert not np.array_equal(inputs.token_ids(1, 50, 256, 0), inputs.token_ids(2, 50, 256, 0))


def test_draws_within_ranges():
    """The cell's own mix: ``lmsys_chat``'s ranges, new turns 32-511 and
    outputs 16-127."""
    m = mix(sessions=200, turns=50, new_len=[32, 511], decode_len=[16, 127])
    p = inputs.plan(m, {"serve": {"prefix_cap": 16384}}, 5)
    assert min(p.prefix_lens) >= m["prefix"]["floor"] and max(p.prefix_lens) == 16384
    assert 1500 < float(np.median(p.prefix_lens)) < 4000
    lo, hi = m["new_len"], m["decode_len"]
    assert all(lo[0] <= n <= lo[1] and hi[0] <= d <= hi[1] for n, d in p.turns)
    cell = inputs.plan(json_mix(), {"serve": {"prefix_cap": 16384}}, 5)
    assert {d for _, d in cell.turns} <= set(range(16, 128))
    assert max(d for _, d in cell.turns) > 100 and min(d for _, d in cell.turns) < 30


def json_mix():
    import json
    from bench_fixtures import ROOT
    return json.loads((ROOT / "bench" / "traffic" / "chat_cold.json").read_text())


def test_round_robin_turns():
    p = inputs.plan(mix(), tiny(), 4)
    seen = [p.turn(k).session for k in range(6)]
    assert seen[:3] == p.session_order and seen[3:] == p.session_order
    assert p.turn(1).prefix_len == p.prefix_lens[p.turn(1).session]
    assert (p.clients, p.ramp, p.queue) == (2, 2, 6)
