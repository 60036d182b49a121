"""Arithmetic of the end-to-end metrics and of the device's idle share.

Every statistic is taken over all requests of the window: no sample is
dropped.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    closest ranks (numpy's default), over every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def request_metrics(admit: Dict[str, float], first: Dict[str, float],
                    finish: Dict[str, float], outputs: Dict[str, int],
                    decodes: List[tuple], t0: float, t1: float) -> dict:
    """Wall-clock metrics of the window [t0, t1] from a run's stamps.

    TTFT is ``first - admit`` of every request whose first token came in
    the window; a request's time per output token is ``(finish - first) /
    (outputs - 1)`` of every request that finished in it, and so is the
    request rate; the token rate counts the first tokens and the decode
    dispatches' tokens (``decodes``: (wall, participants)) in the window,
    those of requests still in flight at its close included, over its wall
    seconds."""
    span = t1 - t0
    inside = lambda t: t0 <= t <= t1                      # noqa: E731
    done = sorted(r for r, t in finish.items() if inside(t) and r in first)
    ttft = [first[r] - admit[r] for r, t in sorted(first.items()) if inside(t)]
    tpot = [(finish[r] - first[r]) / (outputs[r] - 1) for r in done
            if outputs[r] > 1]
    tokens = sum(1 for t in first.values() if inside(t)) \
        + sum(len(step) for t, step in decodes if inside(t))
    return {"completed": len(done), "done": done,
            "requests_per_s": len(done) / span,
            "output_tokens_per_s": tokens / span,
            "ttft": ttft,
            "tpot": tpot,
            "ttft_p50_s": percentile(ttft, 50) if ttft else None,
            "tpot_p50_ms": percentile(tpot, 50) * 1e3 if tpot else None}


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the intervals: overlaps (kernels on two
    streams at once) count once."""
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        elif hi > cur_hi:
            cur_hi = hi
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers, longest first."""
    gaps, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    return gaps

