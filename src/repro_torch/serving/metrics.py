"""TTFT / lifecycle / utilization metrics."""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional

import numpy as np


def percentiles(values: Iterable[float], ps=(50, 90, 99)) -> Dict[str, float]:
    """Percentile summary; empty inputs yield ``None`` values (NOT NaN —
    None serializes as standard-JSON ``null``, NaN is the non-standard
    token default ``json.dumps`` emits and most parsers reject)."""
    arr = np.asarray(sorted(values), np.float64)
    if arr.size == 0:
        return {f"p{p}": None for p in ps} | {"mean": None}
    out = {f"p{p}": float(np.percentile(arr, p)) for p in ps}
    out["mean"] = float(arr.mean())
    return out


def sanitize_json(obj):
    """Recursively replace non-finite floats (NaN/±Inf) with None so the
    structure serializes as strict JSON.  Every report writer pairs this
    with ``json.dumps(..., allow_nan=False)`` — the sanitizer makes the
    payload valid, ``allow_nan`` makes any future regression loud."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    return obj


def dumps_report(obj, indent: int = 1) -> str:
    """Strict-JSON report serialization: the single path every report
    writer (serve stdout, --metrics-out/--timeline-out, emit_bench) goes
    through, so no emitted file ever carries a bare ``NaN`` token."""
    return json.dumps(sanitize_json(obj), indent=indent, allow_nan=False)


def cdf(values: Iterable[float], n_points: int = 50) -> List[tuple]:
    arr = np.asarray(sorted(values), np.float64)
    if arr.size == 0:
        return []
    qs = np.linspace(0, 100, n_points)
    return [(float(np.percentile(arr, q)), q / 100.0) for q in qs]


def speedup(baseline: Dict[str, float], ours: Dict[str, float], key: str = "mean") -> float:
    return baseline[key] / max(ours[key], 1e-12)


def lifecycle_stats(ttfts: Dict[str, float],
                    e2e: Optional[Dict[str, float]] = None,
                    tpots: Optional[Dict[str, float]] = None,
                    total_tokens: int = 0,
                    makespan: float = 0.0, *,
                    arrivals: Optional[Dict[str, float]] = None,
                    finishes: Optional[Dict[str, float]] = None,
                    offered: int = 0) -> Dict[str, float]:
    """Whole-lifecycle serving summary: the classic TTFT percentiles plus
    end-to-end request latency, per-output-token time (TPOT — for a batched
    decode step this is also the time between tokens, TBT) and generation
    throughput over the run.

    Stream-safe: all rates derive from PER-REQUEST finish events, never from
    the engine's batch-close makespan.  Under continuous batching requests
    retire mid-flight and the offered stream may outlive the measured
    window, so ``makespan`` (which includes the drain tail of whatever
    happened to still be in flight) systematically understates throughput.
    When ``arrivals``/``finishes`` are given the denominator is the active
    serving span — first arrival to last completed finish — and the summary
    additionally reports ``completed``/``offered``/``requests_per_sec``.
    ``makespan`` is only the fallback denominator for legacy callers."""
    out = percentiles(ttfts.values())
    if e2e:
        ep = percentiles(e2e.values())
        out["e2e_mean"] = ep["mean"]
        out["e2e_p99"] = ep["p99"]
    if tpots:
        tp = percentiles(tpots.values())
        out["tpot_mean"] = tp["mean"]
        out["tpot_p99"] = tp["p99"]
    span = makespan
    if finishes:
        t0 = min(arrivals.values()) if arrivals else 0.0
        span = max(finishes.values()) - t0
        out["completed"] = len(finishes)
        out["offered"] = offered or (len(arrivals) if arrivals
                                     else len(finishes))
        if span > 0:
            out["requests_per_sec"] = len(finishes) / span
    if total_tokens and span > 0:
        out["tokens_per_sec"] = total_tokens / span
    return out


def sustained_throughput(arrivals: Dict[str, float],
                         finishes: Dict[str, float],
                         warmup: float = 0.0,
                         drain: float = 0.0) -> Dict[str, float]:
    """Steady-state completion rate over a trimmed measurement window.

    Continuous-batching throughput is only meaningful at steady state: the
    first requests see an empty device (warmup bias) and the last ones see
    a draining queue (no fresh arrivals competing).  The window keeps
    completions with ``warmup <= finish <= horizon - drain`` where the
    horizon is the last arrival; the rate divides by the window length.
    Returns ``{"window", "completed_in_window", "sustained_rps"}`` (zeros
    when the window is empty or degenerate)."""
    if not finishes:
        return {"window": 0.0, "completed_in_window": 0, "sustained_rps": 0.0}
    horizon = max(arrivals.values()) if arrivals else max(finishes.values())
    lo, hi = warmup, horizon - drain
    if hi <= lo:
        lo, hi = 0.0, max(finishes.values())
    done = sum(1 for t in finishes.values() if lo <= t <= hi)
    window = hi - lo
    return {"window": window, "completed_in_window": done,
            "sustained_rps": done / window if window > 0 else 0.0}
