"""Synthetic serving workloads shaped after the paper's three datasets (§4.1).

A copy of ``repro.serving.workloads`` (numpy only): given one seed, both
packages draw the same ``Request`` lists, bit for bit.

Length distributions are calibrated to the published dataset statistics
(paper Fig. 1a: high prevalence of multi-thousand-token reusable prefixes,
tails beyond 20k):

  * lmsys_chat — multi-turn ChatGPT traces: lognormal prefix lengths
    (median ≈ 2.5k, p95 ≈ 15k), short new turns.
  * wildchat   — open-domain, broader/multi-lingual: wider lognormal
    (median ≈ 1.5k, p95 ≈ 12k) with a 20% short-context mass.
  * swe_bench  — agentic coding: long shared repository contexts
    (10k–30k) reused across tool invocations (shared prefix_id), short
    tool-call suffixes.

Beyond the three datasets, ``bursty_priority`` is the SLO-pressure workload
the engine's preemption policies target: a steady background of long-prefix
batch requests (priority 0) punctuated by bursts of short urgent
interactive requests (priority 1, tight first-token deadlines) arriving
together — under a ``max_active`` cap the urgent burst queues behind long
restorations unless the engine preempts.

``multi_tenant`` is the CONTINUOUS-BATCHING workload (DESIGN.md §11): a
sustained production-shaped stream mixing Zipf prefix popularity (a small
catalog of shared contexts absorbs most traffic, so the KV store's reuse
tiers matter), a diurnal arrival-rate envelope (the steady state the
benchmark measures sits between the ramp-up and the trough) and three SLO
classes (interactive / standard / batch) with distinct priorities and
first-token deadlines.

``agentic_tree`` is the SESSION-FORKING workload (DESIGN.md §12): tree
search over actions — each tree has one PARENT request carrying a long
agent context, then K speculative BRANCHES forked from the live parent
(``meta["fork_of"]``) moments later, each trying a different short action
suffix.  Branches share the parent's entire prefix: with paged-block CoW
they reach first token with ~zero restoration bytes (the fork aliases the
parent's device blocks) instead of re-restoring the full context K times.

Deterministic in the seed; arrivals are Poisson.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from repro_torch.serving.request import Request

WORKLOADS = ("lmsys_chat", "wildchat", "swe_bench", "bursty_priority",
             "multi_tenant", "agentic_tree")


def generate(workload: str, n_requests: int, *, seed: int = 0,
             arrival_rate: float = 2.0, max_len: int = 32_768) -> List[Request]:
    if workload == "bursty_priority":
        return bursty_priority(n_requests, seed=seed,
                               arrival_rate=arrival_rate, max_len=max_len)
    if workload == "multi_tenant":
        return multi_tenant(n_requests, seed=seed,
                            arrival_rate=arrival_rate, max_len=max_len)
    if workload == "agentic_tree":
        return agentic_tree(n_requests, seed=seed,
                            arrival_rate=arrival_rate, max_len=max_len)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    reqs: List[Request] = []
    if workload == "lmsys_chat":
        prefix = np.minimum(rng.lognormal(np.log(2500), 0.9, n_requests), max_len)
        new = rng.integers(32, 512, n_requests)
        pid = [f"conv-{i}" for i in range(n_requests)]
    elif workload == "wildchat":
        prefix = np.minimum(rng.lognormal(np.log(1500), 1.1, n_requests), max_len)
        short = rng.random(n_requests) < 0.2
        prefix = np.where(short, rng.integers(64, 512, n_requests), prefix)
        new = rng.integers(32, 768, n_requests)
        pid = [f"conv-{i}" for i in range(n_requests)]
    elif workload == "swe_bench":
        n_repos = max(1, n_requests // 6)   # ~6 tool calls per repo context
        repo_len = rng.integers(10_000, min(30_000, max_len), n_repos)
        repo_of = rng.integers(0, n_repos, n_requests)
        prefix = repo_len[repo_of] + rng.integers(0, 2000, n_requests)
        prefix = np.minimum(prefix, max_len)
        new = rng.integers(16, 256, n_requests)
        pid = [f"repo-{repo_of[i]}" for i in range(n_requests)]
    else:
        raise ValueError(f"unknown workload {workload!r}; known: {WORKLOADS}")
    for i in range(n_requests):
        reqs.append(Request(
            request_id=f"{workload}-{i}", arrival=float(arrivals[i]),
            prefix_len=int(max(64, prefix[i])), new_len=int(new[i]),
            decode_len=int(rng.integers(16, 128)), prefix_id=pid[i]))
    return reqs


def bursty_priority(n_requests: int, *, seed: int = 0,
                    arrival_rate: float = 2.0, max_len: int = 32_768,
                    burst_every: float = 4.0, burst_size: int = 3,
                    urgent_deadline: float = 2.0) -> List[Request]:
    """Two-SLO-class admission-pressure workload (preemption target).

    ~2/3 of the requests are BACKGROUND (priority 0): Poisson arrivals,
    long lognormal prefixes (median ≈ 8k), loose deadlines.  The rest are
    URGENT (priority 1): short prefixes (256–1k) and short turns, arriving
    in simultaneous bursts of ``burst_size`` every ``burst_every`` seconds
    with a ``urgent_deadline``-second first-token SLO — the short-behind-
    long queueing pattern §3.3's batch awareness leaves on the table
    without preemption."""
    rng = np.random.default_rng(seed)
    # ~1/3 urgent (at least one); the last burst may be partial so the
    # function always returns EXACTLY n_requests requests
    n_urgent = min(n_requests, max(1, n_requests // 3))
    n_bg = n_requests - n_urgent
    reqs: List[Request] = []
    bg_arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n_bg))
    bg_prefix = np.minimum(rng.lognormal(np.log(8000), 0.6, n_bg), max_len)
    for i in range(n_bg):
        reqs.append(Request(
            request_id=f"bg-{i}", arrival=float(bg_arrivals[i]),
            prefix_len=int(max(2048, bg_prefix[i])),
            new_len=int(rng.integers(32, 256)),
            decode_len=int(rng.integers(16, 128)),
            priority=0, deadline=float(bg_arrivals[i]) + 120.0,
            prefix_id=f"bg-{i}"))
    for j, start in enumerate(range(0, n_urgent, burst_size)):
        t = burst_every * (j + 1)
        for i in range(start, min(start + burst_size, n_urgent)):
            reqs.append(Request(
                request_id=f"hi-{i}", arrival=float(t),
                prefix_len=int(rng.integers(256, 1024)),
                new_len=int(rng.integers(16, 128)),
                decode_len=int(rng.integers(8, 32)),
                priority=1, deadline=float(t) + urgent_deadline,
                prefix_id=f"hi-{i}"))
    reqs.sort(key=lambda r: (r.arrival, r.request_id))
    return reqs


def multi_tenant(n_requests: int, *, seed: int = 0, arrival_rate: float = 2.0,
                 max_len: int = 32_768, n_prefixes: int = 0,
                 zipf_s: float = 1.1, diurnal_period: float = 60.0,
                 diurnal_depth: float = 0.6) -> List[Request]:
    """Sustained multi-tenant stream for continuous-batching studies.

    Three production-shaped dimensions:

      * **Zipf prefix popularity** — requests draw their shared context
        from a catalog of ``n_prefixes`` prefixes (default ``≈ n/4``) with
        Zipf(``zipf_s``) popularity: the head prefixes recur constantly
        (hot in the KV store after first restoration; prefetch and reuse
        tiers pay off), the tail is effectively cold.  Each catalog entry
        has a FIXED length (lognormal, median ≈ 4k) so repeat hits are
        true reuse.
      * **Diurnal arrival envelope** — a thinned Poisson process whose
        instantaneous rate follows ``rate·(1 - depth·(1+cos(2πt/T))/2)``:
        peaks at ``arrival_rate``, troughs at ``rate·(1-depth)``.  The
        steady-state window the throughput benchmark measures excludes the
        empty-device ramp; the trough/peak alternation keeps admission
        pressure time-varying the way real traffic is.
      * **Mixed SLO classes** — ~30% interactive (priority 2, first-token
        deadline arrival+2s, short turns), ~50% standard (priority 1,
        +10s), ~20% batch (priority 0, no deadline, long decode) — the mix
        the priority-aware I/O dispatch key orders a congested channel by.

    Deterministic in the seed (thinning uses its own substream).
    """
    rng = np.random.default_rng(seed)
    n_prefixes = n_prefixes or max(4, n_requests // 4)
    # fixed-length catalog: popularity rank ~ Zipf, length iid lognormal
    catalog_len = np.minimum(
        rng.lognormal(np.log(4000), 0.8, n_prefixes), max_len)
    catalog_len = np.maximum(catalog_len, 256).astype(np.int64)
    ranks = np.arange(1, n_prefixes + 1, dtype=np.float64)
    popularity = ranks ** (-zipf_s)
    popularity /= popularity.sum()

    # diurnal thinned Poisson: simulate at the PEAK rate, keep each arrival
    # with probability rate(t)/peak (Lewis–Shedler thinning)
    arrivals: List[float] = []
    t = 0.0
    while len(arrivals) < n_requests:
        t += rng.exponential(1.0 / arrival_rate)
        envelope = 1.0 - diurnal_depth * (
            1.0 + math.cos(2.0 * math.pi * t / diurnal_period)) / 2.0
        if rng.random() < envelope:
            arrivals.append(t)

    reqs: List[Request] = []
    classes = rng.choice(3, n_requests, p=[0.3, 0.5, 0.2])
    prefix_ids = rng.choice(n_prefixes, n_requests, p=popularity)
    for i in range(n_requests):
        pid = int(prefix_ids[i])
        a = arrivals[i]
        if classes[i] == 0:        # interactive
            prio, deadline = 2, a + 2.0
            new = int(rng.integers(16, 128))
            dec = int(rng.integers(8, 64))
        elif classes[i] == 1:      # standard
            prio, deadline = 1, a + 10.0
            new = int(rng.integers(32, 512))
            dec = int(rng.integers(16, 128))
        else:                      # batch
            prio, deadline = 0, math.inf
            new = int(rng.integers(64, 1024))
            dec = int(rng.integers(64, 256))
        reqs.append(Request(
            request_id=f"mt-{i}", arrival=float(a),
            prefix_len=int(catalog_len[pid]), new_len=new, decode_len=dec,
            priority=prio, deadline=float(deadline),
            prefix_id=f"prefix-{pid}"))
    return reqs


def agentic_tree(n_requests: int, *, seed: int = 0, arrival_rate: float = 2.0,
                 max_len: int = 32_768, branch_factor: int = 4,
                 think_gap: float = 0.25) -> List[Request]:
    """Agentic tree-search workload: speculative branches forked off live
    parent contexts.

    Requests come in TREES of ``1 + branch_factor``: the parent carries a
    long accumulated agent context (lognormal, median ≈ 6k — tool outputs,
    scratchpads, retrieved docs) and starts decoding; ``think_gap`` seconds
    later its K speculative branches arrive, each with the SAME prefix
    length, ``meta={"fork_of": parent_id}`` and a short action suffix —
    the serving engine forks them from the parent session (CoW block
    tables) instead of re-running/re-restoring the shared context.  The
    last tree may be partial so EXACTLY ``n_requests`` are returned; sim
    engines (no fork path) still see maximal prefix sharing via the
    tree-wide ``prefix_id``."""
    rng = np.random.default_rng(seed)
    tree = 1 + max(1, branch_factor)
    n_trees = -(-n_requests // tree)
    arrivals = np.cumsum(rng.exponential(tree / arrival_rate, n_trees))
    prefix = np.minimum(rng.lognormal(np.log(6000), 0.7, n_trees), max_len)
    reqs: List[Request] = []
    for t in range(n_trees):
        parent_id = f"tree{t}-root"
        plen = int(max(256, prefix[t]))
        reqs.append(Request(
            request_id=parent_id, arrival=float(arrivals[t]),
            prefix_len=plen, new_len=int(rng.integers(16, 128)),
            decode_len=int(rng.integers(16, 64)),
            prefix_id=f"tree-{t}"))
        for j in range(max(1, branch_factor)):
            if len(reqs) >= n_requests:
                break
            reqs.append(Request(
                request_id=f"tree{t}-b{j}",
                arrival=float(arrivals[t] + think_gap * (1 + j)
                              + rng.exponential(0.05)),
                prefix_len=plen, new_len=int(rng.integers(8, 64)),
                decode_len=int(rng.integers(4, 32)),
                prefix_id=f"tree-{t}",
                meta={"fork_of": parent_id}))
        if len(reqs) >= n_requests:
            break
    reqs = reqs[:n_requests]
    reqs.sort(key=lambda r: (r.arrival, r.request_id))
    return reqs


def fixed_length(n_requests: int, prefix_len: int, *, new_len: int = 128,
                 seed: int = 0, arrival_rate: float = 100.0) -> List[Request]:
    """Uniform-length batch (paper Fig. 6 / Fig. 10 style ablations)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    return [Request(request_id=f"fix-{i}", arrival=float(arrivals[i]),
                    prefix_len=prefix_len, new_len=new_len) for i in range(n_requests)]
