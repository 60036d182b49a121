"""Traffic of returning sessions: a pool of chat sessions remembered in
set-up, and new turns of them served by a closed loop of clients.

Mix keys: ``clients`` (requests in flight), ``sessions`` (the pool),
``turns`` (the fixed set of turn sizes), ``ramp`` (requests that finish
before the window opens), ``queue`` (requests handed to one ``serve``
call), ``sizes_seed``, ``prefix`` (lognormal median, sigma, floor) and
the inclusive ranges ``new_len`` and ``decode_len``; the configuration's
``serve.prefix_cap`` caps a prefix.  The length draws are a copy of the
program's ``lmsys_chat`` (``repro_torch/serving/workloads.py``: a
lognormal prefix with a floor and a cap, the new turn uniform on [32,
512), the output uniform on [16, 128)), kept here so that the yardstick
does not move when the program changes.

The sizes come from the mix's own ``sizes_seed``, never from the run's
seed: every seed serves the same multiset of prefix, turn and output
lengths, and the run's seed only orders them (the token ids come from it
too, ``bench.inputs``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class Turn:
    """One request of the window: a new turn of a pool session."""
    index: int          # position in the run's sequence of requests
    session: int        # index into the pool
    prefix_len: int     # the session's stored prefix
    new_len: int        # the new turn's tokens (the suffix prefill)
    decode_len: int     # output tokens, the first one included


@dataclass
class Plan:
    prefix_lens: List[int]          # per pool session
    session_order: List[int]        # round-robin order of the sessions
    turns: List[tuple]              # (new_len, decode_len) in request order
    clients: int
    ramp: int
    queue: int

    def turn(self, k: int) -> Turn:
        """The k-th request: sessions taken round-robin, the fixed set of
        turns cycled in the seed's order."""
        s = self.session_order[k % len(self.session_order)]
        new, dec = self.turns[k % len(self.turns)]
        return Turn(k, s, self.prefix_lens[s], new, dec)


def lmsys_prefix(rng: np.random.Generator, n: int, *, median: float,
                 sigma: float, floor: int, cap: int) -> np.ndarray:
    """``lmsys_chat``'s prefix draw: lognormal, capped, with a floor."""
    prefix = np.minimum(rng.lognormal(np.log(median), sigma, n), cap)
    return np.maximum(floor, prefix).astype(np.int64)


def lmsys_turns(rng: np.random.Generator, n: int, *, new_len, decode_len):
    """``lmsys_chat``'s new-turn and output draws, inclusive ranges."""
    new = rng.integers(new_len[0], new_len[1] + 1, n)
    dec = [int(rng.integers(decode_len[0], decode_len[1] + 1)) for _ in range(n)]
    return [(int(a), b) for a, b in zip(new, dec)]


def plan(mix: dict, cfg: dict, seed: int) -> Plan:
    """The cell's sessions and turns: sizes from the mix's ``sizes_seed``,
    their order from ``seed``."""
    p = mix["prefix"]
    sizes = int(mix["sizes_seed"])
    prefix = lmsys_prefix(np.random.default_rng([sizes, 0]), mix["sessions"],
                          median=p["median"], sigma=p["sigma"], floor=p["floor"],
                          cap=cfg["serve"]["prefix_cap"])
    turns = lmsys_turns(np.random.default_rng([sizes, 1]), mix["turns"],
                        new_len=mix["new_len"], decode_len=mix["decode_len"])
    rng = np.random.default_rng([int(seed), 2])
    order = [int(i) for i in rng.permutation(len(prefix))]
    turns = [turns[i] for i in rng.permutation(len(turns))]
    return Plan([int(x) for x in prefix], order, turns, int(mix["clients"]),
                int(mix["ramp"]), int(mix["queue"]))
