"""A cell's traffic and token ids.

A mix file (``bench/traffic/<mix>.json``) holds only parameters; its
``kind`` names the generator that reads it, ``bench/traffic/<kind>.py``,
found by that name.  A generator's ``plan(mix, cfg, seed)`` returns the
pool of sessions that set-up remembers (``prefix_lens``) and the window's
requests in order (``turn(k)``).  Token ids come from the run's seed here,
for every generator alike.
"""
from __future__ import annotations

import numpy as np

from bench import load_file


def plan(mix: dict, cfg: dict, seed: int):
    """The plan of mix ``mix`` for configuration ``cfg`` and ``seed``."""
    return load_file(f"bench/traffic/{mix['kind']}.py").plan(mix, cfg, seed)


def token_ids(seed: int, n: int, vocab: int, stream: int) -> np.ndarray:
    """(n,) int32 token ids of pool session ``stream`` from the run's seed."""
    rng = np.random.default_rng([int(seed), 3, int(stream)])
    return rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32)


def suffix_ids(engine_seed: int, n: int, vocab: int) -> np.ndarray:
    """The new turn's token ids as ``RealServingEngine.serve`` draws them
    (``_inputs``): a CPU ``torch.Generator`` seeded with ``seed * 1_000_003
    + n``, ``randint(0, vocab, (1, n), int32)``.  The engine takes no
    caller inputs, so the benchmark repeats its documented rule to hand the
    reference the same ids."""
    import torch
    gen = torch.Generator().manual_seed(int(engine_seed) * 1_000_003 + int(n))
    return torch.randint(0, vocab, (1, int(n)), generator=gen,
                         dtype=torch.int32)[0].numpy()
