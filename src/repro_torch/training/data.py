"""Deterministic sharded synthetic data (counterpart of
``repro.training.data``).

Stateless addressing: a batch is a pure function of (seed, step, host), so a
restarted host resumes at the exact global batch index with no
coordination.  Each batch is drawn from a CPU ``torch.Generator`` seeded
from that triple and then moved to the device, so a batch is the same on
the CPU and on the card.  The distributions are the reference's — 70% of
rows an arithmetic token sequence with a random phase (learnable, so the
loss falls within a few hundred steps), the rest uniform tokens — but not
its values, which come from ``jax.random``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} over "
                             f"{self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


def _generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from ``key`` (seed, step, host) through
    numpy's SeedSequence, which mixes every word of the key."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def batch_at(cfg: DataConfig, step: int, device="cpu") -> dict:
    """{"tokens": (local_batch, seq_len + 1) int32} on ``device``: the
    model's input is tokens[:, :-1], its labels tokens[:, 1:]."""
    g = _generator(cfg.seed, step, cfg.host_id)
    b, s = cfg.local_batch, cfg.seq_len + 1
    base = torch.randint(0, cfg.vocab_size, (b, s), generator=g, dtype=torch.int32)
    phase = torch.randint(0, cfg.vocab_size, (b, 1), generator=g, dtype=torch.int32)
    pattern = (phase + torch.arange(s, dtype=torch.int32)[None]) % cfg.vocab_size
    use_pattern = torch.rand((b, 1), generator=g) < 0.7
    tokens = torch.where(use_pattern, pattern, base)
    return {"tokens": tokens.to(device)}


def embedding_batch_at(cfg: DataConfig, step: int, d_model: int, device="cpu") -> dict:
    """For embedding-input models: {"embeddings": (local_batch, seq_len,
    d_model) f32 ~ N(0, 0.1²), "labels": (local_batch, seq_len) int32}."""
    g = _generator(cfg.seed + 7, step, cfg.host_id)
    b, s = cfg.local_batch, cfg.seq_len
    emb = torch.randn((b, s, d_model), generator=g) * 0.1
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g, dtype=torch.int32)
    return {"embeddings": emb.to(device), "labels": labels.to(device)}
