"""Boundary-activation store — the 3rd dimension of CacheFlow (paper §3.2).

Counterpart of ``repro.core.boundary``.

At original prefill time each pipeline stage persists the *input activations*
of its first layer for the prefix tokens (size n × d_model — far smaller than
the stage's KV slice: 2·H·Dh·(L/S)·n).  On restoration every stage fetches
its boundary row and reconstructs its local KV concurrently — no
inter-stage dependency.

For recurrent/hybrid archs the store additionally keeps end-of-chunk
recurrent-state snapshots (RG-LRU h/conv, RWKV wkv/shift): the state analogue
of boundary activations along the *token* axis (DESIGN.md §5).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _nbytes(tree) -> int:
    # numel * element_size: works for device and bf16 tensors, which a
    # numpy round trip (the reference's np.asarray) does not
    return sum(a.numel() * a.element_size() for a in _leaves(tree))


@dataclass
class StoredRequest:
    request_id: str
    n_tokens: int
    inputs: object                       # tokens (B,N) or embeddings (B,N,D)
    kv_reference: dict                   # full-prefill cache (ground truth / KV store payload)
    boundaries: Dict[int, object]        # stage -> (B, N, D) input activations
    state_snapshots: Dict[Tuple[int, int], dict] = field(default_factory=dict)
    # (stage, chunk_idx) -> recurrent-state pytree at the END of that chunk
    final_logits: Optional[object] = None


class BoundaryStore:
    """In-memory stand-in for the storage tier holding boundary activations,
    KV payloads and state snapshots. Byte counters feed the cost model."""

    def __init__(self):
        self._store: Dict[str, StoredRequest] = {}
        self.bytes_written = 0
        self.bytes_read = 0

    def put(self, req: StoredRequest):
        self._store[req.request_id] = req
        self.bytes_written += _nbytes(req.kv_reference)
        self.bytes_written += _nbytes(list(req.boundaries.values()))

    def get(self, rid: str) -> StoredRequest:
        req = self._store[rid]
        return req

    def read_boundary(self, rid: str, stage: int):
        b = self._store[rid].boundaries[stage]
        self.bytes_read += _nbytes(b)
        return b

    def boundary_bytes(self, rid: str, stage: int) -> int:
        return _nbytes(self._store[rid].boundaries[stage])

    def kv_slice_bytes(self, rid: str, tokens: Tuple[int, int],
                       layer_frac: float) -> int:
        req = self._store[rid]
        total = _nbytes(req.kv_reference)
        t0, t1 = tokens
        return int(total * (t1 - t0) / max(1, req.n_tokens) * layer_frac)

    def fork(self, src_rid: str, dst_rid: str) -> StoredRequest:
        """Alias ``src``'s stored request under ``dst`` — the fork shares
        every array (inputs, KV reference, boundaries, snapshots) and
        writes ZERO bytes; only the id differs."""
        req = self._store[src_rid]
        clone = replace(req, request_id=dst_rid)
        self._store[dst_rid] = clone
        return clone

    def __contains__(self, rid: str) -> bool:
        return rid in self._store


def stage_bounds(num_layers: int, stages: int) -> List[Tuple[int, int]]:
    """Contiguous layer partition [ℓ_s^start, ℓ_s^end) per stage."""
    base = num_layers // stages
    rem = num_layers % stages
    bounds = []
    lo = 0
    for s in range(stages):
        hi = lo + base + (1 if s < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds
