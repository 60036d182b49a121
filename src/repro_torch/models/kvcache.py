"""KV-cache dicts of stacked tensors, and the paged block pool.

Counterpart of ``repro.models.kvcache`` for attention caches.  The cache is
a flat dict of stacked tensors (leading axis = attention layer slot) so the
restoration executor can slice per-layer, per-token-range views:

  k, v : (n_attn, B, S_cache, H_kv, Dh)
  kpos : (n_attn, S_cache) int32   position of each cache slot (-1 = empty;
                                   ring buffer for windowed attention)

Unlike the reference's immutable arrays, the port updates these tensors in
place wherever the reference rebuilt a whole stacked array with
``.at[].set``; callers that need a snapshot clone.

:class:`BlockPool` + :class:`PagedKVCache` are the paged view of the
attention KV (fixed-size token blocks in a shared device pool, refcounted,
copy-on-write on append) that backs the chunk store's hbm tier.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.config import ModelConfig

# token axis of each attention field inside a per-block payload
# (k/v/ckv: (n_attn, B, bs, ...); kpos: (n_attn, bs)); +1 in the pool slab
_TOKEN_AXIS = {"k": 2, "v": 2, "ckv": 2, "kpos": 1}


def layer_slots(cfg: ModelConfig) -> dict:
    """Map layer index -> (kind, slot index within that kind's stacked array)."""
    slots, counters = {}, {"attention": 0, "recurrent": 0, "rwkv": 0}
    for i, kind in enumerate(cfg.layer_kinds()):
        slots[i] = (kind, counters[kind])
        counters[kind] += 1
    return slots


def cache_seq_len(cfg: ModelConfig, max_len: int) -> int:
    """Windowed archs only ever hold ``attn_window`` keys (ring buffer)."""
    if cfg.attn_window:
        return min(max_len, cfg.attn_window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    kinds = cfg.layer_kinds()
    if set(kinds) != {"attention"} or cfg.mla is not None:
        raise NotImplementedError("the port's caches hold dense attention KV "
                                  "only (MLA/recurrent/RWKV not yet ported)")
    n_attn = len(kinds)
    s = cache_seq_len(cfg, max_len)
    shape = (n_attn, batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kpos": torch.full((n_attn, s), -1, dtype=torch.int32, device=device)}


def park_cache(cache: dict) -> dict:
    """Move a (partially restored) cache off the device into pinned host
    tensors — how a preempted restoration parks WITHOUT being finalized.
    Inverse: :func:`unpark_cache`."""
    out = {}
    for f, a in cache.items():
        host = torch.empty(a.shape, dtype=a.dtype, pin_memory=a.is_cuda)
        out[f] = host.copy_(a)
    return out


def unpark_cache(cache: dict, device) -> dict:
    """Return a parked cache to ``device`` (dtypes preserved); resumed
    restoration ops continue writing into it exactly where they left off."""
    return {f: a.to(device) for f, a in cache.items()}


class BlockPool:
    """Shared device-side pool of fixed-size KV token blocks.

    One block holds ``block_size`` tokens' attention KV across ALL
    attention layer slots (k/v plus kpos) — the span a content-addressed
    store chunk covers, so a store chunk promoted to HBM *is* a pool block
    and every request table that maps it aliases one physical copy.
    Storage is one slab per field with a leading block axis; the slab
    doubles when the free list runs dry.  Blocks are refcounted, ``copy``
    is the CoW primitive (counted in ``cow_copies`` / ``bytes_copied``).

    Field shapes are fixed by the first block written; payloads shorter
    than ``block_size`` tokens (a prefix's tail block) are zero-padded
    (kpos pads with -1 = empty slot).  Writes go into the slabs in place.
    """

    def __init__(self, block_size: int, *, capacity: int = 8):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self._slabs: Optional[Dict[str, torch.Tensor]] = None
        self._specs: Optional[Dict[str, tuple]] = None   # f -> (shape, dtype, device)
        self.capacity = 0
        self._init_capacity = max(1, capacity)
        self.refcounts: List[int] = []
        self._free: List[int] = []
        self.block_nbytes = 0
        self.allocs = 0
        self.frees = 0
        self.cow_copies = 0
        self.bytes_copied = 0

    # -- layout ---------------------------------------------------------
    def _pad(self, f: str, arr: torch.Tensor) -> torch.Tensor:
        """Pad (or trim) the payload's token axis to exactly one block."""
        ax = _TOKEN_AXIS[f]
        short = self.block_size - arr.shape[ax]
        if short > 0:
            shape = list(arr.shape)
            shape[ax] = short
            fill = torch.full(shape, -1 if f == "kpos" else 0, dtype=arr.dtype,
                              device=arr.device)
            arr = torch.cat([arr, fill], dim=ax)
        elif short < 0:
            arr = arr.narrow(ax, 0, self.block_size)
        return arr

    def _ensure_slabs(self, payload: dict):
        if self._slabs is not None:
            return
        self._specs = {}
        for f, arr in payload.items():
            a = self._pad(f, arr)
            self._specs[f] = (tuple(a.shape), a.dtype, a.device)
            self.block_nbytes += a.numel() * a.element_size()
        self._grow(self._init_capacity)

    def _blank(self, f: str, lead=()) -> torch.Tensor:
        shape, dtype, device = self._specs[f]
        return torch.full(tuple(lead) + shape, -1 if f == "kpos" else 0,
                          dtype=dtype, device=device)

    def _grow(self, extra: int):
        new = {}
        for f in self._specs:
            blank = self._blank(f, (extra,))
            new[f] = blank if self._slabs is None \
                else torch.cat([self._slabs[f], blank])
        self._slabs = new
        self._free.extend(range(self.capacity, self.capacity + extra))
        self.refcounts.extend([0] * extra)
        self.capacity += extra

    def _take_slot(self) -> int:
        if not self._free:
            self._grow(max(1, self.capacity))
        bid = self._free.pop()
        assert self.refcounts[bid] == 0, bid
        self.refcounts[bid] = 1
        self.allocs += 1
        return bid

    def ensure_layout(self, payload: dict):
        """Fix the pool's field shapes/dtypes from a sample payload (padded
        to one block) without allocating; no-op once the layout is set."""
        self._ensure_slabs(payload)

    # -- lifecycle ------------------------------------------------------
    def alloc(self, payload: dict) -> int:
        """Write ``payload`` (a per-block field dict) into a fresh block;
        returns its id with refcount 1."""
        self._ensure_slabs(payload)
        bid = self._take_slot()
        for f, arr in payload.items():
            self._slabs[f][bid] = self._pad(f, arr)
        return bid

    def alloc_blank(self) -> int:
        """A fresh zeroed block (kpos = -1); the CoW append target when a
        table extends past its mapped blocks."""
        if self._slabs is None:
            raise RuntimeError("pool layout unset: alloc() a block first")
        bid = self._take_slot()
        for f in self._specs:
            self._slabs[f][bid] = self._blank(f)
        return bid

    def copy(self, bid: int) -> int:
        """CoW: a new sole-owner block holding ``bid``'s bytes."""
        new = self._take_slot()
        for f in self._specs:
            self._slabs[f][new] = self._slabs[f][bid]
        self.cow_copies += 1
        self.bytes_copied += self.block_nbytes
        return new

    def incref(self, bid: int):
        assert self.refcounts[bid] > 0, f"incref of free block {bid}"
        self.refcounts[bid] += 1

    def decref(self, bid: int):
        rc = self.refcounts[bid]
        if rc <= 0:
            raise AssertionError(f"double free of block {bid}")
        self.refcounts[bid] = rc - 1
        if rc == 1:
            self.frees += 1
            self._free.append(bid)

    # -- access ---------------------------------------------------------
    def read(self, bid: int) -> dict:
        """The block's fields as views into the slabs (one block's span);
        valid until the block is freed and reused."""
        return {f: self._slabs[f][bid] for f in self._specs}

    def write_slice(self, bid: int, lo: int, hi: int, fields: dict):
        """Overwrite tokens [lo, hi) of a SOLELY-OWNED block (callers CoW
        first when the refcount is > 1)."""
        assert self.refcounts[bid] == 1, \
            f"write to shared block {bid} (refcount {self.refcounts[bid]})"
        assert 0 <= lo <= hi <= self.block_size, (lo, hi)
        for f, arr in fields.items():
            self._slabs[f][bid].narrow(_TOKEN_AXIS[f], lo, hi - lo).copy_(arr)

    # -- accounting -----------------------------------------------------
    def live_blocks(self) -> int:
        return sum(1 for rc in self.refcounts if rc > 0)

    def audit(self):
        """No block is both free and referenced; free-list ids are unique;
        every slot is either live or on the free list."""
        assert len(self._free) == len(set(self._free)), "dup free-list ids"
        for bid in self._free:
            assert self.refcounts[bid] == 0, f"free block {bid} referenced"
        assert all(rc >= 0 for rc in self.refcounts)
        assert self.live_blocks() + len(self._free) == self.capacity, \
            (self.live_blocks(), len(self._free), self.capacity)


class PagedKVCache:
    """A request's paged view of its attention KV: a block table mapping
    logical block index (token span [i·bs, (i+1)·bs)) to a physical
    :class:`BlockPool` block, or None while the span is not yet resident.

    ``clone()`` is an O(1)-copied-bytes fork: the child copies the table
    and increfs every mapped block; ``write_span`` copies a shared block
    before mutating it (copy-on-write on append)."""

    def __init__(self, pool: BlockPool, n_tokens: int = 0):
        self.pool = pool
        self.blocks: List[Optional[int]] = [None] * self._nblocks(n_tokens)
        self.n_tokens = n_tokens

    def _nblocks(self, n: int) -> int:
        return -(-n // self.pool.block_size)

    # -- fork / free ----------------------------------------------------
    def clone(self) -> "PagedKVCache":
        child = PagedKVCache(self.pool, self.n_tokens)
        child.blocks = list(self.blocks)
        for bid in child.blocks:
            if bid is not None:
                self.pool.incref(bid)
        return child

    def free(self):
        for bid in self.blocks:
            if bid is not None:
                self.pool.decref(bid)
        self.blocks = []
        self.n_tokens = 0

    def truncate(self, n_tokens: int):
        """Drop table entries past ``n_tokens`` (releasing their refs)."""
        keep = self._nblocks(n_tokens)
        for bid in self.blocks[keep:]:
            if bid is not None:
                self.pool.decref(bid)
        self.blocks = self.blocks[:keep]
        self.n_tokens = min(self.n_tokens, n_tokens)

    # -- residency ------------------------------------------------------
    def _extend(self, n_tokens: int):
        need = self._nblocks(n_tokens)
        if need > len(self.blocks):
            self.blocks.extend([None] * (need - len(self.blocks)))
        self.n_tokens = max(self.n_tokens, n_tokens)

    def has_block(self, idx: int) -> bool:
        return idx < len(self.blocks) and self.blocks[idx] is not None

    def map_block(self, idx: int, bid: int):
        """Alias an existing pool block (e.g. a store chunk promoted to
        HBM) at logical index ``idx``; takes a new reference."""
        self._extend((idx + 1) * self.pool.block_size)
        old = self.blocks[idx]
        if old == bid:
            return
        self.pool.incref(bid)
        if old is not None:
            self.pool.decref(old)
        self.blocks[idx] = bid

    def missing_blocks(self, t0: int, t1: int) -> List[int]:
        bs = self.pool.block_size
        return [i for i in range(t0 // bs, self._nblocks(t1))
                if not self.has_block(i)]

    def read_block(self, idx: int) -> dict:
        return self.pool.read(self.blocks[idx])

    # -- copy-on-write append -------------------------------------------
    def write_span(self, t0: int, t1: int, fields: dict):
        """Write tokens [t0, t1) of the given attention fields through the
        table.  Unmapped blocks allocate fresh; blocks shared with another
        table (refcount > 1) are copied first."""
        self.pool.ensure_layout(fields)
        self._extend(t1)
        bs = self.pool.block_size
        for idx in range(t0 // bs, self._nblocks(t1)):
            lo = max(t0, idx * bs) - idx * bs
            hi = min(t1, (idx + 1) * bs) - idx * bs
            bid = self.blocks[idx]
            if bid is None:
                bid = self.pool.alloc_blank()
            elif self.pool.refcounts[bid] > 1:
                new = self.pool.copy(bid)
                self.pool.decref(bid)
                bid = new
            self.blocks[idx] = bid
            sliced = {f: arr.narrow(_TOKEN_AXIS[f], idx * bs + lo - t0, hi - lo)
                      for f, arr in fields.items()}
            self.pool.write_slice(bid, lo, hi, sliced)


def grow_cache(cfg: ModelConfig, cache: dict, new_len: int) -> dict:
    """Extend the attention KV buffers (k/v/kpos) so the cache holds
    ``new_len`` tokens — how suffix prefill and decode append onto a
    restored prefix cache.  New tensors (zeros, kpos -1) receive a copy of
    the old contents; windowed archs stay capped at the ring-buffer size."""
    target = cache_seq_len(cfg, new_len)
    out = {}
    for f, a in cache.items():
        if f in ("k", "v", "ckv") and a.shape[2] < target:
            new = torch.zeros(a.shape[:2] + (target,) + a.shape[3:],
                              dtype=a.dtype, device=a.device)
            new[:, :, :a.shape[2]] = a
            out[f] = new
        elif f == "kpos" and a.shape[1] < target:
            new = torch.full((a.shape[0], target), -1, dtype=a.dtype,
                             device=a.device)
            new[:, :a.shape[1]] = a
            out[f] = new
        else:
            out[f] = a
    return out
