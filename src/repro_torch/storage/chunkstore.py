"""Materialized, content-addressed, chunk-granular KV storage.

Counterpart of ``repro.storage.chunkstore`` in PyTorch: the hbm tier is the
device :class:`~repro_torch.models.kvcache.BlockPool`, the host tier holds
pinned CPU tensors (plain CPU tensors when the store runs on the CPU), and
int8 encoding runs the ``kv_quant`` kernel on the device before the copy
to the host.  The store runs on ``device`` (CUDA unless asked otherwise).

Unlike the reference's sim-mode ``TieredKVStore`` (a
bandwidth/capacity *model* over whole-request placeholders), this store
actually holds tensor bytes.  A stored chunk is the attention-KV slice
(k/v or MLA ckv, plus kpos) of one ``chunk_size``-token span of a prefix,
keyed by a prefix-chained content hash::

    h_0 = sha256(salt)            h_i = sha256(h_{i-1} || tokens_i)

so chunk ``i`` names the KV of tokens [i·C, (i+1)·C) *given its entire
prefix* — exactly the dependence structure of causal attention.  Two
requests sharing a prefix hash to the same chunks and dedup to ONE stored
copy with a refcount (vLLM-style prefix caching, here across the storage
tiers of the CacheFlow restoration path).

Tiers (placement/accounting shared with the sim store via
:class:`~repro_torch.storage.placement.PlacementCore`):

  * ``hbm``  — a block in the shared device-side
    :class:`~repro_torch.models.kvcache.BlockPool` (``chunk_size`` tokens ==
    one block): requests sharing a prefix alias the SAME physical block
    on device, and the restoration executor's per-request
    ``PagedKVCache`` tables map these blocks directly (the load ops copy
    straight out of the pool view; a chunk resident here costs NO
    transfer — the engine core skips the I/O channel entirely, a *dedup
    hit*).  ``fork_request`` forks a whole chain O(1) by refcount bumps;
  * ``host`` — host tensors; with ``quant="int8"`` the chunk is
    stored per-channel int8-quantized (``kernels/kv_quant``), so demotion
    compresses and promotion dequantizes — transfers move ~half the bytes;
  * ``disk`` — serialized ``.npz`` bytes (bf16 as int16 bit views), written under ``store_dir`` when
    given (a real on-disk tier) or held as in-memory blobs otherwise.

Eviction is benefit-aware: the victim is the chunk with the least
restoration benefit per byte — ``refcount × recompute-cost(t0,t1) /
nbytes`` (causal attention makes late chunks quadratically more expensive
to recompute, and shared chunks save that cost for every referent);
refcount-0 chunks go first.  Only the bottom tier drops bytes; a dropped
chunk is simply a future ``store miss`` and restoration falls back to
recompute/ground-truth.

Quantization is one-way per chunk: the int8 form becomes authoritative on
first demotion, and promotion to HBM keeps that sub-HBM encoding alive as
a *shadow* — a later demotion to a same-precision tier reuses the shadow
instead of re-encoding from the decoded bf16 view, so demote/promote
cycles are drift-free after the first quantization.  ``quant="none"``
round-trips bit-exactly through every tier — the restoration served from
this store then bit-matches the full-prefill reference.

The fused restoration datapath (``core/datapath.py``) consumes chunks in
their *stored* encoding via ``fetch_packed`` / ``fetch_range_packed`` —
int8 bytes + scales cross the host→device wire and are dequantized on
device by the ``kv_restore`` kernel — and lands the HBM pool block from
the already-staged device arrays via ``promote_staged`` (no second
host→device copy).  The legacy per-chunk ``fetch`` path decodes before
the copy into the cache; both paths share byte/hit/miss accounting exactly.
"""
from __future__ import annotations

import hashlib
import io
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
from repro_torch.models.kvcache import BlockPool
from repro_torch.models.model import resolve_device
from repro_torch.storage.placement import PlacementCore, Tier

CHUNK_TIERS = ("hbm", "host", "disk")
ATTN_FIELDS = ("k", "v", "ckv")


def chunk_hash_chain(inputs, chunk_size: int, salt: str = "") -> List[str]:
    """Prefix-chained content hashes of the token chunks of ``inputs``
    ((1, N) tokens or (1, N, D) embeddings)."""
    arr = np.ascontiguousarray(inputs.cpu().numpy())
    n = arr.shape[1]
    h = hashlib.sha256(salt.encode()).digest()
    keys = []
    for t0 in range(0, n, chunk_size):
        h = hashlib.sha256(h + arr[:, t0:t0 + chunk_size].tobytes()).digest()
        keys.append(h.hex())
    return keys


@dataclass
class _Chunk:
    tokens: Tuple[int, int]
    fields: Tuple[str, ...]           # float KV fields present (k/v or ckv)
    dtypes: Dict[str, object]
    raw_nbytes: int
    quant_nbytes: int
    refcount: int = 0
    # live representations; at most the placed tier's is authoritative
    reprs: dict = field(default_factory=dict)   # "hbm"|"host"|"disk" -> payload


class ChunkStore:
    """Chunk-granular KV store frontend over the shared placement core.

    Implements the engine-core kvstore protocol (``touch`` / ``promote`` /
    ``bandwidth_for`` / ``io_resident`` / ``note_io_hit``) keyed by request
    id, mapping each request to its chunk chain."""

    materialized = True               # serving engines skip the sim-put path

    def __init__(self, *, chunk_size: int = 16,
                 hbm_bw: float = 819e9, hbm_cap: float = 1 << 30,
                 host_bw: float = 100e9, host_cap: float = 1 << 33,
                 disk_bw: float = 10e9 / 8, disk_cap: float = 1 << 40,
                 quant: str = "none", store_dir: Optional[str] = None,
                 eviction: str = "benefit", default_tier: str = "host",
                 salt: str = "", device="cuda"):
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        if eviction not in ("benefit", "lru"):
            raise ValueError(f"unknown eviction policy {eviction!r}")
        if default_tier == "remote":          # TieredKVStore vocabulary
            default_tier = "disk"
        if default_tier not in CHUNK_TIERS:
            raise ValueError(f"unknown tier {default_tier!r}")
        self.device = resolve_device(device)
        self.chunk_size = chunk_size
        self.quant = quant
        self.store_dir = store_dir
        self.default_tier = default_tier
        self.salt = salt
        if store_dir:
            os.makedirs(store_dir, exist_ok=True)
        self.core = PlacementCore(
            [Tier("hbm", hbm_bw, hbm_cap), Tier("host", host_bw, host_cap),
             Tier("disk", disk_bw, disk_cap)],
            size_fn=self._size, move_fn=self._move, drop_fn=self._drop,
            victim_fn=self._benefit if eviction == "benefit" else None)
        # device-side block pool backing the hbm tier: one chunk == one
        # block, so an hbm repr is a block id and every request table
        # aliasing the chunk shares ONE physical copy (CoW on writes)
        self.pool = BlockPool(chunk_size)
        self.chunks: Dict[str, _Chunk] = {}
        # device payloads staged by the fused datapath, consumed by _move's
        # hbm branch so promotion reuses the bytes already on device
        self._staged_dev: Dict[str, dict] = {}
        self.requests: Dict[str, List[str]] = {}   # rid -> chunk key chain
        # accounting (benchmarks/tests read these)
        self.dedup_hits = 0
        self.bytes_deduped = 0
        self.forks = 0                   # O(1) session forks (fork_request)
        self.puts = 0
        self.fetches = 0                 # chunk transfers out of host/disk
        self.io_hits = 0                 # fetches served from the hbm view
        self.skipped_transfers = 0       # engine-level channel skips
        self.bytes_put = 0
        self.bytes_transferred = 0       # bytes moved toward HBM (post-quant)
        self.store_misses = 0
        self.max_scale = 0.0             # worst per-channel int8 scale seen

    # ------------------------------------------------------------------
    # Placement-core callbacks
    # ------------------------------------------------------------------
    def _size(self, key: str, tier: str) -> float:
        c = self.chunks[key]
        if tier != "hbm" and self.quant == "int8":
            return c.quant_nbytes
        return c.raw_nbytes

    def _benefit(self, key: str) -> float:
        """Restoration benefit density: recompute cost saved per stored
        byte.  Causal attention makes a chunk over [t0, t1) cost
        O(t1² − t0²) to recompute; every referent saves that."""
        c = self.chunks[key]
        t0, t1 = c.tokens
        return c.refcount * (t1 * t1 - t0 * t0 + (t1 - t0)) \
            / max(1, c.raw_nbytes)

    def _move(self, key: str, src: Optional[str], dst: str):
        c = self.chunks[key]
        if dst not in c.reprs:
            if dst == "hbm":
                # the hbm repr is a pool BLOCK ID (the store holds one pool
                # ref; request block tables aliasing the chunk hold more)
                staged = self._staged_dev.pop(key, None)
                c.reprs["hbm"] = self.pool.alloc(
                    staged if staged is not None
                    else self._decode_device(key))
            elif dst == "host":
                c.reprs["host"] = self._encode_host(key)
            else:
                c.reprs["disk"] = self._encode_disk(key)
        for t in (*CHUNK_TIERS, "raw"):
            if t == dst or t not in c.reprs:
                continue
            if dst == "hbm" and self.quant == "int8" and t in ("host",
                                                              "disk"):
                # keep the authoritative int8 encoding as a shadow across
                # the promote: demoting back to a same-precision tier
                # reuses it instead of requantizing the decoded bf16 view
                # (which drifted one LSB per demote/promote cycle)
                continue
            self._del_repr(key, t)

    def _drop(self, key: str, src: Optional[str]):
        c = self.chunks.pop(key, None)
        if c is not None:
            for t in list(c.reprs):
                self._del_repr_obj(c, t)
        # the key stays in request chains: fetching it later is a store
        # miss and restoration falls back to recompute/ground truth

    def _del_repr(self, key: str, tier: str):
        self._del_repr_obj(self.chunks[key], tier)

    def _del_repr_obj(self, c: _Chunk, tier: str):
        rep = c.reprs.pop(tier, None)
        if tier == "hbm" and rep is not None:
            # release the STORE's pool ref; the physical block outlives the
            # hbm placement while any request block table still aliases it
            # (demotion/eviction never invalidates a live table)
            self.pool.decref(rep)
        if tier == "disk" and isinstance(rep, str) and os.path.exists(rep):
            os.remove(rep)

    # ------------------------------------------------------------------
    # Representation codecs
    # ------------------------------------------------------------------
    def _host_payload(self, key: str) -> dict:
        """The chunk as its host-tier encoding: raw numpy (quant="none")
        or {"kpos", f: {"q", "scales"}} (quant="int8")."""
        c = self.chunks[key]
        if "host" in c.reprs:
            return c.reprs["host"]
        if "disk" in c.reprs:
            return self._read_disk(c.reprs["disk"], c)
        if "raw" in c.reprs:                 # staged put, not yet placed
            raw = c.reprs["raw"]
        else:
            raw = self.device_view(key)
        if self.quant == "int8":
            return self._quantize(raw)
        return {f: self._to_host(a) for f, a in raw.items()}

    def _encode_host(self, key: str) -> dict:
        return self._host_payload(key)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy (pinned when the store runs on CUDA, so transfers
        back to the device can be asynchronous)."""
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.device.type == "cuda")
        return host.copy_(t)

    def _quantize(self, raw: dict) -> dict:
        """Encode on the DEVICE (the kv_quant kernel), then copy the int8
        codes and scales to the host.  A tail chunk demoted from HBM is a
        strided view of its pool block: the kernel takes it contiguous."""
        out = {"kpos": self._to_host(raw["kpos"])}
        for f, arr in raw.items():
            if f == "kpos":
                continue
            q, scales = kv_quantize(arr.to(self.device).contiguous())
            out[f] = {"q": self._to_host(q), "scales": self._to_host(scales)}
            self.max_scale = max(self.max_scale, float(out[f]["scales"].max()))
        return out

    def _decode_device(self, key: str) -> dict:
        """The chunk as device arrays in its original dtypes (the HBM view
        restoration load ops copy from)."""
        c = self.chunks[key]
        if "raw" in c.reprs:
            # a freshly-put chunk landing straight in HBM must NOT round-
            # trip through the quantizer: quantization applies only to
            # sub-HBM encodings (first demotion makes the int8 form
            # authoritative — never before)
            return dict(c.reprs["raw"])
        host = self._host_payload(key)
        dev = {"kpos": host["kpos"].to(self.device)}
        for f in c.fields:
            rep = host[f]
            if isinstance(rep, dict):              # quantized
                dev[f] = kv_dequantize(rep["q"].to(self.device),
                                       rep["scales"].to(self.device),
                                       dtype=c.dtypes[f])
            else:
                dev[f] = rep.to(self.device)
        return dev

    def _flatten_host(self, host: dict) -> dict:
        flat = {"kpos": host["kpos"]}
        for f, rep in host.items():
            if f == "kpos":
                continue
            if isinstance(rep, dict):
                flat[f + "__q"] = rep["q"]
                flat[f + "__scales"] = rep["scales"]
            else:
                flat[f + "__raw"] = rep
        return flat

    def _encode_disk(self, key: str):
        flat = self._flatten_host(self._host_payload(key))
        # bf16 has no numpy dtype: store its bits as an int16 view (the
        # chunk's recorded dtype turns them back on read)
        packed = {k: (a.view(torch.int16) if a.dtype == torch.bfloat16
                      else a).numpy() for k, a in flat.items()}
        if self.store_dir:
            path = os.path.join(self.store_dir, key + ".npz")
            np.savez(path, **packed)
            return path
        buf = io.BytesIO()
        np.savez(buf, **packed)
        return buf.getvalue()

    def _read_disk(self, rep, c: _Chunk) -> dict:
        src = rep if isinstance(rep, str) else io.BytesIO(rep)
        with np.load(src) as z:
            flat = {k: torch.from_numpy(z[k]) for k in z.files}
        pin = self.device.type == "cuda"
        flat = {k: a.pin_memory() if pin else a for k, a in flat.items()}
        host = {"kpos": flat["kpos"]}
        for f in c.fields:
            if f + "__q" in flat:
                host[f] = {"q": flat[f + "__q"], "scales": flat[f + "__scales"]}
            else:
                arr = flat[f + "__raw"]
                if c.dtypes[f] == torch.bfloat16:   # stored as an int16 view
                    arr = arr.view(torch.bfloat16)
                host[f] = arr
        return host

    # ------------------------------------------------------------------
    # Request-facing API
    # ------------------------------------------------------------------
    def put_request(self, rid: str, inputs, cache: dict,
                    tier: Optional[str] = None) -> List[str]:
        """Store a request's prefix KV as content-addressed chunks; chunks
        another request already stored dedup to a refcount bump.  Returns
        the chunk key chain."""
        keys = chunk_hash_chain(inputs, self.chunk_size, self.salt)
        fields = tuple(f for f in ATTN_FIELDS if f in cache)
        if not fields:
            raise ValueError("cache has no attention KV fields to store")
        n = int(inputs.shape[1])
        if rid in self.requests:
            self.free_request(rid)
        for ci, key in enumerate(keys):
            t0, t1 = ci * self.chunk_size, min(n, (ci + 1) * self.chunk_size)
            c = self.chunks.get(key)
            if c is not None:
                c.refcount += 1
                self.dedup_hits += 1
                self.bytes_deduped += c.raw_nbytes
                self.core.touch(key)
                continue
            # device copies of the chunk's slices (the live cache is updated
            # in place later, so the store keeps its own bytes)
            raw = {f: cache[f][:, :, t0:t1].clone() for f in fields}
            raw["kpos"] = cache["kpos"][:, t0:t1].clone()
            raw_nb = sum(a.numel() * a.element_size() for a in raw.values())
            quant_nb = raw["kpos"].numel() * 4 + sum(
                raw[f].numel() + raw[f].shape[-1] * 4 for f in fields)
            c = _Chunk((t0, t1), fields,
                       {f: cache[f].dtype for f in fields}, raw_nb, quant_nb,
                       refcount=1)
            # stage the exact payload; the placement's move_fn encodes it
            # for whatever tier the chunk actually lands in (quantization
            # only happens when a sub-HBM encoding is needed)
            c.reprs["raw"] = raw
            self.chunks[key] = c
            self.puts += 1
            self.bytes_put += raw_nb
            self.core.put(key, tier or self.default_tier)
        self.requests[rid] = keys
        return keys

    def fork_request(self, parent: str, child: str) -> List[str]:
        """O(1) session fork: the child references the parent's exact
        chunk chain — refcount bumps only, zero bytes staged, moved or
        copied.  Counted as dedup hits (the bytes the fork did NOT copy
        feed ``bytes_deduped``)."""
        keys = self.requests[parent]
        if child in self.requests:
            self.free_request(child)
        for key in keys:
            c = self.chunks.get(key)
            if c is None:
                continue                 # dropped chunk: future store miss
            c.refcount += 1
            self.dedup_hits += 1
            self.bytes_deduped += c.raw_nbytes
            self.core.touch(key)
        self.requests[child] = list(keys)
        self.forks += 1
        return list(keys)

    def free_request(self, rid: str):
        """Drop a request's reference to its chunks.  Chunks at refcount 0
        stay stored (prefix cache) but evict first (zero benefit)."""
        for key in self.requests.pop(rid, ()):
            c = self.chunks.get(key)
            if c is None:
                continue                 # already dropped from the bottom tier
            if c.refcount <= 0:
                raise AssertionError(f"negative refcount for chunk {key}")
            c.refcount -= 1

    def block_of(self, key: str) -> Optional[int]:
        """The pool block id backing an HBM-resident chunk (None when the
        chunk sits below HBM) — what request block tables alias."""
        c = self.chunks.get(key)
        if c is None or self.core.tier_of(key) != "hbm":
            return None
        return c.reprs["hbm"]

    def device_view(self, key: str) -> dict:
        """The HBM-resident chunk's fields as device array views, trimmed
        to the chunk's real token extent (tail blocks are zero-padded in
        the pool)."""
        c = self.chunks[key]
        dev = self.pool.read(c.reprs["hbm"])
        n = c.tokens[1] - c.tokens[0]
        out = {f: dev[f][:, :, :n] for f in c.fields}
        out["kpos"] = dev["kpos"][:, :n]
        return out

    def fetch(self, key: str) -> Optional[dict]:
        """The chunk as device arrays, promoting it to the HBM tier.  An
        already-resident chunk is a hit (no bytes transferred); a chunk in
        a lower tier transfers its (possibly quantized) stored bytes.
        Returns None (a store miss) if the chunk was dropped."""
        c = self.chunks.get(key)
        tier = self.core.tier_of(key)
        if c is None or tier is None:
            self.store_misses += 1
            return None
        if tier == "hbm":
            self.io_hits += 1
            self.core.touch(key)
            return self.device_view(key)
        self.fetches += 1
        self.bytes_transferred += self._size(key, tier)
        landed = self.core.promote(key, "hbm")
        if landed == "hbm":
            return self.device_view(key)
        # HBM tier can't hold it (oversized/cap pressure): ephemeral view
        return self._decode_device(key)

    def fetch_range(self, rid: str, t0: int, t1: int
                    ) -> Optional[List[Tuple[int, int, dict]]]:
        """Device payloads of every chunk overlapping tokens [t0, t1) —
        what a restoration load op copies into the live cache.  None if any
        chunk is missing (caller falls back to ground truth)."""
        keys = self.requests.get(rid)
        if keys is None:
            return None
        cs = self.chunk_size
        out = []
        for ci in range(t0 // cs, min(len(keys), -(-t1 // cs))):
            pay = self.fetch(keys[ci])
            if pay is None:
                return None
            c0, c1 = self.chunks[keys[ci]].tokens
            out.append((c0, c1, pay))
        return out

    def fetch_packed(self, key: str) -> Optional[Tuple[str, dict]]:
        """The chunk in its *stored* encoding, counting the transfer but
        not decoding: ``("hbm", device views)`` for a resident chunk (an
        io hit), else ``("int8"|"raw", host payload)`` — the fused
        datapath stages those bytes as-is and dequantizes on device, then
        lands the pool block via :meth:`promote_staged`.  Byte/hit/miss
        accounting is identical to :meth:`fetch`."""
        c = self.chunks.get(key)
        tier = self.core.tier_of(key)
        if c is None or tier is None:
            self.store_misses += 1
            return None
        if tier == "hbm":
            self.io_hits += 1
            self.core.touch(key)
            return "hbm", self.device_view(key)
        self.fetches += 1
        self.bytes_transferred += self._size(key, tier)
        form = "int8" if self.quant == "int8" else "raw"
        return form, self._host_payload(key)

    def fetch_range_packed(self, rid: str, t0: int, t1: int
                           ) -> Optional[List[Tuple[int, int, str, dict,
                                                    str]]]:
        """Packed (undecoded) payloads of every chunk overlapping tokens
        [t0, t1): a list of ``(c0, c1, form, payload, key)``.  None if any
        chunk is missing (caller falls back to ground truth)."""
        keys = self.requests.get(rid)
        if keys is None:
            return None
        cs = self.chunk_size
        out = []
        with obs.span("store.fetch", rid):
            for ci in range(t0 // cs, min(len(keys), -(-t1 // cs))):
                got = self.fetch_packed(keys[ci])
                if got is None:
                    return None
                c0, c1 = self.chunks[keys[ci]].tokens
                out.append((c0, c1, got[0], got[1], keys[ci]))
        return out

    def promote_staged(self, key: str, dev: dict) -> Optional[str]:
        """Land a fetched chunk in the HBM tier from the datapath's
        already-staged device arrays: ``_move``'s pool alloc consumes
        ``dev`` instead of decoding the host payload a second time, so a
        fused restore puts each chunk on the wire exactly once.  ``dev``
        must be the dequantized device payload trimmed to the chunk's real
        token extent."""
        with obs.span("store.promote_staged"):
            if self.core.tier_of(key) == "hbm":
                return "hbm"
            self._staged_dev[key] = dev
            try:
                return self.core.promote(key, "hbm")
            finally:
                self._staged_dev.pop(key, None)

    # ------------------------------------------------------------------
    # Engine-core kvstore protocol (keyed by request id)
    # ------------------------------------------------------------------
    def touch(self, rid: str):
        for key in self.requests.get(rid, ()):
            self.core.touch(key)

    def promote(self, rid: str, to: str = "host"):
        if to == "remote":
            to = "disk"
        for key in self.requests.get(rid, ()):
            self.core.promote(key, to)

    def tier_of(self, rid: str) -> Optional[str]:
        """Worst (lowest) tier among the request's chunks."""
        worst = None
        for key in self.requests.get(rid, ()):
            t = self.core.tier_of(key)
            if t is None:
                return None              # a chunk is gone: treat as cold
            if worst is None or CHUNK_TIERS.index(t) > CHUNK_TIERS.index(worst):
                worst = t
        return worst

    def bandwidth_for(self, rid: str) -> float:
        tier = self.tier_of(rid) or "disk"
        bw = self.core.tiers[tier].bandwidth
        if self.quant == "int8" and tier != "hbm":
            bw *= 2.0                    # int8 halves the bytes on the wire
        return bw

    def io_resident(self, rid: str, tokens: Tuple[int, int],
                    layers: Tuple[int, int]) -> bool:
        """True iff every chunk overlapping the token span is HBM-resident
        — the transfer for this I/O unit can be skipped entirely."""
        keys = self.requests.get(rid)
        if not keys:
            return False
        cs = self.chunk_size
        t0, t1 = tokens
        for ci in range(t0 // cs, min(len(keys), -(-t1 // cs))):
            if self.core.tier_of(keys[ci]) != "hbm":
                return False
        return True

    def note_io_hit(self, rid: str, tokens: Tuple[int, int],
                    layers: Tuple[int, int]):
        self.skipped_transfers += 1

    def missing_fraction(self, rid: str, tokens: Tuple[int, int],
                         layers: Tuple[int, int]) -> float:
        """Bytes-weighted fraction of the I/O unit's blocks NOT already
        HBM-resident — block-granular residency for the engine core's
        partial-transfer pricing: a unit with some blocks on device only
        pays the interconnect for the missing ones (partial eviction no
        longer re-transfers from token 0)."""
        keys = self.requests.get(rid)
        if not keys:
            return 1.0
        cs = self.chunk_size
        t0, t1 = tokens
        tot = miss = 0
        for ci in range(t0 // cs, min(len(keys), -(-t1 // cs))):
            c = self.chunks.get(keys[ci])
            nb = c.raw_nbytes if c is not None else cs
            tot += nb
            if self.core.tier_of(keys[ci]) != "hbm":
                miss += nb
        return miss / tot if tot else 1.0

    # ------------------------------------------------------------------
    def quant_tolerance(self) -> float:
        """Documented bound on the restored-KV error under int8: 0.5·scale
        round-off + up to 0.5·scale from the bf16 re-cast of the decoded
        view, per channel — i.e. one max-magnitude scale."""
        return 0.0 if self.quant == "none" else self.max_scale + 1e-6

    def audit(self):
        self.core.audit()
        self.pool.audit()
        n_hbm = sum(1 for k in self.chunks
                    if self.core.tier_of(k) == "hbm")
        # every hbm-resident chunk pins exactly one store-side pool ref;
        # request block tables may pin more, never fewer
        assert self.pool.live_blocks() >= n_hbm, \
            (self.pool.live_blocks(), n_hbm)
        for rid, keys in self.requests.items():
            for key in keys:
                c = self.chunks.get(key)
                assert c is None or c.refcount >= 0, (rid, key)
