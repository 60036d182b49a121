"""Tiered KV store: HBM / host DRAM / remote, with bandwidth + capacity model.

A copy of ``repro.serving.kvstore``.

On a real fleet the tiers are per-device HBM, host DRAM over DMA, and a
remote disaggregated store over the network (the paper's 10–80 Gbps
regime).  This is the SIM-MODE facade: placement is per *request* payload
(KV bytes + boundary activations) and no real bytes move — the store
tracks placement, enforces capacities, and reports the channel bandwidth
restoration I/O sees for a given request, which is what the CacheFlow cost
model and simulator consume.  The materialized, chunk-granular store that
actually holds tensor bytes (real mode) is
:class:`repro_torch.storage.chunkstore.ChunkStore`; both sit on the SAME
placement/accounting core (:mod:`repro_torch.storage.placement`), so capacities,
recency, and the demotion cascade behave identically.

The cascade is correct when lower tiers are also full (see
``PlacementCore``): an entry larger than a tier's capacity skips to the
first tier that fits, demotion into a full tier recursively evicts there,
and only the bottom tier drops entries (counted, never silent).

``quant="int8"`` models the kv_quant compression of sub-HBM tiers: entries
below ``hbm`` occupy half their bytes and their transfers see 2× the
tier's nominal bandwidth (half the bytes on the wire).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.storage.placement import PlacementCore, Tier

TIER_ORDER = ("hbm", "host", "remote")


class TieredKVStore:
    def __init__(self, *, hbm_bw: float = 819e9, hbm_cap: float = 4e9,
                 host_bw: float = 100e9, host_cap: float = 200e9,
                 remote_bw: float = 10e9 / 8, remote_cap: float = 100e12,
                 io_channels: int = 1, quant: str = "none"):
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        self.quant = quant
        self.core = PlacementCore(
            [Tier("hbm", hbm_bw, hbm_cap), Tier("host", host_bw, host_cap),
             Tier("remote", remote_bw, remote_cap)],
            size_fn=self._size)
        self.io_channels = io_channels
        self._raw: dict = {}            # rid -> nominal payload bytes
        self.io_hits = 0                # transfers skipped (HBM-resident)

    # ------------------------------------------------------------------
    def _size(self, rid: str, tier: str) -> float:
        nb = self._raw[rid]
        if self.quant == "int8" and tier != "hbm":
            return (nb + 1) // 2        # int8 halves the bf16 payload
        return nb

    @property
    def tiers(self):
        return self.core.tiers

    @property
    def placement(self):
        return self.core.placement

    # ------------------------------------------------------------------
    def put(self, rid: str, nbytes: int, tier: str = "host"):
        """Store a request's KV payload, demoting victims downward (the
        cascade never over-fills a tier; bottom-tier drops are counted)."""
        self._raw[rid] = nbytes
        self.core.put(rid, tier)

    def touch(self, rid: str):
        self.core.touch(rid)

    def tier_of(self, rid: str) -> Optional[str]:
        return self.core.tier_of(rid)

    def bandwidth_for(self, rid: str) -> float:
        """Channel bandwidth restoration I/O sees for this request's payload."""
        tier = self.core.tier_of(rid) or "remote"
        bw = self.core.tiers[tier].bandwidth
        if self.quant == "int8" and tier != "hbm":
            bw *= 2.0                   # half the bytes move per KV token
        return bw

    def promote(self, rid: str, to: str = "host"):
        self.core.promote(rid, to)

    def evict(self, rid: str):
        self.core.remove(rid)
        self._raw.pop(rid, None)

    # ------------------------------------------------------------------
    # Engine-core residency protocol: an HBM-resident payload needs no
    # restoration transfer at all — the engine skips the I/O channel.
    # ------------------------------------------------------------------
    def io_resident(self, rid: str, tokens: Tuple[int, int],
                    layers: Tuple[int, int]) -> bool:
        return self.core.tier_of(rid) == "hbm"

    def note_io_hit(self, rid: str, tokens: Tuple[int, int],
                    layers: Tuple[int, int]):
        self.io_hits += 1
