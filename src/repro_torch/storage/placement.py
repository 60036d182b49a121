"""Tier placement & accounting core shared by every KV-storage frontend.

A copy of ``repro.storage.placement``.  One state machine answers "which
tier holds this entry?" for both the reference's sim-mode
``TieredKVStore`` (whole-request payloads, virtual bytes) and the
materialized :class:`repro_torch.storage.chunkstore.ChunkStore`
(content-addressed chunks, real tensor bytes).  The core owns capacities, recency, eviction order and
the demotion cascade; frontends own what an entry *is* (its bytes, its
per-tier encoding) through three callbacks:

  * ``size_fn(key, tier) -> int``   — entry size in ``tier`` (pure; lower
    tiers may store a compressed encoding, e.g. int8-quantized KV).
  * ``move_fn(key, src, dst)``      — re-encode the payload for ``dst``
    (``src is None`` on first insert).  Called exactly once per placement.
  * ``drop_fn(key, src)``           — the entry leaves the store entirely
    (bottom-tier eviction overflow).

Eviction is benefit-aware when ``victim_fn`` is given: the tier victim is
the entry with the SMALLEST ``victim_fn(key)`` (least restoration benefit
lost per byte evicted), recency breaking ties; without it, plain LRU.

Demotion cascades correctly when lower tiers are full (the historical
``TieredKVStore._evict_for`` could over-fill a tier or silently lose
entries):

  * an entry larger than a tier's whole capacity skips that tier and
    places in the first tier below that can hold it — no tier is ever
    filled past capacity;
  * a victim demoted into a full tier recursively evicts there;
  * only the bottom tier drops entries, and every drop is counted
    (``drops``) and surfaced to the frontend via ``drop_fn``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class Tier:
    name: str
    bandwidth: float               # bytes/s toward HBM
    capacity: int                  # bytes
    used: int = 0
    # key -> nbytes in THIS tier's encoding; front = eviction candidate
    lru: "OrderedDict[str, int]" = field(default_factory=OrderedDict)

    def __post_init__(self):
        # byte accounting is EXACT integers: repeated float +=/-= drifts
        # over long continuous-batching runs and capacity checks go soft
        self.capacity = int(self.capacity)
        self.used = int(self.used)


class PlacementCore:
    def __init__(self, tiers: Sequence[Tier], *,
                 size_fn: Optional[Callable[[str, str], float]] = None,
                 move_fn: Optional[Callable[[str, Optional[str], str], None]] = None,
                 drop_fn: Optional[Callable[[str, Optional[str]], None]] = None,
                 victim_fn: Optional[Callable[[str], float]] = None):
        self.order: List[str] = [t.name for t in tiers]
        self.tiers: Dict[str, Tier] = {t.name: t for t in tiers}
        self.size_fn = size_fn
        self.move_fn = move_fn
        self.drop_fn = drop_fn
        self.victim_fn = victim_fn
        self.placement: Dict[str, str] = {}      # key -> tier name
        self._sizes: Dict[str, int] = {}         # key -> nominal (raw) nbytes
        # incremental recency index: key -> monotone stamp, bumped on every
        # insert/touch.  Within a tier, stamp order == LRU order, so the
        # benefit-aware victim scan breaks ties in O(1) per candidate
        # instead of rebuilding an O(n) position map per eviction (which
        # made demotion cascades under a full store quadratic).
        self._stamp: Dict[str, int] = {}
        self._seq = 0
        self.demotions = 0
        self.promotions = 0
        self.drops = 0

    # ------------------------------------------------------------------
    def _size(self, key: str, tier: str) -> int:
        if self.size_fn is not None:
            return int(self.size_fn(key, tier))
        return self._sizes[key]

    def _restamp(self, key: str):
        self._seq += 1
        self._stamp[key] = self._seq

    def _index(self, tier: str) -> int:
        return self.order.index(tier)

    # ------------------------------------------------------------------
    def put(self, key: str, tier: str, *, nbytes: Optional[float] = None
            ) -> Optional[str]:
        """Place ``key`` in ``tier`` or the first tier below it that can
        hold it (after eviction).  Returns the tier the entry actually
        landed in, or None if it fell off the bottom (dropped, counted)."""
        if nbytes is not None:
            self._sizes[key] = int(nbytes)
        src = self._detach(key)
        return self._place(key, self._index(tier), src)

    def _place(self, key: str, i: int, src: Optional[str]) -> Optional[str]:
        while i < len(self.order):
            t = self.tiers[self.order[i]]
            nb = self._size(key, t.name)
            if nb <= t.capacity and self._evict_for(i, nb):
                if self.move_fn is not None:
                    self.move_fn(key, src, t.name)
                t.lru[key] = nb
                t.used += nb
                self.placement[key] = t.name
                self._restamp(key)
                return t.name
            i += 1
        # fell off the bottom: the entry leaves the store (accounted)
        self.drops += 1
        self._sizes.pop(key, None)
        self._stamp.pop(key, None)
        if self.drop_fn is not None:
            self.drop_fn(key, src)
        return None

    def _evict_for(self, i: int, nbytes: float) -> bool:
        """Make room for ``nbytes`` in tier index ``i`` by demoting victims
        downward; returns False iff the tier cannot be made to fit (then the
        caller tries the next tier down — never over-fills this one)."""
        t = self.tiers[self.order[i]]
        while t.used + nbytes > t.capacity:
            victim = self._pick_victim(t)
            if victim is None:
                return False
            vb = t.lru.pop(victim)
            t.used -= vb
            del self.placement[victim]
            # count the demotion only if the victim LANDED somewhere below;
            # a victim that falls off the bottom is a drop (counted in
            # _place) and must not inflate both counters
            if self._place(victim, i + 1, t.name) is not None:
                self.demotions += 1
        return True

    def _pick_victim(self, t: Tier) -> Optional[str]:
        if not t.lru:
            return None
        if self.victim_fn is None:
            return next(iter(t.lru))
        # benefit-aware: least benefit first; the incremental recency stamp
        # breaks ties in LRU order without rebuilding a position map on
        # every eviction of a cascade
        return min(t.lru, key=lambda k: (self.victim_fn(k), self._stamp[k]))

    def _detach(self, key: str) -> Optional[str]:
        """Remove ``key`` from its current tier (accounting only); returns
        the tier it was in."""
        tier = self.placement.pop(key, None)
        if tier is not None:
            t = self.tiers[tier]
            t.used -= t.lru.pop(key)
        return tier

    # ------------------------------------------------------------------
    def touch(self, key: str):
        tier = self.placement.get(key)
        if tier is not None and key in self.tiers[tier].lru:
            self.tiers[tier].lru.move_to_end(key)
            self._restamp(key)

    def tier_of(self, key: str) -> Optional[str]:
        return self.placement.get(key)

    def promote(self, key: str, to: str) -> Optional[str]:
        """Move ``key`` UP to ``to`` (no-op if already at or above it).

        A promotion counts — and resets the entry's recency — only when the
        entry actually lands STRICTLY above its source tier.  If no tier in
        [to, src) can hold the entry (each would be skipped for capacity),
        the whole call is a pure no-op: the entry keeps its LRU position
        and ``promotions`` stays put.  (``_place`` never fails with side
        effects: a tier with ``nb <= capacity`` can always be evicted into
        fitting, so checking capacities up front is exact.)"""
        tier = self.placement.get(key)
        if tier is None or self._index(tier) <= self._index(to):
            return tier
        i_src = self._index(tier)
        if not any(self._size(key, self.order[i])
                   <= self.tiers[self.order[i]].capacity
                   for i in range(self._index(to), i_src)):
            return tier
        src = self._detach(key)
        self.promotions += 1
        return self._place(key, self._index(to), src)

    def remove(self, key: str) -> Optional[str]:
        """Forget ``key`` entirely (caller owns the payload); returns the
        tier it occupied."""
        tier = self._detach(key)
        self._sizes.pop(key, None)
        self._stamp.pop(key, None)
        return tier

    # ------------------------------------------------------------------
    def total_used(self) -> int:
        return sum(t.used for t in self.tiers.values())

    def audit(self):
        """Invariants every mutation must preserve: per-tier ``used``
        EXACTLY equals the sum of its entries (integer bytes — no float
        drift tolerance), no tier exceeds capacity, and the placement map
        mirrors tier membership exactly."""
        for t in self.tiers.values():
            assert t.used == sum(t.lru.values()), \
                f"{t.name}: used {t.used} != sum {sum(t.lru.values())}"
            assert t.used <= t.capacity, \
                f"{t.name}: over capacity ({t.used} > {t.capacity})"
            for k in t.lru:
                assert self.placement.get(k) == t.name, k
                assert k in self._stamp, k
        for k, tier in self.placement.items():
            assert k in self.tiers[tier].lru, k
