"""Serving engine: continuous batching with CacheFlow restoration.

Counterpart of ``repro.serving.engine`` (the real-mode engine; the
simulation engine is not ported yet).  ``RealServingEngine`` is a thin
facade over the shared event loop
(:class:`repro_torch.core.engine_core.EngineCore`) with a ``RealBackend``
that executes the dispatched ops on the device (restoration → suffix
prefill → batched decode), wall-clock timed and output-verified.

The whole first-token path runs INSIDE the engine loop: suffix prefill is a
scheduled op competing FCFS with other requests' restoration chunks, and
decode is a recurring batched step — so TTFT = wait + restoration +
*contended* suffix prefill, and the report additionally carries end-to-end
latency, TPOT/TBT and generation throughput.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.baselines import make_baseline_plans
from repro_torch.core.boundary import stage_bounds
from repro_torch.core.engine_core import (EngineCore, EngineRequest, EngineResult,
                                          RealBackend, interleaving_dur_fn)
from repro_torch.core.executor import RestorationExecutor
from repro_torch.models.model import resolve_device
from repro_torch.serving.metrics import lifecycle_stats, percentiles
from repro_torch.serving.request import Phase, Request


@dataclass
class ServingReport:
    system: str
    ttfts: Dict[str, float]
    restore_secs: Dict[str, float]
    compute_busy: float
    io_busy: float
    stats: dict = field(default_factory=dict)
    e2e: Dict[str, float] = field(default_factory=dict)       # finish - arrival
    tpots: Dict[str, float] = field(default_factory=dict)     # per output token
    decode_busy: float = 0.0
    preemptions: Dict[str, int] = field(default_factory=dict)  # rid -> count
    finishes: Dict[str, float] = field(default_factory=dict)   # rid -> engine t
    arrivals: Dict[str, float] = field(default_factory=dict)   # rid -> engine t
    overlap_decode_restore: float = 0.0   # secs decode and restoration ran
                                          # concurrently (steady-state metric)
    sanitizer: Optional[dict] = None      # SanitizerCounters.as_dict() when
                                          # the run sanitized, else None
    telemetry: Optional[dict] = None      # Telemetry.snapshot() when the
                                          # run collected metrics, else None

    def __post_init__(self):
        if not self.stats:
            self.stats = percentiles(self.ttfts.values())


def _fill_lifecycle(requests: List[Request], res: EngineResult):
    """Map engine-clock lifecycle times back onto the Request objects and
    derive the per-request serving metrics.

    Stream-safe: completion comes from the engine's PER-REQUEST ``finish``
    events — a request that never retired (e.g. the run was truncated) is
    left un-finalized instead of being back-filled from restore completion,
    so downstream rates never count phantom completions."""
    ttfts, restore_secs, e2e, tpots = {}, {}, {}, {}
    arrivals, finishes = {}, {}
    total_tokens = 0
    for r in requests:
        rid = r.request_id
        arrivals[rid] = r.arrival
        fin = res.restore_finish.get(rid)
        if fin is None:
            continue
        start = res.restore_start.get(rid, r.arrival)
        r.t_restore_start, r.t_restore_end = start, fin
        restore_secs[rid] = fin - start
        ft = res.first_token.get(rid)
        if ft is not None:
            r.t_first_token = ft
            ttfts[rid] = ft - r.arrival
        done = res.finish.get(rid)
        if done is None:
            # restored but never retired — still mid-lifecycle
            continue
        r.t_done = done
        r.phase = Phase.DONE
        finishes[rid] = done
        e2e[rid] = done - r.arrival
        n_out = r.decode_len if r.decode_len > 0 else (1 if r.new_len else 0)
        total_tokens += n_out
        if ft is not None and n_out > 1:
            tpots[rid] = (done - ft) / (n_out - 1)
    return ttfts, restore_secs, e2e, tpots, total_tokens, arrivals, finishes


# ---------------------------------------------------------------------------
# Real mode (wall clock, output-verified)
# ---------------------------------------------------------------------------


class RealServingEngine:
    def __init__(self, model, params, *, system: str = "cacheflow",
                 stages: int = 1, chunk_size: int = 16, l_delta: int = 64,
                 seed: int = 0, io_channels: int = 1, max_batch: int = 0,
                 kvstore=None, preempt: str = "none", evict: bool = False,
                 admission: str = "continuous", prefetch: bool = False,
                 datapath: str = "fused", sanitize: Optional[bool] = None,
                 telemetry=None, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on {self.device}")
        self.model = model
        self.params = params
        self.system = system
        self.stages = stages
        self.chunk_size = chunk_size
        self.l_delta = l_delta
        self.io_channels = io_channels
        self.max_batch = max_batch
        self.kvstore = kvstore
        self.preempt = preempt
        self.evict = evict
        self.admission = admission
        self.prefetch = prefetch
        self.sanitize = sanitize
        self.telemetry = telemetry
        # a MATERIALIZED store (repro_torch.storage.ChunkStore) plugs in as both
        # the engine-core kvstore (residency/bandwidth/dedup-hit protocol)
        # and the executor's byte source: load ops then move real chunk
        # bytes out of its tiers instead of copying ground truth
        materialized = getattr(kvstore, "materialized", False)
        if materialized and kvstore.device != self.device:
            raise ValueError(f"store on {kvstore.device}, engine on {self.device}")
        # "fused" (default) restores through core/datapath.py: per-channel
        # double-buffered copy streams + one dequant-scatter launch per
        # load op; "legacy" keeps the per-chunk copy baseline.  A prebuilt
        # RestoreDatapath may be passed directly.
        dp = None
        if materialized and datapath not in (None, "legacy"):
            if datapath == "fused":
                from repro_torch.core.datapath import RestoreDatapath
                dp = RestoreDatapath.for_channels(io_channels, device=self.device)
            else:
                dp = datapath
        self.datapath = dp
        self.executor = RestorationExecutor(
            model, params, chunk_size=chunk_size, stages=stages,
            chunk_store=kvstore if materialized else None, datapath=dp)
        self.seed = seed

    def _inputs(self, n: int):
        """(1, n) int32 host token ids from a generator re-seeded per draw:
        same-length draws give the same tokens (as the reference's single
        PRNG key does — what makes store dedup fire across same-length
        requests), different lengths give unrelated tokens."""
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + n)
        return torch.randint(0, self.model.cfg.vocab_size, (1, n),
                             generator=gen, dtype=torch.int32)

    def remember(self, r: Request):
        """Previous-turn prefill: persist KV + boundaries for the request."""
        self.executor.remember(r.request_id, self._inputs(r.prefix_len))
        if self.kvstore is not None and \
                not getattr(self.kvstore, "materialized", False):
            # the materialized store already holds the real chunk bytes
            # (executor.remember wrote them); only the sim-model store
            # needs a virtual whole-request placement
            self.kvstore.put(r.request_id,
                             r.prefix_len * self.model.cfg.kv_bytes_per_token())

    def fork(self, parent_rid: str, child_rid: str):
        """O(1) session fork: the child aliases the parent's stored prefix
        (shared arrays + chunk-chain refcount bumps + CoW block tables on
        device) instead of re-running prefill — how an agentic tree search
        speculates K branches off one live context.  Requests carrying
        ``meta={"fork_of": parent_id}`` take this path in :meth:`serve`."""
        return self.executor.fork(parent_rid, child_rid)

    def _make_plans(self, r: Request, bounds):
        cfg = self.model.cfg
        # attention-free models restore layer-wise only: no token pointers
        # (DESIGN §5), so no prefix length reaches l_delta's token-wise plans
        l_delta = 10**9 if cfg.rwkv is not None else self.l_delta
        return make_baseline_plans(
            self.system, r.request_id, r.prefix_len,
            chunk_size=self.chunk_size, l_delta=l_delta,
            num_layers=cfg.num_layers, stage_bounds=bounds)

    def serve(self, requests: List[Request], *, verify: bool = True,
              op_order: str = "measured",
              rng: Optional[np.random.Generator] = None,
              trace=None) -> ServingReport:
        """Drive ALL requests through the shared engine core for their whole
        lifecycle: concurrent restoration (continuous batching), per-stage
        suffix prefill competing FCFS with restoration chunks, and recurring
        batched decode steps — every op executes on device.

        ``verify=True`` checks each restored cache against its full-prefill
        ground truth the moment restoration completes (before the suffix
        touches the cache); per-request first-token logits and greedy decode
        outputs are retrievable via ``self.executor.outputs(rid)``.

        op_order="measured" drives the schedule with real measured op
        durations; the other modes (see ``interleaving_dur_fn``) randomize
        the multi-request interleaving for correctness testing.

        Reported times are ENGINE-CLOCK times: measured per-op durations
        arranged on the engine's resource model, where compute, I/O and
        decode overlap as they would on parallel hardware — this host
        executes ops serially, so the true serial wall time for the whole
        batch is reported separately as ``stats["serve_wall"]``.

        ``trace``: optional recorder with the interface of the reference's
        ``TraceRecorder`` (trace capture is not ported yet)."""
        cfg = self.model.cfg
        bounds = (stage_bounds(cfg.num_layers, self.stages)
                  if self.stages > 1 else None)
        engine_reqs = []
        for r in requests:
            if r.request_id not in self.executor.store:
                parent = r.meta.get("fork_of") if r.meta else None
                if parent is not None and parent in self.executor.store:
                    if self.executor.store.get(parent).n_tokens != r.prefix_len:
                        raise ValueError(
                            f"fork {r.request_id}: prefix_len {r.prefix_len} "
                            f"!= parent {parent} stored length "
                            f"{self.executor.store.get(parent).n_tokens}")
                    self.fork(parent, r.request_id)
                else:
                    self.remember(r)
            r.phase = Phase.RESTORING
            if r.new_len > 0 or r.decode_len > 0:
                suffix = self._inputs(r.new_len) if r.new_len > 0 else None
                self.executor.set_suffix(r.request_id, suffix,
                                         decode_len=r.decode_len)
            engine_reqs.append(EngineRequest(r.request_id, r.prefix_len,
                                             arrival=r.arrival,
                                             plans=self._make_plans(r, bounds),
                                             new_len=r.new_len,
                                             decode_len=r.decode_len,
                                             priority=r.priority,
                                             deadline=r.deadline))
        # a quantized chunk store's restored KV carries its documented int8
        # error on top of the chunked-recompute tolerance
        atol = None
        if getattr(self.kvstore, "materialized", False) \
                and self.kvstore.quant != "none":
            atol = 2e-2 + self.kvstore.quant_tolerance()
        backend = RealBackend(self.executor,
                              dur_fn=interleaving_dur_fn(op_order, rng),
                              verify=verify, verify_atol=atol)
        core = EngineCore(backend, stages=self.stages,
                          io_channels=self.io_channels,
                          max_active=self.max_batch, kvstore=self.kvstore,
                          preempt=self.preempt, evict=self.evict,
                          admission=self.admission, prefetch=self.prefetch,
                          sanitize=self.sanitize, telemetry=self.telemetry,
                          strict=True)
        t0 = time.perf_counter()
        res = core.run(engine_reqs, trace=trace)
        serve_wall = time.perf_counter() - t0
        san = core.last_sanitizer
        tel = core.last_telemetry
        ttfts, restore_secs, e2e, tpots, total, arrivals, finishes = \
            _fill_lifecycle(requests, res)
        for r in requests:
            if r.new_len > 0:
                out = self.executor.outputs(r.request_id)
                if not bool(torch.isfinite(out["first_logits"]).all()):
                    raise AssertionError(
                        f"non-finite first-token logits for {r.request_id}")
        return ServingReport(self.system, ttfts, restore_secs,
                             res.compute_busy, res.io_busy,
                             e2e=e2e, tpots=tpots, decode_busy=res.decode_busy,
                             preemptions=dict(res.preemptions),
                             arrivals=arrivals, finishes=finishes,
                             overlap_decode_restore=res.overlap_decode_restore,
                             sanitizer=(san.counters.as_dict()
                                        if san is not None else None),
                             telemetry=(tel.snapshot()
                                        if tel is not None else None),
                             stats=lifecycle_stats(
                                 ttfts, e2e, tpots, total, res.makespan,
                                 arrivals=arrivals, finishes=finishes,
                                 offered=len(requests))
                             | {"serve_wall": serve_wall})
