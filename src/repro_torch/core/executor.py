"""Request-lifecycle executor on a real model (PyTorch).

Counterpart of ``repro.core.executor`` with the same method names — the
interface ``RealBackend`` calls.

Executes CacheFlow lifecycle ops (from the BatchScheduler / plans) on an
actual model: restoration compute ops run chunk/layer forwards on device,
load ops copy KV slices from the stored payload, suffix-prefill ops run the
new turn's tokens through each pipeline stage of the restored cache (the
last stage yields the first-token logits), and batched decode steps append
one generated token per request.  The restored cache is verified against
the full-prefill ground truth.  The simulator measures the schedule; this
executor proves its *correctness* (restored KV ≡ recomputed KV for any
legal op interleaving — a property test randomises the interleaving).

Requests are single-sequence (B = 1) as in the serving engine; decode
batches across requests by stepping each live cache in arrival order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.boundary import BoundaryStore, StoredRequest, stage_bounds
from repro_torch.core.plans import RequestPlan, make_request_plans
from repro_torch.core.scheduler import ScheduledOp
from repro_torch.models.kvcache import (PagedKVCache, grow_cache, park_cache,
                                        unpark_cache)
from repro_torch.models.model import Model

ATTN_FIELDS = ("k", "v", "ckv")


class RestorationExecutor:
    def __init__(self, model: Model, params, store: Optional[BoundaryStore] = None,
                 *, chunk_size: int = 16, stages: int = 1, chunk_store=None,
                 datapath=None):
        self.model = model
        self.params = params
        self.store = store or BoundaryStore()
        self.chunk_size = chunk_size
        self.stages = stages
        self.bounds = stage_bounds(model.cfg.num_layers, stages)
        # materialized chunk-granular KV store (repro.storage.ChunkStore):
        # load ops read REAL chunk bytes out of its tiers instead of the
        # boundary store's ground-truth payload.  Requires linear (non-ring)
        # attention caches; store blocks must tile the executor's I/O unit
        # (block size divides chunk_size), so residency — and partial
        # re-restoration after eviction — is BLOCK-granular even when the
        # restoration plan moves coarser units.
        if chunk_store is not None:
            if chunk_size % chunk_store.chunk_size != 0:
                raise ValueError(
                    f"chunk_store block size {chunk_store.chunk_size} must "
                    f"divide executor chunk_size {chunk_size}")
            if model.cfg.attn_window:
                raise ValueError("chunk store does not support ring-buffer "
                                 "(windowed) caches; token->slot is modular")
        self.chunk_store = chunk_store
        # fused restoration datapath (core/datapath.py): load ops consume
        # the store's PACKED chunk bytes through per-channel transfer
        # streams and one dequant-scatter launch per op; None restores
        # through the legacy per-chunk/per-layer/per-field copy
        # path (kept as the measured baseline and the fallback for ops
        # whose layer span has no attention slots)
        self.datapath = datapath
        self.io_channel = 0          # engine channel of the op in flight
        # accounting (benchmarks/tests): cache-write + staging dispatches
        # issued by load ops, and which path each load op took
        self.load_dispatches = 0
        self.fused_loads = 0
        self.legacy_loads = 0
        # live restoration state: rid -> dict(cache=..., act={stage: x}, ...)
        self._live: Dict[str, dict] = {}
        # lifecycle inputs registered before the engine runs:
        # rid -> (suffix inputs | None, decode_len)
        self._suffix: Dict[str, Tuple[object, int]] = {}
        # child rid -> parent rid for O(1) session forks (fork())
        self._forks: Dict[str, str] = {}
        # rid -> per-field worst |restored - reference| of the last verify
        self.verify_errs: Dict[str, dict] = {}

    # ------------------------------------------------------------------
    # Previous turn: full (chunked) prefill; persist KV + boundaries + states
    # ------------------------------------------------------------------
    def remember(self, rid: str, inputs) -> StoredRequest:
        m, cfg = self.model, self.model.cfg
        n = inputs.shape[1]
        cache = m.init_cache(1, n, dtype=m.compute_dtype)
        boundaries = {s: [] for s in range(self.stages)}
        snapshots: Dict[Tuple[int, int], dict] = {}
        c = self.chunk_size
        x_last = None
        for ci, t0 in enumerate(range(0, n, c)):
            t1 = min(n, t0 + c)
            pos = _positions(t0, t1)
            chunk = inputs[:, t0:t1]
            x = m.embed(self.params, chunk, pos)
            for s, (lo, hi) in enumerate(self.bounds):
                boundaries[s].append(x)
                for i in range(lo, hi):
                    x, cache = m.layer_chunk(self.params, i, x, pos, cache)
                # snapshot recurrent state at end of this chunk for this stage
                snap = _state_snapshot(cfg, cache)
                if snap:
                    snapshots[(s, ci)] = snap
            x_last = x
        logits = m.unembed(self.params, x_last[:, -1:])[:, 0]
        req = StoredRequest(
            request_id=rid, n_tokens=n, inputs=inputs,
            kv_reference=cache,
            boundaries={s: torch.cat(bs, dim=1) for s, bs in boundaries.items()},
            state_snapshots=snapshots, final_logits=logits)
        self.store.put(req)
        if self.chunk_store is not None and "kpos" in cache:
            # materialize the prefix KV as content-addressed chunks (shared
            # prefixes dedup); non-attention state stays in the boundary
            # store's snapshots — it has no per-token byte range
            self.chunk_store.put_request(rid, inputs, cache)
        return req

    def fork(self, parent_rid: str, child_rid: str) -> StoredRequest:
        """O(1) fork of a stored (possibly live) session: the child aliases
        the parent's stored prefix — inputs/KV reference/boundaries are
        SHARED arrays, the chunk chain forks by refcount bumps, and on
        device the child's block table will alias the parent's physical
        blocks (copy-on-write) when restoration begins.  No prefill runs
        and no KV bytes are copied; contrast with :meth:`remember`, which
        recomputes the whole prefix."""
        child = self.store.fork(parent_rid, child_rid)
        if self.chunk_store is not None:
            self.chunk_store.fork_request(parent_rid, child_rid)
        self._forks[child_rid] = parent_rid
        return child

    # ------------------------------------------------------------------
    # Restoration
    # ------------------------------------------------------------------
    def begin_restore(self, rid: str, plans: Optional[List[RequestPlan]] = None):
        req = self.store.get(rid)
        m = self.model
        cache = m.init_cache(1, req.n_tokens, dtype=m.compute_dtype)
        self._live[rid] = {"cache": cache, "act": {}, "req": req}
        if plans is not None:
            self._live[rid]["plans"] = {p.stage: p for p in plans}
        if self.chunk_store is not None and "kpos" in cache:
            parent = self._forks.get(rid)
            p_live = self._live.get(parent) if parent is not None else None
            if p_live is not None and "paged" in p_live:
                # fork of a LIVE session: the child's block table clones the
                # parent's — O(1) copied bytes, CoW from here on.  Only the
                # stored prefix is inherited (not the parent's decoded tail).
                paged = p_live["paged"].clone()
                paged.truncate(req.n_tokens)
            else:
                paged = PagedKVCache(self.chunk_store.pool, req.n_tokens)
            self._live[rid]["paged"] = paged
            self._sync_paged(rid)

    def _sync_paged(self, rid: str):
        """Alias every already-HBM-resident store block into the request's
        block table (no bytes move) — the table then answers residency at
        block granularity."""
        live = self._live[rid]
        paged: PagedKVCache = live["paged"]
        n_blocks = paged._nblocks(live["req"].n_tokens)
        for ci, key in enumerate(self.chunk_store.requests.get(rid, ())):
            if ci >= n_blocks:
                break
            bid = self.chunk_store.block_of(key)
            if bid is not None and not paged.has_block(ci):
                paged.map_block(ci, bid)

    def _paged_write(self, live: dict, t0: int, t1: int):
        """Write tokens [t0, t1) of the live contiguous cache through the
        request's block table (CoW: blocks shared with a forked session are
        copied before mutation)."""
        paged = live.get("paged")
        if paged is None:
            return
        cache = live["cache"]
        fields = {f: cache[f][:, :, t0:t1] for f in ATTN_FIELDS if f in cache}
        fields["kpos"] = cache["kpos"][:, t0:t1]
        paged.write_span(t0, t1, fields)

    def live_cache(self, rid: str):
        """The in-flight (or final) restored cache of a live restoration."""
        return self._live[rid]["cache"]

    def paged_cache(self, rid: str) -> Optional[PagedKVCache]:
        """The request's block-table view (None without a chunk store)."""
        live = self._live.get(rid)
        return live.get("paged") if live else None

    def make_plans(self, rid: str, *, l_delta: int, strategy: Optional[str] = None
                   ) -> List[RequestPlan]:
        req = self.store.get(rid)
        cfg = self.model.cfg
        if cfg.rwkv is not None:
            strategy = "layer"      # token pointers inapplicable (DESIGN §5)
        return make_request_plans(rid, req.n_tokens, chunk_size=self.chunk_size,
                                  l_delta=l_delta, num_layers=cfg.num_layers,
                                  stage_bounds=self.bounds if self.stages > 1 else None,
                                  strategy=strategy)

    # ------------------------------------------------------------------
    # Lifecycle inputs (registered before the engine core runs)
    # ------------------------------------------------------------------
    def set_suffix(self, rid: str, new_inputs, decode_len: int = 0):
        """Register the request's new-turn suffix (may be None for
        decode-only lifecycles) and decode extent; the engine core's
        prefill/decode ops pull from here."""
        self._suffix[rid] = (new_inputs, decode_len)

    def suffix_inputs(self, rid: str):
        return self._suffix[rid][0]

    def outputs(self, rid: str) -> dict:
        """Per-request lifecycle outputs: first-token logits, greedy token
        ids, and the logits of every decode step."""
        live = self._live[rid]
        return {"first_logits": live.get("first_logits"),
                "last_logits": live.get("last_logits"),
                "tokens": list(live.get("tokens_out", [])),
                "step_logits": list(live.get("step_logits", []))}

    def execute_op(self, op: ScheduledOp):
        if op.kind == "compute":
            self._exec_compute(op)
        elif op.kind == "prefill":
            self._exec_prefill(op)
        else:
            self._exec_load(op)

    # -- compute ---------------------------------------------------------
    def _stage_input(self, rid: str, stage: int, t0: int, t1: int):
        """Activations entering the stage's first layer for tokens [t0,t1)."""
        m = self.model
        live = self._live[rid]
        req: StoredRequest = live["req"]
        if stage == 0:
            pos = _positions(t0, t1)
            return m.embed(self.params, req.inputs[:, t0:t1], pos)
        return self.store.read_boundary(rid, stage)[:, t0:t1]

    def _exec_compute(self, op: ScheduledOp):
        m = self.model
        live = self._live[op.request_id]
        cache = live["cache"]
        t0, t1 = op.tokens
        lo, hi = op.layers
        pos = _positions(t0, t1)
        plan = _plan_of(live, op)
        if plan.strategy == "token":
            x = self._stage_input(op.request_id, op.stage, t0, t1)
            for i in range(lo, hi):
                x, cache = m.layer_chunk(self.params, i, x, pos, cache)
        else:
            # layer-wise: the full-prefix activation ENTERING each unit is
            # snapshotted per unit (not a single running value) so an op
            # aborted by preemption after it already ran re-executes from
            # the same input — idempotent for any abort/resume interleaving.
            # Only the last two snapshots are live: unit u-1 can never run
            # again once unit u dispatches (its completion is permanent).
            acts = live["act"]
            key = (op.stage, op.unit)
            if key not in acts:
                assert op.unit == 0, key
                acts[key] = self._stage_input(op.request_id, op.stage,
                                              0, plan.n_tokens)
            # the unit's layers run over the prefix in remember's chunks
            # (the reference takes the whole prefix in one pass): a GEMM
            # library may pick another kernel, and another summation order,
            # for another row count, and verify needs remember's arithmetic
            outs = []
            for c0 in range(t0, t1, self.chunk_size):
                c1 = min(t1, c0 + self.chunk_size)
                x = acts[key][:, c0 - t0:c1 - t0]
                for i in range(lo, hi):
                    x, cache = m.layer_chunk(self.params, i, x,
                                             _positions(c0, c1), cache)
                outs.append(x)
            x = torch.cat(outs, dim=1)
            acts[(op.stage, op.unit + 1)] = x
            acts.pop((op.stage, op.unit - 1), None)
        live["cache"] = cache

    def _attn_slot_span(self, lo: int, hi: int) -> Optional[Tuple[int, int]]:
        """Contiguous attention-slot range owned by layers [lo, hi) — slot
        counters grow monotonically with layer index, so any layer span
        maps to one contiguous slot range (asserted).  None when the span
        has no attention layers (pure-recurrent stage of a hybrid)."""
        slots = [s for k, s in (self.model.slots[i] for i in range(lo, hi))
                 if k == "attention"]
        if not slots:
            return None
        assert slots == list(range(slots[0], slots[0] + len(slots))), slots
        return slots[0], slots[-1] + 1

    # -- load --------------------------------------------------------------
    def _exec_load(self, op: ScheduledOp):
        live = self._live[op.request_id]
        req: StoredRequest = live["req"]
        cache, ref = live["cache"], req.kv_reference
        t0, t1 = op.tokens
        lo, hi = op.layers
        plan = _plan_of(live, op)
        slots = self.model.slots
        # materialized path: the transfer's bytes come out of the chunk
        # store's tiers; a store miss (chunk dropped off the bottom tier)
        # falls back to the ground truth.  With a datapath, the op's
        # chunks stay in their stored (possibly int8) encoding across the
        # wire and ONE fused dequant-scatter writes the whole layer span;
        # without one, the legacy loop decodes per chunk and issues one
        # in-place slice copy per chunk x layer x field.
        chunks = packed = None
        if self.chunk_store is not None and "kpos" in cache:
            span = self._attn_slot_span(lo, hi)
            if self.datapath is not None and span is not None:
                packed = self.chunk_store.fetch_range_packed(
                    op.request_id, t0, t1)
            if packed is not None:
                self.datapath.restore_op(cache, packed,
                                         store=self.chunk_store,
                                         slot_span=span,
                                         channel=self.io_channel)
                self.fused_loads += 1
                self.load_dispatches += self.datapath.last_op_dispatches
                self._map_loaded_blocks(op.request_id, t0, t1)
            else:
                chunks = self.chunk_store.fetch_range(op.request_id, t0, t1)
                if chunks is not None:
                    self.legacy_loads += 1
                    self._map_loaded_blocks(op.request_id, t0, t1)
        kp_all = None
        # legacy per-chunk baseline + recurrent-state snapshot apply: kept
        # deliberately as the comparison point for the fused datapath
        for i in range(lo, hi):
            kind, slot = slots[i]
            if kind == "attention":
                if packed is not None:
                    continue          # fused scatter covered the whole span
                if chunks is not None:
                    for c0, c1, pay in chunks:
                        for f in ATTN_FIELDS:
                            if f in cache:
                                cache[f][slot, :, c0:c1] = pay[f][slot]
                                self.load_dispatches += 1
                        cache["kpos"][slot, c0:c1] = pay["kpos"][slot]
                        self.load_dispatches += 1
                    continue
                if kp_all is None:
                    kp_all = ref["kpos"].cpu().numpy()
                # slots whose stored position falls inside [t0, t1)
                sel = np.nonzero((kp_all[slot] >= t0)
                                 & (kp_all[slot] < t1))[0]
                if sel.size:
                    sel = torch.from_numpy(sel).to(cache["kpos"].device)
                    for f in ATTN_FIELDS:
                        if f in cache:
                            cache[f][slot][:, sel] = ref[f][slot][:, sel]
                    cache["kpos"][slot][sel] = ref["kpos"][slot][sel]
            else:
                # recurrent/rwkv state. Layer strategy: this layer is restored
                # wholly by I/O -> apply its end-of-prefix snapshot now (compute
                # never touches this slot). Token strategy: state fix-up happens
                # in finalize_restore so op order cannot clobber the live state.
                if plan.strategy == "layer":
                    n_chunks = -(-plan.n_tokens // self.chunk_size)
                    snap = req.state_snapshots.get((op.stage, n_chunks - 1))
                    if snap:
                        for f, arr in snap.items():
                            cache[f][slot] = arr[slot]
        live["cache"] = cache

    def _map_loaded_blocks(self, rid: str, t0: int, t1: int):
        """After a load fetched tokens [t0, t1), alias the now-HBM-resident
        store blocks into the request's block table."""
        live = self._live[rid]
        paged = live.get("paged")
        if paged is None:
            return
        keys = self.chunk_store.requests.get(rid, ())
        cs = self.chunk_store.chunk_size
        for ci in range(t0 // cs, min(len(keys), -(-t1 // cs))):
            bid = self.chunk_store.block_of(keys[ci])
            if bid is not None and not paged.has_block(ci):
                paged.map_block(ci, bid)

    # -- suffix prefill (one op per pipeline stage, in stage order) --------
    def _exec_prefill(self, op: ScheduledOp):
        m = self.model
        live = self._live[op.request_id]
        req: StoredRequest = live["req"]
        new_inputs, decode_len = self._suffix[op.request_id]
        t0, t1 = op.tokens
        lo, hi = op.layers
        positions = _positions(t0, t1)
        if "prefill_x" not in live:
            # first stage: make room for suffix + decode tail, embed suffix
            live["cache"] = grow_cache(m.cfg, live["cache"],
                                       req.n_tokens + (t1 - t0) + decode_len)
            live["prefill_x"] = m.embed(self.params, new_inputs, positions)
        x, cache = m.stack_chunk(self.params, live["prefill_x"], positions,
                                 live["cache"], lo, hi)
        live["prefill_x"], live["cache"] = x, cache
        if hi == m.cfg.num_layers:
            # last pipeline stage: the suffix's final activation gives the
            # request's FIRST output token
            logits = m.unembed(self.params, x[:, -1:])[:, 0]
            live["first_logits"] = logits
            live["last_logits"] = logits
            live["tokens_out"] = [int(torch.argmax(logits[0]))]
            live["step_logits"] = []
            live["pos"] = t1
            # every layer's suffix KV is now in the contiguous cache:
            # append it through the block table (CoW against forks)
            if "kpos" in live["cache"]:
                self._paged_write(live, t0, t1)

    # -- batched decode (one token per request per step) -------------------
    def decode_step_batch(self, rids: List[str]):
        """One engine decode step: append one generated token to every
        listed request's live cache (greedy feed of its previous output)."""
        m, cfg = self.model, self.model.cfg
        for rid in rids:
            live = self._live[rid]
            req: StoredRequest = live["req"]
            if "pos" not in live:
                # decode-only lifecycle (no suffix): seed from the stored
                # prefix's final logits and grow room for the decode tail
                _, decode_len = self._suffix.get(rid, (None, 0))
                live["cache"] = grow_cache(cfg, live["cache"],
                                           req.n_tokens + max(1, decode_len))
                live["last_logits"] = req.final_logits
                live["tokens_out"] = []
                live["step_logits"] = []
                live["pos"] = req.n_tokens
            # greedy feed (the port's models take token inputs only);
            # argmax ties resolve to the first index, as jnp.argmax
            inp = torch.argmax(live["last_logits"], dim=-1).to(torch.int32)
            logits, cache = m.decode_step(self.params, inp, live["cache"],
                                          live["pos"])
            live["cache"] = cache
            live["last_logits"] = logits
            if "kpos" in cache:
                # append the new token's KV through the block table: a tail
                # block shared with a forked sibling copies here (CoW)
                self._paged_write(live, live["pos"], live["pos"] + 1)
            live["pos"] += 1
            live["tokens_out"].append(int(torch.argmax(logits[0])))
            live["step_logits"].append(logits)

    # ------------------------------------------------------------------
    def restore(self, rid: str, *, l_delta: int = 0, strategy: Optional[str] = None,
                plans: Optional[List[RequestPlan]] = None,
                io_policy: str = "longest_remaining",
                op_order: str = "alternate", rng: Optional[np.random.Generator] = None):
        """Run a full restoration for one request; returns the live cache.

        Convenience wrapper: drives the shared engine core with a RealBackend
        over a single-request batch.  op_order: "alternate" | "io_first" |
        "compute_first" | "random" | "measured" — mapped onto schedule
        durations (see ``interleaving_dur_fn``); correctness must hold for
        ANY legal interleaving (property-tested).
        """
        from repro_torch.core.engine_core import (EngineCore, EngineRequest,
                                            RealBackend, interleaving_dur_fn)
        if plans is None:
            plans = self.make_plans(rid, l_delta=l_delta, strategy=strategy)
        backend = RealBackend(self, dur_fn=interleaving_dur_fn(op_order, rng))
        core = EngineCore(backend, stages=max(p.stage for p in plans) + 1,
                          io_channels=1, io_policy=io_policy, strict=True)
        req = self.store.get(rid)
        core.run([EngineRequest(rid, req.n_tokens, 0.0, plans)])
        return self._live[rid]["cache"]

    # ------------------------------------------------------------------
    # Preemption: park / unpark an in-flight restoration
    # ------------------------------------------------------------------
    def suspend_restore(self, rid: str):
        """Park a preempted request's restoration state: the partially
        restored cache and layer-strategy boundary activations move to host
        buffers so a suspended request stops pinning device memory while it
        waits for a slot.  ``finalize_restore`` (recurrent-state fix-up) is
        deliberately NOT run — restoration is incomplete and will continue,
        not restart, on resume."""
        live = self._live[rid]
        live["cache"] = park_cache(live["cache"])
        live["act"] = park_cache(live["act"])
        live["parked"] = True

    def resume_restore(self, rid: str):
        """Inverse of :meth:`suspend_restore`: the parked state returns to
        device exactly as suspended; released plan units re-execute
        idempotently on top of it."""
        live = self._live[rid]
        dev = self.model.device
        live["cache"] = unpark_cache(live["cache"], dev)
        live["act"] = unpark_cache(live["act"], dev)
        live.pop("parked", None)

    def drop_restore(self, rid: str):
        """Eviction-mode preemption: the partially-restored cache (and its
        boundary activations) are DROPPED — nothing is parked, host memory
        is freed immediately.  Restoration restarts from the KV store via a
        fresh :meth:`begin_restore` when the request is re-admitted.  The
        block table releases its refs, but blocks the STORE still holds
        stay HBM-resident — re-restoration re-fetches only the blocks the
        store actually demoted in the meantime, not the whole prefix."""
        live = self._live.pop(rid, None)
        if live is not None and "paged" in live:
            live["paged"].free()

    def release(self, rid: str):
        """Retire a finished request: free its live state (block-table refs
        included) and drop its store references.  Store-held blocks remain
        for prefix reuse; chunks at refcount 0 become eviction candidates."""
        self.drop_restore(rid)
        self._forks.pop(rid, None)
        if self.chunk_store is not None:
            self.chunk_store.free_request(rid)

    def is_live(self, rid: str) -> bool:
        return rid in self._live

    def finalize_restore(self, rid: str):
        """Recurrent-state fix-up for token-wise plans on hybrid archs: the
        end-of-prefix state must come from the tail chunk's snapshot whenever
        I/O restored the tail (compute ops legitimately run the state only up
        to the meeting point; op order must not matter)."""
        cfg = self.model.cfg
        if cfg.rglru is None and cfg.rwkv is None:
            return
        live = self._live[rid]
        req: StoredRequest = live["req"]
        cache = live["cache"]
        for stage, plan in live["plans"].items():
            if plan.strategy != "token" or plan.plan.io_done == 0:
                continue
            n_chunks = plan.plan.n_units
            snap = req.state_snapshots.get((stage, n_chunks - 1))
            if not snap:
                continue
            lo, hi = plan.layer_lo, plan.layer_hi
            for i in range(lo, hi):
                kind, slot = self.model.slots[i]
                if kind != "attention":
                    # tiny once-per-layer state fix-up at restore finalize,
                    # not the bulk KV path
                    for f, arr in snap.items():
                        cache[f][slot] = arr[slot]
        live["cache"] = cache

    # ------------------------------------------------------------------
    def verify(self, rid: str, atol: float = 2e-2) -> dict:
        """Compare the live restored cache against the ground-truth payload.
        An element passes iff ``|restored - ref| < atol``, for f32 and bf16
        caches alike: restoration repeats ``remember``'s arithmetic, so only
        int8 storage adds error, and the caller widens ``atol`` by the
        store's ``max_scale`` for that.  Returns the worst absolute error per
        field (raises on mismatch) and keeps it in ``verify_errs[rid]``."""
        live = self._live[rid]
        req: StoredRequest = live["req"]
        errs = {}
        for f in req.kv_reference:
            a = req.kv_reference[f]
            b = live["cache"][f]
            if f == "kpos":
                if not torch.equal(a, b):
                    raise AssertionError(f"kpos mismatch for {rid}")
                errs[f] = 0.0
                continue
            a, b = a.float(), b.float()
            diff = (a - b).abs()
            err = float(diff.max()) if a.numel() else 0.0
            errs[f] = err
            if a.numel() and bool(((diff >= atol) | diff.isnan()).any()):
                raise AssertionError(f"{f} mismatch for {rid}: {err}")
        self.verify_errs[rid] = errs
        return errs

    def sync(self):
        """Wait for every op issued so far on the model's device (what the
        measured engine clock times)."""
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def first_token_logits(self, rid: str, new_inputs):
        """Prefill the new suffix on the restored cache -> first-token logits.

        One-shot convenience path (quickstart / direct use); the serving
        engines instead schedule per-stage ``prefill`` ops through the
        engine core so the suffix contends for stage compute."""
        m = self.model
        live = self._live[rid]
        req: StoredRequest = live["req"]
        n = req.n_tokens
        # grow cache to fit the suffix
        c_new = new_inputs.shape[1]
        cache = grow_cache(m.cfg, live["cache"], n + c_new)
        logits, cache = m.prefill_chunk(self.params, new_inputs, cache, n)
        live["cache"] = cache
        return logits


# ---------------------------------------------------------------------------


def _positions(t0: int, t1: int) -> torch.Tensor:
    """(1, t1 - t0) int32 host positions of a chunk."""
    return torch.arange(t0, t1, dtype=torch.int32)[None]


def _plan_of(live: dict, op: ScheduledOp) -> RequestPlan:
    return live["plans"][op.stage]


def _state_snapshot(cfg, cache: dict) -> dict:
    """Copies of the recurrent state fields: the live cache is updated in
    place by the next chunk, and a snapshot must keep this chunk's state
    (the reference's snapshots are immutable arrays)."""
    out = {}
    for f in ("conv", "lru", "wkv", "shift_tm", "shift_cm"):
        if f in cache:
            out[f] = cache[f].clone()
    return out
