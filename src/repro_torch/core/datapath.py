"""The fused restoration data path: per-channel CUDA copy streams feeding
one dequant-scatter kernel launch per load op.

Counterpart of ``repro.core.datapath``.  The engine core schedules
restoration as ``(layer-span, token-range)`` I/O units over
``io_channels``; this module executes them:

  * :class:`TransferStream` — one host→device staging queue per channel:
    a ``torch.cuda.Stream`` of its own.  ``put`` copies the op's pinned
    staging buffers with ``non_blocking=True`` on that stream, records an
    event after the copy, and makes the compute stream WAIT on the event
    before anything there reads the buffers (the kv_restore launch).
    Only when ``depth`` puts are in flight does it block, on the oldest
    event: with depth 2, op k+1's copy runs while op k's scatter consumes
    its buffer (double buffering), and staging memory stays bounded.
    ``record_stream`` tells the caching allocator that the compute stream
    uses the staged device buffers, so their memory is not reused early.
  * :class:`RestoreDatapath` — one load op's data movement.  The op's
    chunks (in *stored* encoding, via ``ChunkStore.fetch_range_packed``)
    are grouped into contiguous same-residency runs; each transfer run is
    packed into ONE multi-chunk pinned staging buffer per field (int8 bytes
    + per-chunk scales cross the wire — half the bf16 bytes), staged
    through the channel's stream, and scattered into the live cache by ONE
    fused :func:`~repro_torch.kernels.kv_restore.kv_restore_scatter` launch.
    Runs already HBM-resident are gathered device-to-device from the pool
    views and go through the same kernel as a raw copy.  Each transferred
    chunk then lands its pool block via ``ChunkStore.promote_staged`` —
    built from the bytes already on device, so nothing crosses the wire
    twice: an int8 run's blocks come from one ``kv_dequantize`` launch
    over the run.

On the CPU (tests) there are no streams: a put is a plain copy.

In measured mode (``measure=True``, i.e. ``RealBackend`` without a
duration model) each op waits for the device and the wall seconds + wire
bytes are attributed to the op's channel — ``RealBackend.io_secs`` charges
the engine clock with the measured transfer time and per-channel bandwidth
becomes an observable.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.kernels.kv_quant import kv_dequantize
from repro_torch.kernels.kv_restore import kv_restore_scatter
from repro_torch.models.model import resolve_device

ATTN_FIELDS = ("k", "v", "ckv")


class TransferStream:
    """One host→device staging queue — an engine I/O channel made real."""

    def __init__(self, device="cuda", *, depth: int = 2):
        self.device = resolve_device(device)
        self.depth = max(1, int(depth))
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        # (copy-done event, host buffers kept alive until the copy ran)
        self._inflight: deque = deque()
        self.puts = 0                  # staged host→device copies issued
        self.bytes_staged = 0          # bytes handed to the copy engine
        self.secs = 0.0                # measured wall secs (measure mode)
        self.bytes_moved = 0           # wire bytes behind those secs

    def put(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Stage one op's packed buffers onto this stream's device.
        Asynchronous on CUDA: the consumer (current) stream waits on the
        copy's event; the host blocks only on the oldest in-flight put
        beyond ``depth``."""
        while len(self._inflight) >= self.depth:
            self._inflight.popleft()[0].synchronize()
        self.puts += 1
        self.bytes_staged += sum(v.numel() * v.element_size()
                                 for v in host.values())
        if self.stream is None:
            return {k: v.clone() for k, v in host.items()}
        consumer = torch.cuda.current_stream(self.device)
        # the device buffers are allocated on the copy stream; the
        # record_stream below keeps the allocator from reusing them while
        # the consumer's kernels may still read them
        with torch.cuda.stream(self.stream):
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        consumer.wait_event(done)
        for v in dev.values():
            v.record_stream(consumer)
        self._inflight.append((done, host))
        return dev

    def note(self, secs: float, nbytes: int):
        self.secs += secs
        self.bytes_moved += nbytes

    def bandwidth(self) -> Optional[float]:
        """Measured bytes/sec over everything attributed to this channel
        (None until the first measured transfer)."""
        return self.bytes_moved / self.secs if self.secs > 0 else None


def _split_runs(packed) -> List[list]:
    """Group an op's chunks into maximal contiguous runs of equal
    residency (resident pool views vs. bytes that must cross the wire) —
    one scatter per run keeps the kernel's token range contiguous."""
    runs: List[list] = []
    prev_cat, prev_c1 = None, None
    for item in packed:
        c0, _c1, form = item[0], item[1], item[2]
        cat = "hbm" if form == "hbm" else "xfer"
        if runs and cat == prev_cat and c0 == prev_c1:
            runs[-1].append(item)
        else:
            runs.append([item])
        prev_cat, prev_c1 = cat, item[1]
    return runs


class RestoreDatapath:
    """Per-channel double-buffered fetch→dequant→scatter pipeline."""

    def __init__(self, streams: Optional[Sequence[TransferStream]] = None,
                 *, depth: int = 2, measure: bool = False, device="cuda"):
        self.streams = list(streams) if streams else [TransferStream(
            device, depth=depth)]
        self.measure = measure
        self.kernel_launches = 0       # fused dequant-scatter launches
        self.resident_copies = 0       # device-to-device run scatters
        self.runs = 0
        self.ops = 0
        self.last_op_dispatches = 0    # copy dispatches of the latest op
        self._last_secs: Optional[float] = None

    @classmethod
    def for_channels(cls, io_channels: Optional[int] = None, *,
                     device="cuda", depth: int = 2):
        """One stream per engine I/O channel, all on the one device: each
        channel gets a copy queue of its own."""
        n = max(1, io_channels or 1)
        return cls([TransferStream(device, depth=depth) for _ in range(n)])

    def stream_for(self, channel: int) -> TransferStream:
        return self.streams[channel % len(self.streams)]

    def bandwidths(self) -> List[Optional[float]]:
        return [s.bandwidth() for s in self.streams]

    def pop_measured_secs(self) -> Optional[float]:
        secs, self._last_secs = self._last_secs, None
        return secs

    # ------------------------------------------------------------------
    def restore_op(self, cache: dict, packed, *, store, slot_span,
                   channel: int = 0) -> dict:
        """Execute one load op's data movement into the live ``cache``
        (updated in place and returned).  ``packed`` is the op's
        ``fetch_range_packed`` result; ``slot_span`` the contiguous
        attention-slot range the op's layer span owns."""
        fields = [f for f in ATTN_FIELDS if f in cache]
        s_lo, s_hi = slot_span
        cs = store.chunk_size
        stream = self.stream_for(channel)
        a = cache["kpos"].shape[0]
        s = cache[fields[0]].shape[2]
        assert cache[fields[0]].shape[1] == 1, "datapath assumes B == 1"
        dispatches = 0
        moved = 0
        t_begin = time.perf_counter() if self.measure else 0.0

        for run in _split_runs(packed):
            r0, r1 = run[0][0], run[-1][1]
            form = run[0][2]
            if form == "hbm":
                staged, kpos_dev = self._gather_resident(run, fields)
                scales_dev = None
                self.resident_copies += 1
            else:
                host, nbytes = self._pack_host(run, fields, cs, a,
                                               pin=stream.stream is not None)
                dev = stream.put(host)
                dispatches += 1                    # one staged copy per run
                moved += nbytes
                staged = {f: dev[f] for f in fields}
                kpos_dev = dev["kpos"]
                scales_dev = ({f: dev[f + "__s"] for f in fields}
                              if form == "int8" else None)
                self.kernel_launches += 1

            # one fused (dequantizing) scatter per run, all fields in the
            # launch; resident runs ride the same kernel as a raw copy.
            # The views alias the live cache: the kernel writes in place.
            views = [cache[f].view(a, s, -1) for f in fields]
            kv_restore_scatter(
                views, [staged[f] for f in fields],
                None if scales_dev is None else [scales_dev[f]
                                                 for f in fields],
                t0=r0, slot_lo=s_lo, n_slots=s_hi - s_lo, chunk_size=cs)
            dispatches += 1
            # one kpos update per RUN, not per chunk x layer x field
            cache["kpos"][s_lo:s_hi, r0:r1] = kpos_dev[s_lo:s_hi]
            dispatches += 1

            if form != "hbm":
                self._promote_run(run, fields, cache, staged, scales_dev,
                                  kpos_dev, store)
            self.runs += 1

        self.ops += 1
        self.last_op_dispatches = dispatches
        if self.measure:
            if cache["kpos"].is_cuda:
                torch.cuda.synchronize(cache["kpos"].device)
            secs = time.perf_counter() - t_begin
            stream.note(secs, moved)
            self._last_secs = secs
        return cache

    # ------------------------------------------------------------------
    @staticmethod
    def _gather_resident(run, fields):
        """Concatenate a resident run's pool views into (A, T, C) staging
        shapes — device-to-device, nothing crosses the wire."""
        staged = {}
        for f in fields:
            cat = torch.cat([item[3][f] for item in run], dim=2)
            staged[f] = cat.reshape(cat.shape[0], cat.shape[2], -1)
        kpos = torch.cat([item[3]["kpos"] for item in run], dim=1)
        return staged, kpos

    @staticmethod
    def _pack_host(run, fields, cs, a, *, pin: bool):
        """Pack a transfer run's stored chunk payloads into one (pinned)
        staging buffer per field: (A, n_chunks·cs, C) with zero-padded
        tails, plus per-chunk per-channel scales (n_chunks, C) on the int8
        path and the run's kpos rows.  Returns (host dict, wire bytes)."""
        quant = run[0][2] == "int8"

        def buf(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)

        kp = [item[3]["kpos"] for item in run]
        host = {"kpos": buf((a, sum(k.shape[1] for k in kp)), torch.int32)}
        torch.cat(kp, dim=1, out=host["kpos"])
        nbytes = host["kpos"].numel() * 4
        for f in fields:
            first = run[0][3][f]
            arr0 = first["q"] if quant else first
            assert arr0.shape[1] == 1, "datapath assumes B == 1"
            c = arr0[0, 0, 0].numel()
            out = buf((a, len(run) * cs, c), arr0.dtype)
            scl = []
            for idx, (c0, c1, _form, pay, _key) in enumerate(run):
                rep = pay[f]
                arr = rep["q"] if quant else rep
                out[:, idx * cs:idx * cs + (c1 - c0)] = arr.reshape(a, c1 - c0, c)
                nbytes += arr.numel() * arr.element_size()
                if quant:
                    sc = rep["scales"]
                    scl.append(sc.repeat(c // sc.shape[0]))
                    nbytes += sc.numel() * 4
            host[f] = out
            if quant:
                host[f + "__s"] = buf((len(run), c), torch.float32)
                torch.stack(scl, out=host[f + "__s"])
        return host, nbytes

    @staticmethod
    def _promote_run(run, fields, cache, staged, scales_dev, kpos_dev,
                     store):
        """Land each transferred chunk's pool block from the staged device
        bytes — the store's HBM promote then consumes these instead of a
        second host→device copy.  An int8 run is dequantized on device by
        ONE kv_dequantize launch over the run's rows of every field (the
        staging columns taken as strided views, per-chunk scales, the
        scatter's math bit for bit), which writes each chunk as the
        contiguous block the pool copies; each chunk's payload is that
        block, trimmed to the chunk's tokens."""
        r0, r1 = run[0][0], run[-1][1]
        a = cache["kpos"].shape[0]
        chunks = None
        if scales_dev is not None:
            chunks = kv_dequantize([staged[f][:, :r1 - r0] for f in fields],
                                   [scales_dev[f] for f in fields],
                                   dtype=cache[fields[0]].dtype,
                                   chunk_size=store.chunk_size)
        for idx, (c0, c1, _form, _pay, key) in enumerate(run):
            off, n = c0 - r0, c1 - c0
            dev = {"kpos": kpos_dev[:, off:off + n]}
            for i, f in enumerate(fields):
                sl = (staged[f][:, off:off + n] if chunks is None
                      else chunks[i][idx])
                dev[f] = sl.reshape((a, 1, n) + cache[f].shape[3:])
            store.promote_staged(key, dev)
