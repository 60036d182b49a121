"""The traced run's instruments, all from the benchmark's side of the API.

* ``Spy`` wraps the hand-written kernels' wrappers as the program calls
  them (``flash_prefill`` and ``flash_decode`` in ``models.attention``,
  ``kv_restore_scatter`` in ``core.datapath``) and records each launch's
  shapes; ``bench.flops`` turns them into operations and bytes.
* ``ranges`` puts ``record_function`` ranges around the engine backend's
  calls into each layer (restoration compute and loads, the suffix
  prefill, decode steps): the host spans that label the device's idle gaps.
* ``read`` reduces the profiler's raw events: the union of the device's
  kernel and copy intervals (overlaps counted once), device time by kernel
  name, and the longest idle gaps with the host range they fell in.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List

from bench import flops, stats

HOST_RANGES = {"compute_secs": "bench.restore_compute", "io_secs": "bench.restore_load",
               "io_hit_secs": "bench.restore_load_hit",
               "prefill_secs": "bench.suffix_prefill", "decode_secs": "bench.decode_step",
               "admit": "bench.admit", "restore_done": "bench.restore_done"}
# a kernel's device time: the trace's kernels whose names hold its name
KERNELS = ("flash_prefill", "flash_decode", "kv_restore")


class Spy:
    """Launch shapes of the hand-written kernels on the serve path, as
    called."""

    def __init__(self):
        self.launches: Dict[str, List[tuple]] = defaultdict(list)
        self.active = True          # cleared when the profiler stops

    def counts(self, name: str):
        """(flops, bytes) of every recorded launch of kernel ``name``."""
        return [getattr(flops, name)(*args) for args in self.launches[name]]

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.core import datapath
        from repro_torch.models import attention

        prefill, decode = attention.flash_prefill, attention.flash_decode
        restore = datapath.kv_restore_scatter
        spy = self

        def flash_prefill(q, k, v, kpos, q_offset, **kw):
            b, sq, hq, dh = q.shape
            if spy.active:
                spy.launches["flash_prefill"].append(
                    (b, sq, hq, k.shape[2], dh, int(q_offset), q.element_size()))
            return prefill(q, k, v, kpos, q_offset, **kw)

        def flash_decode(q, k, v, kpos, q_pos, **kw):
            b, hq, dh = q.shape
            if spy.active:
                spy.launches["flash_decode"].append(
                    (b, hq, k.shape[2], dh, int(q_pos), q.element_size()))
            return decode(q, k, v, kpos, q_pos, **kw)

        def kv_restore_scatter(caches, staged, scales=None, *, t0, slot_lo=0,
                               n_slots=None, chunk_size):
            if spy.active:
                a, s, _ = caches[0].shape
                spy.launches["kv_restore"].append(
                    (a - slot_lo if n_slots is None else n_slots,
                     min(staged[0].shape[1], s - t0), tuple(c.shape[2] for c in caches),
                     staged[0].element_size(), caches[0].element_size(), chunk_size,
                     scales is not None))
            return restore(caches, staged, scales, t0=t0, slot_lo=slot_lo,
                           n_slots=n_slots, chunk_size=chunk_size)

        attention.flash_prefill, attention.flash_decode = flash_prefill, flash_decode
        datapath.kv_restore_scatter = kv_restore_scatter
        try:
            yield self
        finally:
            attention.flash_prefill, attention.flash_decode = prefill, decode
            datapath.kv_restore_scatter = restore


@contextlib.contextmanager
def ranges():
    """record_function ranges around the backend's calls."""
    from torch.profiler import record_function

    from repro_torch.core.engine_core import RealBackend

    saved = {m: getattr(RealBackend, m) for m in HOST_RANGES}

    def wrap(fn, label):
        def inner(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return inner

    for m, label in HOST_RANGES.items():
        setattr(RealBackend, m, wrap(saved[m], label))
    try:
        yield
    finally:
        for m, fn in saved.items():
            setattr(RealBackend, m, fn)


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def read(prof, window_s: float, top: int = 10) -> dict:
    """Device intervals, busy and idle, kernel device time, and the
    breakdown, from the profiler's raw events."""
    dev, host_ranges = [], []
    for e in prof.profiler.kineto_results.events():
        if _is_device(e):
            if e.duration_ns() > 0 and not e.is_user_annotation():
                dev.append(e)
        elif e.name().startswith("bench."):
            host_ranges.append((e.start_ns(), e.end_ns(), e.name()))
    intervals = [(e.start_ns(), e.end_ns()) for e in dev]
    busy_ns = stats.union_length(intervals)
    by_name: Dict[str, float] = defaultdict(float)
    kernel_s: Dict[str, float] = defaultdict(float)
    for e in dev:
        name = e.name()
        by_name[name[:80]] += e.duration_ns() / 1e9
        for k in KERNELS:
            if k in name:
                kernel_s[k] += e.duration_ns() / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    if intervals:
        lo = min(a for a, _ in intervals)
        hi = max(b for _, b in intervals)
        host_ranges.sort()
        hstarts = [a for a, _, _ in host_ranges]
        for a, b in stats.idle_gaps(intervals, lo, hi)[:top]:
            mid = (a + b) / 2
            i = bisect.bisect_right(hstarts, mid) - 1
            label = "engine loop"
            if i >= 0 and mid <= host_ranges[i][1]:
                label = host_ranges[i][2]
            gaps.append([label, (b - a) / 1e9])
    return {"busy_s": busy_ns / 1e9, "window_s": window_s,
            "device_s": sum(e.duration_ns() for e in dev) / 1e9,
            "kernel_s": dict(kernel_s),
            "device_ops": [[n, s] for n, s in device_ops], "idle_gaps": gaps,
            "n_device_events": len(dev)}
