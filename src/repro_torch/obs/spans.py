"""Wall-clock spans of the port's served path, recorded where the work
happens.

A site is ``with obs.span("engine.decode_step", rid, count):``.  The span
names are declared in ``obs/registry.py``'s :data:`SPAN_CATALOG` (codelint's
``span-catalog`` rule checks every literal).  A :class:`SpanRecorder` lives
on each :class:`~repro_torch.obs.telemetry.Telemetry` (``tel.spans``) and
``EngineCore.run`` makes it the current recorder for the run, so spans are
on exactly when telemetry is.  With no current recorder ``span`` returns
:data:`NULL_SPAN`: no allocation and no call into torch.

A span is the tuple ``(name, t0_ns, t1_ns, parent, rid, count)``: its times
from ``time.perf_counter_ns`` (the clock of ``time.perf_counter``), the
list index of the span it nests in (-1 at the top level), the request id or
None, and one optional count (bytes on the datapath, tokens of compute, the
requests of a decode forward).
A span takes its slot in the list when it opens, so that a child can name
it, and is written there when it closes, an exception included.

While ``torch.profiler`` records, each span also opens a ``record_function``
range of its name, so the spans sit in the device trace.  The profiler's
events carry epoch nanoseconds (``time.time_ns``); each run notes one
``(perf_counter_ns, time_ns)`` pair in ``anchors``, and :func:`epoch_ns` maps
a span time onto the trace's clock.
"""
from __future__ import annotations

import bisect
from time import perf_counter_ns, time_ns
from typing import List, Optional, Tuple


class _NullSpan:
    """The context every site gets with no recorder.  ``count`` may be set
    on it and is never read."""
    __slots__ = ("count",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class SpanRecorder(list):
    """The spans of one telemetry, in the order they opened."""

    def __init__(self):
        super().__init__()
        import torch
        self.anchors: List[Tuple[int, int]] = []
        self._open: List[int] = []          # indices of the spans now open
        self._profiling = torch.autograd._profiler_enabled
        self._range = torch.profiler.record_function

    def anchor(self) -> None:
        self.anchors.append((perf_counter_ns(), time_ns()))


class _Span:
    __slots__ = ("rec", "name", "rid", "count", "i", "parent", "t0", "rf")

    def __init__(self, rec: SpanRecorder, name: str, rid, count):
        self.rec, self.name, self.rid, self.count = rec, name, rid, count

    def __enter__(self):
        rec = self.rec
        self.parent = rec._open[-1] if rec._open else -1
        self.i = len(rec)
        rec.append(None)
        rec._open.append(self.i)
        self.rf = None
        self.t0 = perf_counter_ns()
        if rec._profiling():
            self.rf = rec._range(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = perf_counter_ns()
        rec = self.rec
        rec._open.pop()
        rec[self.i] = (self.name, self.t0, t1, self.parent, self.rid, self.count)
        return False


_current: Optional[SpanRecorder] = None


def span(name: str, rid=None, count=None):
    """The context of one span named ``name`` (a :data:`SPAN_CATALOG` key)
    on the current recorder, or :data:`NULL_SPAN` when there is none."""
    rec = _current
    if rec is None:
        return NULL_SPAN
    return _Span(rec, name, rid, count)


def activate(rec: Optional[SpanRecorder]) -> Optional[SpanRecorder]:
    """Make ``rec`` the current recorder (None: no spans) and note its
    anchor; returns the recorder it replaces."""
    global _current
    prev, _current = _current, rec
    if rec is not None:
        rec.anchor()
    return prev


def epoch_ns(anchors: List[Tuple[int, int]], t_ns: int) -> int:
    """A ``perf_counter_ns`` time on the profiler's clock (epoch ns), by the
    latest anchor noted at or before it."""
    i = max(0, bisect.bisect_right([a for a, _ in anchors], t_ns) - 1)
    perf, epoch = anchors[i]
    return t_ns - perf + epoch
