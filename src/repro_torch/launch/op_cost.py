"""Per-device operation, byte and collective counts of an eager step
(counterpart of ``repro.launch.hlo_cost``).

There is no HLO in the port: the reference parses the compiled per-device
HLO text, the port counts the ops a step dispatches.  :func:`analyze` runs
a function under :class:`_Counter`, a ``TorchDispatchMode``:

  * an op with a DTensor among its arguments is handed back to DTensor
    (``NotImplemented``), which runs this rank's LOCAL ops and the
    collectives of its redistributions; the mode sees those, with their
    local shapes, so every count is per device, as the reference's
    post-SPMD module is.  The ops DTensor runs on FakeTensors to infer a
    global output shape are skipped: they are not part of the step;
  * ``dot_flops`` = 2·M·N·K over ``aten.mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``mv`` and ``dot`` (the einsums decompose into them).
    Nothing elementwise is counted, as ``hlo_cost`` counts only ``dot``s;
  * the hand-written kernels run where the mode cannot see inside (CUDA, or
    their ``meta`` route): each wrapper reports its products and its
    operand and result bytes through :func:`note` on both routes, so a step
    on the card and its trace on ``meta`` count the same work, and
    ``kernel_notes`` counts the calls by kernel;
  * collectives come from the ``_c10d_functional`` ops (and ``c10d``'s
    in-place ones, which ``torch.distributed``'s calls dispatch), with the
    group size read from the op's group, by the reference's ring
    accounting (``hlo_cost.py``, ``dryrun.py``'s ``collective_bytes``);
  * ``bytes_accessed`` sums every non-view op's tensor operands and
    results, unfused: it sits above XLA's ``bytes accessed``, which counts
    a fusion's operands and results once;
  * ``temp_bytes`` is the peak, over the step, of the bytes of live
    storages that the step's own local ops allocated, those of its outputs
    left out (XLA's ``temp_size_in_bytes``).  A storage counts as live
    while a Python tensor on it is (views included); one that only autograd
    or C++ keeps is counted as freed.

Eager code runs every repeat, so each counts as it runs: the reference's
while-loop trip counts have no counterpart except where the port runs one
repeat and multiplies it instead (:func:`repeat`: the dry run's gradient
accumulation).  ``while_trip_counts`` holds only those.

Importing this module touches no device; the wrappers' hook costs one
``if`` when no analysis is active.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
ACTIVE = None                  # the analysis in progress (one at a time)

_aten = torch.ops.aten
_DOTS = {_aten.mm.default: 0, _aten.addmm.default: 1, _aten.bmm.default: 0,
         _aten.baddbmm.default: 1, _aten.mv.default: 0, _aten.dot.default: 0}
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default}
# collective op names (without namespace and overload) -> kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}


def ring_bytes(kind: str, r: float, n: int) -> float:
    """Bytes a device moves over links for one collective of result ``r``
    bytes over a group of ``n``: the reference's ring accounting."""
    if kind == "all-gather":
        return r * (n - 1) / max(1, n)
    if kind == "reduce-scatter":
        return r * (n - 1)
    if kind == "all-reduce":
        return 2 * r * (n - 1) / max(1, n)
    if kind == "all-to-all":
        return r * (n - 1) / max(1, n)
    return r


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(func, args) -> int:
    """The group size of a collective: the functional ops name their group
    (or pass its size); the in-place ``c10d`` ops pass the group itself."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = func._opname
    if name.startswith("all_gather_into_tensor"):
        return int(args[1])
    if name.startswith("reduce_scatter_tensor"):
        return int(args[2])
    names = [a for a in args if isinstance(a, str)]
    if names:                         # the group's name comes last (after a reduce op's)
        return _resolve_process_group(names[-1]).size()
    for a in args:
        if isinstance(a, torch.ScriptObject):           # a c10d op's ProcessGroup
            return torch.distributed.ProcessGroup.unbox(a).size()
    return 2                          # hlo_cost's default for an unnamed group


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.bytes_accessed = 0.0
        self.coll = defaultdict(float)
        self.coll_counts = defaultdict(int)
        self.kernel_notes = defaultdict(int)
        self.records: list = []       # (kind, result bytes, group size), each once
        self.trips: dict = {}
        self.mult = 1
        self._live: dict = {}         # storage key -> [python tensors alive on it, bytes]
        self._events: list = []       # (+/-bytes, key) in the order of allocation / free

    # --- the mode ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if (any(issubclass(t, FakeTensor) for t in types)
                or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)):
            return out                # DTensor's shape inference, not the step
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        m = self.mult
        if func in _DOTS:
            a = args[_DOTS[func]]
            o = out
            self.dot_flops += 2.0 * o.numel() * a.shape[-1] * m
        kind = _COLLECTIVES.get(func._opname) if func.namespace in (
            "_c10d_functional", "_c10d_functional_autograd", "c10d") else None
        if kind is not None:
            r = _nbytes(out if func.namespace != "c10d" else args[0])
            n = _group_size(func, args)
            self.coll[kind] += ring_bytes(kind, r, n) * m
            self.coll_counts[kind] += 1
            self.records.append((kind, r, n))
        if func.is_view:
            self._track(out, view=True)
            return
        if func not in _NO_BYTES:
            self.bytes_accessed += (_nbytes(args) + _nbytes(kwargs) + _nbytes(out)) * m
        if not func._schema.is_mutable:
            self._track(out, view=False)

    # --- live storages ----------------------------------------------------
    def _track(self, out, view: bool):
        for t in _tensors(out):
            try:
                key = t.untyped_storage()._cdata
            except (RuntimeError, NotImplementedError):
                continue
            entry = self._live.get(key)
            if entry is None:
                if view:
                    continue          # a view of a storage the step did not allocate
                entry = self._live[key] = [0, t.untyped_storage().nbytes()]
                self._events.append((entry[1], key))
            entry[0] += 1
            weakref.finalize(t, self._drop, key)

    def _drop(self, key):
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            del self._live[key]
            self._events.append((-entry[1], key))

    def temp_bytes(self, outputs) -> int:
        keep = set()
        for t in _tensors(outputs):
            try:
                keep.add(t.untyped_storage()._cdata)
            except (RuntimeError, NotImplementedError):
                pass
        live = peak = 0
        for delta, key in self._events:
            if key in keep:
                continue
            live += delta
            peak = max(peak, live)
        return peak


def note(name: str, flops: float, nbytes: float):
    """A hand-written kernel's call: ``flops`` (2 per multiply-add of its
    products, the wrapper's ``_products``) and ``nbytes`` (its operands and
    results) added to the active analysis.  Wrappers call it only when
    ``ACTIVE`` is set."""
    a = ACTIVE
    a.dot_flops += float(flops) * a.mult
    a.bytes_accessed += float(nbytes) * a.mult
    a.kernel_notes[name] += 1


@contextlib.contextmanager
def repeat(name: str, n: int):
    """Count the body as ``n`` runs of it (recorded in
    ``while_trip_counts[name]``); outside an analysis, just the body."""
    a = ACTIVE
    if a is None:
        yield
        return
    outer = a.mult
    a.mult = outer * n
    a.trips[name] = n
    try:
        yield
    finally:
        a.mult = outer


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the counting mode.  Returns
    (``fn``'s result, the counts): ``dot_flops``, ``collective_bytes`` and
    ``collective_counts`` by kind, ``collective_total_bytes``,
    ``while_trip_counts``, ``bytes_accessed``, ``temp_bytes``,
    ``kernel_notes`` (calls by kernel) and ``records``: (kind, result
    bytes, group size) of every collective, each once."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("op_cost.analyze: an analysis is already running")
    counter = _Counter()
    ACTIVE = counter
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        ACTIVE = None
    coll = {k: counter.coll[k] for k in KINDS if k in counter.coll}
    return out, {
        "dot_flops": counter.dot_flops,
        "collective_bytes": coll,
        "collective_total_bytes": sum(coll.values()),
        "collective_counts": {k: counter.coll_counts[k] for k in KINDS
                              if k in counter.coll_counts},
        "while_trip_counts": dict(counter.trips),
        "bytes_accessed": counter.bytes_accessed,
        "temp_bytes": counter.temp_bytes(out),
        "kernel_notes": dict(counter.kernel_notes),
        "records": counter.records,
    }
