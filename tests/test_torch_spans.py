"""The port's wall-clock spans (``repro_torch.obs.spans``).

* With no telemetry there is no recorder: ``obs.span`` returns the shared
  null context, during a serve too.
* A tiny CPU int8 serve with telemetry records only catalogued names, each
  child inside its parent's interval under a parent the catalog allows,
  each op span with its request id; the recorder is cleared when the run
  ends, by an exception too.
* Spans observe and change nothing: the served tokens equal a
  telemetry-off serve's, and a simulation's snapshot has no ``"spans"``
  key and still equals the reference's.
* Under ``torch.profiler`` each span is a ``record_function`` range of its
  name, and the run's anchor maps the span onto the range: the range
  inside the span's mapped interval within 1 ms, the median start offset
  under 1 ms.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.serving import SimServingEngine as JSimServingEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.config import HARDWARE, IO_BANDWIDTHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import spans as obs_spans  # noqa: E402
from repro_torch.serving import (ChunkStore, RealServingEngine, Request,  # noqa: E402
                                 SimServingEngine)

ENGINE_KW = dict(system="cacheflow", stages=2, chunk_size=16, l_delta=32,
                 max_batch=2, io_channels=1, datapath="fused")
# prefixes 32 (token-wise) and 16 (layer-wise); "c" dedups "a"'s chunks, so
# its loads are HBM hits
REQS = [("a", 0.0, 32), ("b", 0.0, 16), ("c", 0.05, 32)]
TOP = {n for n, spec in obs.SPAN_CATALOG.items() if not spec["parent"]}


@pytest.fixture(scope="module")
def model():
    m = Model(get_config("qwen3-8b").reduced(), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _engine(model, telemetry):
    m, params = model
    store = ChunkStore(chunk_size=8, quant="int8", default_tier="host", device="cpu")
    return RealServingEngine(m, params, kvstore=store, device="cpu",
                             telemetry=telemetry, **ENGINE_KW)


def _serve(model, telemetry, op_order="measured"):
    eng = _engine(model, telemetry)
    reqs = [Request(rid, t, n, 8, decode_len=3) for rid, t, n in REQS]
    rep = eng.serve(reqs, verify=True, op_order=op_order)
    return eng, rep


def test_no_telemetry_no_recorder(model):
    assert obs.span("engine.admit", "r0") is obs.NULL_SPAN
    assert obs_spans._current is None
    eng = _engine(model, False)
    seen = []
    step = eng.executor.decode_step_batch

    def decode_step_batch(rids):
        seen.append(obs.span("engine.decode_step") is obs.NULL_SPAN)
        return step(rids)
    eng.executor.decode_step_batch = decode_step_batch
    rep = eng.serve([Request(rid, t, n, 8, decode_len=3) for rid, t, n in REQS],
                    verify=True)
    assert seen and all(seen)
    assert rep.telemetry is None and obs_spans._current is None
    with obs.span("engine.admit") as sp:
        sp.count = 3                        # settable, and read by no one


@pytest.fixture(scope="module")
def served(model):
    eng, rep = _serve(model, True)
    return eng, rep.telemetry


def test_spans_are_catalogued_and_nested(served):
    _, snap = served
    spans = snap["spans"]["records"]
    assert len(snap["spans"]["anchors"]) == 1
    names = {s[0] for s in spans}
    assert names <= set(obs.SPAN_CATALOG)
    # every layer boundary of a CPU int8 serve through the fused datapath
    # (the device waits of the ring and of measure mode need a card; an HBM
    # hit needs the measured schedule to load "a"'s chunks before "c"'s; a
    # dense model has no MoE FFN)
    assert names >= set(obs.SPAN_CATALOG) - {"datapath.ring_wait",
                                             "datapath.measure_wait",
                                             "engine.restore_load_hit",
                                             "model.moe"}
    for i, (name, t0, t1, parent, rid, count) in enumerate(spans):
        assert t0 <= t1
        allowed = obs.SPAN_CATALOG[name]["parent"]
        if not allowed:
            assert parent == -1, (i, name)
            continue
        assert 0 <= parent < i, (i, name)
        p = spans[parent]
        assert p[0] in allowed, (name, p[0])
        assert p[1] <= t0 and t1 <= p[2], (name, p[0])
    for name, _, _, _, rid, count in spans:
        if name in TOP - {"engine.decode_step"}:
            assert rid in {r for r, _, _ in REQS}, name
        if name in ("engine.restore_compute", "engine.suffix_prefill"):
            assert count > 0
        if name == "engine.decode_step":
            assert rid is None and count >= 1
    # top-level spans never overlap: the host runs one op at a time
    top = sorted((s[1], s[2]) for s in spans if s[3] == -1)
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    # a decode step: one forward and one token read of all its requests
    # (the batched path of an attention stack), a paged write a request
    for i, s in enumerate(spans):
        if s[0] == "engine.decode_step":
            kids = [c for c in spans if c[3] == i]
            for child in ("executor.decode_forward", "executor.token_read"):
                once = [c for c in kids if c[0] == child]
                assert len(once) == 1, child
                assert once[0][4] is None and once[0][5] == s[5], child
            writes = [c for c in kids if c[0] == "executor.paged_write"]
            assert len(writes) == s[5]
            assert len({c[4] for c in writes}) == s[5]
    # the datapath counts the bytes it packed, and a load op those it moved
    pack = sum(s[5] for s in spans if s[0] == "datapath.pack")
    assert pack > 0 and pack == sum(s[5] for s in spans
                                    if s[0] == "datapath.restore_op")


def test_spans_served_tokens_unchanged(model):
    on, rep_on = _serve(model, True, op_order="alternate")
    off, rep_off = _serve(model, False, op_order="alternate")
    assert rep_on.telemetry["spans"]["records"] and rep_off.telemetry is None
    for rid, _, _ in REQS:
        assert on.executor.outputs(rid)["tokens"] == off.executor.outputs(rid)["tokens"]
        assert torch.equal(on.executor.outputs(rid)["first_logits"],
                           off.executor.outputs(rid)["first_logits"])


class Stop(Exception):
    pass


@pytest.mark.parametrize("where", ["hook", "op"])
def test_recorder_cleared_when_a_run_raises(model, where):
    """A hook that ends the call (as the benchmark's window does), or an op
    that raises inside its spans: the spans are closed and the recorder is
    no longer current."""
    class Tel(obs.Telemetry):
        def on_decode_dispatch(self, now, dur, rids):
            if where == "hook":
                raise Stop

    tel = Tel()
    eng = _engine(model, tel)
    step = eng.executor.decode_step_batch

    def decode_step_batch(rids):
        step(rids)
        if where == "op":
            raise Stop
    eng.executor.decode_step_batch = decode_step_batch
    with pytest.raises(Stop):
        eng.serve([Request(rid, t, n, 8, decode_len=3) for rid, t, n in REQS],
                  verify=False)
    assert obs_spans._current is None and not tel.spans._open
    assert tel.spans and all(s is not None for s in tel.spans)
    last = max(range(len(tel.spans)), key=lambda i: tel.spans[i][2])
    assert tel.spans[last][0] == "engine.decode_step"
    kids = [s[0] for s in tel.spans if s[3] == last]
    assert kids[-1] == ("engine.device_wait" if where == "hook"
                        else "executor.token_read")


def test_sim_snapshot_has_no_spans_and_equals_reference():
    cfg = get_config("qwen3-8b")
    reqs = [Request(f"r{i}", 0.2 * i, prefix_len=4096, new_len=128, decode_len=2)
            for i in range(3)]
    kw = dict(io_bandwidth=IO_BANDWIDTHS["10Gbps"], stages=2, max_batch=2,
              telemetry=True)
    snap = SimServingEngine(cfg, HARDWARE["h100"], **kw).run(reqs).telemetry
    from repro.configs import get_config as j_get_config
    from repro.config import HARDWARE as J_HARDWARE
    from repro.serving import Request as JRequest
    jreqs = [JRequest(f"r{i}", 0.2 * i, prefix_len=4096, new_len=128, decode_len=2)
             for i in range(3)]
    j_snap = JSimServingEngine(j_get_config("qwen3-8b"), J_HARDWARE["h100"],
                               **kw).run(jreqs).telemetry
    assert "spans" not in snap and snap == j_snap


def test_spans_are_profiler_ranges_on_the_profilers_clock(model):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass                    # the profiler's first range sets it up
        _, rep = _serve(model, True)
    spans, anchors = rep.telemetry["spans"]["records"], rep.telemetry["spans"]["anchors"]
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in obs.SPAN_CATALOG:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    by_name = {}
    for s in spans:
        by_name.setdefault(s[0], []).append(s)
    assert set(ranges) == set(by_name)
    ms = 1_000_000
    offsets = []
    for name, ss in by_name.items():
        rs = sorted(ranges[name])
        assert len(rs) == len(ss), name
        for s, (r0, r1) in zip(sorted(ss, key=lambda s: s[1]), rs):
            t0, t1 = obs_spans.epoch_ns(anchors, s[1]), obs_spans.epoch_ns(anchors, s[2])
            # a span's stamps enclose its range's (the clock is read before
            # the range opens and after it closes): mapped right to 1 ms
            assert t0 - ms <= r0 and r1 <= t1 + ms, name
            offsets.append(abs(r0 - t0))
    # the range opens a few microseconds after the span's stamp; a garbage
    # collection or a descheduled thread can land between the two on a
    # loaded host, so the start is held at the median
    offsets.sort()
    assert offsets[len(offsets) // 2] < ms
