"""Perfetto timeline export: engine schedules as Chrome trace-event JSON.

A copy of ``repro.obs.timeline``; ``serve --telemetry --timeline-out``
passes the run's ``Telemetry.snapshot()``, whose storage-tier gauges become
counter tracks.

Converts an engine ``ops_log`` (plus, when available, the captured
``ScheduleTrace`` events and a telemetry snapshot) into the Chrome
trace-event format [1] that Perfetto (https://ui.perfetto.dev) and
chrome://tracing load directly:

  * one named track per engine resource (``comp*``, ``io*``, ``decode``),
    duration ("X") slices for every dispatched op,
  * per-request FLOW events stitching RESTORING -> PREFILL -> DECODE
    across tracks (follow a request's arrows through the schedule),
  * ``:aborted`` ops as instant ("i") markers at the abort point,
  * counter ("C") tracks: queue depth and active batch size (derived from
    the trace's admit/finish events), measured per-channel bandwidth at
    each I/O dispatch, and — when a telemetry snapshot rides along —
    storage-tier occupancy bytes (HBM et al.) over time.

Offline mode renders a timeline from ANY captured trace without
re-running the engine, so every golden/replay trace is viewable:

    PYTHONPATH=src python -m repro_torch.obs.timeline trace.json [-o out.json]

[1] https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

US = 1e6    # trace-event timestamps are microseconds

#: op-desc tag -> slice category (colors the tracks by phase in Perfetto)
_TAG_CATS = {"c": "restore-compute", "l": "restore-io", "p": "prefill",
             "pf": "prefetch"}


def _desc_category(resource: str, desc: str) -> str:
    if resource == "decode":
        return "decode"
    tag = desc.rsplit(":", 1)[-1]
    if tag == "pf":
        return _TAG_CATS["pf"]
    return _TAG_CATS.get(tag[:1], "op")


def _resource_order(resource: str) -> Tuple[int, int]:
    """comp* first, then io*, then decode — stable track ordering."""
    for rank, prefix in ((0, "comp"), (1, "io")):
        if resource.startswith(prefix) and resource[len(prefix):].isdigit():
            return rank, int(resource[len(prefix):])
    return (2, 0)


def _desc_rids(resource: str, desc: str) -> List[str]:
    """Request ids an ops_log entry belongs to (decode slices are the
    whole batch, comma-joined)."""
    if resource == "decode":
        return desc.split(",")
    return [desc.rsplit(":", 1)[0]]


def ops_to_chrome(ops_log, *, events: Optional[list] = None,
                  requests: Optional[list] = None,
                  telemetry: Optional[dict] = None) -> dict:
    """Build the Chrome trace-event document from an engine ``ops_log``.

    ``events``/``requests`` are the captured ``ScheduleTrace`` event and
    request dict lists (optional — they add the queue-depth/active counter
    tracks); ``telemetry`` is a ``Telemetry.snapshot()`` dict (optional —
    it adds the storage-occupancy counter tracks)."""
    resources = sorted({r for _, _, r, _ in ops_log}, key=_resource_order)
    tids = {r: i for i, r in enumerate(resources)}
    out: List[dict] = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "cacheflow-engine"}}]
    for r, tid in tids.items():
        out.append({"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                    "args": {"name": r}})
        out.append({"ph": "M", "pid": 0, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": tid}})

    # duration slices + aborted-op instant markers
    per_rid: Dict[str, List[tuple]] = {}
    for t0, t1, resource, desc in ops_log:
        tid = tids[resource]
        if desc.endswith(":aborted"):
            out.append({"ph": "i", "s": "t", "pid": 0, "tid": tid,
                        "ts": t1 * US, "name": desc,
                        "cat": "abort"})
            continue
        out.append({"ph": "X", "pid": 0, "tid": tid, "ts": t0 * US,
                    "dur": (t1 - t0) * US, "name": desc,
                    "cat": _desc_category(resource, desc)})
        for rid in _desc_rids(resource, desc):
            per_rid.setdefault(rid, []).append((t0, tid, resource))

    # per-request flow events: RESTORING -> PREFILL -> DECODE arrows.
    # Each anchor binds to the slice starting at (ts, tid); only the FIRST
    # decode slice per request is stitched (the recurring steps would just
    # repaint the same track).
    for flow_id, rid in enumerate(sorted(per_rid)):
        anchors, seen_decode = [], False
        for t0, tid, resource in sorted(per_rid[rid]):
            if resource == "decode":
                if seen_decode:
                    continue
                seen_decode = True
            anchors.append((t0, tid))
        if len(anchors) < 2:
            continue
        for i, (t0, tid) in enumerate(anchors):
            ph = "s" if i == 0 else ("f" if i == len(anchors) - 1 else "t")
            ev = {"ph": ph, "pid": 0, "tid": tid, "ts": t0 * US,
                  "id": flow_id, "cat": "lifecycle", "name": rid}
            if ph == "f":
                ev["bp"] = "e"      # bind the finish to the enclosing slice
            out.append(ev)

    out += _counter_events(events, requests, tids)
    out += _telemetry_counters(telemetry)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.obs.timeline",
                          "resources": resources}}


def _counter_events(events, requests, tids) -> List[dict]:
    """Queue-depth / active-batch counter tracks from trace events, and
    per-channel measured bandwidth at each I/O dispatch."""
    out: List[dict] = []
    if events is None:
        return out
    edges: List[Tuple[float, int, int]] = []   # (t, d_queued, d_active)
    for r in requests or []:
        edges.append((r.get("arrival", 0.0), +1, 0))
    for e in events:
        kind = e.get("kind") if isinstance(e, dict) else e.kind
        t = e.get("t") if isinstance(e, dict) else e.t
        if kind == "admit":
            edges.append((t, -1, +1))
        elif kind == "finish":
            edges.append((t, 0, -1))
        elif kind == "preempt":
            edges.append((t, 0, -1))
        elif kind == "resume":
            edges.append((t, 0, +1))
        elif kind == "dispatch":
            res = e.get("resource") if isinstance(e, dict) else e.resource
            bw = e.get("bandwidth") if isinstance(e, dict) else e.bandwidth
            if bw and res and res.startswith("io") and res in tids:
                out.append({"ph": "C", "pid": 0, "ts": t * US,
                            "name": f"bandwidth_gbps:{res}",
                            "args": {"gbps": bw / 1e9}})
    queued = active = 0
    for t, dq, da in sorted(edges):
        queued += dq
        active += da
        out.append({"ph": "C", "pid": 0, "ts": t * US, "name": "queue_depth",
                    "args": {"queued": queued}})
        out.append({"ph": "C", "pid": 0, "ts": t * US,
                    "name": "active_requests", "args": {"active": active}})
    return out


def _telemetry_counters(telemetry) -> List[dict]:
    """Storage-occupancy counter tracks from a telemetry snapshot's gauge
    series (``storage.tier_used_bytes{tier=...}`` over engine time)."""
    out: List[dict] = []
    if not telemetry:
        return out
    gauges = telemetry.get("metrics", {}).get("gauges", {})
    for key, g in sorted(gauges.items()):
        if not key.startswith("storage.tier_used_bytes"):
            continue
        tier = key.split("tier=", 1)[-1].rstrip("}")
        for t, v in g.get("series", []):
            out.append({"ph": "C", "pid": 0, "ts": t * US,
                        "name": f"tier_bytes:{tier}", "args": {"bytes": v}})
    return out


def trace_to_chrome(trace, telemetry: Optional[dict] = None) -> dict:
    """Render a captured ``ScheduleTrace`` (any schema version) without
    re-running the engine.  Prefers the captured result's ``ops_log``;
    traces without one (hand-stripped) reconstruct slices from their
    pinned dispatch durations."""
    if trace.result and trace.result.get("ops_log"):
        ops_log = [tuple(e) for e in trace.result["ops_log"]]
    else:
        ops_log = []
        for e in trace.events:
            if e.kind == "dispatch" and e.duration is not None:
                op = e.op or {}
                tag = {"compute": "c", "load": "l", "prefill": "p",
                       "prefetch": "pf"}.get(op.get("kind"), "?")
                unit = "" if tag == "pf" else str(op.get("unit", ""))
                ops_log.append((e.t, e.t + e.duration, e.resource,
                                f"{op.get('request_id')}:{tag}{unit}"))
            elif e.kind == "decode_step" and e.duration is not None:
                ops_log.append((e.t, e.t + e.duration, "decode",
                                ",".join(e.requests or [])))
    events = [e.to_dict() for e in trace.events]
    return ops_to_chrome(ops_log, events=events, requests=trace.requests,
                         telemetry=telemetry)


def result_to_chrome(result, *, events=None, requests=None,
                     telemetry: Optional[dict] = None) -> dict:
    """Render a live ``EngineResult`` (no trace capture needed)."""
    return ops_to_chrome(result.ops_log, events=events, requests=requests,
                         telemetry=telemetry)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.timeline",
        description="Render a captured ScheduleTrace as Chrome trace-event "
                    "JSON (open the output in https://ui.perfetto.dev).")
    ap.add_argument("trace", help="ScheduleTrace JSON (serve --trace-out)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <trace>.timeline.json)")
    args = ap.parse_args(argv)
    from repro_torch.core.trace import ScheduleTrace
    trace = ScheduleTrace.load(args.trace)
    doc = trace_to_chrome(trace)
    out_path = args.out or (args.trace.rsplit(".json", 1)[0]
                            + ".timeline.json")
    with open(out_path, "w") as f:
        # allow_nan=False: the document must be standard JSON — Perfetto's
        # parser (rightly) rejects bare NaN/Infinity tokens
        json.dump(doc, f, indent=1, allow_nan=False)
    n = len(doc["traceEvents"])
    print(f"# timeline ({n} events, {len(trace.requests)} requests) -> "
          f"{out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
