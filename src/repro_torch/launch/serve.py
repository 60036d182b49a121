"""End-to-end serving entry point of the PyTorch port (counterpart of
``repro.launch.serve``).

Simulation at paper scale (default; never touches a device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --workload swe_bench --requests 64 --system cacheflow --bandwidth 10Gbps

Real execution: restoration is served from the MATERIALIZED chunk-granular
KV store (content-addressed dedup across hbm/host/disk tiers; see DESIGN.md
§10) — ``--kv-quant int8`` stores sub-HBM tiers per-channel quantized,
``--store-dir`` materializes the disk tier as .npz files, ``--evict`` drops
(instead of parks) preempted caches and restarts them from the store.  On
the default ``--device cuda`` the named config runs at FULL width in bf16
(the attention kernels take head_dim 64/128/256 in bf16, which
``.reduced()`` is not) and is refused before anything is allocated when its
bf16 weights exceed the card's free memory; ``--device cpu`` runs
``.reduced()`` in f32, as the reference does.  Both modes take every arch
of the registry:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --real \
      --requests 4 --system cacheflow --kv-quant int8
  PYTHONPATH=src python -m repro_torch.launch.serve --real --device cpu \
      --requests 2

Schedule capture & replay (see repro_torch/core/trace.py): ``--trace-out
t.json`` records the restoration schedule of any run; ``--replay t.json``
re-executes a captured schedule decision-for-decision with pinned durations
— analytically by default (bit-identical EngineResult), or on the device
with ``--real`` (every dispatched op runs through a RestorationExecutor and
each restored cache is verified against full-prefill ground truth under the
captured interleaving).  Traces are one JSON contract with the reference:
either package replays the other's.  On-device replay needs a trace whose
geometry fits the model built on that device — capture it with ``--real
--trace-out`` on the same device.

Correctness tooling (see DESIGN.md §14): ``--sanitize`` (or
``CACHEFLOW_SANITIZE=1``) runs the engine under the runtime invariant
sanitizer and prints its counters in the report.  Captured traces lint
offline with
  PYTHONPATH=src python -m repro_torch.analysis.lint_trace t.json
and the port's static lint pass runs with
  PYTHONPATH=src python -m repro_torch.analysis.codelint

Observability (see DESIGN.md §15): ``--telemetry`` (or
``CACHEFLOW_TELEMETRY=1``) collects the engine-wide metrics registry
(queue depth, batch sizes, gate outcomes, per-channel GB/s, tier
occupancy, per-request phase timestamps) into the report, and in real
mode the wall-clock spans of each layer boundary (``repro_torch.obs``'s
``SPAN_CATALOG``); ``--metrics-out m.json`` writes the snapshot to a file
and ``--timeline-out t.json`` exports a Chrome trace-event timeline loadable
in https://ui.perfetto.dev.  Any captured trace renders offline with
  PYTHONPATH=src python -m repro_torch.obs.timeline t.json
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.config import HARDWARE, IO_BANDWIDTHS
from repro_torch.configs import get_config
from repro_torch.core.baselines import BASELINES
from repro_torch.core.trace import ScheduleTrace, TraceRecorder, replay_trace
from repro_torch.serving import (ChunkStore, RealServingEngine, Request,
                                 SimServingEngine, TieredKVStore, generate)
from repro_torch.serving.metrics import dumps_report
from repro_torch.serving.workloads import WORKLOADS


def _real_config(arch: str, device):
    """(cfg, device) of ``--real``: the named config at full width on a card
    (the attention kernels take head_dim 64/128/256 in bf16, which
    ``.reduced()`` is not), ``.reduced()`` on the CPU as in the reference.
    On a card, exits for a config whose bf16 weights exceed the card's free
    memory, before anything is allocated.  A CUDA device without a card
    raises."""
    from repro_torch.models.model import resolve_device
    cfg = get_config(arch)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return cfg.reduced(), dev
    import torch
    weights = 2 * cfg.param_counts()["total"]
    free, _total = torch.cuda.mem_get_info(dev)
    if weights > free:
        raise SystemExit(
            f"--real --arch {arch}: its bf16 weights take {weights} bytes "
            f"({weights / 1e9:.1f} GB), more than the {free} bytes free on "
            f"{torch.cuda.get_device_name(dev)}; it is not served at full "
            f"width on one card")
    return cfg, dev


def _build_model(cfg, dev):
    """(model, params): bf16 on a card, f32 on the CPU; random weights from
    seed 0."""
    import torch

    from repro_torch.models import Model
    if dev.type == "cuda":
        model = Model(cfg, param_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16, device=dev)
    else:
        model = Model(cfg, device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(0))


def _save_trace(rec: TraceRecorder, path: str, arch: str = None):
    if arch is not None:
        rec.trace.meta["arch"] = arch   # replay sanity check (--real)
    rec.trace.save(path)
    # stderr: stdout carries the JSON report (`serve ... > report.json`)
    print(f"# schedule trace ({len(rec.trace.events)} events) -> {path}",
          file=sys.stderr)


def _save_timeline(trace: ScheduleTrace, path: str, telemetry=None):
    """Export the run's Perfetto timeline from its captured trace."""
    from repro_torch.obs.timeline import trace_to_chrome
    doc = trace_to_chrome(trace, telemetry=telemetry)
    with open(path, "w") as f:
        f.write(dumps_report(doc))
    print(f"# perfetto timeline ({len(doc['traceEvents'])} events) -> "
          f"{path} (open in https://ui.perfetto.dev)", file=sys.stderr)


def _save_metrics(telemetry: dict, path: str):
    with open(path, "w") as f:
        f.write(dumps_report(telemetry))
    print(f"# telemetry snapshot -> {path}", file=sys.stderr)


def _replay(args) -> None:
    trace = ScheduleTrace.load(args.replay)
    if not trace.requests:
        raise SystemExit(f"--replay: trace {args.replay} contains no requests")
    recorder = TraceRecorder() if args.trace_out else None
    if args.real:
        # Rebuild the model, re-prefill every captured request so the
        # executor holds its ground truth, then execute the captured
        # schedule op-for-op with verification.
        import torch

        from repro_torch.core.executor import RestorationExecutor
        t_arch = trace.meta.get("arch")
        if t_arch is not None and t_arch != args.arch:
            raise SystemExit(
                f"--replay --real: trace was captured on arch '{t_arch}' "
                f"but --arch is '{args.arch}'; pass --arch {t_arch}")
        cfg, dev = _real_config(args.arch, args.device)
        # On-device replay needs a trace captured on this device's model
        # geometry (e.g. from `--real --trace-out`): a paper-scale sim trace
        # references layers this model does not have and prefixes a prefill
        # cannot reproduce in reasonable time, and a trace of the reduced
        # model restores only some of the full-width model's layers.
        max_layer = max(p["layer_hi"] for r in trace.requests
                        for p in r["plans"])
        max_tokens = max(r["n_tokens"] for r in trace.requests)
        if max_layer != cfg.num_layers or max_tokens > 4096:
            raise SystemExit(
                f"--replay --real: trace geometry (layers {max_layer}, "
                f"prefix<= {max_tokens} tokens) does not fit the "
                f"'{args.arch}' model on {dev} ({cfg.num_layers} "
                f"layers, prefix<= 4096); capture the trace with `--real "
                f"--trace-out` on that device instead")
        chunks = {p["chunk_size"] for r in trace.requests for p in r["plans"]}
        if len(chunks) > 1:
            raise SystemExit(
                f"--replay --real: heterogeneous chunk sizes {sorted(chunks)} "
                f"in trace; one executor serves one chunk granularity")
        model, params = _build_model(cfg, dev)
        ex = RestorationExecutor(model, params, chunk_size=chunks.pop(),
                                 stages=trace.meta["stages"])
        # one host generator for every draw: distinct ground truth per rid
        gen = torch.Generator().manual_seed(args.seed)

        def draw(n):
            """(1, n) token ids, or (1, n, D) N(0, 1) embeddings."""
            if cfg.input_mode != "tokens":
                return torch.randn((1, n, cfg.d_model), generator=gen)
            return torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                                 dtype=torch.int32)
        for r in trace.requests:
            ex.remember(r["request_id"], draw(r["n_tokens"]))
            # lifecycle traces (schema v2) also re-execute the captured
            # suffix prefill + decode steps on device
            new_len = r.get("new_len", 0)
            decode_len = r.get("decode_len", 0)
            if new_len > 0 or decode_len > 0:
                ex.set_suffix(r["request_id"],
                              draw(new_len) if new_len else None,
                              decode_len=decode_len)
        res = replay_trace(trace, ex, verify=True, trace_out=recorder)
        mode = "replay-real"
    else:
        res = replay_trace(trace, trace_out=recorder)
        captured = trace.captured_result()
        if captured is not None and res != captured:
            raise SystemExit(
                "--replay: analytic replay diverged from the captured "
                "EngineResult (trace edited or engine behavior changed)")
        mode = "replay-sim"
    if recorder is not None:
        # propagate the source capture's arch tag so a re-captured trace
        # keeps the --real arch sanity check armed
        _save_trace(recorder, args.trace_out, arch=trace.meta.get("arch"))
    if args.timeline_out:
        _save_timeline(recorder.trace if recorder is not None else trace,
                       args.timeline_out)
    print(dumps_report({
        "mode": mode, "trace": args.replay,
        "requests": len(trace.requests),
        "dispatches": len(trace.dispatches()),
        "prefills": len(trace.prefills()),
        "decode_steps": len(trace.decode_steps()),
        "makespan": res.makespan,
        "compute_busy": round(res.compute_busy, 3),
        "io_busy": round(res.io_busy, 3),
        "decode_busy": round(res.decode_busy, 3)}, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--workload", default="swe_bench", choices=list(WORKLOADS))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--system", default="cacheflow", choices=list(BASELINES))
    ap.add_argument("--bandwidth", default="10Gbps", choices=list(IO_BANDWIDTHS))
    ap.add_argument("--hardware", default="h100", choices=list(HARDWARE),
                    help="hardware profile the simulation prices "
                         "(default: the H100 the port runs on)")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--max-batch", "--max-active", dest="max_batch",
                    type=int, default=8,
                    help="continuous-batching admission cap (engine-core "
                         "max_active); 0 = unlimited")
    ap.add_argument("--io-channels", type=int, default=1)
    ap.add_argument("--decode-len", type=int, default=-1,
                    help="output tokens per request (lifecycle decode); "
                         "-1 keeps the workload-drawn lengths (sim) or "
                         "uses 8 (real)")
    ap.add_argument("--preempt", default="none",
                    choices=["none", "priority", "deadline"],
                    help="admission-pressure policy: suspend the least-"
                         "beneficial in-flight restoration for a more "
                         "urgent arrival (resumes on a freed slot)")
    ap.add_argument("--admission", default="continuous",
                    choices=["continuous", "gang"],
                    help="'continuous' streams arrivals into freed decode "
                         "slots mid-flight (restoration overlaps the live "
                         "decode batch); 'gang' is the run-to-completion "
                         "baseline — the next batch is admitted only when "
                         "the whole current batch retires")
    ap.add_argument("--prefetch", action="store_true",
                    help="promote queued requests' KV up a storage tier on "
                         "idle channel time (the admission queue is a known "
                         "lookahead window), so admission-time restoration "
                         "starts from the faster tier")
    ap.add_argument("--burst-size", type=int, default=3,
                    help="bursty_priority workload: urgent requests per burst")
    ap.add_argument("--burst-every", type=float, default=4.0,
                    help="bursty_priority workload: seconds between bursts")
    ap.add_argument("--kv-tier", default="host",
                    choices=["hbm", "host", "remote"],
                    help="tier returning prefixes start in: 'hbm' is "
                         "device-resident (restoration transfers are "
                         "skipped entirely as dedup/residency hits), "
                         "'host' models warm DRAM reuse, and 'remote' the "
                         "cold disaggregated store (the real-mode chunk "
                         "store maps it to its disk tier), where "
                         "restoration dominates and admission pressure "
                         "(and preemption) is real")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="per-channel int8 compression of sub-HBM tiers "
                         "(kernels/kv_quant): real mode stores quantized "
                         "chunk bytes and dequantizes on promotion; sim "
                         "mode halves stored bytes / doubles effective "
                         "transfer bandwidth")
    ap.add_argument("--store-dir", metavar="DIR",
                    help="real mode: materialize the chunk store's bottom "
                         "tier as .npz files under DIR (in-memory blobs "
                         "when omitted)")
    ap.add_argument("--datapath", default="fused",
                    choices=["fused", "legacy"],
                    help="real mode restoration data path: 'fused' moves "
                         "each load op's chunks as ONE packed (int8-"
                         "quantized when --kv-quant int8) staging buffer "
                         "through a per-channel double-buffered transfer "
                         "stream and scatters with a single fused dequant "
                         "kernel launch (core/datapath.py + "
                         "kernels/kv_restore); 'legacy' keeps the "
                         "per-chunk/per-layer/per-field copy baseline")
    ap.add_argument("--evict", action="store_true",
                    help="eviction-mode preemption: drop the victim's "
                         "partially-restored cache (instead of parking "
                         "it) and restart restoration from the KV store "
                         "on re-admission — for when host memory is tight")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sanitize", action="store_true",
                    help="run the engine under the runtime sanitizer "
                         "(repro_torch.analysis.sanitizer): every "
                         "scheduling event is checked against the engine's "
                         "concurrency invariants and the report prints "
                         "the sanitizer counters; equivalent to "
                         "CACHEFLOW_SANITIZE=1")
    ap.add_argument("--telemetry", action="store_true",
                    help="collect the engine-wide metrics registry "
                         "(repro_torch.obs): queue depth, admitted/decode batch "
                         "sizes, benefit-gate outcomes, preempt/abort "
                         "counts, per-channel busy and measured GB/s, "
                         "storage-tier occupancy and per-request phase "
                         "timestamps; the report carries the snapshot "
                         "under 'telemetry'; equivalent to "
                         "CACHEFLOW_TELEMETRY=1")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write the full telemetry snapshot (metrics + "
                         "gauge time series + per-request phase "
                         "transitions, and a real serve's spans) to PATH "
                         "as strict JSON; implies --telemetry")
    ap.add_argument("--timeline-out", metavar="PATH",
                    help="export the run's schedule as Chrome trace-event "
                         "JSON loadable in https://ui.perfetto.dev — one "
                         "track per engine resource, per-request lifecycle "
                         "flow arrows, aborted-op markers and counter "
                         "tracks (queue depth, tier bytes, per-channel "
                         "bandwidth); works with --replay too")
    ap.add_argument("--real", action="store_true",
                    help="run the model for real: at full width in bf16 on "
                         "'cuda', reduced in f32 on 'cpu'")
    ap.add_argument("--device", default="cuda",
                    help="device of --real and --replay --real (default "
                         "cuda, which needs a card; pass cpu to run the "
                         "reduced model on the CPU); sim and analytic "
                         "replay never touch it")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="capture the restoration schedule to a JSON trace")
    ap.add_argument("--replay", metavar="PATH",
                    help="re-execute a captured trace (pinned durations) "
                         "instead of scheduling fresh; --real replays it "
                         "on-device with per-request cache verification")
    args = ap.parse_args(argv)

    if args.admission == "gang" and args.preempt != "none":
        raise SystemExit("--admission gang is the run-to-completion "
                         "baseline: no mid-flight admission, so preemption "
                         "policies do not apply (drop --preempt)")

    if args.metrics_out:
        args.telemetry = True

    if args.replay:
        _replay(args)
        return

    # --timeline-out renders from a captured trace, so it implies capture
    # (recording is observation-only; the schedule is unchanged)
    recorder = TraceRecorder() if (args.trace_out or args.timeline_out) \
        else None

    if args.real:
        cfg, dev = _real_config(args.arch, args.device)
        model, params = _build_model(cfg, dev)
        # real mode restores from the MATERIALIZED chunk store: prefix KV
        # lives as content-addressed, deduplicated chunks across
        # hbm/host/disk tiers and load ops move its actual bytes
        store = None
        if not cfg.attn_window:
            store = ChunkStore(chunk_size=16, quant=args.kv_quant,
                               store_dir=args.store_dir,
                               default_tier=args.kv_tier, device=dev)
        eng = RealServingEngine(model, params, system=args.system,
                                stages=min(args.stages, 2), chunk_size=16,
                                max_batch=args.max_batch,
                                io_channels=args.io_channels,
                                preempt=args.preempt, evict=args.evict,
                                admission=args.admission,
                                prefetch=args.prefetch,
                                kvstore=store, datapath=args.datapath,
                                sanitize=args.sanitize or None,
                                telemetry=args.telemetry or None,
                                seed=args.seed, device=dev)
        decode_len = args.decode_len if args.decode_len >= 0 else 8
        # with a preemption policy armed, stagger arrivals and mark every
        # other request urgent so admission pressure actually exercises it;
        # without one, keep the classic simultaneous-arrival smoke exactly
        if args.preempt != "none":
            reqs = [Request(f"r{i}", 0.1 * i, prefix_len=64 + 32 * i,
                            new_len=16, decode_len=decode_len, priority=i % 2,
                            deadline=0.1 * i + (2.0 if i % 2 else 120.0))
                    for i in range(args.requests)]
        else:
            reqs = [Request(f"r{i}", 0.0, prefix_len=64 + 32 * i, new_len=16,
                            decode_len=decode_len)
                    for i in range(args.requests)]
        rep = eng.serve(reqs, trace=recorder)
        if args.trace_out:
            _save_trace(recorder, args.trace_out, arch=args.arch)
        out = {"system": args.system, "mode": "real",
               "admission": args.admission,
               "lifecycle": rep.stats,
               "preemptions": sum(rep.preemptions.values()),
               "compute_busy": round(rep.compute_busy, 3),
               "io_busy": round(rep.io_busy, 3),
               "decode_busy": round(rep.decode_busy, 3),
               "overlap_decode_restore": round(rep.overlap_decode_restore, 3)}
        if rep.sanitizer is not None:
            out["sanitizer"] = rep.sanitizer
        if store is not None:
            out["storage"] = {
                "chunks": len(store.chunks), "dedup_hits": store.dedup_hits,
                "bytes_put": store.bytes_put,
                "bytes_transferred": store.bytes_transferred,
                "io_hits": store.io_hits,
                "skipped_transfers": store.skipped_transfers,
                "store_misses": store.store_misses,
                "forks": store.forks,
                "pool_blocks": store.pool.live_blocks(),
                "cow_copies": store.pool.cow_copies,
                "cow_bytes": store.pool.bytes_copied}
        if eng.datapath is not None:
            dp, ex = eng.datapath, eng.executor
            out["datapath"] = {
                "mode": args.datapath,
                "channels": len(dp.streams),
                "kernel_launches": dp.kernel_launches,
                "resident_copies": dp.resident_copies,
                "staged_puts": sum(s.puts for s in dp.streams),
                "staged_bytes": sum(s.bytes_staged for s in dp.streams),
                "fused_loads": ex.fused_loads,
                "legacy_loads": ex.legacy_loads,
                "load_dispatches": ex.load_dispatches,
                # measured host→device bytes/sec per engine channel (None
                # until a channel carries a measured transfer)
                "channel_gbps": [round(b / 1e9, 6) if b else None
                                 for b in dp.bandwidths()]}
        elif store is not None:
            out["datapath"] = {"mode": "legacy",
                               "load_dispatches":
                                   eng.executor.load_dispatches}
        _emit_outputs(out, rep, recorder, args)
        return

    cfg = get_config(args.arch)
    if args.workload == "bursty_priority":
        from repro_torch.serving.workloads import bursty_priority
        reqs = bursty_priority(args.requests, seed=args.seed,
                               burst_size=args.burst_size,
                               burst_every=args.burst_every)
    else:
        reqs = generate(args.workload, args.requests, seed=args.seed)
    if args.decode_len >= 0:
        for r in reqs:
            r.decode_len = args.decode_len
    store = TieredKVStore(remote_bw=IO_BANDWIDTHS[args.bandwidth],
                          quant=args.kv_quant)
    eng = SimServingEngine(cfg, HARDWARE[args.hardware],
                           io_bandwidth=IO_BANDWIDTHS[args.bandwidth],
                           system=args.system, stages=args.stages,
                           max_batch=args.max_batch, kvstore=store,
                           io_channels=args.io_channels,
                           preempt=args.preempt, evict=args.evict,
                           kv_tier=args.kv_tier, admission=args.admission,
                           prefetch=args.prefetch,
                           sanitize=args.sanitize or None,
                           telemetry=args.telemetry or None)
    rep = eng.run(reqs, trace=recorder)
    if args.trace_out:
        _save_trace(recorder, args.trace_out, arch=args.arch)
    out = {
        "system": args.system, "workload": args.workload,
        "bandwidth": args.bandwidth, "hardware": args.hardware,
        "stages": args.stages, "preempt": args.preempt,
        "admission": args.admission,
        "lifecycle": rep.stats,
        "preemptions": sum(rep.preemptions.values()),
        "compute_busy": round(rep.compute_busy, 3),
        "io_busy": round(rep.io_busy, 3),
        "decode_busy": round(rep.decode_busy, 3),
        "overlap_decode_restore": round(rep.overlap_decode_restore, 3)}
    if rep.sanitizer is not None:
        out["sanitizer"] = rep.sanitizer
    _emit_outputs(out, rep, recorder, args)


def _emit_outputs(out: dict, rep, recorder, args):
    """Shared report/metrics/timeline emission for the sim and real paths.
    stdout gets the report (with the telemetry counters inlined when
    collected); the full snapshot and the Perfetto timeline go to their
    --*-out files."""
    if rep.telemetry is not None:
        # counters only on stdout — the gauge series and phase timelines
        # can be large; --metrics-out carries the full snapshot
        out["telemetry"] = {"counters": rep.telemetry["metrics"]["counters"]}
    if args.metrics_out:
        _save_metrics(rep.telemetry, args.metrics_out)
    if args.timeline_out:
        _save_timeline(recorder.trace, args.timeline_out,
                       telemetry=rep.telemetry)
    print(dumps_report(out))


if __name__ == "__main__":
    main()
