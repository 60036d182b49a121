"""Benchmark of the PyTorch and CUDA port (``repro_torch``): one cell, one run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cell's cards.  The
cell (``BENCHMARK.json``) names a configuration (``bench/configs/``) and a
traffic mix (``bench/traffic/``).  Set-up builds the engine, makes the
weights on the card from the seed, remembers the pool of sessions and
warms every path up.  Then a closed loop of the mix's ``clients`` clients
serves new turns of those sessions: ``serve`` calls of ``queue`` requests,
``clients`` of them in flight, a finished one's slot taken at once by the
next.  The window opens at the first dispatch after ``ramp`` requests have
finished (every client has then turned over once: the loop is in its
steady state) and closes at the first dispatch ``--seconds`` later, which
ends the call.  Afterwards the program's state is freed and a sample of
the window's finished requests is held to the plain reference.  The last
line of standard output is the result; the numbers compared, each with its
limit, are the last lines of standard error.

With ``--trace 0`` the result carries the cell's end-to-end metrics, all
on the wall clock; with ``--trace 1`` its per-layer metrics, read by the
files of ``bench/metrics/`` from the window's stamps and counters and from
a ``torch.profiler`` trace of the same loop after the window closed (at
least ``TRACE_SECONDS``, and on until every kernel it reads has launched):
the profiler slows the host, so the window itself runs untraced and its
counters read as in an untraced run.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the trace after the window: at least TRACE_SECONDS, then until every
# hand-written kernel of the serve path has launched, TRACE_MAX_SECONDS at most
TRACE_SECONDS = 8.0
TRACE_MAX_SECONDS = 40.0
# modules that must not be loaded in the process that prints the result,
# compared by whole top-level name ("repro_torch" is not "repro")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_cell(root: Path, name: str):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"unknown workload {name!r}")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return spec, cell, cfg, mix


def metric_reader(name: str):
    from bench import load_file
    return load_file(f"bench/metrics/{name}.py").read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Loop:
    """The phases of a run's closed loop, advanced by the stamps' hook after
    every dispatch: the ramp, until ``ramp`` requests have finished; the
    window, ``seconds`` of wall clock from the next dispatch; with a trace,
    ``TRACE_SECONDS`` more under the profiler, or more until ``trace[2]()``
    holds (every kernel the trace reads has launched), ``TRACE_MAX_SECONDS``
    at most.  Then ``WindowClosed`` ends the ``serve`` call.  ``t0``/``t1`` bound the window, ``e0``/``e1`` are
    the engine clock there, ``c0``/``c1`` the counters."""

    def __init__(self, ramp: int, seconds: float, counters, trace=None):
        self.ramp, self.seconds, self.counters = ramp, seconds, counters
        self.trace = trace                  # (start, stop, ready) or None
        self.t0 = self.t1 = None

    def __call__(self, st):
        from bench.serve import WindowClosed
        now = time.perf_counter()
        if self.t0 is None:
            if len(st.finish) >= self.ramp:
                self.t0, self.e0, self.c0 = now, st.engine_now, self.counters()
            return
        if self.t1 is None:
            if now - self.t0 >= self.seconds:
                self.t1, self.e1, self.c1 = now, st.engine_now, self.counters()
                if self.trace is None:
                    raise WindowClosed
                self.trace[0]()
            return
        traced = now - self.t1
        if traced >= TRACE_MAX_SECONDS or (traced >= TRACE_SECONDS and self.trace[2]()):
            self.trace[1]()
            raise WindowClosed


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, *, trace: bool,
             device, t_process: float, tamper=None, control: bool = False) -> dict:
    """Set-up, window and check of one run.  Returns the window's stamps
    and bounds, the finished requests' outputs, the set-up seconds, the
    counters' deltas, the trace, the peak memory and the check's numbers.
    ``tamper(system)``, when given, is called after set-up (tests break the
    timed path with it); ``control`` also reads the float8 control's
    numbers on the same sample (``bench/control.py``; the benchmark's runs
    do not)."""
    import torch

    from bench import check, flops, inputs, load_file, serve, tracing

    hf = cfg["hf"]
    plan = inputs.plan(mix, cfg, seed)
    marks = [("start", time.perf_counter())]
    system = serve.build(cfg, plan.clients, seed, device)
    engine = system["engine"]
    marks.append(("build", time.perf_counter()))
    pool = serve.remember_pool(system, plan, seed, hf["vocab_size"])
    marks.append(("remember", time.perf_counter()))
    # warm-up on a session of its own: restoration from the host tier and
    # from HBM, a suffix prefill and decode steps, so nothing builds or
    # compiles in the window
    warm = cfg["serve"]["warmup"]
    engine.executor.remember("session-warmup", torch.from_numpy(
        inputs.token_ids(seed, warm["prefix_len"], hf["vocab_size"],
                         len(plan.prefix_lens)))[None])
    for i, (new, dec) in enumerate(warm["turns"]):
        serve.serve_call(engine, [serve.Request(
            f"warmup-{i}", 0.0, warm["prefix_len"], new, decode_len=dec,
            meta={"fork_of": "session-warmup"})], serve.Stamps())
    if tamper is not None:
        tamper(system)
    engine.executor.sync()
    marks.append(("warmup", time.perf_counter()))
    store, dp = system["store"], engine.datapath

    def counters():
        streams = dp.streams if dp is not None else []
        return {"io_hits": store.io_hits, "fetches": store.fetches,
                "dp_bytes": sum(s.bytes_moved for s in streams),
                "dp_secs": sum(s.secs for s in streams)}

    spy = traced = None
    hooks = None
    if trace:
        spy, prof, span, stack = tracing.Spy(), tracing.profiler(), {}, contextlib.ExitStack()

        def start():
            stack.enter_context(spy.installed())
            stack.enter_context(tracing.ranges())
            span["t0"] = time.perf_counter()
            prof.start()

        def stop():
            engine.executor.sync()
            span["t1"] = time.perf_counter()     # stopping flushes for seconds
            spy.active = False
            prof.stop()
            stack.close()

        hooks = (start, stop, lambda: all(spy.launches[k] for k in tracing.KERNELS))
    loop = Loop(plan.ramp, seconds, counters, hooks)
    stamps = serve.Stamps(loop)
    outputs, k = {}, 0
    while True:
        turns = [plan.turn(k + i) for i in range(plan.queue)]
        k += plan.queue
        got = serve.serve_call(engine, serve.requests_of(turns, "r"), stamps)
        for t in turns:
            rid = f"r-{t.index}"
            if rid in got["tokens"]:
                outputs[rid] = (t, got["tokens"][rid], got["logits"][rid])
        if got["closed"]:
            break
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if trace:
        traced = tracing.read(prof, span["t1"] - span["t0"])
    t0, t1 = loop.t0, loop.t1
    in_window = [rid for rid, t in stamps.finish.items() if t0 <= t <= t1]
    finished = []
    for rid in sorted(in_window, key=lambda r: stamps.finish[r]):
        t, toks, logits = outputs[rid]
        finished.append({"rid": rid, "prefix_len": t.prefix_len, "new_len": t.new_len,
                         "decode_len": t.decode_len, "tokens": toks, "logits": logits,
                         "prefix_ids": pool[t.session].numpy(),
                         "suffix_ids": inputs.suffix_ids(seed, t.new_len,
                                                         hf["vocab_size"])})
    # the program's state goes before the reference runs; the weights stay,
    # read by both sides
    params = system["params"]
    del system, engine, store, dp, outputs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = load_file(cfg["reference"])
    picked = check.sample(finished, seed, cfg["check"]["min_tokens"])
    t_ref = time.perf_counter()
    numbers = check.numbers(hf, params, picked, device, ref)
    reference_s = time.perf_counter() - t_ref
    control_numbers = check.numbers(hf, params, picked, device, ref, control=True) \
        if control else None
    return {"stamps": stamps, "t0": t0, "t1": t1, "window_s": t1 - t0,
            "engine_s": loop.e1 - loop.e0, "setup_s": t0 - t_process,
            "finished": finished,
            "delta": {key: loop.c1[key] - loop.c0[key] for key in loop.c1},
            "trace": traced, "spy": spy, "peak_bytes": peak, "numbers": numbers,
            "reference_s": reference_s, "control_numbers": control_numbers,
            "shape": flops.Shape.of(hf), "attempted": len(finished),
            "requests_served": k,
            "setup_parts": {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
            | {"before": marks[0][1] - t_process, "ramp": t0 - marks[-1][1]}}


def report(spec: dict, workload: str, cfg: dict, out: dict, *, trace: bool,
           numbers=None):
    """The result's verdict and metrics, and the diagnostics, of a run.
    ``numbers`` judges other check numbers than the run's (the control's,
    ``bench/control.py``)."""
    from bench import stats

    st, t0, t1 = out["stamps"], out["t0"], out["t1"]
    served = {f["rid"]: len(f["tokens"]) for f in out["finished"]}
    req = stats.request_metrics(st.admit, st.first, st.finish, served, st.decodes, t0, t1)
    e2e = {"setup_s": out["setup_s"]} | {k: req[k] for k in (
        "requests_per_s", "output_tokens_per_s", "ttft_p50_s", "tpot_p50_ms")}
    ctx = out | {"requests": req,
                 "ops": [o for o in st.ops if t0 <= o[0] <= t1],
                 "decodes": [d for d in st.decodes if t0 <= d[0] <= t1]}
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = metric_reader(m["name"])(ctx) if trace else e2e[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cfg["check"]["limits"]
    nums = out["numbers"] if numbers is None else numbers
    # a request of the window fails when it served another number of
    # tokens than it asked for
    failed = sum(1 for f in out["finished"] if len(f["tokens"]) != f["decode_len"])
    checks = {k: {"value": nums[k], "limit": lim} for k, lim in limits.items()}
    result = {"correct": bool(out["attempted"] > 0 and failed == 0
                              and all(c["value"] is not None and c["value"] <= c["limit"]
                                      for c in checks.values())),
              "attempted": out["attempted"], "failed": failed, "metrics": metrics,
              "checks": checks}
    diag = {"window_s": out["window_s"], "completed": req["completed"],
            "e2e": e2e, "engine_s": out["engine_s"],
            "in_flight_at_close": sum(1 for r in st.admit
                                      if st.admit[r] <= t1 and st.finish.get(r, t1 + 1) > t1),
            "requests_served": out["requests_served"],
            "reference_s": out["reference_s"],
            "numbers": {k: v for k, v in nums.items() if k != "per_request"},
            "per_request": nums["per_request"],
            "sample_requests": len(nums["per_request"]),
            "sample_tokens": sum(served[r] for r in nums["per_request"]),
            "ttft_s": req["ttft"], "tpot_s": req["tpot"], "delta": out["delta"],
            "setup_parts": out["setup_parts"],
            "decode_batch": [len(d[1]) for d in ctx["decodes"]][:400],
            "trace_events": (out["trace"] or {}).get("n_device_events")}
    return result, diag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec, cell, cfg, mix = load_cell(ROOT, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)

    out = run_cell(cfg, mix, args.seed, args.seconds, trace=bool(args.trace),
                   device=device, t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3

    result, diag = report(spec, args.workload, cfg, out, trace=bool(args.trace))
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": cell["chips"], "memory_peak_bytes": out["peak_bytes"]}
    if args.trace and out["trace"] is not None:
        tr = out["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = result.pop("checks")
    print(json.dumps(diag), file=sys.stderr)
    print(json.dumps(result))
    print(f"checked {diag['sample_requests']} requests, "
          f"{diag['sample_tokens']} served tokens", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
