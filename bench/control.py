"""Readings that the limit of ``correct`` is set from, on the chip:

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell (set-up, a window of ``--seconds``,
the program's state freed) in this process, then over the same sample of
finished requests the program's numbers and the float8 control's
(``bench.check``), each judged by ``run.report`` as a run's are.  One
JSON line per seed: the program's readings set the lower end of a limit,
the control's the upper, and the control's ``correct`` has to come out
false.  The benchmark's own runs never run the control."""
import argparse
import json
import sys
import time

from run import ROOT, load_cell, report, run_cell


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    spec, cell, cfg, mix = load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run_cell(cfg, mix, seed, args.seconds, trace=False,
                       device=torch.device("cuda", 0), t_process=t0, control=True)
        prog, _ = report(spec, args.workload, cfg, out, trace=False)
        ctl, _ = report(spec, args.workload, cfg, out, trace=False,
                        numbers=out["control_numbers"])
        print(json.dumps({"seed": seed, "program_correct": prog["correct"],
                          "control_correct": ctl["correct"],
                          "program": {k: v for k, v in out["numbers"].items()
                                      if k != "per_request"},
                          "control": {k: v for k, v in out["control_numbers"].items()
                                      if k != "per_request"},
                          "program_per_request": out["numbers"]["per_request"],
                          "control_per_request": out["control_numbers"]["per_request"],
                          "metrics": prog["metrics"], "attempted": prog["attempted"],
                          "window_s": out["window_s"], "reference_s": out["reference_s"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
