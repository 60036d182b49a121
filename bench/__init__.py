"""Benchmark of the PyTorch and CUDA port (``repro_torch``); see ``run.py``."""
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_file(rel: str):
    """The module in file ``rel`` (a path from the repository root), found by
    name: the traffic generators of ``bench/traffic/``, the metric readers
    of ``bench/metrics/`` and the references that configurations name."""
    path = ROOT / rel
    name = "bench_file_" + "".join(c if c.isalnum() else "_" for c in rel)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod
