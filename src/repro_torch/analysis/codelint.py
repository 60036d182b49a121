"""The PyTorch port's static lint (AST-level), the counterpart of
``repro.analysis.codelint`` with the port's own rules:

    python -m repro_torch.analysis.codelint [--root PATH] [--json]

  * ``kernel-oracle``      — every ``csrc/*.cu`` entry point (``extern "C"``)
    is called by a wrapper under ``kernels/<name>/``; that wrapper defines a
    ``*_plain`` version, a ``tests/test_torch_*.py`` names it, and
    ``chip_smoke.py`` names the source and the kernel (the entry point less
    its ``_bf16`` / ``_f32`` suffix) in its ``kernels`` table.  A CUDA kernel
    cannot run on the CPU, so its plain version and the on-card check are
    all that hold it.
  * ``unseeded-rng``       — the reference's rule (no ``time.time()``, bare
    ``random``, ``np.random`` singleton draws or seedless
    ``np.random.default_rng()``) plus torch's global generator:
    ``torch.rand*`` / ``randn*`` / ``randint*`` / ``randperm`` / ``normal``
    / ``bernoulli`` / ``multinomial`` without ``generator=``, and
    ``torch.manual_seed``, under ``core/``, ``storage/`` and ``serving/``:
    what they feed is captured in traces that must replay bit for bit.
  * ``trace-kinds``        — every event kind emitted or matched in
    ``core/trace.py`` is registered in its ``EVENT_KINDS``.
  * ``metric-catalog``     — every metric name given as a literal to a
    ``.counter()`` / ``.gauge()`` / ``.histogram()`` call under
    ``src/repro_torch`` is in ``obs/registry.py``'s ``METRIC_CATALOG``.
  * ``span-catalog``       — every span name given as a literal to an
    ``obs.span()`` call under ``src/repro_torch`` is in
    ``obs/registry.py``'s ``SPAN_CATALOG``.
  * ``no-reference-import`` — nothing under ``src/repro_torch`` and nothing in
    ``chip_smoke.py`` imports ``repro`` (the JAX package) or ``jax``, by an
    import statement or ``importlib.import_module``: the port and its
    on-card smoke run where neither is installed.
  * ``no-library-kernel``  — nothing under ``src/repro_torch`` calls
    ``scaled_dot_product_attention``, ``torch.compile`` or ``flash_attn``:
    the port's attention is its own kernels.

Each ``check_*`` function takes explicit paths so the mutation tests can
point it at synthetic files.  No rule has a way round it: a comment on the
offending line silences nothing.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Set

#: np.random module-singleton entry points that draw from unseeded global
#: state (the reference's list)
NP_GLOBAL_DISTS = {
    "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "normal", "uniform", "exponential", "poisson",
    "seed", "bytes",
}
#: torch functions that draw from the global generator unless handed one
TORCH_DRAWS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson",
}
#: the C entry points' dtype suffixes, less which the kernels table names them
ENTRY_SUFFIXES = ("_bf16", "_f32")
_ENTRY = re.compile(r'extern\s+"C"\s+\w+\s+(\w+)\s*\(')


@dataclass
class CodeLintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _parse(path: Path):
    return ast.parse(path.read_text(), filename=str(path))


# ---------------------------------------------------------------------------
# kernel-oracle
# ---------------------------------------------------------------------------


def _string_constants(tree) -> Set[str]:
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def check_kernel_oracles(csrc_dir: Path, kernels_dir: Path, tests_dir: Path,
                         smoke_py: Path) -> List[CodeLintFinding]:
    out: List[CodeLintFinding] = []
    wrappers = {p: p.read_text() for p in sorted(kernels_dir.glob("*/__init__.py"))}
    tests = [p.read_text() for p in sorted(tests_dir.glob("test_torch_*.py"))] \
        if tests_dir.is_dir() else []
    smoke = _string_constants(ast.parse(smoke_py.read_text())) \
        if smoke_py.exists() else set()
    for cu in sorted(csrc_dir.glob("*.cu")):
        text = cu.read_text()
        for m in _ENTRY.finditer(text):
            entry = m.group(1)
            line = text.count("\n", 0, m.start()) + 1
            where = (str(cu), line)
            callers = [p for p, src in wrappers.items() if f".{entry}(" in src]
            if not callers:
                out.append(CodeLintFinding(
                    "kernel-oracle", *where,
                    f"entry point {entry!r} is called by no wrapper under "
                    f"{kernels_dir}/<name>/"))
                continue
            for wrapper in callers:
                plains = [n.name for n in ast.walk(ast.parse(wrappers[wrapper]))
                          if isinstance(n, ast.FunctionDef)
                          and n.name.endswith("_plain")]
                if not plains:
                    out.append(CodeLintFinding(
                        "kernel-oracle", str(wrapper), 1,
                        f"wrapper of {entry!r} defines no *_plain version"))
                elif not any(p in t for p in plains for t in tests):
                    out.append(CodeLintFinding(
                        "kernel-oracle", str(wrapper), 1,
                        f"no tests/test_torch_*.py names {plains} (the plain "
                        f"version of {entry!r})"))
            name = entry
            for suffix in ENTRY_SUFFIXES:
                name = name.removesuffix(suffix)
            rel = f"src/repro_torch/csrc/{cu.name}"
            if name not in smoke or rel not in smoke:
                out.append(CodeLintFinding(
                    "kernel-oracle", *where,
                    f"{smoke_py.name}'s kernels table does not name "
                    f"{name!r} from {rel!r} (the on-card check of {entry!r})"))
    return out


# ---------------------------------------------------------------------------
# unseeded-rng
# ---------------------------------------------------------------------------


def _module_names(tree, module: str) -> Set[str]:
    """The names ``module`` is bound to by ``import module [as x]``."""
    return {a.asname or a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names if a.name == module}


def check_unseeded_rng(paths: Sequence[Path]) -> List[CodeLintFinding]:
    out: List[CodeLintFinding] = []
    for path in paths:
        if not path.exists():
            continue
        tree = _parse(path)
        random_names = _module_names(tree, "random")
        numpy_names = _module_names(tree, "numpy") | {"np"}
        torch_names = _module_names(tree, "torch") | {"torch"}

        def find(node, msg):
            out.append(CodeLintFinding("unseeded-rng", str(path), node.lineno, msg))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "random":
                find(node, "from random import ... pulls unseeded global-state "
                           "RNG into trace-feeding code; use "
                           "np.random.default_rng(seed)")
            elif isinstance(node, ast.ImportFrom) and node.module == "torch" \
                    and any(a.name in TORCH_DRAWS | {"manual_seed"}
                            for a in node.names):
                find(node, "from torch import <draw> hides the global "
                           "generator; call torch.<draw>(..., generator=g)")
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            f, mod = node.func, node.func.value
            if f.attr == "time" and isinstance(mod, ast.Name) and mod.id == "time":
                find(node, "time.time() is nondeterministic wall clock; engine "
                           "time must come from the simulated clock "
                           "(time.perf_counter is fine for pure profiling)")
            elif isinstance(mod, ast.Name) and mod.id in random_names:
                find(node, f"random.{f.attr}() draws from unseeded global "
                           f"state; use np.random.default_rng(seed)")
            elif isinstance(mod, ast.Attribute) and mod.attr == "random" \
                    and isinstance(mod.value, ast.Name) \
                    and mod.value.id in numpy_names:
                if f.attr == "default_rng" and not node.args and not node.keywords:
                    find(node, "np.random.default_rng() without a seed is "
                               "entropy-seeded; pass an explicit seed")
                elif f.attr in NP_GLOBAL_DISTS:
                    find(node, f"np.random.{f.attr}() uses the unseeded global "
                               f"generator; use np.random.default_rng(seed)")
            elif isinstance(mod, ast.Name) and mod.id in torch_names:
                if f.attr == "manual_seed":
                    find(node, "torch.manual_seed() reseeds the process-wide "
                               "generator; seed a torch.Generator and pass it")
                elif f.attr in TORCH_DRAWS and not any(
                        k.arg == "generator" for k in node.keywords):
                    find(node, f"torch.{f.attr}() without generator= draws from "
                               f"the global generator; pass a seeded "
                               f"torch.Generator")
    return out


# ---------------------------------------------------------------------------
# trace-kinds and metric-catalog (the reference's rules on the port's
# files), and span-catalog, their twin for the port's spans
# ---------------------------------------------------------------------------


def _literal_dict_keys(tree, name: str) -> Optional[Set[str]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name) \
                and node.target.id == name and node.value is not None:
            value = node.value
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            value = node.value
        else:
            continue
        if isinstance(value, ast.Dict):
            return {k.value for k in value.keys if isinstance(k, ast.Constant)}
    return None


def check_trace_kinds(trace_py: Path) -> List[CodeLintFinding]:
    if not trace_py.exists():
        return [CodeLintFinding("trace-kinds", str(trace_py), 1,
                                "trace module not found")]
    tree = ast.parse(trace_py.read_text(), filename=str(trace_py))
    registered = _literal_dict_keys(tree, "EVENT_KINDS")
    if registered is None:
        return [CodeLintFinding(
            "trace-kinds", str(trace_py), 1,
            "no EVENT_KINDS literal dict found — the schema version table "
            "is gone")]
    out: List[CodeLintFinding] = []
    for node in ast.walk(tree):
        # recorder emissions: _ev(kind="...") / TraceEvent(kind="...")
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str) \
                        and kw.value.value not in registered:
                    out.append(CodeLintFinding(
                        "trace-kinds", str(trace_py), node.lineno,
                        f"event kind {kw.value.value!r} emitted but not "
                        f"registered in EVENT_KINDS"))
        # consumers: <expr>.kind == "..." comparisons
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Attribute) \
                and node.left.attr == "kind":
            for cmp in node.comparators:
                if isinstance(cmp, ast.Constant) and isinstance(cmp.value, str) \
                        and cmp.value not in registered:
                    out.append(CodeLintFinding(
                        "trace-kinds", str(trace_py), node.lineno,
                        f"event kind {cmp.value!r} matched but not "
                        f"registered in EVENT_KINDS"))
    return out


#: registry accessors whose first positional string argument is a metric name
METRIC_METHODS = {"counter", "gauge", "histogram"}


def check_metric_catalog(registry_py: Path,
                         paths: Sequence[Path]) -> List[CodeLintFinding]:
    if not registry_py.exists():
        return [CodeLintFinding("metric-catalog", str(registry_py), 1,
                                "metrics registry module not found")]
    registered = _literal_dict_keys(ast.parse(registry_py.read_text()),
                                    "METRIC_CATALOG")
    if registered is None:
        return [CodeLintFinding(
            "metric-catalog", str(registry_py), 1,
            "no METRIC_CATALOG literal dict found — the metric catalog "
            "is gone")]
    out: List[CodeLintFinding] = []
    for path in paths:
        if not path.exists():
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in METRIC_METHODS and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value not in registered):
                out.append(CodeLintFinding(
                    "metric-catalog", str(path), node.lineno,
                    f"metric {node.args[0].value!r} used at a "
                    f".{node.func.attr}() call but not registered in "
                    f"METRIC_CATALOG (obs/registry.py)"))
    return out


def check_span_catalog(registry_py: Path,
                       paths: Sequence[Path]) -> List[CodeLintFinding]:
    registered = _literal_dict_keys(ast.parse(registry_py.read_text()),
                                    "SPAN_CATALOG") \
        if registry_py.exists() else None
    if registered is None:
        return [CodeLintFinding(
            "span-catalog", str(registry_py), 1,
            "no SPAN_CATALOG literal dict found — the span catalog is gone")]
    out: List[CodeLintFinding] = []
    for path in paths:
        if not path.exists():
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "obs" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value not in registered):
                out.append(CodeLintFinding(
                    "span-catalog", str(path), node.lineno,
                    f"span {node.args[0].value!r} opened at an obs.span() "
                    f"call but not registered in SPAN_CATALOG "
                    f"(obs/registry.py)"))
    return out


# ---------------------------------------------------------------------------
# no-reference-import, no-library-kernel
# ---------------------------------------------------------------------------


def _is_module(name: Optional[str], top: str) -> bool:
    return name is not None and (name == top or name.startswith(top + "."))


def check_no_reference_import(paths: Sequence[Path]) -> List[CodeLintFinding]:
    out: List[CodeLintFinding] = []
    for path in paths:
        if not path.exists():
            continue
        tree = _parse(path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif (isinstance(node, ast.Call) and node.args
                  and getattr(node.func, "attr", "") == "import_module"):
                arg = node.args[0]                # "pkg.mod" or f"pkg.{name}"
                head = arg.values[0] if isinstance(arg, ast.JoinedStr) else arg
                if not (isinstance(head, ast.Constant) and isinstance(head.value, str)):
                    continue
                names = [head.value.rstrip(".")]
            else:
                continue
            for name in names:
                top = next((t for t in ("repro", "jax", "jaxlib")
                            if _is_module(name, t)), None)
                if top:
                    out.append(CodeLintFinding(
                        "no-reference-import", str(path), node.lineno,
                        f"imports {name!r}: the port and chip_smoke.py import "
                        f"nothing of the JAX package or of JAX"))
    return out


#: what the port may not call in place of its own kernels
LIBRARY_KERNELS = ("scaled_dot_product_attention", "flash_attn")


def check_no_library_kernel(paths: Sequence[Path]) -> List[CodeLintFinding]:
    out: List[CodeLintFinding] = []
    for path in paths:
        if not path.exists():
            continue
        tree = _parse(path)
        for node in ast.walk(tree):
            what = None
            if isinstance(node, ast.Attribute):
                if node.attr in LIBRARY_KERNELS:
                    what = node.attr
                elif node.attr == "compile" and isinstance(node.value, ast.Name) \
                        and node.value.id == "torch":
                    what = "torch.compile"
            elif isinstance(node, ast.Name) and node.id in LIBRARY_KERNELS:
                what = node.id
            elif isinstance(node, ast.Import):
                what = next((a.name for a in node.names
                             if _is_module(a.name, "flash_attn")), None)
            elif isinstance(node, ast.ImportFrom):
                if _is_module(node.module, "flash_attn"):
                    what = node.module
                elif any(a.name in LIBRARY_KERNELS for a in node.names):
                    what = next(a.name for a in node.names
                                if a.name in LIBRARY_KERNELS)
            if what:
                out.append(CodeLintFinding(
                    "no-library-kernel", str(path), node.lineno,
                    f"{what}: the port's attention runs in its own kernels "
                    f"(a library kernel may only be timed beside them, in "
                    f"chip_smoke.py)"))
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def run_all(root: Path) -> List[CodeLintFinding]:
    src = root / "src" / "repro_torch"
    smoke = root / "chip_smoke.py"
    files = sorted(src.rglob("*.py"))
    findings: List[CodeLintFinding] = []
    findings += check_kernel_oracles(src / "csrc", src / "kernels",
                                     root / "tests", smoke)
    findings += check_unseeded_rng([p for d in ("core", "storage", "serving")
                                    for p in sorted((src / d).glob("*.py"))])
    findings += check_trace_kinds(src / "core" / "trace.py")
    findings += check_metric_catalog(src / "obs" / "registry.py", files)
    findings += check_span_catalog(src / "obs" / "registry.py", files)
    findings += check_no_reference_import(files + [smoke])
    findings += check_no_library_kernel(files)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.codelint",
        description="The port's AST lint (see module docstring).")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect from this file)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    root = Path(args.root) if args.root else Path(__file__).resolve().parents[3]
    findings = run_all(root)
    if args.as_json:
        print(json.dumps([{"rule": f.rule, "path": f.path, "line": f.line,
                           "message": f.message} for f in findings]))
    elif findings:
        for f in findings:
            print(f)
        print(f"{len(findings)} finding(s)")
    else:
        print("codelint: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
