"""No module of the benchmark imports JAX, the JAX package or the old
benchmarks, and the reference imports nothing of the program: top-level
module names compared whole (``repro_torch`` is not ``repro``)."""
import ast
from pathlib import Path

import bench_fixtures  # noqa: F401  (the repository on the path)

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere_under_bench():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(set(top_level_imports(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = set(top_level_imports(f))
        assert not names & (FORBIDDEN | {"repro_torch", "bench"}), (f, names)


def test_comparison_is_whole_names():
    """``repro_torch`` passes, ``repro`` and ``repro.models`` do not."""
    from bench.run import FORBIDDEN as RUN_FORBIDDEN
    names = {m.split(".")[0] for m in ("repro_torch.models", "repro.models", "jaxlib.x")}
    assert names & set(RUN_FORBIDDEN) == {"repro", "jaxlib"}
