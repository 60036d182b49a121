"""The port's static lint (``python -m repro_torch.analysis.codelint``): the
tree lints clean, and each rule fires on a synthetic file that breaks it
(a rule that cannot fail its mutant is dead code) and stays quiet on its
fixed twin."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.codelint import (check_kernel_oracles,
                                           check_metric_catalog,
                                           check_no_library_kernel,
                                           check_no_reference_import,
                                           check_span_catalog,
                                           check_trace_kinds,
                                           check_unseeded_rng, main, run_all)

ROOT = Path(__file__).resolve().parents[1]


def _rules(findings):
    return [f.rule for f in findings]


def test_tree_is_clean():
    assert [str(f) for f in run_all(ROOT)] == []


def test_cli_prints_clean_and_exits_0(capsys):
    assert main(["--root", str(ROOT)]) == 0
    assert capsys.readouterr().out.strip() == "codelint: clean"
    assert main(["--root", str(ROOT), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_cli_as_a_module():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.codelint"],
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert (out.returncode, out.stdout.strip()) == (0, "codelint: clean")


# ---------------------------------------------------------------------------
# kernel-oracle
# ---------------------------------------------------------------------------


def _kernel_tree(tmp_path, *, wrapper=True, plain=True, test=True, smoke=True):
    csrc, kernels, tests = tmp_path / "csrc", tmp_path / "kernels", tmp_path / "tests"
    for d in (csrc, kernels / "myker", tests):
        d.mkdir(parents=True, exist_ok=True)
    (csrc / "myker.cu").write_text(
        '#include "common.cuh"\nextern "C" int myker_bf16(const void* x, void* stream) {\n'
        "  return 0;\n}\n")
    body = ""
    if wrapper:
        body += "def myker(x):\n    return _build.lib().myker_bf16(x, 0)\n"
    if plain:
        body += "def myker_plain(x):\n    return x\n"
    (kernels / "myker" / "__init__.py").write_text(body)
    if test:
        (tests / "test_torch_myker.py").write_text(
            "from k import myker_plain\n\ndef test_it():\n    myker_plain(1)\n")
    smoke_py = tmp_path / "chip_smoke.py"
    smoke_py.write_text('table = [("myker", "src/repro_torch/csrc/myker.cu")]\n'
                        if smoke else 'table = []\n')
    return csrc, kernels, tests, smoke_py


def test_kernel_oracle_clean_when_all_present(tmp_path):
    assert check_kernel_oracles(*_kernel_tree(tmp_path)) == []


def test_kernel_oracle_fires_on_each_missing_piece(tmp_path):
    for missing, word in (("wrapper", "no wrapper"), ("plain", "no *_plain"),
                          ("test", "no tests/test_torch_"), ("smoke", "kernels table")):
        tree = _kernel_tree(tmp_path / missing, **{missing: False})
        findings = check_kernel_oracles(*tree)
        assert _rules(findings) == ["kernel-oracle"], (missing, findings)
        assert word in findings[0].message


# ---------------------------------------------------------------------------
# unseeded-rng
# ---------------------------------------------------------------------------


def test_unseeded_rng_fires_on_global_draws(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text("import time\nimport random\nimport numpy as np\nimport torch\n"
                   "a = time.time()\n"
                   "b = random.random()\n"
                   "c = np.random.default_rng()\n"
                   "d = np.random.normal()\n"
                   "e = torch.randn(4)\n"
                   "f = torch.randint(0, 8, (2,))\n"
                   "torch.manual_seed(0)\n"
                   "g = torch.randperm(5)\n")
    findings = check_unseeded_rng([bad])
    assert _rules(findings) == ["unseeded-rng"] * 8
    assert sorted(f.line for f in findings) == list(range(5, 13))


def test_unseeded_rng_quiet_on_seeded_draws(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("import time\nimport numpy as np\nimport torch\n"
                  "a = time.perf_counter()\n"
                  "rng = np.random.default_rng(0)\n"
                  "b = rng.normal()\n"
                  "gen = torch.Generator().manual_seed(3)\n"
                  "c = torch.randint(0, 8, (2,), generator=gen)\n"
                  "d = torch.randn(4, generator=gen)\n")
    assert check_unseeded_rng([ok]) == []


# ---------------------------------------------------------------------------
# trace-kinds, metric-catalog
# ---------------------------------------------------------------------------


def test_trace_kinds(tmp_path):
    tr = tmp_path / "trace.py"
    tr.write_text('EVENT_KINDS = {"admit": 1}\n'
                  'def record(self, t):\n'
                  '    self._ev(kind="admit", t=t)\n'
                  '    self._ev(kind="vanish", t=t)\n')
    findings = check_trace_kinds(tr)
    assert _rules(findings) == ["trace-kinds"] and "vanish" in findings[0].message
    tr.write_text('EVENT_KINDS = {"admit": 1}\ndef scan(e):\n    return e.kind == "ghost"\n')
    assert _rules(check_trace_kinds(tr)) == ["trace-kinds"]
    tr.write_text('KINDS = {"admit": 1}\n')
    assert "EVENT_KINDS" in check_trace_kinds(tr)[0].message


def test_metric_catalog(tmp_path):
    reg = tmp_path / "registry.py"
    reg.write_text('METRIC_CATALOG = {"engine.admissions_total": {"type": "counter"}}\n')
    mod = tmp_path / "mod.py"
    mod.write_text('r.counter("engine.admissions_total").inc()\n'
                   'r.gauge("engine.warp_factor").set(9)\n')
    findings = check_metric_catalog(reg, [mod])
    assert _rules(findings) == ["metric-catalog"] and findings[0].line == 2
    mod.write_text('r.counter("engine.admissions_total").inc()\n')
    assert check_metric_catalog(reg, [mod]) == []


def test_span_catalog(tmp_path):
    reg = tmp_path / "registry.py"
    reg.write_text('SPAN_CATALOG = {"engine.decode_step": {"parent": ()}}\n')
    mod = tmp_path / "mod.py"
    mod.write_text('with obs.span("engine.decode_step", None, 4):\n    pass\n'
                   'with obs.span("engine.warp_jump", rid):\n    pass\n'
                   'm.span(1)\n')
    findings = check_span_catalog(reg, [mod])
    assert _rules(findings) == ["span-catalog"] and findings[0].line == 3
    assert "engine.warp_jump" in findings[0].message
    mod.write_text('with obs.span("engine.decode_step"):\n    pass\n')
    assert check_span_catalog(reg, [mod]) == []
    reg.write_text('METRIC_CATALOG = {}\n')
    assert "SPAN_CATALOG" in check_span_catalog(reg, [mod])[0].message


# ---------------------------------------------------------------------------
# no-reference-import, no-library-kernel
# ---------------------------------------------------------------------------


def test_no_reference_import(tmp_path):
    mods = {"plans.py": "from repro.core import plans\n",
            "j.py": "import jax\n",
            "jnp.py": "import jax.numpy as jnp\n",
            "pkg.py": "import repro.models.model\n",
            "lib.py": "from jaxlib import xla_client\n",
            "dyn.py": "import importlib\nm = importlib.import_module(f\"repro.configs.{n}\")\n"}
    for name, text in mods.items():
        (tmp_path / name).write_text(text)
        findings = check_no_reference_import([tmp_path / name])
        assert _rules(findings) == ["no-reference-import"], name
    ok = tmp_path / "ok.py"
    ok.write_text("from repro_torch.core import plans\nimport reprox\nfrom . import jax\n"
                  "import importlib\nm = importlib.import_module(f\"repro_torch.configs.{n}\")\n")
    assert check_no_reference_import([ok]) == []


@pytest.mark.parametrize("rule,check,line", [
    ("no-reference-import", check_no_reference_import, "import jax"),
    ("no-reference-import", check_no_reference_import, "from repro.core import plans"),
    ("no-library-kernel", check_no_library_kernel, "o = F.scaled_dot_product_attention(q, k, v)"),
    ("unseeded-rng", check_unseeded_rng, "e = torch.randn(4)"),
])
def test_no_comment_silences_a_rule(tmp_path, rule, check, line):
    """A rule has no way round it: the reference's allow comment, or any
    other, on the offending line still leaves it reported."""
    for i, comment in enumerate((f"  # codelint: allow({rule})", "  # noqa")):
        mod = tmp_path / f"m{i}.py"
        mod.write_text(f"import torch\n{line}{comment}\n")
        findings = check([mod])
        assert _rules(findings) == [rule] and findings[0].line == 2, (comment, findings)


def test_no_library_kernel(tmp_path):
    mods = {"sdpa.py": "import torch.nn.functional as F\n"
                       "o = F.scaled_dot_product_attention(q, k, v)\n",
            "sdpa_name.py": "from torch.nn.functional import scaled_dot_product_attention\n",
            "compile.py": "import torch\nf = torch.compile(g)\n",
            "fa.py": "from flash_attn import flash_attn_func\n",
            "fa_mod.py": "import flash_attn\n"}
    for name, text in mods.items():
        (tmp_path / name).write_text(text)
        findings = check_no_library_kernel([tmp_path / name])
        assert findings and set(_rules(findings)) == {"no-library-kernel"}, name
    ok = tmp_path / "ok.py"
    ok.write_text("import re\np = re.compile('x')\nfrom repro_torch.kernels import flash_prefill\n")
    assert check_no_library_kernel([ok]) == []
