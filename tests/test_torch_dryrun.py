"""The port's dry run (``repro_torch.launch.dryrun``) and its counting mode
(``repro_torch.launch.op_cost``) held to the reference's ``dryrun`` and
``hlo_cost`` on the CPU.

The reference runs in subprocesses started together by the module
fixture, so that ``repro.launch.dryrun``'s ``XLA_FLAGS`` line (512 host
devices) never reaches this process: one prints its ``input_specs`` for
every arch and shape and its ``cells``; one a family its ``dryrun_cell``
of that family's reduced config on a (2, 2) mesh of host devices with Auto
axes (``get_config`` and ``make_production_mesh`` patched there, nothing
in ``src/repro`` changed); one a family ``hlo_cost.analyze``'s
``dot_flops`` of its reduced train, prefill and decode step compiled for
one CPU device.  One more runs the port's CLI on one full-size cell.  Every fake process group
of this process is destroyed in a ``finally`` (``dryrun.fake_world``), so
no later test file on this worker sees one.

Tolerances of ``dot_flops`` against the reference (port / reference):

* one device (``DOT_TOL``, B 2, S 16, a 128-slot decode cache): dense GQA,
  MoE (dropless scatter in both), MLA and the RG-LRU hybrid within 1%;
  they count the same products to the flop (train, prefill, decode), but
  for the hybrid's decode, where the reference pads its 64-slot ring to a
  128-key block (``_gqa_flash``'s block of max(128, slots)) and takes QKᵀ
  and PV over the empty slots: the test adds those to the port's count.
  RWKV's prefill and decode within 1% (0.99936: XLA writes the bonus
  r·(u⊙k) as a dot, the port as a product and a sum); its train step
  within 10% (1.0919): the reference differentiates its step-by-step scan,
  the port's backward is ``wkv6_backward_plain``'s chunk-parallel
  algorithm, whose decay-weighted chunk products are more dots at S 16.
* (2, 2) mesh (``MESH_TOL``; head_dim 64 where the attention kernels run,
  their meta route taking Dh 64, 128 or 256 as the CUDA kernels do):
  dense train (1.0062), MoE prefill (1.001), MLA decode (0.9994) and the
  hybrid's prefill (1.0019) within 1%: GSPMD and DTensor split a few small
  products differently.  (The hybrid's train step, 1.331, is not held:
  under remat "nothing" XLA keeps the local attention's block products
  once in the forward, where the port's eager checkpoint runs them again
  in the backward.)  RWKV's decode within 12% (1.102): the
  ``wkv6`` kernel's note counts its state update k vᵀ as a product, which
  the reference's scan writes elementwise (no dot), and GSPMD partitions
  the small time-mix products of 64 rows a rank otherwise.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import SHAPES  # noqa: E402
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.kernels import flash_decode as fd_mod  # noqa: E402
from repro_torch.kernels import flash_prefill as fp_mod  # noqa: E402
from repro_torch.kernels import rglru_scan as rg_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wk_mod  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "deepseek-moe-16b", "mla": "deepseek-v2-236b",
            "hybrid": "recurrentgemma-2b", "rwkv": "rwkv6-7b"}
# one reduced dryrun_cell a family on (2, 2)
MESH_CELLS = {"dense": "train_4k", "moe": "prefill_32k", "mla": "decode_32k",
              "hybrid": "prefill_32k", "rwkv": "decode_32k"}
B, S, SLOTS = 2, 16, 128       # the one-device steps: batch, sequence, decode cache slots
# the (2, 2) cells' reduced configs: head_dim 64 where the attention kernels
# run (their meta route takes Dh 64, 128 or 256, as the CUDA kernels do)
OVERRIDES = {"dense": {"head_dim": 64}, "moe": {"head_dim": 64}, "mla": {},
             "hybrid": {"head_dim": 64}, "rwkv": {}}
DOT_TOL = {"dense": 0.01, "moe": 0.01, "mla": 0.01, "hybrid": 0.01, "rwkv": 0.01,
           "rwkv_train": 0.10}
MESH_TOL = {"dense": 0.01, "moe": 0.01, "mla": 0.01, "hybrid": 0.01, "rwkv": 0.12}

_REF_DRYRUN = textwrap.dedent("""
    import json
    import repro.launch.dryrun as D          # sets XLA_FLAGS before jax loads
    import jax, numpy as np
    from jax.sharding import Mesh, AxisType
    from repro.config import SHAPES
    from repro.configs import ALL_ARCHS, get_config
    out = {"specs": {}, "cells": {}, "dry": {}}
    if not CELLS:
        for a in ALL_ARCHS:
            for s, sh in SHAPES.items():
                out["specs"][a + "|" + s] = jax.tree.map(
                    lambda x: [list(x.shape), str(x.dtype)], D.input_specs(get_config(a), sh))
        for m in ("single", "multi", "both"):
            out["cells"][m] = [list(c) for c in D.cells(m)]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    D.make_production_mesh = lambda multi_pod=False: mesh
    for fam, (arch, shape) in CELLS.items():
        D.get_config = lambda a: get_config(a).reduced(**OVERRIDES[fam])
        r = D.dryrun_cell(arch, shape, False)
        out["dry"][fam] = {k: r[k] for k in ("mode", "params_total", "params_active",
                                             "params_embedding", "memory", "corrected")}
    print(json.dumps(out))
""")

_REF_HLO = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.hlo_cost import analyze
    from repro.models import build_model
    from repro.training import AdamWConfig, init_opt_state, make_train_step
    out = {}
    for fam, arch in FAMILIES.items():
        cfg = get_config(arch).reduced()
        m = build_model(cfg)
        p = m.init(jax.random.PRNGKey(0))
        if cfg.input_mode == "tokens":
            batch = {"tokens": jnp.zeros((B, S + 1), jnp.int32)}
            inputs, tok = jnp.zeros((B, S), jnp.int32), jnp.zeros((B,), jnp.int32)
        else:
            batch = {"embeddings": jnp.zeros((B, S, cfg.d_model)),
                     "labels": jnp.zeros((B, S), jnp.int32)}
            inputs, tok = jnp.zeros((B, S, cfg.d_model)), jnp.zeros((B, cfg.d_model))
        cache = m.init_cache(B, SLOTS)
        steps = {
            "train": (make_train_step(m, AdamWConfig()), (p, init_opt_state(p), batch)),
            "prefill": (m.prefill, (p, inputs)),
            "decode": (m.decode_step, (p, tok, cache, S)),
        }
        for kind, (fn, args) in steps.items():
            hlo = jax.jit(fn).lower(*args).compile().as_text()
            out[fam + "|" + kind] = analyze(hlo)["dot_flops"]
    print(json.dumps(out))
""")


def _spawn(code, env=None, **consts):
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **(env or {}))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", head + code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _collect(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference's readings and the port's CLI run, all started at
    once before the first test; the port's own counts are taken meanwhile
    (the tests that read a subprocess come after those that need none)."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = {
        "specs": _spawn(_REF_DRYRUN, CELLS={}, OVERRIDES=OVERRIDES),
        **{f"dry:{fam}": _spawn(_REF_DRYRUN, CELLS={fam: (FAMILIES[fam], shape)},
                                OVERRIDES=OVERRIDES)
           for fam, shape in MESH_CELLS.items()},
        **{f"hlo:{fam}": _spawn(_REF_HLO, FAMILIES={fam: arch}, B=B, S=S, SLOTS=SLOTS)
           for fam, arch in FAMILIES.items()},
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b",
             "--shape", "decode_32k", "--out-dir", str(d)],
            env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
    }
    yield {"procs": procs, "dir": d, "got": {}}
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _result(ref, name):
    got = ref["got"]
    if name not in got:
        p = ref["procs"][name]
        if name == "cli":
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            got[name] = out
        else:
            got[name] = _collect(p)
    return got[name]


# ---------------------------------------------------------------------------
# the kernels' meta route and products
# ---------------------------------------------------------------------------


def _attn_inputs(dev, bsz=2, sq=5, hq=8, hkv=2, s=48, dh=64):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(bsz, sq, hq, dh, generator=g).to(torch.bfloat16)
    k = torch.randn(bsz, s, hkv, dh, generator=g).to(torch.bfloat16)
    v = torch.randn(bsz, s, hkv, dh, generator=g).to(torch.bfloat16)
    kpos = torch.arange(s, dtype=torch.int32)
    return [t.to(dev) for t in (q, k, v, kpos)]


def _scan_inputs(dev, bsz=2, s=6, w=32, h=2, dh=32):
    g = torch.Generator().manual_seed(1)
    la = -torch.rand(bsz, s, w, generator=g)
    rkvw = [torch.randn(bsz, s, h, dh, generator=g) for _ in range(3)]
    rkvw.append(torch.rand(bsz, s, h, dh, generator=g))
    u, s0 = torch.randn(h, dh, generator=g), torch.randn(bsz, h, dh, dh, generator=g)
    return ([t.to(dev) for t in (la, torch.randn(bsz, s, w, generator=g),
                                 torch.randn(bsz, w, generator=g))],
            [t.to(dev) for t in (*rkvw, u, s0)])


def _calls(dev):
    """(name, thunk) of every kernel call on the dry run's path, on ``dev``."""
    q, k, v, kp = _attn_inputs(dev)
    (la, bb, h0), wk = _scan_inputs(dev)
    (la1, bb1, h01), wk1 = _scan_inputs(dev, s=1)
    dy = torch.ones_like(wk[0])
    return [
        ("flash_decode", lambda: fd_mod.flash_decode(q[:, 0].contiguous(), k, v, kp, 40,
                                                     scale=0.125)),
        ("flash_decode_partials", lambda: fd_mod.flash_decode_partials(
            q[:, 0].contiguous(), k, v, kp, 40, scale=0.125, window=16)),
        ("flash_prefill", lambda: fp_mod.flash_prefill(q, k, v, kp, 40, scale=0.125)),
        ("rglru_scan", lambda: rg_mod.rglru_scan(la, bb, h0)),
        ("rglru_scan_step", lambda: rg_mod.rglru_scan(la1, bb1, h01)),
        ("wkv6", lambda: wk_mod.wkv6(*wk)),
        ("wkv6_step", lambda: wk_mod.wkv6(*wk1)),
        ("wkv6_backward", lambda: wk_mod.wkv6_backward(*wk, dy)),
    ]


def _flat(x):
    return [x] if isinstance(x, torch.Tensor) else [t for y in x for t in _flat(y)]


@pytest.mark.parametrize("name", [n for n, _ in _calls("cpu")])
def test_meta_route_shapes_match_plain(name):
    """On meta every kernel of the path returns empty meta outputs of the
    plain version's shapes and dtypes and counts no launch."""
    plain = dict(_calls("cpu"))[name]()
    counters = (fd_mod.flash_decode.launches, fd_mod.flash_decode_partials.launches,
                fp_mod.flash_prefill.launches, rg_mod.rglru_scan.launches,
                wk_mod.wkv6.launches, wk_mod.wkv6.backward_launches)
    meta = dict(_calls("meta"))[name]()
    assert [(t.device.type, t.shape, t.dtype) for t in _flat(meta)] == [
        ("meta", t.shape, t.dtype) for t in _flat(plain)]
    assert counters == (fd_mod.flash_decode.launches, fd_mod.flash_decode_partials.launches,
                        fp_mod.flash_prefill.launches, rg_mod.rglru_scan.launches,
                        wk_mod.wkv6.launches, wk_mod.wkv6.backward_launches)


def test_products_match_plain_dots_and_hand_counts():
    """Attention: ``_products`` equals the dot_flops the mode reads from the
    plain version; the scans: the hand count of the step form's state
    products.  The meta route notes exactly ``_products`` once."""
    q, k, v, kp = _attn_inputs("cpu")
    (la, _, _), wk = _scan_inputs("cpu")
    bsz, sq, hq, dh = q.shape
    s = k.shape[1]
    plain = {
        "flash_decode": lambda: fd_mod.flash_decode_plain(q[:, 0], k, v, kp, 40, scale=0.1),
        "flash_decode_partials": lambda: fd_mod.flash_decode_partials_plain(
            q[:, 0], k, v, kp, 40, scale=0.1),
        "flash_prefill": lambda: fp_mod.flash_prefill_plain(q, k, v, kp, 40, scale=0.1),
    }
    want = {"flash_decode": 4 * bsz * hq * s * dh, "flash_decode_partials": 4 * bsz * hq * s * dh,
            "flash_prefill": 4 * bsz * sq * hq * s * dh}
    for name, fn in plain.items():
        _, cost = op_cost.analyze(fn)
        assert cost["dot_flops"] == want[name], name
    assert fd_mod._products(q[:, 0].shape, k.shape) == want["flash_decode"]
    assert fp_mod._products(q.shape, k.shape) == want["flash_prefill"]
    b2, s2, w2 = la.shape
    assert rg_mod._products(la.shape) == 2 * b2 * s2 * w2            # a·h + b a lane a step
    r = wk[0]
    rb, rs, rh, rd = r.shape
    assert wk_mod._products(r.shape) == 2 * 2 * rb * rs * rh * rd * rd   # Sᵀr and k vᵀ
    assert wk_mod._backward_products(r.shape) == 6 * 2 * rb * rs * rh * rd * rd
    # the plain wkv6 computes only the read-out as a product
    _, cost = op_cost.analyze(lambda: wk_mod.wkv6_plain(*wk))
    assert cost["dot_flops"] == 2 * rb * rs * rh * rd * rd
    expect = {"flash_decode": want["flash_decode"], "flash_decode_partials": want["flash_decode"],
              "flash_prefill": want["flash_prefill"], "rglru_scan": rg_mod._products(la.shape),
              "rglru_scan_step": 2 * b2 * w2, "wkv6": wk_mod._products(r.shape),
              "wkv6_step": wk_mod._products((rb, 1, rh, rd)),
              "wkv6_backward": wk_mod._backward_products(r.shape)}
    for name, fn in _calls("meta"):
        _, cost = op_cost.analyze(fn)
        note = name.replace("_step", "")
        assert cost["kernel_notes"] == {note: 1}, name
        assert cost["dot_flops"] == expect[name], name


# ---------------------------------------------------------------------------
# the counting mode on a fake mesh
# ---------------------------------------------------------------------------


def _meta_dt(mesh, shape, placements, dtype=torch.bfloat16):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh,
                              placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def test_counts_are_local_on_a_fake_mesh():
    """A (256, 256) @ (256, 256) product, rows over "data" and columns over
    "model" of a (2, 2) fake mesh: the mode reads the local (128, 256) @
    (256, 128) product, not the global one FlopCounterMode reads."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        x = _meta_dt(mesh, (256, 256), [Shard(0), Replicate()])
        w = _meta_dt(mesh, (256, 256), [Replicate(), Shard(1)])
        y, cost = op_cost.analyze(lambda: x @ w)
        with FlopCounterMode(display=False) as fc:
            x @ w
    assert y.to_local().shape == (128, 128)
    assert cost["dot_flops"] == 2 * 128 * 128 * 256
    assert fc.get_total_flops() == 2 * 256 ** 3          # the global count
    assert cost["collective_counts"] == {}


def test_ring_accounting_by_kind():
    """Every collective kind on a (4,) fake mesh against the hand count of
    the reference's ring accounting: all-gather (n-1)/n·R, reduce-scatter
    (n-1)·R, all-reduce 2(n-1)/n·R, all-to-all (n-1)/n·R, permute R."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard
    n = 4
    with dryrun.fake_world(n):
        mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("model",))
        x = _meta_dt(mesh, (64, 32), [Shard(0)], torch.float32)      # 16 x 32 a rank
        p = _meta_dt(mesh, (64, 32), [Partial()], torch.float32)     # 64 x 32 a rank
        cases = {
            "all-gather": (lambda: x.redistribute(mesh, [Replicate()]), 64 * 32 * 4),
            "reduce-scatter": (lambda: p.redistribute(mesh, [Shard(0)]), 16 * 32 * 4),
            "all-reduce": (lambda: p.redistribute(mesh, [Replicate()]), 64 * 32 * 4),
            "all-to-all": (lambda: funcol.all_to_all_single(
                torch.empty(64, 32, device="meta"), None, None, mesh), 64 * 32 * 4),
            "collective-permute": (lambda: dist.broadcast(
                torch.empty(8, 8, device="meta"), 0), 8 * 8 * 4),
        }
        for kind, (fn, r) in cases.items():
            _, cost = op_cost.analyze(fn)
            assert cost["collective_counts"] == {kind: 1}, kind
            assert cost["records"] == [(kind, r, n)], kind
            assert cost["collective_bytes"][kind] == pytest.approx(
                op_cost.ring_bytes(kind, r, n)), kind
    assert op_cost.ring_bytes("all-gather", 400, 4) == 300
    assert op_cost.ring_bytes("reduce-scatter", 100, 4) == 300
    assert op_cost.ring_bytes("all-reduce", 400, 4) == 600
    assert op_cost.ring_bytes("all-to-all", 400, 4) == 300
    assert op_cost.ring_bytes("collective-permute", 400, 4) == 400
    got = dryrun.collective_bytes([("all-gather", 400, 4), ("all-reduce", 400, 4)])
    assert got["bytes"]["all-gather"] == 300 and got["counts"]["all-reduce"] == 1
    assert got["total_bytes"] == 900


def test_repeat_multiplies_and_records_trips():
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 4, device="meta")

    def step():
        with op_cost.repeat("grad_accum", 3):
            a @ b
        a @ b
    _, cost = op_cost.analyze(step)
    assert cost["dot_flops"] == 4 * 2 * 8 * 4 * 16
    assert cost["while_trip_counts"] == {"grad_accum": 3}


# ---------------------------------------------------------------------------
# (2, 2): dryrun_cell against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_cell_on_2x2_matches_reference(ref, monkeypatch, family):
    """One reduced cell a family on a (2, 2) fake mesh: mode, parameter
    counts, argument and alias bytes equal to the reference's on a (2, 2)
    mesh of host devices; dot_flops_per_device within MESH_TOL."""
    from torch.distributed.device_mesh import init_device_mesh
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced(**OVERRIDES[family]))
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod=False, device="cpu":
                        init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")))
    monkeypatch.setitem(dryrun.WORLD, False, 4)
    got = dryrun.dryrun_cell(FAMILIES[family], MESH_CELLS[family], False)
    want = _result(ref, f"dry:{family}")["dry"][family]
    for key in ("mode", "params_total", "params_active", "params_embedding"):
        assert got[key] == want[key], key
    for key in ("argument_bytes", "alias_bytes"):
        assert got["memory"][key] == want["memory"][key], key
    gf, wf = got["corrected"]["dot_flops_per_device"], want["corrected"]["dot_flops_per_device"]
    assert abs(gf / wf - 1) <= MESH_TOL[family], (gf, wf)
    import torch.distributed as dist
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# one device: dot_flops against hlo_cost
# ---------------------------------------------------------------------------


def _port_steps(arch):
    cfg = get_config(arch).reduced()
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.zeros(B, S + 1, dtype=torch.int32)}
        inputs, tok = torch.zeros(B, S, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)
    else:
        batch = {"embeddings": torch.zeros(B, S, cfg.d_model),
                 "labels": torch.zeros(B, S, dtype=torch.int32)}
        inputs, tok = torch.zeros(B, S, cfg.d_model), torch.zeros(B, cfg.d_model)
    return {
        "train": lambda: make_train_step(m, AdamWConfig())(p, init_opt_state(p), batch),
        "prefill": lambda: m.prefill(p, inputs),
        "decode": lambda: m.decode_step(p, tok, m.init_cache(B, SLOTS), S),
    }


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_device_dot_flops_match_hlo_cost(ref, family):
    """Each family's reduced train, prefill and decode step on one device:
    the mode's dot_flops against ``hlo_cost``'s of the compiled reference
    step, within DOT_TOL (module docstring)."""
    got = {}
    for kind, fn in _port_steps(FAMILIES[family]).items():
        if kind == "decode":
            with torch.no_grad():
                got[kind] = op_cost.analyze(fn)[1]["dot_flops"]
        else:
            got[kind] = op_cost.analyze(fn)[1]["dot_flops"]
    want = _result(ref, f"hlo:{family}")
    cfg = get_config(FAMILIES[family]).reduced()
    window = cfg.attn_window
    for kind, flops in got.items():
        tol = DOT_TOL.get(f"{family}_{kind}", DOT_TOL[family])
        w = want[f"{family}|{kind}"]
        if kind == "decode" and window and window < SLOTS:
            # the reference pads its ring of `window` slots to a block of
            # 128 keys (_gqa_flash's block of max(128, slots)) and takes
            # QKᵀ and PV over the empty ones too
            n_attn = cfg.layer_kinds().count("attention")
            flops += n_attn * 4 * B * cfg.num_heads * (128 - window) * cfg.head_dim
        assert w > 0 and abs(flops / w - 1) <= tol, (family, kind, flops, w)


# ---------------------------------------------------------------------------
# input_specs and cells
# ---------------------------------------------------------------------------


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return [list(tree.shape), str(tree.dtype).replace("torch.", "")]


def test_input_specs_and_cells_match_reference(ref):
    want = _result(ref, "specs")
    got = {a + "|" + s: _spec_tree(dryrun.input_specs(get_config(a), sh))
           for a in ALL_ARCHS for s, sh in SHAPES.items()}
    assert len(got) == 13 * 4
    assert got == want["specs"]
    for mode in ("single", "multi", "both"):
        assert [list(c) for c in dryrun.cells(mode)] == want["cells"][mode]
    assert ASSIGNED_ARCHS == tuple(ALL_ARCHS[:10])
    assert all(t.device.type == "meta" for a in ALL_ARCHS for s in SHAPES.values()
               for t in _leaf_list(dryrun.input_specs(get_config(a), s)))


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_list(v)]
    return [tree]



def test_cli_writes_a_full_size_cell(ref):
    """``--arch qwen1.5-0.5b --shape decode_32k`` at full size on 16x16
    writes its JSON under the given results dir."""
    _result(ref, "cli")
    path = ref["dir"] / "qwen1.5-0.5b__decode_32k__16x16.json"
    res = json.loads(path.read_text())
    assert res["mesh"] == "16x16" and res["mode"] == "serve_tp" and res["kind"] == "decode"
    cfg = get_config("qwen1.5-0.5b")
    # per device: 8 of the 128 rows, one of the 16 heads over 32768 slots a layer
    attn = cfg.num_layers * 4 * 8 * 1 * 32_768 * cfg.head_dim
    assert res["kernel_notes"] == {"flash_decode": cfg.num_layers}
    assert res["corrected"]["dot_flops_per_device"] > attn
    assert res["collectives"]["counts"]["all-gather"] >= 1   # the embedding, gathered whole
    assert math.isfinite(res["memory"]["peak_estimate_bytes"])
