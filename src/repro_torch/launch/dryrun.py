"""Multi-pod dry run of the port: every (architecture x input shape) traced
on the production meshes, and the per-device roofline terms read off the
trace (counterpart of ``repro.launch.dryrun``).

For each cell this:
  1. builds the model on the ``meta`` device with the reference's settings
     and the sharding rules for the mode,
  2. joins a fake process group (backend "fake": no communication, every
     collective a no-op) of 256 or 512 ranks and builds the production
     mesh over it, as rank 0,
  3. places parameters, optimizer state, cache and inputs on it by
     ``param_pspecs`` / ``opt_pspecs`` / ``cache_pspecs`` / ``data_pspecs``
     (``elastic.place_meta``: DTensors whose locals are ``meta`` tensors of
     rank 0's shard shapes) — success proves the specs divide,
  4. runs the right step (train micro-batch + AdamW / prefill / restore
     chunk / append decode / decode) under ``use_mesh`` and
     ``op_cost.analyze``: each rank's local ops, its collectives and its
     hand-written kernels (their meta route) are counted, per device,
  5. writes one JSON per cell under ``build/dryrun/``.

It touches no device: no CUDA and no arithmetic, only ``meta`` shapes (and
a few host integers for positions).

Run one cell:   PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape decode_32k
Run the sweep:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both] [--jobs N]
(the sweep runs one subprocess per cell so no process group outlives its
cell; ``--jobs`` runs that many at once: a 2x16x16 cell spends minutes in
DTensor's sharding propagation, which expands every op's strategies over
three mesh dims)

The result keeps the reference's keys where the quantity is the same:
``arch``, ``shape``, ``mesh``, ``mode``, ``kind``, ``memory`` (argument,
output, alias bytes summed over rank 0's local shards; ``temp_bytes`` the
peak of the step's live local intermediates, ``op_cost``'s; the peak
estimate their sum, as the reference's), ``collectives`` (the ring
accounting of every collective the trace ran, each counted once),
``corrected`` (``dot_flops_per_device``, ``collective_bytes``,
``collective_total_bytes``, ``while_trip_counts``: the trace's counts with
the train step's one micro-batch multiplied by its ``grad_accum``),
``params_total`` / ``active`` / ``embedding``, and ``bytes_per_device``
(``op_cost``'s unfused ``bytes_accessed``).  ``lower_s`` / ``compile_s``
become ``place_s`` / ``trace_s``; ``kernel_notes`` counts the hand-written
kernels' calls.  Left out, having no counterpart: ``flops_per_device``
(XLA's count of every op, elementwise included) and ``hlo``.

The collectives are DTensor's choices, not GSPMD's: on a CPU process group
(the fake one here) DTensor moves a Shard to another Shard by all-gather
and chunk, where an NCCL mesh runs an all-to-all.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig, supports_shape
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.distributed import sharding as shr
from repro_torch.distributed.constraints import _as_dtensor, use_mesh
from repro_torch.distributed.elastic import place_meta
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.model import _leaves
from repro_torch.training import AdamWConfig, adamw_update, init_opt_state
from repro_torch.training.train_step import lm_loss, tree_like, value_and_grad

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
RESULTS_DIR = os.path.join(SRC, "..", "build", "dryrun")

# Serving MoE dispatch uses capacity-factor routing in the traced step, as
# in the reference's compiled plan (restoration-equality paths on real runs
# are dropless).
_MOE_GROUPS = {"train": 16, "prefill": 16, "decode": 1}
WORLD = {False: 256, True: 512}   # ranks of the production meshes (16x16, 2x16x16)
RESTORE_CHUNK = 2048           # the restore-chunk step's chunk (the reference's C)
APPEND_WINDOW = 64             # the append decode's tail (the reference's W)


# ---------------------------------------------------------------------------
# input_specs: meta stand-ins for every model input
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors of the reference's input shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.input_mode == "tokens":
            return {"batch": {"tokens": _meta((b, s + 1), torch.int32)}}
        return {"batch": {"embeddings": _meta((b, s, cfg.d_model), torch.bfloat16),
                          "labels": _meta((b, s), torch.int32)}}
    if shape.kind == "prefill":
        if cfg.input_mode == "tokens":
            return {"inputs": _meta((b, s), torch.int32)}
        return {"inputs": _meta((b, s, cfg.d_model), torch.bfloat16)}
    # decode: one new token against a seq_len cache
    if cfg.input_mode == "tokens":
        tok = _meta((b,), torch.int32)
    else:
        tok = _meta((b, cfg.d_model), torch.bfloat16)
    return {"tokens": tok, "pos": _meta((), torch.int32)}


# ---------------------------------------------------------------------------
# collective bytes
# ---------------------------------------------------------------------------


def collective_bytes(records) -> dict:
    """Per-device bytes moved over links, by collective kind, from
    ``records`` of (kind, result bytes R, group size n), each collective
    once.  Ring-algorithm accounting (``op_cost.ring_bytes``):
      all-gather R bytes result, group n: (n-1)/n · R
      reduce-scatter result R: (n-1) · R     (operand is n·R per device)
      all-reduce result R: 2(n-1)/n · R
      all-to-all result R: (n-1)/n · R
      collective-permute result R: R
    """
    out = {k: 0.0 for k in op_cost.KINDS}
    counts = {k: 0 for k in op_cost.KINDS}
    for kind, r, n in records:
        out[kind] += op_cost.ring_bytes(kind, r, n)
        counts[kind] += 1
    return {"bytes": out, "counts": counts, "total_bytes": sum(out.values())}


# ---------------------------------------------------------------------------
# per-cell dry run
# ---------------------------------------------------------------------------


def _bytes(*trees) -> int:
    """Bytes of every tensor leaf of ``trees``, each DTensor's local shard."""
    from torch.distributed.tensor import DTensor
    total = 0
    for tree in trees:
        for t in _leaves(tree):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if isinstance(t, DTensor) else t
                total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process rank 0), destroyed
    on exit.  Refuses to stack on an existing group."""
    import torch.distributed as dist
    # the module registers the "fake" backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool, mode_override=None,
                decode_append: bool = False, restore_chunk: bool = False) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": "full-attn @500k"}
    with fake_world(WORLD[multi_pod]):
        return _trace_cell(cfg, arch, shape, multi_pod, mode_override, decode_append,
                           restore_chunk)


def _trace_cell(cfg, arch, shape, multi_pod, mode_override, decode_append, restore_chunk):
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    mode = mode_override or shr.choose_mode(cfg, shape)
    is_train = shape.kind == "train"
    model = build_model(
        cfg,
        param_dtype=torch.float32 if is_train else torch.bfloat16,
        compute_dtype=torch.bfloat16,
        backend="flash",
        device="meta",
        remat_policy="nothing" if is_train else "none",
        moe_groups=_MOE_GROUPS[shape.kind],
        moe_dropless=False)
    b, s = shape.global_batch, shape.seq_len

    def specs_pos():
        # a position: a host int to the port's entry points, an int32 scalar
        # argument to the reference's, counted in argument_bytes where the
        # step reads it (jit drops an argument nothing reads: RWKV's)
        used = "attention" in cfg.layer_kinds() or cfg.position == "sinusoidal"
        return _meta((), torch.int32) if used else {}
    t0 = time.time()
    params = place_meta(model.param_specs(), shr.param_pspecs(model, mode), mesh)
    specs = input_specs(cfg, shape)

    def cache_of(batch, seq):
        return place_meta(model.init_cache(batch, seq),
                          shr.cache_pspecs(model, mesh, batch, seq), mesh)

    def data(tree, kind, batch):
        return place_meta(tree, shr.data_pspecs(cfg, mesh, kind, batch), mesh)

    if is_train:
        # microbatch = one sequence per (pod×data) batch shard, as the
        # reference: one is traced and counted accum times
        shards = 1
        for a in shr.batch_axes(mesh):
            shards *= mesh.size(mesh.mesh_dim_names.index(a))
        accum = max(1, b // shards)
        opt = place_meta(init_opt_state(model.param_specs()),
                         shr.opt_pspecs(model, mode), mesh)
        batch = data(specs["batch"], "train", b)
        micro_shape = ShapeConfig(shape.name, shape.kind, s, b // accum)
        micro = data(input_specs(cfg, micro_shape)["batch"], "train", b // accum)
        opt_cfg = AdamWConfig()

        def step():
            with op_cost.repeat("grad_accum", accum):
                (loss, extras), grads = value_and_grad(lm_loss, model, params, micro)
                grads = [g.float() for g in _leaves(grads)]
            grads = tree_like(params, [g / accum for g in grads])
            p, o, om = adamw_update(opt_cfg, params, grads, opt)
            return p, o, {"loss": loss, **extras, **om}
        args, donated = (params, opt, batch), (params, opt)
    elif shape.kind == "prefill" and not restore_chunk:
        inputs = data(specs["inputs"], "prefill", b)
        cache_specs = shr.cache_pspecs(model, mesh, b, s)

        def step():
            logits, cache = model.prefill(params, inputs)
            return logits, _to_specs(cache, cache_specs, mesh)
        args, donated = (params, inputs), ()
    elif shape.kind == "prefill":
        # the paper's step: recompute-pointer chunk prefill against a
        # restored prefix cache (token-wise restoration at scale)
        cache = cache_of(b, s)
        if cfg.input_mode == "tokens":
            chunk = _meta((b, RESTORE_CHUNK), torch.int32)
        else:
            chunk = _meta((b, RESTORE_CHUNK, cfg.d_model), torch.bfloat16)
        chunk = data(chunk, "prefill", b)

        def step():
            with torch.no_grad():
                return model.prefill_chunk(params, chunk, cache, s - RESTORE_CHUNK)
        args, donated = (params, chunk, cache, specs_pos()), (cache,)
    elif decode_append and cfg.is_uniform:
        # read-only cache + small append tail
        cache = cache_of(b, s)
        tail = cache_of(b, APPEND_WINDOW)
        tokens = data(specs["tokens"], "decode", b)

        def step():
            with torch.no_grad():
                return model.decode_step_append(params, tokens, cache, tail, 0, s)
        args, donated = (params, tokens, cache, tail, specs_pos(), specs_pos()), (tail,)
    else:
        cache = cache_of(b, s)
        tokens = data(specs["tokens"], "decode", b)

        def step():
            with torch.no_grad():
                return model.decode_step(params, tokens, cache, s - 1)
        args, donated = (params, tokens, cache, specs_pos()), (cache,)
    t_place = time.time() - t0
    t0 = time.time()
    with use_mesh(mesh):
        out, cost = op_cost.analyze(step)
    t_trace = time.time() - t0

    arg_b, out_b, temp_b = _bytes(*args), _bytes(out), cost["temp_bytes"]
    pc = cfg.param_counts()
    return {
        "arch": arch, "shape": shape.name,
        "mesh": mesh_name(multi_pod),
        "mode": mode, "kind": shape.kind,
        "place_s": round(t_place, 2), "trace_s": round(t_trace, 2),
        "bytes_per_device": cost["bytes_accessed"],
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": _bytes(*donated),
            "peak_estimate_bytes": arg_b + out_b + temp_b,
        },
        "collectives": collective_bytes(cost["records"]),
        "corrected": {
            "dot_flops_per_device": cost["dot_flops"],
            "collective_bytes": cost["collective_bytes"],
            "collective_total_bytes": cost["collective_total_bytes"],
            "while_trip_counts": cost["while_trip_counts"],
        },
        "kernel_notes": cost["kernel_notes"],
        "params_total": pc["total"], "params_active": pc["active"],
        "params_embedding": pc["embedding"],
    }


def _to_specs(cache: dict, specs: dict, mesh) -> dict:
    """The prefill's cache placed as ``cache_pspecs`` says (the reference's
    ``out_shardings``)."""
    return {f: _as_dtensor(t, mesh).redistribute(mesh, shr.to_placements(mesh, specs[f]))
            for f, t in cache.items()}


def cells(multi_pod_mode: str):
    pods = {"single": [False], "multi": [True], "both": [False, True]}[multi_pod_mode]
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            for mp in pods:
                yield arch, shape_name, mp, supports_shape(cfg, shape)


def _result_path(out_dir: str, arch: str, shape_name: str, multi_pod: bool) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name(multi_pod)}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Trace every (architecture x input shape) of the port on the "
                    "production meshes (16x16, 2x16x16) over a fake process group and "
                    "write per-device FLOPs, collective bytes and memory as JSON. "
                    "Touches no device: no CUDA and no arithmetic, only meta shapes.")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--mode", default=None, help="override sharding mode")
    ap.add_argument("--out-dir", default=RESULTS_DIR,
                    help="where the JSON files go (default: build/dryrun)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells of the sweep run at once (each its own process)")
    args = ap.parse_args(argv)

    if args.all:
        t_all = time.time()
        todo = []
        for arch, shape_name, mp, ok in cells(args.multi_pod):
            path = _result_path(args.out_dir, arch, shape_name, mp)
            if os.path.exists(path) and not args.force:
                print(f"[cached] {path}")
                continue
            if not ok:
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape_name, "mesh": mesh_name(mp),
                               "skipped": "full-attn @500k"}, f, indent=1)
                print(f"[skip]   {arch} × {shape_name} (full-attn @500k)")
                continue
            todo.append((arch, shape_name, mp))

        def run(cell):
            arch, shape_name, mp = cell
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--multi-pod", "multi" if mp else "single", "--out-dir", args.out_dir]
            if args.mode:
                cmd += ["--mode", args.mode]
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True,
                               env={**os.environ, "PYTHONPATH": SRC})
            print(f"[run]    {arch} × {shape_name} × {mesh_name(mp)}: "
                  f"{'ok' if r.returncode == 0 else 'FAILED'}, {time.time() - t0:.1f} s",
                  flush=True)
            return cell, r
        from concurrent.futures import ThreadPoolExecutor
        failures = []
        with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
            for (arch, shape_name, mp), r in pool.map(run, todo):
                if r.returncode != 0:
                    failures.append((arch, shape_name, mp, r.stderr[-2000:]))
                    print(r.stderr[-2000:])
        print(f"\nhost seconds: {time.time() - t_all:.1f}")
        if failures:
            print(f"\n{len(failures)} FAILURES:")
            for a, s, mp, _err in failures:
                print(f"  {a} × {s} × {'multi' if mp else 'single'}")
            return 1
        print("\nall cells traced OK")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    mp = args.multi_pod == "multi"
    res = dryrun_cell(args.arch, args.shape, mp, mode_override=args.mode)
    path = _result_path(args.out_dir, args.arch, args.shape, mp)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    if "memory" in res:
        print(f"\nmemory: {res['memory']}")
        print(f"dot flops/device: {res['corrected']['dot_flops_per_device']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
