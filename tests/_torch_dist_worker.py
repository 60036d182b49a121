"""The ranks of ``tests/test_torch_distributed.py``: one spawned process
per rank, gloo over a file rendezvous, one intra-op thread each.  Every
rank runs every job of the pickled job file in order (their collectives
must meet) and writes what it computed to ``rank<r>.pkl`` beside it; the
test compares those with the reference.  Imports torch and the port only.
"""
import pickle
import traceback
from pathlib import Path

import torch


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _leaves(tree):
    from repro_torch.models.model import _leaves as leaves
    return list(leaves(tree))


def _place(tree, specs, mesh):
    from repro_torch.distributed.elastic import replace_on_mesh
    return replace_on_mesh(tree, specs, mesh)


def _check_placed(leaf, spec, mesh):
    from repro_torch.distributed.sharding import to_placements
    if list(leaf.placements) != to_placements(mesh, spec):
        raise AssertionError(f"{leaf.placements} placed, {spec} specified")


def train_and_decode(job, mesh):
    """One sharded train step and one sharded decode step on (2, 2)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    cfg = get_config("qwen1.5-0.5b").reduced(**job["overrides"])
    out = {}
    for remat in job["remat"]:
        m = build_model(cfg, device="cpu", remat_policy=remat)
        params = _place(params_from_jax(job["params"], device="cpu"),
                        shr.param_pspecs(m, "train"), mesh)
        opt = init_opt_state(params)
        ospecs = shr.opt_pspecs(m, "train")
        specs = {}
        shr._map_with_path(lambda path, sp: specs.__setitem__(path, sp), ospecs.m)
        shr._map_with_path(lambda path, leaf: _check_placed(leaf, specs[path], mesh), opt.m)
        batch = _place({"tokens": torch.from_numpy(job["tokens"])},
                       shr.data_pspecs(cfg, mesh, "train", job["tokens"].shape[0]), mesh)
        step = make_train_step(m, AdamWConfig(total_steps=10))
        with use_mesh(mesh):
            p_sh, _, met = step(params, opt, batch)
        out[f"train_{remat}"] = {"leaves": [_np(t) for t in _leaves(p_sh)],
                                 "loss": float(_np(met["loss"]))}
    # decode from the reference's cache, with the step's ORIGINAL weights
    m = build_model(cfg, device="cpu")
    params = _place(params_from_jax(job["params"], device="cpu"),
                    shr.param_pspecs(m, "train"), mesh)
    b, s = job["dec_cache"]["k"].shape[1:3]
    cache = _place({f: torch.from_numpy(a) for f, a in job["dec_cache"].items()},
                   shr.cache_pspecs(m, mesh, b, s), mesh)
    tok = _place(torch.from_numpy(job["dec_tok"]),
                 shr.data_pspecs(cfg, mesh, "decode", b), mesh)
    with use_mesh(mesh), torch.no_grad():
        logits, _ = m.decode_step(params, tok, cache, job["dec_pos"])
    out["decode_logits"] = _np(logits)
    out["k_spec"] = tuple(shr.cache_pspecs(m, mesh, b, s)["k"])
    return out


def append_decode(job, mesh):
    """Greedy steps of ``decode_step_append`` over a sequence-sharded cache
    on (1, 4); counts the LSE branch's calls."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.models import model as model_mod
    cfg = get_config("qwen3-8b").reduced()
    m = build_model(cfg, device="cpu")
    params = params_from_jax(job["params"], device="cpu")
    b, s = job["cache"]["k"].shape[1:3]
    specs = shr.cache_pspecs(m, mesh, b, s)
    cache = _place({f: torch.from_numpy(a) for f, a in job["cache"].items()}, specs, mesh)
    tail = m.init_tail(b, job["window"])
    calls = []
    lse = model_mod.lse_decode_attention

    def counted(*a, **kw):
        calls.append(1)
        return lse(*a, **kw)
    model_mod.lse_decode_attention = counted
    try:
        tok, logits, toks = torch.from_numpy(job["tok0"]), [], []
        with use_mesh(mesh), torch.no_grad():
            for i in range(job["steps"]):
                lg, tail = m.decode_step_append(params, tok, cache, tail, i, job["prefix"] + i)
                logits.append(_np(lg))
                tok = lg.argmax(-1).to(torch.int32)
                toks.append(tok.numpy().copy())
    finally:
        model_mod.lse_decode_attention = lse
    return {"logits": logits, "tokens": toks, "tail": {f: _np(t) for f, t in tail.items()},
            "lse_calls": len(calls), "k_spec": tuple(specs["k"])}


def lse_cases(job, mesh):
    """``lse_decode_attention`` alone, k/v/kpos sharded over "model"."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.collectives import lse_decode_attention
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.distributed.sharding import to_placements
    out = {}
    for name, c in job.items():
        kv = to_placements(mesh, (None, "model", None, None))
        k = distribute_tensor(torch.from_numpy(c["k"]), mesh, kv)
        v = distribute_tensor(torch.from_numpy(c["v"]), mesh, kv)
        kpos = distribute_tensor(torch.from_numpy(c["kpos"]), mesh,
                                 to_placements(mesh, ("model",)))
        tail = None if c.get("tk") is None else tuple(
            torch.from_numpy(c[f]) for f in ("tk", "tv", "tkp"))
        with use_mesh(mesh):
            o = lse_decode_attention(torch.from_numpy(c["q"]), k, v, kpos, c["q_pos"],
                                     scale=c["scale"], window=c["window"], tail=tail)
        out[name] = _np(o)
    return out


KERNEL_SITES = (("repro_torch.models.attention", "flash_decode"),
                ("repro_torch.models.attention", "flash_prefill"),
                ("repro_torch.distributed.collectives", "flash_decode_partials"),
                ("repro_torch.models.rglru", "rglru_scan_grad"),
                ("repro_torch.models.rwkv6", "wkv6"))


def _spied(calls):
    """Patch every kernel call site of the models with a spy recording, per
    wrapper, whether each call got a DTensor; returns the undo."""
    import importlib

    from torch.distributed.tensor import DTensor
    undo = []
    for mod_name, name in KERNEL_SITES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.setdefault(_name, []).append(
                any(isinstance(t, DTensor) for t in list(a) + list(kw.values())))
            return _fn(*a, **kw)
        setattr(mod, name, spy)
        undo.append((mod, name, fn))
    return lambda: [setattr(m, n, f) for m, n, f in undo]


def sharded_decode(job, mesh):
    """One ``decode_step`` a case on (1, 4) against the same step in one
    process (plain tensors): qwen3-8b with 4 kv-heads (the cache's heads over
    "model"), recurrentgemma-2b (MQA: the cache along its sequence, the
    RG-LRU state along its width) and rwkv6-7b (the wkv state's heads), each
    from a prefix prefilled in one process.  Every kernel wrapper is spied."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.models import build_model
    from repro_torch.models.kvcache import grow_cache
    out = {}
    for name, c in job.items():
        cfg = get_config(c["arch"]).reduced(**c["overrides"])
        m = build_model(cfg, device="cpu")
        params = m.init(torch.Generator().manual_seed(0))
        prompt = torch.from_numpy(c["prompt"])
        b, pre = prompt.shape
        with torch.no_grad():
            last, cache = m.prefill(params, prompt)
            cache = grow_cache(cfg, cache, c["slots"])
            tok = last.argmax(-1).to(torch.int32)
            one, one_cache = m.decode_step(params, tok, copy.deepcopy(cache), pre)
        specs = shr.cache_pspecs(m, mesh, b, c["slots"])
        p_sh = _place(params, shr.param_pspecs(m, "serve_tp"), mesh)
        c_sh = _place(cache, specs, mesh)
        t_sh = _place(tok, shr.data_pspecs(cfg, mesh, "decode", b), mesh)
        calls = {}
        undo = _spied(calls)
        try:
            with use_mesh(mesh), torch.no_grad():
                logits, c_sh = m.decode_step(p_sh, t_sh, c_sh, pre)
        finally:
            undo()
        out[name] = {"logits": _np(logits), "one": _np(one),
                     "cache": {f: _np(t) for f, t in c_sh.items()},
                     "one_cache": {f: _np(t) for f, t in one_cache.items()},
                     "specs": {f: tuple(sp) for f, sp in specs.items()},
                     "calls": calls}
    return out


def gqa_local(job, mesh):
    """``gqa_flash`` on (1, 4) DTensors (q's heads over "model" where they
    divide it, else its rows; k/v replicated) against its plain run."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.distributed.sharding import to_placements
    from repro_torch.models.attention import gqa_flash
    out = {}
    for name, c in job.items():
        q, k, v = (torch.from_numpy(c[f]) for f in ("q", "k", "v"))
        pos = torch.arange(q.shape[1], dtype=torch.int32).expand(q.shape[0], -1)
        rep = to_placements(mesh, (None, None, None, None))
        qd = distribute_tensor(q, mesh, to_placements(mesh, (None, None, "model", None)))
        kd, vd = (distribute_tensor(t, mesh, rep) for t in (k, v))
        with use_mesh(mesh):
            got = gqa_flash(qd, kd, vd, pos, pos, 0.2, c["window"], block=8)
        out[name] = {"got": _np(got), "want": _np(gqa_flash(q, k, v, pos, pos, 0.2,
                                                             c["window"], block=8)),
                     "placements": str(tuple(got.placements))}
    return out


def error_feedback(job, rank):
    from repro_torch.training.compression import error_feedback_psum
    mean, res = error_feedback_psum(torch.from_numpy(job["x"][rank]))
    return {"mean": _np(mean), "residual": _np(res)}


def elastic(job, mesh_a, mesh_b, ckpt_dir):
    """Place on (2, 2), checkpoint, restore, re-place on (1, 4)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.elastic import replace_on_mesh, validate_divisibility
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.training import CheckpointManager
    cfg = get_config("qwen1.5-0.5b").reduced(**job["overrides"])
    m = build_model(cfg, device="cpu")
    params = params_from_jax(job["params"], device="cpu")
    spec = shr.param_pspecs(m, "train")
    placed = replace_on_mesh(params, spec, mesh_a)
    ck = CheckpointManager(ckpt_dir)
    ck.save(0, placed)
    _, restored = ck.restore(placed)
    bad = validate_divisibility(restored, spec, mesh_b)
    placed_b = replace_on_mesh(restored, spec, mesh_b)
    equal = all(torch.equal(a.full_tensor(), b)
                for a, b in zip(_leaves(placed_b), _leaves(params)))
    shards = [str(tuple(t.placements)) for t in _leaves(placed_b)]
    return {"equal": equal, "bad": bad, "restored_plain": all(
        type(t) is torch.Tensor for t in _leaves(restored)), "placements_b": shards}


def main(rank: int, world: int, job_path: str):
    torch.set_num_threads(1)
    job_path = Path(job_path)
    out = {}
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.launch.mesh import init_process_group
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        out["backend"] = init_process_group(rank, world, str(job_path.parent / "store"),
                                            device="cpu")
        mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        from repro_torch.distributed.sharding import io_channel_ranks
        out["io"] = {(shape, n): io_channel_ranks(mesh, n)
                     for shape, mesh in (((2, 2), mesh22), ((1, 4), mesh14))
                     for n in (None, 1, 3, 8)}
        out["lse"] = lse_cases(job["lse"], mesh14)
        out["ef"] = error_feedback(job["ef"], rank)
        out["append"] = append_decode(job["append"], mesh14)
        out["elastic"] = elastic(job["train"], mesh22, mesh14, str(job_path.parent / "ckpt"))
        out["train"] = train_and_decode(job["train"], mesh22)
        out["routing"] = sharded_decode(job["routing"], mesh14)
        out["gqa_local"] = gqa_local(job["gqa_local"], mesh14)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    except Exception:                      # reported to the test, never swallowed
        out["error"] = traceback.format_exc()
    with open(job_path.parent / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
