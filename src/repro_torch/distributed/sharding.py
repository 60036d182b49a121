"""Sharding rules per (architecture x input shape x mesh): counterpart of
``repro.distributed.sharding`` on ``torch.distributed``'s ``DeviceMesh``.

Three modes:
  * ``train``     — FSDP over "data" (weights + optimizer state ZeRO-3-style)
                    + Megatron TP over "model"; batch over ("pod","data").
  * ``serve_tp``  — TP over "model" only; weights replicated over "data".
  * ``serve_2d``  — 2D tensor parallelism: d_model over "data" AND
                    d_ff/heads/vocab over "model" (archs above 60B).

A spec (:class:`P`) is a tuple with one entry per tensor dim: None, a mesh
dim name, or a tuple of names — JAX's ``PartitionSpec`` written as data.
:func:`to_placements` turns one into the DTensor placements of a mesh
(``to_named``'s counterpart).  Leaf rules are name-based over the model's
parameter tree.  The reference stacks its uniform layers for ``lax.scan``
and prepends None for that axis; the port keeps one dict per layer, so its
spec for layer i's leaf is the reference's less that leading None.

KV-cache rule: batch over ("pod","data"); kv-heads over "model" when
divisible, otherwise the cache *sequence* dim is sharded over "model"
(sequence-parallel decode, ``collectives.lse_decode_attention``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.distributed.constraints import axis_size
from repro_torch.models.kvcache import init_cache

# threshold above which serving needs 2D weight sharding (bf16 bytes / chip)
_SERVE_2D_PARAM_THRESHOLD = 60e9


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``.  A tuple of
    one name is that name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def choose_mode(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape.kind == "train":
        return "train"
    total = cfg.param_counts()["total"]
    return "serve_2d" if total > _SERVE_2D_PARAM_THRESHOLD else "serve_tp"


def batch_axes(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def to_placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    placements = [Replicate() for _ in range(mesh.ndim)]
    names = list(mesh.mesh_dim_names or ())
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in names:
                placements[names.index(a)] = Shard(d)
    return placements


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _leaf_rule(name: str, parent: str, fsdp: Optional[str]):
    """The spec of the leaf's own dims (None: replicate)."""
    expert = parent == "moe" and name in ("w_gate", "w_up", "w_down", "router")
    if expert:
        if name == "router":
            return P(fsdp, "model")
        if name in ("w_gate", "w_up"):
            return P("model", None, fsdp)       # (E, D, F)
        return P("model", fsdp, None)           # w_down (E, F, D)
    table = {
        "embed": P("model", fsdp),
        "unembed": P(fsdp, "model"),
        "wq": P(fsdp, "model"), "wk": P(fsdp, "model"), "wv": P(fsdp, "model"),
        "wo": P("model", fsdp),
        "bq": P("model"), "bk": P("model"), "bv": P("model"),
        "w_gate": P(fsdp, "model"), "w_up": P(fsdp, "model"),
        "w_down": P("model", fsdp),
        # MLA
        "wq_a": P(fsdp, None), "wq_b": P(None, "model"),
        "wkv_a": P(fsdp, None), "wkv_b": P(None, "model"),
        # RG-LRU
        "w_y": P(fsdp, "model"), "w_x": P(fsdp, "model"),
        "w_out": P("model", fsdp),
        "conv_w": P(None, "model"), "conv_b": P("model"),
        "gate_a": P(None, None, None), "gate_i": P(None, None, None),
        "gate_a_b": P("model"), "gate_i_b": P("model"), "lam": P("model"),
        # RWKV
        "w_r": P(fsdp, "model"), "w_k": P(fsdp, "model"), "w_v": P(fsdp, "model"),
        "w_g": P(fsdp, "model"), "w_o": P("model", fsdp),
        "cm_k": P(fsdp, "model"), "cm_v": P("model", fsdp), "cm_r": P(fsdp, "model"),
        "decay_w1": P(fsdp, None), "decay_w2": P(None, "model"),
        "mix_w1": P(fsdp, None), "mix_w2": P(None, None, "model"),
    }
    return table.get(name)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and (named) tuples,
    rebuilt with its types; a path is the keys and list indices (as
    strings) down to the leaf.  A spec is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(path, tree)


def param_pspecs(model, mode: str):
    """Spec tree matching ``model.param_specs()``."""
    fsdp = "data" if mode in ("train", "serve_2d") else None

    def rule(names, leaf):
        name = names[-1]
        parent = names[-2] if len(names) >= 2 else ""
        if name in ("scale", "bias"):            # norms
            spec = None
        else:
            look_parent = parent
            if parent != "moe" and "moe" in names:
                look_parent = "moe"
            if name in ("w_gate", "w_up", "w_down") and "shared" in names:
                look_parent = "mlp"
            spec = _leaf_rule(name, look_parent, fsdp)
        base = tuple(spec) if spec is not None else ()
        if len(base) < leaf.ndim:
            base = (None,) * (leaf.ndim - len(base)) + base
        elif len(base) > leaf.ndim:
            base = base[len(base) - leaf.ndim:]
        return P(*base)

    return _map_with_path(rule, model.param_specs())


def opt_pspecs(model, mode: str):
    from repro_torch.training.optimizer import OptState
    p = param_pspecs(model, mode)
    return OptState(P(), p, _map_with_path(lambda _path, s: s, p))


# ---------------------------------------------------------------------------
# Activation / batch / cache specs
# ---------------------------------------------------------------------------


def _prod(mesh, axes) -> int:
    out = 1
    for a in axes:
        out *= axis_size(mesh, a)
    return out


def _batch_spec(mesh, batch: int):
    bax = batch_axes(mesh)
    n = _prod(mesh, bax)
    return bax if (batch % max(1, n) == 0 and batch >= n) else None


def data_pspecs(cfg: ModelConfig, mesh, kind: str, batch: int):
    """Batch specs. train: {"tokens": (B, S+1)} or the embeddings batch;
    prefill: inputs (B, S); decode: tokens (B,).  Batch dims smaller than
    the data axes replicate (long_500k B=1)."""
    baxes = _batch_spec(mesh, batch)
    b = P(baxes)
    if kind == "train":
        if cfg.input_mode == "tokens":
            return {"tokens": b}
        return {"embeddings": P(baxes, None, None), "labels": b}
    if kind == "prefill":
        return b if cfg.input_mode == "tokens" else P(baxes, None, None)
    return b if cfg.input_mode == "tokens" else P(baxes, None)


def cache_pspecs(model, mesh, batch: int, seq: int):
    """KV-cache specs for decode (see the module docstring for the kv-head
    vs sequence rule).  Shapes come from ``init_cache`` on the meta
    device."""
    cfg = model.cfg
    model_size = axis_size(mesh, "model")
    bspec = _batch_spec(mesh, batch)
    specs = {}
    shapes = init_cache(cfg, batch, seq, model.compute_dtype, torch.device("meta"))
    for f, t in shapes.items():
        if f in ("k", "v"):
            s_dim = t.shape[2]
            if cfg.num_kv_heads % model_size == 0:
                specs[f] = P(None, bspec, None, "model", None)
            elif s_dim % model_size == 0:
                specs[f] = P(None, bspec, "model", None, None)
            else:
                specs[f] = P(None, bspec, None, None, None)
        elif f == "ckv":
            s_dim = t.shape[2]
            specs[f] = P(None, bspec, "model" if s_dim % model_size == 0 else None, None)
        elif f == "kpos":
            specs[f] = P(None, None)
        elif f == "wkv":
            h = t.shape[2]
            specs[f] = P(None, bspec, "model" if h % model_size == 0 else None, None, None)
        elif f in ("conv", "lru", "shift_tm", "shift_cm"):
            w = t.shape[-1]
            specs[f] = P(*([None] * (t.ndim - 1)), "model" if w % model_size == 0 else None)
        else:
            specs[f] = P(*([None] * t.ndim))
    return specs


# ---------------------------------------------------------------------------
# Restoration I/O channels
# ---------------------------------------------------------------------------


def io_channel_ranks(mesh, io_channels: Optional[int] = None) -> list:
    """The mesh rank behind each restoration I/O channel: channel c on the
    c-th rank of the mesh in row-major order, round robin."""
    ranks = mesh.mesh.flatten().tolist()
    n = io_channels if io_channels is not None else len(ranks)
    return [ranks[c % len(ranks)] for c in range(max(1, n))]


def io_channel_devices(mesh=None, io_channels: Optional[int] = None, *,
                       device="cuda") -> list:
    """Device behind each restoration I/O channel.

    The engine core's ``io_channels`` contention model maps onto real
    transfer queues by pinning channel c to the device of
    ``io_channel_ranks(mesh)[c]`` (rank r on card r modulo the host's
    cards): on a sharded mesh every card gets its own host-to-device fetch
    stream.  With no mesh every channel is a queue of its own on
    ``device``."""
    if mesh is None:
        return [torch.device(device)] * max(1, io_channels or 1)
    ranks = io_channel_ranks(mesh, io_channels)
    if mesh.device_type == "cuda":
        cards = torch.cuda.device_count()
        return [torch.device("cuda", r % cards) for r in ranks]
    return [torch.device(mesh.device_type) for _ in ranks]
