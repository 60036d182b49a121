"""Sharding-constraint helper usable from model code (counterpart of
``repro.distributed.constraints``).

``use_mesh(mesh)`` stands in for JAX's ``with mesh:``: inside it
``ambient_mesh()`` returns the ``DeviceMesh`` and ``constrain(x, *spec)``
redistributes a DTensor ``x`` to the spec's placements on it.  Axis names
missing from the mesh are stripped and axes that do not divide the dim
are dropped, so the same model code is valid on any mesh (or none).  With
no ambient mesh, or on a plain tensor, ``constrain`` returns its input
object: single-device runs are untouched.

Inside ``use_mesh`` a plain tensor met by an op on DTensors counts as
replicated (DTensor's implicit replication), as an unsharded array does
under ``jit``: positions and masks built inside the model need no
placement of their own.

``local_call`` runs a function (a hand-written kernel) on each rank's
local shards, and ``write_slots`` writes a chunk into a cache through the
shards that hold its slots.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the body with ``mesh`` as the ambient mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    outer = _AMBIENT.get()
    token = _AMBIENT.set(mesh)
    try:
        if outer is None:
            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _AMBIENT.get()


def axis_size(mesh, name: str) -> int:
    """Size of the mesh dim ``name`` (1 when the mesh has no such dim)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def clean_spec(mesh, spec, shape) -> tuple:
    """``spec`` padded to ``len(shape)`` with axes missing from ``mesh``
    stripped and entries whose axes do not divide the dim dropped (the
    reference's rules).  Entries come back as a name, a tuple of names or
    None."""
    names = set(mesh.mesh_dim_names or ())

    def keep(entry, dim):
        if entry is None:
            return None
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a in names)
        size = 1
        for a in kept:
            size *= axis_size(mesh, a)
        if not kept or size == 0 or dim % size:
            return None
        return kept if len(kept) > 1 else kept[0]

    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(keep(e, shape[i]) for i, e in enumerate(entries[:len(shape)]))


def constrain(x, *spec):
    """``x`` redistributed to ``spec`` (cleaned) on the ambient mesh; a
    plain tensor, or any tensor with no ambient mesh, as it is."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import to_placements
    if not isinstance(x, DTensor):
        return x
    if x.device_mesh != mesh:
        raise ValueError("constrain: the DTensor lies on another mesh than the "
                         "ambient one")
    placements = to_placements(mesh, clean_spec(mesh, spec, x.shape))
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local_call(fn, inputs, out_like):
    """``fn`` run on this rank's local shards (the reference's
    ``shard_map``): each (tensor, spec) of ``inputs`` is redistributed to
    its spec (cleaned) on the ambient mesh, a plain tensor counting as
    replicated, and handed to ``fn`` as its local tensor.  ``fn`` returns
    a tensor or a tuple; output i becomes a DTensor placed as input
    ``out_like[i]`` was handed over (outputs keep their inputs' shard
    shapes: the kernels' shape rules).  Gradients flow through both
    wrappings.  With no ambient mesh, ``fn`` on the inputs as they are."""
    mesh = ambient_mesh()
    if mesh is None:
        return fn(*(t for t, _ in inputs))
    from torch.distributed.tensor import DTensor
    placed = [constrain(_as_dtensor(t, mesh), *spec) for t, spec in inputs]
    outs = fn(*(t.to_local() for t in placed))
    single = isinstance(outs, torch.Tensor)
    outs = (outs,) if single else tuple(outs)
    wrapped = tuple(DTensor.from_local(o, mesh, placed[i].placements, run_check=False)
                    for o, i in zip(outs, out_like))
    return wrapped[0] if single else wrapped


def write_slots(dst, dim: int, slots, src):
    """DTensor ``dst``'s entries at ``slots`` (host ints, one a position of
    ``src`` along ``dim``) along ``dim`` set to ``src``, in place: each rank
    writes the slots its own shard holds, taking them from ``src`` brought
    to ``dst``'s placements with ``dim`` whole (indexing a DTensor along a
    sharded dim would write into a gathered copy)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    whole = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in dst.placements]
    src = _as_dtensor(src, mesh).redistribute(mesh, whole).to_local()
    shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
    lo, n = offset[dim], shape[dim]
    mine = [(s - lo, i) for i, s in enumerate(slots) if lo <= s < lo + n]
    if mine:
        _write_local(dst.to_local(), dim, [a for a, _ in mine], [b for _, b in mine], src)
    return dst


def _write_local(dst, dim: int, at, take, src):
    """dst[..., at, ...] = src[..., take, ...] along ``dim``: slices where
    both runs are consecutive, else index tensors."""
    if at == list(range(at[0], at[0] + len(at))) and take == list(
            range(take[0], take[0] + len(take))):
        dst.narrow(dim, at[0], len(at)).copy_(src.narrow(dim, take[0], len(take)))
        return
    idx = torch.tensor(at, device=dst.device)
    sel = src.index_select(dim, torch.tensor(take, device=src.device))
    dst.index_copy_(dim, idx, sel.to(dst.dtype))


def split_dim(x, dim: int, sizes):
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  On a DTensor
    sharded along that dim over more shards than divide ``sizes[0]``
    (DTensor cannot split an uneven shard) the dim is gathered first;
    otherwise the shard stays on the first of the new dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim = dim % x.ndim
    if isinstance(x, DTensor):
        on = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
        n = 1
        for i in on:
            n *= x.device_mesh.size(i)
        if sizes[0] % n:
            x = x.redistribute(x.device_mesh, [Replicate() if i in on else p
                                               for i, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def merge_dims(x, *shape):
    """``x.reshape(*shape)`` where ``shape`` merges x's trailing dims (heads
    into width).  On a DTensor with none of the merged dims sharded, each
    rank reshapes its own shard, so that the backward hands the gradient
    back in x's placements (a split of a gradient sharded along the merged
    dim fails where the heads do not divide its shards)."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(x, DTensor):
        first = len(shape) - 1
        if not any(isinstance(p, Shard) and p.dim >= first for p in x.placements):
            local = x.to_local()
            return DTensor.from_local(local.reshape(*local.shape[:first], -1), x.device_mesh,
                                      x.placements, run_check=False)
    return x.reshape(*shape)
