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
"""
from __future__ import annotations

import contextlib
import contextvars

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
