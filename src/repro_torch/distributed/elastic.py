"""Elastic scaling: resume a checkpoint on a different mesh shape
(counterpart of ``repro.distributed.elastic``).

The specs of ``sharding.py`` name mesh dims, not sizes, so the same spec
tree re-places host checkpoint leaves onto any mesh whose dim sizes divide
the tensor dims.  Scaling (2, 2) to (1, 4) is therefore: restore (the
checkpoint holds whole host tensors, gathered at save) -> ``replace_on_mesh``
with the new mesh -> continue.  No resharding pass is needed on disk.

:func:`place_meta` places a tree of shapes the same way without data: each
leaf a DTensor whose local is a ``meta`` tensor of this rank's shard shape
(the dry run's stand-in for the reference's sharded ``ShapeDtypeStruct``s).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.constraints import axis_size
from repro_torch.distributed.sharding import _map_with_path, to_placements


def replace_on_mesh(host_tree, spec_tree, mesh):
    """``host_tree``'s leaves as DTensors on ``mesh`` placed by
    ``spec_tree`` (each rank keeps its shard; every rank passes the same
    whole tensors, as a restore gives them)."""
    from torch.distributed.tensor import distribute_tensor
    specs = dict(_flat(spec_tree))

    def put(path, t):
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 to_placements(mesh, specs[path]))
    return _map_with_path(put, host_tree)


def place_meta(tree, spec_tree, mesh):
    """``tree``'s leaves (tensors of any device; only shape and dtype are
    read) as DTensors on ``mesh`` placed by ``spec_tree``, each rank's local
    an empty ``meta`` tensor of its shard's shape: no storage, no copy, no
    collective."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    specs = dict(_flat(spec_tree))

    def put(path, t):
        placements = to_placements(mesh, specs[path])
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, placements)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh,
                                  placements, run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape, device="meta").stride())
    return _map_with_path(put, tree)


def validate_divisibility(tree, spec_tree, mesh) -> list:
    """The (path, dim, axis) violations of placing ``tree`` by ``spec_tree``
    on ``mesh`` (empty: the re-placement is valid).  Paths are written as
    the reference's ``keystr``: ``['layers'][0]['attn']['wq']``."""
    specs = dict(_flat(spec_tree))
    bad = []

    def check(path, t):
        for d, ax in enumerate(tuple(specs[path])):
            if ax is None:
                continue
            size = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                size *= axis_size(mesh, a)
            if t.shape[d] % size:
                bad.append((keystr(path), d, ax))
    _map_with_path(check, tree)
    return bad


def keystr(path) -> str:
    """``path`` written as JAX's ``keystr``: [0] for a list index, ['k']
    for a dict key."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in path)


def _flat(spec_tree):
    out = []
    _map_with_path(lambda path, s: out.append((path, s)), spec_tree)
    return out
