"""Random weights made on the device from the seed, in a few large calls.

The parameter tree takes the program's layout (``Model.param_specs``:
shapes and dtypes only), but its values come from here: one normal draw
per dtype into one flat buffer on the card (a ``torch.Generator`` there),
clipped at two standard deviations, and every leaf a view of it scaled in
place — fan-in scaling for products (1/sqrt of the input width: axis 0 of
an (in, out) matrix, axis 1 of an (E, in, out) expert stack), 0.02 for the
embedding tables, ones for norm scales.  Both the program and the
reference read these same tensors.
"""
from __future__ import annotations

import math

import torch

EMBED_STD = 0.02


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _std(path, shape):
    """None for a norm scale (ones); else the leaf's standard deviation."""
    name = path[-1]
    if name in ("scale", "q_norm", "k_norm"):
        return None
    if name in ("embed", "unembed"):
        return EMBED_STD
    return 1.0 / math.sqrt(shape[1] if len(shape) == 3 else shape[0])


def make(specs: dict, seed: int, device) -> dict:
    """Weights of the tree ``specs`` (meta tensors) on ``device``."""
    tree = _copy_structure(specs)
    leaves = list(_leaves(specs))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for dtype in sorted({t.dtype for _, t in leaves}, key=str):
        group = [(p, t) for p, t in leaves if t.dtype == dtype]
        buf = torch.randn(sum(t.numel() for _, t in group), generator=gen,
                          device=device, dtype=dtype)
        buf.clamp_(-2.0, 2.0)
        off = 0
        for path, t in group:
            view = buf[off:off + t.numel()].view(t.shape)
            off += t.numel()
            std = _std(path, t.shape)
            if std is None:
                view.fill_(1.0)
            else:
                view.mul_(std)
            _set(tree, path, view)
    return tree


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return None
