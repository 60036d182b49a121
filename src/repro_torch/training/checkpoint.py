"""Checkpointing: atomic, async, restart-friendly (counterpart of
``repro.training.checkpoint``).

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per leaf of the saved tree
(leaves in a fixed order: dict keys sorted, lists and tuples in order) and
``manifest.json`` (step, leaf count, completion marker).  Writes go to
``tmp_step_<N>`` and are published with an atomic ``os.replace``, so a
crash mid-save never corrupts the latest checkpoint.  ``save`` copies every
leaf to host memory before it returns, the writer thread of ``save_async``
included: the optimizer updates the parameters in place, so a thread that
read the tensors later would write a later step's values.

DTensor leaves (a sharded run's parameters and optimizer state) are
gathered whole to the host: every rank calls ``save``, rank 0 writes, and
all of them return once the checkpoint is published.  ``restore`` gives a
DTensor like-leaf back as a whole host tensor, which
``distributed.elastic.replace_on_mesh`` places on any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, flat):
    """``flat`` (in ``_flatten`` order) shaped like ``like``: dicts, lists,
    tuples and named tuples rebuilt with their types."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}           # the like tree's key order
        if isinstance(node, list):
            return [build(v) for v in node]
        if isinstance(node, tuple):
            vals = [build(v) for v in node]
            return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
        return next(it)
    return build(like)


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _is_dtensor(t) -> bool:
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _to_host(t) -> np.ndarray:
    """A host copy that later in-place updates of ``t`` cannot reach (a
    DTensor gathered whole: a collective)."""
    if _is_dtensor(t):
        t = t.full_tensor()
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.array(t, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = True):
        leaves = _flatten(tree)
        host = [_to_host(t) for t in leaves]                 # device -> host now
        if any(_is_dtensor(t) for t in leaves):
            # a sharded tree: every rank gathered it; rank 0 writes, and no
            # rank returns before the checkpoint is published
            if dist.get_rank() == 0:
                self._write(step, host)
            dist.barrier()
            return
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, host),
                                            daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree):
        self.save(step, tree, blocking=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves):
        tmp = os.path.join(self.dir, f"tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, arr in enumerate(host_leaves):
            with open(os.path.join(tmp, _leaf_name(i)), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
        manifest = {"step": step, "n_leaves": len(host_leaves), "complete": True}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)                              # atomic publish
        self._gc()

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                mf = os.path.join(self.dir, d, "manifest.json")
                if os.path.exists(mf):
                    with open(mf) as f:
                        if json.load(f).get("complete"):
                            out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: Optional[int] = None):
        """Returns (step, tree) shaped like ``like_tree``, each leaf a tensor
        on its like leaf's device (a whole host tensor for a DTensor) and of
        its dtype."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        like = _flatten(like_tree)
        host = [np.load(os.path.join(d, _leaf_name(i))) for i in range(len(like))]
        for i, (a, b) in enumerate(zip(host, like)):
            if tuple(a.shape) != tuple(b.shape):
                raise ValueError(f"leaf {i} shape {a.shape} != expected {tuple(b.shape)}")
        return step, _unflatten(like_tree, [
            torch.from_numpy(a).to("cpu" if _is_dtensor(b) else b.device, b.dtype)
            for a, b in zip(host, like)])
