"""Mesh construction (counterpart of ``repro.launch.mesh``) on
``torch.distributed``: ``DeviceMesh``es with the reference's dim names and
shapes.

Functions, not module constants: importing this module touches no device
and no process group.  A mesh needs an initialised process group of its
size; :func:`init_process_group` makes one from a file rendezvous (no TCP
port to race for).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def init_process_group(rank: int, world_size: int, store_path: str, *,
                       device: str = "cuda"):
    """Join the default process group through the file ``store_path``
    (``file://`` rendezvous).  Backend: ``nccl`` when every rank has a card
    of its own; ``gloo`` on the CPU and when ranks share a card (NCCL takes
    one rank per card).  Returns the backend's name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available()"
                               " is False; pass device='cpu' to run on the CPU")
        backend = "nccl" if torch.cuda.device_count() >= world_size else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            world_size=world_size, rank=rank)
    return backend


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available()"
                           " is False; pass device='cpu' to run on the CPU")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs an initialised process group of "
                           f"{n} ranks (launch.mesh.init_process_group)")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_local_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A small (data, model) mesh over the process group's ranks (tests,
    one host)."""
    return _mesh((data, model), ("data", "model"), device)
