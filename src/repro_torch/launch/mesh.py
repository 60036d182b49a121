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
    one rank per card; DTensor's collectives of CUDA tensors are then
    staged through host memory, :func:`_stage_functional_collectives`).
    Returns the backend's name."""
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
    if backend == "gloo" and dev.type == "cuda":
        _stage_functional_collectives()
    return backend


_STAGED = None          # the registrations of _stage_functional_collectives


def _stage_functional_collectives():
    """Run the functional collectives (``torch.ops._c10d_functional``, which
    DTensor's redistributions call) on host copies of CUDA tensors.  Over
    gloo their work on a CUDA tensor crashes the process in ``wait_tensor``
    (a segmentation fault on an H100 with torch 2.11), while gloo's c10d
    calls stage CUDA tensors through host memory and work: this is that
    staging, done before the call.  Once a process."""
    global _STAGED
    if _STAGED is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    ops = torch.ops._c10d_functional

    def staged(op):
        def impl(inp, *args):
            return ops.wait_tensor(op(inp.cpu(), *args)).to(inp.device)
        return impl
    for name in ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
                 "all_to_all_single"):
        lib.impl(name, staged(getattr(ops, name).default), "CUDA")
    _STAGED = lib


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
