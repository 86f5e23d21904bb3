"""Mesh construction (the reference's ``repro/launch/mesh.py``) on torch
``DeviceMesh``es over the ranks of the process group.

Mesh semantics, as the reference's:

* single-pod: ``(16, 16)`` over ``("data", "model")``, 256 ranks;
* multi-pod: ``(2, 16, 16)`` over ``("pod", "data", "model")``, 512 ranks.

:func:`make_production_mesh` builds one of these only over a world of
exactly that many ranks, and raises otherwise: it never builds a smaller
mesh.  :func:`make_host_mesh` builds a small mesh over whatever ranks the
process group has; with no group it starts one, from the launcher's
environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) or,
for one process, a one-rank group of its own: NCCL on ``cuda``, gloo only
when the caller asks for the CPU.  Both run on the card unless the caller
asks for the CPU (``device="cpu"``), and raise without one.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _start_group(device: str) -> None:
    """Initialize the default process group if none is: from the
    environment when a launcher set ``WORLD_SIZE`` above 1, else one rank
    on an in-process store."""
    if device not in _BACKEND:
        raise ValueError(f"device {device!r}: one of {sorted(_BACKEND)}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the mesh runs on the card unless "
                           "the caller asks for the CPU (device='cpu')")
    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(_BACKEND[device])
    else:
        dist.init_process_group(_BACKEND[device], store=dist.HashStore(),
                                rank=0, world_size=1)


def _mesh(device: str, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    if device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The ``(16, 16)`` or ``(2, 16, 16)`` mesh over an initialized world
    of 256 or 512 ranks; raises ``ValueError`` naming both counts on any
    other world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != need:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod mesh "
                         f"{shape} needs {need} ranks; the process group has "
                         f"{world} (the production meshes take 256 or 512)")
    _start_group(device)
    return _mesh(device, shape, names)


def make_host_mesh(model: int = 1, *, data: int | None = None,
                   multi_pod: bool = False, device: str = "cuda"):
    """A small ``("data", "model")`` mesh (``("pod", "data", "model")``
    with ``multi_pod``: two pods of ``data // 2``) over the ranks of the
    process group, started here if there is none."""
    _start_group(device)
    n = dist.get_world_size()
    data = data or max(n // model, 1)
    if multi_pod:
        if data % 2:
            raise ValueError(f"a multi-pod mesh needs an even data size, not "
                             f"{data}")
        shape, names = (2, data // 2, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    if data * model != n:
        raise ValueError(f"mesh {shape} needs {data * model} ranks; the "
                         f"process group has {n}")
    return _mesh(device, shape, names)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
