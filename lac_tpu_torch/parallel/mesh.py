"""Device mesh construction: the (data, model) mesh over the process group.

Ports ``lac_tpu/parallel/mesh.py`` (:20-34): coding lanes data-parallel
over ``data``, weights tensor-parallel over ``model``, ``model`` innermost
(fastest-varying over the ranks) so that tensor-parallel collectives run
between neighbouring devices. The reference's mesh is one controller's
local devices; here it is a ``torch.distributed`` ``DeviceMesh`` over the
ranks of the process group, one rank per device (``distributed.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device
from .distributed import backend_for

__all__ = ["make_mesh", "mesh_geometry"]


def make_mesh(data: int = -1, model: int = 1, devices=None, device=None) -> DeviceMesh:
    """Build a (data, model) mesh over the process group's ranks on
    ``device`` (the card unless the caller asks for the CPU). ``data=-1``:
    every rank the ``model`` dim leaves. ``devices``, the reference's
    argument, lists the mesh's devices, one a rank in rank order: this rank
    takes ``devices[rank]``, and a list that is not one device a rank is
    refused. Without a process group a 1 x 1 mesh starts a one-rank group
    (its store in-process: no address, no file); any other mesh needs its
    ranks launched (``torchrun --nproc-per-node``). Every rank of the group
    calls it."""
    if devices is not None:
        if device is not None:
            raise ValueError("make_mesh takes devices (one a rank) or device, not both")
        devices = [resolve_device(d) for d in devices]
        rank, n = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a process group of {n} ranks: "
                             "a mesh takes one device a rank")
        device = devices[rank]
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
    dev = resolve_device(device)
    if not dist.is_initialized():
        if data not in (-1, 1) or model != 1:
            raise ValueError(
                f"a mesh of data {data} x model {model} needs a process group of that many "
                "ranks: launch them with torchrun --nproc-per-node N (or call "
                "distributed_init in each)")
        dist.init_process_group(backend_for(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def mesh_geometry(mesh: DeviceMesh) -> dict:
    """``{"data": d, "model": m}``, the container's record of a mesh."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {"data": int(shape["data"]), "model": int(shape["model"])}
