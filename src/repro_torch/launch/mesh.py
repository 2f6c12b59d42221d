"""Meshes over ``torch.distributed`` ranks: the port of ``repro.launch.mesh``.

``make_production_mesh`` and ``make_host_mesh`` are functions, so importing
this module touches no device and no process group.  The single-pod mesh is
a (data=16, model=16) grid of 256 ranks; multi-pod adds a leading "pod" axis
(2 pods = 512 ranks) used purely for data parallelism, as in the JAX
package.  Meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects
over the default process group, which ``repro_torch.distributed`` picks
(``resolve_group``) and, for a launcher, starts (``world``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed import resolve_group
from repro_torch.mapreduce.executor import _device


def production_axes(multi_pod: bool = False) -> dict[str, int]:
    """Axis name -> size of the production mesh, in mesh order."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device: torch.device | str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the default group's ranks.  Raises
    unless that group has exactly 256 (512) ranks."""
    axes = production_axes(multi_pod)
    need = math.prod(axes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"make_production_mesh: the {'multi-pod ' if multi_pod else ''}mesh "
            f"{tuple(axes.values())} needs {need} ranks; this world has {world}")
    return init_device_mesh(_device(device).type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    """Axes that carry batch/data parallelism."""
    return ("pod", "data") if multi_pod else ("data",)


def make_host_mesh(axis_name: str = "data", device: torch.device | str = "cuda") -> DeviceMesh:
    """Every rank of the default group on one axis (tests, examples, the
    launcher's ``--mesh host``).  ``torch.distributed`` must be initialized
    (``torchrun``, or ``repro_torch.distributed.world`` for one process)."""
    dev = _device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh: torch.distributed is not initialized; launch with torchrun or "
            "enter repro_torch.distributed.world(device) first")
    return DeviceMesh.from_group(resolve_group(None, dev), dev.type,
                                 mesh_dim_names=(axis_name,))
