"""Meshes over ``torch.distributed`` ranks: the port of ``repro.launch.mesh``.

A ``Mesh`` is a grid of the default group's ranks with named axes, ordered
as ``jax.make_mesh`` orders devices: rank r sits at the row-major
coordinates of r in the grid, so on a ("data", "model") mesh rank =
data_index * model + model_index.  Every rank of the default group builds
the same mesh, and with it one process group for each axis and one for the
data axes together (the ranks that differ from this one only along those
axes), in the same order on every rank, as ``torch.distributed.new_group``
needs.

``make_production_mesh`` (a (data=16, model=16) grid of 256 ranks;
multi-pod adds a leading "pod" axis, 2 pods = 512 ranks, used purely for
data parallelism, as in the JAX package), ``make_host_mesh`` (every rank on
one axis) and ``make_mesh`` (any grid) are functions, so importing this
module touches no device and no process group.  The default group is the
caller's: ``repro_torch.distributed.world`` starts one for a launcher.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.mapreduce.executor import _device


def production_axes(multi_pod: bool = False) -> dict[str, int]:
    """Axis name -> size of the production mesh, in mesh order."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    """Axes that carry batch/data parallelism."""
    return ("pod", "data") if multi_pod else ("data",)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a grid of ranks.  ``groups`` maps an axis name,
    or the tuple of the data axes, to the process group of the ranks that
    share this rank's coordinates on every other axis (empty for a mesh
    that only slices, as the tests' meshes of one rank's view)."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    device_type: str = "cpu"
    groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def size(self, axes) -> int:
        """Ranks along ``axes`` (a name or a tuple of names)."""
        return math.prod(self.shape[self.mesh_dim_names.index(a)] for a in _names(axes))

    def index(self, axes) -> int:
        """This rank's index along ``axes``, row-major over the names in
        the order given."""
        i = 0
        for a in _names(axes):
            k = self.mesh_dim_names.index(a)
            i = i * self.shape[k] + self.coords[k]
        return i

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Every axis but "model", in mesh order."""
        return tuple(a for a in self.mesh_dim_names if a != "model")

    def group(self, axes) -> dist.ProcessGroup:
        """The process group along ``axes``: an axis name, or the tuple of
        the data axes."""
        key = axes if isinstance(axes, str) or len(axes) > 1 else axes[0]
        if key not in self.groups:
            raise KeyError(f"mesh {dict(zip(self.mesh_dim_names, self.shape))} has no group "
                           f"along {axes!r}")
        return self.groups[key]


def _names(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: torch.device | str = "cuda") -> Mesh:
    """The default group's ranks as a ``shape`` grid named ``axes`` (e.g.
    (2, 2) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model")), with its axis groups.  Every rank of the default group must
    call it, with the same arguments.  Raises unless ``torch.distributed``
    is initialized with exactly ``prod(shape)`` ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} do not match")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: torch.distributed is not initialized; launch with torchrun or "
            "enter repro_torch.distributed.world(device) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise RuntimeError(f"make_mesh: the mesh {shape} needs {math.prod(shape)} ranks; "
                           f"this world has {world}")
    coords = _unravel(rank, shape)
    data = tuple(a for a in axes if a != "model")
    wanted = [(a,) for a in axes] + ([data] if len(data) > 1 else [])
    groups = {}
    for along in wanted:
        ks = [axes.index(a) for a in along]
        others = [k for k in range(len(axes)) if k not in ks]
        for fixed in itertools.product(*(range(shape[k]) for k in others)):
            members = []
            for moving in itertools.product(*(range(shape[k]) for k in ks)):
                c = [0] * len(axes)
                for k, v in zip(others, fixed):
                    c[k] = v
                for k, v in zip(ks, moving):
                    c[k] = v
                members.append(_ravel(c, shape))
            group = dist.new_group(members)  # every rank creates every group, in order
            if rank in members:
                groups[along if len(along) > 1 else along[0]] = group
    return Mesh(axes, shape, coords, _device(device).type, groups)


def _unravel(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def make_production_mesh(*, multi_pod: bool = False, device: torch.device | str = "cuda") -> Mesh:
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
    return make_mesh(tuple(axes.values()), tuple(axes), device)


def make_host_mesh(axis_name: str = "data", device: torch.device | str = "cuda") -> Mesh:
    """Every rank of the default group on one axis (tests, examples, the
    launcher's ``--mesh host``).  ``torch.distributed`` must be initialized
    (``torchrun``, or ``repro_torch.distributed.world`` for one process)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh: torch.distributed is not initialized; launch with torchrun or "
            "enter repro_torch.distributed.world(device) first")
    return make_mesh((dist.get_world_size(),), (axis_name,), device)
