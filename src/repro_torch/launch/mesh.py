"""Device meshes for the sharded Mode A drivers, the port of the JAX
package's ``launch/mesh.py`` over ``torch.distributed``.

The port follows torch's SPMD idiom: every rank of the default process group
runs the same program with the same arguments, and a mesh names, for each of
its axes, the process group of the ranks that share this rank's coordinates
on the other axes. Ranks are laid out row-major, so on a ``(lanes,
workers)`` mesh rank r sits at ``(r // n_workers, r % n_workers)``. A mesh
of one device needs no process group; a larger one is built on
``torch.distributed.device_mesh.init_device_mesh`` over the default group,
which every rank of it must have initialised (``init_process_group``) and
enter together.

A ``(workers, 'model')`` mesh (``make_worker_mesh(model=)``) is the model
zoo's GSPMD path: ``launch/sharding.py``'s specs split each parameter over
both axes (``core/sharded.ShardPlan``). ``make_test_mesh`` and
``make_production_mesh`` name the JAX package's meshes over the default
group's ranks; Mode B's step (``launch/steps.py``) runs on them, its
workers every axis but 'model'. Where those are more than one (``('pod',
'data', 'model')``), the mesh also holds one process group across them,
its ranks in the flattened worker order, pod-major: ``group`` and
``coordinate`` take that tuple of axes as one axis. The
JAX package's ``set_mesh`` and ``shard_map`` are jax API with no
counterpart: the mesh's process groups and explicit collectives take their
place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: ``axis_names`` and their ``sizes``, and the torch
    ``DeviceMesh`` that holds a process group per axis (None for a mesh of
    one device, and for a mesh built by hand to check a driver's
    validation, which needs no group). Two meshes of the same axes and sizes
    compare equal."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)
    # the worker axes' joint group, keyed by their tuple, where a mesh with
    # 'model' has more than one worker axis
    joint_groups: Any = dataclasses.field(default=None, compare=False,
                                          repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def _built(self):
        if self.device_mesh is None:
            raise ValueError(
                f"{self} has no process groups: build it with "
                "make_worker_mesh / make_lane_mesh")
        return self.device_mesh

    def group(self, axis):
        """This rank's process group along ``axis`` (a name, or the tuple of
        the worker axes)."""
        names = _names(axis)
        if len(names) == 1:
            return self._built().get_group(names[0])
        if names not in (self.joint_groups or {}):
            raise ValueError(f"{self} has no joint group over {names}")
        return self.joint_groups[names]

    def coordinate(self, axis) -> int:
        """This rank's index along ``axis`` (0 on an axis of size 1); along
        a tuple of axes, the flattened index, the first axis major."""
        index = 0
        for name in _names(axis):
            index = index * self.shape[name] + self._coordinate(name)
        return index

    def _coordinate(self, axis: str) -> int:
        if self.shape[axis] == 1:
            return 0
        coord = self._built().get_coordinate()
        if coord is None:
            raise ValueError(
                f"rank {dist.get_rank()} is not in {self} (the mesh takes "
                f"the first {self.size} ranks of the default group)")
        return coord[self.axis_names.index(axis)]


def _names(axis) -> Tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def world_size() -> int:
    """The ranks of the default process group; 1 when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _device_type() -> str:
    """The device type of the default group's collectives: ``cuda`` for
    NCCL, else ``cpu`` (gloo, which also gathers CUDA tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _make_mesh(sizes: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    have = world_size()
    if math.prod(sizes) > have:
        raise ValueError(
            f"requested {'x'.join(map(str, sizes))} devices, have {have}")
    if math.prod(sizes) == 1:
        return Mesh(axes, sizes)
    from torch.distributed.device_mesh import init_device_mesh
    device_mesh = init_device_mesh(_device_type(), sizes, mesh_dim_names=axes)
    waxes = tuple(a for a in axes if a != "model")
    if "model" not in axes or len(waxes) < 2:
        return Mesh(axes, sizes, device_mesh)
    # one group a 'model' coordinate over the worker axes, every rank making
    # every group; a group's ranks ascend, which is the flattened order
    m_at, n_m = axes.index("model"), sizes[axes.index("model")]
    coords = [divmod(r, math.prod(sizes[m_at + 1:]))[0] % n_m
              for r in range(math.prod(sizes))]
    joint, _ = dist.new_subgroups_by_enumeration(
        [[r for r, c in enumerate(coords) if c == col] for col in range(n_m)])
    return Mesh(axes, sizes, device_mesh, {waxes: joint})


def worker_axes(mesh) -> tuple:
    """The axes across which DynaBRO workers are laid out."""
    return tuple(a for a in mesh.axis_names if a != "model")


def n_workers(mesh) -> int:
    n = 1
    for a in worker_axes(mesh):
        n *= mesh.shape[a]
    return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh: 16 x 16 ranks over ("data",
    "model"), or 2 x 16 x 16 over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh of ``shape`` over ``axes`` for tests (gloo CPU ranks)."""
    return _make_mesh(tuple(shape), tuple(axes))


def worker_spec(waxes):
    """The spec entry of a leading worker axis: the tuple of worker mesh
    axes, collapsed to the bare name when there is only one."""
    return tuple(waxes) if len(waxes) > 1 else waxes[0]


def worker_iota(m: int, device="cuda") -> torch.Tensor:
    """The worker index as data: ``arange(m)`` in float32, a rank's block
    of it its own worker indices."""
    return torch.arange(m, dtype=torch.float32, device=resolve_device(device))


def make_worker_mesh(n_devices: int = 0, axis: str = "workers",
                     model: int = 0) -> Mesh:
    """The worker mesh of the sharded compiled drivers.

    ``model=0`` (default) builds the 1-axis ``(workers,)`` mesh:
    ``n_devices`` ranks (0: every rank of the default group), and
    ``n_devices=1`` the parity-contract mesh, bitwise the unsharded driver.

    ``model`` >= 1 builds the 2-axis ``(workers, 'model')`` mesh of the
    model zoo's GSPMD path: ``n_devices`` (0: whatever the model axis
    leaves over) is the worker axis's size, rank r sits at ``(r // model,
    r % model)``, and ``launch.sharding.plan_params``'s per-leaf rules split
    the parameters over it (the worker axis doubling as the FSDP axis). A
    ``(1, 1)`` mesh is this path's parity-contract mesh."""
    have = world_size()
    if model:
        return _make_mesh((n_devices or max(1, have // model), model),
                          (axis, "model"))
    return _make_mesh((n_devices or have,), (axis,))


def make_lane_mesh(n_lanes: int = 0, n_workers: int = 1,
                   lane_axis: str = "lanes",
                   worker_axis: str = "workers") -> Mesh:
    """The 2-axis ``(lanes, workers)`` mesh of the sharded sweep: the
    sweep's cells are split over ``lane_axis`` and, with ``n_workers`` > 1,
    each cell's workers over ``worker_axis``. ``n_lanes=0`` takes whatever
    the worker axis leaves over; a ``(1, 1)`` mesh is bitwise the unsharded
    sweep."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    n = n_lanes or max(1, world_size() // n_workers)
    return _make_mesh((n, n_workers), (lane_axis, worker_axis))

