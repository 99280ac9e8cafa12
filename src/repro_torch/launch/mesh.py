"""Meshes of the dry run and of a run on the card (port of
`repro.launch.mesh`), as torch `DeviceMesh`es with the reference's axis
names:

Single pod:  (16, 16)      ("data", "model")          = 256 ranks
Multi pod:   (2, 16, 16)   ("pod", "data", "model")   = 512 ranks

A `DeviceMesh` lives on the default process group, which `open_group`
opens and `close_group` closes; importing this module opens nothing. The
dry run (`launch.dryrun`) opens a group of torch's fake backend
(`torch.testing._internal.distributed.fake_pg.FakeStore`, backend
"fake"): one process plays one rank of 256 or 512, every collective
returns at once and moves no data, so only one rank's program is seen
(`fake_group` plays the last rank). A
run on the card opens a real group ("nccl", or "gloo" on the CPU) of
`world_size` processes. `AbstractMesh` is a mesh's axis names and sizes
alone, for rule tables and spec trees with no group (the reference's
`jax.sharding.AbstractMesh`).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh with no devices behind it."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def production_shape(multi_pod: bool = False) -> tuple:
    """(sizes, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def open_group(world_size: int, *, backend: str = "fake", rank: int = 0,
               init_method: str = None) -> None:
    """Open the default process group: torch's fake backend of
    `world_size` ranks played by this process (no data moves), or a real
    backend ("nccl", "gloo") with `init_method` (e.g.
    "tcp://localhost:<port>") and this process's `rank`. Raises if a
    default group is open already."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is open already")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)


def close_group() -> None:
    """Close the default process group (and every group made from it), if
    one is open."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake-backend default group for the duration of the block, played
    by its LAST rank: every rank runs the same program but for
    sequence-parallel causal attention, where the last rank on 'model'
    holds the latest queries and sees the most keys, so its program is
    the one that bounds a step."""
    open_group(world_size, backend="fake", rank=world_size - 1)
    try:
        yield
    finally:
        close_group()


def make_mesh(sizes, axis_names, device_type: str = "cpu"):
    """A DeviceMesh of these sizes and axis names over the open default
    group, whose size must be their product."""
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(sizes)
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(f"mesh {tuple(sizes)} needs {need} ranks; the "
                           f"default group has {have}")
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    return make_mesh(*production_shape(multi_pod), device_type=device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 1,
                   device_type: str = "cpu"):
    """Small mesh over the open default group for tests and a run on the
    card."""
    if pod > 1:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def data_axis_names(mesh) -> tuple:
    """Mesh axes that shard the batch (everything except 'model')."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def n_chips(mesh) -> int:
    from repro_torch.models.common import axis_sizes
    return math.prod(axis_sizes(mesh).values())


def coordinate(mesh, axes) -> int:
    """This rank's index along the mesh axes `axes` taken together, major
    to minor."""
    from repro_torch.models.common import axis_sizes
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx
