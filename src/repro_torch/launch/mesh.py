"""Production meshes.

Port of ``repro.launch.mesh``: the same shapes and axis names, as torch
``DeviceMesh``es.  The JAX dry-run forces 512 host devices before JAX
starts; here the production mesh lives on a fake process group
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once and moves nothing), so no device and no other process
is needed.  Importing this module initializes nothing:
``production_world`` creates the fake world, and destroys it on exit,
only where no process group is initialized already.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch.distributed as dist

from repro_torch.parallel.sharding import P


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...],
                                                       Tuple[str, ...]]:
    """Single pod: (16, 16) = 256 devices, axes (data, model).
    Multi-pod: (2, 16, 16) = 512 devices, axes (pod, data, model)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0) for the block, when none is initialized; an initialized world is
    left as it is (it must have ``world_size`` ranks to hold a mesh of
    that size)."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the current world (``production_world``
    gives a fake one)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def production_world(*, multi_pod: bool = False):
    """``make_production_mesh`` on a fake world of its size, for the
    block: ``with production_world() as mesh:``."""
    shape, _ = production_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    with fake_world(n):
        yield make_production_mesh(multi_pod=multi_pod)


def make_host_mesh(model_axis: int = 1):
    """Tiny mesh over the ranks of the current world (a CPU smoke run's
    gloo ranks, or a fake world): (world // model_axis, model_axis)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    data = max(n // model_axis, 1)
    return init_device_mesh("cpu", (data, model_axis),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry the batch dimension."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def batch_spec(mesh) -> P:
    da = data_axes(mesh)
    return P(da if len(da) > 1 else da[0])
