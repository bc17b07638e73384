"""Production meshes as ``torch.distributed`` ``DeviceMesh``es: the port of
the JAX package's ``launch/mesh.py``.  Functions, not module constants:
importing this file touches no device and no ``torch.distributed`` state.

A ``DeviceMesh`` needs a process group of the mesh's world size, and that
group is global to the process.  Where none is initialized, the mesh
factories initialize torch's fake backend (``init_process_group("fake",
store=FakeStore(), ...)``), whose collectives do nothing: a dry run plans
256 or 512 ranks in one process.  ``FakeStore`` is imported from
``torch.testing._internal.distributed.fake_pg``, a module internal to
torch (present in the 2.11 and 2.13 builds this port runs on).  The group
is made once, at the first mesh's world size; a later mesh must fit in it.
Where a real group is already initialized (several processes), the
factories use it.
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_mesh_shape"]


def _ensure_world(n: int) -> None:
    """A default process group of at least ``n`` ranks: the fake backend
    at world size ``n`` when none is initialized."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < n:
            raise RuntimeError(
                f"a mesh of {n} ranks does not fit the process group of "
                f"{dist.get_world_size()} already initialized in this "
                "process; plan each mesh size in a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh_shape(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ranks 0..n-1 laid out as ``shape`` with the axis
    names ``axes`` (elastic re-scale paths, one-device plans).  A planning
    mesh places no tensor, so its device type is the CPU's."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ "
                         "in length")
    n = math.prod(shape)
    _ensure_world(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 devices as (16 data, 16 model).  Multi-pod: 2 × 256
    with a leading 'pod' axis (DP across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_shape(shape, axes)
