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
Where a real group is already initialized (several processes, or one
rank of ``launch/train.py --mesh``), the factories use it, and the mesh's
device type follows the group's backend: ``nccl`` → ``cuda``, ``gloo``
or ``fake`` → ``cpu``.  A mesh over the fake group plans and never
executes: the train step and ``runtime.pp.gpipe`` refuse it
(:func:`require_execution`), since every rank would compute alone.
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_mesh_shape", "mesh_backend",
           "require_execution"]


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


def mesh_backend() -> str:
    """The default process group's backend ("nccl", "gloo", "fake", ...)."""
    import torch.distributed as dist
    return str(dist.get_backend())


def require_execution(mesh, what: str) -> None:
    """Raise unless ``mesh``'s process group really communicates: the fake
    backend's collectives do nothing, so a run on it would "pass" with
    every rank computing alone."""
    backend = mesh_backend()
    if "fake" in backend:
        raise RuntimeError(
            f"{what} executes across ranks, and the mesh {mesh} lies on the "
            f"{backend!r} process group, whose collectives do nothing: start "
            "a real group (gloo on the CPU, nccl on the card) first")


def make_mesh_shape(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ranks 0..n-1 laid out as ``shape`` with the axis
    names ``axes`` (elastic re-scale paths, one-device plans, execution
    across ranks).  Its device type follows the group's backend: ``cuda``
    over nccl, else ``cpu`` (a planning mesh places no tensor)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ "
                         "in length")
    n = math.prod(shape)
    _ensure_world(n)
    device_type = "cuda" if "nccl" in mesh_backend() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 devices as (16 data, 16 model).  Multi-pod: 2 × 256
    with a leading 'pod' axis (DP across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_shape(shape, axes)
