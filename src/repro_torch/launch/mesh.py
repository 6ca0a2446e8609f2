"""Device meshes over the current process group.

Port of src/repro/launch/mesh.py. Single pod: 16×16 = 256 ranks, axes
(data, model). Multi-pod: 2×16×16 = 512 ranks, axes (pod, data, model):
the pod axis is pure data parallelism, so only gradient reductions cross
the slower link between pods.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the process group the caller started: `launch/train.py --mesh smoke`
takes it from torchrun's environment (or runs as a single rank), and the
dry run (launch/dryrun.py) starts a fake one of the mesh's size, where
every rank is simulated by this process and no collective moves data.
Defined as functions, never module-level meshes, so importing this file
touches no process group.
"""
from __future__ import annotations

import math

import torch


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 0


def _mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod" in
    front, over the first ranks of the process group; raises where the
    group has fewer ranks than the mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = _world()
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, the process group has {have} "
            "— the dry run must start a fake process group of that size "
            "(launch/dryrun.py) before it builds the mesh")
    return _mesh(shape, axes, device_type)


def make_smoke_mesh(shape=(2, 2), axes=("data", "model"), *,
                    device_type: str = "cuda"):
    """A small mesh over the first prod(shape) ranks of the current
    process group (`init_device_mesh` where the group is exactly that
    size)."""
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    have = _world()
    if have < need:
        raise RuntimeError(f"mesh {tuple(shape)} needs {need} ranks, the "
                           f"process group has {have}")
    if have == need:
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    return _mesh(shape, axes, device_type)
