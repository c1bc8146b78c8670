"""Device meshes for the engine's mesh plans and the trainer.

`make_mesh` names the axes of the ranks of an already initialised
process group, as repro's `launch/mesh.py::make_auto_mesh` names the axes
of the JAX devices: ``("data", "model")`` for the two plans of
`ExecutionConfig(mesh=...)`.  `make_host_mesh` is the trainer's small
mesh over whatever ranks exist.  Nothing here starts a process or a
process group; the caller runs ``torch.distributed.init_process_group``
with its own address, world size and rank first (NCCL for a ``"cuda"``
mesh, one GPU per rank; gloo for a ``"cpu"`` mesh).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: tuple[int, ...],
              axis_names: tuple[str, ...] = ("data", "model"),
              device_type: str = "cuda") -> DeviceMesh:
    """A ``shape`` mesh over the process group's ranks (row-major: the last
    axis varies fastest), with ``axis_names``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's process group;"
                           " call init_process_group first")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         f"differ in length")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh | None:
    """A (data, model) mesh over the first ranks of the process group,
    each extent clamped to the world size as the JAX package clamps them
    to its devices (model to the world, data to world // model).  With
    no process group there is one device: the mesh is (1, 1), and None
    stands for it (`ShardCtx`, `constrain` and `Checkpointer.restore`
    read None as that one-device mesh)."""
    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    model = min(model, n)
    data = max(1, min(data, n // model))
    return DeviceMesh(device_type, torch.arange(data * model).reshape(
        data, model), mesh_dim_names=("data", "model"))
