"""Device meshes for the engine's mesh plans.

`make_mesh` names the axes of the ranks of an already initialised
process group, as repro's `launch/mesh.py::make_auto_mesh` names the axes
of the JAX devices: ``("data", "model")`` for the two plans of
`ExecutionConfig(mesh=...)`.  Nothing here starts a process or a process
group; the caller runs ``torch.distributed.init_process_group`` with its
own address, world size and rank first (NCCL for a ``"cuda"`` mesh, one
GPU per rank; gloo for a ``"cpu"`` mesh).
"""
from __future__ import annotations

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
