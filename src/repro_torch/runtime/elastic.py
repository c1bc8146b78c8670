"""Elastic re-meshing: rebuild the production mesh after host failures.

When the watchdog EVICTs a host (or a host dies), the launcher calls
`plan_remesh(total, failed)` to pick the largest viable (pod, data, model)
mesh from the survivors, then restores the latest checkpoint **under the
new mesh's placements**: the checkpointer's reshard-on-restore does the
data movement, so no bespoke reshard code is needed here.

Policy (the JAX package's): the tensor-parallel (`model`) extent is kept
whenever possible (it keeps activation memory per device constant); the
batch axes shrink to the largest power-of-two host count the survivors
support.  Global batch is kept by raising the per-device batch
(gradient accumulation if it no longer fits).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    shape: tuple            # new mesh shape
    axes: tuple             # axis names
    n_devices: int
    dropped: int            # devices idled (not in the new mesh)
    grad_accum: int         # microbatch multiplier to preserve global batch


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_remesh(n_total: int, n_failed: int, model: int = 16,
                pods: int = 1) -> RemeshPlan:
    """Largest (pod, data, model) mesh from `n_total - n_failed` devices."""
    if not 0 <= n_failed < n_total:
        raise ValueError(f"need 0 <= n_failed < n_total, got {n_failed} "
                         f"of {n_total}")
    survivors = n_total - n_failed
    if survivors < model:
        # cannot keep TP extent: shrink TP to the largest pow2 that fits
        model = _largest_pow2_leq(survivors)
    per_pod = survivors // pods if pods > 1 else survivors
    data = _largest_pow2_leq(max(per_pod // model, 1))
    while pods > 1 and data < 1:
        pods //= 2
        per_pod = survivors // pods
        data = _largest_pow2_leq(max(per_pod // model, 1))
    used = pods * data * model
    old_data_total = (n_total // model)
    grad_accum = max(1, old_data_total // max(pods * data, 1))
    if pods > 1:
        return RemeshPlan((pods, data, model), ("pod", "data", "model"),
                          used, survivors - used, grad_accum)
    return RemeshPlan((data, model), ("data", "model"),
                      used, survivors - used, grad_accum)


def build_mesh(plan: RemeshPlan, device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` of ``plan.shape`` over the first ``plan.n_devices``
    ranks of the initialised process group (row-major), with
    ``plan.axes``; every rank of the group calls it."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs torch.distributed's process "
                           "group; call init_process_group first")
    world = dist.get_world_size()
    if world < plan.n_devices:
        raise ValueError(f"the plan needs {plan.n_devices} ranks, the group "
                         f"has {world}")
    ranks = torch.arange(plan.n_devices).reshape(plan.shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=plan.axes)
