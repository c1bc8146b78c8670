"""Explicit collectives over one axis of a `DeviceMesh`: what the JAX
package leaves to GSPMD's partitioner, written out for the (data, model)
mesh of the trainer and of the serving steps.

  gather(x, dim, axis)      all-gather along ``dim``; backward sums the
                            gradient over the axis and keeps this rank's
                            block (reduce-scatter).  FSDP's gather of a
                            leaf before its layer runs, and the gather of
                            a tensor-parallel leaf a layer needs whole,
                            where each rank computes its share of the
                            layer from it.
  gather_replicated(x, dim, axis)
                            all-gather along ``dim``; backward keeps this
                            rank's block of the gradient: every rank of
                            the axis computes the same thing from the
                            whole (MoE's expert outputs before the
                            combine, the router), so each rank's gradient
                            of it is already the whole one.
  reduce_sum(x, axis)       all-reduce sum; backward passes the gradient
                            on (a row-parallel product's partial sums).
  grad_sum(x, axis)         the identity; backward all-reduces the
                            gradient (an input every rank of the axis
                            uses for its part only).
  all_reduce_(t, axis, op)  in place, outside autograd
                            (`mesh_all_reduce_`: over every axis).
  all_gather(x, dim, axis)  all-gather outside autograd (serving: a
                            decode's q heads, logits split over the
                            vocab).
  combine_softmax(m, l, acc, axis)
                            one softmax from partial statistics over
                            disjoint key blocks, one block a rank
                            (decode over a sequence-split cache).

Every rank of the axis must make the same calls in the same order; a
collective that fails raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

# the names of torch 2.13 and later, falling back to the older ones
_all_gather_base = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_base = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh as this rank sees it: its process group, its
    extent and this rank's coordinate along it."""

    name: str
    group: Any
    size: int
    index: int


def mesh_axis(mesh, name: str) -> MeshAxis:
    dim = mesh.mesh_dim_names.index(name)
    return MeshAxis(name, mesh.get_group(name), mesh.size(dim),
                    mesh.get_local_rank(name))


def all_reduce_(t: torch.Tensor, axis: MeshAxis,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=axis.group)
    return t


def mesh_all_reduce_(t: torch.Tensor, mesh,
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over every rank of ``mesh``, one axis after
    the other (SUM and MAX: the result is the whole mesh's)."""
    for name in mesh.mesh_dim_names:
        all_reduce_(t, mesh_axis(mesh, name), op)
    return t


def _all_gather(x, dim: int, axis: MeshAxis):
    x = x.contiguous()
    out = torch.empty((axis.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_base(out, x, group=axis.group)
    out = out.view((axis.size,) + tuple(x.shape))
    shape = list(x.shape)
    shape[dim] *= axis.size
    # the axis's blocks in rank order along dim
    return out.movedim(0, dim).reshape(shape)


def _reduce_scatter(g, dim: int, axis: MeshAxis):
    n = axis.size
    blocks = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
    blocks = blocks.contiguous()
    out = torch.empty(blocks.shape[1:], dtype=g.dtype, device=g.device)
    _reduce_scatter_base(out.view(-1), blocks.view(-1),
                         op=dist.ReduceOp.SUM, group=axis.group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.axis), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.axis.size
        return g.narrow(ctx.dim, ctx.axis.index * n, n), None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def _no_graph(x: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(f"{what} has no backward; it serves")


def all_gather(x: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """The axis's blocks of ``x`` in rank order along ``dim``, outside
    autograd (a tensor that needs a gradient raises)."""
    _no_graph(x, "all_gather")
    return _all_gather(x, dim % x.ndim, axis)


def combine_softmax(m, l, acc, axis: MeshAxis) -> torch.Tensor:
    """``acc / l`` of one softmax whose keys lie in blocks, one a rank of
    ``axis``: each rank's running max ``m``, sum of exponentials ``l``
    (both (..., 1)) and unnormalised output ``acc`` (..., D), float32,
    over its own block.  The statistics are gathered and combined in rank
    order, so every rank gets the same bits, run after run (a reduction
    whose order the library picks would not promise that).  A rank whose
    keys are all masked (``m`` at the mask value) weighs nothing."""
    _no_graph(acc, "combine_softmax")
    parts = _all_gather(torch.cat([m, l, acc], -1)[None], 0, axis)
    ms, ls, accs = parts[..., :1], parts[..., 1:2], parts[..., 2:]
    top = ms.amax(0)
    tot_l = torch.zeros_like(l)
    tot = torch.zeros_like(acc)
    for r in range(axis.size):
        w = torch.exp(ms[r] - top)
        tot_l = tot_l + ls[r] * w
        tot = tot + accs[r] * w
    return tot / tot_l


def gather(x: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    return _Gather.apply(x, dim % x.ndim, axis)


def gather_replicated(x: torch.Tensor, dim: int,
                      axis: MeshAxis) -> torch.Tensor:
    return _GatherReplicated.apply(x, dim % x.ndim, axis)


def reduce_sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return _ReduceSum.apply(x, axis)


def grad_sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return _GradSum.apply(x, axis)
