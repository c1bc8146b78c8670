"""Optimizers: AdamW and Adafactor (memory-factored).

The update math is the JAX package's.  Parameters and optimizer state
are nested dicts of tensors; `update` writes the new parameters and
moments into their tensors in place (the JAX package donates them to its
jitted step), so a step holds no second copy of either.  Optimizer state
follows each parameter's placement (`opt_state_sharding`), as the JAX
package's does under GSPMD.

Under a mesh (``shardings``: the parameters' tree of `Sharding`) each
rank holds and updates its slices: AdamW is elementwise; the global norm
sums every element once over the mesh; Adafactor factors by the whole
leaf's shape, and a row or column mean over a split dim is summed over
the axes that split it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.sharding.collectives import (
    all_reduce_, mesh_all_reduce_, mesh_axis,
)
from repro_torch.sharding.partition import Sharding
from repro_torch.tree import map_up_to, tree_leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # bfloat16 halves optimizer memory
    factored_min_dim: int = 128  # adafactor: factor only big matrices


class OptState(NamedTuple):
    m: Any       # first moment (adamw) or () (adafactor)
    v: Any       # second moment: tensor (adamw) / (row, col) or tensor
    step: torch.Tensor   # 0-d int32


def _should_factor(shape, cfg: OptConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.factored_min_dim
            and shape[-2] >= cfg.factored_min_dim)


def _with_shardings(fn, tree, shardings, *rest):
    """`map_up_to` of ``fn(leaf, *rest entries, sharding or None)``."""
    if shardings is None:
        return map_up_to(lambda *a: fn(*a, None), tree, *rest)
    return map_up_to(fn, tree, *rest, shardings)


def init(params, cfg: OptConfig, shardings=None) -> OptState:
    """Zero moments of the parameters' (local) shapes; ``shardings``:
    theirs under a mesh (Adafactor factors by the whole leaf's shape)."""
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    if cfg.kind == "adamw":
        mdt = getattr(torch, cfg.moment_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)
        return OptState(map_up_to(zeros, params), map_up_to(zeros, params),
                        step)
    if cfg.kind == "adafactor":
        def v_init(p, sh):
            z = dict(dtype=torch.float32, device=p.device)
            whole = p.shape if sh is None else sh.global_shape(p.shape)
            if _should_factor(whole, cfg):
                return (torch.zeros(p.shape[:-1], **z),
                        torch.zeros(p.shape[:-2] + p.shape[-1:], **z))
            return torch.zeros(p.shape, **z)
        return OptState((), _with_shardings(v_init, params, shardings), step)
    raise ValueError(cfg.kind)


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares.  Under a
    mesh (``shardings``) each rank sums the slices it counts
    (`Sharding.counted_here`: a slice replicated over an axis counts
    once), and the sums are added over the mesh."""
    leaves = tree_leaves(tree)
    if shardings is None:
        return torch.sqrt(sum(x.float().square().sum() for x in leaves))
    shs = tree_leaves(shardings)
    mesh = shs[0].mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), device=leaves[0].device) + sum(
        x.float().square().sum() for x, sh in zip(leaves, shs)
        if sh.counted_here(coord))
    return torch.sqrt(mesh_all_reduce_(total, mesh))


def _mean(t, dim: int, sh, p_dim: int):
    """``t.mean(dim)`` (keeping the dim), where ``dim`` is the parameter's
    dim ``p_dim`` and may be split over mesh axes (``sh``, or None)."""
    axes = sh.split_axes(p_dim) if sh is not None else ()
    parts = [mesh_axis(sh.mesh, a) for a in axes]
    n = 1
    for a in parts:
        n *= a.size
    if n == 1:
        return t.mean(dim, keepdim=True)
    s = t.sum(dim, keepdim=True)
    for a in parts:
        all_reduce_(s, a)
    return s / (t.shape[dim] * n)


@torch.no_grad()
def update(grads, state: OptState, params, cfg: OptConfig, lr=None,
           shardings=None):
    """Returns (params, new_state); ``params`` and the moments are updated
    in place.

    ``lr`` (a float or a 0-d tensor) overrides ``cfg.lr`` (LR schedules).
    Gradients are clipped to a global norm of ``cfg.grad_clip``.
    ``shardings``: the parameters' under a mesh (see the module).
    """
    lr = cfg.lr if lr is None else lr
    step = state.step + 1
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    def write(p, delta):
        """p - lr * delta, in p's dtype."""
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)

    def moment(buf):
        """A float32 tensor to update in place: the moment itself, or a
        float32 copy of a bf16 one (written back rounded)."""
        return buf if buf.dtype == torch.float32 else buf.float()

    if cfg.kind == "adamw":
        bc1 = 1.0 - torch.pow(cfg.b1, step.float())
        bc2 = 1.0 - torch.pow(cfg.b2, step.float())

        def upd(p, g, m, v):
            g = g.float() * scale
            m32 = moment(m).mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v32 = moment(v).mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            del g
            if m32 is not m:
                m.copy_(m32)
            if v32 is not v:
                v.copy_(v32)
            denom = (v32 / bc2).sqrt_().add_(cfg.eps)
            delta = (m32 / bc1).div_(denom)
            del denom
            write(p, delta.add_(cfg.weight_decay * p.float()))

        map_up_to(upd, params, grads, state.m, state.v)
        return params, OptState(state.m, state.v, step)

    # ---- adafactor (simplified: no momentum; grad-norm clipping) ----------
    decay = 1.0 - step.float() ** -0.8

    def upd_f(p, g, v, sh):
        g = g.float() * scale
        g2 = g * g + 1e-30
        if isinstance(v, tuple):
            vr, vc = v
            nd = p.ndim
            vr.mul_(decay).add_((1 - decay)
                                * _mean(g2, -1, sh, nd - 1).squeeze(-1))
            vc.mul_(decay).add_((1 - decay)
                                * _mean(g2, -2, sh, nd - 2).squeeze(-2))
            del g2
            mean_r = _mean(vr, -1, sh, nd - 2).clamp(min=1e-30)
            denom = ((vr / mean_r)[..., None] * vc[..., None, :]).sqrt_()
        else:
            v.mul_(decay).add_((1 - decay) * g2)
            del g2
            denom = v.sqrt()
        delta = g.div_(denom.add_(cfg.eps))
        del denom
        write(p, delta.add_(cfg.weight_decay * p.float()))

    _with_shardings(upd_f, params, shardings, grads, state.v)
    return params, OptState((), state.v, step)


def opt_state_sharding(param_shardings, params, cfg: OptConfig,
                       repl_sharding: Sharding) -> OptState:
    """Placements of `OptState` mirroring the parameters' (ZeRO under
    GSPMD in the JAX package): adafactor's factored leaves take the
    parameter's spec with the reduced dim dropped; the step is
    replicated.  ``params``: the parameter tree (anything with shapes)."""
    if cfg.kind == "adamw":
        return OptState(param_shardings, param_shardings, repl_sharding)

    def v_shard(sh, p):
        if _should_factor(p.shape, cfg):
            pad = list(sh.spec) + [None] * (len(p.shape) - len(sh.spec))
            return (Sharding(sh.mesh, tuple(pad[:-1])),
                    Sharding(sh.mesh, tuple(pad[:-2] + pad[-1:])))
        return sh

    return OptState((), map_up_to(lambda p, sh: v_shard(sh, p), params,
                                  param_shardings), repl_sharding)
