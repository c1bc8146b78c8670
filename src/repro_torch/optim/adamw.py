"""Optimizers: AdamW and Adafactor (memory-factored).

The update math is the JAX package's.  Parameters and optimizer state
are nested dicts of tensors; `update` writes the new parameters and
moments into their tensors in place (the JAX package donates them to its
jitted step), so a step holds no second copy of either.  Optimizer state
follows each parameter's placement (`opt_state_sharding`), as the JAX
package's does under GSPMD.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

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


def init(params, cfg: OptConfig) -> OptState:
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    if cfg.kind == "adamw":
        mdt = getattr(torch, cfg.moment_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)
        return OptState(map_up_to(zeros, params), map_up_to(zeros, params),
                        step)
    if cfg.kind == "adafactor":
        def v_init(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _should_factor(p.shape, cfg):
                return (torch.zeros(p.shape[:-1], **z),
                        torch.zeros(p.shape[:-2] + p.shape[-1:], **z))
            return torch.zeros(p.shape, **z)
        return OptState((), map_up_to(v_init, params), step)
    raise ValueError(cfg.kind)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(grads, state: OptState, params, cfg: OptConfig, lr=None):
    """Returns (params, new_state); ``params`` and the moments are updated
    in place.

    ``lr`` (a float or a 0-d tensor) overrides ``cfg.lr`` (LR schedules).
    Gradients are clipped to a global norm of ``cfg.grad_clip``.
    """
    lr = cfg.lr if lr is None else lr
    step = state.step + 1
    gnorm = global_norm(grads)
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

    def upd_f(p, g, v):
        g = g.float() * scale
        g2 = g * g + 1e-30
        if isinstance(v, tuple):
            vr, vc = v
            vr.mul_(decay).add_((1 - decay) * g2.mean(-1))
            vc.mul_(decay).add_((1 - decay) * g2.mean(-2))
            del g2
            mean_r = vr.mean(-1, keepdim=True).clamp(min=1e-30)
            denom = ((vr / mean_r)[..., None] * vc[..., None, :]).sqrt_()
        else:
            v.mul_(decay).add_((1 - decay) * g2)
            del g2
            denom = v.sqrt()
        delta = g.div_(denom.add_(cfg.eps))
        del denom
        write(p, delta.add_(cfg.weight_decay * p.float()))

    map_up_to(upd_f, params, grads, state.v)
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
