"""Parameter templates: one source of truth for shapes and init.

A template is a nested dict of `Leaf`s, as in the JAX package; from it
`init_params` makes concrete tensors and `count_params` counts them.
Parameters are plain nested dicts of tensors, layer-stacked ``(L, ...)``
like the JAX package's trees, so a JAX tree carries across leaf by leaf
(`repro_torch.convert.lm_params_from_jax`).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    axes: tuple                  # logical axes, len(axes) == len(shape)
    init: str = "normal"         # normal | zeros | ones
    scale: float | None = None   # normal stddev; None -> 1/sqrt(fan_in)
    fan_in_dims: tuple = (-2,)   # dims whose product is fan-in
    dtype: str | None = None     # None -> cfg.param_dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def leaves(template, prefix: str = ""):
    """``(path, leaf)`` of every `Leaf`, paths joined with ``/``, in the
    JAX package's flattening order (sorted dict keys)."""
    if isinstance(template, Leaf):
        yield prefix, template
        return
    for k in sorted(template):
        yield from leaves(template[k], f"{prefix}/{k}" if prefix else k)


def axes_tree(template):
    """The tree of each leaf's logical-axes tuple, in the template's
    structure (the JAX package's ``axes_tree``)."""
    if isinstance(template, Leaf):
        return template.axes
    return {k: axes_tree(template[k]) for k in sorted(template)}


def _init_leaf(lf: Leaf, generator: torch.Generator, param_dtype: str,
               device):
    dt = getattr(torch, lf.dtype or param_dtype)
    if lf.init == "zeros":
        return torch.zeros(lf.shape, dtype=dt, device=device)
    if lf.init == "ones":
        return torch.ones(lf.shape, dtype=dt, device=device)
    fan_in = 1
    for d in lf.fan_in_dims:
        fan_in *= lf.shape[d]
    scale = lf.scale if lf.scale is not None else \
        1.0 / math.sqrt(max(fan_in, 1))
    if dt == torch.float32:
        return torch.randn(lf.shape, generator=generator,
                           dtype=torch.float32, device=device).mul_(scale)
    # drawn in float32 one trailing matrix at a time: a float32 copy
    # of a whole bf16 expert stack would not fit beside it on the card
    arr = torch.empty(lf.shape, dtype=dt, device=device)
    for mat in arr.view((-1,) + tuple(lf.shape[-2:])
                        if len(lf.shape) > 2 else (1,) + arr.shape):
        mat.copy_(torch.randn(mat.shape, generator=generator,
                              dtype=torch.float32,
                              device=device).mul_(scale))
    return arr


def init_params(template, generator: torch.Generator, param_dtype: str,
                device="cuda", shardings=None, coordinate=None):
    """Concrete parameters: each normal leaf drawn from ``generator`` (on
    ``device``) with its ``scale`` or 1/sqrt(fan_in), zeros and ones as
    the leaf says.  The numbers differ from `jax.random`'s.

    With ``shardings`` (a tree of `Sharding` in the template's structure)
    and a mesh ``coordinate``, each leaf is drawn whole, in the same
    order, and only the slice held at ``coordinate`` is kept: the values
    are the one-device draw's, and the peak is one whole leaf."""
    if isinstance(template, Leaf):
        t = _init_leaf(template, generator, param_dtype, device)
        if shardings is None:
            return t
        return t[shardings.local_index(template.shape, coordinate)].clone()
    return {k: init_params(template[k], generator, param_dtype, device,
                           None if shardings is None else shardings[k],
                           coordinate)
            for k in sorted(template)}


def count_params(template) -> int:
    return sum(math.prod(lf.shape) for _, lf in leaves(template))
