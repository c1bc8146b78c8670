"""Gradient compression with error feedback.

Two codecs, as in the JAX package:
  - bf16: gradients cast to bfloat16 on the wire (half the bytes of a
    data-parallel all-reduce);
  - int8: per-tensor symmetric quantisation (scale max|g| / 127, rounded
    half to even, clipped to +-127) with an error-feedback accumulator:
    the quantisation residual is added back on the next step.

The train step applies `compress` to the reduced gradient, as the JAX
package's does (its GSPMD reduction comes first), and the returned
decompress function after it; the error state is carried in the train
loop.  Gradient trees are nested dicts of tensors.  Under a mesh
(``shardings``) each rank codes its slices: the int8 scale is the whole
leaf's (its max over the mesh), and the error buffers are sliced like
their leaf, so the wire values and residuals are the one-device codec's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed

from repro_torch.sharding.collectives import mesh_all_reduce_
from repro_torch.tree import map_up_to, tree_leaves


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    codec: str = "none"   # none | bf16 | int8
    error_feedback: bool = True


class CompressState(NamedTuple):
    error: Any  # residual accumulator tree (int8 codec) or ()


def init_state(params, cfg: CompressConfig) -> CompressState:
    if cfg.codec == "int8" and cfg.error_feedback:
        return CompressState(map_up_to(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))
    return CompressState(())


def _carried(g, e):
    return g.float() + e if e is not None else g.float()


def _int8(g, e, amax=None):
    """(int8 values, float32 scale) of ``g`` plus the carried error ``e``
    (or None), and the new residual; ``amax``: the whole leaf's max |g|
    (None: this tensor's)."""
    g32 = _carried(g, e)
    if amax is None:
        amax = g32.abs().max()
    scale = amax.clamp(min=1e-12) / 127.0
    qv = torch.round(g32 / scale).clamp(-127, 127).to(torch.int8)
    return (qv, scale), g32 - qv.float() * scale


def compress(grads, state: CompressState, cfg: CompressConfig,
             shardings=None):
    """Returns (wire_grads, new_state, decompress_fn).  ``shardings``: the
    gradients' under a mesh (each rank holds slices)."""
    if cfg.codec == "none":
        return grads, state, lambda g: g
    if cfg.codec == "bf16":
        return (map_up_to(lambda g: g.to(torch.bfloat16), grads), state,
                lambda w: map_up_to(lambda x: x.float(), w))
    if cfg.codec == "int8":
        err = state.error if state.error != () else map_up_to(
            lambda g: None, grads)
        if shardings is None:
            pairs = map_up_to(_int8, grads, err)
        else:
            amax = map_up_to(lambda g, e: _carried(g, e).abs().max(), grads,
                             err)
            flat = tree_leaves(amax)
            whole = mesh_all_reduce_(torch.stack(flat),
                                     tree_leaves(shardings)[0].mesh,
                                     torch.distributed.ReduceOp.MAX)
            for a, w in zip(flat, whole):
                a.copy_(w)
            pairs = map_up_to(_int8, grads, err, amax)
        wire = map_up_to(lambda pe: pe[0], pairs)
        new_err = (map_up_to(lambda pe: pe[1], pairs) if cfg.error_feedback
                   else ())

        def dec(w):
            return map_up_to(lambda vs: vs[0].float() * vs[1], w)
        return wire, CompressState(new_err), dec
    raise ValueError(cfg.codec)
