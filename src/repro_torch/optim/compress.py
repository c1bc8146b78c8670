"""Gradient compression with error feedback.

Two codecs, as in the JAX package:
  - bf16: gradients cast to bfloat16 on the wire (half the bytes of a
    data-parallel all-reduce);
  - int8: per-tensor symmetric quantisation (scale max|g| / 127, rounded
    half to even, clipped to +-127) with an error-feedback accumulator:
    the quantisation residual is added back on the next step.

The train step applies `compress` where a data-parallel reduction would
sit and the returned decompress function after it; the error state is
carried in the train loop.  Gradient trees are nested dicts of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.tree import map_up_to


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


def _int8(g, e):
    """(int8 values, float32 scale) of ``g`` plus the carried error ``e``
    (or None), and the new residual."""
    g32 = g.float() + e if e is not None else g.float()
    scale = g32.abs().max().clamp(min=1e-12) / 127.0
    qv = torch.round(g32 / scale).clamp(-127, 127).to(torch.int8)
    return (qv, scale), g32 - qv.float() * scale


def compress(grads, state: CompressState, cfg: CompressConfig):
    """Returns (wire_grads, new_state, decompress_fn)."""
    if cfg.codec == "none":
        return grads, state, lambda g: g
    if cfg.codec == "bf16":
        return (map_up_to(lambda g: g.to(torch.bfloat16), grads), state,
                lambda w: map_up_to(lambda x: x.float(), w))
    if cfg.codec == "int8":
        if state.error == ():
            pairs = map_up_to(lambda g: _int8(g, None), grads)
        else:
            pairs = map_up_to(_int8, grads, state.error)
        wire = map_up_to(lambda pe: pe[0], pairs)
        new_err = (map_up_to(lambda pe: pe[1], pairs) if cfg.error_feedback
                   else ())

        def dec(w):
            return map_up_to(lambda vs: vs[0].float() * vs[1], w)
        return wire, CompressState(new_err), dec
    raise ValueError(cfg.codec)
