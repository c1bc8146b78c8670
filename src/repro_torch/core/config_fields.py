"""The mapper's configs rebuilt from plain field dicts.

A JAX config's ``dataclasses.asdict``, or a manifest's config dict from
an index store of either package, becomes this package's
`SeedMapConfig` / `PipelineConfig` / `LongReadConfig` / `Scoring`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.long_read import LongReadConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.scoring import Scoring

#: JAX PipelineConfig fields with no counterpart here: the per-family
#: kernel backends (a session here has one backend, `ExecutionConfig.
#: backend`)
_BACKENDS = {"frontend_backend", "light_backend", "residual_backend"}
#: fields of the same names as this package's launch geometry that hold
#: TPU block sizes in a JAX config (one that names the backends above)
_BLOCKS = {"frontend_block", "light_block", "residual_block"}
#: the same two sets of the JAX LongReadConfig
_LR_BACKENDS, _LR_BLOCKS = {"vote_backend"}, {"vote_block"}


def _drop_tpu_fields(fields: dict, backends: set, blocks: set) -> None:
    """Drop a JAX config's kernel backends and, with them, its TPU launch
    blocks; a config of this package (no backend fields) keeps its own
    launch geometry."""
    if backends & set(fields):
        for k in backends | blocks:
            fields.pop(k, None)


def config_from_fields(cls, fields: dict):
    """One of `SeedMapConfig`, `PipelineConfig`, `LongReadConfig`,
    `Scoring` from the JAX config's ``dataclasses.asdict``.

    A nested scoring dict becomes a `Scoring` and a nested pipe dict a
    `PipelineConfig`; a JAX config's per-family kernel backends are
    dropped (every backend gives the same results; a session here picks
    one with `ExecutionConfig.backend`), and with them its TPU launch
    blocks, whose names this package's own launch geometry shares; any
    other unknown field raises.
    """
    fields = dict(fields)
    if cls is LongReadConfig:
        _drop_tpu_fields(fields, _LR_BACKENDS, _LR_BLOCKS)
        if isinstance(fields.get("pipe"), dict):
            fields["pipe"] = config_from_fields(PipelineConfig,
                                                fields["pipe"])
    if cls is PipelineConfig:
        _drop_tpu_fields(fields, _BACKENDS, _BLOCKS)
        if isinstance(fields.get("scoring"), dict):
            fields["scoring"] = Scoring(**fields["scoring"])
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**fields)
