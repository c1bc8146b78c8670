"""Carry state from the JAX package into this one.

The system has no weights; its state is the index and the reference.
These helpers take the JAX package's arrays and config fields as plain
numpy / dicts (``np.asarray`` of its `SeedMap` / `PaddedSeedMap` /
`ShardedSeedMap` fields,
``dataclasses.asdict`` of its configs), so both packages can map against
the same index without this package importing the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.distributed import SeedMapShard, ShardedSeedMap
from repro_torch.core.long_read import LongReadConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.scoring import Scoring
from repro_torch.core.seedmap import PaddedSeedMap, SeedMap, SeedMapConfig

#: JAX PipelineConfig fields with no counterpart here: TPU launch blocks,
#: and the per-family kernel backends (a session here has one backend,
#: `ExecutionConfig.backend`)
_DROPPED = {"frontend_block", "light_block", "residual_block",
            "frontend_backend", "light_backend", "residual_backend"}
#: JAX LongReadConfig fields with no counterpart here, for the same reasons
_LR_DROPPED = {"vote_backend", "vote_block"}


def config_from_fields(cls, fields: dict):
    """One of `SeedMapConfig`, `PipelineConfig`, `LongReadConfig`,
    `Scoring` from the JAX config's ``dataclasses.asdict``.

    A nested scoring dict becomes a `Scoring` and a nested pipe dict a
    `PipelineConfig`; TPU launch-block sizes and per-family kernel
    backends are dropped (every backend gives the same results; a session
    here picks one with `ExecutionConfig.backend`); any other unknown
    field raises.
    """
    fields = dict(fields)
    if cls is LongReadConfig:
        for k in _LR_DROPPED:
            fields.pop(k, None)
        if isinstance(fields.get("pipe"), dict):
            fields["pipe"] = config_from_fields(PipelineConfig,
                                                fields["pipe"])
    if cls is PipelineConfig:
        for k in _DROPPED:
            fields.pop(k, None)
        if isinstance(fields.get("scoring"), dict):
            fields["scoring"] = Scoring(**fields["scoring"])
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**fields)


def seedmap_from_numpy(offsets, locations, config_fields: dict,
                       device="cpu") -> SeedMap:
    """The JAX `SeedMap`'s CSR arrays -> this package's `SeedMap`."""
    return SeedMap(
        offsets=torch.tensor(np.asarray(offsets, np.int32), device=device),
        locations=torch.tensor(np.asarray(locations, np.int32),
                               device=device),
        config=config_from_fields(SeedMapConfig, config_fields))


def padded_from_numpy(rows, counts, config_fields: dict,
                      device="cpu") -> PaddedSeedMap:
    """The JAX `PaddedSeedMap`'s arrays -> this package's."""
    return PaddedSeedMap(
        rows=torch.tensor(np.asarray(rows, np.int32), device=device),
        counts=torch.tensor(np.asarray(counts, np.int32), device=device),
        config=config_from_fields(SeedMapConfig, config_fields))


def sharded_from_numpy(offsets, locations, config_fields: dict,
                       shard: int | None = None, device="cpu"
                       ) -> ShardedSeedMap | SeedMapShard:
    """The JAX `ShardedSeedMap`'s arrays (offsets (D, T/D + 1), locations
    (D, Nmax)) -> this package's `ShardedSeedMap`, or with ``shard`` the
    `SeedMapShard` one rank of the model axis keeps."""
    ssm = ShardedSeedMap(
        offsets=torch.tensor(np.asarray(offsets, np.int32)),
        locations=torch.tensor(np.asarray(locations, np.int32)),
        config=config_from_fields(SeedMapConfig, config_fields))
    if shard is not None:
        return ssm.shard(shard, device)
    return ssm._replace(offsets=ssm.offsets.to(device),
                        locations=ssm.locations.to(device))
