"""Carry state from the JAX package into this one.

The mapper has no weights; its state is the index and the reference.
The LM path has weights: `lm_params_from_jax` carries a JAX
parameter tree across, and `opt_state_from_jax` /
`compress_state_from_jax` its optimizer and gradient-codec state.  These helpers take the JAX package's arrays and config fields as plain
numpy / dicts (``np.asarray`` of its `SeedMap` / `PaddedSeedMap` /
`ShardedSeedMap` fields,
``dataclasses.asdict`` of its configs), so both packages can map against
the same index without this package importing the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config_fields import config_from_fields
from repro_torch.core.distributed import SeedMapShard, ShardedSeedMap
from repro_torch.core.seedmap import PaddedSeedMap, SeedMap, SeedMapConfig
from repro_torch.models.template import leaves
from repro_torch.models.transformer import model_template
from repro_torch.optim.adamw import OptState
from repro_torch.optim.compress import CompressState
from repro_torch.tree import tree_map


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


def lm_params_from_jax(params_np, cfg: ModelConfig, device="cpu") -> dict:
    """The JAX package's LM parameter tree (nested dicts of numpy leaves,
    layer-stacked ``(L, ...)``, e.g. ``jax.tree.map(np.asarray, params)``)
    -> this package's parameters for ``cfg``.

    Every leaf of `model_template` must be there with its shape and no
    other leaf may be; values and dtypes are kept as they are.
    """
    def flat(tree, prefix=""):
        if not isinstance(tree, dict):
            yield prefix, tree
            return
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}" if prefix else k)

    given = dict(flat(params_np))
    want = dict(leaves(model_template(cfg)))
    if set(given) != set(want):
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(set(want) - set(given))}, unexpected "
                         f"{sorted(set(given) - set(want))}")
    out: dict = {}
    for path, lf in want.items():
        arr = np.asarray(given[path])
        if arr.shape != tuple(lf.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{tuple(lf.shape)}")
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = _tensor(arr, device)
    return out


def _tensor(arr, device) -> torch.Tensor:
    """A copy of a numpy array (ml_dtypes bfloat16 included) on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # ml_dtypes: no numpy dtype in torch
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.as_tensor(arr.copy())
    return t.to(device)


def opt_state_from_jax(state_np, device="cpu") -> OptState:
    """The JAX package's `OptState` (m, v, step) with numpy leaves, e.g.
    ``jax.tree.map(np.asarray, state)`` -> this package's: AdamW's m and v
    trees, or Adafactor's () and v tree whose factored leaves are (row,
    col) tuples; the step an int32 0-d tensor."""
    m, v, step = state_np
    return OptState(tree_map(lambda a: _tensor(a, device), m),
                    tree_map(lambda a: _tensor(a, device), v),
                    torch.as_tensor(np.array(step, np.int32),
                                    device=device))


def compress_state_from_jax(state_np, device="cpu") -> CompressState:
    """The JAX package's `CompressState` (its int8 error tree, or ()) with
    numpy leaves -> this package's."""
    return CompressState(tree_map(lambda a: _tensor(a, device),
                                  state_np.error))
