"""Plain PyTorch version of the seed_gather kernel.

jnp's ``table[ids]`` wraps a negative id once (id + T) and clamps every
id to [0, T - 1]; PyTorch's indexing raises instead, so the ids are
normalised here first, in int64.
"""
import torch


def normalise_ids(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Row indices of ``ids`` into an ``n_rows``-row table, as jnp maps
    out-of-range ids."""
    i = ids.to(torch.int64)
    return torch.where(i < 0, i + n_rows, i).clamp(0, n_rows - 1)


def seed_gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[normalise_ids(ids, table.shape[0])]
