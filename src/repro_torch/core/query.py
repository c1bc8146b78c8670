"""SeedMap Query (§4.4): retrieve candidate locations for hashed seeds.

Locations are converted to *read start positions* (location - seed offset
in the read) and the per-read lists of all seeds are merged sorted.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.seedmap import INVALID_LOC, PaddedSeedMap, SeedMap
from repro_torch.core.seeding import SeedSet


class QueryResult(NamedTuple):
    """Sorted candidate read-start positions per read.

    starts: (B, M) int32 ascending, INVALID_LOC padded
    n_hits: (B,)  int32 number of valid entries
    """

    starts: torch.Tensor
    n_hits: torch.Tensor


def query_csr(sm: SeedMap, hashes: torch.Tensor, max_locs_per_seed: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather up to K locations per seed hash.

    hashes: (...,) integer hashes -> locations (..., K) int32 (INVALID_LOC
    padded, ascending within the valid prefix), counts (...,) int32.
    """
    K = max_locs_per_seed
    dev = sm.offsets.device
    bucket = (hashes.to(torch.int64) & (sm.config.table_size - 1))
    start = sm.offsets[bucket].to(torch.int64)
    end = sm.offsets[bucket + 1].to(torch.int64)
    count = torch.clamp(end - start, max=K)
    ar = torch.arange(K, device=dev)
    idx = start[..., None] + ar
    valid = ar < count[..., None]
    n_loc = sm.locations.shape[0]
    if n_loc:
        locs = sm.locations[idx.clamp(0, n_loc - 1)]
    else:
        locs = torch.full(idx.shape, INVALID_LOC, dtype=torch.int32,
                          device=dev)
    locs = torch.where(valid, locs, INVALID_LOC)
    return locs, count.to(torch.int32)


def query_padded(psm: PaddedSeedMap, hashes: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row gather from the padded layout (fixed K = padded_cap): hashes
    (...,) -> rows (..., K) int32 and counts (...,) int32."""
    bucket = hashes.to(torch.int64) & (psm.config.table_size - 1)
    return psm.rows[bucket], psm.counts[bucket]


def padded_rows_device(sm: SeedMap, cap: int) -> torch.Tensor:
    """CSR -> (T, cap) padded rows via `query_csr` over every bucket id.

    Materializes T*cap int64 indices: a test-scale helper; sessions build
    a `PaddedSeedMap` once with `to_padded`.
    """
    T = sm.config.table_size
    locs, _ = query_csr(sm, torch.arange(T, device=sm.offsets.device), cap)
    return locs


def merge_read_starts(locs: torch.Tensor, seed_offsets: torch.Tensor
                      ) -> QueryResult:
    """Convert per-seed locations to read-start positions and merge sorted.

    locs: (B, S, K) int32 per-seed locations (INVALID_LOC padded);
    seed_offsets: (S,) offset of each seed within the read
    -> QueryResult with starts (B, S*K) ascending.  A seed at read offset
    o hitting reference position l implies the read begins at l - o.
    """
    valid = locs != INVALID_LOC
    starts = torch.where(
        valid, locs - seed_offsets.to(torch.int32)[None, :, None],
        INVALID_LOC)
    flat = starts.reshape(starts.shape[0], -1)
    flat = torch.sort(flat, dim=-1).values
    n = valid.reshape(valid.shape[0], -1).sum(dim=-1).to(torch.int32)
    return QueryResult(starts=flat, n_hits=n)


def query_read_batch(sm: SeedMap, seeds: SeedSet, max_locs_per_seed: int
                     ) -> QueryResult:
    """Full SeedMap Query step for one read of the pair."""
    locs, _ = query_csr(sm, seeds.hashes, max_locs_per_seed)
    return merge_read_starts(locs, seeds.offsets)
