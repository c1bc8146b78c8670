"""Plain PyTorch version of the fused pipeline front end (steps 1-3).

Partitioned Seeding (`core.seeding`), padded-row SeedMap lookup +
`merge_read_starts` (`core.query`) and Paired-Adjacency Filtering
(`core.pair_filter`), staged.  The three CUDA kernels of the family compute
`seed_buckets_ref`, `frontend_from_buckets_ref` and `merge_filter_ref`
respectively.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.pair_filter import paired_adjacency_filter
from repro_torch.core.query import merge_read_starts
from repro_torch.core.seeding import extract_seeds, hash_seeds, seed_offsets


class FrontendResult(NamedTuple):
    """Front-end output for a batch of read pairs.

    pos1, pos2: (B, C) int32 candidate read-start pairs (INVALID_LOC padded)
    n:          (B,)   int32 surviving candidate count (<= C)
    n_hits1/2:  (B,)   int32 SeedMap hit count per mate
    """

    pos1: torch.Tensor
    pos2: torch.Tensor
    n: torch.Tensor
    n_hits1: torch.Tensor
    n_hits2: torch.Tensor


def seed_buckets_ref(reads: torch.Tensor, seed_len: int, seeds_per_read: int,
                     hash_seed: int, table_size: int) -> torch.Tensor:
    """(N, R) reads (reference orientation) -> (N, S) int32 bucket ids."""
    hashes = hash_seeds(extract_seeds(reads, seed_len, seeds_per_read),
                        hash_seed=hash_seed)
    return (hashes & (table_size - 1)).to(torch.int32)


def merge_filter_ref(locs1: torch.Tensor, locs2: torch.Tensor,
                     offsets: torch.Tensor, delta: int, max_candidates: int
                     ) -> FrontendResult:
    """Merge + Δ filter of locations already gathered: (B, S, K) int32 per
    mate (INVALID_LOC padded), (S,) seed offsets -> FrontendResult."""
    q1 = merge_read_starts(locs1, offsets)
    q2 = merge_read_starts(locs2, offsets)
    cands = paired_adjacency_filter(q1, q2, delta, max_candidates)
    return FrontendResult(pos1=cands.pos1, pos2=cands.pos2, n=cands.n,
                          n_hits1=q1.n_hits, n_hits2=q2.n_hits)


def frontend_from_buckets_ref(rows: torch.Tensor, buckets1: torch.Tensor,
                              buckets2: torch.Tensor, offsets: torch.Tensor,
                              delta: int, max_candidates: int
                              ) -> FrontendResult:
    """Row gather + merge + Δ filter given both mates' (B, S) bucket ids
    and the padded rows (T, K)."""
    return merge_filter_ref(rows[buckets1.to(torch.int64)],
                            rows[buckets2.to(torch.int64)], offsets, delta,
                            max_candidates)


def pair_frontend_ref(rows, reads1, reads2, seed_len: int,
                      seeds_per_read: int, hash_seed: int, delta: int,
                      max_candidates: int) -> FrontendResult:
    """Staged front end: seeding -> padded lookup -> merge -> Δ filter."""
    T = rows.shape[0]
    offs = seed_offsets(reads1.shape[1], seed_len, seeds_per_read,
                        rows.device)
    b1 = seed_buckets_ref(reads1, seed_len, seeds_per_read, hash_seed, T)
    b2 = seed_buckets_ref(reads2, seed_len, seeds_per_read, hash_seed, T)
    return frontend_from_buckets_ref(rows, b1, b2, offs, delta,
                                     max_candidates)
