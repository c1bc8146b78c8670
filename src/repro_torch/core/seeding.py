"""Partitioned Seeding (§4.3): non-overlapping seeds per read (3 by default).

Seeds are the first, middle and last `seed_len` bases of each read.  Each
seed is 2-bit packed into 4 zero-padded words and hashed with xxHash32.
The `seed_buckets` CUDA kernel (kernels/pair_frontend) computes the same
bucket ids in one pass over both mates.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.encoding import pack_2bit, revcomp
from repro_torch.core.hashing import xxhash32_words

SEED_WORDS = 4  # 50 bases -> 100 bits -> 4 zero-padded 32-bit words


class SeedSet(NamedTuple):
    """Seeds of one read batch.

    hashes:  (B, S) int64 xxHash32 values in [0, 2^32)
    offsets: (S,)  int32 offset of each seed's first base within the read
    """

    hashes: torch.Tensor
    offsets: torch.Tensor


def seed_offsets_np(read_len: int, seed_len: int,
                    seeds_per_read: int = 3) -> np.ndarray:
    """First/middle/last placement, rounded half-to-even (generalizes to
    any S)."""
    if seeds_per_read * seed_len > read_len:
        raise ValueError(
            f"{seeds_per_read} seeds of {seed_len} bp do not fit a "
            f"{read_len} bp read")
    if seeds_per_read == 1:
        return np.array([0], dtype=np.int32)
    span = read_len - seed_len
    return np.round(
        np.arange(seeds_per_read) * span / (seeds_per_read - 1)
    ).astype(np.int32)


def seed_offsets_tuple(read_len: int, seed_len: int,
                       seeds_per_read: int = 3) -> tuple[int, ...]:
    """Placements as a tuple of Python ints (the kernels' launch form)."""
    return tuple(int(o) for o in
                 seed_offsets_np(read_len, seed_len, seeds_per_read))


def seed_offsets(read_len: int, seed_len: int, seeds_per_read: int = 3,
                 device=None) -> torch.Tensor:
    return torch.as_tensor(seed_offsets_np(read_len, seed_len, seeds_per_read),
                           device=device)


def extract_seeds(reads: torch.Tensor, seed_len: int,
                  seeds_per_read: int = 3) -> torch.Tensor:
    """(B, L) uint8 -> (B, S, seed_len) uint8 seed windows."""
    offs = seed_offsets(reads.shape[-1], seed_len, seeds_per_read,
                        reads.device).to(torch.int64)
    idx = offs[:, None] + torch.arange(seed_len, device=reads.device)
    return reads[..., idx]


def hash_seeds(seeds: torch.Tensor, hash_seed: int = 0) -> torch.Tensor:
    """(..., seed_len) uint8 -> (...,) int64 hashes in [0, 2^32)."""
    return xxhash32_words(pack_2bit(seeds, n_words=SEED_WORDS),
                          seed=hash_seed)


def seed_read_batch(
    reads: torch.Tensor,
    seed_len: int,
    seeds_per_read: int = 3,
    hash_seed: int = 0,
    reverse_complement: bool = False,
) -> SeedSet:
    """Partitioned Seeding for a batch of reads (read 2 of an FR pair is
    RC'd with ``reverse_complement=True``)."""
    if reverse_complement:
        reads = revcomp(reads)
    seeds = extract_seeds(reads, seed_len, seeds_per_read)
    return SeedSet(
        hashes=hash_seeds(seeds, hash_seed=hash_seed),
        offsets=seed_offsets(reads.shape[-1], seed_len, seeds_per_read,
                             reads.device),
    )
