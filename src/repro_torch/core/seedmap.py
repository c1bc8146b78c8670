"""SeedMap (§4.2): the offline two-table index of the reference genome.

Layout (paper-faithful CSR):
  - Seed Table  -> `offsets`: int32[T + 1].  Bucket b's locations live at
    `locations[offsets[b]:offsets[b+1]]`, where b = xxhash32(seed) & (T-1).
  - Location Table -> `locations`: int32[N], reference positions grouped by
    bucket and ascending within a bucket.

Buckets with more than `max_locations` entries are removed (§5.2).
`PaddedSeedMap` is the bucket-major fixed-width layout the GPU front-end
kernel gathers rows from.

Both functions run on the device they are given with torch ops, so a
chromosome-scale index (2^27 bases, 2^26 buckets) is built on the card
without the host-side (T, cap) index tensors a numpy relayout needs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.hashing import xxhash32_words

INVALID_LOC = 2**31 - 1  # sentinel: sorts after every real position

#: seed positions hashed per chunk while building (bounds int64 temporaries)
HASH_CHUNK = 1 << 23


@dataclasses.dataclass(frozen=True)
class SeedMapConfig:
    seed_len: int = 50
    table_bits: int = 20          # T = 2**table_bits buckets
    max_locations: int = 500      # index-filtering threshold (paper: 500)
    hash_seed: int = 0
    padded_cap: int = 32          # row width of the padded (kernel) layout

    @property
    def table_size(self) -> int:
        return 1 << self.table_bits


class SeedMap(NamedTuple):
    """CSR index."""

    offsets: torch.Tensor    # int32[T + 1]
    locations: torch.Tensor  # int32[N]
    config: SeedMapConfig

    @property
    def n_locations(self) -> int:
        return self.locations.shape[0]


class PaddedSeedMap(NamedTuple):
    """Bucket-major fixed-width layout for the GPU front-end kernel."""

    rows: torch.Tensor    # int32[T, cap], INVALID_LOC-padded
    counts: torch.Tensor  # int32[T], min(count, cap)
    config: SeedMapConfig


def _rolling_words(ref: torch.Tensor) -> torch.Tensor:
    """pw[k] = bases k..k+15 packed little-endian (int64), k in [0, L-16]."""
    L = ref.shape[0]
    r = ref.to(torch.int64)
    pw = torch.zeros(L - 15, dtype=torch.int64, device=ref.device)
    for i in range(16):
        pw |= r[i:L - 15 + i] << (2 * i)
    return pw


def _seed_words(ref: torch.Tensor, pw: torch.Tensor, seed_len: int,
                lo: int, hi: int) -> torch.Tensor:
    """(hi-lo, 4) int64 packed words of the seeds starting at [lo, hi)."""
    n_full, rem = divmod(seed_len, 16)
    n = hi - lo
    words = torch.zeros((n, 4), dtype=torch.int64, device=ref.device)
    for j in range(n_full):
        words[:, j] = pw[lo + 16 * j:hi + 16 * j]
    if rem:
        r = ref.to(torch.int64)
        base0 = lo + 16 * n_full
        for i in range(rem):
            words[:, n_full] |= r[base0 + i:base0 + i + n] << (2 * i)
    return words


def build_seedmap(ref: torch.Tensor, config: SeedMapConfig = SeedMapConfig(),
                  device=None) -> SeedMap:
    """Offline SeedMap construction (§4.2, Fig. 4a) on ``device``.

    (1) hash every seed position (in chunks), (2) stable-sort positions by
    bucket, (3) count per bucket and drop over-full buckets, (4) prefix-sum
    the Seed Table.  Bit-identical to the JAX package's numpy build.
    """
    ref = torch.as_tensor(ref, dtype=torch.uint8, device=device)
    L = ref.shape[0]
    n_pos = L - config.seed_len + 1
    if n_pos <= 0:
        raise ValueError("reference shorter than seed length")
    if config.seed_len > 64:
        raise ValueError("seed_len > 64 not supported (4-word hash input)")
    pw = _rolling_words(ref)
    T = config.table_size
    buckets = torch.empty(n_pos, dtype=torch.int32, device=ref.device)
    for lo in range(0, n_pos, HASH_CHUNK):
        hi = min(lo + HASH_CHUNK, n_pos)
        h = xxhash32_words(_seed_words(ref, pw, config.seed_len, lo, hi),
                           seed=config.hash_seed)
        buckets[lo:hi] = (h & (T - 1)).to(torch.int32)
    del pw
    sorted_buckets, order = torch.sort(buckets, stable=True)
    del buckets
    sorted_pos = order.to(torch.int32)   # positions == arange, so order
    del order
    counts = torch.bincount(sorted_buckets, minlength=T)
    dropped = counts > config.max_locations
    if bool(dropped.any()):
        sorted_pos = sorted_pos[~dropped[sorted_buckets.to(torch.int64)]]
        counts = torch.where(dropped, 0, counts)
    offsets = torch.zeros(T + 1, dtype=torch.int32, device=ref.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return SeedMap(offsets=offsets, locations=sorted_pos, config=config)


def to_padded(sm: SeedMap, cap: int | None = None) -> PaddedSeedMap:
    """CSR -> bucket-major fixed-width rows (truncating at ``cap``), on the
    device the SeedMap lives on.

    Each kept location is scattered to ``rows[bucket, rank]`` with its rank
    inside the bucket, so memory stays O(N) beside the (T, cap) rows.
    """
    cfg = sm.config
    if cap is not None and cap != cfg.padded_cap:
        cfg = dataclasses.replace(cfg, padded_cap=cap)
    T, cap = cfg.table_size, cfg.padded_cap
    dev = sm.offsets.device
    full = (sm.offsets[1:] - sm.offsets[:-1]).to(torch.int64)
    counts = full.clamp(max=cap).to(torch.int32)
    rows = torch.full((T * cap,), INVALID_LOC, dtype=torch.int32, device=dev)
    N = sm.locations.shape[0]
    if N:
        bucket = torch.repeat_interleave(
            torch.arange(T, device=dev), full, output_size=N)
        rank = torch.arange(N, device=dev) - sm.offsets[:-1].to(
            torch.int64)[bucket]
        keep = rank < cap
        rows[bucket[keep] * cap + rank[keep]] = sm.locations[keep]
    return PaddedSeedMap(rows=rows.view(T, cap), counts=counts, config=cfg)


def seedmap_stats(sm: SeedMap) -> dict:
    """Observation-2 style stats: locations per non-empty bucket etc. (one
    host fetch of the counts)."""
    counts = (sm.offsets[1:] - sm.offsets[:-1]).to(torch.int64)
    nonzero = counts[counts > 0]
    return {
        "table_size": sm.config.table_size,
        "n_locations": int(sm.locations.shape[0]),
        "n_nonempty_buckets": int(nonzero.numel()),
        "mean_locs_per_nonempty_bucket": (
            float(nonzero.double().mean()) if nonzero.numel() else 0.0),
        "max_locs_per_bucket": int(counts.max()) if counts.numel() else 0,
    }
