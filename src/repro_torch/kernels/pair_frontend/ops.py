"""Public wrappers of the fused pipeline front end (steps 1-3).

On CUDA tensors `pair_frontend` runs two kernels: `seed_buckets` hashes
both mates' seeds into (2B, S) bucket ids, and `pair_frontend` gathers
the padded rows, merges, filters and compacts, so the (B, S, K) location
tensor and the sorted start lists never reach device memory.
`frontend_merge_filter` is the post-query entry, for (B, S, K) locations
already gathered (the sharded-index serve step): one `merge_filter`
kernel.  Both kernels run csrc/merge_filter.cuh's block, one warp per
pair, which sorts only each mate's valid starts and probes only mate 1's.
On CPU tensors (or with ``backend="torch"``) each runs its plain version
in `ref.py`.  ``block`` is the kernels' warps (pairs) a block
(`frontend_warps`): None for the default, a value the kernels cannot take
raises on either backend; the result does not depend on it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.seeding import seed_offsets_tuple
from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import INT, PTR, U32
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.pair_frontend.ref import (
    FrontendResult,
    merge_filter_ref,
    pair_frontend_ref,
)

# The work that depends on the data, where a caller has none (a dry run):
# the valid seed hits of a mate (h of its S*K slots) on chip_smoke.py's
# pair-lane batch (65,536 pairs at sub_rate 0.01 against a 2^27-base
# random reference: 7.785 of 96).
HITS_PER_MATE = 7.785


def seed_buckets_cost(B: int, R: int, S: int, seed_len: int) -> _cuda.Work:
    """Both mates read once, the (2B, S) ids written; each seed's 2-bit
    packing (2 operations a base) and its xxhash (~40)."""
    return _cuda.Work(2 * B * R + 2 * B * S * 4,
                      2 * B * S * (2 * seed_len + 40))


def _merge_ops(B: int, hits1, hits2) -> float:
    """The merge + Δ filter's own work over B pairs: each mate's h valid
    starts sorted (2 h log2 h), a search of mate 1's into mate 2's
    (2 h1 log2 h2), and O(h1) probing, dedup and compaction.  ``hits1``,
    ``hits2``: each pair's valid hits (tensors), or None for
    `HITS_PER_MATE` a mate."""
    if hits1 is None:
        h = HITS_PER_MATE
        return B * (6 * h * math.log2(max(h, 2)) + 12 * h)
    h1, h2 = hits1.double(), hits2.double()

    def nlogn(h, n):
        return h * torch.log2(n.clamp(min=2))

    return float((2 * nlogn(h1, h1) + 2 * nlogn(h2, h2) + 2 * nlogn(h1, h2)
                  + 12 * h1).sum())


def pair_frontend_cost(B: int, S: int, K: int, C: int, hits1=None,
                       hits2=None) -> _cuda.Work:
    """The (2B, S) ids and their K-wide rows read, the results written;
    each mate's S*K row slots scanned, then `_merge_ops`."""
    M = S * K
    return _cuda.Work(2 * B * S * 4 + 2 * B * M * 4 + B * (2 * C + 3) * 4,
                      2 * B * M + _merge_ops(B, hits1, hits2))


def merge_filter_cost(B: int, S: int, K: int, C: int, hits1=None,
                      hits2=None) -> _cuda.Work:
    """`pair_frontend_cost` without the ids and the row scan: the gathered
    (2B, S, K) locations read, the results written, `_merge_ops`."""
    M = S * K
    return _cuda.Work(2 * B * M * 4 + B * (2 * C + 3) * 4,
                      _merge_ops(B, hits1, hits2))


SEED_BUCKETS = _cuda.register(
    "seed_buckets", "seed_buckets_launch",
    (PTR, PTR, INT, INT, PTR, INT, INT, U32, U32, PTR, PTR),
    seed_buckets_cost)
PAIR_FRONTEND = _cuda.register(
    "pair_frontend", "pair_frontend_launch",
    (PTR, INT, PTR, INT, INT, PTR, INT, INT, PTR, PTR, PTR, PTR, PTR, INT,
     PTR), pair_frontend_cost)

MERGE_FILTER = _cuda.register(
    "merge_filter", "merge_filter_launch",
    (PTR, PTR, INT, INT, INT, PTR, INT, INT, PTR, PTR, PTR, PTR, PTR, INT,
     PTR), merge_filter_cost)

MAX_SHARED = 48 * 1024
MAX_SEEDS = 16
MAX_WARPS = 32            # 1,024 threads a block
DEFAULT_WARPS = 8


def frontend_warps(S: int, K: int, block: int | None = None) -> int:
    """Warps (pairs) a block of the pair_frontend and merge_filter kernels.

    Each warp holds 4*S*K ints of its pair in shared memory
    (csrc/merge_filter.cuh).  None gives the default: 8, or as many as fit
    48 KB (csrc/merge_filter.cuh::merge_filter_warps).  An explicit
    ``block`` past 1,024 threads or 48 KB raises; nothing is clamped."""
    fit = MAX_SHARED // (4 * S * K * 4)
    if fit < 1:
        raise ValueError(f"S*K = {S * K} exceeds the kernel's shared memory")
    if block is None:
        return min(DEFAULT_WARPS, fit)
    top = min(MAX_WARPS, fit)
    if not 1 <= block <= top:
        raise ValueError(f"pair_frontend takes 1..{top} warps a block at "
                         f"S*K = {S * K}, got {block}")
    return block


@functools.lru_cache(maxsize=64)
def _seed_offsets(read_len: int, seed_len: int, seeds_per_read: int
                  ) -> tuple[int, ...]:
    """`seed_offsets_tuple`, computed once per shape: a mapping step calls
    the front end once per batch, and the pair step's host time bounds
    it."""
    return seed_offsets_tuple(read_len, seed_len, seeds_per_read)


@functools.lru_cache(maxsize=64)
def _offsets_array(offs: tuple[int, ...]) -> ctypes.Array:
    """The launchers' host int array of the seed offsets, built once per
    tuple (the launcher copies it into the kernel's arguments)."""
    return _cuda.int_array(offs)


def _frontend_outputs(B: int, C: int, dev) -> tuple:
    pos1 = torch.empty((B, C), dtype=torch.int32, device=dev)
    pos2 = torch.empty((B, C), dtype=torch.int32, device=dev)
    return (pos1, pos2) + tuple(torch.empty((B,), dtype=torch.int32,
                                            device=dev) for _ in range(3))


def seed_buckets(reads1: torch.Tensor, reads2: torch.Tensor, seed_len: int,
                 seeds_per_read: int, hash_seed: int,
                 table_size: int) -> torch.Tensor:
    """Kernel: (B, R) uint8 mates -> (2B, S) int32 bucket ids (mate-1 rows
    first)."""
    B, R = reads1.shape
    _cuda.check(reads1, "reads1", torch.uint8)
    _cuda.check(reads2, "reads2", torch.uint8, (B, R))
    offs = _seed_offsets(R, seed_len, seeds_per_read)
    if len(offs) > MAX_SEEDS or seed_len > 64:
        raise ValueError("seed_buckets supports S <= 16 seeds of <= 64 bp")
    if table_size & (table_size - 1):
        raise ValueError("table_size must be a power of two")
    out = torch.empty((2 * B, len(offs)), dtype=torch.int32,
                      device=reads1.device)
    SEED_BUCKETS(reads1, reads2, B, R, _offsets_array(offs), len(offs),
                 seed_len, hash_seed & 0xFFFFFFFF, table_size - 1, out,
                 stream=reads1, work=(B, R, len(offs), seed_len))
    return out


def frontend_from_buckets(rows: torch.Tensor, buckets: torch.Tensor,
                          seed_offs: tuple, delta: int, max_candidates: int,
                          block: int | None = None) -> FrontendResult:
    """Kernel: padded rows (T, K) + (2B, S) bucket ids -> FrontendResult,
    ``block`` warps a block (`frontend_warps`)."""
    K = rows.shape[1]
    n2, S = buckets.shape
    B = n2 // 2
    C = max_candidates
    _cuda.check(rows, "rows", torch.int32)
    _cuda.check(buckets, "buckets", torch.int32, (2 * B, len(seed_offs)))
    if S > MAX_SEEDS:
        raise ValueError(f"pair_frontend supports S <= {MAX_SEEDS} seeds")
    warps = frontend_warps(S, K, block)
    pos1, pos2, n, nh1, nh2 = _frontend_outputs(B, C, rows.device)
    PAIR_FRONTEND(rows, K, buckets, B, S, _offsets_array(tuple(seed_offs)),
                  delta, C, pos1, pos2, n, nh1, nh2, warps, stream=rows,
                  work=(B, S, K, C))
    return FrontendResult(pos1=pos1, pos2=pos2, n=n, n_hits1=nh1,
                          n_hits2=nh2)


def frontend_merge_filter(
    locs1: torch.Tensor,     # (B, S, K) int32 per-seed locations, mate 1
    locs2: torch.Tensor,     # (B, S, K) int32, mate 2
    seed_offs: tuple,        # the S seed offsets within the read
    delta: int,
    max_candidates: int,
    block: int | None = None,
    backend: str = "auto",
) -> FrontendResult:
    """Conversion + sorted merge + Δ filter + compaction (steps 2.5-3) of
    locations already gathered by a (possibly sharded) SeedMap query."""
    backend = resolve_backend(backend, locs1.device, family="pair_frontend")
    if block is not None:
        frontend_warps(locs1.shape[1], locs1.shape[2], block)
    if backend == "torch":
        offs = torch.tensor(seed_offs, dtype=torch.int32, device=locs1.device)
        return merge_filter_ref(locs1, locs2, offs, delta, max_candidates)
    B, S, K = locs1.shape
    C = max_candidates
    _cuda.check(locs1, "locs1", torch.int32, (B, len(seed_offs), K))
    _cuda.check(locs2, "locs2", torch.int32, (B, S, K))
    if S > MAX_SEEDS:
        raise ValueError(f"merge_filter supports S <= {MAX_SEEDS} seeds")
    warps = frontend_warps(S, K, block)
    pos1, pos2, n, nh1, nh2 = _frontend_outputs(B, C, locs1.device)
    MERGE_FILTER(locs1, locs2, B, S, K, _offsets_array(tuple(seed_offs)),
                 delta, C, pos1, pos2, n, nh1, nh2, warps, stream=locs1,
                 work=(B, S, K, C))
    return FrontendResult(pos1=pos1, pos2=pos2, n=n, n_hits1=nh1,
                          n_hits2=nh2)


def pair_frontend(
    rows: torch.Tensor,      # (T, K) int32 padded location rows
    reads1: torch.Tensor,    # (B, R) uint8 mate 1, reference orientation
    reads2: torch.Tensor,    # (B, R) uint8 mate 2, reference orientation
    seed_len: int,
    seeds_per_read: int = 3,
    hash_seed: int = 0,
    delta: int = 500,
    max_candidates: int = 8,
    block: int | None = None,
    backend: str = "auto",
) -> FrontendResult:
    """Fused front end for a batch of read pairs (steps 1-3)."""
    backend = resolve_backend(backend, rows.device, family="pair_frontend")
    if block is not None:
        frontend_warps(seeds_per_read, rows.shape[1], block)
    if backend == "torch":
        return pair_frontend_ref(rows, reads1, reads2, seed_len,
                                 seeds_per_read, hash_seed, delta,
                                 max_candidates)
    T = rows.shape[0]
    buckets = seed_buckets(reads1, reads2, seed_len, seeds_per_read,
                           hash_seed, T)
    offs = _seed_offsets(reads1.shape[1], seed_len, seeds_per_read)
    return frontend_from_buckets(rows, buckets, offs, delta, max_candidates,
                                 block)


def segment_pair_frontend(
    rows: torch.Tensor,      # (T, K) int32 padded location rows
    reads: torch.Tensor,     # (B, L) uint8 long reads, reference orientation
    segment_len: int,
    segment_stride: int,
    seed_len: int,
    seeds_per_read: int = 3,
    hash_seed: int = 0,
    delta: int = 500,
    max_candidates: int = 8,
    block: int | None = None,
    backend: str = "auto",
) -> FrontendResult:
    """Long-read pseudo-pair front end (§4.7).

    Each read is cut into ``segment_len``-wide segments every
    ``segment_stride`` bases; segments ``[:, :-1]`` and ``[:, 1:]`` become
    the mates of ``S - 1`` pseudo-pairs per read, made contiguous as
    ``(B * (S-1), segment_len)`` and routed through `pair_frontend`
    unchanged.  Mate 2 is not reverse-complemented: both segments already
    sit in reference orientation.
    """
    # call-time import: core.long_read imports this module
    from repro_torch.core.long_read import segment_views

    segs = segment_views(reads, segment_len, segment_stride)
    B, S, R = segs.shape
    r1 = segs[:, :-1].reshape(B * (S - 1), R).contiguous()
    r2 = segs[:, 1:].reshape(B * (S - 1), R).contiguous()
    return pair_frontend(rows, r1, r2, seed_len, seeds_per_read, hash_seed,
                         delta, max_candidates, block=block, backend=backend)
