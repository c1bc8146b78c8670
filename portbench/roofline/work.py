"""The work of each pair-lane kernel launch, frozen, and the card's peaks.

The formulas are those the program's kernels were designed against
(each kernel's cost function beside its wrapper), copied here so that a
later change to the program cannot move the yardstick.  They take the
counts that the benchmark's own reference works out on the batches a
run sends (valid hits, kept candidates, residual items), never the
program's outputs.  Bytes count each input read once and each output
written once; operations count the int32 work of the algorithm.

Peaks, one NVIDIA H100 SXM5 80GB at its 700 W limit: HBM3 3.35 TB/s
(published, NVIDIA's data sheet).  int32 16.7 Tops/s is *derived*, not
published: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the Hopper
architecture white paper's counts).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12                 # published
INT32_OPS_PER_S = 132 * 64 * 1.98e9       # derived: SMs x lanes x clock

#: the device symbol of each kernel, as the profiler names its launches
SYMBOLS = {
    "seed_buckets": "seed_buckets_kernel",
    "pair_frontend": "pair_frontend_kernel",
    "candidate_align": "candidate_align_kernel",
    "residual_dp": "residual_dp_kernel",
}


class Work(NamedTuple):
    bytes: float
    ops: float


def bound_s(w: Work) -> float:
    """Least seconds the card needs for ``w``: the larger of its bytes at
    the HBM peak and its operations at the int32 peak."""
    return max(w.bytes / HBM_BYTES_PER_S, w.ops / INT32_OPS_PER_S)


def seed_buckets(B: int, R: int, S: int, seed_len: int) -> Work:
    """Both mates read once, the (2B, S) bucket ids written; each seed's
    2-bit packing (2 operations a base) and its xxHash32 (~40)."""
    return Work(2 * B * R + 2 * B * S * 4, 2 * B * S * (2 * seed_len + 40))


def merge_ops(hits1, hits2) -> float:
    """The merge and Δ filter of every pair: each mate's h valid starts
    sorted (2 h log2 h), a search of mate 1's into mate 2's (2 h1 log2
    h2), and O(h1) probing, dedup and compaction; ``hits1``, ``hits2``
    are the pairs' valid hits (arrays)."""
    h1 = np.asarray(hits1, dtype=np.float64)
    h2 = np.asarray(hits2, dtype=np.float64)
    l1 = np.log2(np.maximum(h1, 2))
    l2 = np.log2(np.maximum(h2, 2))
    return float((2 * h1 * l1 + 2 * h2 * l2 + 2 * h1 * l2 + 12 * h1).sum())


def pair_frontend(B: int, S: int, K: int, C: int, hits1, hits2) -> Work:
    """The (2B, S) ids and their K-wide rows read, the results written;
    each mate's S*K row slots scanned, then the merge."""
    M = S * K
    return Work(2 * B * S * 4 + 2 * B * M * 4 + B * (2 * C + 3) * 4,
                2 * B * M + merge_ops(hits1, hits2))


def candidate_align(B: int, R: int, C: int, E: int, n_cand) -> Work:
    """Both mates and the (B, C) candidates read, one packed R + 2E window
    for each valid candidate of each mate (a pair without any aligns one)
    and the results written; each alignment's 2E + 1 shifts of R compares
    at ~6 operations."""
    W = R + 2 * E
    n_align = 2 * int(np.maximum(np.asarray(n_cand, np.int64), 1).sum())
    win_bytes = (W // 16 + 2) * 4
    return Work(2 * B * R + 2 * B * C * 4 + n_align * win_bytes + 12 * B * 4,
                n_align * R * (2 * E + 1) * 6)


def residual_dp(N: int, R: int, W: int, band: int, items: int) -> Work:
    """Each needed mate's read and packed W-base window read, every buffer
    row's positions, flags and results; each needed mate's R rows of
    2 band + 1 cells at ~14 operations a cell."""
    win_bytes = (W // 16 + 2) * 4
    return Work(items * (R + win_bytes) + N * (2 * 4 + 2 + 4 * 4),
                items * R * (2 * band + 1) * 14)
