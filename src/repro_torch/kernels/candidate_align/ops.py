"""Public wrapper of the fused candidate light-alignment op (step 4).

On CUDA tensors `candidate_pair_align` launches the `candidate_align`
kernel, which computes each window's coordinates itself (the rule of
`kernels/_util.window_starts`: edge-padded uint8 bases, or back-padded
packed words with a word/offset split), never materializes the (B, C,
R+2E) window tensor, aligns only the valid candidates' mates (and a
winner's invalid mates) and writes the winner's fields and CIGAR runs.  On
CPU tensors (or with ``backend="torch"``) it runs the plain version.
``block`` is the kernel's pairs a block (`launch_shape`): None for the
default, a value the kernel cannot take raises on either backend; the
result does not depend on it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.encoding import packed_gather_coords
from repro_torch.core.scoring import Scoring
from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import INT, PTR
from repro_torch.kernels._util import (
    KernelRef,
    kernel_reference,
    staged_stride,
)
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.candidate_align.ref import (
    PairAlignResult,
    candidate_pair_align_ref,
)

# The work that depends on the data, where a caller has none (a dry run),
# on chip_smoke.py's pair-lane batch (65,536 pairs at sub_rate 0.01): the
# alignments of a mate a pair, each pair's candidates clamped to at least
# one (a pair without any aligns one window; 132,990 for both mates), and
# the valid candidates of a pair, unclamped (57,973).
CANDIDATES_PER_PAIR = 132_990 / (2 * 65_536)
VALID_CANDIDATES_PER_PAIR = 57_973 / 65_536


def candidate_align_cost(B: int, R: int, C: int, E: int, packed: bool,
                         prescreen: int, n_cand=None) -> _cuda.Work:
    """Both mates and the (B, C) candidates read, one R+2E window a valid
    candidate of each mate (a pair without any: one at 0) and the results
    written; each alignment's 2E+1 shifts of R compares at ~6 operations,
    and with a prescreen the zero-shift Hamming distance of every valid
    candidate first.  ``n_cand``: each pair's valid candidates (a
    tensor), or None for `CANDIDATES_PER_PAIR` and
    `VALID_CANDIDATES_PER_PAIR`."""
    W = R + 2 * E
    if n_cand is None:
        per = max(CANDIDATES_PER_PAIR, 1.0)
        aligned = min(per, prescreen) if prescreen else per
        n_align, n_valid = 2 * B * aligned, B * VALID_CANDIDATES_PER_PAIR
    else:
        n = n_cand.long()
        a = n.clamp(min=1)
        if prescreen:
            a = a.clamp(max=prescreen)
        n_align, n_valid = 2 * int(a.sum()), int(n.sum())
    win_bytes = (W // 16 + 2) * 4 if packed else W
    return _cuda.Work(
        2 * B * R + 2 * B * C * 4 + n_align * win_bytes + 12 * B * 4,
        n_align * R * (2 * E + 1) * 6
        + (2 * n_valid * R * 2 if prescreen else 0))


CANDIDATE_ALIGN = _cuda.register(
    "candidate_align", "candidate_align_launch",
    (PTR, INT, PTR, PTR, PTR, PTR) + (INT,) * 19 + (PTR,) * 5,
    candidate_align_cost)

# the reduction key (score1 + score2) * C - j stays inside int32
MAX_CANDIDATES = 512
MAX_READ = 1 << 14        # the kernel packs an edit's length and position
MAX_LANE_READ = 1024      # positions a warp of lanes holds (light_align.cuh)
# Threads per block (the kernel's MAX_THREADS).  With 8 lanes an item, as
# at R 150 and 250, a block runs 16 items at once; at most 64 registers a
# thread (the kernel's MIN_BLOCKS), so an SM holds 8 blocks, 32 warps.
THREADS = 128
# The pair lane has ~2.03 live alignments per pair: 48 pairs give ~97
# items a block, six rounds of its 16 lane groups at R 150 or 250.
PAIRS_PER_BLOCK = 48
MAX_SHARED = 100 * 1024   # bytes per block: two blocks fit an SM
TABLE_BYTES = 256 * 8     # the lanes' nibble table


def read_lanes(R: int, E: int) -> int:
    """Lanes an alignment takes: the power of two covering R in 32-position
    lanes where `light_align_lanes` holds the read (E + 2 <= R <=
    `MAX_LANE_READ`), else 0 (one thread an item)."""
    if not E + 2 <= R <= MAX_LANE_READ:
        return 0
    lanes = 1
    while 32 * lanes < R:
        lanes *= 2
    return lanes


class LaunchShape(NamedTuple):
    threads: int          # a block's
    pairs: int            # pairs a block
    lanes: int            # lanes an item, 0 for one thread
    sr: int               # staged read row stride, bytes
    sw: int               # staged window row stride, bytes
    max_pairs: int        # the most pairs a block fits
    shared: int           # bytes of shared memory a block takes


def launch_shape(R: int, W: int, C: int, block: int | None = None
                 ) -> LaunchShape:
    """A launch's threads, pairs a block, lanes an item and staged row
    strides (`LaunchShape`).  With lanes (`read_lanes`), a group of L lanes
    aligns an item, `THREADS` / L items in flight a block, each row
    holding the item's bytes plus the slack `light_align_lanes` reads past
    them (4 NW L + E + 8 and 4 NW L + 2E + 8 bytes); else each of up to
    `THREADS` threads (whole warps, or fewer than one where a warp's rows
    do not fit) aligns one on rows of R and W bytes.  The rows, the table
    and each pair's 8 C + 1 ints fit `MAX_SHARED`.  ``block`` pairs a
    block, or None for `PAIRS_PER_BLOCK` (fewer where they do not fit); an
    explicit value that does not fit raises, nothing is clamped."""
    E = (W - R) // 2
    lanes = read_lanes(R, E)
    pair_bytes = 4 * (8 * C + 1)
    if lanes:
        span = 4 * -(-R // (4 * lanes)) * lanes        # 4 NW L
        sr, sw = staged_stride(span + E + 8), staged_stride(span + 2 * E + 8)
        fixed = 4 + TABLE_BYTES
        warps = (MAX_SHARED - fixed - pair_bytes) // (32 // lanes * (sr + sw))
        threads = min(THREADS, 32 * warps)
        rows = threads // lanes
    else:
        sr, sw = staged_stride(R), staged_stride(W)
        fixed = 4
        n = min(THREADS, (MAX_SHARED - fixed - pair_bytes) // (sr + sw))
        threads = rows = n // 32 * 32 or n          # whole warps, or fewer
    fit = 0 if threads <= 0 else (
        MAX_SHARED - fixed - rows * (sr + sw)) // pair_bytes
    if fit <= 0:
        raise ValueError(f"candidate_align: an item's rows of {R} + {W} "
                         f"bases and a pair of {C} candidates exceed "
                         f"{MAX_SHARED}-byte shared memory")
    if block is None:
        block = min(PAIRS_PER_BLOCK, fit)
    elif not 1 <= block <= fit:
        raise ValueError(f"candidate_align takes 1..{fit} pairs a block at "
                         f"R {R}, W {W}, C {C}, got {block}")
    return LaunchShape(threads, block, lanes, sr, sw, fit,
                       fixed + rows * (sr + sw) + block * pair_bytes)


def candidate_pair_align(
    ref: torch.Tensor,       # (L,) uint8 bases, or (Lw,) int32 packed words
    reads1: torch.Tensor,    # (B, R) uint8 mate 1, reference orientation
    reads2: torch.Tensor,    # (B, R) uint8 mate 2, reference orientation
    pos1: torch.Tensor,      # (B, C) int32 candidate starts, INVALID_LOC padded
    pos2: torch.Tensor,      # (B, C)
    max_gap: int,
    scoring: Scoring = Scoring(),
    threshold: int | None = None,
    mode: str = "minsplit",
    prescreen_top: int = 0,
    packed_ref: bool = False,
    backend: str = "auto",
    kref: KernelRef | None = None,
    count: torch.Tensor | None = None,
    block: int | None = None,
) -> PairAlignResult:
    """Best-candidate Light Alignment for a batch of read pairs.

    ``kref``: ``ref`` already padded for windows of at least R+2E bases
    (`kernels/_util.kernel_reference`); built here when None.  ``count``:
    a (1,) int32 tensor on the card that the kernel adds the number of
    alignments it ran to (the plain version leaves it)."""
    backend = resolve_backend(backend, ref.device, family="candidate_align")
    if mode not in ("minsplit", "paper"):
        raise ValueError(f"unknown mode {mode!r}")
    if block is not None:
        launch_shape(reads1.shape[1], reads1.shape[1] + 2 * max_gap,
                     pos1.shape[1], block)
    if backend == "torch":
        return candidate_pair_align_ref(
            ref, reads1, reads2, pos1, pos2, max_gap, scoring, threshold,
            mode, prescreen_top, packed_ref)

    B, R = reads1.shape
    C = pos1.shape[1]
    E = max_gap
    W = R + 2 * E
    if threshold is None:
        threshold = scoring.default_threshold(R)
    if C > MAX_CANDIDATES or R < E + 2 or R >= MAX_READ:
        raise ValueError(f"candidate_align needs C <= {MAX_CANDIDATES} and "
                         f"E + 2 <= R < {MAX_READ} (C={C}, R={R}, E={E})")
    _cuda.check(ref, "ref", torch.int32 if packed_ref else torch.uint8)
    _cuda.check(reads1, "reads1", torch.uint8)
    _cuda.check(reads2, "reads2", torch.uint8, (B, R))
    _cuda.check(pos1, "pos1", torch.int32, (B, C))
    _cuda.check(pos2, "pos2", torch.int32, (B, C))
    if count is not None:
        _cuda.check(count, "count", torch.int32, (1,))
    shape = launch_shape(R, W, C, block)

    if kref is None:
        kref = kernel_reference(ref, W, packed_ref)
    _cuda.check(kref.data, "kref.data", ref.dtype)
    if kref.pad < W:
        raise ValueError(f"a reference padded for {kref.pad}-base windows "
                         f"cannot serve {W}-base windows")
    # the window coordinates of `window_starts`, computed in the kernel
    win_hi = packed_gather_coords(ref.shape[0], W)[1] if packed_ref else 0
    out = torch.empty((8, B), dtype=torch.int32, device=ref.device)
    cigar1, cigar2 = (torch.empty((B, 3, 2), dtype=torch.int32,
                                  device=ref.device) for _ in range(2))
    CANDIDATE_ALIGN(
        kref.data, int(packed_ref), reads1, reads2, pos1, pos2,
        B, R, C, E, prescreen_top, int(mode == "paper"), scoring.match,
        scoring.mismatch, scoring.gap_open, scoring.gap_extend, threshold,
        shape.threads, shape.lanes, shape.pairs, shape.sr, shape.sw,
        ref.shape[0], win_hi, kref.pad, out, cigar1, cigar2, count,
        stream=ref, work=(B, R, C, E, packed_ref, prescreen_top),
        path="lanes" if shape.lanes else "thread")
    slot, rank, sc1, sc2, ok1, ok2, bp1, bp2 = out.unbind(0)
    return PairAlignResult(
        best=rank, slot=slot, pos1=bp1, pos2=bp2, score1=sc1, score2=sc2,
        ok1=ok1.bool(), ok2=ok2.bool(), cigar1=cigar1, cigar2=cigar2)
