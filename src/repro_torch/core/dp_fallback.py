"""DP fallback (GenDP analogue): semiglobal affine-gap Gotoh alignment.

Residual read-pairs that Light Alignment cannot accept are aligned with a
semiglobal Gotoh DP: the read is global, the reference window has free
leading/trailing gaps.  Each row is vectorized over the batch; the
horizontal gap is a running max (`torch.cummax`).  These are the plain
PyTorch versions the `residual_dp` CUDA kernel is held against.
`gotoh_align_np` is the host-side traceback oracle (numpy).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.scoring import Scoring

NEG = -(1 << 20)


class DPResult(NamedTuple):
    score: torch.Tensor    # (B,) int32
    ref_end: torch.Tensor  # (B,) int32 end column (bases of window consumed)


def gotoh_semiglobal(read: torch.Tensor, refwin: torch.Tensor,
                     scoring: Scoring = Scoring()) -> DPResult:
    """Batched semiglobal Gotoh. read (B, R) uint8, refwin (B, W) uint8."""
    B, R = read.shape
    W = refwin.shape[-1]
    dev = read.device
    op, ext = scoring.gap_open, scoring.gap_extend
    first = op + ext
    j_idx = torch.arange(W + 1, dtype=torch.int32, device=dev)
    h = torch.zeros((B, W + 1), dtype=torch.int32, device=dev)
    e = torch.full((B, W + 1), NEG, dtype=torch.int32, device=dev)
    neg = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    for i in range(1, R + 1):
        e = torch.maximum(h - first, e - ext)
        sub = torch.where(read[:, i - 1:i] == refwin, scoring.match,
                          -scoring.mismatch).to(torch.int32)
        h_tmp = torch.empty_like(h)
        h_tmp[:, 1:] = torch.maximum(h[:, :-1] + sub, e[:, 1:])
        h_tmp[:, 0] = -(op + ext * i)
        g = torch.cummax(h_tmp + ext * j_idx, dim=1).values
        f = torch.cat([neg, g[:, :-1]], 1) - op - ext * j_idx
        h = torch.maximum(h_tmp, f)
    return DPResult(score=torch.max(h, dim=-1).values,
                    ref_end=_first_argmax(h))


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(x, dim=-1).to(torch.int32)


def band_center(read_len: int, win_len: int) -> int:
    """Center diagonal offset of a banded semiglobal DP: a read placed
    symmetrically in its window starts at column ``(W - R) // 2`` (for the
    pipeline's ``W = R + 2*dp_pad`` windows, exactly ``dp_pad``)."""
    return (win_len - read_len) // 2


def slice_start(start: int, W: int, band: int) -> int:
    """Where repro's `jax.lax.dynamic_slice_in_dim` takes a row's
    ``2*band + 1`` bases of the ``W + 2*band + 2``-wide padded window: a
    negative start counts from the end, then the start is clamped into
    ``[0, W + 1]``.  Every start of a window at least as long as the read
    is already in that range."""
    if start < 0:
        start += W + 2 * band + 2
    return min(max(start, 0), W + 1)


def gotoh_semiglobal_banded(read: torch.Tensor, refwin: torch.Tensor,
                            band: int | None,
                            scoring: Scoring = Scoring()) -> DPResult:
    """Banded batched semiglobal Gotoh over the ``K = 2*band + 1`` moving
    frame: slot k of row i is column ``j = i + c - band + k``; cells outside
    ``[0, W]`` are ``NEG``.  ``band is None`` or ``band >= W`` is the exact
    full DP (`gotoh_semiglobal`).

    Row i compares its read base with the K bases of the padded window
    from `slice_start` ``(i + c + 1)`` on.  Only a window shorter than the
    read (``c <= -2``, or ``R + c > W + 1``) moves a start there; the
    in-band cells of such a row then score against other bases than their
    own (shifted ones, or the padding), as repro's do."""
    B, R = read.shape
    W = refwin.shape[-1]
    if band is None or band >= W:
        return gotoh_semiglobal(read, refwin, scoring)
    dev = read.device
    c = band_center(R, W)
    K = 2 * band + 1
    op, ext = scoring.gap_open, scoring.gap_extend
    first = op + ext
    k_idx = torch.arange(K, dtype=torch.int32, device=dev)
    neg = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    pad = torch.full((B, band + 1), -1, dtype=torch.int32, device=dev)
    win_pad = torch.cat([pad, refwin.to(torch.int32), pad], 1)
    read32 = read.to(torch.int32)

    j0 = c - band + k_idx
    h = torch.where((j0 >= 0) & (j0 <= W), 0, NEG).to(torch.int32).expand(
        B, K).contiguous()
    e = torch.full((B, K), NEG, dtype=torch.int32, device=dev)
    for i in range(R):
        jcol = (i + 1 + c - band) + k_idx
        valid = ((jcol >= 0) & (jcol <= W))[None, :]
        h_up = torch.cat([h[:, 1:], neg], 1)
        e_up = torch.cat([e[:, 1:], neg], 1)
        e = torch.maximum(h_up - first, e_up - ext)
        start = slice_start(i + c + 1, W, band)
        wrow = win_pad[:, start:start + K]
        sub = torch.where(read32[:, i:i + 1] == wrow, scoring.match,
                          -scoring.mismatch).to(torch.int32)
        h_tmp = torch.maximum(h + sub, e)
        h_tmp = torch.where(jcol[None, :] == 0, -(op + ext * (i + 1)), h_tmp)
        h_tmp = torch.where(valid, h_tmp, NEG)
        g = torch.cummax(h_tmp + ext * k_idx, dim=1).values
        f = torch.cat([neg, g[:, :-1]], 1) - op - ext * k_idx
        h = torch.where(valid, torch.maximum(h_tmp, f), NEG).to(torch.int32)
    score = torch.max(h, dim=-1).values
    return DPResult(score=score,
                    ref_end=R + c - band + _first_argmax(h))


def gotoh_align_np(read: np.ndarray, refwin: np.ndarray,
                   scoring: Scoring = Scoring()
                   ) -> tuple[int, list[tuple[str, int]], int]:
    """Host-side semiglobal Gotoh with traceback (read global, reference
    window with free end gaps), the oracle of Light Alignment's exactness
    on single-gap-run inputs.

    Returns ``(score, cigar_runs, ref_begin)``: runs ``[(op, len)]`` with
    ops in 'MID'.  The end column is the first of the last row's maxima;
    the traceback prefers a match/mismatch step, then the vertical gap
    (E, 'I'), then the horizontal one (F, 'D'), and stays in a gap while
    extending it scores the cell, as the JAX package's oracle does.
    """
    read = np.asarray(read)
    refwin = np.asarray(refwin)
    R, W = len(read), len(refwin)
    first = scoring.gap_open + scoring.gap_extend
    ext = scoring.gap_extend
    H = np.zeros((R + 1, W + 1), np.int64)
    E = np.full((R + 1, W + 1), NEG, np.int64)  # read base unaligned, 'I'
    F = np.full((R + 1, W + 1), NEG, np.int64)  # gap in the read, 'D'
    for i in range(1, R + 1):
        H[i, 0] = -(scoring.gap_open + ext * i)

    def sub(i, j):
        return (scoring.match if read[i - 1] == refwin[j - 1]
                else -scoring.mismatch)

    for i in range(1, R + 1):
        for j in range(0, W + 1):
            E[i, j] = max(H[i - 1, j] - first, E[i - 1, j] - ext)
            if j > 0:
                F[i, j] = max(H[i, j - 1] - first, F[i, j - 1] - ext)
                H[i, j] = max(H[i - 1, j - 1] + sub(i, j), E[i, j], F[i, j])
            else:
                H[i, j] = E[i, j]
    j = int(np.argmax(H[R]))
    score = int(H[R, j])
    ops: list[str] = []
    i = R
    state = "H"
    while i > 0:
        if state == "H":
            if j > 0 and H[i, j] == H[i - 1, j - 1] + sub(i, j):
                ops.append("M")
                i -= 1
                j -= 1
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append("I")
            nxt = "E" if E[i, j] == E[i - 1, j] - ext else "H"
            i -= 1
            state = nxt
        else:
            ops.append("D")
            nxt = "F" if F[i, j] == F[i, j - 1] - ext else "H"
            j -= 1
            state = nxt
    ref_begin = j
    ops.reverse()
    runs: list[tuple[str, int]] = []
    for op in ops:
        if runs and runs[-1][0] == op:
            runs[-1] = (op, runs[-1][1] + 1)
        else:
            runs.append((op, 1))
    return score, runs, ref_begin
