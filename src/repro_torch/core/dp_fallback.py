"""DP fallback (GenDP analogue): semiglobal affine-gap Gotoh alignment.

Residual read-pairs that Light Alignment cannot accept are aligned with a
semiglobal Gotoh DP: the read is global, the reference window has free
leading/trailing gaps.  Each row is vectorized over the batch; the
horizontal gap is a running max (`torch.cummax`).  These are the plain
PyTorch versions the `residual_dp` CUDA kernel is held against.
"""
from __future__ import annotations

from typing import NamedTuple

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
