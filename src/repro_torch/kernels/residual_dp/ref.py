"""Plain PyTorch version of the fused residual-DP op (step 5).

Materializes the (N, R + 2*dp_pad) reference windows of both mates (the
two gather flavors of `candidate_align.ref.gather_windows`), runs the
banded Gotoh DP over every lane and masks the mates whose Light Alignment
succeeded to the ``NEG`` / 0 sentinels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dp_fallback import NEG, gotoh_semiglobal_banded
from repro_torch.core.scoring import Scoring
from repro_torch.core.seedmap import INVALID_LOC
from repro_torch.kernels.candidate_align.ref import gather_windows


class ResidualDPResult(NamedTuple):
    """Per-row DP fallback scores; defined where the matching ``need`` mask
    is True, ``NEG`` / 0 elsewhere.  ``dp_lanes`` counts the DP alignments
    run (the failed-mate count)."""

    score1: torch.Tensor    # (N,) int32
    ref_end1: torch.Tensor  # (N,) int32
    score2: torch.Tensor
    ref_end2: torch.Tensor
    dp_lanes: torch.Tensor  # () int


def residual_pair_dp_ref(
    ref: torch.Tensor,
    reads1: torch.Tensor,   # (N, R) mate 1, reference orientation
    reads2: torch.Tensor,   # (N, R) mate 2, reference orientation
    pos1: torch.Tensor,     # (N,) best-candidate starts, INVALID_LOC padded
    pos2: torch.Tensor,
    need1: torch.Tensor,    # (N,) bool: mate 1 needs DP re-alignment
    need2: torch.Tensor,
    dp_pad: int,
    band: int | None = None,
    scoring: Scoring = Scoring(),
    packed_ref: bool = False,
) -> ResidualDPResult:
    R = reads1.shape[1]
    outs = []
    for reads, pos, need in ((reads1, pos1, need1), (reads2, pos2, need2)):
        win = gather_windows(ref, pos, pos != INVALID_LOC, R, dp_pad,
                             packed_ref)
        dp = gotoh_semiglobal_banded(reads, win, band, scoring)
        outs += [torch.where(need, dp.score, NEG).to(torch.int32),
                 torch.where(need, dp.ref_end, 0).to(torch.int32)]
    return ResidualDPResult(*outs, dp_lanes=need1.sum() + need2.sum())
