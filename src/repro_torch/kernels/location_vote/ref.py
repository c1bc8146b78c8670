"""Plain PyTorch version of the Location Voting reduction (§4.7, [85]).

Every surviving pseudo-pair candidate of a long read proposes a read-start
diagonal; the diagonals are binned by ``vote_bin`` and the most-voted bin
wins:

  * a slot's vote count is the multiplicity of its bin among the read's
    valid (non-INVALID_LOC) slots;
  * ``votes`` is the largest count (0 when every slot is invalid);
  * ``win_bin`` is the smallest bin among the maxima, and 0 when
    ``votes == 0``.

Bins are floored (toward -inf): near-origin candidates give negative
diagonals, and truncating division would fold bins -1 and 0 together.
Counts come from a sort and two searchsorteds, O(M log M) per read.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.seedmap import INVALID_LOC


class VoteResult(NamedTuple):
    win_bin: torch.Tensor  # (B,) int32 winning diagonal bin (0: no vote)
    votes: torch.Tensor    # (B,) int32 winning vote count (0: no candidate)


def location_vote_ref(diag: torch.Tensor, vote_bin: int) -> VoteResult:
    """(B, M) int32 candidate diagonals (INVALID_LOC padded) -> VoteResult."""
    d = diag.to(torch.int32)
    valid = d != INVALID_LOC
    # invalid slots keep the sentinel as their bin: it sorts last and no
    # real bin equals it
    vbin = torch.where(valid, torch.div(d, vote_bin, rounding_mode="floor"),
                       INVALID_LOC).to(torch.int32)
    sb = torch.sort(vbin, dim=-1).values
    lo = torch.searchsorted(sb, sb, side="left")
    hi = torch.searchsorted(sb, sb, side="right")
    live = sb != INVALID_LOC
    cnt = torch.where(live, hi - lo, 0).to(torch.int32)
    votes = cnt.max(dim=-1).values
    at_max = (cnt == votes[:, None]) & live
    win = torch.where(at_max, sb, INVALID_LOC).min(dim=-1).values
    return VoteResult(win_bin=torch.where(votes > 0, win, 0).to(torch.int32),
                      votes=votes)
