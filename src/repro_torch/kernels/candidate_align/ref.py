"""Plain PyTorch version of the fused candidate light-alignment op (step 4).

Materializes every (B, C, R+2E) candidate window, light-aligns all B*C
(read, window) rows per mate, masks invalid candidates and argmaxes the
summed pair score.  With ``0 < prescreen_top < C`` only the top-P
candidate pairs ranked by summed zero-shift Hamming distance are aligned
(a stable ascending rank: equal distances keep slot order).

Two window-gather flavors:

- ``packed_ref=False``: ``ref`` is the (L,) uint8 base array; invalid
  starts read the window at 0 and every base index is clamped.
- ``packed_ref=True``: ``ref`` is the (Lw,) int32-held 2-bit packing;
  window starts ``pos - E`` are clamped as a scalar.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.encoding import gather_windows_packed
from repro_torch.core.light_align import (
    cigar_ops,
    gather_ref_windows,
    light_align,
)
from repro_torch.core.scoring import Scoring
from repro_torch.core.seedmap import INVALID_LOC

NEG_BIG = -(1 << 20)   # masked-candidate score sentinel
MM_BIG = 1 << 20       # masked-candidate Hamming sentinel (prescreen)


class PairAlignResult(NamedTuple):
    """Best-candidate Light Alignment for a batch of read pairs."""

    best: torch.Tensor    # (B,) int32 winner index in post-prescreen order
    slot: torch.Tensor    # (B,) int32 winner's original candidate slot
    pos1: torch.Tensor    # (B,) int32 winning candidate start (mate 1)
    pos2: torch.Tensor    # (B,) int32 winning candidate start (mate 2)
    score1: torch.Tensor  # (B,) int32 masked score (NEG_BIG if invalid slot)
    score2: torch.Tensor  # (B,) int32
    ok1: torch.Tensor     # (B,) bool  score >= threshold and slot valid
    ok2: torch.Tensor     # (B,) bool
    cigar1: torch.Tensor  # (B, 3, 2) int32 light-align CIGAR runs
    cigar2: torch.Tensor  # (B, 3, 2) int32


def gather_windows(ref, pos, valid, read_len: int, lead: int,
                   packed_ref: bool) -> torch.Tensor:
    """(..., R + 2*lead) windows of the oracle's two gather flavors."""
    if packed_ref:
        return gather_windows_packed(ref, torch.where(valid, pos - lead, 0),
                                     read_len + 2 * lead)
    return gather_ref_windows(ref, torch.where(valid, pos, 0), read_len, lead)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, P, ...) at per-row index idx (B,) -> (B, ...)."""
    view = idx.to(torch.int64).reshape((-1, 1) + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, view, dim=1)[:, 0]


def candidate_pair_align_ref(
    ref: torch.Tensor,
    reads1: torch.Tensor,    # (B, R) mate 1, reference orientation
    reads2: torch.Tensor,    # (B, R) mate 2, reference orientation
    pos1: torch.Tensor,      # (B, C) candidate starts, INVALID_LOC padded
    pos2: torch.Tensor,      # (B, C)
    max_gap: int,
    scoring: Scoring = Scoring(),
    threshold: int | None = None,
    mode: str = "minsplit",
    prescreen_top: int = 0,
    packed_ref: bool = False,
) -> PairAlignResult:
    B, R = reads1.shape
    C = pos1.shape[1]
    E = max_gap
    if threshold is None:
        threshold = scoring.default_threshold(R)
    valid1 = pos1 != INVALID_LOC
    valid2 = pos2 != INVALID_LOC
    wins1 = gather_windows(ref, pos1, valid1, R, E, packed_ref)
    wins2 = gather_windows(ref, pos2, valid2, R, E, packed_ref)

    pos1s, pos2s = pos1, pos2
    if 0 < prescreen_top < C:
        mm0 = ((wins1[..., E:E + R] != reads1[:, None, :]).sum(-1)
               + (wins2[..., E:E + R] != reads2[:, None, :]).sum(-1))
        mm0 = torch.where(valid1 & valid2, mm0, MM_BIG)
        top = torch.argsort(mm0, dim=1, stable=True)[:, :prescreen_top]
        wins1 = torch.take_along_dim(wins1, top[..., None], dim=1)
        wins2 = torch.take_along_dim(wins2, top[..., None], dim=1)
        pos1s = torch.gather(pos1, 1, top)
        pos2s = torch.gather(pos2, 1, top)
        valid1 = torch.gather(valid1, 1, top)
        valid2 = torch.gather(valid2, 1, top)
        slots = top.to(torch.int32)
    else:
        slots = torch.arange(C, dtype=torch.int32,
                             device=pos1.device).expand(B, C)
    P = pos1s.shape[1]

    def run_light(reads, wins, valid):
        res = light_align(reads[:, None].expand(B, P, R).reshape(B * P, R),
                          wins.reshape(B * P, -1), E, scoring, threshold,
                          mode)
        sc = torch.where(valid.reshape(-1), res.score, NEG_BIG).reshape(B, P)
        return res, sc

    res1, sc1 = run_light(reads1, wins1, valid1)
    res2, sc2 = run_light(reads2, wins2, valid2)
    best = torch.argmax(sc1 + sc2, dim=-1).to(torch.int32)   # first max

    def take_res(res, field):
        return _take(getattr(res, field).reshape(B, P), best)

    b_pos1 = _take(pos1s, best)
    b_pos2 = _take(pos2s, best)
    return PairAlignResult(
        best=best, slot=_take(slots, best), pos1=b_pos1, pos2=b_pos2,
        score1=_take(sc1, best), score2=_take(sc2, best),
        ok1=take_res(res1, "ok") & (b_pos1 != INVALID_LOC),
        ok2=take_res(res2, "ok") & (b_pos2 != INVALID_LOC),
        cigar1=cigar_ops(take_res(res1, "edit_type"),
                         take_res(res1, "edit_len"),
                         take_res(res1, "edit_pos"), R),
        cigar2=cigar_ops(take_res(res2, "edit_type"),
                         take_res(res2, "edit_len"),
                         take_res(res2, "edit_pos"), R),
    )
