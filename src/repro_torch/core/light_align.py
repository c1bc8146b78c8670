"""Light Alignment (§4.6): XOR-style shifted-mask alignment with exact score.

Given a candidate read-start position, the reference window
``refwin = ref[start - E : start + R + E]`` is compared against the read
under 2E+1 shift hypotheses (shift +k = k-base deletion from the read,
shift -k = k-base insertion), plus the mismatch-only hypothesis.

- ``minsplit`` (default): per shift k, the split point p minimizing
  ``mm(mask0[:p]) + mm(mask_k[p:])`` via two prefix sums — the optimal
  alignment with at most one interior gap run and any mismatches.
- ``paper``: a gap hypothesis is accepted only with zero mismatches.

This is the plain PyTorch version; the `candidate_align` CUDA kernel runs
the same arithmetic per candidate without storing the prefix-sum rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.scoring import Scoring

EDIT_NONE = 0       # mismatches only (possibly zero)
EDIT_INS = 1        # k-base insertion in the read
EDIT_DEL = 2        # k-base deletion from the read (ref consumes k extra)

CIG_M, CIG_I, CIG_D = 0, 1, 2

BIG = 1 << 20   # "infinite" mismatch count; a hypothesis reaching it scores -BIG


class LightAlignResult(NamedTuple):
    score: torch.Tensor       # (B,) int32 best score over hypotheses
    ok: torch.Tensor          # (B,) bool  score >= threshold
    edit_type: torch.Tensor   # (B,) int32 EDIT_*
    edit_len: torch.Tensor    # (B,) int32 gap run length (0 for EDIT_NONE)
    edit_pos: torch.Tensor    # (B,) int32 read split position p
    n_mismatch: torch.Tensor  # (B,) int32 mismatches of the chosen hypothesis


def light_align(
    read: torch.Tensor,
    refwin: torch.Tensor,
    max_gap: int,
    scoring: Scoring = Scoring(),
    threshold: int | None = None,
    mode: str = "minsplit",
) -> LightAlignResult:
    """Batched Light Alignment.  read (B, R) uint8, refwin (B, R+2E) uint8."""
    if mode not in ("minsplit", "paper"):
        raise ValueError(f"unknown mode {mode!r}")
    B, R = read.shape
    E = max_gap
    if refwin.shape[-1] != R + 2 * E:
        raise ValueError("refwin must be read_len + 2*max_gap wide")
    if threshold is None:
        threshold = scoring.default_threshold(R)
    dev = read.device

    # masks[:, E+s, i] = read[i] != refwin[E+s+i], shift s in [-E, E]
    windows = refwin.unfold(-1, R, 1)                  # (B, 2E+1, R) view
    masks = (windows != read[:, None, :]).to(torch.int32)
    cum = torch.zeros((B, 2 * E + 1, R + 1), dtype=torch.int32, device=dev)
    cum[..., 1:] = torch.cumsum(masks, dim=-1)
    cum0 = cum[:, E, :]
    m2 = scoring.match + scoring.mismatch
    p_range = torch.arange(R + 1, device=dev)

    mm_none = cum0[:, R]
    scores = [scoring.match * R - m2 * mm_none]
    types = [torch.full_like(mm_none, EDIT_NONE)]
    lens = [torch.zeros_like(mm_none)]
    poss = [torch.zeros_like(mm_none)]
    mms = [mm_none]

    def best_split(cand, interior):
        cand = torch.where(interior[None, :], cand, BIG)
        if mode == "paper":
            cand = torch.where(cand == 0, cand, BIG)
        p = torch.argmin(cand, dim=-1)
        mm = torch.gather(cand, 1, p[:, None])[:, 0]
        return p.to(torch.int32), mm

    for k in range(1, E + 1):
        # deletion of k: suffix read[p:] aligns at shift +k
        cum_d = cum[:, E + k, :]
        p_d, mm_d = best_split(cum0 + (cum_d[:, R:R + 1] - cum_d),
                               (p_range >= 1) & (p_range <= R - 1))
        sc = scoring.match * R - m2 * mm_d - scoring.gap_cost(k)
        scores.append(torch.where(mm_d >= BIG, -BIG, sc))
        types.append(torch.full_like(mm_d, EDIT_DEL))
        lens.append(torch.full_like(mm_d, k))
        poss.append(p_d)
        mms.append(mm_d)

        # insertion of k: suffix read[p+k:] aligns at shift -k;
        # mm(p) = cum0[p] + (tot_i - cum_i[p + k])
        cum_i = cum[:, E - k, :]
        shifted = torch.zeros_like(cum_i)
        shifted[:, :R + 1 - k] = cum_i[:, k:]
        p_i, mm_i = best_split(cum0 + (cum_i[:, R:R + 1] - shifted),
                               (p_range >= 1) & (p_range <= R - k - 1))
        sc = scoring.match * (R - k) - m2 * mm_i - scoring.gap_cost(k)
        scores.append(torch.where(mm_i >= BIG, -BIG, sc))
        types.append(torch.full_like(mm_i, EDIT_INS))
        lens.append(torch.full_like(mm_i, k))
        poss.append(p_i)
        mms.append(mm_i)

    score_stack = torch.stack(scores, -1)
    best = torch.argmax(score_stack, dim=-1, keepdim=True)  # first max

    def pick(xs):
        return torch.gather(torch.stack(xs, -1), 1, best)[:, 0].to(
            torch.int32)

    score = pick(scores)
    return LightAlignResult(
        score=score, ok=score >= threshold, edit_type=pick(types),
        edit_len=pick(lens), edit_pos=pick(poss), n_mismatch=pick(mms))


def cigar_ops(edit_type: torch.Tensor, edit_len: torch.Tensor,
              edit_pos: torch.Tensor, read_len: int) -> torch.Tensor:
    """(B, 3, 2) int32 [(op, len)] runs; zero-length runs are padding.

    EDIT_NONE -> [(M, R)]; EDIT_DEL k at p -> [(M, p), (D, k), (M, R-p)];
    EDIT_INS k at p -> [(M, p), (I, k), (M, R-p-k)].
    """
    R = read_len
    is_none = edit_type == EDIT_NONE
    is_ins = edit_type == EDIT_INS
    p, k = edit_pos, edit_len
    len0 = torch.where(is_none, R, p)
    op1 = torch.where(is_ins, CIG_I, CIG_D)
    len1 = torch.where(is_none, 0, k)
    len2 = torch.where(is_none, 0, torch.where(is_ins, R - p - k, R - p))
    m = torch.full_like(p, CIG_M)
    return torch.stack([torch.stack([m, len0], -1),
                        torch.stack([op1, len1], -1),
                        torch.stack([m, len2], -1)], 1).to(torch.int32)


def gather_ref_windows(ref: torch.Tensor, starts: torch.Tensor,
                       read_len: int, max_gap: int) -> torch.Tensor:
    """ref (L,) uint8, starts (...,) int32 -> (..., R+2E) windows, with
    every out-of-range base index clamped into [0, L-1]."""
    E = max_gap
    idx = starts.to(torch.int64)[..., None] + torch.arange(
        -E, read_len + E, device=ref.device)
    return ref[idx.clamp(0, ref.shape[0] - 1)]
