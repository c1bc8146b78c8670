"""Paired-Adjacency Filtering (§4.5).

Every read-1 start is binary-searched (`searchsorted`) against the sorted
read-2 list.  Occurrence k of a read-1 start duplicated by several seeds
probes the (k+1)-th in-range read-2 start, so distinct mate-2 placements
near the same mate-1 start each emit a candidate; exact duplicate
(start1, start2) pairs collapse to one.  Survivors are compacted to the
front of a fixed-capacity candidate set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.query import QueryResult
from repro_torch.core.seedmap import INVALID_LOC


class CandidateSet(NamedTuple):
    """Candidate mapping positions for a batch of read-pairs.

    pos1, pos2: (B, C) int32 read-start positions (INVALID_LOC padded)
    n:          (B,)   int32 valid candidate count (<= C)
    """

    pos1: torch.Tensor
    pos2: torch.Tensor
    n: torch.Tensor


def filter_rows(starts1: torch.Tensor, starts2: torch.Tensor, delta: int,
                cap: int) -> CandidateSet:
    """Batched Δ filter over sorted (B, M) int32 start lists."""
    B, M = starts1.shape
    valid1 = starts1 != INVALID_LOC
    # int32 arithmetic wraps exactly as the reference's does
    lo = torch.searchsorted(starts2, starts1 - delta, side="left")
    ar = torch.arange(M, device=starts1.device)
    occ = ar - torch.searchsorted(starts1, starts1, side="left")
    s2 = torch.gather(starts2, 1, (lo + occ).clamp(0, M - 1))
    within = (s2 != INVALID_LOC) & (torch.abs(s2 - starts1) <= delta) & valid1
    # Duplicates of a read-1 start are contiguous and probe non-decreasing
    # partners, so equal (start1, start2) pairs are adjacent.
    first = torch.ones_like(within)
    first[:, 1:] = (starts1[:, 1:] != starts1[:, :-1]) | (s2[:, 1:]
                                                         != s2[:, :-1])
    keep = within & first
    # Compact kept candidates to the front, preserving position order.
    take = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :cap]
    ok = torch.gather(keep, 1, take)
    pos1 = torch.where(ok, torch.gather(starts1, 1, take), INVALID_LOC)
    pos2 = torch.where(ok, torch.gather(s2, 1, take), INVALID_LOC)
    if cap > M:
        pad = torch.full((B, cap - M), INVALID_LOC, dtype=torch.int32,
                         device=starts1.device)
        pos1 = torch.cat([pos1, pad], 1)
        pos2 = torch.cat([pos2, pad], 1)
    n = keep.sum(1).clamp(max=cap).to(torch.int32)
    return CandidateSet(pos1=pos1, pos2=pos2, n=n)


def paired_adjacency_filter(q1: QueryResult, q2: QueryResult, delta: int,
                            max_candidates: int) -> CandidateSet:
    """Keep read-1/read-2 start pairs within Δ of each other."""
    return filter_rows(q1.starts, q2.starts, delta, max_candidates)
