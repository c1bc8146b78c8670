"""Full-DP baseline mapper (the role Minimap2 plays in the paper's §6).

Same seeding + SeedMap query as GenPair, but *single-end*: each read is
mapped on its own (no Paired-Adjacency), every candidate is aligned with
the full semiglobal Gotoh DP (no Light Alignment), and chaining is
emulated by scoring all candidates.  This is the comparison point for:
  - Fig. 1-style stage breakdown (DP dominates),
  - §3.2's single-end vs paired-end exact-match-rate observation,
  - accuracy benchmarks (GenPair vs full-DP positions).

It runs plain PyTorch ops only: the DP is `gotoh_semiglobal`, as in the
JAX package, where this path reaches no kernel either.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dp_fallback import NEG, gotoh_semiglobal
from repro_torch.core.light_align import gather_ref_windows
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.query import query_read_batch
from repro_torch.core.seeding import seed_read_batch
from repro_torch.core.seedmap import INVALID_LOC, SeedMap


class BaselineResult(NamedTuple):
    pos: torch.Tensor     # (B,) int32 best candidate start
    score: torch.Tensor   # (B,) int32 best DP score
    mapped: torch.Tensor  # (B,) bool


def map_single_end(
    sm: SeedMap,
    ref: torch.Tensor,
    reads: torch.Tensor,
    cfg: PipelineConfig = PipelineConfig(),
    max_cands: int = 16,
) -> BaselineResult:
    """Map (B, R) uint8 reads (reference orientation) against the (L,)
    uint8 ``ref`` by DP-scoring every deduplicated seed candidate (the
    first ``max_cands`` in start order).  Reads are independent, so a
    caller may map a large batch in chunks.
    """
    B, R = reads.shape
    seeds = seed_read_batch(reads, cfg.seed_len, cfg.seeds_per_read,
                            sm.config.hash_seed)
    q = query_read_batch(sm, seeds, cfg.max_locs_per_seed)
    # Dedup + truncate candidate starts (valid, distinct starts first, in
    # start order: a stable sort of the "drop" flag).
    starts = q.starts
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                  device=starts.device),
                       starts[:, 1:] != starts[:, :-1]], dim=-1)
    keep = first & (starts != INVALID_LOC)
    order = torch.argsort((~keep).to(torch.uint8), dim=-1,
                          stable=True)[:, :max_cands]
    cand = torch.gather(starts, 1, order)
    cand_ok = torch.gather(keep, 1, order)
    safe = torch.where(cand_ok, cand, 0)
    wins = gather_ref_windows(ref, safe, R, cfg.dp_pad)   # (B, C, W)
    C = max_cands
    reads_t = reads[:, None, :].expand(B, C, R).reshape(B * C, R)
    dp = gotoh_semiglobal(reads_t, wins.reshape(B * C, -1), cfg.scoring)
    scores = torch.where(cand_ok.reshape(-1), dp.score, NEG).reshape(B, C)
    best = torch.argmax(scores, dim=-1, keepdim=True)     # first max
    pos = torch.gather(cand, 1, best)[:, 0]
    sc = torch.gather(scores, 1, best)[:, 0]
    mapped = torch.gather(cand_ok, 1, best)[:, 0]
    return BaselineResult(
        pos=torch.where(mapped, pos, INVALID_LOC).to(torch.int32),
        score=torch.where(mapped, sc, NEG).to(torch.int32),
        mapped=mapped,
    )


def exact_match_rate(reads: torch.Tensor, ref: torch.Tensor,
                     true_starts: torch.Tensor) -> torch.Tensor:
    """Fraction of reads identical to the reference at their true position
    (§3.2's whole-read exact-match filter effectiveness)."""
    R = reads.shape[-1]
    wins = gather_ref_windows(ref, true_starts, R, 0)
    return (reads == wins).all(dim=-1).float().mean()
