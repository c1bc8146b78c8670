"""The long-read lane (§4.7): long reads as interleaved pseudo-pairs.

A long read is cut into ``segment_len``-wide segments every
``segment_stride`` bases; consecutive segments form pseudo-pairs (their
in-read distance is the stride, below Δ by construction) that go through
the paired-end front end unchanged, with Δ widened by the stride.  Every
surviving candidate proposes a read-start diagonal (candidate position
minus the segment's in-read offset); Location Voting ([85]) bins the
diagonals by ``vote_bin`` and the most-voted bin wins.  The anchor
segment (segment 0) is then aligned with a banded DP against a reference
window centred on the voted diagonal, the band covering the residual
start uncertainty (half a vote bin plus ``max_gap`` of indel drift).

  stage       plain path (this module + core.*)   CUDA kernels
  ---------   --------------------------------    -----------------------
  front end   seed and query each segment once,   seed_buckets,
              pair adjacent QueryResults          pair_frontend
                                                  (`segment_pair_frontend`)
  voting      `location_vote_ref`                 location_vote
  anchor DP   `gotoh_semiglobal_banded`           banded_sw

The session entry points are ``Mapper.map_long`` / ``map_long_stream``;
`map_long_reads` is the one-shot entry.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.dp_fallback import NEG
from repro_torch.core.encoding import gather_windows_packed
from repro_torch.core.light_align import gather_ref_windows
from repro_torch.core.pair_filter import paired_adjacency_filter
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.query import (
    QueryResult,
    padded_rows_device,
    query_read_batch,
)
from repro_torch.core.seeding import seed_read_batch
from repro_torch.core.seedmap import INVALID_LOC, PaddedSeedMap, SeedMap
from repro_torch.kernels._util import clamp_window_starts
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.banded_sw.ops import banded_sw
from repro_torch.kernels.location_vote.ops import location_vote
from repro_torch.kernels.pair_frontend.ops import segment_pair_frontend


@dataclasses.dataclass(frozen=True)
class LongReadConfig:
    segment_len: int = 150
    segment_stride: int = 300   # distance between pseudo-pair mates (< Δ)
    pipe: PipelineConfig = PipelineConfig()
    vote_bin: int = 64          # diagonal-vote bin width
    dp_halo: int = 64           # DP window halo around the voted diagonal
    # Half-width of the anchor-segment DP band around the window's centre
    # diagonal.  None derives `vote_bin // 2 + pipe.max_gap`: the voted
    # position is known only to a bin, so the true start sits within half
    # a bin of the window centre, plus max_gap of indel drift.  Any value
    # >= segment_len + 2*dp_halo is the exact unbanded DP.
    dp_band: int | None = None
    # Warps (reads) a block of the location_vote kernel; None keeps its
    # hand-picked default (the tuner fills it, as the pipe config's
    # `*_block` knobs).  The result does not depend on it.
    vote_block: int | None = None

    def band(self) -> int:
        """Resolved anchor-DP band half-width (`dp_band` or derived)."""
        if self.dp_band is not None:
            return self.dp_band
        return self.vote_bin // 2 + self.pipe.max_gap

    def n_segments(self, read_len: int) -> int:
        return (read_len - self.segment_len) // self.segment_stride + 1

    def pair_delta(self) -> int:
        """Adjacency threshold for pseudo-pairs: Δ widened by the in-read
        mate distance (consecutive segments map ``segment_stride`` apart)."""
        return self.segment_stride + self.pipe.delta


class LongReadResult(NamedTuple):
    position: torch.Tensor      # (B,) int32 voted read start (INVALID_LOC)
    votes: torch.Tensor         # (B,) int32 winning vote count
    score: torch.Tensor         # (B,) int32 banded-DP score of segment 0
    mapped: torch.Tensor        # (B,) bool
    n_candidates: torch.Tensor  # (B,) int32 surviving pseudo-pair candidates
    n_valid: torch.Tensor       # (B,) bool row is a real read


def segment_views(reads: torch.Tensor, segment_len: int,
                  segment_stride: int) -> torch.Tensor:
    """(B, L) -> (B, S, segment_len) windows every ``segment_stride`` bases.

    ``S`` is maximal: segment ``S-1`` still fits in the read.  A trailing
    remainder shorter than ``segment_len`` is not segmented.
    """
    return reads.unfold(-1, segment_len, segment_stride)


def candidate_diagonals(pos1: torch.Tensor, n_pairs: int,
                        segment_stride: int) -> torch.Tensor:
    """(B*(S-1), C) INVALID_LOC-padded mate-1 candidates of the pseudo-pair
    front end (pair ``i`` = segments ``i`` and ``i+1``) -> (B, (S-1)*C)
    int32 read-start diagonals: position minus the segment's in-read
    offset ``i * segment_stride``, taken in int32 (negative near the
    reference origin, which is why the vote floors its bins)."""
    BP, C = pos1.shape
    B = BP // n_pairs
    seg_off = torch.arange(n_pairs, dtype=torch.int32,
                           device=pos1.device) * segment_stride
    p = pos1.reshape(B, n_pairs, C)
    diag = torch.where(p != INVALID_LOC, p - seg_off[None, :, None],
                       INVALID_LOC)
    return diag.reshape(B, n_pairs * C).to(torch.int32)


def _anchor_windows(ref: torch.Tensor, position: torch.Tensor,
                    mapped: torch.Tensor, cfg: LongReadConfig
                    ) -> torch.Tensor:
    """(B, segment_len + 2*dp_halo) reference windows centred half a vote
    bin past the voted position, so the true start (anywhere in the bin)
    sits within ``vote_bin/2`` of the window centre.  Unmapped rows and
    near-origin votes go through each reference flavor's clamp."""
    R = cfg.segment_len
    halo = cfg.dp_halo
    center = position + cfg.vote_bin // 2
    if ref.dtype == torch.int32:
        start = torch.where(mapped, center, 0) - halo
        return gather_windows_packed(ref, start, R + 2 * halo)
    s = clamp_window_starts(center, mapped, ref.shape[0], R + 2 * halo, halo)
    return gather_ref_windows(ref, s, R, halo)


def map_long_impl(
    sm: SeedMap | PaddedSeedMap,
    ref: torch.Tensor,
    reads: torch.Tensor,
    cfg: LongReadConfig = LongReadConfig(),
    backend: str = "auto",
) -> LongReadResult:
    """Map (B, L) uint8 long reads, already in reference orientation.

    ``ref`` is the (L,) uint8 base array or its (Lw,) int32 2-bit packing;
    ``sm`` the CSR `SeedMap` (queried by the staged plain path) or the
    `PaddedSeedMap` the kernel front end gathers rows from.  ``backend``
    ("auto" | "cuda" | "torch") picks the kernels or their plain versions
    for every stage.
    """
    p = cfg.pipe
    segs = segment_views(reads, cfg.segment_len, cfg.segment_stride)
    B, S, R = segs.shape
    if S < 2:
        raise ValueError(f"{reads.shape[-1]}-base reads give {S} segment(s) "
                         f"of {R} every {cfg.segment_stride}; the lane "
                         f"needs two to form a pseudo-pair")
    delta = cfg.pair_delta()
    backend = resolve_backend(backend, reads.device)

    # -- front end: segments through the pseudo-pair pipeline -------------
    if isinstance(sm, SeedMap) and backend == "torch":
        # staged: seed and query every segment once, then pair adjacent
        # segments' sorted start lists (the same result as the S-1
        # pseudo-pairs through `pair_frontend`, without re-seeding)
        flat = segs.reshape(B * S, R)
        seeds = seed_read_batch(flat, p.seed_len, p.seeds_per_read,
                                sm.config.hash_seed)
        q = query_read_batch(sm, seeds, p.max_locs_per_seed)
        starts = q.starts.reshape(B, S, -1)
        hits = q.n_hits.reshape(B, S)
        q1 = QueryResult(starts=starts[:, :-1].reshape(B * (S - 1), -1),
                         n_hits=hits[:, :-1].reshape(-1))
        q2 = QueryResult(starts=starts[:, 1:].reshape(B * (S - 1), -1),
                         n_hits=hits[:, 1:].reshape(-1))
        cands = paired_adjacency_filter(q1, q2, delta, p.max_candidates)
        pos1, n_cand = cands.pos1, cands.n
    else:
        rows = (sm.rows if isinstance(sm, PaddedSeedMap)
                else padded_rows_device(sm, p.max_locs_per_seed))
        fe = segment_pair_frontend(
            rows, reads, cfg.segment_len, cfg.segment_stride, p.seed_len,
            p.seeds_per_read, sm.config.hash_seed, delta, p.max_candidates,
            block=p.frontend_block, backend=backend)
        pos1, n_cand = fe.pos1, fe.n

    # -- Location Voting ---------------------------------------------------
    diag = candidate_diagonals(pos1, S - 1, cfg.segment_stride)
    vote = location_vote(diag, cfg.vote_bin, block=cfg.vote_block,
                         backend=backend)
    mapped = vote.votes > 0
    position = vote.win_bin * cfg.vote_bin          # int32, wraps as JAX's

    # -- banded DP of the anchor segment at the voted diagonal -------------
    win = _anchor_windows(ref, position, mapped, cfg)
    dp = banded_sw(segs[:, 0].contiguous(), win, scoring=p.scoring,
                   band=cfg.band(), backend=backend)

    return LongReadResult(
        position=torch.where(mapped, position, INVALID_LOC),
        votes=vote.votes,
        score=torch.where(mapped, dp.score, NEG).to(torch.int32),
        mapped=mapped,
        n_candidates=n_cand.reshape(B, S - 1).sum(-1).to(torch.int32),
        n_valid=torch.ones(B, dtype=torch.bool, device=reads.device),
    )


def map_long_reads(
    sm: SeedMap | PaddedSeedMap, ref: torch.Tensor, reads,
    cfg: LongReadConfig = LongReadConfig(),
) -> LongReadResult:
    """One-shot long-read mapping on the device ``ref`` lives on: the
    kernels on a CUDA ``ref`` (seed_buckets, pair_frontend, location_vote,
    banded_sw, as `Mapper.map_long` launches them), their plain versions on
    the CPU.  ``reads`` is a (B, L) uint8 tensor or array, moved to that
    device.  The session entry is `Mapper.map_long`."""
    reads = torch.as_tensor(reads, dtype=torch.uint8, device=ref.device)
    return map_long_impl(sm, ref, reads, cfg)


def long_stage_stat_counts(res: LongReadResult) -> dict:
    """Long-lane stage quantities as device int64 counts over the valid
    rows (`engine/stats.py` LONG_STAT_KEYS)."""
    v = res.n_valid

    def c(x):
        return torch.where(v, x, 0).sum()

    return {
        "lr_no_vote": c(~res.mapped),
        "lr_mapped": c(res.mapped),
        "lr_candidates": c(res.n_candidates),
        "lr_winning_votes": c(res.votes),
        "n_reads": v.sum(),
    }
