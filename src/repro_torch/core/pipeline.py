"""GenPair online pipeline (§4.1, Fig. 3): the paper's steps end to end.

`map_pairs_impl` is the math of one fixed-shape batch; `repro_torch.engine`
(`Mapper`) is the front door that resolves the reference flavor, the
SeedMap layout and the kernel backend once per session.

  1-3. Seeding + SeedMap Query + Paired-Adjacency Filtering
                          -> kernels/pair_frontend (CUDA: seed_buckets,
                             pair_frontend)
  4.   Light Alignment + best-pair pick -> kernels/candidate_align
  5.   DP fallback for residual pairs   -> kernels/residual_dp

Residual pairs go through a fixed-capacity DP buffer of
``residual_capacity_frac * B`` rows; overflow is flagged, not dropped, and
``residual_capacity_frac=0`` removes the DP stage.

Method codes (MapResult.method):
  0 UNMAPPED          no candidate and no DP capacity spent
  1 LIGHT             mapped+aligned by Light Alignment
  2 DP                mapped by the filter, aligned by fallback DP
  3 RESIDUAL_FULL     no SeedMap/adjacency candidates -> full DP pipeline
  4 DP_OVERFLOW       needed DP but the residual buffer was full
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.dp_fallback import NEG
from repro_torch.core.encoding import revcomp
from repro_torch.core.pair_filter import paired_adjacency_filter
from repro_torch.core.query import padded_rows_device, query_read_batch
from repro_torch.core.scoring import Scoring
from repro_torch.core.seeding import seed_read_batch
from repro_torch.core.seedmap import INVALID_LOC, PaddedSeedMap, SeedMap
from repro_torch.kernels._util import KernelRef
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.candidate_align.ops import candidate_pair_align
from repro_torch.kernels.pair_frontend.ops import pair_frontend
from repro_torch.kernels.residual_dp.ops import residual_pair_dp

M_UNMAPPED, M_LIGHT, M_DP, M_RESIDUAL_FULL, M_DP_OVERFLOW = 0, 1, 2, 3, 4
INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    read_len: int = 150
    seed_len: int = 50
    seeds_per_read: int = 3
    max_locs_per_seed: int = 32   # K: per-seed location cap
    delta: int = 500              # Paired-Adjacency threshold Δ
    max_candidates: int = 8       # C: candidate cap after filtering
    max_gap: int = 8              # E: Light Alignment max indel-run length
    dp_pad: int = 16              # DP fallback window halo
    light_mode: str = "minsplit"  # "paper" for the paper-faithful mechanism
    accept_threshold: int | None = None  # default: perfect - 24
    # Fraction of the batch the residual DP buffer holds (rows); 0 removes
    # the DP stage and every residual row reports M_DP_OVERFLOW.
    residual_capacity_frac: float = 0.25
    # Half-width of the residual DP band; None derives dp_pad + max_gap.
    # Any value >= read_len + 2*dp_pad is the exact unbanded DP.
    dp_band: int | None = None
    scoring: Scoring = Scoring()
    # Align only the best `prescreen_top` candidate pairs by zero-shift
    # Hamming distance; None or 0 aligns every candidate.
    prescreen_top: int | None = None
    # 2-bit packed reference for every window gather; None keeps the
    # entry point's default (unpacked).
    packed_ref: bool | None = None
    # Launch geometry of the pair kernels: warps (pairs) a block of
    # pair_frontend and merge_filter, pairs a block of candidate_align,
    # warps (slots) a block of residual_dp.  None keeps each kernel's
    # hand-picked default; the tuner (`repro_torch.tune`) fills them.  The
    # result does not depend on them.
    frontend_block: int | None = None
    light_block: int | None = None
    residual_block: int | None = None

    def threshold(self) -> int:
        if self.accept_threshold is not None:
            return self.accept_threshold
        return self.scoring.default_threshold(self.read_len)

    def packed(self, default: bool) -> bool:
        """Resolve the tri-state packed_ref against an entry point default."""
        return default if self.packed_ref is None else self.packed_ref

    def band(self) -> int:
        """Resolved residual-DP band half-width (`dp_band` or derived)."""
        if self.dp_band is not None:
            return self.dp_band
        return self.dp_pad + self.max_gap

    def prescreen(self) -> int:
        """Resolved prescreen_top (None behaves as 0/off)."""
        return self.prescreen_top or 0

    def residual_cap(self, batch: int) -> int:
        """Residual DP buffer rows for a ``batch``-row step (0: no stage;
        any positive fraction provisions at least one row)."""
        if self.residual_capacity_frac <= 0:
            return 0
        return max(1, int(round(batch * self.residual_capacity_frac)))


class MapResult(NamedTuple):
    pos1: torch.Tensor      # (B,) int32 mapped read-1 start (INVALID_LOC if not)
    pos2: torch.Tensor      # (B,) int32 mapped read-2 window start
    score1: torch.Tensor    # (B,) int32
    score2: torch.Tensor    # (B,) int32
    method: torch.Tensor    # (B,) int32 M_*
    cigar1: torch.Tensor    # (B, 3, 2) int32 light-align CIGAR runs
    cigar2: torch.Tensor
    had_hits: torch.Tensor          # (B,) bool both reads had SeedMap hits
    passed_adjacency: torch.Tensor  # (B,) bool >=1 candidate survived Δ
    light_ok: torch.Tensor          # (B,) bool light alignment accepted
    dp_mate1: torch.Tensor          # (B,) bool mate 1 re-aligned by DP
    dp_mate2: torch.Tensor
    n_valid: torch.Tensor           # (B,) bool row is a real pair


def stage_stat_counts(res: MapResult) -> dict:
    """Fig. 10 quantities as device int64 counts over the valid rows."""
    v = res.n_valid

    def c(x):
        return (x & v).sum()

    return {
        "no_seed_hit": c(~res.had_hits),
        "adjacency_fail": c(res.had_hits & ~res.passed_adjacency),
        "light_align_fail": c(res.passed_adjacency & ~res.light_ok),
        "light_mapped": c(res.method == M_LIGHT),
        "dp_mapped": c(res.method == M_DP),
        "dp_overflow": c(res.method == M_DP_OVERFLOW),
        "residual_full_dp": c(res.method == M_RESIDUAL_FULL),
        "dp_mate_alignments": c(res.dp_mate1) + c(res.dp_mate2),
        "n_pairs": v.sum(),
    }


def stage_stats(res: MapResult) -> dict:
    """Fig. 10 quantities as fractions of the (valid rows of the) batch,
    device float32 scalars.  Reading them on the host syncs; accumulate
    `stage_stat_counts` on the device instead when looping over batches."""
    counts = stage_stat_counts(res)
    n = counts.pop("n_pairs").clamp(min=1)
    return {k: v / n for k, v in counts.items()}


class ResidualBuffer(NamedTuple):
    """The fixed-capacity residual DP buffer of one batch (step 5)."""

    idx: torch.Tensor    # (cap,) int64 batch row of each buffer row
    take: torch.Tensor   # (cap,) bool  the row needs DP (False: filler)
    need1: torch.Tensor  # (cap,) bool  mate 1 is re-aligned
    need2: torch.Tensor  # (cap,) bool  mate 2 is re-aligned


def residual_buffer(pair, needs_dp: torch.Tensor, cap: int) -> ResidualBuffer:
    """Fill the ``cap``-row buffer with the rows that need DP, in batch
    order (stable), then reorder the taken rows by window start, filler
    rows last — a permutation of independent items, so results are
    unchanged.  A row's passing mate is not re-aligned."""
    order = torch.argsort((~needs_dp).to(torch.uint8), stable=True)
    idx = order[:cap]
    take = needs_dp[idx]
    locality = torch.argsort(
        torch.where(take, pair.pos1[idx], INT32_MAX), stable=True)
    idx = idx[locality]
    take = take[locality]
    return ResidualBuffer(idx, take, take & ~pair.ok1[idx],
                          take & ~pair.ok2[idx])


def _residual_dp_stage(ref, reads1, reads2_fwd, pair, passed, light_ok,
                       cfg: PipelineConfig, packed: bool, backend: str,
                       kref=None, split=None):
    """Step 5: the fixed-capacity, single-mate-aware banded DP fallback.

    Returns ``(score1, score2, dp_done, dp_overflow, dp_mate1, dp_mate2)``,
    all (B,): a passing mate of a re-aligned row keeps its light score.
    With ``split`` (a `core.distributed.RowSplit`) the batch's buffer is
    filled as one, and each data rank aligns its share of the buffer rows.
    """
    B = passed.shape[0]
    dev = passed.device
    needs_dp = passed & ~light_ok
    cap = cfg.residual_cap(B)
    zeros = torch.zeros(B, dtype=torch.bool, device=dev)
    neg = torch.full((B,), NEG, dtype=torch.int32, device=dev)
    if cap == 0:
        return neg, neg.clone(), zeros, needs_dp, zeros, zeros.clone()

    buf = residual_buffer(pair, needs_dp, cap)
    dp_idx = buf.idx
    idx, need1, need2 = dp_idx, buf.need1, buf.need2
    if split is not None:
        # filler rows (nothing to align) up to a multiple of the ranks
        pad = -cap % split.size
        idx = torch.cat([idx, idx[:1].expand(pad)])
        need1, need2 = (torch.cat([x, x.new_zeros(pad)])
                        for x in (need1, need2))
        idx, need1, need2 = (split.rows(x) for x in (idx, need1, need2))
    dp = residual_pair_dp(
        ref, reads1[idx], reads2_fwd[idx], pair.pos1[idx], pair.pos2[idx],
        need1, need2, cfg.dp_pad, band=cfg.band(), scoring=cfg.scoring,
        packed_ref=packed, backend=backend, kref=kref,
        block=cfg.residual_block)
    dp_s1, dp_s2 = dp.score1, dp.score2
    if split is not None:
        dp_s1, dp_s2 = (x[:cap] for x in split.gather((dp_s1, dp_s2)))
    sc1 = torch.where(buf.need1, dp_s1, pair.score1[dp_idx])
    sc2 = torch.where(buf.need2, dp_s2, pair.score2[dp_idx])

    def scatter(base, vals):
        out = base.clone()
        out[dp_idx] = vals
        return out

    dp_sc1 = scatter(neg, torch.where(buf.take, sc1, NEG).to(torch.int32))
    dp_sc2 = scatter(neg, torch.where(buf.take, sc2, NEG).to(torch.int32))
    dp_done = scatter(zeros, buf.take)
    return (dp_sc1, dp_sc2, dp_done, needs_dp & ~dp_done,
            scatter(zeros, buf.need1), scatter(zeros, buf.need2))


def map_pairs_impl(
    sm: SeedMap | PaddedSeedMap,
    ref: torch.Tensor,
    reads1: torch.Tensor,
    reads2: torch.Tensor,
    cfg: PipelineConfig = PipelineConfig(),
    backend: str = "auto",
    kref: KernelRef | None = None,
    split=None,
) -> MapResult:
    """Map a batch of FR read pairs; reads2 is as-sequenced (reverse strand).

    ``ref`` is the (L,) uint8 base array, or with ``cfg.packed_ref=True``
    the (Lw,) int32-held 2-bit packing.  ``sm`` is the CSR `SeedMap`
    (queried by the staged plain path) or the `PaddedSeedMap` the kernel
    front end gathers rows from; a CSR map on the kernel path is re-laid
    out per call (test scales only).  ``backend`` ("auto" | "cuda" |
    "torch") picks the kernels or their plain versions for every step;
    ``kref`` is ``ref`` padded once for the window kernels (built per call
    when None).  ``split``: see `map_batch`.
    """
    backend = resolve_backend(backend, reads1.device)

    def front(r1, r2_fwd):
        if isinstance(sm, SeedMap) and backend == "torch":
            hs = sm.config.hash_seed
            q1 = query_read_batch(
                sm, seed_read_batch(r1, cfg.seed_len, cfg.seeds_per_read, hs),
                cfg.max_locs_per_seed)
            q2 = query_read_batch(
                sm, seed_read_batch(r2_fwd, cfg.seed_len, cfg.seeds_per_read,
                                    hs), cfg.max_locs_per_seed)
            return ((q1.n_hits > 0) & (q2.n_hits > 0),
                    paired_adjacency_filter(q1, q2, cfg.delta,
                                            cfg.max_candidates))
        rows = (sm.rows if isinstance(sm, PaddedSeedMap)
                else padded_rows_device(sm, cfg.max_locs_per_seed))
        fe = pair_frontend(rows, r1, r2_fwd, cfg.seed_len,
                           cfg.seeds_per_read, sm.config.hash_seed, cfg.delta,
                           cfg.max_candidates, block=cfg.frontend_block,
                           backend=backend)
        return (fe.n_hits1 > 0) & (fe.n_hits2 > 0), fe

    return map_batch(front, ref, reads1, reads2, cfg, backend, kref, split)


def map_batch(front, ref: torch.Tensor, reads1: torch.Tensor,
              reads2: torch.Tensor, cfg: PipelineConfig, backend: str,
              kref: KernelRef | None = None, split=None) -> MapResult:
    """Steps 1-5 of a batch around its front end, shared by
    `map_pairs_impl` and the sharded-index serve step
    (`core.genpairx_step`).

    ``front(reads1, reads2_fwd) -> (had_hits, cands)`` runs steps 1-3
    (``cands`` holds (B, C) ``pos1`` / ``pos2`` and (B,) ``n``);
    ``backend`` is resolved.  With ``split`` (a `core.distributed.RowSplit`
    over the mesh's data axis) the batch is the global one every rank was
    handed: steps 1-4 run on this rank's rows and are all_gathered, and
    step 5 fills the global residual buffer, so the result equals the
    single-device result and every rank returns it.
    """
    # engine imports core, so the stream's spans are looked up here
    from repro_torch.engine.spans import span

    B, R = reads1.shape
    if R != cfg.read_len:
        raise ValueError(f"reads are {R} bp, config says {cfg.read_len}")
    # -- 1-3. Front end --------------------------------------------------
    with span("step.front"):
        reads2_fwd = revcomp(reads2).contiguous()  # reference orientation
        r1, r2_fwd = reads1, reads2_fwd
        if split is not None:
            r1, r2_fwd = split.rows(reads1), split.rows(reads2_fwd)
        had_hits, cands = front(r1, r2_fwd)
        passed = cands.n > 0

    # -- 4. Light Alignment over candidates ------------------------------
    with span("step.light"):
        packed = cfg.packed(default=False)
        if packed and ref.dtype != torch.int32:
            raise ValueError("packed_ref needs the int32 packed words")
        pair = candidate_pair_align(
            ref, r1, r2_fwd, cands.pos1, cands.pos2, cfg.max_gap,
            scoring=cfg.scoring, threshold=cfg.threshold(),
            mode=cfg.light_mode, prescreen_top=cfg.prescreen(),
            packed_ref=packed, backend=backend, kref=kref,
            block=cfg.light_block)
        if split is not None:
            had_hits, passed, *fields = split.gather((had_hits, passed,
                                                      *pair))
            pair = type(pair)(*fields)
        light_ok = passed & pair.ok1 & pair.ok2

    # -- 5. DP fallback on the fixed-capacity residual buffer ------------
    with span("step.dp"):
        dp_sc1, dp_sc2, dp_done, dp_overflow, dp_m1, dp_m2 = \
            _residual_dp_stage(ref, reads1, reads2_fwd, pair, passed,
                               light_ok, cfg, packed, backend, kref, split)

    # -- assemble ---------------------------------------------------------
    with span("step.assemble"):
        method = torch.full((B,), M_UNMAPPED, dtype=torch.int32,
                            device=reads1.device)
        method = torch.where(~had_hits, M_RESIDUAL_FULL, method)
        method = torch.where(had_hits & ~passed, M_RESIDUAL_FULL, method)
        method = torch.where(light_ok, M_LIGHT, method)
        method = torch.where(dp_done, M_DP, method)
        method = torch.where(dp_overflow, M_DP_OVERFLOW, method)

        mapped = light_ok | dp_done
        return MapResult(
            pos1=torch.where(mapped, pair.pos1, INVALID_LOC),
            pos2=torch.where(mapped, pair.pos2, INVALID_LOC),
            score1=torch.where(light_ok, pair.score1,
                               torch.where(dp_done, dp_sc1, NEG)),
            score2=torch.where(light_ok, pair.score2,
                               torch.where(dp_done, dp_sc2, NEG)),
            method=method, cigar1=pair.cigar1, cigar2=pair.cigar2,
            had_hits=had_hits, passed_adjacency=passed, light_ok=light_ok,
            dp_mate1=dp_m1, dp_mate2=dp_m2,
            n_valid=torch.ones(B, dtype=torch.bool, device=reads1.device),
        )
