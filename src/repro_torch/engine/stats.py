"""Device-side stage totals of the two lanes.

`Mapper.map_stream` / `map_long_stream` add each batch's stage counts
into one device tensor and fetch it once, when the stream ends.
"""
from __future__ import annotations

import torch

#: the pair lane's accumulated keys: the Fig. 10 stage counts plus the
#: valid-pair total
STAT_KEYS = (
    "no_seed_hit", "adjacency_fail", "light_align_fail", "light_mapped",
    "dp_mapped", "dp_overflow", "residual_full_dp", "dp_mate_alignments",
    "n_pairs",
)

#: the long-read lane's accumulated keys (`long_stage_stat_counts`): vote
#: outcomes, per-read candidate and winning-vote totals (their fractions
#: read as means per read) and the valid-read total
LONG_STAT_KEYS = (
    "lr_no_vote", "lr_mapped", "lr_candidates", "lr_winning_votes",
    "n_reads",
)

#: batch-size keys, the denominators of `stage_fractions`
_DENOM_KEYS = ("n_pairs", "n_reads")


def init_stage_totals(device, keys: tuple) -> torch.Tensor:
    """Fresh all-zero (len(keys),) int64 accumulator on ``device``."""
    return torch.zeros(len(keys), dtype=torch.int64, device=device)


def add_stage_counts(totals: torch.Tensor, counts: dict,
                     keys: tuple) -> None:
    """totals += counts, on the device, without a host sync."""
    totals += torch.stack([counts[k] for k in keys])


def fetch_stage_totals(totals: torch.Tensor, keys: tuple) -> dict:
    """One host sync: device totals -> {key: python int}."""
    return dict(zip(keys, totals.tolist()))


def stage_fractions(totals: dict) -> dict:
    """Per-item fractions from fetched totals, over whichever batch-size
    key the lane accumulated (``n_pairs`` or ``n_reads``)."""
    n = max(max(totals.get(k, 0) for k in _DENOM_KEYS), 1)
    return {k: v / n for k, v in totals.items() if k not in _DENOM_KEYS}
