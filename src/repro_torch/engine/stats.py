"""Device-side stage totals of the pair lane.

`Mapper.map_stream` adds each batch's `stage_stat_counts` into one device
tensor and fetches it once, when the stream ends.
"""
from __future__ import annotations

import torch

#: accumulated keys: the Fig. 10 stage counts plus the valid-pair total
STAT_KEYS = (
    "no_seed_hit", "adjacency_fail", "light_align_fail", "light_mapped",
    "dp_mapped", "dp_overflow", "residual_full_dp", "dp_mate_alignments",
    "n_pairs",
)


def init_stage_totals(device) -> torch.Tensor:
    """Fresh all-zero (len(STAT_KEYS),) int64 accumulator on ``device``."""
    return torch.zeros(len(STAT_KEYS), dtype=torch.int64, device=device)


def add_stage_counts(totals: torch.Tensor, counts: dict) -> None:
    """totals += counts, on the device, without a host sync."""
    totals += torch.stack([counts[k] for k in STAT_KEYS])


def fetch_stage_totals(totals: torch.Tensor) -> dict:
    """One host sync: device totals -> {key: python int}."""
    return dict(zip(STAT_KEYS, totals.tolist()))


def stage_fractions(totals: dict) -> dict:
    """Per-pair fractions from fetched totals."""
    n = max(totals.get("n_pairs", 0), 1)
    return {k: v / n for k, v in totals.items() if k != "n_pairs"}
