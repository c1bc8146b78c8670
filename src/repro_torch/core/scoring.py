"""Minimap2 short-read (sr) scoring scheme used throughout (§3.4).

match +2, mismatch -8, affine gaps: a k-base gap costs 12 + 2k.  A perfect
150 bp read scores 300, one mismatch 290, one deletion 286, one insertion
284.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Scoring:
    match: int = 2
    mismatch: int = 8      # penalty (positive)
    gap_open: int = 12     # charged once per gap run, on top of extends
    gap_extend: int = 2    # per gap base (including the first)

    def gap_cost(self, k):
        """Cost of a k-base gap run (k >= 1)."""
        return self.gap_open + self.gap_extend * k

    def perfect(self, read_len: int) -> int:
        return self.match * read_len

    def default_threshold(self, read_len: int) -> int:
        """Paper's high-quality cutoff: perfect - 24 (= 276 for 150 bp)."""
        return self.perfect(read_len) - 24
