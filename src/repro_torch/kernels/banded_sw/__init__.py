"""Banded semiglobal Gotoh DP of the long-read anchor segment."""
