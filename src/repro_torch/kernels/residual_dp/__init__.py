"""Fused residual DP fallback: banded Gotoh of the failed mates."""
