"""Model configurations of the LM serving path (all ten of repro's)."""
