"""Causal flash attention forward (the LM serving path's prefill)."""
