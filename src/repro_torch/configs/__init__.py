"""Model configurations of the LM serving path (the dense family)."""
