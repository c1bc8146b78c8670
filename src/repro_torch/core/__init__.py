"""The GenPair pipeline math in PyTorch (steps 1-5 of the paper)."""
