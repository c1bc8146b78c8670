"""Plain PyTorch version of the xxhash32 kernel (delegates to core)."""
import torch

from repro_torch.core.hashing import xxhash32_words


def xxhash32_ref(words: torch.Tensor, seed: int = 0) -> torch.Tensor:
    return xxhash32_words(words, seed=seed)
