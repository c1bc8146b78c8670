"""xxHash32 (exact, spec-compliant) over fixed 16-byte inputs, vectorized.

The paper hashes each 50 bp seed into a 32-bit value with xxHash (§4.3).
A 50-mer packs into 100 bits; it is zero-padded to 16 bytes (4 32-bit
little-endian words) so every hash takes one 4-lane round + avalanche.

`xxhash32_words` computes in int64 masked to 32 bits (PyTorch's uint32
has no arithmetic on the CPU, and int32 `>>` shifts arithmetically).
Products are split into 16-bit halves so no int64 intermediate
overflows.  `xxhash32_words_np` is the numpy twin used for host checks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import MASK32, from_int32_bits

PRIME1 = 2654435761
PRIME2 = 2246822519
PRIME3 = 3266489917


def _mul32(x: torch.Tensor, p: int) -> torch.Tensor:
    """(x * p) mod 2^32 for x in [0, 2^32) without int64 overflow."""
    lo = x * (p & 0xFFFF)
    hi = ((x * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _round(acc, lane: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl((acc + _mul32(lane, PRIME2)) & MASK32, 13), PRIME1)


def xxhash32_words(words: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """xxHash32 of a 16-byte message given as (..., 4) little-endian words.

    ``words`` may be int32 bit patterns or int64 values in [0, 2^32).
    Returns int64 hashes in [0, 2^32).
    """
    w = from_int32_bits(words) if words.dtype == torch.int32 \
        else words.to(torch.int64) & MASK32
    s = seed & MASK32
    v1 = _round((s + PRIME1 + PRIME2) & MASK32, w[..., 0])
    v2 = _round((s + PRIME2) & MASK32, w[..., 1])
    v3 = _round(s, w[..., 2])
    v4 = _round((s - PRIME1) & MASK32, w[..., 3])
    acc = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
           + 16) & MASK32  # + total length in bytes
    acc = acc ^ (acc >> 15)
    acc = _mul32(acc, PRIME2)
    acc = acc ^ (acc >> 13)
    acc = _mul32(acc, PRIME3)
    return acc ^ (acc >> 16)


def xxhash32_words_np(words: np.ndarray, seed: int = 0) -> np.ndarray:
    """NumPy mirror in native uint32 (host-side checks)."""
    with np.errstate(over="ignore"):
        w = words.astype(np.uint32)
        s = np.uint32(seed)
        p1, p2, p3 = np.uint32(PRIME1), np.uint32(PRIME2), np.uint32(PRIME3)

        def rotl(x, r):
            return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

        def rnd(acc, lane):
            return rotl(acc + lane * p2, 13) * p1

        v1 = rnd(s + p1 + p2, w[..., 0])
        v2 = rnd(s + p2, w[..., 1])
        v3 = rnd(s + np.uint32(0), w[..., 2])
        v4 = rnd(s - p1, w[..., 3])
        acc = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)
        acc = acc + np.uint32(16)
        acc ^= acc >> np.uint32(15)
        acc *= p2
        acc ^= acc >> np.uint32(13)
        acc *= p3
        acc ^= acc >> np.uint32(16)
        return acc
