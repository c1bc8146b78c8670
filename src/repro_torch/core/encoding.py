"""2-bit DNA base encoding utilities.

Bases are encoded A=0, C=1, G=2, T=3 (uint8).  The packed representation
stores 16 bases per 32-bit word, base i occupying bits [2i, 2i+2).  PyTorch
has no usable unsigned 32-bit arithmetic, so packed words live in int32
tensors holding the same bits as the JAX package's uint32 words; the
arithmetic on them runs in int64 and is masked back to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

BASES = "ACGT"
A, C, G, T = 0, 1, 2, 3
BASES_PER_WORD = 16  # 2 bits/base, 32-bit words
MASK32 = 0xFFFFFFFF


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor holding the same bits."""
    x = x & MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def from_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & MASK32


def encode_str(s: str) -> np.ndarray:
    """Encode an ACGT string (either case) into uint8 codes (host-side
    helper); any other character raises."""
    lut = np.full(256, 255, dtype=np.uint8)
    for i, b in enumerate(BASES):
        lut[ord(b)] = i
        lut[ord(b.lower())] = i
    out = lut[np.frombuffer(s.encode(), dtype=np.uint8)]
    if (out == 255).any():
        raise ValueError("non-ACGT character in sequence")
    return out


def decode_to_str(codes) -> str:
    """uint8 codes (a tensor or an array) -> their ACGT string."""
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    return "".join(BASES[int(c)] for c in np.asarray(codes))


def revcomp(codes: torch.Tensor) -> torch.Tensor:
    """Reverse complement along the last axis.  A<->T, C<->G is 3-x."""
    return (3 - codes).flip(-1)


def pack_2bit(codes: torch.Tensor, n_words: int | None = None) -> torch.Tensor:
    """Pack uint8 base codes (..., L) into int32-held words (..., ceil(L/16)).

    Base i of a word occupies bits [2*i, 2*i+2).  Padding bases are 0
    (='A').  Words are the sum of the shifted codes, as in the JAX package.
    """
    L = codes.shape[-1]
    if n_words is None:
        n_words = (L + BASES_PER_WORD - 1) // BASES_PER_WORD
    pad = n_words * BASES_PER_WORD - L
    if pad:
        codes = torch.cat(
            [codes, codes.new_zeros(codes.shape[:-1] + (pad,))], dim=-1)
    w = codes.reshape(codes.shape[:-1] + (n_words, BASES_PER_WORD)).to(
        torch.int64)
    shifts = 2 * torch.arange(BASES_PER_WORD, device=codes.device)
    return to_int32_bits((w << shifts).sum(dim=-1))


def unpack_2bit(words: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of pack_2bit: (..., W) int32 words -> (..., length) uint8."""
    shifts = 2 * torch.arange(BASES_PER_WORD, device=words.device)
    codes = (from_int32_bits(words)[..., :, None] >> shifts) & 3
    codes = codes.reshape(words.shape[:-1] + (-1,))
    return codes[..., :length].to(torch.uint8)


def mismatch_mask_packed(a_words: torch.Tensor,
                         b_words: torch.Tensor) -> torch.Tensor:
    """XOR two packed sequences and collapse bit pairs: int32-held words
    whose bit pair (2i, 2i+1) is nonzero iff base i differs (the low bit
    of the pair carries it).  The Light Alignment primitive, "simple
    vectorized logical XOR operators" (§1).  The arithmetic shift of an
    int32 differs from the uint32 one only in bit 31, which the mask
    clears, so the bits equal the JAX package's uint32 result."""
    x = a_words ^ b_words
    lo = x & 0x55555555
    hi = (x >> 1) & 0x55555555
    return lo | hi


def packed_gather_coords(n_ref_words: int, length: int) -> tuple[int, int]:
    """(n_words, start clamp hi) for a `length`-base packed-window gather.

    Shared by `gather_windows_packed` and the packed-flavor kernel preps,
    which must mirror this gather bit-for-bit.
    """
    n_words = length // BASES_PER_WORD + 2
    hi = min(n_ref_words * BASES_PER_WORD - length - 1, 2**31 - 1)
    return n_words, hi


def gather_windows_packed(ref_words: torch.Tensor, starts: torch.Tensor,
                          length: int) -> torch.Tensor:
    """Gather base windows from a 2-bit packed reference.

    ref_words: (Lw,) int32-held words; starts: (...,) int32 window starts
    (clamped to the packed range); -> (..., length) uint8.
    """
    Lw = ref_words.shape[0]
    n_words, hi = packed_gather_coords(Lw, length)
    starts = starts.to(torch.int64).clamp(0, hi)
    w0 = starts // BASES_PER_WORD
    off = starts % BASES_PER_WORD
    dev = ref_words.device
    idx = w0[..., None] + torch.arange(n_words, device=dev)
    words = ref_words[idx.clamp(0, Lw - 1)]                 # (..., n_words)
    codes = unpack_2bit(words, n_words * BASES_PER_WORD)
    take = off[..., None] + torch.arange(length, device=dev)
    return torch.take_along_dim(codes, take, dim=-1)
