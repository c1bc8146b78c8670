"""Public wrapper of the standalone xxHash32 op (a building block).

On CUDA tensors `xxhash32` launches the `xxhash32` kernel, which runs the
hash `seed_buckets` runs (csrc/xxhash.cuh); on CPU tensors (or with
``backend="torch"``) it runs the plain version.

Types: ``words`` may be uint32, int32 bit patterns, or int64 values in
[0, 2^32) (taken mod 2^32, as `core.hashing.xxhash32_words` takes them).
The result is int64 hashes in [0, 2^32) on both backends: PyTorch's
uint32 has no arithmetic on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import MASK32, to_int32_bits
from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import I64, PTR, U32
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.xxhash.ref import xxhash32_ref

def xxhash32_cost(n: int) -> _cuda.Work:
    """16 bytes in and an int64 out a hash; ~51 integer operations of
    xxhash.cuh each."""
    return _cuda.Work(n * (16 + 8), n * 51)


XXHASH32 = _cuda.register("xxhash32", "xxhash32_launch",
                          (PTR, I64, U32, PTR, PTR), xxhash32_cost)

WORD_DTYPES = (torch.uint32, torch.int32, torch.int64)


def _int32_bits(words: torch.Tensor) -> torch.Tensor:
    if words.dtype == torch.int32:
        return words
    if words.dtype == torch.uint32:
        return words.view(torch.int32)
    return to_int32_bits(words)


def xxhash32(words: torch.Tensor, seed: int = 0,
             backend: str = "auto") -> torch.Tensor:
    """xxHash32 of (..., 4) little-endian words -> (...,) int64."""
    backend = resolve_backend(backend, words.device, family="xxhash")
    if words.shape[-1:] != (4,):
        raise ValueError(f"words must end in a 4-word axis, got "
                         f"{tuple(words.shape)}")
    if words.dtype not in WORD_DTYPES:
        raise TypeError(f"words must be one of {WORD_DTYPES}, got "
                        f"{words.dtype}")
    if backend == "torch":
        return xxhash32_ref(words, seed)
    flat = _int32_bits(words).reshape(-1, 4)
    if not flat.is_contiguous() or not _cuda.aligned(flat, 16):
        flat = flat.clone(memory_format=torch.contiguous_format)
    n = flat.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=words.device)
    XXHASH32(flat, n, seed & MASK32, out, stream=words, work=(n,))
    return out.reshape(words.shape[:-1])
