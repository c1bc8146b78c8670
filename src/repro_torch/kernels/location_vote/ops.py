"""Public wrapper of the Location Voting reduction (§4.7).

On CUDA tensors `location_vote` launches the `location_vote` kernel (one
warp per read); on CPU tensors (or with ``backend="torch"``) it runs the
plain version in `ref.py`.  ``block`` is the kernel's warps (reads) a
block (`vote_warps`): None for the default, a value the kernel cannot
take raises on either backend; the result does not depend on it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import INT, PTR
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.location_vote.ref import (
    VoteResult,
    location_vote_ref,
)

def location_vote_cost(B: int, M: int) -> _cuda.Work:
    """Each (B, M) int32 row read once, two ints a read written; the
    function's own work, a sort of each row (~2 M log2 M)."""
    return _cuda.Work(4 * B * M + 8 * B, B * 2 * M * math.log2(max(M, 2)))


LOCATION_VOTE = _cuda.register(
    "location_vote", "location_vote_launch",
    (PTR, INT, INT, INT, PTR, PTR, INT, PTR), location_vote_cost)

MAX_SHARED = 48 * 1024
MAX_WARPS = 32            # 1,024 threads a block
DEFAULT_WARPS = 8


def vote_warps(M: int, block: int | None = None) -> int:
    """Warps (reads) a block of the location_vote kernel.

    A warp holds its row's compacted bins, round_up(M, 4) ints, in shared
    memory.  None gives the default: 8, or as many as fit 48 KB.  An
    explicit ``block`` past 1,024 threads or 48 KB raises; nothing is
    clamped."""
    fit = MAX_SHARED // (4 * max(-(-M // 4) * 4, 4))
    if fit < 1:
        raise ValueError(f"a {M}-slot diagonal row exceeds the kernel's "
                         f"{MAX_SHARED}-byte shared memory")
    if block is None:
        return min(DEFAULT_WARPS, fit)
    top = min(MAX_WARPS, fit)
    if not 1 <= block <= top:
        raise ValueError(f"location_vote takes 1..{top} warps a block at "
                         f"M = {M}, got {block}")
    return block


def location_vote(diag: torch.Tensor, vote_bin: int,
                  block: int | None = None,
                  backend: str = "auto") -> VoteResult:
    """(B, M) int32 read-start diagonals (INVALID_LOC padded) -> each
    read's winning ``vote_bin``-wide bin and its vote count."""
    backend = resolve_backend(backend, diag.device, family="location_vote")
    if vote_bin <= 0:
        raise ValueError(f"vote_bin must be positive, got {vote_bin}")
    if block is not None:
        vote_warps(diag.shape[1], block)
    if backend == "torch":
        return location_vote_ref(diag, vote_bin)
    B, M = diag.shape
    _cuda.check(diag, "diag", torch.int32)
    warps = vote_warps(M, block)
    win_bin, votes = (torch.empty(B, dtype=torch.int32, device=diag.device)
                      for _ in range(2))
    LOCATION_VOTE(diag, B, M, vote_bin, win_bin, votes, warps, stream=diag,
                  work=(B, M))
    return VoteResult(win_bin=win_bin, votes=votes)
