"""Public wrapper of the Location Voting reduction (§4.7).

On CUDA tensors `location_vote` launches the `location_vote` kernel (one
warp per read); on CPU tensors (or with ``backend="torch"``) it runs the
plain version in `ref.py`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import INT, PTR
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.location_vote.ref import (
    VoteResult,
    location_vote_ref,
)

LOCATION_VOTE = _cuda.register(
    "location_vote", "location_vote_launch",
    (PTR, INT, INT, INT, PTR, PTR, PTR))

MAX_SHARED = 48 * 1024


def location_vote(diag: torch.Tensor, vote_bin: int,
                  backend: str = "auto") -> VoteResult:
    """(B, M) int32 read-start diagonals (INVALID_LOC padded) -> each
    read's winning ``vote_bin``-wide bin and its vote count."""
    backend = resolve_backend(backend, diag.device, family="location_vote")
    if vote_bin <= 0:
        raise ValueError(f"vote_bin must be positive, got {vote_bin}")
    if backend == "torch":
        return location_vote_ref(diag, vote_bin)
    B, M = diag.shape
    _cuda.check(diag, "diag", torch.int32)
    if -(-M // 4) * 16 > MAX_SHARED:
        raise ValueError(f"a {M}-slot diagonal row exceeds the kernel's "
                         f"{MAX_SHARED}-byte shared memory")
    win_bin, votes = (torch.empty(B, dtype=torch.int32, device=diag.device)
                      for _ in range(2))
    LOCATION_VOTE(diag.data_ptr(), B, M, vote_bin, win_bin.data_ptr(),
                  votes.data_ptr(), _cuda.stream_of(diag))
    return VoteResult(win_bin=win_bin, votes=votes)
