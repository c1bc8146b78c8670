"""Public wrapper of the fused residual-DP fallback op (step 5).

On CUDA tensors one `residual_dp` launch covers the ``2*N`` (row, mate)
slots: one warp per slot, so a slot whose ``need`` flag is clear costs a
warp that writes ``NEG`` / 0 and exits, and no compaction, gather or
scatter runs around the kernel.  The kernel computes each window's start
itself (`kernels/_util.window_starts`'s clamp).  No host sync decides the
launch.  On CPU tensors (or with ``backend="torch"``) it runs the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import packed_gather_coords
from repro_torch.core.scoring import Scoring
from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import INT, PTR
from repro_torch.kernels._util import (
    KernelRef,
    kernel_reference,
    lane_slots,
)
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.residual_dp.ref import (
    ResidualDPResult,
    residual_pair_dp_ref,
)

RESIDUAL_DP = _cuda.register(
    "residual_dp", "residual_dp_launch",
    (PTR, INT) + (PTR,) * 6 + (INT,) * 13 + (PTR,) * 3)


def residual_pair_dp(
    ref: torch.Tensor,       # (L,) uint8 bases, or (Lw,) int32 packed words
    reads1: torch.Tensor,    # (N, R) uint8 mate 1, reference orientation
    reads2: torch.Tensor,    # (N, R) uint8 mate 2, reference orientation
    pos1: torch.Tensor,      # (N,) int32 best-candidate starts
    pos2: torch.Tensor,
    need1: torch.Tensor,     # (N,) bool: mate 1's Light Alignment failed
    need2: torch.Tensor,
    dp_pad: int,
    band: int | None = None,
    scoring: Scoring = Scoring(),
    packed_ref: bool = False,
    backend: str = "auto",
    kref: KernelRef | None = None,
) -> ResidualDPResult:
    """Banded DP fallback for a compacted batch of residual pairs.

    ``kref``: ``ref`` already padded for windows of at least R+2*dp_pad
    bases (`kernels/_util.kernel_reference`); built here when None."""
    backend = resolve_backend(backend, ref.device, family="residual_dp")
    need1 = need1.bool()
    need2 = need2.bool()
    if backend == "torch":
        return residual_pair_dp_ref(ref, reads1, reads2, pos1, pos2, need1,
                                    need2, dp_pad, band, scoring, packed_ref)

    N, R = reads1.shape
    W = R + 2 * dp_pad
    _cuda.check(ref, "ref", torch.int32 if packed_ref else torch.uint8)
    _cuda.check(reads1, "reads1", torch.uint8)
    _cuda.check(reads2, "reads2", torch.uint8, (N, R))
    _cuda.check(pos1, "pos1", torch.int32, (N,))
    _cuda.check(pos2, "pos2", torch.int32, (N,))
    need1 = need1.contiguous()
    need2 = need2.contiguous()
    _cuda.check(need1, "need1", torch.bool, (N,))
    _cuda.check(need2, "need2", torch.bool, (N,))
    full = band is None or band >= W
    cpl = lane_slots(W + 1 if full else 2 * band + 1)
    if kref is None:
        kref = kernel_reference(ref, W, packed_ref)
    _cuda.check(kref.data, "kref.data", ref.dtype)
    if kref.pad < W:
        raise ValueError(f"a reference padded for {kref.pad}-base windows "
                         f"cannot serve {W}-base windows")
    # the window coordinates of `window_starts`, computed in the kernel
    win_hi = packed_gather_coords(ref.shape[0], W)[1] if packed_ref else 0
    score, end = (torch.empty((N, 2), dtype=torch.int32, device=ref.device)
                  for _ in range(2))
    RESIDUAL_DP(
        kref.data.data_ptr(), int(packed_ref), reads1.data_ptr(),
        reads2.data_ptr(), pos1.data_ptr(), pos2.data_ptr(),
        need1.data_ptr(), need2.data_ptr(), N, R, W, -1 if full else band,
        dp_pad, ref.shape[0], win_hi, kref.pad, cpl, scoring.match,
        scoring.mismatch, scoring.gap_open, scoring.gap_extend,
        score.data_ptr(), end.data_ptr(), _cuda.stream_of(ref))
    return ResidualDPResult(
        score1=score[:, 0], ref_end1=end[:, 0],
        score2=score[:, 1], ref_end2=end[:, 1],
        dp_lanes=need1.sum() + need2.sum())
