"""Public wrapper of the fused residual-DP fallback op (step 5).

On CUDA tensors the ``2*N`` (row, mate) slots are stably partitioned so
the items whose ``need`` mask is set come first; the `residual_dp`
kernel reads the live item count from device memory, runs the banded DP
for those items only, and the results scatter back to per-mate (N,)
arrays through the inverse permutation.  Mates whose Light Alignment
succeeded come back as ``NEG`` / 0.  No host sync decides the launch.  On
CPU tensors (or with ``backend="torch"``) it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.dp_fallback import NEG
from repro_torch.core.scoring import Scoring
from repro_torch.core.seedmap import INVALID_LOC
from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import INT, PTR
from repro_torch.kernels._util import (
    KernelRef,
    kernel_reference,
    window_starts,
)
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.residual_dp.ref import (
    ResidualDPResult,
    residual_pair_dp_ref,
)

RESIDUAL_DP = _cuda.register(
    "residual_dp", "residual_dp_launch",
    (PTR, INT, PTR, PTR, PTR, PTR) + (INT,) * 9 + (PTR, PTR, PTR, PTR))

MAX_SHARED = 48 * 1024


def dp_threads(cols: int) -> int:
    """Threads per block so each thread's H and E rows (2*cols int32) fit
    48 KB of shared memory; whole warps where possible."""
    t = min(128, MAX_SHARED // (8 * cols))
    if t < 1:
        raise ValueError(f"a {cols}-column DP row exceeds shared memory")
    return t - t % 32 if t >= 32 else t


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
    if kref is None:
        kref = kernel_reference(ref, W, packed_ref)
    _cuda.check(kref.data, "kref.data", ref.dtype)
    sd1, off1 = window_starts(ref, pos1, pos1 != INVALID_LOC, W, dp_pad,
                              packed_ref, kref.pad)
    sd2, off2 = window_starts(ref, pos2, pos2 != INVALID_LOC, W, dp_pad,
                              packed_ref, kref.pad)

    # ---- single-mate-aware item compaction ------------------------------
    # Slot 2*r + m is (row r, mate m); a stable partition puts the
    # failed-mate items first, the kernel skips everything past n_items.
    need = torch.stack([need1, need2], -1).reshape(2 * N)
    order = torch.argsort((~need).to(torch.uint8), stable=True)
    n_items = need.sum().to(torch.int32).reshape(1)
    item_reads = torch.stack([reads1, reads2], 1).reshape(2 * N, R)[order]
    sd = torch.stack([sd1, sd2], -1).reshape(2 * N)[order]
    off = torch.stack([off1, off2], -1).reshape(2 * N)[order]

    full = band is None or band >= W
    cols = W + 1 if full else 2 * band + 1
    score_c, end_c, did = (torch.empty(2 * N, dtype=torch.int32,
                                       device=ref.device) for _ in range(3))
    RESIDUAL_DP(
        kref.data.data_ptr(), int(packed_ref), sd.data_ptr(), off.data_ptr(),
        n_items.data_ptr(), item_reads.data_ptr(), 2 * N, R, W,
        -1 if full else band, dp_threads(cols), scoring.match,
        scoring.mismatch, scoring.gap_open, scoring.gap_extend,
        score_c.data_ptr(), end_c.data_ptr(), did.data_ptr(),
        _cuda.stream_of(ref))

    # ---- scatter back through the inverse permutation -------------------
    inv = torch.argsort(order)
    score = torch.where(need, score_c[inv], NEG).reshape(N, 2)
    end = torch.where(need, end_c[inv], 0).reshape(N, 2)
    return ResidualDPResult(
        score1=score[:, 0], ref_end1=end[:, 0],
        score2=score[:, 1], ref_end2=end[:, 1],
        dp_lanes=did.sum())
