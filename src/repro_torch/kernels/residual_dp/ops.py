"""Public wrapper of the fused residual-DP fallback op (step 5).

On CUDA tensors one `residual_dp` launch covers the ``2*N`` (row, mate)
slots: one warp per slot, so a slot whose ``need`` flag is clear costs a
warp that writes ``NEG`` / 0 and exits, and no compaction, gather or
scatter runs around the kernel.  The kernel computes each window's start
itself (`kernels/_util.window_starts`'s clamp).  No host sync decides the
launch.  On CPU tensors (or with ``backend="torch"``) it runs the plain
version.  ``block`` is the kernel's warps (slots) a block
(`residual_warps`): None for the default, a value the kernel cannot take
raises on either backend; the result does not depend on it.
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

# The work that depends on the data, where a caller has none (a dry run):
# the mates a buffer row re-aligns, on chip_smoke.py's pair-lane batch
# (17,943 items in the 16,384-row buffer of 65,536 pairs at sub_rate
# 0.01).
ITEMS_PER_ROW = 17_943 / 16_384


def residual_dp_cost(N: int, R: int, W: int, band: int | None,
                     packed: bool, n_items=None) -> _cuda.Work:
    """Each needed mate's read and W-base window read, every row's
    positions, flags and results; each needed mate's R rows of
    2*band+1 cells (W+1 unbanded) at ~14 operations a cell.
    ``n_items``: the needed mates, or None for `ITEMS_PER_ROW` a row."""
    full = band is None or band >= W
    cols = W + 1 if full else 2 * band + 1
    items = N * ITEMS_PER_ROW if n_items is None else n_items
    win_bytes = (W // 16 + 2) * 4 if packed else W
    return _cuda.Work(items * (R + win_bytes) + N * (2 * 4 + 2 + 4 * 4),
                      items * R * cols * 14)


RESIDUAL_DP = _cuda.register(
    "residual_dp", "residual_dp_launch",
    (PTR, INT) + (PTR,) * 6 + (INT,) * 13 + (PTR, PTR, INT, PTR),
    residual_dp_cost)

MAX_SHARED = 48 * 1024
#: the default warps a block, and the most the kernel's __launch_bounds__
#: admit (wider bounds would change its register allocation)
MAX_WARPS = 8


def warp_stage_bytes(R: int, W: int, band: int | None, cpl: int) -> int:
    """Bytes of a warp's staged window (csrc/gotoh.cuh::gotoh_warp_stage:
    W bases between the pads the frame reads past them)."""
    c = (W - R) // 2
    if band is None or band >= W:
        lo, hi = -1, 32 * cpl - 2
    else:
        lo = max(c + 1, 0) - band - 1
        hi = (W + 1 if c + 1 < 0 else min(R + c, W + 1)) - band \
            + 32 * cpl - 2
    left = -lo if lo < 0 else 0
    return (left + max(hi + 1, W) + 3) & ~3


def residual_warps(R: int, W: int, band: int | None,
                   block: int | None = None) -> tuple[int, int]:
    """``(warps a block, cpl)`` of a residual_dp launch.

    A warp stages its read and window in shared memory, and the kernel's
    ``__launch_bounds__`` admit `MAX_WARPS` (csrc/residual_dp.cu).  None
    gives the default, `MAX_WARPS`; an explicit ``block`` past it or past
    48 KB raises, nothing is clamped."""
    full = band is None or band >= W
    cpl = lane_slots(W + 1 if full else 2 * band + 1)
    if block is None:
        return MAX_WARPS, cpl
    per_warp = ((R + 3) & ~3) + warp_stage_bytes(R, W, band, cpl)
    top = min(MAX_WARPS, MAX_SHARED // per_warp)
    if not 1 <= block <= top:
        raise ValueError(f"residual_dp takes 1..{top} warps a block at R "
                         f"{R}, W {W}, band {band}, got {block}")
    return block, cpl


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
    block: int | None = None,
) -> ResidualDPResult:
    """Banded DP fallback for a compacted batch of residual pairs.

    ``kref``: ``ref`` already padded for windows of at least R+2*dp_pad
    bases (`kernels/_util.kernel_reference`); built here when None."""
    backend = resolve_backend(backend, ref.device, family="residual_dp")
    need1 = need1.bool()
    need2 = need2.bool()
    R = reads1.shape[1]
    if block is not None:
        residual_warps(R, R + 2 * dp_pad, band, block)
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
    warps, cpl = residual_warps(R, W, band, block)
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
        kref.data, int(packed_ref), reads1, reads2, pos1, pos2, need1,
        need2, N, R, W, -1 if full else band, dp_pad, ref.shape[0], win_hi,
        kref.pad, cpl, scoring.match, scoring.mismatch, scoring.gap_open,
        scoring.gap_extend, score, end, warps, stream=ref,
        work=(N, R, W, band, packed_ref))
    return ResidualDPResult(
        score1=score[:, 0], ref_end1=end[:, 0],
        score2=score[:, 1], ref_end2=end[:, 1],
        dp_lanes=need1.sum() + need2.sum())
