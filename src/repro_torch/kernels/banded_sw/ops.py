"""Public wrapper of the banded Gotoh DP (the long-read anchor DP).

On CUDA tensors `banded_sw` launches the `banded_sw` kernel library entry,
which picks one of two hand-written kernels by the row's width (not on
failure): rows of up to 1,024 columns run csrc/gotoh.cuh's warp
recurrence, one warp per read (as `residual_dp` does), and wider rows its
one-thread recurrence, up to 6,144 columns.  On CPU tensors (or with
``backend="torch"``) it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.dp_fallback import DPResult
from repro_torch.core.scoring import Scoring
from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import INT, PTR
from repro_torch.kernels._util import LANE_SLOTS, lane_slots
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.banded_sw.ref import gotoh_banded_ref

def banded_sw_cost(B: int, R: int, W: int, band: int | None) -> _cuda.Work:
    """Each read and window read once, two ints a read written; R rows of
    2*band+1 cells (W+1 unbanded) a read at ~14 operations a cell."""
    cols = W + 1 if band is None or band >= W else 2 * band + 1
    return _cuda.Work(B * (R + W) + 8 * B, B * R * cols * 14)


BANDED_SW = _cuda.register(
    "banded_sw", "banded_sw_launch", (PTR, PTR) + (INT,) * 10 + (PTR,) * 3,
    banded_sw_cost)

MAX_SHARED = 48 * 1024


def dp_threads(cols: int) -> int:
    """Threads per block of the one-thread kernel so each thread's H and E
    rows (2*cols int32) fit 48 KB of shared memory; whole warps where
    possible."""
    t = min(128, MAX_SHARED // (8 * cols))
    if t < 1:
        raise ValueError(f"a {cols}-column DP row exceeds shared memory")
    return t - t % 32 if t >= 32 else t


def banded_sw(read: torch.Tensor, win: torch.Tensor,
              scoring: Scoring = Scoring(), band: int | None = None,
              backend: str = "auto") -> DPResult:
    """Batched semiglobal Gotoh of (B, R) uint8 reads against (B, W) uint8
    windows.  ``band`` restricts the DP to cells within ``band`` of the
    window's centre diagonal (`core.dp_fallback.band_center`); ``None``
    or ``band >= W`` is the exact full DP.

    On the card a row of ``cols`` columns (``2*band + 1``, or ``W + 1``)
    up to 1,024 runs the warp kernel at `lane_slots` ``(cols)`` frame
    slots per lane (one whose staged read and window pass 48 KB, R + W
    beyond ~48,000 bases, runs the one-thread kernel); a wider row runs
    the one-thread kernel, and one past 6,144 columns is refused."""
    backend = resolve_backend(backend, read.device, family="banded_sw")
    if backend == "torch":
        return gotoh_banded_ref(read, win, band, scoring)
    B, R = read.shape
    W = win.shape[1]
    _cuda.check(read, "read", torch.uint8)
    _cuda.check(win, "win", torch.uint8, (B, W))
    if band is not None and band < 0:
        raise ValueError(f"band must be >= 0 or None, got {band}")
    full = band is None or band >= W
    cols = W + 1 if full else 2 * band + 1
    cpl = lane_slots(cols) if cols <= 32 * LANE_SLOTS[-1] else 0
    threads = dp_threads(cols)
    score, end = (torch.empty(B, dtype=torch.int32, device=read.device)
                  for _ in range(2))
    BANDED_SW(read, win, B, R, W, -1 if full else band, cpl, threads,
              scoring.match, scoring.mismatch, scoring.gap_open,
              scoring.gap_extend, score, end, stream=read,
              work=(B, R, W, band))
    return DPResult(score=score, ref_end=end)
