"""Public wrapper of the fused candidate light-alignment op (step 4).

On CUDA tensors `candidate_pair_align` prepares the kernel's window
coordinates (`kernels/_util.window_starts`: edge-padded uint8 bases, or
back-padded packed words with a word/offset split), launches the
`candidate_align` kernel — which never materializes the (B, C, R+2E)
window tensor — and turns the winner's edit fields into CIGAR runs.  On
CPU tensors (or with ``backend="torch"``) it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.light_align import cigar_ops
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
from repro_torch.kernels.candidate_align.ref import (
    PairAlignResult,
    candidate_pair_align_ref,
)

CANDIDATE_ALIGN = _cuda.register(
    "candidate_align", "candidate_align_launch",
    (PTR, INT, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR) + (INT,) * 11
    + (PTR, PTR))

# the reduction key (score1 + score2) * C - j stays inside int32
MAX_CANDIDATES = 512


def candidate_pair_align(
    ref: torch.Tensor,       # (L,) uint8 bases, or (Lw,) int32 packed words
    reads1: torch.Tensor,    # (B, R) uint8 mate 1, reference orientation
    reads2: torch.Tensor,    # (B, R) uint8 mate 2, reference orientation
    pos1: torch.Tensor,      # (B, C) int32 candidate starts, INVALID_LOC padded
    pos2: torch.Tensor,      # (B, C)
    max_gap: int,
    scoring: Scoring = Scoring(),
    threshold: int | None = None,
    mode: str = "minsplit",
    prescreen_top: int = 0,
    packed_ref: bool = False,
    backend: str = "auto",
    kref: KernelRef | None = None,
) -> PairAlignResult:
    """Best-candidate Light Alignment for a batch of read pairs.

    ``kref``: ``ref`` already padded for windows of at least R+2E bases
    (`kernels/_util.kernel_reference`); built here when None."""
    backend = resolve_backend(backend, ref.device, family="candidate_align")
    if mode not in ("minsplit", "paper"):
        raise ValueError(f"unknown mode {mode!r}")
    if backend == "torch":
        return candidate_pair_align_ref(
            ref, reads1, reads2, pos1, pos2, max_gap, scoring, threshold,
            mode, prescreen_top, packed_ref)

    B, R = reads1.shape
    C = pos1.shape[1]
    E = max_gap
    W = R + 2 * E
    if threshold is None:
        threshold = scoring.default_threshold(R)
    if C > MAX_CANDIDATES or R < E + 2:
        raise ValueError(f"candidate_align needs C <= {MAX_CANDIDATES} and "
                         f"R >= E + 2 (C={C}, R={R}, E={E})")
    _cuda.check(ref, "ref", torch.int32 if packed_ref else torch.uint8)
    _cuda.check(reads1, "reads1", torch.uint8)
    _cuda.check(reads2, "reads2", torch.uint8, (B, R))
    _cuda.check(pos1, "pos1", torch.int32, (B, C))
    _cuda.check(pos2, "pos2", torch.int32, (B, C))

    valid1 = pos1 != INVALID_LOC
    valid2 = pos2 != INVALID_LOC
    if kref is None:
        kref = kernel_reference(ref, W, packed_ref)
    _cuda.check(kref.data, "kref.data", ref.dtype)
    sdma1, off1 = window_starts(ref, pos1, valid1, W, E, packed_ref, kref.pad)
    sdma2, off2 = window_starts(ref, pos2, valid2, W, E, packed_ref, kref.pad)
    v1 = valid1.to(torch.int32)
    v2 = valid2.to(torch.int32)
    out = torch.empty((12, B), dtype=torch.int32, device=ref.device)
    CANDIDATE_ALIGN(
        kref.data.data_ptr(), int(packed_ref), reads1.data_ptr(),
        reads2.data_ptr(), sdma1.data_ptr(), sdma2.data_ptr(),
        off1.data_ptr(), off2.data_ptr(), v1.data_ptr(), v2.data_ptr(),
        B, R, C, E, prescreen_top, int(mode == "paper"), scoring.match,
        scoring.mismatch, scoring.gap_open, scoring.gap_extend, threshold,
        out.data_ptr(), _cuda.stream_of(ref))
    (slot, rank, sc1, sc2, ok1, ok2,
     et1, el1, ep1, et2, el2, ep2) = out.unbind(0)
    idx = slot.to(torch.int64)[:, None]
    return PairAlignResult(
        best=rank, slot=slot,
        pos1=torch.gather(pos1, 1, idx)[:, 0],
        pos2=torch.gather(pos2, 1, idx)[:, 0],
        score1=sc1, score2=sc2, ok1=ok1.bool(), ok2=ok2.bool(),
        cigar1=cigar_ops(et1, el1, ep1, R),
        cigar2=cigar_ops(et2, el2, ep2, R),
    )
