"""Public wrapper of the standalone Light Alignment op (a building block).

On CUDA tensors `light_align` launches the `light_align` kernel, which
runs the lane-split unit of csrc/light_align.cuh (L lanes a row, the
unit `candidate_align` runs on its staged items) on gathered windows; on
CPU tensors (or with ``backend="torch"``) it runs the
plain version.  Reads and windows are compared as values, as repro
compares them in int32: the kernel takes uint8 bases, so an int32 input is
narrowed only when every value lies in [0, 255], and refused otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.core.light_align import LightAlignResult
from repro_torch.core.scoring import Scoring
from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import INT, PTR
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.light_align.ref import light_align_ref

def light_align_cost(B: int, R: int, E: int) -> _cuda.Work:
    """Each read and R+2E window read once, five ints a read written; counted
    at four bases a 32-bit word: 2E+1 mismatch masks (a shift's four flags
    take ~10 operations: 2.5 a base) and 2E gap walks (a nibble of four
    positions through the table, ~7: 1.75 a base)."""
    return _cuda.Work(B * (R + R + 2 * E) + B * 5 * 4,
                      B * R * ((2 * E + 1) * 2.5 + 2 * E * 1.75))


LIGHT_ALIGN = _cuda.register(
    "light_align", "light_align_launch", (PTR, PTR) + (INT,) * 8 + (PTR, PTR),
    light_align_cost)

# positions a warp holds: 32 lanes of at most 32 (the lanes' bitmasks)
MAX_READ = 1024


def _bases(x: torch.Tensor, name: str) -> torch.Tensor:
    """uint8 bases of a uint8 or int32 tensor, without truncating."""
    if x.dtype == torch.uint8:
        return x.contiguous()
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be uint8 or int32, got {x.dtype}")
    if x.numel() and not bool(((x >= 0) & (x <= 255)).all()):
        raise ValueError(f"{name} holds int32 values outside [0, 255], "
                         f"which the uint8 kernel cannot compare")
    return x.to(torch.uint8).contiguous()


def light_align(read: torch.Tensor, refwin: torch.Tensor, max_gap: int,
                scoring: Scoring = Scoring(), threshold: int | None = None,
                mode: str = "minsplit",
                backend: str = "auto") -> LightAlignResult:
    """Batched Light Alignment of (B, R) reads against (B, R + 2E)
    windows; ``ok = score >= threshold``."""
    backend = resolve_backend(backend, read.device, family="light_align")
    if mode not in ("minsplit", "paper"):
        raise ValueError(f"unknown mode {mode!r}")
    if backend == "torch":
        return light_align_ref(read, refwin, max_gap, scoring, threshold,
                               mode)
    B, R = read.shape
    E = max_gap
    W = R + 2 * E
    if R < E + 2:
        raise ValueError(f"light_align needs R >= E + 2 (R={R}, E={E})")
    if R > MAX_READ:
        raise ValueError(f"a {R}-base read exceeds the {MAX_READ} positions "
                         f"one warp of the kernel holds")
    if threshold is None:
        threshold = scoring.default_threshold(R)
    reads = _bases(read, "read")
    wins = _bases(refwin, "refwin")
    _cuda.check(reads, "read", torch.uint8)
    _cuda.check(wins, "refwin", torch.uint8, (B, W))
    out = torch.empty((5, B), dtype=torch.int32, device=read.device)
    LIGHT_ALIGN(reads, wins, B, R, E, int(mode == "paper"), scoring.match,
                scoring.mismatch, scoring.gap_open, scoring.gap_extend, out,
                stream=read, work=(B, R, E))
    score, etype, elen, epos, mm = out.unbind(0)
    return LightAlignResult(score=score, ok=score >= threshold,
                            edit_type=etype, edit_len=elen, edit_pos=epos,
                            n_mismatch=mm)
