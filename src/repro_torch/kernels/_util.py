"""Shared prep for the window-gathering kernels (candidate_align and
residual_dp): both read a contiguous window of a padded reference, so
their starts are clamped by one shared rule per reference flavor
(`window_starts`; the candidate_align kernel applies it itself).  Also
the stride of candidate_align's staged Light Alignment rows, and the
frame slots per lane of the warp DP kernels (residual_dp and banded_sw).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.encoding import BASES_PER_WORD, packed_gather_coords


class KernelRef(NamedTuple):
    """A reference padded for the window kernels (`kernel_reference`)."""

    data: torch.Tensor  # padded bases (uint8) or packed words (int32)
    pad: int            # the widest window it serves


def kernel_reference(ref: torch.Tensor, width: int, packed: bool
                     ) -> KernelRef:
    """``ref`` padded for every window up to ``width`` bases wide.

    Packed: the (Lw,) words plus n_words copies of the last word, so a
    window read past word Lw-1 sees what the oracle's index clamp gives.
    Unpacked: ``width`` copies of ref[0] in front of the (L,) bases and
    ``width - 1`` copies of ref[L-1] behind them.  A session builds it once
    for its widest window; a wrapper called without one builds its own.
    """
    if packed:
        n_words, _ = packed_gather_coords(ref.shape[0], width)
        return KernelRef(torch.cat([ref, ref[-1:].expand(n_words)]), width)
    return KernelRef(torch.cat([ref[:1].expand(width), ref,
                                ref[-1:].expand(width - 1)]), width)


def window_starts(ref: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor,
                  width: int, lead: int, packed: bool, pad: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel window coordinates ``(start, off)`` (int32) of ``width``-base
    windows beginning ``lead`` bases before ``pos``, addressing the
    `kernel_reference` of ``ref`` padded for ``pad >= width``.

    Packed: the same scalar clamp as `gather_windows_packed`, split into a
    word index and an intra-word base offset.  Unpacked:
    `clamp_window_starts` shifted into the edge-padded bases (offset 0).
    Invalid slots read the window at 0.
    """
    if pad < width:
        raise ValueError(f"a reference padded for {pad}-base windows cannot "
                         f"serve {width}-base windows")
    if packed:
        _, hi = packed_gather_coords(ref.shape[0], width)
        s = torch.where(valid, pos - lead, 0).clamp(0, hi)
        return ((s // BASES_PER_WORD).to(torch.int32),
                (s % BASES_PER_WORD).to(torch.int32))
    s = clamp_window_starts(pos, valid, ref.shape[0], width, lead)
    return (s + (pad - lead)).to(torch.int32), torch.zeros_like(s)


def clamp_window_starts(pos: torch.Tensor, valid: torch.Tensor, ref_len: int,
                        width: int, lead: int) -> torch.Tensor:
    """Saturating clamp of candidate window starts.

    ``pos`` are starts whose ``width``-wide window begins ``lead`` bases
    earlier; ``valid`` masks INVALID_LOC slots to 0.  The result is clamped
    to ``[lead - width, ref_len - 1 + lead]`` — exactly the range where
    `gather_ref_windows`' per-element index clamp saturates the whole
    window to all-``ref[0]`` / all-``ref[ref_len-1]`` anyway — so a
    contiguous read of a ``width``-lead edge-padded reference starting at
    ``result + (width - lead)`` reproduces the oracle's window for every
    int32 start, including negative starts near the reference origin.
    """
    return torch.where(valid, pos, 0).clamp(lead - width,
                                            ref_len - 1 + lead).to(torch.int32)


def staged_stride(n: int) -> int:
    """Bytes of one row staged in shared memory by candidate_align (a
    thread's or a lane group's row): whole 4-byte words, an odd number of
    them (a warp's rows then start in different banks)."""
    return 4 * (((n + 3) // 4) | 1)


#: frame slots per lane the warp DP kernels are built for
#: (csrc/residual_dp.cu, csrc/banded_sw.cu)
LANE_SLOTS = (1, 2, 3, 4, 6, 8, 16, 32)


def lane_slots(cols: int) -> int:
    """Frame slots each of a warp's 32 lanes owns for a ``cols``-column
    DP row: the least built value with 32 of them covering the row."""
    for cpl in LANE_SLOTS:
        if 32 * cpl >= cols:
            return cpl
    raise ValueError(f"a {cols}-column DP row exceeds the warp kernel's "
                     f"{32 * LANE_SLOTS[-1]} columns")
