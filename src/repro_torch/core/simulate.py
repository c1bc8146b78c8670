"""Reference + paired-end read simulation (the role Mason plays in §7.7/7.8).

Host-side numpy.  Generates a random (or repeat-rich) reference, samples
FR read pairs with a normal insert-size distribution and injects per-base
substitution / insertion / deletion errors.  For a given seed the
generator draws the same random numbers in the same order as the JAX
package's simulator, so both produce identical pairs; the per-base loop
is replaced by copying error-free runs in bulk, which is what makes
65,536-pair batches cheap enough to simulate per run.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ReadSimConfig:
    read_len: int = 150
    insert_mean: float = 300.0
    insert_std: float = 30.0
    sub_rate: float = 0.001
    ins_rate: float = 0.0002
    del_rate: float = 0.0002
    edge_pad: int = 64  # keep fragments away from reference ends


@dataclasses.dataclass
class SimulatedPairs:
    reads1: np.ndarray       # (N, R) uint8, reference orientation
    reads2: np.ndarray       # (N, R) uint8, as sequenced (reverse strand)
    true_start1: np.ndarray  # (N,) int32 reference start of read 1
    true_start2: np.ndarray  # (N,) int32 reference start of read 2's window
    n_edits: np.ndarray      # (N, 2) int32 edit count injected per read


def revcomp_np(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis (numpy)."""
    return (3 - codes)[..., ::-1]


def random_reference(length: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def repetitive_reference(
    length: int, rng: np.random.Generator, *, repeat_frac: float = 0.5,
    motif_len: int = 400, n_motifs: int = 12,
) -> np.ndarray:
    """Reference with planted repeat families (human-genome-like): copies of
    `n_motifs` motifs, each ~0.5% diverged, make up `repeat_frac` of it."""
    motifs = [rng.integers(0, 4, size=motif_len, dtype=np.uint8)
              for _ in range(n_motifs)]
    out = np.empty(length, np.uint8)
    pos = 0
    while pos < length:
        if rng.random() < repeat_frac:
            m = motifs[rng.integers(0, n_motifs)].copy()
            k = max(1, int(0.005 * motif_len))
            idx = rng.integers(0, motif_len, size=k)
            m[idx] = (m[idx] + rng.integers(1, 4, size=k)) % 4
            chunk = m
        else:
            chunk = rng.integers(0, 4, size=motif_len, dtype=np.uint8)
        n = min(len(chunk), length - pos)
        out[pos:pos + n] = chunk[:n]
        pos += n
    return out


def simulate_long_reads(
    ref: np.ndarray,
    n: int,
    length: int,
    sub_rate: float = 0.01,
    rng: np.random.Generator | None = None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Substitution-only long reads in reference orientation.

    Returns ``(reads, true_starts)``: (n, length) uint8 reads and their
    (n,) int32 reference starts.  Substitutions at a PacBio-HiFi-like
    rate are enough for the long-read lane, whose vote and anchor DP need
    per-segment seed survival only.
    """
    rng = rng or np.random.default_rng(seed)
    starts = rng.integers(64, len(ref) - length - 64, size=n)
    reads = ref[starts[:, None] + np.arange(length)]
    errs = rng.random(reads.shape) < sub_rate
    reads[errs] = (reads[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    return reads.astype(np.uint8), starts.astype(np.int32)


def _inject_errors(ref, start, read_len, cfg: ReadSimConfig, rng):
    """Sequence `read_len` bases starting at `start` with errors.

    One uniform draw decides each step (insert a random base, skip a
    reference base, substitute, or copy); error-free copies between error
    draws are taken as one slice.  The draw buffer is refilled exactly
    where a step-by-step loop would refill it.  Returns (read, n_edits).
    """
    out = np.empty(read_len, np.uint8)
    err = cfg.ins_rate + cfg.del_rate + cfg.sub_rate
    i = 0          # bases emitted
    p = start      # reference cursor
    edits = 0
    u = rng.random(read_len * 2 + 8)
    ui = 0
    while i < read_len:
        # copy the error-free run up to the next error draw, the end of the
        # read, or the end of the draw buffer
        hits = np.flatnonzero(u[ui:] < err)
        nxt = ui + int(hits[0]) if len(hits) else len(u)
        n = min(nxt - ui, read_len - i)
        if n:
            out[i:i + n] = ref[p:p + n]
            i += n
            p += n
            ui += n
        else:
            r = u[ui]
            ui += 1
            if r < cfg.ins_rate:
                out[i] = rng.integers(0, 4)
                i += 1
            elif r < cfg.ins_rate + cfg.del_rate:
                p += 1
            else:
                out[i] = (ref[p] + rng.integers(1, 4)) % 4
                i += 1
                p += 1
            edits += 1
        if ui >= len(u):
            u = rng.random(read_len)
            ui = 0
    return out, edits


def simulate_pairs(
    ref: np.ndarray,
    n_pairs: int,
    cfg: ReadSimConfig = ReadSimConfig(),
    seed: int = 0,
) -> SimulatedPairs:
    rng = np.random.default_rng(seed)
    L = len(ref)
    R = cfg.read_len
    reads1 = np.empty((n_pairs, R), np.uint8)
    reads2 = np.empty((n_pairs, R), np.uint8)
    s1 = np.empty(n_pairs, np.int32)
    s2 = np.empty(n_pairs, np.int32)
    n_edits = np.zeros((n_pairs, 2), np.int32)
    lo = cfg.edge_pad
    hi = L - cfg.edge_pad
    for i in range(n_pairs):
        insert = max(R, int(rng.normal(cfg.insert_mean, cfg.insert_std)))
        start = int(rng.integers(lo, hi - insert - R))
        r1, e1 = _inject_errors(ref, start, R, cfg, rng)
        start2 = start + insert - R
        r2_fwd, e2 = _inject_errors(ref, start2, R, cfg, rng)
        reads1[i] = r1
        reads2[i] = revcomp_np(r2_fwd)  # sequenced from reverse strand
        s1[i] = start
        s2[i] = start2
        n_edits[i] = (e1, e2)
    return SimulatedPairs(
        reads1=reads1, reads2=reads2, true_start1=s1, true_start2=s2,
        n_edits=n_edits,
    )
