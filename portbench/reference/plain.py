"""The plain reference of the pair lane: GenPair's steps 1-5 in PyTorch.

A frozen copy of the plain paths the program under test is held against
(partitioned seeding, xxHash32 bucket ids, the CSR SeedMap and its
query, the Paired-Adjacency filter, minsplit Light Alignment, the
fixed-capacity residual buffer and the banded semiglobal Gotoh DP),
written out again so that a later change to the program cannot move
what ``correct`` compares against.  It imports nothing of the program.

Bases are uint8 codes A=0, C=1, G=2, T=3.  Every integer path is exact,
so the program's kernels must agree bit for bit.  The reference builds
its own CSR SeedMap from the reference bases (the program's index is the
program's), and aligns in blocks of rows so that it fits beside the
stream's results on one card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF
PRIME1, PRIME2, PRIME3 = 2654435761, 2246822519, 3266489917
INVALID_LOC = 2**31 - 1
INT32_MAX = 2**31 - 1
NEG = -(1 << 20)          # DP / unmapped score sentinel
NEG_BIG = -(1 << 20)      # masked-candidate score sentinel
BIG = 1 << 20             # "infinite" mismatch count in Light Alignment
HASH_CHUNK = 1 << 23      # seed positions hashed per chunk of the build
EDIT_NONE, EDIT_INS, EDIT_DEL = 0, 1, 2
CIG_M, CIG_I, CIG_D = 0, 1, 2
M_UNMAPPED, M_LIGHT, M_DP, M_RESIDUAL_FULL, M_DP_OVERFLOW = 0, 1, 2, 3, 4

#: the pair lane's stage totals, in the order the program accumulates them
STAT_KEYS = ("no_seed_hit", "adjacency_fail", "light_align_fail",
             "light_mapped", "dp_mapped", "dp_overflow", "residual_full_dp",
             "dp_mate_alignments", "n_pairs")

#: the fields of one batch's result, in the program's order
RESULT_FIELDS = ("pos1", "pos2", "score1", "score2", "method", "cigar1",
                 "cigar2", "had_hits", "passed_adjacency", "light_ok",
                 "dp_mate1", "dp_mate2", "n_valid")


@dataclasses.dataclass(frozen=True)
class Params:
    """What a configuration file states of the index and the pipeline."""

    read_len: int = 150
    seed_len: int = 50
    seeds_per_read: int = 3
    table_bits: int = 26
    max_locations: int = 500
    hash_seed: int = 0
    padded_cap: int = 32            # K: locations a seed
    delta: int = 500                # the Paired-Adjacency threshold
    max_candidates: int = 8         # C
    max_gap: int = 8                # E
    dp_pad: int = 16
    residual_capacity_frac: float = 0.25
    light_mode: str = "minsplit"
    match: int = 2
    mismatch: int = 8
    gap_open: int = 12
    gap_extend: int = 2

    @property
    def table_size(self) -> int:
        return 1 << self.table_bits

    @property
    def band(self) -> int:
        return self.dp_pad + self.max_gap

    @property
    def threshold(self) -> int:
        return self.match * self.read_len - 24

    def gap_cost(self, k):
        return self.gap_open + self.gap_extend * k

    def residual_cap(self, batch: int) -> int:
        if self.residual_capacity_frac <= 0:
            return 0
        return max(1, int(round(batch * self.residual_capacity_frac)))


class CSR(NamedTuple):
    offsets: torch.Tensor    # int32[T + 1]
    locations: torch.Tensor  # int32[N], grouped by bucket, ascending


# ------------------------------------------------------------- hashing ----
def _mul32(x, p: int):
    lo = x * (p & 0xFFFF)
    hi = ((x * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def _round(acc, lane):
    return _mul32(_rotl((acc + _mul32(lane, PRIME2)) & MASK32, 13), PRIME1)


def xxhash32(words: torch.Tensor, seed: int) -> torch.Tensor:
    """xxHash32 of 16-byte messages given as (..., 4) int64 words in
    [0, 2^32) -> (...,) int64 hashes."""
    w = words & MASK32
    s = seed & MASK32
    v1 = _round((s + PRIME1 + PRIME2) & MASK32, w[..., 0])
    v2 = _round((s + PRIME2) & MASK32, w[..., 1])
    v3 = _round(s, w[..., 2])
    v4 = _round((s - PRIME1) & MASK32, w[..., 3])
    acc = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
           + 16) & MASK32
    acc = acc ^ (acc >> 15)
    acc = _mul32(acc, PRIME2)
    acc = acc ^ (acc >> 13)
    acc = _mul32(acc, PRIME3)
    return acc ^ (acc >> 16)


def pack_words(codes: torch.Tensor, n_words: int) -> torch.Tensor:
    """(..., L) uint8 bases -> (..., n_words) int64 words, base i of a word
    in bits [2i, 2i+2), zero-padded."""
    L = codes.shape[-1]
    pad = n_words * 16 - L
    if pad:
        codes = torch.cat([codes, codes.new_zeros(codes.shape[:-1] + (pad,))],
                          -1)
    w = codes.reshape(codes.shape[:-1] + (n_words, 16)).to(torch.int64)
    return (w << (2 * torch.arange(16, device=codes.device))).sum(-1)


# ------------------------------------------------------------- SeedMap ----
def build_csr(ref: torch.Tensor, p: Params) -> CSR:
    """Hash every seed position of ``ref`` (uint8, on its device), group the
    positions by bucket (stable), drop buckets over ``max_locations``."""
    L = ref.shape[0]
    n_pos = L - p.seed_len + 1
    r = ref.to(torch.int64)
    T = p.table_size
    buckets = torch.empty(n_pos, dtype=torch.int32, device=ref.device)
    for lo in range(0, n_pos, HASH_CHUNK):
        hi = min(lo + HASH_CHUNK, n_pos)
        words = torch.zeros((hi - lo, 4), dtype=torch.int64,
                            device=ref.device)
        for i in range(p.seed_len):
            words[:, i // 16] |= r[lo + i:hi + i] << (2 * (i % 16))
        h = xxhash32(words, p.hash_seed)
        buckets[lo:hi] = (h & (T - 1)).to(torch.int32)
        del words, h
    del r
    sorted_buckets, order = torch.sort(buckets, stable=True)
    del buckets
    locations = order.to(torch.int32)
    del order
    counts = torch.bincount(sorted_buckets, minlength=T)
    dropped = counts > p.max_locations
    if bool(dropped.any()):
        locations = locations[~dropped[sorted_buckets.to(torch.int64)]]
        counts = torch.where(dropped, 0, counts)
    del sorted_buckets
    offsets = torch.zeros(T + 1, dtype=torch.int32, device=ref.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return CSR(offsets, locations)


def seed_offsets(p: Params) -> list[int]:
    """First / middle / last seed placements, rounded half to even."""
    S = p.seeds_per_read
    if S == 1:
        return [0]
    span = p.read_len - p.seed_len
    return [int(round(k * span / (S - 1))) for k in range(S)]


class Front(NamedTuple):
    pos1: torch.Tensor     # (B, C) candidate starts, INVALID_LOC padded
    pos2: torch.Tensor
    n: torch.Tensor        # (B,) candidates kept (<= C)
    n_hits1: torch.Tensor  # (B,) valid SeedMap hits of each mate
    n_hits2: torch.Tensor


def _query(sm: CSR, reads: torch.Tensor, p: Params):
    """Seed, hash and query one mate: (B, S*K) sorted read starts and the
    (B,) valid hit count."""
    dev = reads.device
    offs = seed_offsets(p)
    idx = (torch.tensor(offs, device=dev)[:, None]
           + torch.arange(p.seed_len, device=dev))
    seeds = reads[:, idx]                                  # (B, S, seed_len)
    h = xxhash32(pack_words(seeds, 4), p.hash_seed)
    bucket = h & (p.table_size - 1)
    K = p.padded_cap
    start = sm.offsets[bucket].to(torch.int64)
    count = torch.clamp(sm.offsets[bucket + 1].to(torch.int64) - start,
                        max=K)
    ar = torch.arange(K, device=dev)
    valid = ar < count[..., None]
    n_loc = sm.locations.shape[0]
    locs = sm.locations[(start[..., None] + ar).clamp(0, max(n_loc - 1, 0))]
    locs = torch.where(valid, locs, INVALID_LOC)
    starts = torch.where(
        valid, locs - torch.tensor(offs, dtype=torch.int32,
                                   device=dev)[None, :, None], INVALID_LOC)
    flat = torch.sort(starts.reshape(starts.shape[0], -1), dim=-1).values
    return flat, valid.reshape(valid.shape[0], -1).sum(-1).to(torch.int32)


def _adjacency(starts1, starts2, delta: int, cap: int):
    """The Δ filter over sorted (B, M) start lists: (pos1, pos2, n)."""
    B, M = starts1.shape
    valid1 = starts1 != INVALID_LOC
    lo = torch.searchsorted(starts2, starts1 - delta, side="left")
    ar = torch.arange(M, device=starts1.device)
    occ = ar - torch.searchsorted(starts1, starts1, side="left")
    s2 = torch.gather(starts2, 1, (lo + occ).clamp(0, M - 1))
    within = (s2 != INVALID_LOC) & (torch.abs(s2 - starts1) <= delta) & valid1
    first = torch.ones_like(within)
    first[:, 1:] = (starts1[:, 1:] != starts1[:, :-1]) | (s2[:, 1:]
                                                         != s2[:, :-1])
    keep = within & first
    take = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :cap]
    ok = torch.gather(keep, 1, take)
    pos1 = torch.where(ok, torch.gather(starts1, 1, take), INVALID_LOC)
    pos2 = torch.where(ok, torch.gather(s2, 1, take), INVALID_LOC)
    if cap > M:
        pad = torch.full((B, cap - M), INVALID_LOC, dtype=torch.int32,
                         device=starts1.device)
        pos1, pos2 = torch.cat([pos1, pad], 1), torch.cat([pos2, pad], 1)
    return pos1, pos2, keep.sum(1).clamp(max=cap).to(torch.int32)


def front_end(sm: CSR, reads1, reads2_fwd, p: Params) -> Front:
    """Steps 1-3 for both mates (reference orientation)."""
    s1, h1 = _query(sm, reads1, p)
    s2, h2 = _query(sm, reads2_fwd, p)
    pos1, pos2, n = _adjacency(s1, s2, p.delta, p.max_candidates)
    return Front(pos1, pos2, n, h1, h2)


# ------------------------------------------------------------- windows ----
def padded_bases(ref: torch.Tensor) -> torch.Tensor:
    """The reference as a 2-bit packing holds it: zero ('A') bases up to a
    whole 16-base word, plus one base past it for the window ends."""
    pad = -ref.shape[0] % 16
    return torch.cat([ref, ref.new_zeros(pad + 16)])


def windows(refp: torch.Tensor, n_ref: int, pos, valid, read_len: int,
            lead: int) -> torch.Tensor:
    """(..., R + 2 lead) windows of the packed reference's gather: the start
    ``pos - lead`` (0 for an invalid slot) clamped as a scalar to
    ``[0, words * 16 - width - 1]``."""
    width = read_len + 2 * lead
    n_words = (n_ref + 15) // 16
    hi = min(n_words * 16 - width - 1, INT32_MAX)
    s = torch.where(valid, pos - lead, 0).to(torch.int64).clamp(0, hi)
    idx = s[..., None] + torch.arange(width, device=refp.device)
    return refp[idx]


# ----------------------------------------------------- Light Alignment ----
class Light(NamedTuple):
    score: torch.Tensor
    ok: torch.Tensor
    edit_type: torch.Tensor
    edit_len: torch.Tensor
    edit_pos: torch.Tensor


def light_align(read: torch.Tensor, refwin: torch.Tensor, p: Params) -> Light:
    """Minsplit Light Alignment of (N, R) reads against (N, R + 2E)
    windows: the best of the mismatch-only hypothesis and, for each gap of
    k <= E bases, the split point with the fewest mismatches."""
    N, R = read.shape
    E = p.max_gap
    dev = read.device
    masks = (refwin.unfold(-1, R, 1) != read[:, None, :]).to(torch.int32)
    cum = torch.zeros((N, 2 * E + 1, R + 1), dtype=torch.int32, device=dev)
    cum[..., 1:] = torch.cumsum(masks, dim=-1)
    del masks
    cum0 = cum[:, E, :]
    m2 = p.match + p.mismatch
    p_range = torch.arange(R + 1, device=dev)
    mm_none = cum0[:, R]
    scores = [p.match * R - m2 * mm_none]
    types = [torch.full_like(mm_none, EDIT_NONE)]
    lens = [torch.zeros_like(mm_none)]
    poss = [torch.zeros_like(mm_none)]

    def best_split(cand, interior):
        cand = torch.where(interior[None, :], cand, BIG)
        at = torch.argmin(cand, dim=-1)
        return at.to(torch.int32), torch.gather(cand, 1, at[:, None])[:, 0]

    for k in range(1, E + 1):
        cum_d = cum[:, E + k, :]
        p_d, mm_d = best_split(cum0 + (cum_d[:, R:R + 1] - cum_d),
                               (p_range >= 1) & (p_range <= R - 1))
        sc = p.match * R - m2 * mm_d - p.gap_cost(k)
        scores.append(torch.where(mm_d >= BIG, -BIG, sc))
        types.append(torch.full_like(mm_d, EDIT_DEL))
        lens.append(torch.full_like(mm_d, k))
        poss.append(p_d)
        cum_i = cum[:, E - k, :]
        shifted = torch.zeros_like(cum_i)
        shifted[:, :R + 1 - k] = cum_i[:, k:]
        p_i, mm_i = best_split(cum0 + (cum_i[:, R:R + 1] - shifted),
                               (p_range >= 1) & (p_range <= R - k - 1))
        sc = p.match * (R - k) - m2 * mm_i - p.gap_cost(k)
        scores.append(torch.where(mm_i >= BIG, -BIG, sc))
        types.append(torch.full_like(mm_i, EDIT_INS))
        lens.append(torch.full_like(mm_i, k))
        poss.append(p_i)
    best = torch.argmax(torch.stack(scores, -1), dim=-1, keepdim=True)

    def pick(xs):
        return torch.gather(torch.stack(xs, -1), 1, best)[:, 0].to(
            torch.int32)

    score = pick(scores)
    return Light(score, score >= p.threshold, pick(types), pick(lens),
                 pick(poss))


def cigar(res: Light, R: int) -> torch.Tensor:
    """(N, 3, 2) int32 (op, length) runs of a Light Alignment."""
    is_none = res.edit_type == EDIT_NONE
    is_ins = res.edit_type == EDIT_INS
    at, k = res.edit_pos, res.edit_len
    len0 = torch.where(is_none, R, at)
    op1 = torch.where(is_ins, CIG_I, CIG_D)
    len1 = torch.where(is_none, 0, k)
    len2 = torch.where(is_none, 0, torch.where(is_ins, R - at - k, R - at))
    m = torch.full_like(at, CIG_M)
    return torch.stack([torch.stack([m, len0], -1),
                        torch.stack([op1, len1], -1),
                        torch.stack([m, len2], -1)], 1).to(torch.int32)


class Pair(NamedTuple):
    pos1: torch.Tensor
    pos2: torch.Tensor
    score1: torch.Tensor
    score2: torch.Tensor
    ok1: torch.Tensor
    ok2: torch.Tensor
    cigar1: torch.Tensor
    cigar2: torch.Tensor


def _take(x, idx):
    view = idx.to(torch.int64).reshape((-1, 1) + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, view, dim=1)[:, 0]


def candidate_align(refp, n_ref: int, reads1, reads2, pos1, pos2,
                    p: Params) -> Pair:
    """Step 4: every valid candidate of both mates light-aligned, the
    first pair of the highest summed score kept."""
    B, R = reads1.shape
    C = pos1.shape[1]
    E = p.max_gap
    valid1, valid2 = pos1 != INVALID_LOC, pos2 != INVALID_LOC

    def run(reads, pos, valid):
        win = windows(refp, n_ref, pos, valid, R, E)
        res = light_align(reads[:, None].expand(B, C, R).reshape(B * C, R),
                          win.reshape(B * C, -1), p)
        sc = torch.where(valid.reshape(-1), res.score, NEG_BIG).reshape(B, C)
        return res, sc

    res1, sc1 = run(reads1, pos1, valid1)
    res2, sc2 = run(reads2, pos2, valid2)
    best = torch.argmax(sc1 + sc2, dim=-1).to(torch.int32)

    def field(res):
        return Light(*(_take(x.reshape(B, C), best) for x in res))

    b1, b2 = field(res1), field(res2)
    bp1, bp2 = _take(pos1, best), _take(pos2, best)
    return Pair(bp1, bp2, _take(sc1, best), _take(sc2, best),
                b1.ok & (bp1 != INVALID_LOC), b2.ok & (bp2 != INVALID_LOC),
                cigar(b1, R), cigar(b2, R))


# -------------------------------------------------------------- the DP ----
def gotoh_banded(read: torch.Tensor, refwin: torch.Tensor,
                 p: Params) -> torch.Tensor:
    """Banded semiglobal Gotoh scores of (N, R) reads against (N, W)
    windows (read global, free end gaps in the window): the K = 2 band + 1
    moving frame, slot k of row i at column i + c - band + k, c = (W - R)
    // 2; cells outside [0, W] are NEG."""
    N, R = read.shape
    W = refwin.shape[-1]
    band = p.band
    if band >= W:
        raise ValueError("the reference keeps only the banded DP")
    dev = read.device
    c = (W - R) // 2
    K = 2 * band + 1
    op, ext = p.gap_open, p.gap_extend
    first = op + ext
    k_idx = torch.arange(K, dtype=torch.int32, device=dev)
    neg = torch.full((N, 1), NEG, dtype=torch.int32, device=dev)
    fill = torch.full((N, band + 1), -1, dtype=torch.int32, device=dev)
    win_pad = torch.cat([fill, refwin.to(torch.int32), fill], 1)
    read32 = read.to(torch.int32)
    j0 = c - band + k_idx
    h = torch.where((j0 >= 0) & (j0 <= W), 0, NEG).to(torch.int32).expand(
        N, K).contiguous()
    e = torch.full((N, K), NEG, dtype=torch.int32, device=dev)
    for i in range(R):
        jcol = (i + 1 + c - band) + k_idx
        valid = ((jcol >= 0) & (jcol <= W))[None, :]
        e = torch.maximum(torch.cat([h[:, 1:], neg], 1) - first,
                          torch.cat([e[:, 1:], neg], 1) - ext)
        start = i + c + 1
        if start < 0:
            start += W + 2 * band + 2
        start = min(max(start, 0), W + 1)
        sub = torch.where(read32[:, i:i + 1] == win_pad[:, start:start + K],
                          p.match, -p.mismatch).to(torch.int32)
        h_tmp = torch.maximum(h + sub, e)
        h_tmp = torch.where(jcol[None, :] == 0, -(op + ext * (i + 1)), h_tmp)
        h_tmp = torch.where(valid, h_tmp, NEG)
        g = torch.cummax(h_tmp + ext * k_idx, dim=1).values
        f = torch.cat([neg, g[:, :-1]], 1) - op - ext * k_idx
        h = torch.where(valid, torch.maximum(h_tmp, f), NEG).to(torch.int32)
    return torch.max(h, dim=-1).values


# ------------------------------------------------------------ one batch ---
class Result(NamedTuple):
    """A batch's result, field for field as the program's."""

    pos1: torch.Tensor
    pos2: torch.Tensor
    score1: torch.Tensor
    score2: torch.Tensor
    method: torch.Tensor
    cigar1: torch.Tensor
    cigar2: torch.Tensor
    had_hits: torch.Tensor
    passed_adjacency: torch.Tensor
    light_ok: torch.Tensor
    dp_mate1: torch.Tensor
    dp_mate2: torch.Tensor
    n_valid: torch.Tensor


class Work(NamedTuple):
    """What the batch's kernels had to do, counted by the reference."""

    hits1: torch.Tensor    # (B,) valid SeedMap hits of mate 1
    hits2: torch.Tensor
    n_cand: torch.Tensor   # (B,) candidates kept by the filter
    dp_rows: int           # rows of the residual buffer
    dp_items: int          # mates the buffer re-aligns


def revcomp(codes: torch.Tensor) -> torch.Tensor:
    return (3 - codes).flip(-1)


def map_batch(sm: CSR, refp: torch.Tensor, n_ref: int, reads1, reads2,
              p: Params, block: int = 16_384) -> tuple[Result, Work]:
    """Map one batch of FR pairs (``reads2`` as sequenced) through steps
    1-5; steps 1-4 run ``block`` rows at a time."""
    B, R = reads1.shape
    if R != p.read_len:
        raise ValueError(f"reads are {R} bp, the configuration says "
                         f"{p.read_len}")
    if p.light_mode != "minsplit":
        raise ValueError("the reference aligns in minsplit mode only")
    dev = reads1.device
    reads2_fwd = revcomp(reads2).contiguous()
    parts = []
    for lo in range(0, B, block):
        r1, r2 = reads1[lo:lo + block], reads2_fwd[lo:lo + block]
        fe = front_end(sm, r1, r2, p)
        pair = candidate_align(refp, n_ref, r1, r2, fe.pos1, fe.pos2, p)
        parts.append((fe, pair))
    fe = Front(*(torch.cat(x) for x in zip(*(f for f, _ in parts))))
    pair = Pair(*(torch.cat(x) for x in zip(*(q for _, q in parts))))
    had_hits = (fe.n_hits1 > 0) & (fe.n_hits2 > 0)
    passed = fe.n > 0
    light_ok = passed & pair.ok1 & pair.ok2

    # step 5: the residual buffer, in batch order, then by window start
    needs_dp = passed & ~light_ok
    cap = p.residual_cap(B)
    zeros = torch.zeros(B, dtype=torch.bool, device=dev)
    neg = torch.full((B,), NEG, dtype=torch.int32, device=dev)
    if cap == 0:
        dp_sc1, dp_sc2, dp_done = neg, neg, zeros
        dp_over, dp_m1, dp_m2, items = needs_dp, zeros, zeros, 0
    else:
        order = torch.argsort((~needs_dp).to(torch.uint8), stable=True)
        idx = order[:cap]
        take = needs_dp[idx]
        loc = torch.argsort(torch.where(take, pair.pos1[idx], INT32_MAX),
                            stable=True)
        idx, take = idx[loc], take[loc]
        need1, need2 = take & ~pair.ok1[idx], take & ~pair.ok2[idx]
        scores = []
        for reads, pos, need, own in ((reads1, pair.pos1, need1, pair.score1),
                                      (reads2_fwd, pair.pos2, need2,
                                       pair.score2)):
            sc = own[idx].clone()
            rows = torch.nonzero(need).flatten()
            if rows.numel():
                at = idx[rows]
                win = windows(refp, n_ref, pos[at], pos[at] != INVALID_LOC,
                              R, p.dp_pad)
                sc[rows] = gotoh_banded(reads[at], win, p)
            scores.append(sc)

        def scatter(base, vals):
            out = base.clone()
            out[idx] = vals
            return out

        dp_sc1 = scatter(neg, torch.where(take, scores[0], NEG).to(
            torch.int32))
        dp_sc2 = scatter(neg, torch.where(take, scores[1], NEG).to(
            torch.int32))
        dp_done = scatter(zeros, take)
        dp_over = needs_dp & ~dp_done
        dp_m1, dp_m2 = scatter(zeros, need1), scatter(zeros, need2)
        items = int(need1.sum()) + int(need2.sum())

    method = torch.full((B,), M_UNMAPPED, dtype=torch.int32, device=dev)
    method = torch.where(~had_hits, M_RESIDUAL_FULL, method)
    method = torch.where(had_hits & ~passed, M_RESIDUAL_FULL, method)
    method = torch.where(light_ok, M_LIGHT, method)
    method = torch.where(dp_done, M_DP, method)
    method = torch.where(dp_over, M_DP_OVERFLOW, method)
    mapped = light_ok | dp_done
    res = Result(
        pos1=torch.where(mapped, pair.pos1, INVALID_LOC),
        pos2=torch.where(mapped, pair.pos2, INVALID_LOC),
        score1=torch.where(light_ok, pair.score1,
                           torch.where(dp_done, dp_sc1, NEG)),
        score2=torch.where(light_ok, pair.score2,
                           torch.where(dp_done, dp_sc2, NEG)),
        method=method, cigar1=pair.cigar1, cigar2=pair.cigar2,
        had_hits=had_hits, passed_adjacency=passed, light_ok=light_ok,
        dp_mate1=dp_m1, dp_mate2=dp_m2,
        n_valid=torch.ones(B, dtype=torch.bool, device=dev))
    return res, Work(fe.n_hits1, fe.n_hits2, fe.n, cap, items)


def stage_counts(res: Result) -> dict:
    """The stream's stage totals of one batch, as python ints."""
    v = res.n_valid

    def c(x):
        return int((x & v).sum())

    return {
        "no_seed_hit": c(~res.had_hits),
        "adjacency_fail": c(res.had_hits & ~res.passed_adjacency),
        "light_align_fail": c(res.passed_adjacency & ~res.light_ok),
        "light_mapped": c(res.method == M_LIGHT),
        "dp_mapped": c(res.method == M_DP),
        "dp_overflow": c(res.method == M_DP_OVERFLOW),
        "residual_full_dp": c(res.method == M_RESIDUAL_FULL),
        "dp_mate_alignments": c(res.dp_mate1) + c(res.dp_mate2),
        "n_pairs": int(v.sum()),
    }
