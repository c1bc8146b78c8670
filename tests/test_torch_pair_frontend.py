"""repro_torch's front end (steps 1-3) against repro's on the CPU, exact
equality: the fused op's plain version over an (S, K, Δ, C) grid with
negative starts near the origin, all-invalid rows, duplicate-heavy rows
and candidate overflow; the staged CSR path; the pair-dedup rule; numpy
models of the CUDA kernels' merge block and seed packing."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import query as jquery
from repro.core import seeding as jseeding
from repro.core.hashing import xxhash32_words_np
from repro.core.pair_filter import paired_adjacency_filter as j_filter
from repro.core.query import QueryResult as JQueryResult
from repro.core.seedmap import SeedMapConfig as JSeedMapConfig
from repro.core.seedmap import build_seedmap as j_build
from repro.core.simulate import random_reference
from repro.kernels.pair_frontend import pair_frontend as j_pair_frontend
from repro.kernels.pair_frontend.ref import (
    seed_buckets_ref as j_seed_buckets_ref,
)
from repro_torch.core import query, seeding
from repro_torch.core.pair_filter import paired_adjacency_filter
from repro_torch.core.query import QueryResult
from repro_torch.core.seedmap import INVALID_LOC, SeedMapConfig, build_seedmap
from repro_torch.kernels.pair_frontend.ops import pair_frontend


def _assert_same(got, want, msg=""):
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{f} {msg}")


def _world(k, seed, t=64, b=12, r=64, lo=-40, hi=200):
    """Synthetic padded table + reads.  A narrow location range makes
    duplicate starts and candidate overflow common; locations below the
    seed offsets give negative read starts; ~1/8 of the rows are empty."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(lo, hi, (t, k)).astype(np.int32)
    rows[rng.random((t, k)) < 0.3] = INVALID_LOC
    rows[rng.random(t) < 0.125] = INVALID_LOC
    reads1 = rng.integers(0, 4, (b, r), np.uint8)
    reads2 = rng.integers(0, 4, (b, r), np.uint8)
    return rows, reads1, reads2


def _both(rows, r1, r2, **kw):
    want = j_pair_frontend(jnp.asarray(rows), jnp.asarray(r1),
                           jnp.asarray(r2), backend="jnp", **kw)
    got = pair_frontend(torch.as_tensor(rows), torch.as_tensor(r1),
                        torch.as_tensor(r2), **kw)
    return got, want


@pytest.mark.parametrize("s,k,delta,c", [
    (1, 4, 30, 2), (2, 4, 0, 4), (3, 8, 30, 4), (3, 4, 500, 8),
    (2, 8, 5, 2), (3, 32, 500, 8), (1, 2, 60, 8),
])
def test_frontend_matches_repro(s, k, delta, c):
    rows, r1, r2 = _world(k, seed=s * 100 + k + delta + c)
    got, want = _both(rows, r1, r2, seed_len=16, seeds_per_read=s,
                      hash_seed=0, delta=delta, max_candidates=c)
    _assert_same(got, want, f"S={s} K={k} d={delta} C={c}")


def test_frontend_all_invalid_table():
    rows = np.full((64, 4), INVALID_LOC, np.int32)
    _, r1, r2 = _world(4, seed=3)
    got, want = _both(rows, r1, r2, seed_len=16, seeds_per_read=2,
                      hash_seed=0, delta=100, max_candidates=2)
    _assert_same(got, want, "all-invalid")
    assert (got.n.numpy() == 0).all()
    assert (got.pos1.numpy() == INVALID_LOC).all()


def test_frontend_duplicate_heavy_overflow_rows():
    """Every bucket holds the same dense run: many duplicate starts, far
    more survivors than C."""
    rng = np.random.default_rng(9)
    rows = np.tile(np.arange(8, dtype=np.int32) * 3, (64, 1))
    r1 = rng.integers(0, 4, (8, 64), np.uint8)
    r2 = rng.integers(0, 4, (8, 64), np.uint8)
    got, want = _both(rows, r1, r2, seed_len=16, seeds_per_read=3,
                      hash_seed=0, delta=50, max_candidates=2)
    _assert_same(got, want, "overflow")
    assert (got.n.numpy() == 2).all()


def test_frontend_negative_starts_near_origin():
    """Locations 0..5 at seed offsets up to 48 give starts down to -48."""
    rng = np.random.default_rng(4)
    rows = np.full((32, 4), INVALID_LOC, np.int32)
    rows[:, :3] = rng.integers(0, 6, (32, 3))
    r1 = rng.integers(0, 4, (10, 64), np.uint8)
    r2 = rng.integers(0, 4, (10, 64), np.uint8)
    got, want = _both(rows, r1, r2, seed_len=16, seeds_per_read=3,
                      hash_seed=5, delta=40, max_candidates=4)
    _assert_same(got, want, "negative starts")
    assert (got.pos1.numpy() < 0).any()


def test_filter_keeps_distinct_mate2_placements():
    """Two distinct mate-2 placements within Δ of one duplicated mate-1
    start both surface; equal (start1, start2) pairs collapse."""
    M = 8
    s1 = np.full(M, INVALID_LOC, np.int32)
    s1[:2] = [100, 100]
    for s2_head, n_want in (([80, 150], 2), ([80, 80], 1)):
        s2 = np.full(M, INVALID_LOC, np.int32)
        s2[:2] = s2_head
        want = j_filter(JQueryResult(jnp.asarray(s1[None]),
                                     jnp.asarray([2], jnp.int32)),
                        JQueryResult(jnp.asarray(s2[None]),
                                     jnp.asarray([2], jnp.int32)), 100, 4)
        got = paired_adjacency_filter(
            QueryResult(torch.as_tensor(s1[None]), torch.tensor([2])),
            QueryResult(torch.as_tensor(s2[None]), torch.tensor([2])),
            100, 4)
        _assert_same(got, want)
        assert int(got.n[0]) == n_want


@pytest.mark.parametrize("K,delta,c", [(32, 500, 8), (4, 300, 3)])
def test_staged_csr_path_matches_repro(K, delta, c):
    """Seeding + CSR query + merge + filter (the plain front end over a
    CSR SeedMap) on real seeds of a random reference."""
    rng = np.random.default_rng(K)
    ref = random_reference(60_000, rng)
    jsm = j_build(ref, JSeedMapConfig(table_bits=14))
    sm = build_seedmap(torch.as_tensor(ref), SeedMapConfig(table_bits=14))
    starts = rng.integers(0, 60_000 - 150, 16)
    reads = np.stack([ref[s:s + 150] for s in starts])
    reads[::3] = rng.integers(0, 4, (len(reads[::3]), 150))   # no-hit reads
    j_q = [jquery.query_read_batch(
        jsm, jseeding.seed_read_batch(jnp.asarray(x), 50, 3), K)
        for x in (reads, np.roll(reads, 1, 0))]
    q = [query.query_read_batch(
        sm, seeding.seed_read_batch(torch.as_tensor(x), 50, 3), K)
        for x in (reads, np.roll(reads, 1, 0))]
    for a, b in zip(q, j_q):
        _assert_same(a, b, "query")
    _assert_same(paired_adjacency_filter(q[0], q[1], delta, c),
                 j_filter(j_q[0], j_q[1], delta, c), "filter")
    np.testing.assert_array_equal(
        query.padded_rows_device(sm, K).numpy(),
        np.asarray(jquery.padded_rows_device(jsm, K)))


def _wrap32(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int64)


def _valid_only_model(l1, l2, offs, K, delta, C):
    """numpy model of csrc/merge_filter.cuh's warp block: compact each
    mate's starts other than INVALID_LOC in element order, sort only
    those h (the rest of the reference's sorted row is INVALID_LOC),
    and probe only i < h1 (lo by binary search over h2, occ over the
    sorted prefix, the partner INVALID_LOC past h2)."""
    B, M = l1.shape
    off = np.repeat(np.asarray(offs, np.int64), K)
    pos1 = np.full((B, C), INVALID_LOC, np.int64)
    pos2 = np.full((B, C), INVALID_LOC, np.int64)
    n = np.zeros(B, np.int64)
    hits = np.zeros((2, B), np.int64)
    for b in range(B):
        s = []
        for m, locs in enumerate((l1[b], l2[b])):
            hit = locs != INVALID_LOC
            st = np.where(hit, _wrap32(locs.astype(np.int64) - off),
                          INVALID_LOC)
            hits[m, b] = hit.sum()
            s.append(np.sort(st[st != INVALID_LOC]))
        s1, s2 = s
        h1, h2 = len(s1), len(s2)
        kept, p2 = 0, []
        for i in range(h1):
            v = s1[i]
            lo = np.searchsorted(s2, _wrap32(v - delta), side="left")
            occ = i - np.searchsorted(s1[:i], v, side="left")
            idx = min(max(lo + occ, 0), M - 1)
            q = s2[idx] if idx < h2 else INVALID_LOC
            p2.append(q)
            d = _wrap32(q - v)
            within = q != INVALID_LOC and _wrap32(abs(d)) <= delta
            if within and (i == 0 or s1[i - 1] != v or p2[i - 1] != q):
                if kept < C:
                    pos1[b, kept], pos2[b, kept] = v, q
                kept += 1
        n[b] = min(kept, C)
    return pos1, pos2, n, hits[0], hits[1]


def _edge_locs(k, s, b, seed):
    """(2, B, S*K) locations: random rows, then dense rows (every slot
    valid), all invalid, duplicate-heavy rows with many survivors,
    locations near +-2^31 (one start that wraps to INT_MAX, one target
    that wraps) and starts near 0."""
    rng = np.random.default_rng(seed)
    M = s * k
    x = rng.integers(-40, 300, (2, b, M)).astype(np.int64)
    x[rng.random(x.shape) < 0.4] = INVALID_LOC
    x[:, 1] = rng.integers(0, 2000, (2, M))                  # dense
    x[:, 2] = INVALID_LOC                                    # no hits
    x[1, 3] = INVALID_LOC                                    # mate 2 empty
    x[:, 4] = np.arange(M) % 5 * 3                           # duplicates
    x[:, 5] = 7                                              # all equal
    x[:, 6] = rng.integers(-2**31, -2**31 + 300, (2, M))     # near -2^31
    x[:, 7] = rng.integers(2**31 - 300, 2**31 - 1, (2, M))   # near +2^31
    x[0, 6, 0] = -2**31 + 40 - 1    # seed 0 at offset 40: start INT_MAX
    return x.astype(np.int32)


@pytest.mark.parametrize("s,k,delta,c", [
    (3, 32, 500, 8), (3, 4, 60, 1), (2, 8, 0, 4), (3, 32, 0, 1),
    (1, 4, 30, 8), (3, 24, 50, 40),
])
def test_valid_only_sort_model_matches_repro_block(s, k, delta, c):
    """The identity the warp merge block rests on: sorting only the valid
    starts and probing only mate 1's valid ones gives repro's
    `merge_filter_block` (the full stable sort of all M slots), M > 64
    and more than 32 survivors included."""
    from repro.kernels.pair_frontend.kernel import merge_filter_block
    offs = (40, 80, 120)[:s] if s > 1 else (40,)
    l = _edge_locs(k, s, 10, seed=s * k + delta + c)
    want = merge_filter_block(jnp.asarray(l[0]), jnp.asarray(l[1]),
                              seed_offs=offs, K=k, delta=delta, cap=c)
    got = _valid_only_model(l[0], l[1], offs, k, delta, c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w).reshape(g.shape))
    if c == 1 and delta == 60:
        assert got[2][4] == 1


def _seed_words_model(buf, lead, B, R, rows, offs, seed_len):
    """numpy model of csrc/seed_buckets.cu's staged packing: the (B, R)
    reads lie at byte ``lead`` of ``buf`` (device memory); a block stages
    the 16-byte vectors covering its tile of ``rows`` rows (the start
    aligned down, the head skipped), then each seed takes four bases per
    aligned 32-bit load (two loads funnel-shifted off a word boundary, only
    the words that hold a seed byte), masks the bases past the seed, and
    adds __dp4a(x, 4^m) << 8 (g & 3) into its word, mod 2^32."""
    S = len(offs)
    out = np.zeros((B, S, 4), np.uint64)
    for row0 in range(0, B, rows):
        n_rows = min(rows, B - row0)
        a = lead + row0 * R
        head = a & 15
        n_vec = (head + n_rows * R + 15) >> 4
        assert 16 * n_vec <= (rows * R + 30) & ~15     # the launcher's smem
        staged = buf[a - head:a - head + 16 * n_vec]
        assert len(staged) == 16 * n_vec
        words = staged.view("<u4").astype(np.uint64)
        for r in range(n_rows):
            for s, off in enumerate(offs):
                p = head + r * R + off
                q, sh = p >> 2, 8 * (p & 3)
                n_words = ((p & 3) + seed_len + 3) >> 2
                lo = words[q]
                for g in range(16):
                    if 4 * g >= seed_len:
                        break
                    hi = words[q + g + 1] if g + 1 < n_words else 0
                    x = ((int(hi) << 32 | int(lo)) >> sh) & 0xFFFFFFFF
                    lo = hi
                    if seed_len - 4 * g < 4:
                        x &= (1 << 8 * (seed_len - 4 * g)) - 1
                    dp4a = sum((x >> 8 * m & 0xFF) << 2 * m for m in range(4))
                    w = out[row0 + r, s, g >> 2]
                    out[row0 + r, s, g >> 2] = \
                        (int(w) + (dp4a << 8 * (g & 3))) & 0xFFFFFFFF
    return out.astype(np.uint32)


@pytest.mark.parametrize("r", [150, 151, 37])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_seed_pack_words_model_matches_repro(r, s):
    """The kernel's word-wise packing of a staged tile equals repro's
    summed 2-bit packing and, hashed and masked, repro's bucket ids, for
    any uint8 code (codes > 3 carry into the next base), with each mate's
    reads starting off a 16-byte boundary, odd R (tiles start off a word)
    and a batch that is not a multiple of the tile."""
    rng = np.random.default_rng(r * 10 + s)
    B, rows, seed_len = 13, 5, min(50, r // s)
    offs = seeding.seed_offsets_tuple(r, seed_len, s)
    for lead in (0, 5, 11):
        reads = rng.integers(0, 256, (B, r), np.uint8)
        buf = rng.integers(0, 256, lead + B * r + 32, np.uint8)
        buf[lead:lead + B * r] = reads.reshape(-1)
        got = _seed_words_model(buf, lead, B, r, rows, offs, seed_len)
        want = np.asarray(jseeding.pack_seed_words(
            jseeding.extract_seeds(jnp.asarray(reads), seed_len, s)))
        np.testing.assert_array_equal(got, want.astype(np.uint32),
                                      err_msg=f"lead={lead}")
        ids = (xxhash32_words_np(got, seed=7) & np.uint32((1 << 16) - 1))
        np.testing.assert_array_equal(
            ids.astype(np.int32),
            np.asarray(j_seed_buckets_ref(jnp.asarray(reads), seed_len, s, 7,
                                          1 << 16)))
