"""repro_torch's front end (steps 1-3) against repro's on the CPU, exact
equality: the fused op's plain version over an (S, K, Δ, C) grid with
negative starts near the origin, all-invalid rows, duplicate-heavy rows
and candidate overflow; the staged CSR path; the pair-dedup rule."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import query as jquery
from repro.core import seeding as jseeding
from repro.core.pair_filter import paired_adjacency_filter as j_filter
from repro.core.query import QueryResult as JQueryResult
from repro.core.seedmap import SeedMapConfig as JSeedMapConfig
from repro.core.seedmap import build_seedmap as j_build
from repro.core.simulate import random_reference
from repro.kernels.pair_frontend import pair_frontend as j_pair_frontend
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
