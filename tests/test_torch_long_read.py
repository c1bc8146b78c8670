"""repro_torch's long-read lane (§4.7) against repro's on the CPU, exact
equality: the read simulator, the Location Voting reduction (floored
negative bins, ties, all-invalid rows), the banded anchor DP, the
pseudo-pair front end, `Mapper.map_long` over a (segment_len, stride,
band) grid for both reference flavors and both index layouts, the
ragged-tail `map_long_stream` and the config carry-over."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.long_read import LongReadConfig as JLongReadConfig
from repro.core.scoring import Scoring as JScoring
from repro.core.seedmap import SeedMapConfig as JSeedMapConfig
from repro.core.seedmap import build_seedmap as j_build_seedmap
from repro.core.seedmap import to_padded as j_to_padded
from repro.core.simulate import simulate_long_reads as j_simulate_long_reads
from repro.engine import ExecutionConfig as JExecutionConfig
from repro.engine import Mapper as JMapper
from repro.kernels.banded_sw.ops import banded_sw as j_banded_sw
from repro.kernels.location_vote import location_vote as j_location_vote
from repro.kernels.location_vote import location_vote_ref as j_vote_ref
from repro.kernels.pair_frontend.ops import (
    segment_pair_frontend as j_segment_pair_frontend,
)
from repro_torch.convert import (
    config_from_fields,
    padded_from_numpy,
    seedmap_from_numpy,
)
from repro_torch.core.long_read import LongReadConfig, segment_views
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.scoring import Scoring
from repro_torch.core.seedmap import INVALID_LOC, PaddedSeedMap, SeedMap
from repro_torch.core.simulate import random_reference, simulate_long_reads
from repro_torch.engine import ExecutionConfig, Mapper
from repro_torch.kernels.banded_sw.ops import banded_sw
from repro_torch.kernels.location_vote.ops import location_vote
from repro_torch.kernels.location_vote.ref import location_vote_ref
from repro_torch.kernels.pair_frontend.ops import segment_pair_frontend

REF_LEN, READ_LEN, BITS = 60_000, 1500, 17


def _assert_same(got, want, msg=""):
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{f} {msg}")


@pytest.fixture(scope="module")
def world():
    """A random reference, its repro index, and a batch of long reads:
    simulated ones plus hand-built reads at the reference's start, 40
    bases before it (negative diagonals), at its end, past its end, and
    two random reads that are in no reference (no vote)."""
    rng = np.random.default_rng(11)
    ref = random_reference(REF_LEN, rng)
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=BITS))
    sim, starts = simulate_long_reads(ref, 6, READ_LEN, seed=2)
    noise = rng.integers(0, 4, (4, READ_LEN), np.uint8)
    edge = np.stack([
        ref[:READ_LEN],
        np.concatenate([noise[0, :40], ref[:READ_LEN - 40]]),
        ref[REF_LEN - READ_LEN:],
        np.concatenate([ref[REF_LEN - READ_LEN + 40:], noise[1, :40]]),
        noise[2], noise[3]])
    reads = np.concatenate([sim, edge]).astype(np.uint8)
    return ref, jsm, reads, starts


def test_simulate_long_reads_matches_repro():
    ref = random_reference(20_000, np.random.default_rng(5))
    for kw in (dict(seed=3), dict(sub_rate=0.05, seed=4),
               dict(rng=np.random.default_rng(9))):
        kw2 = dict(kw)
        if "rng" in kw:
            kw2["rng"] = np.random.default_rng(9)
        got = simulate_long_reads(ref, 7, 2000, **kw)
        want = j_simulate_long_reads(ref, 7, 2000, **kw2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- location vote ---
def _diags(B, M, seed, invalid_frac=0.4, lo=-400, hi=4000):
    """Random diagonals (negative ones too) with invalid slots, one
    all-invalid row, one row of ties and one near-origin row."""
    rng = np.random.default_rng(seed)
    d = rng.integers(lo, hi, (B, M)).astype(np.int32)
    d[rng.random((B, M)) < invalid_frac] = INVALID_LOC
    d[0, :] = INVALID_LOC
    d[1, :] = INVALID_LOC
    d[1, :4] = [300, 300, 100, 100]              # tie: the smaller bin wins
    d[2, :] = INVALID_LOC
    d[2, :4] = [-1, -1, -1, 50]                  # bin -1, not 0
    return d


@pytest.mark.parametrize("M,vote_bin", [(8, 64), (24, 64), (24, 32),
                                        (33, 128), (256, 64), (256, 1)])
def test_location_vote_matches_repro(M, vote_bin):
    diag = _diags(13, M, seed=M + vote_bin)
    want = j_vote_ref(jnp.asarray(diag), vote_bin)
    kern = j_location_vote(jnp.asarray(diag), vote_bin, block=8,
                           backend="interpret")
    _assert_same(kern, want, "repro kernel vs repro ref")
    got = location_vote_ref(torch.as_tensor(diag), vote_bin)
    _assert_same(got, want, f"M={M} bin={vote_bin}")
    _assert_same(location_vote(torch.as_tensor(diag), vote_bin), want)


def test_location_vote_edge_rows():
    diag = torch.tensor([[-1, -1, -1, 50, INVALID_LOC, INVALID_LOC],
                         [300, 300, 100, 100, INVALID_LOC, INVALID_LOC],
                         [INVALID_LOC] * 6,
                         [-(2**31), -(2**31) + 1, 7, INVALID_LOC, 64, 65]],
                        dtype=torch.int32)
    got = location_vote(diag, 64)
    assert got.win_bin.tolist() == [-1, 1, 0, -(2**31) // 64]
    assert got.votes.tolist() == [3, 2, 0, 2]
    _assert_same(got, j_vote_ref(jnp.asarray(diag.numpy()), 64))
    with pytest.raises(ValueError, match="positive"):
        location_vote(diag, 0)


def _c_floor_div(a: int, b: int) -> int:
    """csrc/location_vote.cu's floor_div: C++ `/` and `%` truncate."""
    q = abs(a) // b * (1 if a >= 0 else -1)
    return q - 1 if a - q * b != 0 and a < 0 else q


def _warp_vote_model(diag, vote_bin, vec, larger_bin=False):
    """numpy model of csrc/location_vote.cu, one warp per row: 32 lanes
    read the row (``vec``: 4-int vectors, lane l holding slots 4v .. 4v+3
    of vector v = v0 + l; else one slot a lane), each compact() call
    appends the valid slots' floored bins in lane order (ballot + popcount
    ranks), the bins are padded to a multiple of 4 with INVALID_LOC, lane
    l counts its compacted slots l, l+32, ... against all of them and
    keeps the larger count (a tie: the smaller bin), and a 5-step
    shuffle-down tree reduces the lanes the same way.  ``larger_bin``
    flips the tie rule (a mutation the test shows is caught)."""
    B, M = diag.shape

    def better(v, b, votes, bin_):
        tie = b > bin_ if larger_bin else b < bin_
        return v > votes or (v == votes and tie)

    out_bin, out_votes = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for r in range(B):
        row = [int(x) for x in diag[r]]
        bins = []

        def compact(vals):               # one slot per lane, lanes in order
            for d in vals:
                if d != INVALID_LOC:
                    bins.append(_c_floor_div(d, vote_bin))

        if vec:
            n_vec = M // 4
            for v0 in range(0, n_vec, 32):
                lanes = [row[4 * v:4 * v + 4] if v < n_vec
                         else [INVALID_LOC] * 4
                         for v in range(v0, v0 + 32)]
                for c in range(4):
                    compact([x[c] for x in lanes])
        else:
            for s0 in range(0, M, 32):
                compact([row[s] if s < M else INVALID_LOC
                         for s in range(s0, s0 + 32)])
        h = len(bins)
        padded = bins + [INVALID_LOC] * (-h % 4)
        votes, bin_ = [0] * 32, [INVALID_LOC] * 32
        for lane in range(32):
            for s in range(lane, h, 32):
                c = sum(x == bins[s] for x in padded)
                if better(c, bins[s], votes[lane], bin_[lane]):
                    votes[lane], bin_[lane] = c, bins[s]
        for step in (16, 8, 4, 2, 1):
            src_v, src_b = votes[:], bin_[:]      # __shfl_down_sync reads
            for lane in range(32):
                j = lane + step if lane + step < 32 else lane
                if better(src_v[j], src_b[j], votes[lane], bin_[lane]):
                    votes[lane], bin_[lane] = src_v[j], src_b[j]
        out_votes[r] = votes[0]
        out_bin[r] = bin_[0] if votes[0] > 0 else 0
    return out_bin, out_votes


@pytest.mark.parametrize("M,vote_bin", [(6, 64), (33, 128), (100, 64),
                                        (256, 64), (257, 1), (64, 32)])
def test_warp_vote_model_matches_repro(M, vote_bin):
    """The warp design (compacted bins, per-lane counts over h, the shuffle
    tree) equals repro's `location_vote_ref` and its interpret kernel, with
    h = 0, 1, 32 and M, ties, the floored bin -1, far-negative diagonals,
    and M not a multiple of 4 or 32; with the tie rule turned to "larger
    bin" the model no longer does."""
    rng = np.random.default_rng(7 * M + vote_bin)
    diag = _diags(14, M, seed=M * vote_bin)
    diag[3] = INVALID_LOC
    diag[3, M // 2] = 130                                   # h = 1
    diag[4] = INVALID_LOC
    diag[4, :min(32, M)] = rng.integers(-300, 300, min(32, M))   # h = 32
    diag[5] = rng.integers(-300, 3000, M)                   # h = M
    diag[6] = rng.integers(-(2**31), -(2**31) + 4096, M)    # far negative
    diag[7] = INVALID_LOC                                   # one bin, h = M/2
    diag[7, ::2] = vote_bin * 3 + rng.integers(0, vote_bin, len(diag[7, ::2]))
    diag[8, :] = np.where(rng.random(M) < 0.6, rng.integers(0, 9, M) *
                          vote_bin, INVALID_LOC)            # many ties
    want = j_vote_ref(jnp.asarray(diag), vote_bin)
    _assert_same(j_location_vote(jnp.asarray(diag), vote_bin, block=8,
                                 backend="interpret"), want,
                 "repro kernel vs repro ref")
    h = (diag != INVALID_LOC).sum(1)
    assert {0, 1, min(32, M), M} <= set(h.tolist())
    for vec in ((False, True) if M % 4 == 0 else (False,)):
        got_bin, got_votes = _warp_vote_model(diag, vote_bin, vec)
        np.testing.assert_array_equal(got_bin, np.asarray(want.win_bin))
        np.testing.assert_array_equal(got_votes, np.asarray(want.votes))
        bad_bin, _ = _warp_vote_model(diag, vote_bin, vec, larger_bin=True)
        assert not np.array_equal(bad_bin, np.asarray(want.win_bin))


# ------------------------------------------------------------ anchor DP ---
@pytest.mark.parametrize("r,w,band", [
    *(pytest.param(150, 278, b, id=str(b)) for b in (16, 24, 40, 278, None)),
    # windows shorter than the read: repro clamps some rows' window slice
    (150, 149, 16), (150, 147, 8), (150, 145, 3), (40, 37, 2), (40, 35, 10),
])
def test_banded_sw_matches_repro(r, w, band):
    """W < R: (150, 149) puts the band centre at floor(-1/2) = -1; the
    other short windows clamp the slice start of their first (c <= -2)
    and last (R + c > W + 1) rows, which then score in-band cells against
    shifted bases."""
    rng = np.random.default_rng((band or 7) if w > r else r * w + band)
    B = 9 if w > r else 8
    win = rng.integers(0, 4, (B, w), np.uint8)
    read = rng.integers(0, 4, (B, r), np.uint8)
    if w > r:
        for i, s in enumerate((64, 64 - 20, 64 + 35, 0, w - r)):
            read[i] = win[i, s:s + r]             # on and off the centre
            read[i, 40:43] = (read[i, 40:43] + 1) % 4
        read[5, :70] = win[5, 60:130]             # a 3-base deletion
        read[5, 70:] = win[5, 133:213]
    else:                                         # the window in the read
        for i, s in enumerate(((r - w + 1) // 2, 0, r - w, 1)):
            read[i, s:s + w] = win[i]
            read[i, s + w // 3] = (read[i, s + w // 3] + 1) % 4
        d = min(2, r - w)                         # a 1- or 2-base insertion
        read[4, :w // 2] = win[4, :w // 2]
        read[4, w // 2 + d:w + d] = win[4, w // 2:]
    sc = Scoring(match=2, mismatch=3, gap_open=4, gap_extend=1)
    want = j_banded_sw(jnp.asarray(read), jnp.asarray(win),
                       scoring=JScoring(**dataclasses.asdict(sc)),
                       band=band, backend="jnp")
    got = banded_sw(torch.as_tensor(read), torch.as_tensor(win), scoring=sc,
                    band=band)
    _assert_same(got, want, f"r={r} w={w} band={band}")


# ------------------------------------------------------------ front end ---
@pytest.mark.parametrize("seg_len,stride", [(150, 300), (180, 250)])
def test_segment_pair_frontend_matches_repro(world, seg_len, stride):
    ref, jsm, reads, _ = world
    rows = np.array(j_to_padded(jsm, cap=16).rows)
    kw = dict(seed_len=50, seeds_per_read=3, hash_seed=0, delta=800,
              max_candidates=8)
    want = j_segment_pair_frontend(jnp.asarray(rows), jnp.asarray(reads),
                                   seg_len, stride, backend="jnp", **kw)
    got = segment_pair_frontend(torch.as_tensor(rows),
                                torch.as_tensor(reads), seg_len, stride, **kw)
    _assert_same(got, want, f"{seg_len}/{stride}")
    assert segment_views(torch.as_tensor(reads), seg_len, stride).shape[1] \
        == (READ_LEN - seg_len) // stride + 1


# ----------------------------------------------------------- the lane ---
def _port_lr(jcfg):
    return config_from_fields(LongReadConfig, dataclasses.asdict(jcfg))


def _port_indexes(jsm):
    fields = dataclasses.asdict(jsm.config)
    sm = seedmap_from_numpy(np.asarray(jsm.offsets),
                            np.asarray(jsm.locations), fields)
    jp = j_to_padded(jsm, cap=32)
    psm = padded_from_numpy(np.asarray(jp.rows), np.asarray(jp.counts),
                            dataclasses.asdict(jp.config))
    return sm, psm


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seg_len,stride,band", [
    (150, 300, None), (150, 300, 16), (150, 200, None), (200, 400, 24),
    (150, 300, 278),
])
def test_mapper_map_long_matches_repro(world, packed, seg_len, stride,
                                       band):
    ref, jsm, reads, starts = world
    jcfg = JLongReadConfig(segment_len=seg_len, segment_stride=stride,
                           dp_band=band)
    jm = JMapper.from_index(jsm, ref, exec_cfg=JExecutionConfig(
        backend="jnp", packed_ref=packed, long_read=jcfg))
    want = jm.map_long(reads)
    cpu = ExecutionConfig(device="cpu", packed_ref=packed,
                          long_read=_port_lr(jcfg))
    for index, kind in zip(_port_indexes(jsm), (SeedMap, PaddedSeedMap)):
        m = Mapper.from_index(index, ref, exec_cfg=cpu)
        assert isinstance(m.index, kind) and m.pipe_cfg.packed_ref is packed
        assert m.lr_cfg.pipe.max_locs_per_seed == m.pipe_cfg.max_locs_per_seed
        assert m.lr_cfg.band() == jm.lr_cfg.band()
        _assert_same(m.map_long(reads), want,
                     f"{kind.__name__} packed={packed}")
    mapped = np.asarray(want.mapped)
    pos = np.asarray(want.position).astype(np.int64)
    assert mapped[:6].all() and not mapped[-2:].any()
    assert (np.abs(pos[:6] - starts) <= jcfg.vote_bin).all()
    assert pos[7] < 0                           # the read 40 bases early


def test_lane_config_resolution(world):
    """Only max_locs_per_seed and packed_ref come from the session; every
    other lane knob keeps the lane config's value."""
    ref, jsm, _, _ = world
    lane = LongReadConfig(pipe=PipelineConfig(delta=321, max_candidates=4,
                                              max_gap=3))
    m = Mapper.from_index(_port_indexes(jsm)[1], ref,
                          PipelineConfig(delta=99, max_locs_per_seed=32),
                          ExecutionConfig(device="cpu", packed_ref=True,
                                          long_read=lane))
    p = m.lr_cfg.pipe
    assert (p.delta, p.max_candidates, p.max_gap) == (321, 4, 3)
    assert p.max_locs_per_seed == 32 and p.packed_ref is True
    assert m.lr_cfg.band() == 64 // 2 + 3


def test_map_long_stream_ragged_tail_matches_repro(world):
    ref, jsm, reads, _ = world
    jcfg = JLongReadConfig()
    batches = [(reads,), (reads[:5],), (reads[3:],)]
    want = JMapper.from_index(jsm, ref, exec_cfg=JExecutionConfig(
        backend="jnp", long_read=jcfg, stream_batch=12)
    ).map_long_stream(iter(batches))
    m = Mapper.from_index(_port_indexes(jsm)[0], ref, exec_cfg=ExecutionConfig(
        device="cpu", long_read=_port_lr(jcfg), stream_batch=12))
    seen = []
    got = m.map_long_stream(iter(batches),
                            on_result=lambda i, res, n: seen.append((n, res)))
    assert got.totals == want.totals
    assert got.n_pairs == want.n_pairs == 12 + 5 + 9
    assert got.totals["n_reads"] == 26 and got.n_batches == 3
    assert got.reads_per_item == want.reads_per_item == 1
    assert got.fractions == pytest.approx(want.fractions)
    assert set(got.fractions) == {"lr_no_vote", "lr_mapped",
                                  "lr_candidates", "lr_winning_votes"}
    got.seconds = want.seconds = 1.0
    assert got.mbp_per_s(READ_LEN) == want.mbp_per_s(READ_LEN) \
        == 26 * READ_LEN / 1e6
    nv = seen[1][1].n_valid.numpy()
    assert seen[1][0] == 5 and nv[:5].all() and not nv[5:].any()
    full = m.map_long(reads)
    _assert_same(seen[0][1], full)


def test_map_long_stream_reduce_fn_and_warmup(world):
    ref, jsm, reads, starts = world
    m = Mapper.from_index(_port_indexes(jsm)[1], ref,
                          exec_cfg=ExecutionConfig(device="cpu"))

    def near(state, res, true):
        ok = res.n_valid & res.mapped & (
            (res.position.long() - true.long()).abs() <= m.lr_cfg.vote_bin)
        return state + ok.sum()

    sr = m.map_long_stream(
        iter([(reads[:6], starts), (reads[:2], starts[:2])]),
        reduce_fn=near, reduce_init=torch.zeros((), dtype=torch.int64),
        warmup_batch=(reads[:6],))
    assert int(sr.reduced) == 6 + 2 and sr.n_pairs == 8
    with pytest.raises(ValueError, match="read arrays"):
        m.map_long_stream(iter([(reads, reads, starts, starts)]))


def test_long_read_config_from_repro_fields():
    j = JLongReadConfig(segment_len=120, segment_stride=250, vote_bin=32,
                        dp_band=20, vote_backend="jnp", vote_block=16)
    got = config_from_fields(LongReadConfig, dataclasses.asdict(j))
    assert got == LongReadConfig(segment_len=120, segment_stride=250,
                                 vote_bin=32, dp_band=20)
    assert isinstance(got.pipe, PipelineConfig)
    assert got.band() == j.band() and got.pair_delta() == j.pair_delta()
    assert got.n_segments(10_000) == j.n_segments(10_000)
    with pytest.raises(ValueError, match="no fields"):
        config_from_fields(LongReadConfig, {"vote_bins": 3})


def test_map_long_rejects_reads_too_short_for_a_pair(world):
    ref, jsm, reads, _ = world
    m = Mapper.from_index(_port_indexes(jsm)[0], ref,
                          exec_cfg=ExecutionConfig(device="cpu"))
    with pytest.raises(ValueError, match="pseudo-pair"):
        m.map_long(reads[:, :400])
