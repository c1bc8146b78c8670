"""repro_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Every comparison of the mapping kernels is exact equality (all
integer arithmetic); flash_attention, a float kernel, is held within 1e-4
(float32: the sums run in another order) or 3e-2 (bf16, repro's bf16
tolerance) of its plain version, and the LM prefill through it within a
relative L2 error of 1e-2 of the plain-backend prefill.  One train step
on the card is held against the same step on the CPU (tolerances at the
test), and the flash wrapper must refuse autograd on the card.

Run on a machine with an NVIDIA GPU and nvcc:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
Elsewhere every test skips (decided inside the `dev` fixture).  The mesh
tests run a one-rank NCCL process group (a file store in a temporary
directory, the loopback interface).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.encoding import pack_2bit
from repro_torch.core.light_align import cigar_ops
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.scoring import Scoring
from repro_torch.core.seeding import SEED_WORDS, extract_seeds
from repro_torch.core.seedmap import INVALID_LOC, SeedMapConfig
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_long_reads,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, Mapper
from repro_torch.kernels import _cuda
from repro_torch.kernels.banded_sw.ops import banded_sw
from repro_torch.kernels.candidate_align.ops import (
    MAX_LANE_READ,
    candidate_pair_align,
    launch_shape,
)
from repro_torch.kernels.candidate_align.ref import gather_windows
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.light_align.ops import light_align
from repro_torch.kernels.location_vote.ops import location_vote
from repro_torch.kernels.pair_frontend.ops import (
    frontend_from_buckets,
    frontend_merge_filter,
    seed_buckets,
)
from repro_torch.kernels.pair_frontend.ref import (
    frontend_from_buckets_ref,
    seed_buckets_ref,
)
from repro_torch.kernels.residual_dp.ops import residual_pair_dp
from repro_torch.kernels.seed_gather.ops import seed_gather
from repro_torch.kernels.xxhash.ops import xxhash32
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import make_smoke_batch, model_init_params
from repro_torch.models.model import prefill_step
from repro_torch.optim import adamw
from repro_torch.optim.compress import CompressConfig, init_state
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _same(a, b, msg=""):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x.cpu(), y.cpu().to(x.dtype)), f"{f} {msg}"


@pytest.mark.parametrize("s,k,seed_len,b,r,codes,lead", [
    *(pytest.param(s, k, n, 37, 150, 4, 0, id=f"{s}-{k}-{n}")
      for s, k, n in ((3, 32, 50), (2, 8, 16), (1, 4, 64))),
    # odd R (tiles start off a word), codes 0-255 (carries), a batch that
    # is not a multiple of the 64-row tile, mates starting off 16 bytes
    (3, 0, 50, 37, 151, 256, 0), (3, 0, 50, 1000, 151, 256, 5),
    (2, 0, 16, 1000, 151, 256, 3), (1, 0, 64, 37, 151, 256, 0),
    (3, 0, 50, 1000, 150, 256, 1),
    # rows too long to stage (read from device memory)
    (3, 0, 50, 3, 40_000, 256, 1),
])
def test_seed_buckets_matches_plain(dev, s, k, seed_len, b, r, codes, lead):
    rng = np.random.default_rng(s)

    def mate():        # (b, r) contiguous, ``lead`` bytes into its buffer
        buf = torch.as_tensor(rng.integers(0, codes, b * r + lead, np.uint8),
                              device=dev)
        return buf[lead:].view(b, r)

    r1, r2 = mate(), mate()
    got = seed_buckets(r1, r2, seed_len, s, 7, 1 << 16)
    torch.cuda.synchronize()
    want = seed_buckets_ref(torch.cat([r1, r2]), seed_len, s, 7, 1 << 16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("s,k,delta,c", [
    (1, 4, 30, 2), (2, 4, 0, 4), (3, 8, 30, 4), (3, 32, 500, 8),
    (2, 8, 5, 2), (1, 2, 60, 8),
])
def test_frontend_matches_plain(dev, s, k, delta, c):
    rng = np.random.default_rng(100 * s + k + c)
    T, B = 64, 29
    rows = rng.integers(-40, 200, (T, k)).astype(np.int32)  # negatives too
    rows[rng.random((T, k)) < 0.3] = INVALID_LOC
    rows[rng.random(T) < 0.125] = INVALID_LOC
    rows[:4] = np.arange(k, dtype=np.int32) * 3             # dense rows
    rows = torch.as_tensor(rows, device=dev)
    buckets = torch.as_tensor(rng.integers(0, T, (2 * B, s)).astype(np.int32),
                              device=dev)
    buckets[:3] = 0                                          # duplicate-heavy
    buckets[B:B + 2] = 5
    offs = tuple(int(x) for x in np.round(np.arange(s) * (150 - 50)
                                          / max(s - 1, 1)))
    got = frontend_from_buckets(rows, buckets, offs, delta, c)
    want = frontend_from_buckets_ref(
        rows, buckets[:B], buckets[B:], torch.tensor(offs, device=dev),
        delta, c)
    _same(got, want, f"S={s} K={k} delta={delta} C={c}")


def _cand_world(dev, b=40, c=8, L=6000, R=150, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L, np.uint8)
    pos1 = rng.integers(-30, L + 30, (b, c)).astype(np.int32)
    pos2 = rng.integers(-30, L + 30, (b, c)).astype(np.int32)
    pos1[rng.random((b, c)) < 0.3] = INVALID_LOC
    pos2[rng.random((b, c)) < 0.3] = INVALID_LOC
    pos1[0] = pos2[0] = INVALID_LOC                       # all-invalid row
    reads1 = rng.integers(0, 4, (b, R), np.uint8)
    reads2 = rng.integers(0, 4, (b, R), np.uint8)
    for i in range(1, b, 2):                              # planted hits
        p = int(rng.integers(20, L - R - 200))
        pos1[i, i % c] = p
        pos2[i, i % c] = p + 100
        reads1[i] = ref[p:p + R]
        reads2[i] = ref[p + 100:p + 100 + R]
        reads1[i, 10] = (reads1[i, 10] + 1) % 4
        reads2[i, 70:] = ref[p + 100 + 72:p + 100 + R + 2]  # a deletion
    t = (lambda x: torch.as_tensor(x, device=dev))
    return t(ref), t(reads1), t(reads2), t(pos1), t(pos2)


def _cand_kind_world(dev, kind, seed=0, R=150):
    """_cand_world's reference, reads and planted hits under one validity
    pattern: every slot valid ("dense"), one valid slot per row, only
    half-valid slots (one mate valid) beside rows with one fully valid
    slot, every slot invalid, C = 1, a batch of 4,096 pairs whose blocks
    each hold several rounds of items per lane group (or thread), and
    starts at the window clamps' edges (before the origin, past the end,
    near +-2^31, where pos - E wraps as int32)."""
    b, c = {"c1": (40, 1), "large": (4096, 8)}.get(kind, (160, 8))
    ref, r1, r2, p1, p2 = _cand_world(dev, b=b, c=c, R=R, seed=seed)
    rng = np.random.default_rng(seed + 1)
    L = ref.shape[0]
    full = torch.as_tensor(rng.integers(-30, L + 30, (2, b, c)),
                           dtype=torch.int32, device=dev)
    inv = torch.full_like(p1, INVALID_LOC)
    if kind == "dense":
        p1, p2 = (torch.where(p == INVALID_LOC, f, p)
                  for p, f in zip((p1, p2), full))
    elif kind == "one_valid":
        keep = rng.integers(0, c, b)
        keep[1::2] = np.arange(1, b, 2) % c          # the planted slot
        keep = torch.as_tensor(keep, device=dev)
        one = torch.arange(c, device=dev)[None] == keep[:, None]
        p1 = torch.where(one, full[0], inv)
        p2 = torch.where(one, full[1], inv)
    elif kind == "half_valid":
        mate1 = torch.as_tensor(rng.random((b, c)) < 0.5, device=dev)
        p1 = torch.where(mate1, full[0], inv)
        p2 = torch.where(mate1, inv, full[1])
        p1[::4, 3] = full[0, ::4, 3]                 # one fully valid slot
        p2[::4, 3] = full[1, ::4, 3]
    elif kind == "all_invalid":
        p1, p2 = inv, inv.clone()
    elif kind == "edges":                            # the window clamps
        edge = torch.tensor([-2**31, -2**31 + 3, -(R + 16 + 9), -9, -3, 0,
                             L - R - 8, L - 1, L + 7, 2**30, 2**31 - 2],
                            dtype=torch.int32, device=dev)
        p1 = edge[torch.arange(b * c, device=dev) % len(edge)].reshape(b, c)
        p2 = p1.flip(1)
    return ref, r1, r2, p1.contiguous(), p2.contiguous()


def _want_count(p1, p2, got):
    """The alignments the kernel runs without a prescreen: every valid
    mate, both mates of a row without one, and the winner's invalid mates
    in a row with one."""
    v1, v2 = p1 != INVALID_LOC, p2 != INVALID_LOC
    has = (v1 | v2).any(1)
    late = (got.pos1 == INVALID_LOC).int() + (got.pos2 == INVALID_LOC).int()
    return int(v1.sum() + v2.sum() + 2 * (~has).sum() + late[has].sum())


def _path_launches():
    return dict(_cuda.KERNELS["candidate_align"].paths)


@pytest.mark.parametrize("kind", ["dense", "one_valid", "half_valid",
                                  "all_invalid", "c1", "large", "edges"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("prescreen", [0, 4])
@pytest.mark.parametrize("R", [150, 250, 1100])
def test_candidate_align_validity_patterns_match_plain(dev, kind, packed,
                                                       prescreen, R):
    ref, r1, r2, p1, p2 = _cand_kind_world(dev, kind, seed=prescreen + 3,
                                           R=R)
    ref_in = pack_2bit(ref) if packed else ref
    kw = dict(prescreen_top=prescreen, packed_ref=packed)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    got = candidate_pair_align(ref_in, r1, r2, p1, p2, 8, backend="cuda",
                               count=count, **kw)
    want = candidate_pair_align(ref_in, r1, r2, p1, p2, 8, backend="torch",
                                **kw)
    _same(got, want, f"{kind} packed={packed} P={prescreen} R={R}")
    if prescreen == 0 or p1.shape[1] <= prescreen:
        assert int(count) == _want_count(p1, p2, got), kind


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["minsplit", "paper"])
@pytest.mark.parametrize("prescreen", [0, 1, 4, 8])
@pytest.mark.parametrize("E", [8, 16])
@pytest.mark.parametrize("R", [100, 150, 250, 251, 1024, 1100])
def test_candidate_align_matches_plain(dev, packed, mode, prescreen, E, R):
    """Lane groups of 4 (R 100), 8 (150, 250, an odd 251) and 32 lanes
    (1,024, the lanes' limit), one thread an item past it (1,100): bit for
    bit, the alignments counted, the launch on the path R picks."""
    ref, r1, r2, p1, p2 = _cand_world(dev, R=R, seed=prescreen + R + E)
    ref_in = pack_2bit(ref) if packed else ref
    kw = dict(mode=mode, prescreen_top=prescreen, packed_ref=packed)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    before = _path_launches()
    got = candidate_pair_align(ref_in, r1, r2, p1, p2, E, backend="cuda",
                               count=count, **kw)
    path = "lanes" if R <= MAX_LANE_READ else "thread"
    assert _path_launches() == {**before, path: before.get(path, 0) + 1}
    want = candidate_pair_align(ref_in, r1, r2, p1, p2, E, backend="torch",
                                **kw)
    _same(got, want, f"packed={packed} mode={mode} P={prescreen} E={E} "
                     f"R={R}")
    if prescreen == 0 or p1.shape[1] <= prescreen:
        assert int(count) == _want_count(p1, p2, got)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("band", [0, 1, 2, 24, 181, None])
def test_residual_dp_matches_plain(dev, packed, band):
    rng = np.random.default_rng(band or 99)
    L, R, n, dp_pad = 5000, 150, 33, 16
    ref = rng.integers(0, 4, L, np.uint8)
    pos1 = rng.integers(0, L - R - 32, n).astype(np.int32)
    pos1[:6] = [-3, -(R + 2 * dp_pad + 5), 0, L - 1, L + 7, INVALID_LOC]
    pos2 = pos1[::-1].copy()
    reads1 = rng.integers(0, 4, (n, R), np.uint8)
    reads2 = rng.integers(0, 4, (n, R), np.uint8)
    for i in range(7, n, 2):
        reads1[i] = ref[pos1[i]:pos1[i] + R]
        reads1[i, 50:53] = 0
    need1 = rng.random(n) < 0.6
    need2 = rng.random(n) < 0.6
    t = (lambda x: torch.as_tensor(x, device=dev))
    ref_in = pack_2bit(t(ref)) if packed else t(ref)
    args = (ref_in, t(reads1), t(reads2), t(pos1), t(pos2), t(need1),
            t(need2), dp_pad)
    got = residual_pair_dp(*args, band=band, packed_ref=packed,
                           backend="cuda")
    want = residual_pair_dp(*args, band=band, packed_ref=packed,
                            backend="torch")
    _same(got, want, f"packed={packed} band={band}")


def test_residual_dp_zero_items(dev):
    ref = torch.randint(0, 4, (3000,), dtype=torch.uint8, device=dev)
    reads = torch.randint(0, 4, (8, 150), dtype=torch.uint8, device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev) * 100
    none = torch.zeros(8, dtype=torch.bool, device=dev)
    got = residual_pair_dp(ref, reads, reads, pos, pos, none, none, 16,
                           backend="cuda")
    assert int(got.dp_lanes) == 0
    assert bool((got.score1 == -(1 << 20)).all())


def _dp_world(dev, n, R, dp_pad, need, seed):
    """A reference, reads (every other one a noisy copy of its window),
    window anchors on both reference edges and past them, and one of the
    need patterns: "all", "none", "one" (a single slot), "random"."""
    rng = np.random.default_rng(seed)
    L = 4000
    ref = rng.integers(0, 4, L, np.uint8)
    pos1 = rng.integers(0, L - R, n).astype(np.int32)
    edges = [-3, -(R + 2 * dp_pad + 5), 0, L - 1, L + 7, INVALID_LOC,
             -2**31, 2**31 - 2]
    pos1[:min(n, len(edges))] = edges[:n]
    pos2 = pos1[::-1].copy()
    reads1 = rng.integers(0, 4, (n, R), np.uint8)
    reads2 = rng.integers(0, 4, (n, R), np.uint8)
    for i in range(len(edges), n, 2):
        reads1[i] = ref[pos1[i]:pos1[i] + R]
        reads1[i, R // 3:R // 3 + 3] = 0
        if 0 <= pos2[i] < L - R:
            reads2[i, :R // 2] = ref[pos2[i]:pos2[i] + R // 2]
    need1, need2 = {
        "all": (np.ones(n, bool), np.ones(n, bool)),
        "none": (np.zeros(n, bool), np.zeros(n, bool)),
        "one": (np.arange(n) == n // 2, np.zeros(n, bool)),
        "random": (rng.random(n) < 0.5, rng.random(n) < 0.5),
    }[need]
    t = (lambda x: torch.as_tensor(x, device=dev))
    return (t(ref),) + tuple(t(x) for x in (reads1, reads2, pos1, pos2,
                                             need1, need2))


@pytest.mark.parametrize("need", ["all", "none", "one", "random"])
@pytest.mark.parametrize("n,R,dp_pad,band", [
    (33, 150, 16, 24), (5, 45, 16, 24), (3, 150, 16, None),
    (97, 100, 8, 2), (1, 37, 5, 0),
])
@pytest.mark.parametrize("packed", [False, True])
def test_residual_dp_need_patterns_match_plain(dev, need, n, R, dp_pad,
                                               band, packed):
    """Every slot needed, none, one; slot counts 2n that are not a
    multiple of the block's 8 warps; R not a multiple of 32; the full DP
    (CPL 6 at W 182); windows on both reference edges."""
    ref, r1, r2, p1, p2, n1, n2 = _dp_world(dev, n, R, dp_pad, need,
                                            seed=n + R)
    ref_in = pack_2bit(ref) if packed else ref
    args = (ref_in, r1, r2, p1, p2, n1, n2, dp_pad)
    got = residual_pair_dp(*args, band=band, packed_ref=packed,
                           backend="cuda")
    want = residual_pair_dp(*args, band=band, packed_ref=packed,
                            backend="torch")
    _same(got, want, f"need={need} n={n} R={R} band={band}")
    assert int(got.dp_lanes) == int(n1.sum() + n2.sum())


def test_residual_dp_other_scoring_matches_plain(dev):
    ref, r1, r2, p1, p2, n1, n2 = _dp_world(dev, 40, 150, 16, "random", 5)
    sc = Scoring(match=1, mismatch=4, gap_open=6, gap_extend=1)
    for band in (10, None):
        got = residual_pair_dp(ref, r1, r2, p1, p2, n1, n2, 16, band=band,
                               scoring=sc, backend="cuda")
        want = residual_pair_dp(ref, r1, r2, p1, p2, n1, n2, 16, band=band,
                                scoring=sc, backend="torch")
        _same(got, want, f"band={band}")


def test_residual_dp_refuses_rows_past_the_warp_kernel(dev):
    ref = torch.zeros(3000, dtype=torch.uint8, device=dev)
    reads = torch.zeros((2, 1000), dtype=torch.uint8, device=dev)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    need = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="columns"):
        residual_pair_dp(ref, reads, reads, pos, pos, need, need, 16,
                         backend="cuda")


def test_cuda_backend_rejects_cpu_tensors():
    ref = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        candidate_pair_align(ref, ref[None, :50], ref[None, :50],
                             torch.zeros((1, 2), dtype=torch.int32),
                             torch.zeros((1, 2), dtype=torch.int32), 4,
                             backend="cuda")


@pytest.mark.parametrize("packed", [False, True])
def test_mapper_kernels_match_plain_mapper(dev, packed):
    rng = np.random.default_rng(2)
    ref = random_reference(200_000, rng)
    sim = simulate_pairs(ref, 300, ReadSimConfig(sub_rate=0.02), seed=4)
    cfg = PipelineConfig(packed_ref=packed)
    kern = Mapper.build(ref, SeedMapConfig(table_bits=18), cfg,
                        ExecutionConfig(device="cuda"))
    plain = Mapper.from_index(kern.index, torch.as_tensor(ref), cfg,
                              ExecutionConfig(device="cuda",
                                              backend="torch"))
    _cuda.reset_launches()
    got = kern.map(sim.reads1, sim.reads2)
    torch.cuda.synchronize()
    assert _cuda.launch_counts() == {**dict.fromkeys(PAIR_KERNELS, 1),
                                     **dict.fromkeys(LONG_ONLY, 0),
                                     **dict.fromkeys(MESH_ONLY, 0),
                                     **dict.fromkeys(BLOCK_KERNELS, 0),
                                     **dict.fromkeys(LM_KERNELS, 0)}
    want = plain.map(sim.reads1, sim.reads2)
    _same(got, want, f"packed={packed}")


PAIR_KERNELS = ("seed_buckets", "pair_frontend", "candidate_align",
                "residual_dp")
LONG_KERNELS = ("seed_buckets", "pair_frontend", "location_vote",
                "banded_sw")
LONG_ONLY = ("location_vote", "banded_sw")
MESH_ONLY = ("merge_filter",)
BLOCK_KERNELS = ("light_align", "xxhash32", "seed_gather")
LM_KERNELS = ("flash_attention",)


@pytest.mark.parametrize("M,vote_bin", [(6, 64), (33, 128), (256, 64),
                                        (256, 1), (1000, 32), (257, 64),
                                        (4096, 64), (12_288, 64)])
def test_location_vote_matches_plain(dev, M, vote_bin):
    rng = np.random.default_rng(M + vote_bin)
    diag = rng.integers(-400, 4000, (50, M)).astype(np.int32)
    diag[rng.random((50, M)) < 0.4] = INVALID_LOC
    diag[0] = INVALID_LOC                                  # all invalid
    diag[1] = INVALID_LOC
    diag[1, :4] = [300, 300, 100, 100]                     # tie
    diag[2] = INVALID_LOC
    diag[2, :4] = [-1, -1, -1, 50]                         # floored bin -1
    diag[3] = rng.integers(-(2**31), -(2**31) + 4096, M)   # far negative
    d = torch.as_tensor(diag, device=dev)
    got = location_vote(d, vote_bin, backend="cuda")
    want = location_vote(d, vote_bin, backend="torch")
    _same(got, want, f"M={M} bin={vote_bin}")
    assert got.votes[0].item() == 0 and got.win_bin[0].item() == 0
    if vote_bin == 64:
        assert got.win_bin[1].item() == 1 and got.votes[1].item() == 2
        assert got.win_bin[2].item() == -1 and got.votes[2].item() == 3
    # rows 60 % valid, a row whose valid slots all share one bin, and the
    # same rows 4 bytes into their buffer (16-byte loads off, scalar on)
    dense = rng.integers(-400, 4000, (40, M)).astype(np.int32)
    dense[rng.random((40, M)) >= 0.6] = INVALID_LOC
    dense[0] = np.where(dense[0] == INVALID_LOC, INVALID_LOC,
                        vote_bin * 7 + rng.integers(0, vote_bin, M))
    buf = torch.as_tensor(np.concatenate([np.zeros(1, np.int32),
                                          dense.reshape(-1)]), device=dev)
    for d in (torch.as_tensor(dense, device=dev), buf[1:].view(40, M)):
        got = location_vote(d, vote_bin, backend="cuda")
        _same(got, location_vote(d, vote_bin, backend="torch"),
              f"60 % valid M={M}")
        assert got.win_bin[0].item() == 7
        assert got.votes[0].item() == int((dense[0] != INVALID_LOC).sum())


def test_location_vote_rejects_rows_past_shared_memory(dev):
    d = torch.zeros((2, 12_289), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        location_vote(d, 64, backend="cuda")


@pytest.mark.parametrize("b,r,w,band", [
    *(pytest.param(70, 150, 278, band, id=str(band))
      for band in (0, 16, 40, 278, None)),
    (2048, 150, 278, 40),              # the long lane's shape (CPL 3)
    # windows shorter than the read: the centre floors, the first and last
    # rows' slice start wraps or clamps as repro's does
    (64, 150, 149, 16), (64, 150, 147, 8), (64, 150, 145, 3),
    (64, 40, 37, 2), (64, 40, 35, 10),
    # rows wider than the warp kernel covers: the one-thread kernel
    (16, 150, 1100, None), (16, 150, 1100, 600),
    # long reads: 4 warps a block, then staging past 48 KB (one-thread)
    (8, 5000, 5100, 40), (4, 30_000, 30_100, 40),
])
def test_banded_sw_matches_plain(dev, b, r, w, band):
    rng = np.random.default_rng(band or 5)
    win = rng.integers(0, 4, (b, w), np.uint8)
    read = rng.integers(0, 4, (b, r), np.uint8)
    m = min(60, r // 2)                            # a 2-base mismatch at m
    for i in range(1, b, 2):                       # copies at many offsets
        s = int(rng.integers(0, abs(w - r) + 1))
        if w >= r:
            read[i] = win[i, s:s + r]
        else:
            read[i, s:s + w] = win[i]
        read[i, m:m + 2] = (read[i, m:m + 2] + 1) % 4
    if w >= r + 63:
        read[3, :70] = win[3, 60:130]              # a 3-base deletion
        read[3, 70:] = win[3, 133:133 + r - 70]
    t = (lambda x: torch.as_tensor(x, device=dev))
    for sc in (Scoring(), Scoring(match=2, mismatch=3, gap_open=4,
                                  gap_extend=1)):
        got = banded_sw(t(read), t(win), sc, band, backend="cuda")
        want = banded_sw(t(read), t(win), sc, band, backend="torch")
        _same(got, want, f"b={b} r={r} w={w} band={band} {sc}")


@pytest.mark.parametrize("packed", [False, True])
def test_map_long_kernels_match_plain_mapper(dev, packed):
    rng = np.random.default_rng(3)
    ref = random_reference(200_000, rng)
    reads, starts = simulate_long_reads(ref, 40, 3000, seed=6)
    reads[0] = ref[:3000]                                   # at the origin
    reads[1, 40:] = ref[:2960]                              # 40 bases early
    reads[2] = rng.integers(0, 4, 3000)                     # no vote
    cfg = PipelineConfig(packed_ref=packed)
    sm_cfg = SeedMapConfig(table_bits=18)
    kern = Mapper.build(ref, sm_cfg, cfg, ExecutionConfig(device="cuda"))
    plain = Mapper.build(ref, sm_cfg, cfg,
                         ExecutionConfig(device="cuda", backend="torch"))
    _cuda.reset_launches()
    got = kern.map_long(reads)
    torch.cuda.synchronize()
    assert _cuda.launch_counts() == {
        **dict.fromkeys(PAIR_KERNELS, 0), **dict.fromkeys(LONG_KERNELS, 1),
        **dict.fromkeys(MESH_ONLY, 0), **dict.fromkeys(BLOCK_KERNELS, 0),
        **dict.fromkeys(LM_KERNELS, 0)}
    want = plain.map_long(reads)                            # staged, CSR
    _same(got, want, f"packed={packed}")
    pos = got.position.cpu().numpy().astype(np.int64)
    assert got.mapped[3:].all() and not got.mapped[2]
    assert (np.abs(pos[3:] - starts[3:]) <= kern.lr_cfg.vote_bin).all()
    assert pos[1] == -64


def _merge_locs(dev, b, S, K, seed):
    """(b, S, K) locations per mate: random near the origin (negative
    starts), all-invalid rows and mates, duplicate-heavy rows, and
    locations near -2^31 whose starts wrap."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-40, 200, (2, b, S, K), generator=g, device=dev,
                      dtype=torch.int32)
    x[torch.rand(x.shape, generator=g, device=dev) < 0.3] = INVALID_LOC
    x[:, 0] = INVALID_LOC
    x[1, 1] = INVALID_LOC
    x[:, 2] = 60
    x[:, 3, :, : K // 2] = 5
    x[:, 4:8] = torch.randint(-(2**31), -(2**31) + 500, (2, 4, S, K),
                              generator=g, device=dev, dtype=torch.int32)
    return x[0], x[1]


@pytest.mark.parametrize("s,k,delta,c", [
    (1, 4, 30, 2), (2, 4, 0, 4), (3, 8, 30, 4), (3, 32, 500, 8),
    (2, 8, 5, 1), (3, 4, 60, 8),
])
def test_merge_filter_matches_plain(dev, s, k, delta, c):
    l1, l2 = _merge_locs(dev, 53, s, k, seed=10 * s + k + c)
    offs = tuple(int(x) for x in np.round(np.arange(s) * (150 - 50)
                                          / max(s - 1, 1)))
    got = frontend_merge_filter(l1, l2, offs, delta, c, backend="cuda")
    torch.cuda.synchronize()
    want = frontend_merge_filter(l1, l2, offs, delta, c, backend="torch")
    _same(got, want, f"S={s} K={k} delta={delta} C={c}")
    assert int(got.n_hits1[0]) == 0 and int(got.n[1]) == 0


def test_merge_filter_equals_pair_frontend_on_gathered_rows(dev):
    """Both kernels run merge_filter.cuh: locations gathered from the
    padded rows give pair_frontend's result."""
    rng = np.random.default_rng(4)
    T, K, S, B = 64, 8, 3, 40
    rows = rng.integers(-40, 300, (T, K)).astype(np.int32)
    rows[rng.random((T, K)) < 0.3] = INVALID_LOC
    rows = torch.as_tensor(rows, device=dev)
    buckets = torch.as_tensor(rng.integers(0, T, (2 * B, S)).astype(np.int32),
                              device=dev)
    offs = (0, 50, 100)
    locs = rows[buckets.long()]
    got = frontend_merge_filter(locs[:B], locs[B:], offs, 100, 4,
                                backend="cuda")
    want = frontend_from_buckets(rows, buckets, offs, 100, 4)
    _same(got, want, "merge_filter vs pair_frontend")


def test_merge_filter_rejects_rows_past_shared_memory(dev):
    """One warp holds 4*S*K ints of shared memory: S*K = 4,096 is past
    48 KB."""
    l1 = torch.zeros((2, 16, 256), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        frontend_merge_filter(l1, l1, tuple(range(16)), 30, 4,
                              backend="cuda")


def test_merge_filter_takes_rows_the_block_design_refused(dev):
    """S*K = 2,048 (8 KB of starts per mate) runs with one warp a block."""
    l1, l2 = _merge_locs(dev, 9, 16, 128, seed=3)
    offs = tuple(range(0, 160, 10))
    got = frontend_merge_filter(l1, l2, offs, 30, 4, backend="cuda")
    want = frontend_merge_filter(l1, l2, offs, 30, 4, backend="torch")
    _same(got, want, "S*K = 2048")


def _edge_locs(dev, b, S, K, seed):
    """(2, b, S, K) locations: random rows beside dense rows (every slot
    valid), all-invalid rows and mates, duplicate-heavy rows with many
    survivors, locations near +-2^31 (a start that wraps to INT_MAX, Δ
    targets that wrap) and starts near 0."""
    rng = np.random.default_rng(seed)
    M = S * K
    x = rng.integers(-40, 300, (2, b, M)).astype(np.int64)
    x[rng.random(x.shape) < 0.4] = INVALID_LOC
    x[:, 1::8] = rng.integers(0, 2000, x[:, 1::8].shape)     # dense
    x[:, 2] = INVALID_LOC                                    # no hits
    x[1, 3] = INVALID_LOC                                    # mate 2 empty
    x[:, 4::8] = np.arange(M) % 5 * 3                        # duplicates
    x[:, 5] = 7                                              # all equal
    x[:, 6] = rng.integers(-2**31, -2**31 + 300, (2, M))     # near -2^31
    x[:, 7] = rng.integers(2**31 - 300, 2**31 - 1, (2, M))   # near +2^31
    x[0, 6, 0] = -2**31 + 40 - 1    # seed 0 at offset 40: start INT_MAX
    return torch.as_tensor(x.astype(np.int32).reshape(2, b, S, K),
                           device=dev)


@pytest.mark.parametrize("s,k,delta,c", [
    (3, 32, 500, 8), (3, 4, 60, 1), (2, 8, 0, 4), (3, 32, 0, 1),
    (3, 24, 50, 40), (1, 4, 30, 8), (3, 32, 50, 1),
])
def test_merge_block_edge_rows_match_plain(dev, s, k, delta, c):
    """Both launch sites of merge_filter.cuh on the same edge rows: dense
    rows (h = M), more than 32 kept candidates with C = 1 and 40, K 4, 8,
    24 and 32 (M up to 96), Δ 0, wrapped starts and targets; 37 pairs, not
    a multiple of the block's 8 warps."""
    B = 37
    x = _edge_locs(dev, B, s, k, seed=s * k + delta + c)
    offs = (40, 80, 120)[:s]
    got = frontend_merge_filter(x[0], x[1], offs, delta, c, backend="cuda")
    want = frontend_merge_filter(x[0], x[1], offs, delta, c,
                                 backend="torch")
    _same(got, want, f"merge_filter S={s} K={k} delta={delta} C={c}")
    rows = x.reshape(2 * B * s, k)                  # one row per seed
    buckets = torch.arange(2 * B * s, dtype=torch.int32,
                           device=dev).reshape(2 * B, s)
    fe = frontend_from_buckets(rows, buckets, offs, delta, c)
    _same(fe, want, f"pair_frontend S={s} K={k} delta={delta} C={c}")
    if c == 1 and delta == 60:
        assert int(got.n[4]) == 1 and int(got.n_hits1[1]) == s * k


@pytest.fixture(scope="module")
def nccl_mesh(dev, tmp_path_factory):
    """A (1, 1) ("data", "model") CUDA mesh over a one-rank NCCL group."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shard_index", [True, False])
def test_one_rank_nccl_mesh_mapper_matches_replicated(dev, nccl_mesh,
                                                      shard_index):
    rng = np.random.default_rng(7)
    ref = random_reference(200_000, rng)
    sim = simulate_pairs(ref, 300, ReadSimConfig(sub_rate=0.02), seed=8)
    cfg = PipelineConfig(packed_ref=True)
    sm_cfg = SeedMapConfig(table_bits=18)
    repl = Mapper.build(ref, sm_cfg, cfg, ExecutionConfig(device="cuda"))
    mesh = Mapper.build(ref, sm_cfg, cfg, ExecutionConfig(
        device="cuda", mesh=nccl_mesh, shard_index=shard_index))
    assert mesh.device == torch.device("cuda", 0)
    _cuda.reset_launches()
    got = mesh.map(sim.reads1, sim.reads2)
    torch.cuda.synchronize()
    front = {"merge_filter": int(shard_index),
             "pair_frontend": int(not shard_index)}
    assert _cuda.launch_counts() == {
        **dict.fromkeys(PAIR_KERNELS, 1), **dict.fromkeys(LONG_ONLY, 0),
        **dict.fromkeys(BLOCK_KERNELS, 0), **dict.fromkeys(LM_KERNELS, 0),
        **front}
    _same(got, repl.map(sim.reads1, sim.reads2), f"shard={shard_index}")
    batches = [(sim.reads1, sim.reads2), (sim.reads1[:77], sim.reads2[:77])]
    assert mesh.map_stream(iter(batches)).totals == \
        repl.map_stream(iter(batches)).totals


# ------------------------------------------------- building-block kernels --
def _counted(name, fn):
    """fn() run once, with the check that it launched kernel ``name``."""
    before = _cuda.KERNELS[name].launches
    out = fn()
    torch.cuda.synchronize()
    assert _cuda.KERNELS[name].launches == before + 1, name
    return out


@pytest.mark.parametrize("n", [1, 127, 1000, 100_003])
@pytest.mark.parametrize("seed", [0, 99, 0xFFFFFFFF])
def test_xxhash32_matches_plain(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(n)
    w = torch.randint(0, 2**32, (n, 4), generator=g, device=dev,
                      dtype=torch.int64)
    w[0] = torch.tensor([0xFFFFFFFF, 0, 0x80000000, 0x7FFFFFFF])
    want = xxhash32(w, seed, backend="torch")
    for x in (w, w.to(torch.uint32), w.to(torch.uint32).view(torch.int32)):
        got = _counted("xxhash32", lambda: xxhash32(x, seed, backend="cuda"))
        assert got.dtype == torch.int64 and torch.equal(got, want)


def test_xxhash32_unaligned_and_multidim_words(dev):
    flat = torch.randint(-2**31, 2**31, (4 * 777 + 1,), device=dev,
                         dtype=torch.int32)
    w = flat[1:].reshape(7, 111, 4)                 # 4 bytes off alignment
    assert w.data_ptr() % 16
    got = xxhash32(w, 5, backend="cuda")
    assert tuple(got.shape) == (7, 111)
    assert torch.equal(got, xxhash32(w, 5, backend="torch"))
    assert xxhash32(w[:0], backend="cuda").shape == (0, 111)


@pytest.mark.parametrize("s,seed_len", [(3, 50), (2, 16), (1, 64)])
def test_xxhash32_masked_equals_seed_buckets(dev, s, seed_len):
    """Both kernels run xxhash.cuh: the seed words packed as
    core/seeding.py packs them, hashed and masked, are seed_buckets' ids."""
    rng = np.random.default_rng(s)
    r1 = torch.as_tensor(rng.integers(0, 4, (53, 150), np.uint8), device=dev)
    r2 = torch.as_tensor(rng.integers(0, 4, (53, 150), np.uint8), device=dev)
    words = pack_2bit(extract_seeds(torch.cat([r1, r2]), seed_len, s),
                      n_words=SEED_WORDS)
    got = xxhash32(words, 7, backend="cuda") & ((1 << 16) - 1)
    want = seed_buckets(r1, r2, seed_len, s, 7, 1 << 16)
    assert torch.equal(got.to(torch.int32), want)


def _la_world(dev, b, r, e, seed):
    rng = np.random.default_rng(seed)
    read = rng.integers(0, 4, (b, r), np.uint8)
    win = rng.integers(0, 4, (b, r + 2 * e), np.uint8)
    h = b // 2
    win[:h, e:e + r] = read[:h]                       # exact copies
    for i in range(h, h + b // 4):                    # one indel each
        if e == 0:
            break
        k = int(rng.integers(1, min(e, 5) + 1))
        p = int(rng.integers(1, r - k - 1))
        if i % 2:
            win[i, e:e + p] = read[i, :p]
            win[i, e + p + k:e + r + k] = read[i, p:]
        else:
            win[i, e:e + p] = read[i, :p]
            win[i, e + p:e + r - k] = read[i, p + k:]
    return (torch.as_tensor(read, device=dev),
            torch.as_tensor(win, device=dev))


@pytest.mark.parametrize("b,r,e", [(8, 150, 8), (33, 150, 4), (64, 100, 8),
                                    (300, 150, 2), (16, 64, 6), (3, 20, 0),
                                    (1, 150, 8), (77, 700, 8), (90, 150, 1),
                                    (70, 10, 8), (40, 1000, 8),
                                    (9, 300, 120)])
@pytest.mark.parametrize("mode", ["minsplit", "paper"])
def test_light_align_matches_plain(dev, b, r, e, mode):
    read, win = _la_world(dev, b, r, e, b * 1000 + r + e)
    want = light_align(read, win, e, mode=mode, backend="torch")
    for dtype in (torch.uint8, torch.int32):
        got = _counted("light_align", lambda: light_align(
            read.to(dtype), win.to(dtype), e, mode=mode, backend="cuda"))
        _same(got, want, f"b={b} r={r} e={e} {mode} {dtype}")
    sc = Scoring(match=2, mismatch=3, gap_open=4, gap_extend=1)
    _same(light_align(read, win, e, sc, threshold=40, mode=mode,
                      backend="cuda"),
          light_align(read, win, e, sc, threshold=40, mode=mode,
                      backend="torch"), f"scoring {sc}")
    # tandem repeats (ACAC... against the repeat shifted by 0 or 1: the
    # arg-min ties on many splits), all-mismatch rows, codes 0-255
    rng = np.random.default_rng(r + e)
    q = max(b // 3, 1)
    tr = np.arange(r) % 2
    tw = (np.arange(r + 2 * e) + rng.integers(0, 2, (q, 1))) % 2
    codes_r = rng.integers(0, 256, (q, r))
    codes_w = rng.integers(0, 256, (q, r + 2 * e))
    codes_w[::2, e:e + r] = codes_r[::2]
    edge_r = np.concatenate([np.broadcast_to(tr, (q, r)),
                             np.ones((q, r), np.int64), codes_r])
    edge_w = np.concatenate([tw, np.full((q, r + 2 * e), 3), codes_w])
    for dtype in (torch.uint8, torch.int32):
        er = torch.as_tensor(edge_r, device=dev).to(dtype)
        ew = torch.as_tensor(edge_w, device=dev).to(dtype)
        _same(light_align(er, ew, e, mode=mode, backend="cuda"),
              light_align(er, ew, e, mode=mode, backend="torch"),
              f"edge rows {dtype}")


def test_light_align_refuses_int32_bases_outside_uint8(dev):
    read, win = _la_world(dev, 4, 50, 2, 0)
    bad_read = read.to(torch.int32)
    bad_read[1, 3] = 256
    bad_win = win.to(torch.int32)
    bad_win[2, 7] = -1
    with pytest.raises(ValueError, match=r"\[0, 255\]"):
        light_align(bad_read, win, 2, backend="cuda")
    with pytest.raises(ValueError, match=r"\[0, 255\]"):
        light_align(read, bad_win, 2, backend="cuda")
    # the plain version compares the values as they are
    assert light_align(bad_read, bad_win, 2,
                       backend="torch").score.shape == (4,)


def test_light_align_rejects_rows_past_shared_memory(dev):
    read, win = _la_world(dev, 4, 1025, 8, 0)
    with pytest.raises(ValueError, match="1024 positions"):
        light_align(read, win, 8, backend="cuda")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["minsplit", "paper"])
def test_light_align_equals_candidate_align_per_mate(dev, packed, mode):
    """Both kernels run light_align.cuh: each mate aligned against the
    window candidate_align aligned at the slot it picked gives that mate's
    score, ok flag and CIGAR."""
    ref, r1, r2, p1, p2 = _cand_world(dev, seed=11)
    ref_in = pack_2bit(ref) if packed else ref
    pair = candidate_pair_align(ref_in, r1, r2, p1, p2, 8, mode=mode,
                                packed_ref=packed, backend="cuda")
    R = r1.shape[1]
    for reads, pos, score, ok, cigar in (
            (r1, pair.pos1, pair.score1, pair.ok1, pair.cigar1),
            (r2, pair.pos2, pair.score2, pair.ok2, pair.cigar2)):
        valid = pos != INVALID_LOC
        assert int(valid.sum()) > 5
        win = gather_windows(ref_in, pos, valid, R, 8, packed)
        la = light_align(reads[valid], win[valid], 8, mode=mode,
                         backend="cuda")
        assert torch.equal(la.score, score[valid])
        assert torch.equal(la.ok, ok[valid])
        assert torch.equal(cigar_ops(la.edit_type, la.edit_len,
                                     la.edit_pos, R), cigar[valid])


@pytest.mark.parametrize("t,cap,n", [(64, 16, 40), (128, 32, 128),
                                      (16, 8, 3), (1000, 7, 5000),
                                      (4096, 32, 100_000)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_seed_gather_matches_plain(dev, t, cap, n, dtype):
    g = torch.Generator(device=dev).manual_seed(t + cap + n)
    table = torch.randint(-1000, 1000, (t, cap), generator=g,
                          device=dev).to(dtype)
    ids = torch.randint(-2 * t, 2 * t, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    edges = torch.tensor([-1, -t, -t - 1, -2**31, t - 1, t, 2**31 - 1, 0])
    ids[:len(edges[:n])] = edges[:n]
    got = _counted("seed_gather",
                   lambda: seed_gather(table, ids, backend="cuda"))
    assert got.dtype == dtype
    assert torch.equal(got, seed_gather(table, ids, backend="torch"))


def test_seed_gather_out_of_range_rows_and_shapes(dev):
    table = torch.arange(16 * 8, device=dev, dtype=torch.int32).reshape(16, 8)
    ids = torch.tensor([-1, -16, -17, -100, 15, 16, 2**31 - 1, -2**31],
                       device=dev, dtype=torch.int32)
    got = seed_gather(table, ids, backend="cuda")
    assert (got[:, 0] // 8).tolist() == [15, 0, 0, 0, 15, 15, 15, 0]
    ids2 = ids.reshape(2, 4)
    assert torch.equal(seed_gather(table, ids2, backend="cuda"),
                       seed_gather(table, ids2, backend="torch"))
    flat = torch.arange(1 + 64 * 8, device=dev, dtype=torch.float32)
    unaligned = flat[1:].reshape(64, 8)            # the 4-byte copy path
    assert unaligned.data_ptr() % 16
    assert torch.equal(seed_gather(unaligned, ids, backend="cuda"),
                       seed_gather(unaligned, ids, backend="torch"))
    assert seed_gather(table, ids[:0], backend="cuda").shape == (0, 8)


def test_building_blocks_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        xxhash32(torch.zeros((3, 4), dtype=torch.int32), backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        light_align(torch.zeros((2, 20), dtype=torch.int32),
                    torch.zeros((2, 24), dtype=torch.int32), 2,
                    backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        seed_gather(torch.zeros((4, 8), dtype=torch.float32),
                    torch.zeros(3, dtype=torch.int32), backend="cuda")


# -------------------------------------------------------- flash_attention --
@pytest.mark.parametrize("dtype,bh,g,s,d,causal", [
    (torch.bfloat16, 16, 8, 2048, 128, True),    # yi-6b's shapes, BH cut
    (torch.float32, 16, 8, 2048, 128, True),
    (torch.bfloat16, 16, 8, 2000, 128, True),    # unaligned S, padded
    (torch.float32, 16, 8, 2000, 128, True),
    (torch.bfloat16, 16, 8, 2048, 128, False),
    (torch.float32, 8, 1, 1024, 128, False),
    (torch.bfloat16, 32, 1, 512, 80, True),      # stablelm's head width
    (torch.float32, 32, 1, 512, 80, True),
    (torch.bfloat16, 32, 4, 384, 64, True),
    (torch.float32, 32, 4, 384, 64, False),
    (torch.bfloat16, 3, 3, 128, 64, True),
    (torch.bfloat16, 4, 1, 128, 128, True),      # one K/V tile
    (torch.bfloat16, 4, 1, 128, 128, False),
    (torch.bfloat16, 16, 8, 2176, 128, True),    # an odd tile count
    (torch.bfloat16, 16, 1, 1024, 128, True),    # G 1 at D 128
    (torch.bfloat16, 16, 1, 1024, 128, False),
    (torch.bfloat16, 64, 8, 512, 128, False),    # G 8 at D 128
    (torch.bfloat16, 32, 1, 512, 80, False),     # D 80 padded to 128
    (torch.bfloat16, 32, 4, 640, 80, True),
    (torch.bfloat16, 64, 8, 512, 112, True),     # kimi-k2's, padded to 128
    (torch.float32, 64, 8, 512, 112, True),
    (torch.bfloat16, 16, 1, 256, 112, False),
    (torch.bfloat16, 8, 4, 256, 16, True),       # a smoke width, to 64
])
def test_flash_attention_matches_plain(dev, dtype, bh, g, s, d, causal):
    gen = torch.Generator(device=dev).manual_seed(bh * s + d)
    q = torch.randn((bh, s, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((bh // g, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((bh // g, s, d), generator=gen, device=dev).to(dtype)
    got = _counted("flash_attention",
                   lambda: flash_attention(q, k, v, causal, backend="cuda"))
    want = flash_attention(q, k, v, causal, backend="torch")
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_flash_attention_refuses_what_the_kernel_cannot_take(dev):
    q = torch.zeros((2, 128, 160), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head widths up to 128"):
        flash_attention(q, q, q, backend="cuda")
    q = torch.zeros((2, 128, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q, q, q, backend="cuda")
    q = torch.zeros((2, 128, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q, backend="cuda")


def test_lm_prefill_through_the_kernel_matches_plain(dev):
    """Two layers of yi-6b at full width: a 2 x 1,024-token prefill through
    the flash kernel against the plain-backend prefill."""
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=2,
                              use_flash_kernel=True)
    params = model_init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    batch = make_smoke_batch(cfg, 2, 1024, seed=1, device=dev)
    before = _cuda.KERNELS["flash_attention"].launches
    got, cache = prefill_step(params, batch, cfg, 1040)
    torch.cuda.synchronize()
    assert _cuda.KERNELS["flash_attention"].launches == before + 2
    want, want_cache = prefill_step(params, batch, cfg, 1040,
                                    backend="torch")
    assert got.shape == (2, cfg.vocab_size) and bool(got.isfinite().all())
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-2, rel
    assert cache.kv_k.shape == (2, 2, 1040, 4, 128) and cache.length == 1024


# ------------------------------------------------------- launch geometry --
# Every block the tuner may pick (its grid, plus 1 and each family's
# largest at these shapes) gives the plain version's result: a kernel
# whose output depended on how work splits across blocks would be a bug.
def _blocks(grid, top):
    return sorted({1, *grid, top})


@pytest.mark.parametrize("block", _blocks((4, 8, 16, 32), 32))
def test_pair_frontend_every_geometry_matches_plain(dev, block):
    rng = np.random.default_rng(block)
    T, B, S, K = 64, 301, 3, 32
    rows = rng.integers(-40, 400, (T, K)).astype(np.int32)
    rows[rng.random((T, K)) < 0.4] = INVALID_LOC
    rows = torch.as_tensor(rows, device=dev)
    buckets = torch.as_tensor(rng.integers(0, T, (2 * B, S)).astype(np.int32),
                              device=dev)
    offs = (0, 50, 100)
    want = frontend_from_buckets_ref(rows, buckets[:B], buckets[B:],
                                     torch.tensor(offs, device=dev), 60, 8)
    _same(frontend_from_buckets(rows, buckets, offs, 60, 8, block=block),
          want, f"block={block}")
    locs = rows[buckets.long()]
    _same(frontend_merge_filter(locs[:B], locs[B:], offs, 60, 8,
                                block=block, backend="cuda"),
          want, f"merge_filter block={block}")


@pytest.mark.parametrize("block", _blocks((16, 32, 48, 96),
                                          launch_shape(150, 166, 8).max_pairs))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("prescreen", [0, 4])
def test_candidate_align_every_geometry_matches_plain(dev, block, packed,
                                                      prescreen):
    ref, r1, r2, p1, p2 = _cand_kind_world(dev, "large", seed=block)
    ref_in = pack_2bit(ref) if packed else ref
    kw = dict(prescreen_top=prescreen, packed_ref=packed)
    want = candidate_pair_align(ref_in, r1, r2, p1, p2, 8, backend="torch",
                                **kw)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    base = torch.zeros(1, dtype=torch.int32, device=dev)
    got = candidate_pair_align(ref_in, r1, r2, p1, p2, 8, backend="cuda",
                               block=block, count=count, **kw)
    candidate_pair_align(ref_in, r1, r2, p1, p2, 8, backend="cuda",
                         count=base, **kw)
    _same(got, want, f"block={block} packed={packed} P={prescreen}")
    assert int(count) == int(base)


@pytest.mark.parametrize("block", _blocks((2, 4, 8), 8))
@pytest.mark.parametrize("band", [24, None])
@pytest.mark.parametrize("packed", [False, True])
def test_residual_dp_every_geometry_matches_plain(dev, block, band, packed):
    rng = np.random.default_rng(block)
    L, R, n, dp_pad = 5000, 150, 301, 16
    ref = rng.integers(0, 4, L, np.uint8)
    pos1 = rng.integers(-40, L + 10, n).astype(np.int32)
    pos2 = rng.integers(0, L - R, n).astype(np.int32)
    reads = rng.integers(0, 4, (2, n, R), np.uint8)
    need = rng.random((2, n)) < 0.5
    t = (lambda x: torch.as_tensor(x, device=dev))
    ref_in = pack_2bit(t(ref)) if packed else t(ref)
    args = (ref_in, t(reads[0]), t(reads[1]), t(pos1), t(pos2), t(need[0]),
            t(need[1]), dp_pad)
    want = residual_pair_dp(*args, band=band, packed_ref=packed,
                            backend="torch")
    _same(residual_pair_dp(*args, band=band, packed_ref=packed,
                           backend="cuda", block=block), want,
          f"block={block} band={band} packed={packed}")


@pytest.mark.parametrize("M,block", [
    *((256, b) for b in _blocks((4, 8, 16, 32), 32)),
    *((1000, b) for b in (1, 4, 8, 12)),       # 12 warps fill 48 KB
])
def test_location_vote_every_geometry_matches_plain(dev, M, block):
    rng = np.random.default_rng(block + M)
    diag = rng.integers(-400, 4000, (301, M)).astype(np.int32)
    diag[rng.random((301, M)) < 0.5] = INVALID_LOC
    d = torch.as_tensor(diag, device=dev)
    _same(location_vote(d, 64, block=block, backend="cuda"),
          location_vote(d, 64, backend="torch"), f"block={block} M={M}")


def test_geometry_past_the_limits_raises_before_launch(dev):
    d = torch.zeros((4, 12_288), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="1..1 warps"):
        location_vote(d, 64, block=2, backend="cuda")
    ref, r1, r2, p1, p2 = _cand_world(dev)
    with pytest.raises(ValueError, match="pairs a block"):
        candidate_pair_align(ref, r1, r2, p1, p2, 8,
                             block=launch_shape(150, 166, 8).max_pairs + 1,
                             backend="cuda")


# ------------------------------------------------------------ LM training --
@pytest.mark.parametrize("codec,grad_accum", [("none", 1), ("int8", 2)])
def test_train_step_on_the_card_matches_the_cpu(dev, codec, grad_accum):
    """One `make_train_step` of stablelm-3b's smoke config in float32 (256
    positions: the blockwise route) on the card and on the CPU from the
    same parameters and batch: the loss within 1e-5 and the grad norm
    within 1e-4 relative (float32 sums in other orders), and each leaf's
    update within 1e-3 of its L2 norm (AdamW's first update is
    ~lr * g / (|g| + eps): only entries with a gradient within a few eps of
    0, or an int8 rounding boundary, can move)."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              dtype="float32")
    run = train_mod.TrainRunConfig(arch="stablelm-3b", seq_len=256,
                                   global_batch=4, grad_accum=grad_accum,
                                   warmup_steps=0, device="cuda")
    opt_cfg = adamw.OptConfig(lr=run.peak_lr)
    ccfg = CompressConfig(codec=codec)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                      global_batch=4, seed=3)
    start = model_init_params(cfg, torch.Generator().manual_seed(4),
                              device="cpu")
    out = {}
    for where in ("cuda", "cpu"):
        params = tree_map(lambda t: t.clone().to(where), start)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        step_fn = train_mod.make_train_step(cfg, opt_cfg, run, ccfg)
        params, _, _, m = step_fn(params, adamw.init(params, opt_cfg),
                                  init_state(params, ccfg),
                                  batch_for_step(data, cfg, 0, where), 0)
        out[where] = ({k: v.item() for k, v in m.items()},
                      [p.detach().cpu() for p in tree_leaves(params)])
    (mg, pg), (mc, pc) = out["cuda"], out["cpu"]
    assert mg["loss"] == pytest.approx(mc["loss"], rel=1e-5)
    assert mg["gnorm"] == pytest.approx(mc["gnorm"], rel=1e-4)
    for a, b, s0 in zip(pg, pc, tree_leaves(start)):
        assert torch.isfinite(a).all()
        assert ((a - s0) - (b - s0)).norm() <= 1e-3 * (b - s0).norm()


def test_flash_attention_refuses_autograd_on_the_card(dev):
    q, k, v = (torch.randn((4, 256, 64), device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    _cuda.reset_launches()
    for t in (q, k, v):
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(q, k, v)
        t.requires_grad_(False)
    assert _cuda.launch_counts()["flash_attention"] == 0
    with torch.no_grad():
        q.requires_grad_(True)
        flash_attention(q, k, v)       # no graph: the kernel runs
    assert _cuda.launch_counts()["flash_attention"] == 1
