"""repro_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Every comparison is exact equality (all integer arithmetic).

Run on a machine with an NVIDIA GPU and nvcc:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
Elsewhere every test skips (decided inside the `dev` fixture).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.encoding import pack_2bit
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import INVALID_LOC, SeedMapConfig
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, Mapper
from repro_torch.kernels import _cuda
from repro_torch.kernels.candidate_align.ops import candidate_pair_align
from repro_torch.kernels.pair_frontend.ops import (
    frontend_from_buckets,
    seed_buckets,
)
from repro_torch.kernels.pair_frontend.ref import (
    frontend_from_buckets_ref,
    seed_buckets_ref,
)
from repro_torch.kernels.residual_dp.ops import residual_pair_dp

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


@pytest.mark.parametrize("s,k,seed_len", [(3, 32, 50), (2, 8, 16),
                                          (1, 4, 64)])
def test_seed_buckets_matches_plain(dev, s, k, seed_len):
    rng = np.random.default_rng(s)
    r1 = torch.as_tensor(rng.integers(0, 4, (37, 150), np.uint8), device=dev)
    r2 = torch.as_tensor(rng.integers(0, 4, (37, 150), np.uint8), device=dev)
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


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["minsplit", "paper"])
@pytest.mark.parametrize("prescreen", [0, 1, 4, 8])
def test_candidate_align_matches_plain(dev, packed, mode, prescreen):
    ref, r1, r2, p1, p2 = _cand_world(dev, seed=prescreen)
    ref_in = pack_2bit(ref) if packed else ref
    kw = dict(mode=mode, prescreen_top=prescreen, packed_ref=packed)
    got = candidate_pair_align(ref_in, r1, r2, p1, p2, 8, backend="cuda",
                               **kw)
    want = candidate_pair_align(ref_in, r1, r2, p1, p2, 8, backend="torch",
                                **kw)
    _same(got, want, f"packed={packed} mode={mode} P={prescreen}")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("band", [2, 24, None])
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
    assert all(v == 1 for v in _cuda.launch_counts().values())
    want = plain.map(sim.reads1, sim.reads2)
    _same(got, want, f"packed={packed}")
