"""The frozen roofline formulas against values worked out by hand, and
the share the per-layer metrics report."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.manifest import _load_reader  # noqa: E402
from portbench.roofline import share_pct, work  # noqa: E402

METRICS = ROOT / "portbench" / "metrics"


def test_peaks():
    assert work.HBM_BYTES_PER_S == 3.35e12
    assert work.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)


def test_seed_buckets_by_hand():
    # 2 mates x 4 pairs x 150 bases read, 2 x 4 x 3 ids of 4 bytes written;
    # each of the 24 seeds: 100 packing operations + 40 for the hash
    w = work.seed_buckets(4, 150, 3, 50)
    assert w == (1200 + 96, 24 * 140)


def test_pair_frontend_by_hand():
    # one pair, S 3, K 32, C 8; mate 1 with 4 hits, mate 2 with 1
    w = work.pair_frontend(1, 3, 32, 8, [4], [1])
    assert w.bytes == 24 + 768 + 76
    merge = 2 * 4 * 2 + 2 * 1 * 1 + 2 * 4 * 1 + 12 * 4
    assert w.ops == pytest.approx(192 + merge)


def test_candidate_align_by_hand():
    # two pairs: 3 candidates and none (which aligns one window anyway)
    w = work.candidate_align(2, 150, 8, 8, [3, 0])
    n_align = 2 * (3 + 1)
    win = (166 // 16 + 2) * 4
    assert w.bytes == 600 + 128 + n_align * win + 96
    assert w.ops == n_align * 150 * 17 * 6


def test_residual_dp_by_hand():
    w = work.residual_dp(4, 150, 182, 24, 3)
    assert w.bytes == 3 * (150 + (182 // 16 + 2) * 4) + 4 * 26
    assert w.ops == 3 * 150 * 49 * 14


def test_bound_takes_the_larger_term():
    assert work.bound_s(work.Work(3.35e12, 0)) == pytest.approx(1.0)
    assert work.bound_s(work.Work(0, work.INT32_OPS_PER_S * 2)) == \
        pytest.approx(2.0)


def test_share_and_readers():
    run = {"trace": {"kernels": {"seed_buckets": {"seconds": 4e-3,
                                                  "count": 4},
                                 "pair_frontend": {"seconds": 2e-3,
                                                   "count": 1},
                                 "candidate_align": {"seconds": 0.0,
                                                     "count": 0}},
                     "busy_s": 0.5, "window_s": 2.0, "batches": 10},
           "bounds": {"seed_buckets": 1e-4, "pair_frontend": 2e-4,
                      "candidate_align": 1e-4},
           "window": {"host_s": 0.3, "host_intervals": 30}}
    # (1e-4 + 2e-4) / (1e-3 + 2e-3)
    assert share_pct(run, ("seed_buckets", "pair_frontend")) == \
        pytest.approx(10.0)
    assert share_pct(run, ("candidate_align",)) is None
    assert share_pct({"trace": None}, ("seed_buckets",)) is None
    read = {p.stem: _load_reader(p).read for p in METRICS.glob("*.py")}
    assert read["frontend_roofline"](run) == pytest.approx(10.0)
    assert read["candidate_align_roofline"](run) is None
    assert read["residual_dp_roofline"](run) is None
    assert read["device_idle_pct"](run) == pytest.approx(75.0)
    assert read["device_ms_per_batch"](run) == pytest.approx(50.0)
    assert read["host_ms_per_batch"](run) == pytest.approx(10.0)
    assert read["device_idle_pct"]({"trace": None}) is None


def test_merge_ops_matches_the_scalar_formula():
    h1, h2 = np.array([0, 1, 7, 30]), np.array([5, 0, 9, 2])
    want = sum(2 * a * math.log2(max(a, 2)) + 2 * b * math.log2(max(b, 2))
               + 2 * a * math.log2(max(b, 2)) + 12 * a
               for a, b in zip(h1, h2))
    assert work.merge_ops(h1, h2) == pytest.approx(want)
