"""The traffic generator: the same seed gives the same inputs, and its
error, insert and foreign-read statistics are those its traffic file
states, within sampling error."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import generate as G  # noqa: E402

CPU = torch.device("cpu")
BIG_SEED = 2**31 + 977


def _genome(seed=BIG_SEED, n=1 << 20):
    return G.random_genome(n, G.generator(seed, 1, CPU), CPU)


def test_same_seed_same_inputs_other_seed_others():
    lib = G.Library(150, 300, 30, 0.001, 0.0002, 0.0002, 0.5)
    ref, foreign = _genome(), _genome(BIG_SEED + 1)
    a = G.batch(ref, foreign, 512, lib, G.generator(BIG_SEED, 16, CPU))
    b = G.batch(_genome(), _genome(BIG_SEED + 1), 512, lib,
                G.generator(BIG_SEED, 16, CPU))
    c = G.batch(ref, foreign, 512, lib, G.generator(BIG_SEED + 7, 16, CPU))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert G.stream_seed(BIG_SEED, 1) != G.stream_seed(BIG_SEED, 2)
    assert 0 <= G.stream_seed(2**40, 3) < 2**63


def test_substitutions_and_insert_sizes_match_the_file():
    n, R, rate = 20_000, 150, 0.01
    ref = _genome()
    lib = G.Library(R, 300, 30, rate, 0.0, 0.0)
    r1, r2, start, insert, _ = G.batch(ref, None, n, lib,
                                       G.generator(5, 16, CPU))
    truth1 = ref[start[:, None] + torch.arange(R)]
    truth2 = ref[(start + insert - R)[:, None] + torch.arange(R)]
    got = (torch.cat([(r1 != truth1), ((3 - r2).flip(-1) != truth2)])
           .double().mean().item())
    sd = math.sqrt(rate * (1 - rate) / (2 * n * R))
    assert abs(got - rate) < 5 * sd
    mean, std = insert.double().mean().item(), insert.double().std().item()
    assert abs(mean - 300) < 5 * 30 / math.sqrt(n)
    assert abs(std - 30) < 1.5
    assert int(insert.min()) >= R


def test_indels_emit_whole_reads_at_the_stated_rate():
    n, R, rate = 20_000, 150, 0.01
    ref = _genome()
    # deletions only: a read with none equals the genome from its start
    lib = G.Library(R, 300, 30, 0.0, 0.0, rate)
    r1, *_rest = G.batch(ref, None, n, lib, G.generator(6, 16, CPU))
    start = _rest[1]
    exact = (r1 == ref[start[:, None] + torch.arange(R)]).all(1)
    p_exact = (1 - rate) ** R      # R copy steps before the last emit
    got = exact.double().mean().item()
    assert abs(got - p_exact) < 5 * math.sqrt(p_exact * (1 - p_exact) / n)
    assert r1.shape == (n, R) and r1.dtype == torch.uint8
    assert int(r1.max()) <= 3


@pytest.mark.parametrize("share", [0.0, 0.8])
def test_foreign_share_is_exact(share):
    lib = G.Library(150, 300, 30, 0.001, 0.0002, 0.0002, share)
    *_, mask = G.batch(_genome(), _genome(3), 1000, lib,
                       G.generator(9, 16, CPU))
    assert int(mask.sum()) == round(share * 1000)
