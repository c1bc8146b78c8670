"""repro_torch's residual DP fallback (step 5) against repro's on the CPU,
exact equality: banded (band edges included) and band >= W, both
reference flavors, windows on the reference edges, zero-item and
all-item batches, and the plain Gotoh recurrences themselves."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.dp_fallback import gotoh_semiglobal as j_gotoh
from repro.core.dp_fallback import gotoh_semiglobal_banded as j_banded
from repro.core.encoding import pack_2bit as j_pack
from repro.core.scoring import Scoring as JScoring
from repro.kernels.residual_dp import residual_pair_dp as j_residual
from repro_torch.core.dp_fallback import (
    NEG,
    gotoh_semiglobal,
    gotoh_semiglobal_banded,
)
from repro_torch.core.encoding import pack_2bit
from repro_torch.core.scoring import Scoring
from repro_torch.core.seedmap import INVALID_LOC
from repro_torch.kernels.residual_dp.ops import residual_pair_dp

L, R = 5000, 100
FIELDS = ("score1", "ref_end1", "score2", "ref_end2", "dp_lanes")


def _world(n, seed, need_rate=0.6, edges=False):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L, np.uint8)
    pos1 = rng.integers(0, L - R - 32, n).astype(np.int32)
    pos2 = rng.integers(0, L - R - 32, n).astype(np.int32)
    need1 = rng.random(n) < need_rate
    need2 = rng.random(n) < need_rate
    pos1[0] = pos2[0] = INVALID_LOC             # row with no candidate
    if edges:                                    # windows on the edges
        e = np.array([-3, -40, -(R + 50), 0, 2, L - 1, L + 7, L + 500],
                     np.int32)[:n - 1]
        pos1[1:len(e) + 1] = e
        pos2[1:len(e) + 1] = e[::-1]
    reads1 = rng.integers(0, 4, (n, R), np.uint8)
    reads2 = rng.integers(0, 4, (n, R), np.uint8)
    for i in range(1, n, 2):                     # noisy copies of windows
        if 0 <= pos1[i] < L - R:
            reads1[i] = ref[pos1[i]:pos1[i] + R]
            reads1[i, 30:33] = 1
        if 0 <= pos2[i] < L - R:
            reads2[i, :50] = ref[pos2[i]:pos2[i] + 50]
            reads2[i, 50:] = ref[pos2[i] + 53:pos2[i] + R + 3]
    return ref, reads1, reads2, pos1, pos2, need1, need2


def _check(world, dp_pad, band, packed, scoring=Scoring()):
    ref, r1, r2, p1, p2, n1, n2 = world
    jref = j_pack(jnp.asarray(ref)) if packed else jnp.asarray(ref)
    want = j_residual(jref, *(jnp.asarray(x) for x in (r1, r2, p1, p2, n1,
                                                         n2)),
                      dp_pad, band=band, packed_ref=packed, backend="jnp",
                      scoring=JScoring(**dataclasses.asdict(scoring)))
    tref = pack_2bit(torch.as_tensor(ref)) if packed else torch.as_tensor(ref)
    got = residual_pair_dp(tref, *(torch.as_tensor(x) for x in (r1, r2, p1,
                                                                 p2, n1, n2)),
                           dp_pad, band=band, packed_ref=packed,
                           scoring=scoring)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            err_msg=f"{f} dp_pad={dp_pad} band={band} packed={packed}")
    return got


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("band", [1, 4, 24, 131, 132, None])
def test_residual_dp_matches_repro(packed, band):
    """band 131 is the last banded width below W = 132; 132 is band >= W."""
    _check(_world(12, seed=band or 7), 16, band, packed)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("band", [2, 24, None])
def test_windows_on_reference_edges(packed, band):
    _check(_world(9, seed=31, edges=True, need_rate=1.0), 8, band, packed)


def test_zero_and_all_items():
    world = list(_world(8, seed=12))
    world[5] = world[6] = np.zeros(8, bool)
    got = _check(tuple(world), 12, 24, False)
    assert int(got.dp_lanes) == 0 and (got.score1.numpy() == NEG).all()
    world[5] = world[6] = np.ones(8, bool)
    got = _check(tuple(world), 12, 24, True)
    assert int(got.dp_lanes) == 16


def test_other_scoring():
    _check(_world(8, seed=3), 16, 10, False,
           scoring=Scoring(match=1, mismatch=4, gap_open=6, gap_extend=1))


@pytest.mark.parametrize("b,r,w,band", [(8, 150, 182, 24), (5, 40, 56, 3),
                                        (3, 100, 132, None), (4, 30, 30, 2)])
def test_gotoh_recurrences_match_repro(b, r, w, band):
    rng = np.random.default_rng(r + w)
    read = rng.integers(0, 4, (b, r), np.uint8)
    win = rng.integers(0, 4, (b, w), np.uint8)
    win[0, (w - r) // 2:(w - r) // 2 + r] = read[0]
    for jfn, tfn in ((lambda a, c: j_banded(a, c, band),
                      lambda a, c: gotoh_semiglobal_banded(a, c, band)),
                     (j_gotoh, gotoh_semiglobal)):
        want = jfn(jnp.asarray(read), jnp.asarray(win))
        got = tfn(torch.as_tensor(read), torch.as_tensor(win))
        np.testing.assert_array_equal(got.score.numpy(),
                                      np.asarray(want.score))
        np.testing.assert_array_equal(got.ref_end.numpy(),
                                      np.asarray(want.ref_end))
