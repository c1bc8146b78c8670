"""repro_torch's residual DP fallback (step 5) against repro's on the CPU,
exact equality: banded (band edges included) and band >= W, both
reference flavors, windows on the reference edges, zero-item and
all-item batches, the plain Gotoh recurrences themselves, and a numpy
model of the CUDA kernel's warp recurrence (lane-split slots and scan)."""
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
from repro_torch.kernels._util import lane_slots
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


def _shfl_up(x, d, fill):
    """x (B, 32) per lane -> lane l gets lane l - d (``fill`` below d: the
    kernel's lanes < d keep their own value and ignore it)."""
    out = np.full_like(x, fill)
    out[:, d:] = x[:, :-d]
    return out


def _row_start(s, W):
    """csrc/gotoh.cuh's slice start of a banded row whose unclamped start
    is ``s``: W + 1 where repro's `dynamic_slice_in_dim` wraps or clamps
    it (a start below -2*band wraps into [0, W + 1], but such a row has no
    cell in [0, W], so W + 1 serves it as well)."""
    return W + 1 if s < 0 or s > W + 1 else s


def _warp_stage(R, W, band, cpl):
    """csrc/gotoh.cuh::gotoh_warp_stage: ``(left, bytes)`` of a staged
    window (W bases from byte ``left``, zero pads around them)."""
    c = (W - R) // 2
    if band is None or band >= W:
        lo, hi = -1, 32 * cpl - 2
    else:
        lo = max(c + 1, 0) - band - 1
        hi = (W + 1 if c + 1 < 0 else min(R + c, W + 1)) - band \
            + 32 * cpl - 2
    left = -lo if lo < 0 else 0
    return left, (left + max(hi + 1, W) + 3) & ~3


def _warp_dp_model(read, win, band, sc):
    """numpy model of csrc/gotoh.cuh::gotoh_dp_warp: 32 lanes own CPL
    contiguous frame slots each; neighbours cross a lane edge as one
    shuffle; the horizontal gap is an in-lane running max, a 32-lane
    inclusive max-scan of the lane totals, then the exclusive shift.  The
    banded rows whose frame lies inside [1, W] skip the column tests and
    leave the slots past the frame unmasked, as the kernel does; the
    frame's last slot takes NEG from the row above in their place.  The
    window is read from its staged bytes (`_warp_stage`, pads 0) at the
    kernel's row start (`_row_start`); every index read must fall inside
    them, and the first and last rows' substitution counts a match only
    inside [0, W)."""
    B, R = read.shape
    W = win.shape[1]
    full = band is None or band >= W
    cols = W + 1 if full else 2 * band + 1
    cpl = lane_slots(cols)
    n = 32 * cpl
    k = np.arange(n)
    c = (W - R) // 2
    op, ext = sc.gap_open, sc.gap_extend
    first = op + ext
    j0 = k if full else c - band + k
    H = np.broadcast_to(np.where((k < cols) & (j0 >= 0) & (j0 <= W), 0, NEG),
                        (B, n)).astype(np.int64)
    E = np.full((B, n), NEG, np.int64)
    left, nbytes = _warp_stage(R, W, None if full else band, cpl)
    staged = np.zeros((B, nbytes), np.int64)
    staged[:, left:left + W] = win
    i_head = R if full else min(R, max(0, band - c))
    i_tail = R if full else max(i_head, min(R, W - c - band))
    for i in range(R):
        rb = read[:, i:i + 1].astype(np.int64)
        if full:
            e = np.maximum(H - first, E - ext)
            diag = np.concatenate([np.zeros((B, 1), np.int64), H[:, :-1]], 1)
            idx = k - 1
            assert 0 <= left + idx.min() and left + idx.max() < nbytes
            wb = staged[:, left + idx]
            v = np.maximum(diag + np.where(rb == wb, sc.match, -sc.mismatch),
                           e)
            v[:, 0] = -(op + ext * (i + 1))
            valid = k <= W
        else:
            up_h = np.concatenate([H[:, 1:], np.full((B, 1), NEG)], 1)
            up_e = np.concatenate([E[:, 1:], np.full((B, 1), NEG)], 1)
            up_h[:, k + 1 >= cols] = NEG
            up_e[:, k + 1 >= cols] = NEG
            e = np.maximum(up_h - first, up_e - ext)
            jcol = i + 1 + c - band + k
            check = not i_head <= i < i_tail
            idx = (_row_start(i + c + 1, W) if check else i + c + 1) \
                - band - 1 + k
            assert 0 <= left + idx.min() and left + idx.max() < nbytes
            wb = staged[:, left + idx]
            if check:
                wb = np.where((idx >= 0) & (idx < W), wb, -1)
            v = np.maximum(H + np.where(rb == wb, sc.match, -sc.mismatch), e)
            if check:
                v[:, jcol == 0] = -(op + ext * (i + 1))
                valid = (k < cols) & (jcol >= 0) & (jcol <= W)
            else:                       # every frame slot in [1, W]; slots
                valid = np.ones(n, bool)    # past the frame left unmasked
        v = np.where(valid, v, NEG)
        E = e
        # the lane-split scan
        g = (v + ext * k).reshape(B, 32, cpl)
        run = np.maximum.accumulate(g, axis=2)
        scan = run[:, :, -1].copy()
        d = 1
        while d < 32:
            scan = np.maximum(scan, _shfl_up(scan, d, np.iinfo(np.int64).min))
            d *= 2
        before = _shfl_up(scan, 1, NEG)[:, :, None]
        pre = np.concatenate([before, np.maximum(before, run[:, :, :-1])], 2)
        pre[:, 0, 1:] = run[:, 0, :-1]
        f = pre.reshape(B, n) - op - ext * k
        H = np.where(valid, np.maximum(v, f), NEG)
    last = np.where(k < cols, H, np.iinfo(np.int64).min)
    arg = np.argmax(last, axis=1)
    score = last[np.arange(B), arg]
    return score, (arg if full else R + c - band + arg), H[:, :cols]


def _sequential_last_row(read, win, band, sc):
    """The last DP row as csrc/gotoh.cuh::gotoh_dp computes it: the
    horizontal gap's running max taken slot by slot along each row, the
    window read at the row start of `_row_start`."""
    B, R = read.shape
    W = win.shape[1]
    full = band is None or band >= W
    cols = W + 1 if full else 2 * band + 1
    c = (W - R) // 2
    op, ext = sc.gap_open, sc.gap_extend
    first = op + ext
    rd, wn = read.astype(np.int64), win.astype(np.int64)
    j0 = np.arange(cols) if full else c - band + np.arange(cols)
    H = np.where((j0 >= 0) & (j0 <= W), 0, NEG) + np.zeros((B, 1), np.int64)
    E = np.full((B, cols), NEG, np.int64)
    for i in range(R):
        up_h = H.copy() if full else np.concatenate(
            [H[:, 1:], np.full((B, 1), NEG)], 1)
        up_e = E if full else np.concatenate(
            [E[:, 1:], np.full((B, 1), NEG)], 1)
        E = np.maximum(up_h - first, up_e - ext)
        prev = H.copy()
        gmax = None
        shift = 0 if full else _row_start(i + c + 1, W) - (i + c + 1)
        for k in range(cols):
            j = k if full else i + 1 + c - band + k
            if full:
                ht = -(op + ext * (i + 1)) if k == 0 else np.maximum(
                    prev[:, k - 1] + np.where(rd[:, i] == wn[:, k - 1],
                                              sc.match, -sc.mismatch),
                    E[:, k])
            else:
                q = j - 1 + shift
                wb = wn[:, q] if 1 <= j <= W and 0 <= q < W else -1
                ht = np.maximum(prev[:, k] + np.where(rd[:, i] == wb,
                                                      sc.match,
                                                      -sc.mismatch), E[:, k])
                if j == 0:
                    ht = np.full(B, -(op + ext * (i + 1)))
            valid = 0 <= j <= W
            if not valid:
                ht = np.full(B, NEG)
            f = (NEG if k == 0 else gmax) - op - ext * k
            g = ht + ext * k
            gmax = g if k == 0 else np.maximum(gmax, g)
            H[:, k] = np.maximum(ht, f) if valid else NEG
    return H


LONG_GAP = Scoring(match=2, mismatch=20, gap_open=6, gap_extend=1)


@pytest.mark.parametrize("b,r,w,band,sc", [
    (6, 150, 182, 0, Scoring()), (6, 150, 182, 1, Scoring()),
    (6, 150, 182, 2, Scoring()), (6, 150, 182, 24, Scoring()),
    (6, 150, 182, None, Scoring()), (5, 45, 77, 24, LONG_GAP),
    (4, 37, 45, 3, Scoring()), (3, 40, 52, 40, Scoring()),
    (4, 40, 200, None, LONG_GAP), (4, 150, 278, 40, Scoring()),
    # windows shorter than the read: the first and last rows' slice start
    # wraps or clamps in repro (150, 149 only moves the centre to -1)
    (4, 150, 149, 16, Scoring()), (4, 150, 147, 8, Scoring()),
    (4, 150, 145, 3, LONG_GAP), (4, 40, 37, 2, Scoring()),
    (4, 40, 35, 10, LONG_GAP),
])
def test_warp_scan_model_matches_repro(b, r, w, band, sc):
    """The identities the warp recurrence rests on: lane-split neighbours
    and a lane-split running max give every cell of repro's banded and
    full DP (jnp oracle and the shared `dp_block`).  Row 2 aligns across
    a deletion as long as the band (or the window) allows, so its best
    path takes a horizontal gap across many lanes; in the full DP, row 3
    sits at the window's left edge, so the last row's right end is a gap
    from there.  (150, 278, 40) is the long-read lane's 81-column frame
    (CPL 3); a window shorter than the read lies inside it, on and off
    the centre."""
    from repro.kernels.banded_sw.kernel import dp_block
    rng = np.random.default_rng(r * w + (band or 0))
    read = rng.integers(0, 4, (b, r), np.uint8)
    win = rng.integers(0, 4, (b, w), np.uint8)
    c = (w - r) // 2
    if w < r:
        for i, s in enumerate((-c, 0, r - w)):
            read[i, s:s + w] = win[i]
    else:
        win[0, c:c + r] = read[0]                  # an exact placement
        win[1, c + 2:c + r] = read[1, :r - 2]      # a 2-base shift
        gap = min(band if band is not None else w, w - r) - 2
        head = r // 2 if band is not None else 10
        start = c - gap // 2 if band is not None else 0
        read[2, :head] = win[2, start:start + head]
        read[2, head:] = win[2, start + head + gap:start + gap + r]
        if band is None:    # the last row's gap runs over most lanes
            win[3, :r] = read[3]
    jsc = JScoring(**dataclasses.asdict(sc))
    score, end, last = _warp_dp_model(read, win, band, sc)
    if sc == LONG_GAP:      # every cell of the last row, gaps included
        np.testing.assert_array_equal(
            last, _sequential_last_row(read, win, band, sc))
    want = j_banded(jnp.asarray(read), jnp.asarray(win), band, jsc)
    np.testing.assert_array_equal(score, np.asarray(want.score))
    np.testing.assert_array_equal(end, np.asarray(want.ref_end))
    blk_score, blk_end = dp_block(jnp.asarray(read, jnp.int32),
                                  jnp.asarray(win, jnp.int32),
                                  scoring=jsc, band=band)
    np.testing.assert_array_equal(score, np.asarray(blk_score))
    np.testing.assert_array_equal(end, np.asarray(blk_end))


def test_lane_slots_cover_the_row():
    assert [lane_slots(c) for c in (1, 32, 33, 49, 65, 81, 97, 183, 263,
                                    1024)] == [1, 1, 2, 2, 3, 3, 4, 6, 16, 32]
    with pytest.raises(ValueError, match="1024 columns"):
        lane_slots(1025)
