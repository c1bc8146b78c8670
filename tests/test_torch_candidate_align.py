"""repro_torch's candidate light alignment (step 4) against repro's on the
CPU, exact equality, over prescreen_top in {0, 1, C//2, C}, both
reference flavors and both light modes; out-of-range and negative starts;
all-invalid rows; and the kernel-side window prep (the coordinates the
CUDA kernel reads) against repro's window gathers."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.encoding import gather_windows_packed as j_gather_packed
from repro.core.encoding import pack_2bit as j_pack
from repro.core.light_align import gather_ref_windows as j_gather
from repro.core.light_align import light_align as j_light_align
from repro.kernels.candidate_align import candidate_pair_align as j_align
from repro_torch.core.encoding import pack_2bit
from repro_torch.core.light_align import light_align
from repro_torch.core.seedmap import INVALID_LOC
from repro_torch.kernels._util import kernel_reference, window_starts
from repro_torch.kernels.candidate_align.ops import candidate_pair_align

L, R, E = 4000, 150, 8


def _world(b, c, seed):
    """Random candidates (some out of range, ~30% invalid, row 0 all
    invalid) plus planted near-exact pairs so light alignment accepts."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L, np.uint8)
    pos1 = rng.integers(-30, L + 30, (b, c)).astype(np.int32)
    pos2 = rng.integers(-30, L + 30, (b, c)).astype(np.int32)
    pos1[rng.random((b, c)) < 0.3] = INVALID_LOC
    pos2[rng.random((b, c)) < 0.3] = INVALID_LOC
    pos1[0] = pos2[0] = INVALID_LOC
    reads1 = rng.integers(0, 4, (b, R), np.uint8)
    reads2 = rng.integers(0, 4, (b, R), np.uint8)
    for i in range(1, b, 2):
        p = int(rng.integers(20, L - R - 200))
        pos1[i, i % c] = p
        pos2[i, i % c] = p + 100
        reads1[i] = ref[p:p + R]
        reads1[i, 10] = (reads1[i, 10] + 1) % 4                # mismatch
        reads2[i, :70] = ref[p + 100:p + 170]
        reads2[i, 70:] = ref[p + 172:p + 100 + R + 2]         # deletion
        if i % 4 == 1:                                        # insertion
            reads1[i, 40:] = np.concatenate([[1, 2], ref[p + 40:p + R - 2]])
    return ref, reads1, reads2, pos1, pos2


def _check(ref, r1, r2, p1, p2, packed, **kw):
    jref = j_pack(jnp.asarray(ref)) if packed else jnp.asarray(ref)
    want = j_align(jref, jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(p1),
                   jnp.asarray(p2), E, packed_ref=packed, backend="jnp",
                   **kw)
    tref = pack_2bit(torch.as_tensor(ref)) if packed else torch.as_tensor(ref)
    got = candidate_pair_align(tref, torch.as_tensor(r1), torch.as_tensor(r2),
                               torch.as_tensor(p1), torch.as_tensor(p2), E,
                               packed_ref=packed, **kw)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{f} packed={packed} {kw}")
    return got


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["minsplit", "paper"])
@pytest.mark.parametrize("prescreen", [0, 1, 4, 8])
def test_candidate_align_matches_repro(packed, mode, prescreen):
    world = _world(24, 8, seed=prescreen + 10 * packed)
    got = _check(*world, packed, mode=mode, prescreen_top=prescreen)
    assert got.ok1.any()


@pytest.mark.parametrize("c", [1, 3])
def test_small_candidate_sets(c):
    _check(*_world(10, c, seed=c), packed=False, prescreen_top=c // 2)


def test_edge_starts_and_all_invalid_rows():
    """Starts before the origin, at the edges and past the end; rows with
    no valid candidate (winner j=0 at NEG_BIG, its edit fields still from
    the window at 0)."""
    ref, r1, r2, _, _ = _world(8, 4, seed=5)
    p = np.array([-(R + 2 * E + 9), -E - 1, -3, 0, L - R - E, L - 1, L + 7,
                  2**30], np.int32).reshape(2, 4)
    p1 = np.concatenate([p, np.full((6, 4), INVALID_LOC, np.int32)])
    p2 = p1[:, ::-1].copy()
    for packed in (False, True):
        got = _check(ref, r1, r2, p1, p2, packed, prescreen_top=2)
        assert (got.score1.numpy()[2:] == -(1 << 20)).all()


@pytest.mark.parametrize("prescreen", [0, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_half_valid_winners_report_the_window_at_0(packed, prescreen):
    """Rows whose candidates each have one valid mate: the winner is the
    slot whose valid mate scores best, and its invalid mate's edit fields
    come from aligning the window at 0; beside them rows with one fully
    valid slot among half-valid ones, which it must beat."""
    ref, r1, r2, p1, p2 = _world(12, 4, seed=7)
    rng = np.random.default_rng(8)
    half = rng.random((12, 4)) < 0.5
    p1 = np.where(half, p1, INVALID_LOC).astype(np.int32)
    p2 = np.where(half, INVALID_LOC, p2).astype(np.int32)
    for i in range(12):                        # every slot keeps one mate
        for j in range(4):
            if p1[i, j] == INVALID_LOC and p2[i, j] == INVALID_LOC:
                p2[i, j] = int(rng.integers(0, L))
    p1[1::3, 2] = 300                          # one fully valid slot
    p2[1::3, 2] = 400
    got = _check(ref, r1, r2, p1, p2, packed, prescreen_top=prescreen)
    s1, s2 = got.score1.numpy(), got.score2.numpy()
    one_valid = (s1 == -(1 << 20)) ^ (s2 == -(1 << 20))
    assert one_valid[[i for i in range(12) if i % 3 != 1]].all()
    assert not one_valid[1::3].any()


@pytest.mark.parametrize("mode", ["minsplit", "paper"])
def test_light_align_matches_repro(mode):
    """The plain Light Alignment itself (int32 prefix sums here, int16 in
    repro) on planted single-gap and noisy windows."""
    rng = np.random.default_rng(1)
    n, r, e = 64, 60, 5
    wins = rng.integers(0, 4, (n, r + 2 * e), np.uint8)
    reads = wins[:, e:e + r].copy()
    for i in range(n):
        kind = i % 4
        if kind == 1:                                      # deletion k
            k, p = 1 + i % e, 5 + i % 40
            reads[i, p:] = wins[i, e + p + k:e + r + k]
        elif kind == 2:                                    # insertion k
            k, p = 1 + i % e, 5 + i % 40
            reads[i, p + k:] = wins[i, e + p:e + r - k]
        elif kind == 3:
            reads[i, rng.integers(0, r, 4)] ^= 1
    want = j_light_align(jnp.asarray(reads), jnp.asarray(wins), e, mode=mode)
    got = light_align(torch.as_tensor(reads), torch.as_tensor(wins), e,
                      mode=mode)
    for f in ("score", "ok", "edit_type", "edit_len", "edit_pos"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def read_kernel_windows(ref_arr, start, off, width, packed):
    """What the CUDA kernels read for window base i: ref_arr[start + i], or
    bits 2*((off+i)&15) of word start + ((off+i)>>4)."""
    i = torch.arange(width)
    if not packed:
        return ref_arr[start.long()[..., None] + i]
    q = off.long()[..., None] + i
    words = ref_arr[start.long()[..., None] + (q >> 4)].long() & 0xFFFFFFFF
    return ((words >> (2 * (q & 15))) & 3).to(torch.uint8)


@pytest.mark.parametrize("lead", [E, 16])
@pytest.mark.parametrize("packed", [False, True])
def test_kernel_window_prep_matches_repro_gather(lead, packed):
    """The kernels' window coordinates and padded reference reproduce
    repro's gathers for negative and past-the-end starts (the clamp the
    kernels rely on), at the window's own padding and at a wider one.  Starts within a window of the int32 limits are out
    of scope: repro's int32 index arithmetic wraps there."""
    width = R + 2 * lead
    rng = np.random.default_rng(lead)
    ref = rng.integers(0, 4, L, np.uint8)
    pos = np.concatenate([
        np.array([-2**30, -(width + 50), -width, -lead - 1, -1, 0, 1,
                  15, 16, L - width, L - 1, L, L + width + 3, 2**30,
                  INVALID_LOC], np.int32),
        rng.integers(-300, L + 300, 40).astype(np.int32)])
    valid = pos != INVALID_LOC
    if packed:
        jwords = j_pack(jnp.asarray(ref))
        want = j_gather_packed(jwords, jnp.asarray(np.where(valid, pos - lead,
                                                            0)), width)
        tref = pack_2bit(torch.as_tensor(ref))
    else:
        want = j_gather(jnp.asarray(ref), jnp.asarray(np.where(valid, pos, 0)),
                        R, lead)
        tref = torch.as_tensor(ref)
    # pad == width: a wrapper's own padding; wider: a session's, built
    # once for its widest window
    for pad in (width, width + 21):
        kref = kernel_reference(tref, pad, packed)
        start, off = window_starts(tref, torch.as_tensor(pos),
                                   torch.as_tensor(valid), width, lead, packed,
                                   kref.pad)
        assert int(start.min()) >= 0
        got = read_kernel_windows(kref.data, start, off, width, packed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"pad={pad}")
    with pytest.raises(ValueError, match="padded"):
        window_starts(tref, torch.as_tensor(pos), torch.as_tensor(valid),
                      width, lead, packed, width - 1)
