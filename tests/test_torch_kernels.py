"""repro_torch's building-block ops (light_align, xxhash32, seed_gather)
against repro's on the CPU, exact equality: the same numpy inputs go
through repro's ``backend="jnp"`` and ``backend="interpret"`` (the Pallas
kernel body) and through repro_torch's plain version (``backend="torch"``).
Mirrors tests/test_kernels.py, plus the edges the CUDA kernels must
reproduce: every seed including 0xFFFFFFFF, E = 0, int32 bases, and
seed_gather ids outside the table."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.light_align.ops import light_align as j_light_align
from repro.kernels.seed_gather.ops import seed_gather as j_seed_gather
from repro.kernels.xxhash.ops import xxhash32 as j_xxhash32
from repro_torch.core.scoring import Scoring
from repro_torch.kernels.light_align.ops import light_align
from repro_torch.kernels.seed_gather.ops import seed_gather
from repro_torch.kernels.xxhash.ops import xxhash32

J_BACKENDS = ("jnp", "interpret")


# ---------------------------------------------------------------- xxhash --
def _words(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w[0] = [0xFFFFFFFF, 0, 0x80000000, 0x7FFFFFFF]      # sign-bit words
    return w


def _port_word_inputs(w: np.ndarray):
    """The same words in each dtype the port accepts."""
    return {"uint32": torch.from_numpy(w),
            "int32": torch.from_numpy(w.view(np.int32)),
            "int64": torch.from_numpy(w.astype(np.int64))}


@pytest.mark.parametrize("n", [1, 127, 128, 1000])
@pytest.mark.parametrize("seed", [0, 99, 0xFFFFFFFF])
def test_xxhash32_matches_repro(n, seed):
    w = _words((n, 4), n + seed % 1000)
    for jb in J_BACKENDS:
        want = np.asarray(j_xxhash32(jnp.asarray(w), seed=seed, backend=jb,
                                     block=128)).astype(np.int64)
        for name, x in _port_word_inputs(w).items():
            got = xxhash32(x, seed=seed, backend="torch")
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{jb} {name}")


def test_xxhash32_multidim_matches_repro():
    w = _words((6, 3, 4), 7)
    for jb in J_BACKENDS:
        want = np.asarray(j_xxhash32(jnp.asarray(w), backend=jb,
                                     block=128)).astype(np.int64)
        got = xxhash32(torch.from_numpy(w))
        assert tuple(got.shape) == (6, 3)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=jb)


def test_xxhash32_rejects_bad_words():
    with pytest.raises(ValueError, match="4-word"):
        xxhash32(torch.zeros((5, 3), dtype=torch.int32))
    with pytest.raises(TypeError):
        xxhash32(torch.zeros((5, 4), dtype=torch.float32))


# ----------------------------------------------------------- light_align --
def _mk_la(b, r, e, rng):
    """tests/test_kernels.py's inputs: half the batch an exact match, a
    quarter one indel, the rest random."""
    read = rng.integers(0, 4, (b, r), np.uint8)
    win = rng.integers(0, 4, (b, r + 2 * e), np.uint8)
    h = b // 2
    win[:h, e:e + r] = read[:h]
    for i in range(h, h + b // 4):
        if e == 0:
            break
        k = rng.integers(1, min(e, 5) + 1)
        p = rng.integers(1, r - k - 1)
        win[i, e:e + p] = read[i, :p]
        win[i, e + p + k:e + r + k] = read[i, p:]
    return read, win


def _same_fields(got, want, msg):
    for f in want._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            err_msg=f"field {f} {msg}")


@pytest.mark.parametrize("b,r,e", [(8, 150, 8), (33, 150, 4), (64, 100, 8),
                                    (128, 150, 2), (16, 64, 6), (3, 20, 0)])
@pytest.mark.parametrize("mode", ["minsplit", "paper"])
def test_light_align_matches_repro(b, r, e, mode):
    rng = np.random.default_rng(b * 1000 + r + e)
    read, win = _mk_la(b, r, e, rng)
    for jb in J_BACKENDS:
        want = j_light_align(jnp.asarray(read), jnp.asarray(win), e,
                             mode=mode, backend=jb, block=32)
        for dtype in (torch.uint8, torch.int32):
            got = light_align(torch.from_numpy(read).to(dtype),
                              torch.from_numpy(win).to(dtype), e, mode=mode,
                              backend="torch")
            _same_fields(got, want, f"b={b} r={r} e={e} {mode} {jb} {dtype}")


def test_light_align_scoring_and_threshold_match_repro():
    from repro.core.scoring import Scoring as JScoring
    rng = np.random.default_rng(3)
    read, win = _mk_la(32, 100, 5, rng)
    kw = dict(match=2, mismatch=3, gap_open=4, gap_extend=1)
    for jb in J_BACKENDS:
        want = j_light_align(jnp.asarray(read), jnp.asarray(win), 5,
                             JScoring(**kw), threshold=150, backend=jb,
                             block=32)
        got = light_align(torch.from_numpy(read), torch.from_numpy(win), 5,
                          Scoring(**kw), threshold=150)
        _same_fields(got, want, jb)


def test_light_align_rejects_unknown_mode():
    x = torch.zeros((2, 20), dtype=torch.uint8)
    with pytest.raises(ValueError, match="mode"):
        light_align(x, torch.zeros((2, 24), dtype=torch.uint8), 2,
                    mode="exact")


KEY = 1 << 10         # light_align.cuh's walk keys v * 1024 + p
M32 = 0xFFFFFFFF
BIG = 1 << 20         # a hypothesis' "infinite" mismatch count


def _nibble_entry(idx, last=False):
    """light_align.cuh's `nibble_entry`: bits 0-3 of idx are m0 at a
    nibble's four positions, bits 4-7 the suffix mask; (the first minimum
    over t of P_t * KEY + t + 1, the net step P_3 * KEY + 4).  ``last``
    keys the positions backwards, so the minimum is the last one (a
    mutation the test shows is caught)."""
    sign = -1 if last else 1
    P, first = 0, None
    for t in range(4):
        P += ((idx >> t) & 1) - ((idx >> (4 + t)) & 1)
        key = P * KEY + sign * (t + 1)
        first = key if first is None else min(first, key)
    return first, P * KEY + sign * 4


def _mismatch_nibble(a, b):
    """Four byte pairs' mismatch flags as bits 0-3, as the kernel computes
    them (a carry-free nonzero-byte test, then one multiply)."""
    x = a ^ b
    t = (((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & 0x80808080
    return ((t * 0x00204081) & M32) >> 28


def _low_bits(n):
    return 0 if n <= 0 else M32 if n >= 32 else (1 << n) - 1


def _int16(x):
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def _lane_light_align_model(read, win, E, sc, mode, last=False, seed=0):
    """numpy model of csrc/light_align.cuh's `light_align_lanes` as
    light_align.cu launches it: L = the power of two covering R in 32-base
    lanes, lane li holding positions [a, a + 4 NW), a = 4 NW li; each
    shift's mismatch bitmask from 32-bit words (bytes past the row are
    junk the masks must drop); each gap hypothesis walked a nibble at a
    time through the 256-entry table, positions past the last split
    forced to step +1, the walks' nets and the suffix counts carried
    across the lanes by one packed shuffle scan, and the first minimum
    taken by one integer min over the keys."""
    B, R = read.shape
    L = 1
    while 32 * L < R:
        L *= 2
    NW = -(-R // (4 * L))
    sign = -1 if last else 1
    tab = [_nibble_entry(i, last) for i in range(256)]
    rng = np.random.default_rng(seed)
    m2 = sc.match + sc.mismatch
    out = np.zeros((5, B), np.int64)

    def words(buf, x):
        return [int.from_bytes(buf[x + 4 * t:x + 4 * t + 4].tobytes(),
                               "little") for t in range(NW)]

    def mask(u, v):
        return sum(_mismatch_nibble(p, q) << (4 * t)
                   for t, (p, q) in enumerate(zip(u, v)))

    lanes = [4 * NW * li for li in range(L)]
    for b in range(B):
        junk = rng.integers(0, 256, 4 * NW * L + E + 16, np.uint8)
        rbuf = np.concatenate([read[b].astype(np.uint8), junk])
        wbuf = np.concatenate([win[b].astype(np.uint8), junk])
        rd = [words(rbuf, a) for a in lanes]
        wd = [words(wbuf, E + a) for a in lanes]
        m0 = [mask(rd[i], wd[i]) for i in range(L)]
        mm_none = sum(bin(m0[i] & _low_bits(R - a)).count("1")
                      for i, a in enumerate(lanes))
        best = [sc.match * R - m2 * mm_none, 0, 0, 0, mm_none]

        def hypothesis(h, last_split, n):
            keys, packed = [], []
            for i, a in enumerate(lanes):
                past = ~_low_bits(last_split - a) & M32
                s0, s1 = m0[i] | past, h[i] & ~past & M32
                key = 1023 - a if last else a
                k0, lane_best = key, None
                # nibble q of s0 | nibble q of s1 << 4: byte q // 2 of
                # `even` (q even) or `odd`
                even = (s0 & 0x0F0F0F0F) | ((s1 << 4) & 0xF0F0F0F0)
                odd = ((s0 >> 4) & 0x0F0F0F0F) | (s1 & 0xF0F0F0F0)
                for q in range(NW):
                    ex, ey = tab[((odd if q & 1 else even) >> 8 * (q >> 1))
                                 & 0xFF]
                    cand = key + ex
                    lane_best = cand if lane_best is None else min(
                        lane_best, cand)
                    key += ey
                net = (key - k0 - sign * 4 * NW) // KEY
                keys.append(lane_best)
                packed.append((bin(h[i] & _low_bits(n - a)).count("1") << 16)
                              + net)
            incl = list(np.cumsum(packed))
            tot = (incl[-1] - _int16(incl[-1])) >> 16
            g = min(keys[i] + _int16(incl[i] - packed[i]) * KEY
                    for i in range(L))
            field = g % KEY
            return tot + g // KEY, field if not last else 1023 - field

        def consider(mm_pos, etype, k, length):
            mm, pos = mm_pos
            if mode == "paper" and mm != 0:
                mm, pos = BIG, 0
            score = -BIG if mm >= BIG else (
                sc.match * length - m2 * mm - (sc.gap_open
                                               + sc.gap_extend * k))
            if score > best[0]:
                best[:] = [score, etype, k, pos, mm]

        for k in range(1, E + 1):
            hd = [mask(rd[i], words(wbuf, E + k + a))
                  for i, a in enumerate(lanes)]
            consider(hypothesis(hd, R - 1, R), 2, k, R)
            hi = [mask(words(rbuf, k + a), wd[i])
                  for i, a in enumerate(lanes)]
            consider(hypothesis(hi, R - k - 1, R - k), 1, k, R - k)
        out[:, b] = best
    return out


def _la_edge_rows(b, r, e, rng, codes=4):
    """`_mk_la` rows, then tandem repeats (ACAC... against a window of the
    same repeat shifted: the arg-min ties on many splits), all-mismatch
    rows, a deletion inside a homopolymer run (ties in paper mode too) and rows of codes 0-255 (R < 8: random rows, too short for an
    indel)."""
    if r < 8:
        read = rng.integers(0, 4, (b, r), np.uint8)
        win = rng.integers(0, 4, (b, r + 2 * e), np.uint8)
    else:
        read, win = _mk_la(b, r, e, rng)
    q = b // 4
    read[:q] = np.arange(r) % 2                               # ACAC...
    win[:q] = (np.arange(r + 2 * e) + rng.integers(0, 2, (q, 1))) % 2
    win[q:q + 2, :] = 3
    read[q:q + 2, :] = 1                                      # all mismatch
    if e and r >= 24:              # one base deleted inside a run of 12:
        m = r // 2                 # 13 splits tie at zero mismatches
        read[q + 2, m - 6:m + 6] = 2
        win[q + 2, e:e + m] = read[q + 2, :m]
        win[q + 2, e + m] = 2
        win[q + 2, e + m + 1:e + r + 1] = read[q + 2, m:]
    if codes > 4:
        read[-3:] = rng.integers(0, codes, (3, r))
        win[-3:] = rng.integers(0, codes, (3, r + 2 * e))
        win[-2:, e:e + r] = read[-2:]
        win[-1, e + 1:e + r] = read[-1, :r - 1]
    return read, win


@pytest.mark.parametrize("b,r,e,codes", [
    (24, 150, 8, 4), (12, 150, 1, 4), (10, 10, 8, 4), (12, 40, 0, 4),
    (10, 300, 3, 4), (12, 64, 6, 256), (6, 3, 1, 256),
])
@pytest.mark.parametrize("mode", ["minsplit", "paper"])
def test_lane_light_align_model_matches_repro(b, r, e, codes, mode):
    """The lane design (bitmasks from 4-byte compares, the nibble table,
    positions past the last split forced up, the packed lane scan, the
    first minimum by key) equals repro's jnp and interpret `light_align`
    on tandem repeats (many tied splits), all-mismatch rows, codes 0-255,
    E 0, 1, 3, 6 and 8, R = E + 2, and lanes of 1, 2, 8 and 16; with the
    minimum keyed backwards ("last minimum") it no longer does."""
    from repro.core.scoring import Scoring as JScoring
    rng = np.random.default_rng(b * 7 + r + e + codes)
    read, win = _la_edge_rows(b, r, e, rng, codes)
    jread, jwin = (jnp.asarray(x.astype(np.int32)) for x in (read, win))
    for jb in J_BACKENDS:
        for kw in ({}, dict(match=2, mismatch=3, gap_open=4, gap_extend=1)):
            want = j_light_align(jread, jwin, e, JScoring(**kw), mode=mode,
                                 backend=jb, block=8)
            got = _lane_light_align_model(read, win, e, Scoring(**kw), mode)
            for i, f in enumerate(("score", "edit_type", "edit_len",
                                   "edit_pos", "n_mismatch")):
                np.testing.assert_array_equal(
                    got[i], np.asarray(getattr(want, f)),
                    err_msg=f"{f} {jb} {kw}")
    if e and r >= 24:
        want = j_light_align(jread, jwin, e, mode=mode, backend="jnp")
        bad = _lane_light_align_model(read, win, e, Scoring(), mode,
                                      last=True)
        assert not np.array_equal(bad[3], np.asarray(want.edit_pos))


def test_nibble_table_first_minimum():
    """Spot entries of the walk table: no mismatches anywhere (the first
    position, net 0), m0 all set (rising: the first), h all set (falling:
    the last position, net -4), and a tie (m0 at 0, h at 1: +1, 0)."""
    assert _nibble_entry(0x00) == (1, 4)
    assert _nibble_entry(0x0F) == (KEY + 1, 4 * KEY + 4)
    assert _nibble_entry(0xF0) == (-4 * KEY + 4, -4 * KEY + 4)
    assert _nibble_entry(0x21) == (2, 4)


# ------------------------------------------------------------ seed_gather --
@pytest.mark.parametrize("t,cap,n", [(64, 16, 40), (128, 32, 128),
                                      (16, 8, 3)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_seed_gather_matches_repro(t, cap, n, dtype):
    rng = np.random.default_rng(t + cap + n)
    table = rng.integers(0, 1000, (t, cap)).astype(dtype)
    ids = rng.integers(0, t, n).astype(np.int32)
    for jb in J_BACKENDS:
        want = np.asarray(j_seed_gather(jnp.asarray(table), jnp.asarray(ids),
                                        backend=jb))
        got = seed_gather(torch.from_numpy(table), torch.from_numpy(ids))
        assert got.dtype == torch.from_numpy(table).dtype
        np.testing.assert_array_equal(got.numpy(), want, err_msg=jb)


#: ids outside a 16-row table, and the rows jnp's table[ids] gives them
OUT_OF_RANGE_IDS = [-1, -16, -17, -100, 15, 16, 2**31 - 1, -2**31]
OUT_OF_RANGE_ROWS = [15, 0, 0, 0, 15, 15, 15, 0]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_seed_gather_out_of_range_ids_match_repro(dtype):
    table = (np.arange(16 * 8).reshape(16, 8) * 3).astype(dtype)
    ids = np.array(OUT_OF_RANGE_IDS, np.int32)
    got = seed_gather(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), table[OUT_OF_RANGE_ROWS])
    for jb in J_BACKENDS:
        want = np.asarray(j_seed_gather(jnp.asarray(table), jnp.asarray(ids),
                                        backend=jb))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=jb)


def test_seed_gather_2d_ids_match_repro():
    rng = np.random.default_rng(9)
    table = rng.integers(-50, 50, (32, 12)).astype(np.int32)
    ids = rng.integers(-40, 40, (5, 3)).astype(np.int32)
    got = seed_gather(torch.from_numpy(table), torch.from_numpy(ids))
    assert tuple(got.shape) == (5, 3, 12)
    for jb in J_BACKENDS:
        want = np.asarray(j_seed_gather(jnp.asarray(table), jnp.asarray(ids),
                                        backend=jb))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=jb)


def test_seed_gather_rejects_bad_inputs():
    table = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="ids"):
        seed_gather(table, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="table"):
        seed_gather(table.to(torch.int64), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="without rows"):
        seed_gather(table[:0], torch.zeros(3, dtype=torch.int32))
