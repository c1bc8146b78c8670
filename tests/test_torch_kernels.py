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
