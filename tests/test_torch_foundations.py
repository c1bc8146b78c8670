"""repro_torch foundations against repro on the CPU, exact equality:
2-bit encoding, xxHash32 (uint32 edge words), SeedMap build and padded
relayout, seeding, read simulation, backend resolution, the conversion
helpers, and the rule that repro_torch imports neither JAX nor repro."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import hashing as jhash
from repro.core import seeding as jseed
from repro.core import seedmap as jsm
from repro.core import simulate as jsim
from repro.core.pipeline import PipelineConfig as JPipelineConfig
from repro.core.scoring import Scoring as JScoring
from repro_torch import convert
from repro_torch.core import encoding, hashing, seeding, seedmap, simulate
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.scoring import Scoring
from repro_torch.kernels.backend import resolve_backend

RNG = np.random.default_rng(0)


def _words_i32(jwords) -> np.ndarray:
    """repro's uint32 words as the int32 bit patterns repro_torch holds."""
    return np.asarray(jwords).view(np.int32).copy()


# ---------------------------------------------------------------- encoding --
@pytest.mark.parametrize("length", [1, 15, 16, 17, 150, 1000])
def test_pack_unpack_match_repro(length):
    codes = RNG.integers(0, 4, (3, length), np.uint8)
    want = _words_i32(jenc.pack_2bit(jnp.asarray(codes)))
    got = encoding.pack_2bit(torch.as_tensor(codes)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        encoding.unpack_2bit(torch.as_tensor(got), length).numpy(), codes)
    np.testing.assert_array_equal(
        encoding.revcomp(torch.as_tensor(codes)).numpy(),
        np.asarray(jenc.revcomp(jnp.asarray(codes))))


def test_high_bit_words_round_trip():
    """Base T (3) in the top slot sets bit 31: the int32 holds the same
    bits as the uint32 word."""
    codes = np.full((1, 16), 3, np.uint8)
    got = encoding.pack_2bit(torch.as_tensor(codes))
    assert got.dtype == torch.int32 and int(got[0, 0]) == -1
    np.testing.assert_array_equal(
        got.numpy(), _words_i32(jenc.pack_2bit(jnp.asarray(codes))))


@pytest.mark.parametrize("length", [166, 182, 50])
def test_gather_windows_packed_matches_repro(length):
    L = 5000
    ref = RNG.integers(0, 4, L, np.uint8)
    words_j = jenc.pack_2bit(jnp.asarray(ref))
    starts = np.array([-500, -1, 0, 1, 15, 16, 17, 2500, L - length - 2,
                       L - length, L - 3, L + 9, 2**31 - 1], np.int32)
    want = np.asarray(jenc.gather_windows_packed(words_j,
                                                 jnp.asarray(starts), length))
    got = encoding.gather_windows_packed(
        torch.as_tensor(_words_i32(words_j)), torch.as_tensor(starts),
        length).numpy()
    np.testing.assert_array_equal(got, want)
    assert encoding.packed_gather_coords(313, length) == \
        jenc.packed_gather_coords(313, length)


# ----------------------------------------------------------------- hashing --
EDGE_WORDS = np.array([
    [0, 0, 0, 0],
    [0xFFFFFFFF] * 4,
    [0x80000000, 0, 0x80000000, 0],
    [0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 1],
    [0xDEADBEEF, 0x12345678, 0x0F0F0F0F, 0xF0F0F0F0],
], np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF, 2654435761])
def test_xxhash_edge_words_match_numpy(seed):
    words = np.concatenate([EDGE_WORDS,
                            RNG.integers(0, 2**32, (64, 4), np.uint32)])
    want = jhash.xxhash32_words_np(words, seed=seed)
    as_i32 = torch.as_tensor(words.view(np.int32))
    got = hashing.xxhash32_words(as_i32, seed=seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    got64 = hashing.xxhash32_words(torch.as_tensor(words.astype(np.int64)),
                                   seed=seed).numpy()
    np.testing.assert_array_equal(got64, want.astype(np.int64))
    np.testing.assert_array_equal(hashing.xxhash32_words_np(words, seed),
                                  want)
    np.testing.assert_array_equal(
        np.asarray(jhash.xxhash32_words(jnp.asarray(words), seed=seed)),
        want)


# ----------------------------------------------------------------- seeding --
@pytest.mark.parametrize("R,seed_len,S", [(150, 50, 3), (64, 16, 2),
                                          (100, 20, 4), (150, 50, 1)])
def test_seed_read_batch_matches_repro(R, seed_len, S):
    reads = RNG.integers(0, 4, (9, R), np.uint8)
    np.testing.assert_array_equal(seeding.seed_offsets_np(R, seed_len, S),
                                  jseed.seed_offsets_np(R, seed_len, S))
    want = jseed.seed_read_batch(jnp.asarray(reads), seed_len, S, 3,
                                 reverse_complement=True)
    got = seeding.seed_read_batch(torch.as_tensor(reads), seed_len, S, 3,
                                  reverse_complement=True)
    np.testing.assert_array_equal(got.hashes.numpy(),
                                  np.asarray(want.hashes).astype(np.int64))
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets))


# ----------------------------------------------------------------- seedmap --
@pytest.mark.parametrize("ref_len,bits,max_locs,repetitive", [
    (80_000, 16, 500, False),
    (100_000, 17, 8, True),
    (150_000, 18, 128, True),
])
def test_build_seedmap_bit_identical(ref_len, bits, max_locs, repetitive):
    rng = np.random.default_rng(bits)
    ref = (jsim.repetitive_reference(ref_len, rng, motif_len=120)
           if repetitive else jsim.random_reference(ref_len, rng))
    cfg = dict(table_bits=bits, max_locations=max_locs, hash_seed=bits)
    want = jsm.build_seedmap(ref, jsm.SeedMapConfig(**cfg))
    got = seedmap.build_seedmap(torch.as_tensor(ref),
                                seedmap.SeedMapConfig(**cfg))
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets))
    np.testing.assert_array_equal(got.locations.numpy(),
                                  np.asarray(want.locations))
    for cap in (2, 32):
        pw = jsm.to_padded(want, cap=cap)
        pg = seedmap.to_padded(got, cap=cap)
        np.testing.assert_array_equal(pg.rows.numpy(), np.asarray(pw.rows))
        np.testing.assert_array_equal(pg.counts.numpy(),
                                      np.asarray(pw.counts))
        assert pg.config.padded_cap == cap


def test_build_seedmap_in_small_hash_chunks(monkeypatch):
    """Chunked hashing gives the same index as one chunk."""
    ref = jsim.random_reference(20_000, np.random.default_rng(5))
    cfg = seedmap.SeedMapConfig(table_bits=12)
    whole = seedmap.build_seedmap(torch.as_tensor(ref), cfg)
    monkeypatch.setattr(seedmap, "HASH_CHUNK", 777)
    chunked = seedmap.build_seedmap(torch.as_tensor(ref), cfg)
    assert torch.equal(whole.offsets, chunked.offsets)
    assert torch.equal(whole.locations, chunked.locations)


# ---------------------------------------------------------------- simulate --
@pytest.mark.parametrize("sim_kw,seed", [
    (dict(), 0),
    (dict(sub_rate=0.05, ins_rate=0.02, del_rate=0.02), 1),
    (dict(sub_rate=0, ins_rate=0, del_rate=0), 2),
    (dict(del_rate=0.6, read_len=40), 3),       # refills the draw buffer
])
def test_simulate_pairs_same_seed_same_pairs(sim_kw, seed):
    ref = jsim.random_reference(30_000, np.random.default_rng(seed))
    want = jsim.simulate_pairs(ref, 40, jsim.ReadSimConfig(**sim_kw),
                               seed=seed)
    got = simulate.simulate_pairs(ref, 40, simulate.ReadSimConfig(**sim_kw),
                                  seed=seed)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


def test_reference_generators_match():
    for fn in ("random_reference", "repetitive_reference"):
        a = getattr(jsim, fn)(5000, np.random.default_rng(9))
        b = getattr(simulate, fn)(5000, np.random.default_rng(9))
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- backend --
def test_resolve_backend_rules():
    assert resolve_backend("auto", "cpu") == "torch"
    assert resolve_backend("auto", "cuda") == "cuda"
    assert resolve_backend("torch", "cuda") == "torch"
    assert resolve_backend("cuda", "cuda:0") == "cuda"
    with pytest.raises(ValueError, match="CUDA device"):
        resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("jnp", "cpu")


def test_cuda_session_without_card_raises():
    from repro_torch.engine import ExecutionConfig
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ExecutionConfig().torch_device()


# ----------------------------------------------------------------- convert --
def test_config_from_fields_round_trips_repro_configs():
    jp = JPipelineConfig(packed_ref=True, light_backend="jnp",
                         frontend_backend="pallas", prescreen_top=4,
                         light_block=16, scoring=JScoring(mismatch=6))
    p = convert.config_from_fields(PipelineConfig, dataclasses.asdict(jp))
    assert p.packed_ref is True and p.prescreen_top == 4
    assert not hasattr(p, "light_backend")   # one backend per session
    assert p.scoring == Scoring(mismatch=6)
    assert p.threshold() == jp.threshold() and p.band() == jp.band()
    assert p.residual_cap(1000) == jp.residual_cap(1000)
    s = convert.config_from_fields(
        seedmap.SeedMapConfig, dataclasses.asdict(jsm.SeedMapConfig(
            table_bits=9)))
    assert s.table_size == 512
    sc = convert.config_from_fields(Scoring,
                                    dataclasses.asdict(JScoring(match=3)))
    assert sc.perfect(150) == JScoring(match=3).perfect(150)
    with pytest.raises(ValueError, match="no fields"):
        convert.config_from_fields(Scoring, {"bogus": 1})


def test_index_from_numpy():
    ref = jsim.random_reference(10_000, np.random.default_rng(2))
    jm = jsm.build_seedmap(ref, jsm.SeedMapConfig(table_bits=10))
    fields = dataclasses.asdict(jm.config)
    sm = convert.seedmap_from_numpy(jm.offsets, jm.locations, fields)
    assert sm.config == seedmap.SeedMapConfig(table_bits=10)
    jp = jsm.to_padded(jm, cap=4)
    psm = convert.padded_from_numpy(jp.rows, jp.counts,
                                    dataclasses.asdict(jp.config))
    np.testing.assert_array_equal(seedmap.to_padded(sm, cap=4).rows.numpy(),
                                  psm.rows.numpy())
    assert psm.config.padded_cap == 4


# ------------------------------------------------------------ import guard --
def test_repro_torch_imports_neither_jax_nor_repro():
    """Every repro_torch module imports in a fresh interpreter without
    pulling in jax or the repro package."""
    import repro_torch
    pkg = os.path.dirname(list(repro_torch.__path__)[0])
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": pkg})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_engine_imports_no_lm_substrate():
    """The mapper's session loads none of the LM path: importing
    repro_torch.engine in a fresh interpreter pulls in no model or
    optimizer module."""
    import repro_torch
    pkg = os.path.dirname(list(repro_torch.__path__)[0])
    code = (
        "import sys, repro_torch.engine\n"
        "print(sorted(n for n in sys.modules if n.split('.')[:2] in "
        "(['repro_torch', 'models'], ['repro_torch', 'optim'])))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": pkg})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_imports_neither_jax_nor_repro():
    """chip_smoke.py imports inside main(); check every import statement."""
    import ast
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots
