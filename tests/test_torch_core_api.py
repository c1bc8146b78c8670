"""repro_torch's public core API against repro's on the CPU, exact
equality (all integer or exact host arithmetic): `encode_str` /
`decode_to_str`, `mismatch_mask_packed`, `seedmap_stats`, `query_padded`,
`gotoh_align_np`, the one-shot `map_long_reads`, and `repro_torch.core`'s
re-exports (repro's names, less its deprecated `map_pairs`)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import LongReadConfig as JLongReadConfig
from repro.core import SeedMapConfig as JSeedMapConfig
from repro.core import build_seedmap as j_build_seedmap
from repro.core import to_padded as j_to_padded
from repro.core.dp_fallback import gotoh_align_np as j_gotoh_align_np
from repro.core.encoding import decode_to_str as j_decode_to_str
from repro.core.encoding import encode_str as j_encode_str
from repro.core.encoding import mismatch_mask_packed as j_mismatch_mask
from repro.core.query import query_padded as j_query_padded
from repro.core.seedmap import seedmap_stats as j_seedmap_stats
from repro.core.simulate import repetitive_reference as j_repetitive_ref
import repro_torch.core as tcore
from repro_torch.convert import config_from_fields
from repro_torch.core.dp_fallback import gotoh_align_np
from repro_torch.core.encoding import (
    decode_to_str,
    encode_str,
    from_int32_bits,
    mismatch_mask_packed,
    pack_2bit,
    to_int32_bits,
)
from repro_torch.core.long_read import LongReadConfig, map_long_reads
from repro_torch.core.query import query_padded
from repro_torch.core.scoring import Scoring
from repro_torch.core.seedmap import (
    SeedMapConfig,
    build_seedmap,
    seedmap_stats,
    to_padded,
)
from repro_torch.core.simulate import (
    random_reference,
    simulate_long_reads,
)


# ------------------------------------------------------------ re-exports --
def test_all_is_repros_less_map_pairs():
    assert sorted(tcore.__all__) == sorted(
        n for n in jcore.__all__ if n != "map_pairs")
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    assert not hasattr(tcore, "map_pairs")


# -------------------------------------------------------------- encoding --
@pytest.mark.parametrize("n,seed", [(0, 0), (1, 1), (150, 2), (10_000, 3)])
def test_encode_decode_match_repro(n, seed):
    rng = np.random.default_rng(seed)
    s = "".join(rng.choice(list("ACGTacgt"), n))
    got, want = encode_str(s), j_encode_str(s)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert decode_to_str(got) == j_decode_to_str(want) == s.upper()
    assert decode_to_str(torch.from_numpy(got)) == s.upper()


@pytest.mark.parametrize("bad", ["ACGN", "AC GT", "acgu"])
def test_encode_refuses_what_repro_refuses(bad):
    with pytest.raises(ValueError, match="non-ACGT"):
        j_encode_str(bad)
    with pytest.raises(ValueError, match="non-ACGT"):
        encode_str(bad)


@pytest.mark.parametrize("seed", [0, 1])
def test_mismatch_mask_packed_matches_repro(seed):
    """Random words (high bits set half the time), and the packings of
    two reads that differ at known bases."""
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 2**32, (7, 33), dtype=np.uint64
                         ).astype(np.uint32) for _ in range(2))
    want = np.asarray(j_mismatch_mask(jnp.asarray(a), jnp.asarray(b)))
    got = mismatch_mask_packed(to_int32_bits(torch.from_numpy(
        a.astype(np.int64))), to_int32_bits(torch.from_numpy(
            b.astype(np.int64))))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(from_int32_bits(got).numpy(), want)
    read = rng.integers(0, 4, 150).astype(np.uint8)
    other = read.copy()
    other[[0, 15, 16, 149]] ^= 1
    m = from_int32_bits(mismatch_mask_packed(
        pack_2bit(torch.from_numpy(read)),
        pack_2bit(torch.from_numpy(other)))).numpy()
    bits = [(int(m[i // 16]) >> (2 * (i % 16))) & 1 for i in range(150)]
    assert [i for i, x in enumerate(bits) if x] == [0, 15, 16, 149]


# --------------------------------------------------------------- seedmap --
@pytest.mark.parametrize("kind,bits,max_locs", [
    ("random", 12, 500), ("random", 15, 500), ("repetitive", 10, 20),
])
def test_seedmap_stats_matches_repro(kind, bits, max_locs):
    rng = np.random.default_rng(bits)
    ref = (random_reference(30_000, rng) if kind == "random"
           else j_repetitive_ref(30_000, rng))
    cfg = dict(table_bits=bits, max_locations=max_locs)
    got = seedmap_stats(build_seedmap(ref, SeedMapConfig(**cfg)))
    want = j_seedmap_stats(j_build_seedmap(ref, JSeedMapConfig(**cfg)))
    assert got == want
    assert got["max_locs_per_bucket"] <= max_locs


def test_seedmap_stats_of_an_empty_map_matches_repro():
    """Every bucket over the threshold: no location, no non-empty
    bucket."""
    ref = np.zeros(2_000, np.uint8)
    cfg = dict(table_bits=6, max_locations=1)
    got = seedmap_stats(build_seedmap(ref, SeedMapConfig(**cfg)))
    assert got == j_seedmap_stats(j_build_seedmap(ref, JSeedMapConfig(**cfg)))
    assert got["n_locations"] == 0 and got["mean_locs_per_nonempty_bucket"] \
        == 0.0


@pytest.mark.parametrize("cap", [4, 32])
def test_query_padded_matches_repro(cap):
    """Hashes with the high bits set, as uint32 values (int64) and as the
    int32-held bits this package stores them in."""
    ref = random_reference(20_000, np.random.default_rng(4))
    jpsm = j_to_padded(j_build_seedmap(ref, JSeedMapConfig(table_bits=11)),
                       cap=cap)
    psm = to_padded(build_seedmap(ref, SeedMapConfig(table_bits=11)), cap=cap)
    h = np.random.default_rng(5).integers(0, 2**32, (9, 3), dtype=np.uint64)
    want = j_query_padded(jpsm, jnp.asarray(h.astype(np.uint32)))
    for hashes in (torch.from_numpy(h.astype(np.int64)),
                   to_int32_bits(torch.from_numpy(h.astype(np.int64)))):
        got = query_padded(psm, hashes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------- dp fallback --
def _mutate(rng, window, R, kind):
    """A read cut from ``window`` with a substitution, an insertion or a
    deletion run (or none)."""
    start = int(rng.integers(4, len(window) - R - 8))
    read = window[start:start + R].copy()
    p = int(rng.integers(5, R - 10))
    if kind == "sub":
        read[p] = (read[p] + 1) % 4
    elif kind == "ins":
        k = int(rng.integers(1, 4))
        read = np.concatenate([read[:p], rng.integers(0, 4, k).astype(
            np.uint8), read[p:]])[:R]
    elif kind == "del":
        k = int(rng.integers(1, 4))
        read = window[start:start + R + k].copy()
        read = np.concatenate([read[:p], read[p + k:]])
    return read


@pytest.mark.parametrize("kind", ["none", "sub", "ins", "del", "random"])
def test_gotoh_align_np_matches_repro(kind):
    """Score, CIGAR runs and reference start equal repro's traceback on
    reads with one edit of each kind, unrelated reads, and another
    scoring."""
    rng = np.random.default_rng(len(kind))
    for trial in range(4):
        window = rng.integers(0, 4, 70).astype(np.uint8)
        read = (rng.integers(0, 4, 40).astype(np.uint8) if kind == "random"
                else _mutate(rng, window, 40, kind))
        for sc in (Scoring(), Scoring(match=1, mismatch=4, gap_open=6,
                                      gap_extend=1)):
            jsc = type(jcore.Scoring())(**dataclasses.asdict(sc))
            assert gotoh_align_np(read, window, sc) == \
                j_gotoh_align_np(read, window, jsc), (kind, trial, sc)


# ------------------------------------------------------------- long read --
@pytest.mark.parametrize("layout", ["csr", "padded"])
@pytest.mark.parametrize("packed", [False, True])
def test_map_long_reads_matches_repro(layout, packed):
    """The one-shot lane entry on the CPU against repro's, on the CSR and
    padded maps and both reference flavors, from numpy reads."""
    ref = random_reference(200_000, np.random.default_rng(6))
    reads, _ = simulate_long_reads(ref, 6, 1_500, 0.01, seed=7)
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=16))
    sm = build_seedmap(ref, SeedMapConfig(table_bits=16))
    jcfg = JLongReadConfig()
    cfg = config_from_fields(LongReadConfig, dataclasses.asdict(jcfg))
    if layout == "padded":
        jsm = j_to_padded(jsm, cap=jcfg.pipe.max_locs_per_seed)
        sm = to_padded(sm, cap=cfg.pipe.max_locs_per_seed)
    ref_t = torch.from_numpy(ref)
    jref = jnp.asarray(ref)
    if packed:
        from repro.core.encoding import pack_2bit as j_pack_2bit
        ref_t, jref = pack_2bit(ref_t), j_pack_2bit(jref)
    want = jcore.map_long_reads(jsm, jref, jnp.asarray(reads), jcfg)
    got = map_long_reads(sm, ref_t, reads, cfg)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{f} {layout} {packed}")
    assert bool(got.mapped.all())
