"""repro_torch's tuner (`repro_torch.tune`) against repro's on the CPU:
the cache format, corrupt caches, the nearest-batch lookup, the config
application (equal to repro's on the same entries, keys mapped
``pallas`` -> ``cuda``), explicit > cache > default, sessions that read
a cache once at build and stores that carry tune entries both ways
between the packages, a CPU `tune_session` whose session maps as repro's
with the same resolved knobs, and the launch-geometry checks of the four
tuned kernel families."""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core import LongReadConfig as JLongReadConfig
from repro.core import PipelineConfig as JPipelineConfig
from repro.core import SeedMapConfig as JSeedMapConfig
from repro.core import build_seedmap as j_build_seedmap
from repro.engine import ExecutionConfig as JExecutionConfig
from repro.engine import Mapper as JMapper
from repro.tune import apply_tuned_long_read as j_apply_long_read
from repro.tune import apply_tuned_pipeline as j_apply_pipeline
from repro_torch import tune
from repro_torch.core.long_read import LongReadConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import SeedMapConfig, build_seedmap
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, Mapper
from repro_torch.kernels.candidate_align.ops import (
    MAX_LANE_READ,
    MAX_READ,
    MAX_SHARED,
    PAIRS_PER_BLOCK,
    THREADS,
    candidate_pair_align,
    launch_shape,
)
from repro_torch.kernels.location_vote.ops import location_vote, vote_warps
from repro_torch.kernels.pair_frontend.ops import (
    frontend_merge_filter,
    frontend_warps,
    pair_frontend,
)
from repro_torch.kernels.residual_dp.ops import (
    residual_pair_dp,
    residual_warps,
)

TB = 14
CPU = ExecutionConfig(device="cpu")


@pytest.fixture(scope="module")
def world():
    ref = random_reference(30_000, np.random.default_rng(0))
    sm = build_seedmap(ref, SeedMapConfig(table_bits=TB))
    sim = simulate_pairs(ref, 16, ReadSimConfig(sub_rate=3e-3), seed=4)
    return ref, sm, sim


def _entries(backend, batch, *, prescreen=4, packed=True, fe=16, la=32,
             rd=4, band=None, vote=16, cfg=PipelineConfig()):
    """Hand-made entries keyed for ``backend`` at ``batch``."""
    buckets = tune.pipeline_buckets(cfg, batch, LongReadConfig(pipe=cfg))
    rd_params = {"block": rd}
    if band is not None:
        rd_params["dp_band"] = band
    params = {
        "pair_frontend": {"block": fe},
        "candidate_align": {"block": la, "prescreen_top": prescreen,
                            "packed_ref": packed},
        "residual_dp": rd_params,
        "location_vote": {"block": vote},
    }
    return {tune.entry_key(backend, fam, buckets[fam]): {
        "params": p, "us": 10.0, "staged_us": 20.0}
        for fam, p in params.items()}


def _assert_same(a, b, msg=""):
    for f in b._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
            err_msg=f"{f} {msg}")


# ---------------------------------------------------------------- cache --
def test_cache_round_trip_and_default_path(tmp_path):
    p = tmp_path / "tc.json"
    entries = _entries("cuda", 64)
    assert tune.save_cache(entries, p) == str(p)
    data = json.loads(p.read_text())
    assert data["version"] == tune.CACHE_VERSION == 1
    assert tune.load_cache(p) == entries == data["entries"]
    assert tune.cache_path() == os.path.join("artifacts", "tune_torch",
                                             "tune_cache.json")


@pytest.mark.parametrize("payload", [
    "{not json",
    json.dumps([1, 2, 3]),
    json.dumps({"version": 2, "entries": {}}),
    json.dumps({"version": 1, "entries": "nope"}),
])
def test_corrupt_or_stale_cache_warns_and_defaults(tmp_path, payload):
    p = tmp_path / "bad.json"
    p.write_text(payload)
    with pytest.warns(UserWarning, match="tune cache"):
        assert tune.load_cache(p) == {}


def test_missing_cache_is_silent_and_corrupt_session_defaults(world,
                                                               tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tune.load_cache(tmp_path / "nope.json") == {}
    ref, sm, _ = world
    p = tmp_path / "bad.json"
    p.write_text("{definitely not json")
    with pytest.warns(UserWarning, match="tune cache"):
        m = Mapper.from_index(sm, ref, PipelineConfig(), dataclasses.replace(
            CPU, stream_batch=16, tune=str(p)))
    assert m.pipe_cfg.prescreen() == 0 and m.pipe_cfg.light_block is None


def test_session_cache_reads_no_environment(tmp_path, monkeypatch):
    """None and False are off, True is artifacts/tune_torch/ (never
    repro's artifacts/tune/), a path is that file; REPRO_TUNE_CACHE is
    not read."""
    monkeypatch.chdir(tmp_path)
    mine, repros = _entries("torch", 64), _entries("torch", 64, fe=4)
    tune.save_cache(mine, tune.DEFAULT_CACHE)
    tune.save_cache(repros, os.path.join("artifacts", "tune",
                                         "tune_cache.json"))
    other = tmp_path / "other.json"
    tune.save_cache(_entries("torch", 8), other)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(other))
    assert tune.session_cache(None) == tune.session_cache(False) == {}
    assert tune.session_cache(True) == mine
    assert tune.session_cache(str(other)) == tune.load_cache(other)
    assert tune.cache_path() == tune.DEFAULT_CACHE


def test_lookup_nearest_batch_fallback():
    entries = _entries("cuda", 64)
    cfg = PipelineConfig()
    near = tune.pipeline_buckets(cfg, 128)["candidate_align"]
    assert near.startswith("B128_")
    assert tune.lookup(entries, "cuda", "candidate_align", near) is not None
    far = tune.pipeline_buckets(cfg, 1 << 20)["candidate_align"]
    assert tune.lookup(entries, "cuda", "candidate_align", far) is not None
    other = near.replace(f"_R{cfg.read_len}_", "_R999_")
    assert tune.lookup(entries, "cuda", "candidate_align", other) is None
    assert tune.lookup(entries, "torch", "candidate_align", near) is None
    assert tune.lookup(entries, "pallas", "candidate_align", near) is None


# ---------------------------------------------------------- application --
def _repro_keys(entries):
    """The same entries under repro's kernel backend."""
    return {k.replace("cuda/", "pallas/", 1): v for k, v in entries.items()}


@pytest.mark.parametrize("knobs", [
    dict(), dict(prescreen=0, packed=False, band=182),
    dict(fe=4, la=16, rd=16, vote=32),
])
@pytest.mark.parametrize("explicit", [
    {}, dict(prescreen_top=1, packed_ref=False, light_block=8,
             frontend_block=4, residual_block=8, dp_band=30),
])
@pytest.mark.parametrize("exec_packed", [None, False])
def test_apply_matches_repro(knobs, explicit, exec_packed):
    """`apply_tuned_pipeline` / `apply_tuned_long_read` fill the same
    knobs as repro's from the same entries (``cuda`` keys here,
    ``pallas`` there), at the tuned batch and a nearby one."""
    entries = _entries("cuda", 64, **knobs)
    jentries = _repro_keys(entries)
    for batch in (64, 100):
        got = tune.apply_tuned_pipeline(PipelineConfig(**explicit), entries,
                                        batch, "cuda", exec_packed)
        want = j_apply_pipeline(JPipelineConfig(**explicit), jentries, batch,
                                exec_backend="pallas",
                                exec_packed=exec_packed)
        for f in ("frontend_block", "light_block", "residual_block",
                  "prescreen_top", "packed_ref", "dp_band"):
            assert getattr(got, f) == getattr(want, f), f
        lr = tune.apply_tuned_long_read(LongReadConfig(), entries, batch,
                                        "cuda")
        jlr = j_apply_long_read(JLongReadConfig(), jentries, batch,
                                exec_backend="pallas")
        assert lr.vote_block == jlr.vote_block == knobs.get("vote", 16)


def test_explicit_beats_cache_beats_default(world, tmp_path):
    ref, sm, _ = world
    p = tmp_path / "tc.json"
    tune.save_cache(_entries("torch", 16, band=182), p)
    tuned = Mapper.from_index(sm, ref, PipelineConfig(), dataclasses.replace(
        CPU, stream_batch=16, tune=str(p)))
    c = tuned.pipe_cfg
    assert (c.frontend_block, c.light_block, c.residual_block) == (16, 32, 4)
    assert (c.prescreen_top, c.packed_ref, c.dp_band) == (4, True, 182)
    assert tuned.lr_cfg.vote_block == 16
    assert tuned.lr_cfg.pipe.frontend_block == 16
    explicit = PipelineConfig(prescreen_top=0, light_block=48, dp_band=24)
    m = Mapper.from_index(sm, ref, explicit, dataclasses.replace(
        CPU, stream_batch=16, tune=str(p), packed_ref=False))
    c = m.pipe_cfg
    assert (c.prescreen_top, c.light_block, c.dp_band) == (0, 48, 24)
    assert c.packed_ref is False and c.frontend_block == 16
    plain = Mapper.from_index(sm, ref, PipelineConfig(), dataclasses.replace(
        CPU, stream_batch=16))
    c = plain.pipe_cfg
    assert (c.frontend_block, c.light_block, c.residual_block,
            c.prescreen_top, c.dp_band) == (None,) * 5
    assert plain.lr_cfg.vote_block is None and plain._tune_entries == {}


def test_other_backends_and_backend_params_are_never_applied(world,
                                                             tmp_path):
    """A CPU session reads ``torch/`` keys only: repro's ``pallas/`` and
    ``jnp/`` entries, and ``cuda/`` ones, leave it alone, and a cached
    ``backend`` param has no field to go to."""
    ref, sm, _ = world
    entries = {**_repro_keys(_entries("cuda", 16)), **_entries("cuda", 16)}
    entries.update({k.replace("cuda/", "jnp/", 1): v
                    for k, v in _entries("cuda", 16).items()})
    for e in entries.values():
        e["params"]["backend"] = "jnp"
    p = tmp_path / "tc.json"
    tune.save_cache(entries, p)
    m = Mapper.from_index(sm, ref, PipelineConfig(), dataclasses.replace(
        CPU, stream_batch=16, tune=str(p)))
    assert m.pipe_cfg == Mapper.from_index(
        sm, ref, PipelineConfig(), dataclasses.replace(
            CPU, stream_batch=16)).pipe_cfg
    assert m.backend == "torch" and m._tune_entries == entries


def test_stores_carry_tune_entries_both_ways(world, tmp_path):
    """A tuned session's entries go into its store and survive repro's
    load and save; repro's ``pallas`` entries survive this package's load
    and save unapplied; `Mapper.load` turns ``tune=None`` off."""
    ref, sm, sim = world
    p = tmp_path / "tc.json"
    mine = _entries("torch", 16)
    tune.save_cache(mine, p)
    m = Mapper.from_index(sm, ref, PipelineConfig(), dataclasses.replace(
        CPU, tune=str(p)))
    m.save(tmp_path / "port")
    own = Mapper.load(tmp_path / "port", CPU)
    assert own.pipe_cfg == m.pipe_cfg and own.lr_cfg == m.lr_cfg
    assert own._tune_entries == mine and own.exec_cfg.tune is False
    jm = JMapper.load(tmp_path / "port", JExecutionConfig(backend="jnp"))
    assert jm._tune_entries == mine
    jm.save(tmp_path / "port_again")
    back = Mapper.load(tmp_path / "port_again", CPU)
    assert back._tune_entries == mine and back.exec_cfg.tune is False
    # repro writes its backends beside the blocks, which then read as TPU
    # blocks and are dropped; every other knob survives
    assert back.pipe_cfg == dataclasses.replace(
        m.pipe_cfg, frontend_block=None, light_block=None,
        residual_block=None)
    _assert_same(back.map(sim.reads1, sim.reads2),
                 m.map(sim.reads1, sim.reads2))

    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=TB))
    theirs = _repro_keys(_entries("cuda", 16))
    j = JMapper.from_index(jsm, ref, JPipelineConfig(),
                           JExecutionConfig(backend="jnp"))
    j._tune_entries = dict(theirs)
    j.save(tmp_path / "repro")
    loaded = Mapper.load(tmp_path / "repro", CPU)
    assert loaded._tune_entries == theirs
    assert loaded.pipe_cfg.light_block is None
    assert loaded.pipe_cfg.prescreen_top is None
    loaded.save(tmp_path / "repro_again")
    assert JMapper.load(tmp_path / "repro_again",
                        JExecutionConfig(backend="jnp"))._tune_entries \
        == theirs
    swapped = Mapper.from_index(sm, ref, PipelineConfig(), CPU)
    swapped.swap_index(tmp_path / "port")
    assert swapped.exec_cfg.tune is False and swapped._tune_entries == mine


def test_tune_session_on_cpu_then_a_tuned_session_maps_as_repro(world,
                                                                tmp_path):
    """One ``torch/`` entry per family at a tiny shape (every candidate a
    plain one, nothing flagged ``plain_faster``); a session built with
    ``tune=path`` maps as repro's session whose configs set the same
    resolved knobs."""
    ref, sm, sim = world
    p = tmp_path / "tc.json"
    entries = tune.tune_session(ref, sm, exec_cfg=CPU, batch=16, reps=1,
                                long_read_len=900, path=p)
    assert tune.load_cache(p) == entries
    assert sorted(k.split("/")[1] for k in entries) == sorted(tune.FAMILIES)
    for key, e in entries.items():
        assert key.startswith("torch/") and "plain_faster" not in e, key
        assert e["us"] <= e["staged_us"] and e["params"]["backend"] == \
            "torch", (key, e)
        assert e["meta"]["platform"] == "cpu" and e["meta"]["tune_s"] > 0
    ca = next(e for k, e in entries.items() if "candidate_align" in k)
    assert len(ca["meta"]["candidates_us"]) == 4
    m = Mapper.from_index(sm, ref, PipelineConfig(), dataclasses.replace(
        CPU, stream_batch=16, tune=str(p)))
    c = m.pipe_cfg
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=TB))
    jm = JMapper.from_index(jsm, ref, JPipelineConfig(
        prescreen_top=c.prescreen_top, packed_ref=c.packed_ref,
        dp_band=c.dp_band), JExecutionConfig(backend="jnp"))
    _assert_same(m.map(sim.reads1, sim.reads2),
                 jm.map(sim.reads1, sim.reads2))


def test_tune_cli_on_the_cpu(tmp_path, capsys):
    tune.main(["--device", "cpu", "--ref-len", "20000", "--table-bits",
               "12", "--batch", "8", "--reps", "1", "--families",
               "pair_frontend,location_vote", "--cache",
               str(tmp_path / "tc.json")])
    out = capsys.readouterr().out
    assert "wrote" in out and "torch/pair_frontend/B8_" in out
    assert len(tune.load_cache(tmp_path / "tc.json")) == 2


# -------------------------------------------------------------- winners --
def test_winner_picks_a_kernel_and_flags_a_faster_plain():
    timed = {"staged": ({"backend": "torch"}, 100.0),
             "block8": ({"block": 8}, 250.0),
             "block16": ({"block": 16}, 140.0)}
    params, us, staged, faster = tune._winner(timed, "staged", ("staged",))
    assert params == {"block": 16} and us == 140.0 and staged == 100.0
    assert faster
    timed["block8"] = ({"block": 8}, 60.0)
    assert tune._winner(timed, "staged", ("staged",))[::3] == (
        {"block": 8}, False)
    only_plain = {"a": ({"x": 1}, 5.0), "b": ({"x": 2}, 3.0)}
    assert tune._winner(only_plain, "a", ("a", "b")) == (
        {"x": 2}, 3.0, 5.0, False)


def test_time_candidates_holds_kernels_to_their_plain_version():
    one = (torch.tensor([1, 2]),)
    two = (torch.tensor([1, 3]),)
    ok = tune._time_candidates([("plain", {}, lambda: one, None),
                                ("k", {"block": 1}, lambda: one, "plain")],
                               reps=2)
    assert set(ok) == {"plain", "k"} and ok["k"][0] == {"block": 1}
    with pytest.raises(RuntimeError, match="'k' differs from 'plain'"):
        tune._time_candidates([("plain", {}, lambda: one, None),
                               ("k", {}, lambda: two, "plain")])

    def fails():
        raise ValueError("launch refused")

    with pytest.raises(ValueError, match="launch refused"):
        tune._time_candidates([("plain", {}, lambda: one, None),
                               ("k", {}, fails, "plain")])


# ------------------------------------------------------ launch geometry --
def test_grids_hold_the_defaults():
    assert frontend_warps(3, 32) == 8 in tune.BLOCK_GRID["pair_frontend"]
    assert launch_shape(150, 166, 8)[1] == PAIRS_PER_BLOCK == 48
    assert 48 in tune.BLOCK_GRID["candidate_align"]
    assert residual_warps(150, 182, 24) == (8, 2)
    assert 8 in tune.BLOCK_GRID["residual_dp"]
    assert vote_warps(256) == 8 in tune.BLOCK_GRID["location_vote"]
    for b in tune.BLOCK_GRID["pair_frontend"]:
        assert frontend_warps(3, 32, b) == b
    for b in tune.BLOCK_GRID["candidate_align"]:
        assert launch_shape(150, 166, 8, b)[1] == b
    for b in tune.BLOCK_GRID["residual_dp"]:
        assert residual_warps(150, 182, 24, b)[0] == b
        assert residual_warps(150, 182, 182, b)[0] == b
    for b in tune.BLOCK_GRID["location_vote"]:
        assert vote_warps(256, b) == b


@pytest.mark.parametrize("family,block,match", [
    ("pair_frontend", 0, "1..32 warps"),
    ("pair_frontend", 33, "1..32 warps"),
    ("merge_filter", 64, "1..32 warps"),
    ("candidate_align", 0, r"1\.\.\d+ pairs"),
    ("candidate_align", 1000, r"1\.\.\d+ pairs"),
    ("residual_dp", 9, "1..8 warps"),
    ("residual_dp", -1, "1..8 warps"),
    ("location_vote", 33, "1..32 warps"),
    ("location_vote", 0, "1..32 warps"),
])
def test_out_of_range_geometry_raises(world, family, block, match):
    """A value past the kernel's limits (1,024 threads, shared memory)
    raises on the plain path too; nothing is clamped."""
    ref, sm, sim = world
    rows = torch.full((16, 32), 2**31 - 1, dtype=torch.int32)
    r = torch.from_numpy(sim.reads1)
    pos = torch.zeros((16, 8), dtype=torch.int32)
    one = torch.ones(16, dtype=torch.bool)
    call = {
        "pair_frontend": lambda: pair_frontend(rows, r, r, 50, block=block),
        "merge_filter": lambda: frontend_merge_filter(
            rows.view(16, 1, 32), rows.view(16, 1, 32), (0,), 500, 8,
            block=block),
        "candidate_align": lambda: candidate_pair_align(
            torch.from_numpy(ref), r, r, pos, pos, 8, block=block),
        "residual_dp": lambda: residual_pair_dp(
            torch.from_numpy(ref), r, r, pos[:, 0], pos[:, 0], one, one, 16,
            band=24, block=block),
        "location_vote": lambda: location_vote(
            torch.zeros((4, 256), dtype=torch.int32), 64, block=block),
    }[family]
    with pytest.raises(ValueError, match=match):
        call()


def test_shared_memory_limits_the_geometry():
    """Rows too wide for the largest block: the limit follows shared
    memory, and the kernels' defaults shrink as before."""
    assert frontend_warps(16, 96) == 2
    with pytest.raises(ValueError, match="1..2 warps"):
        frontend_warps(16, 96, 4)
    assert vote_warps(12_288) == 1
    with pytest.raises(ValueError, match="1..1 warps"):
        vote_warps(12_288, 2)
    assert residual_warps(960, 992, None) == (8, 32)
    assert residual_warps(960, 992, None, 8) == (8, 32)
    with pytest.raises(ValueError, match="1..8 warps"):
        residual_warps(960, 992, None, 9)


@pytest.mark.parametrize("C", [1, 8, 64])
@pytest.mark.parametrize("E", [8, 16])
def test_candidate_align_shape_follows_the_read(E, C):
    """Every read length the wrapper takes (E + 2 <= R < 2^14: a coarse
    grid and the lanes' edges): a block's shared memory fits; up to 1,024
    bases an item takes the power of two of 32-position lanes covering R,
    on rows holding the slack the lanes read past the read and window, and
    past that one thread (whole warps, or fewer); the default block takes
    48 pairs where they fit, the largest block fits and one more raises."""
    edges = {E + 2, 32, 33, 64, 65, 100, 128, 129, 150, 250, 251, 256, 257,
             512, 513, 1023, 1024, 1025, 1100, MAX_READ - 1}
    for R in sorted(edges | set(range(E + 2, MAX_READ, 97))):
        W = R + 2 * E
        shape = launch_shape(R, W, C)
        assert shape.shared <= MAX_SHARED, R
        assert shape.pairs == min(PAIRS_PER_BLOCK, shape.max_pairs), R
        L = shape.lanes
        if R <= MAX_LANE_READ:
            assert L in (1, 2, 4, 8, 16, 32) and R <= 32 * L, R
            assert L == 1 or 16 * L < R, R
            assert shape.threads == THREADS, R
            span = 4 * L * -(-R // (4 * L))              # 4 NW L, NW <= 8
            assert span <= 32 * L
            assert shape.sr >= span + E + 8 and shape.sw >= span + 2 * E + 8
        else:
            assert L == 0 and shape.sr >= R and shape.sw >= W, R
            assert 1 <= shape.threads <= THREADS, R
            assert shape.threads % 32 == 0 or shape.threads < 32, R
        top = launch_shape(R, W, C, shape.max_pairs)
        assert top.pairs == shape.max_pairs and top.shared <= MAX_SHARED, R
        assert top.shared + 4 * (8 * C + 1) > MAX_SHARED, R
        with pytest.raises(ValueError, match=rf"1\.\.{shape.max_pairs} pairs"):
            launch_shape(R, W, C, shape.max_pairs + 1)


def test_a_tuned_geometry_maps_as_the_default(world):
    """Any allowed block leaves the result alone (the plain path ignores
    it; on the card, `tests/test_torch_cuda.py` holds every geometry)."""
    ref, sm, sim = world
    base = Mapper.from_index(sm, ref, PipelineConfig(), CPU)
    tuned = Mapper.from_index(sm, ref, PipelineConfig(
        frontend_block=32, light_block=16, residual_block=2), CPU)
    _assert_same(tuned.map(sim.reads1, sim.reads2),
                 base.map(sim.reads1, sim.reads2))
