"""repro_torch's Mapper against repro's Mapper on the CPU, exact equality:
every MapResult field for both reference flavors and
residual_capacity_frac in {0, 0.25, 1}, the light-mode / prescreen /
band variants, sessions built from repro's own index, and map_stream
stage totals with a ragged tail."""
import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PipelineConfig as JPipelineConfig
from repro.core import ReadSimConfig as JReadSimConfig
from repro.core import SeedMapConfig as JSeedMapConfig
from repro.core import build_seedmap as j_build_seedmap
from repro.core import simulate_pairs as j_simulate_pairs
from repro.core import to_padded as j_to_padded
from repro.engine import ExecutionConfig as JExecutionConfig
from repro.engine import Mapper as JMapper
from repro.launch.serve import ACC_KEYS, _make_accuracy_reduce
from repro_torch.convert import (
    config_from_fields,
    padded_from_numpy,
    seedmap_from_numpy,
)
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import INVALID_LOC
from repro_torch.core.seedmap import PaddedSeedMap, SeedMap, SeedMapConfig
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, Mapper

CPU = ExecutionConfig(device="cpu")
JNP = JExecutionConfig(backend="jnp")
BITS = 16


@pytest.fixture(scope="module")
def world():
    ref = random_reference(120_000, np.random.default_rng(0))
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=BITS))
    sim = simulate_pairs(ref, 64, ReadSimConfig(sub_rate=0.015), seed=3)
    jsim = j_simulate_pairs(ref, 64, JReadSimConfig(sub_rate=0.015), seed=3)
    np.testing.assert_array_equal(sim.reads2, jsim.reads2)
    return ref, jsm, sim


def _port_cfg(jcfg):
    return config_from_fields(PipelineConfig, dataclasses.asdict(jcfg))


def _assert_same(got, want, msg=""):
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{f} {msg}")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("frac", [0, 0.25, 1.0])
def test_mapper_map_matches_repro(world, packed, frac):
    ref, jsm, sim = world
    jcfg = JPipelineConfig(packed_ref=packed, residual_capacity_frac=frac)
    want = JMapper.from_index(jsm, ref, jcfg, JNP).map(sim.reads1, sim.reads2)
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=BITS),
                          _port_cfg(jcfg), CPU)
    assert mapper.pipe_cfg.packed_ref is packed
    got = mapper.map(sim.reads1, sim.reads2)
    _assert_same(got, want, f"packed={packed} frac={frac}")
    methods = np.bincount(got.method.numpy(), minlength=5)
    assert methods[1] > 0 and (frac == 0 or methods[2] > 0)


@pytest.mark.parametrize("kw", [
    dict(light_mode="paper", prescreen_top=3),
    dict(prescreen_top=1, dp_band=200, residual_capacity_frac=0.5),
    dict(max_candidates=4, delta=300, dp_band=4, max_locs_per_seed=8),
])
def test_mapper_variants_match_repro(world, kw):
    ref, jsm, sim = world
    jcfg = JPipelineConfig(**kw)
    want = JMapper.from_index(jsm, ref, jcfg, JNP).map(sim.reads1, sim.reads2)
    got = Mapper.build(ref, SeedMapConfig(table_bits=BITS), _port_cfg(jcfg),
                       CPU).map(sim.reads1, sim.reads2)
    _assert_same(got, want, str(kw))


def test_sessions_from_repro_index_and_both_layouts(world):
    """The repro index carried over as numpy serves the same results,
    through the staged CSR path and through the padded-row path."""
    ref, jsm, sim = world
    jcfg = JPipelineConfig(packed_ref=True)
    want = JMapper.from_index(jsm, ref, jcfg, JNP).map(sim.reads1, sim.reads2)
    fields = dataclasses.asdict(jsm.config)
    sm = seedmap_from_numpy(np.asarray(jsm.offsets),
                            np.asarray(jsm.locations), fields)
    jpsm = j_to_padded(jsm, cap=32)
    psm = padded_from_numpy(np.asarray(jpsm.rows), np.asarray(jpsm.counts),
                            dataclasses.asdict(jpsm.config))
    for index, kind in ((sm, SeedMap), (psm, PaddedSeedMap)):
        mapper = Mapper.from_index(index, ref, _port_cfg(jcfg), CPU)
        assert isinstance(mapper.index, kind)
        _assert_same(mapper.map(sim.reads1, sim.reads2), want, kind.__name__)


def test_map_stream_totals_with_ragged_tail(world):
    ref, jsm, sim = world
    tail = 13
    batches = [(sim.reads1, sim.reads2), (sim.reads1[:tail], sim.reads2[:tail]),
               (sim.reads1[5:], sim.reads2[5:])]
    jcfg = JPipelineConfig(packed_ref=True)
    want = JMapper.from_index(
        jsm, ref, jcfg, JExecutionConfig(backend="jnp", stream_batch=64)
    ).map_stream(iter(batches))
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=BITS), _port_cfg(jcfg),
                          dataclasses.replace(CPU, stream_batch=64))
    seen = []
    got = mapper.map_stream(iter(batches),
                            on_result=lambda i, res, n: seen.append((i, n,
                                                                     res)))
    assert got.totals == want.totals
    assert got.n_pairs == want.n_pairs == 64 + tail + 59
    assert got.n_batches == 3
    assert [s[:2] for s in seen] == [(0, 64), (1, tail), (2, 59)]
    nv = seen[1][2].n_valid.numpy()
    assert nv[:tail].all() and not nv[tail:].any()
    assert got.fractions["light_mapped"] == pytest.approx(
        got.totals["light_mapped"] / got.totals["n_pairs"])


def test_map_stream_reduce_fn_and_warmup(world):
    ref, _, sim = world
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=BITS),
                          PipelineConfig(), CPU)

    def count_mapped(state, res, true1):
        ok = res.n_valid & ((res.pos1.long() - true1.long()).abs() <= 5)
        return state + ok.sum()

    sr = mapper.map_stream(
        iter([(sim.reads1, sim.reads2, sim.true_start1),
              (sim.reads1[:7], sim.reads2[:7], sim.true_start1[:7])]),
        reduce_fn=count_mapped, reduce_init=torch.zeros((), dtype=torch.int64),
        warmup_batch=(sim.reads1, sim.reads2))
    full = mapper.map(sim.reads1, sim.reads2)
    near = (full.pos1.long() - torch.as_tensor(sim.true_start1)).abs() <= 5
    assert int(sr.reduced) == int(near.sum() + near[:7].sum())
    with pytest.raises(ValueError, match="exceeds"):
        mapper.map_stream(iter([(sim.reads1, sim.reads2)] * 2),
                          warmup_batch=(sim.reads1[:8], sim.reads2[:8]))


class Truth(NamedTuple):
    start1: np.ndarray
    start2: np.ndarray


def _hits(res, t1, t2, gap, xp):
    """Mapped and correct mates of a batch, masked by ``n_valid``."""
    v = res.n_valid
    m1 = (res.pos1 != INVALID_LOC) & v
    m2 = (res.pos2 != INVALID_LOC) & v
    c1 = m1 & (xp.abs(res.pos1 - t1) <= gap)
    c2 = m2 & (xp.abs(res.pos2 - t2) <= gap)
    return {"mapped1": m1, "mapped2": m2, "correct1": c1, "correct2": c2,
            "pair_mapped": m1 & m2, "pair_correct": c1 & c2}


def _reduce_for(kind, gap, xp):
    """A reduce_fn over one aux shape, in jnp (xp=jnp) or torch."""
    def unpack(aux):
        if kind == "namedtuple":
            assert type(aux).__name__ == "Truth"
            return aux.start1, aux.start2
        if kind == "dict_with_none":
            assert aux["note"] is None
            return aux["true"]["start1"], aux["true"]["start2"]
        return aux

    def reduce(acc, res, aux):
        new = _hits(res, *unpack(aux), gap, xp)
        return {k: acc[k] + new[k].sum() for k in ACC_KEYS}
    return reduce


@pytest.mark.parametrize("kind", ["namedtuple", "dict_with_none",
                                  "serve_tuple"])
def test_map_stream_aux_trees_match_repro(world, kind):
    """An aux tree is padded as jax.tree.map pads it: a NamedTuple keeps
    its type, a None leaf stays None, and launch/serve.py's (t1, t2)
    tuple reaches the reduce_fn as a tuple."""
    ref, jsm, sim = world
    tail = 13

    def aux_of(sl):
        t1, t2 = sim.true_start1[sl], sim.true_start2[sl]
        if kind == "namedtuple":
            return Truth(t1, t2)
        if kind == "dict_with_none":
            return {"true": {"start1": t1, "start2": t2}, "note": None}
        return (t1, t2)

    batches = [(sim.reads1[sl], sim.reads2[sl], aux_of(sl))
               for sl in (slice(None), slice(tail), slice(5, None))]
    jcfg = JPipelineConfig(packed_ref=True)
    gap = jcfg.max_gap
    jreduce = (_make_accuracy_reduce(gap) if kind == "serve_tuple"
               else _reduce_for(kind, gap, jnp))
    want = JMapper.from_index(
        jsm, ref, jcfg, JExecutionConfig(backend="jnp", stream_batch=64)
    ).map_stream(iter(batches), reduce_fn=jreduce,
                 reduce_init={k: jnp.zeros((), jnp.int32) for k in ACC_KEYS})
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=BITS), _port_cfg(jcfg),
                          dataclasses.replace(CPU, stream_batch=64))
    got = mapper.map_stream(
        iter(batches), reduce_fn=_reduce_for(kind, gap, torch),
        reduce_init={k: torch.zeros((), dtype=torch.int64) for k in ACC_KEYS})
    assert got.totals == want.totals
    assert got.n_pairs == want.n_pairs == 64 + tail + 59
    assert {k: int(v) for k, v in got.reduced.items()} == \
        {k: int(v) for k, v in want.reduced.items()}
    assert int(got.reduced["pair_correct"]) > 0
