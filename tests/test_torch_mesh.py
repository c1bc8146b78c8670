"""repro_torch's mesh plans against repro's on the CPU, exact equality (all
integer arithmetic, no tolerance): the merge + Δ filter of gathered
locations (`frontend_merge_filter`) against repro's jnp and interpret
results, the bucket-sharded SeedMap (`shard_seedmap`, `_local_query`),
the sharded-index and data-parallel `Mapper`s on a one-rank gloo mesh in
this process, and, run as a subprocess of 4 gloo ranks on a 2 x 2 CPU mesh
(this file's ``__main__``), both mesh Mappers against results repro
computed here and saved as ``.npz``.

    python tests/test_torch_mesh.py NPZ RANK WORLD INIT_FILE   # one rank
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import PipelineConfig as JPipelineConfig
from repro.core import SeedMapConfig as JSeedMapConfig
from repro.core import build_seedmap as j_build_seedmap
from repro.core import to_padded as j_to_padded
from repro.core.distributed import _local_query as j_local_query
from repro.core.distributed import shard_seedmap as j_shard_seedmap
from repro.core.query import query_read_batch as j_query_read_batch
from repro.core.seeding import seed_read_batch as j_seed_read_batch
from repro.core.seedmap import SeedMap as JSeedMap
from repro.engine import ExecutionConfig as JExecutionConfig
from repro.engine import Mapper as JMapper
from repro.kernels.pair_frontend.ops import (
    frontend_merge_filter as j_merge_filter,
)
from repro.launch.mesh import make_auto_mesh
from repro_torch.convert import (
    config_from_fields,
    padded_from_numpy,
    seedmap_from_numpy,
    sharded_from_numpy,
)
from repro_torch.core.distributed import (
    RowSplit,
    SeedMapShard,
    _local_query,
    shard_seedmap,
)
from repro_torch.core.long_read import LongReadConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.query import merge_read_starts
from repro_torch.core.seedmap import INVALID_LOC
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_long_reads,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, Mapper
from repro_torch.kernels.pair_frontend.ops import frontend_merge_filter
from repro_torch.kernels.pair_frontend.ref import merge_filter_ref
from repro_torch.launch.mesh import make_mesh

BITS = 16
B = 64
TAIL = 14             # ragged tail of the stream (padded to B, masked)
LONG_B, LONG_LEN = 8, 1500
REPL_FRAC = 0.3      # the data-parallel check's residual buffer fraction
WORKER_TIMEOUT = 300  # seconds for the 4-rank subprocess run


def _assert_same(got, want, msg=""):
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{f} {msg}")


# ------------------------------------------------------------ merge_filter --
def _locs(S, K, seed, b=16, lo=-40, hi=200):
    """(b, S, K) locations per mate: a narrow range (duplicate starts and
    candidate overflow), locations below the seed offsets (negative starts
    at the origin), one all-invalid row, one all-invalid mate-2 row and
    two duplicate-heavy rows."""
    rng = np.random.default_rng(seed)
    l1, l2 = (rng.integers(lo, hi, (b, S, K)).astype(np.int32)
              for _ in range(2))
    for x in (l1, l2):
        x[rng.random(x.shape) < 0.3] = INVALID_LOC
        x[0] = INVALID_LOC
        x[2] = 60
        x[3, :, : K // 2] = 5
    l2[1] = INVALID_LOC
    return l1, l2


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("C", [1, 4, 8])
def test_merge_filter_matches_repro(S, K, C):
    l1, l2 = _locs(S, K, seed=100 * S + 10 * K + C)
    offs = tuple(int(o) for o in np.round(np.arange(S) * 48 / (S - 1)))
    delta = 30 + 10 * C
    want = j_merge_filter(jnp.asarray(l1), jnp.asarray(l2), offs, delta, C,
                          backend="jnp")
    interp = j_merge_filter(jnp.asarray(l1), jnp.asarray(l2), offs, delta, C,
                            block=8, backend="interpret")
    t1, t2 = torch.as_tensor(l1), torch.as_tensor(l2)
    ref = merge_filter_ref(t1, t2, torch.tensor(offs, dtype=torch.int32),
                           delta, C)
    op = frontend_merge_filter(t1, t2, offs, delta, C, backend="torch")
    for got in (ref, op):
        _assert_same(got, want, f"S={S} K={K} C={C} vs jnp")
        _assert_same(got, interp, f"S={S} K={K} C={C} vs interpret")
    assert int(op.n[0]) == 0 and int(op.n_hits1[0]) == 0
    assert int(op.n_hits2[1]) == 0 and int(op.n[1]) == 0
    assert (op.n.numpy() <= C).all()


def test_merge_filter_cuda_backend_needs_cuda_tensors():
    l1, l2 = (torch.as_tensor(x) for x in _locs(3, 4, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        frontend_merge_filter(l1, l2, (0, 24, 48), 30, 4, backend="cuda")


# ------------------------------------------------------- sharded SeedMap --
@pytest.fixture(scope="module")
def world():
    ref = random_reference(120_000, np.random.default_rng(0))
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=BITS))
    sm = seedmap_from_numpy(np.asarray(jsm.offsets),
                            np.asarray(jsm.locations),
                            dataclasses.asdict(jsm.config))
    sim = simulate_pairs(ref, B, ReadSimConfig(sub_rate=0.015), seed=3)
    # a pair whose mate 1 starts 5 bases before the reference origin
    sim.reads1[0, 5:] = ref[:145]
    sim.reads2[0] = (3 - ref[200:350])[::-1]
    return ref, jsm, sm, sim


@pytest.mark.parametrize("D", [1, 2, 4])
def test_shard_seedmap_matches_repro(world, D):
    _, jsm, sm, _ = world
    jssm = j_shard_seedmap(jsm, D)
    ssm = shard_seedmap(sm, D)
    assert ssm.n_shards == D
    np.testing.assert_array_equal(ssm.offsets.numpy(),
                                  np.asarray(jssm.offsets))
    np.testing.assert_array_equal(ssm.locations.numpy(),
                                  np.asarray(jssm.locations))
    fields = dataclasses.asdict(jssm.config)
    conv = sharded_from_numpy(jssm.offsets, jssm.locations, fields)
    assert conv.config == ssm.config
    assert torch.equal(conv.offsets, ssm.offsets)
    for d in range(D):
        one = sharded_from_numpy(jssm.offsets, jssm.locations, fields,
                                 shard=d)
        assert isinstance(one, SeedMapShard) and one.shard_id == d
        assert torch.equal(one.offsets, ssm.shard(d).offsets)
        assert torch.equal(one.locations, ssm.shard(d).locations)


def test_shard_seedmap_empty_shards_match_repro():
    """Every location in bucket 1: three of four shards are empty and the
    location rows stay at least one slot wide."""
    cfg = dict(seed_len=50, table_bits=4, max_locations=500, hash_seed=0,
               padded_cap=32)
    offsets = np.array([0, 0] + [3] * 15, np.int32)
    locations = np.array([7, 70, 700], np.int32)
    jsm = JSeedMap(jnp.asarray(offsets), jnp.asarray(locations),
                   JSeedMapConfig(**cfg))
    sm = seedmap_from_numpy(offsets, locations, cfg)
    for D in (4, 16):
        jssm, ssm = j_shard_seedmap(jsm, D), shard_seedmap(sm, D)
        np.testing.assert_array_equal(ssm.offsets.numpy(),
                                      np.asarray(jssm.offsets))
        np.testing.assert_array_equal(ssm.locations.numpy(),
                                      np.asarray(jssm.locations))
    assert shard_seedmap(sm, 16).locations.shape == (16, 3)
    with pytest.raises(ValueError, match="divide"):
        shard_seedmap(sm, 3)


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("K", [4, 32])
def test_local_query_matches_repro_and_csr(world, D, K):
    """Each shard's answer equals repro's; their element-wise min (the
    all_reduce of the serve step) merges to repro's CSR query."""
    _, jsm, sm, sim = world
    jseeds = j_seed_read_batch(jnp.asarray(sim.reads1), 50, 3,
                               jsm.config.hash_seed)
    hashes = torch.as_tensor(np.asarray(jseeds.hashes).astype(np.int64))
    buckets = (hashes & (sm.config.table_size - 1)).to(torch.int32)
    jssm, ssm = j_shard_seedmap(jsm, D), shard_seedmap(sm, D)
    shards = []
    for d in range(D):
        jl, jc = j_local_query(jssm.offsets[d], jssm.locations[d], d,
                               jseeds.hashes, jsm.config, K)
        sh = ssm.shard(d)
        locs, count = _local_query(sh.offsets, sh.locations, d, hashes,
                                   sh.config, K)
        np.testing.assert_array_equal(locs.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
        by_id, _ = _local_query(sh.offsets, sh.locations, d, buckets,
                                sh.config, K)
        assert torch.equal(by_id, locs)
        shards.append(locs)
    merged = merge_read_starts(torch.stack(shards).amin(0),
                               torch.tensor(np.asarray(jseeds.offsets)))
    want = j_query_read_batch(jsm, jseeds, K)
    np.testing.assert_array_equal(merged.starts.numpy(),
                                  np.asarray(want.starts))
    np.testing.assert_array_equal(merged.n_hits.numpy(),
                                  np.asarray(want.n_hits))


def test_row_split_rows_and_refuses_ragged():
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(RowSplit(2, 3, None).rows(x), x[4:])
    with pytest.raises(ValueError, match="does not divide"):
        RowSplit(0, 4, None).rows(x)


# -------------------------------------------------- one-rank gloo mesh ----
@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    """A (1, 1) ("data", "model") CPU mesh over a one-rank gloo group."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh11():
    return make_auto_mesh((1, 1), ("data", "model"))


def _port_cfg(jcfg):
    return config_from_fields(PipelineConfig, dataclasses.asdict(jcfg))


@pytest.mark.parametrize("packed,frac", [(None, 0.25), (False, 0.25),
                                         (None, 0.0), (None, 1.0)])
def test_shard_index_mapper_matches_repro(world, mesh11, jmesh11, packed,
                                          frac):
    ref, jsm, sm, sim = world
    jcfg = JPipelineConfig(packed_ref=packed, residual_capacity_frac=frac)
    want = JMapper.from_index(
        jsm, ref, jcfg, JExecutionConfig(mesh=jmesh11, shard_index=True,
                                         backend="jnp")
    ).map(sim.reads1, sim.reads2)
    mapper = Mapper.from_index(sm, ref, _port_cfg(jcfg), ExecutionConfig(
        device="cpu", mesh=mesh11, shard_index=True))
    assert mapper.pipe_cfg.packed_ref is (packed is None)
    assert isinstance(mapper.index, SeedMapShard)
    assert mapper.lr_cfg is None
    got = mapper.map(sim.reads1, sim.reads2)
    _assert_same(got, want, f"packed={packed} frac={frac}")
    assert got.passed_adjacency[0] and (got.pos1[0] == -5 or frac == 0)


def test_data_parallel_mapper_matches_repro(world, mesh11):
    ref, jsm, sm, sim = world
    jcfg = JPipelineConfig()
    want = JMapper.from_index(jsm, ref, jcfg, JExecutionConfig(
        backend="jnp")).map(sim.reads1, sim.reads2)
    mapper = Mapper.from_index(sm, ref, _port_cfg(jcfg), ExecutionConfig(
        device="cpu", mesh=mesh11))
    assert mapper.pipe_cfg.packed_ref is False
    _assert_same(mapper.map(sim.reads1, sim.reads2), want, "data-parallel")


def _stream_batches(sim):
    return [(sim.reads1, sim.reads2),
            (sim.reads1[:TAIL], sim.reads2[:TAIL]),
            (sim.reads1[::-1], sim.reads2[::-1])]


def test_shard_index_map_stream_matches_repro(world, mesh11, jmesh11):
    ref, jsm, sm, sim = world
    want = JMapper.from_index(jsm, ref, JPipelineConfig(), JExecutionConfig(
        mesh=jmesh11, shard_index=True, backend="jnp", stream_batch=B)
    ).map_stream(iter(_stream_batches(sim)))
    mapper = Mapper.from_index(sm, ref, PipelineConfig(), ExecutionConfig(
        device="cpu", mesh=mesh11, shard_index=True, stream_batch=B))
    seen = []
    got = mapper.map_stream(iter(_stream_batches(sim)),
                            on_result=lambda i, res, n: seen.append(res))
    assert got.totals == want.totals
    assert got.n_pairs == 2 * B + TAIL == got.totals["n_pairs"]
    nv = seen[1].n_valid.numpy()
    assert nv[:TAIL].all() and not nv[TAIL:].any()


def test_shard_index_refusals(world, mesh11):
    ref, jsm, sm, sim = world
    shard = ExecutionConfig(device="cpu", mesh=mesh11, shard_index=True)
    with pytest.raises(ValueError, match="requires a mesh"):
        ExecutionConfig(device="cpu", shard_index=True)
    with pytest.raises(ValueError, match="long-read"):
        ExecutionConfig(device="cpu", mesh=mesh11, shard_index=True,
                        long_read=LongReadConfig())
    jpsm = j_to_padded(jsm, cap=32)
    psm = padded_from_numpy(np.asarray(jpsm.rows), np.asarray(jpsm.counts),
                            dataclasses.asdict(jpsm.config))
    with pytest.raises(TypeError, match="CSR SeedMap"):
        Mapper.from_index(psm, ref, PipelineConfig(), shard)
    mapper = Mapper.from_index(sm, ref, PipelineConfig(), shard)
    long_reads, _ = simulate_long_reads(ref, 2, LONG_LEN, seed=1)
    with pytest.raises(NotImplementedError, match="long-read"):
        mapper.map_long(long_reads)
    with pytest.raises(NotImplementedError, match="long-read"):
        mapper.map_long_stream(iter([(long_reads,)]))


def test_mesh_config_refusals(mesh11):
    with pytest.raises(ValueError, match="lack"):
        ExecutionConfig(device="cpu", mesh=mesh11, model_axis="tp",
                        shard_index=True)
    with pytest.raises(ValueError, match="one mesh axis"):
        ExecutionConfig(device="cpu", mesh=mesh11,
                        batch_axes=("data", "model"))
    with pytest.raises((RuntimeError, ValueError), match="cuda"):
        ExecutionConfig(mesh=mesh11).torch_device()     # a "cpu" mesh
    assert ExecutionConfig(device="cpu", mesh=mesh11).torch_device() == \
        torch.device("cpu")


# ------------------------------------------------- 4 gloo ranks, 2 x 2 ----
def test_four_rank_mesh_mappers_match_repro(world, jmesh11, tmp_path):
    """Both mesh Mappers on a 2 x 2 ("data", "model") gloo mesh of 4 CPU
    processes against repro's results computed here: every MapResult field
    (the residual buffer filled over the global batch, split unevenly over
    the data ranks on the data-parallel check), ragged map_stream totals,
    a data-parallel map_long, and the refusal of a batch that does not
    divide over the data ranks."""
    ref, jsm, sm, sim = world
    shard = JMapper.from_index(jsm, ref, JPipelineConfig(), JExecutionConfig(
        mesh=jmesh11, shard_index=True, backend="jnp", stream_batch=B))
    # 19 buffer rows: the data ranks split them with one filler row
    repl = JMapper.from_index(
        jsm, ref, JPipelineConfig(residual_capacity_frac=REPL_FRAC),
        JExecutionConfig(backend="jnp", stream_batch=B))
    long_reads, _ = simulate_long_reads(ref, LONG_B, LONG_LEN, seed=5)
    arrays = {"ref": ref, "offsets": np.asarray(jsm.offsets),
              "locations": np.asarray(jsm.locations),
              "reads1": sim.reads1, "reads2": sim.reads2,
              "long_reads": long_reads}
    for tag, res in (("shard", shard.map(sim.reads1, sim.reads2)),
                     ("repl", repl.map(sim.reads1, sim.reads2)),
                     ("long", repl.map_long(long_reads))):
        arrays.update({f"{tag}.{f}": np.asarray(getattr(res, f))
                       for f in res._fields})
    totals = {tag: m.map_stream(iter(_stream_batches(sim))).totals
              for tag, m in (("shard", shard), ("repl", repl))}
    arrays["meta"] = np.array(json.dumps({
        "config": dataclasses.asdict(jsm.config), "totals": totals}))
    npz = tmp_path / "want.npz"
    np.savez(npz, **arrays)

    store = tmp_path / "store"
    env = {**os.environ,
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), os.pardir,
                                      "src")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(npz), str(rank), "4", str(store)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = "\n".join(f"-- rank {r} (rc {p.returncode})\n{o}"
                       for r, (p, o) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), report
    assert all(o.count("ok:") == 5 for o in outs), report


def _worker(npz, rank: int, world_size: int, store: str) -> None:
    """One rank of the 4-rank check (see the test above)."""
    data = np.load(npz)
    meta = json.loads(str(data["meta"]))
    sm = seedmap_from_numpy(data["offsets"], data["locations"],
                            meta["config"])
    ref, r1, r2 = data["ref"], data["reads1"], data["reads2"]

    def same(res, tag):
        for f in res._fields:
            np.testing.assert_array_equal(getattr(res, f).numpy(),
                                          data[f"{tag}.{f}"],
                                          err_msg=f"{tag} {f} rank {rank}")

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    try:
        mesh = make_mesh((2, 2), device_type="cpu")
        base = ExecutionConfig(device="cpu", mesh=mesh, stream_batch=B)
        shard = Mapper.from_index(sm, ref, PipelineConfig(),
                                  dataclasses.replace(base, shard_index=True))
        model_rank = mesh.get_local_rank("model")
        assert shard.index.shard_id == model_rank
        assert shard.index.offsets.shape == (sm.config.table_size // 2 + 1,)
        same(shard.map(r1, r2), "shard")
        print(f"ok: rank {rank} shard_index map == repro")
        repl = Mapper.from_index(
            sm, ref, PipelineConfig(residual_capacity_frac=REPL_FRAC), base)
        same(repl.map(r1, r2), "repl")
        print(f"ok: rank {rank} data-parallel map == repro")
        batches = [(r1, r2), (r1[:TAIL], r2[:TAIL]), (r1[::-1], r2[::-1])]
        for tag, m in (("shard", shard), ("repl", repl)):
            sr = m.map_stream(iter(batches))
            assert sr.totals == meta["totals"][tag], (tag, sr.totals)
        print(f"ok: rank {rank} ragged map_stream totals == repro")
        same(repl.map_long(data["long_reads"]), "long")
        print(f"ok: rank {rank} data-parallel map_long == repro")
        for m in (shard, repl):
            try:
                m.map(r1[:B - 1], r2[:B - 1])
            except ValueError as e:
                assert "does not divide" in str(e), e
            else:
                raise AssertionError("a 63-row batch was split 2 ways")
        print(f"ok: rank {rank} refuses a batch the data ranks cannot split")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
