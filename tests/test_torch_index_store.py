"""repro_torch's index store and session persistence against repro's on
the CPU: save -> load maps identically without an index build; stores
move between the two packages both ways (CSR and padded layouts, both
reference flavors) and map as the saving session does; both packages
write byte-identical `.npy` payloads; corrupt, stale and unknown stores
degrade as repro's do; `swap_index` reuses, rebuilds or keeps, also
between two batches of a stream; `save` and `swap_index` refuse a
shard_index session."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import PipelineConfig as JPipelineConfig
from repro.core import SeedMapConfig as JSeedMapConfig
from repro.core import build_seedmap as j_build_seedmap
from repro.core import to_padded as j_to_padded
from repro.engine import ExecutionConfig as JExecutionConfig
from repro.engine import Mapper as JMapper
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import (
    PaddedSeedMap,
    SeedMap,
    SeedMapConfig,
    build_seedmap,
    to_padded,
)
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, Mapper
from repro_torch.engine.index_store import (
    MANIFEST,
    IndexStoreError,
    load_store,
    save_store,
    store_size_bytes,
)
from repro_torch.launch.mesh import make_mesh

TB = 15
CPU = ExecutionConfig(device="cpu")
JNP = JExecutionConfig(backend="jnp")


@pytest.fixture(scope="module")
def world():
    ref = random_reference(60_000, np.random.default_rng(0))
    sim = simulate_pairs(ref, 16, ReadSimConfig(sub_rate=3e-3), seed=1)
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=TB),
                          PipelineConfig(), CPU)
    return ref, sim, mapper


@pytest.fixture(scope="module")
def other_store(tmp_path_factory):
    """A second reference of the same length: a same-shape store."""
    ref_b = random_reference(60_000, np.random.default_rng(7))
    mb = Mapper.build(ref_b, SeedMapConfig(table_bits=TB), PipelineConfig(),
                      CPU)
    path = tmp_path_factory.mktemp("store_b")
    mb.save(path)
    return ref_b, mb, path


def _assert_same(a, b, msg=""):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        np.testing.assert_array_equal(x, y, err_msg=f"{f} {msg}")


def _long_reads(sim, n=4):
    return np.tile(sim.reads1, (1, 4))[:n]


# ------------------------------------------------------ round-tripping ---
def test_save_load_identity_no_build(world, tmp_path, monkeypatch):
    ref, sim, mapper = world
    store = tmp_path / "store"
    manifest = mapper.save(store)
    assert os.path.exists(manifest)
    assert store_size_bytes(store) > 0

    def boom(*a, **k):
        raise AssertionError("Mapper.load called build_seedmap")

    monkeypatch.setattr("repro_torch.core.seedmap.build_seedmap", boom)
    monkeypatch.setattr("repro_torch.engine.mapper.build_seedmap", boom)
    loaded = Mapper.load(store, CPU)
    _assert_same(mapper.map(sim.reads1, sim.reads2),
                 loaded.map(sim.reads1, sim.reads2))
    _assert_same(mapper.map_long(_long_reads(sim)),
                 loaded.map_long(_long_reads(sim)))
    assert loaded.pipe_cfg == mapper.pipe_cfg
    assert loaded.lr_cfg == mapper.lr_cfg
    assert loaded.sm_config == mapper.sm_config
    assert isinstance(loaded.index, SeedMap)

    def batches():
        yield sim.reads1, sim.reads2
        yield sim.reads1[:5], sim.reads2[:5]   # ragged tail

    a = mapper.map_stream(batches())
    b = loaded.map_stream(batches())
    assert a.totals == b.totals and a.n_pairs == b.n_pairs == 21


def _repro_session(ref, layout, packed):
    jcfg = JPipelineConfig(packed_ref=packed)
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=TB))
    index = jsm if layout == "csr" else j_to_padded(jsm, cap=32)
    return JMapper.from_index(index, ref, jcfg, JNP), jcfg


def _port_session(ref, layout, packed):
    cfg = PipelineConfig(packed_ref=packed)
    sm = build_seedmap(ref, SeedMapConfig(table_bits=TB))
    index = sm if layout == "csr" else to_padded(sm, cap=32)
    return Mapper.from_index(index, ref, cfg, CPU)


CASES = [("csr", False), ("csr", True), ("padded", False), ("padded", True)]


@pytest.mark.parametrize("layout,packed", CASES)
def test_repro_store_loads_into_port(world, tmp_path, layout, packed):
    ref, sim, _ = world
    jm, _ = _repro_session(ref, layout, packed)
    jm.save(tmp_path / "s")
    m = Mapper.load(tmp_path / "s", CPU)
    assert isinstance(m.index, SeedMap if layout == "csr" else PaddedSeedMap)
    assert m.pipe_cfg.packed_ref is packed
    assert m.ref.dtype == (torch.int32 if packed else torch.uint8)
    _assert_same(m.map(sim.reads1, sim.reads2),
                 jm.map(sim.reads1, sim.reads2), layout)
    _assert_same(m.map_long(_long_reads(sim)),
                 jm.map_long(_long_reads(sim)), layout)


@pytest.mark.parametrize("layout,packed", CASES)
def test_port_store_loads_into_repro(world, tmp_path, layout, packed):
    ref, sim, _ = world
    m = _port_session(ref, layout, packed)
    m.save(tmp_path / "s")
    jm = JMapper.load(tmp_path / "s", JNP)
    _assert_same(m.map(sim.reads1, sim.reads2),
                 jm.map(sim.reads1, sim.reads2), layout)
    _assert_same(m.map_long(_long_reads(sim)),
                 jm.map_long(_long_reads(sim)), layout)


@pytest.mark.parametrize("layout,packed", CASES)
def test_payloads_hash_the_same(world, tmp_path, layout, packed):
    """The same session saved by both packages: every `.npy` payload has
    the same dtype, shape and sha256."""
    ref = world[0]
    jm, _ = _repro_session(ref, layout, packed)
    jm.save(tmp_path / "j")
    _port_session(ref, layout, packed).save(tmp_path / "t")
    jdoc = json.loads((tmp_path / "j" / MANIFEST).read_text())
    tdoc = json.loads((tmp_path / "t" / MANIFEST).read_text())
    assert jdoc["arrays"] == tdoc["arrays"]
    assert tdoc["arrays"]["ref"]["dtype"] == ("uint32" if packed else "uint8")
    for k in ("version", "layout", "seedmap_config", "tune_entries"):
        assert jdoc[k] == tdoc[k], k
    # the JAX configs carry per-family backends and launch blocks on top
    jpipe, tpipe = jdoc["pipeline_config"], tdoc["pipeline_config"]
    assert set(tpipe) < set(jpipe)
    assert all(jpipe[k] == v for k, v in tpipe.items())


def test_cross_package_swap(world, other_store, tmp_path):
    """A repro store swaps into a port session under its state
    ("reused"); a port store lacks repro's per-family backend fields, so
    repro resolves them anew and rebuilds ("rebuilt"), then maps as the
    port does."""
    ref, sim, _ = world
    ref_b, m_b, path_b = other_store
    jm_b, _ = _repro_session(ref_b, "csr", False)
    jm_b.save(tmp_path / "j")
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), PipelineConfig(),
                     CPU)
    assert m.swap_index(tmp_path / "j") == "reused"
    _assert_same(m.map(sim.reads1, sim.reads2),
                 jm_b.map(sim.reads1, sim.reads2))
    jm, _ = _repro_session(ref, "csr", False)
    with pytest.warns(UserWarning, match="rebuilding in place"):
        assert jm.swap_index(path_b) == "rebuilt"
    _assert_same(m_b.map(sim.reads1, sim.reads2),
                 jm.map(sim.reads1, sim.reads2))


# -------------------------------------------------------- degradation ----
@pytest.fixture
def saved(world, tmp_path):
    store = tmp_path / "store"
    world[2].save(store)
    return store


def _edit_manifest(store, fn):
    mpath = store / MANIFEST
    doc = json.loads(mpath.read_text())
    fn(doc)
    mpath.write_text(json.dumps(doc))


def test_version_mismatch_degrades(world, saved):
    ref, sim, mapper = world
    _edit_manifest(saved, lambda d: d.__setitem__("version", 99))
    with pytest.warns(UserWarning, match="version-1"):
        assert load_store(saved) is None
    with pytest.raises(IndexStoreError, match="version"):
        load_store(saved, strict=True)
    with pytest.raises(IndexStoreError, match="fallback_ref"):
        with pytest.warns(UserWarning):
            Mapper.load(saved, CPU)
    with pytest.warns(UserWarning, match="rebuilding"):
        rebuilt = Mapper.load(saved, CPU, fallback_ref=ref,
                              seedmap_cfg=SeedMapConfig(table_bits=TB))
    _assert_same(mapper.map(sim.reads1, sim.reads2),
                 rebuilt.map(sim.reads1, sim.reads2))


def test_checksum_corruption_degrades(saved):
    target = saved / sorted(f for f in os.listdir(saved)
                            if f.endswith(".npy"))[0]
    raw = bytearray(target.read_bytes())
    raw[-1] ^= 0xFF
    target.write_bytes(bytes(raw))
    with pytest.warns(UserWarning, match="checksum"):
        assert load_store(saved) is None
    with pytest.raises(IndexStoreError, match="checksum"):
        load_store(saved, strict=True)


def test_manifest_shape_mismatch_degrades(saved):
    def grow(doc):
        entry = doc["arrays"][next(iter(doc["arrays"]))]
        entry["shape"] = [s + 1 for s in entry["shape"]]

    _edit_manifest(saved, grow)
    with pytest.warns(UserWarning, match="payload is"):
        assert load_store(saved) is None


@pytest.mark.parametrize("section", ["pipeline_config", "seedmap_config",
                                     "long_read_config"])
def test_unknown_config_field_degrades(saved, section):
    """A store from a future release with new config fields is stale,
    whichever config carries them."""
    _edit_manifest(saved, lambda d: d[section].__setitem__(
        "from_the_future", 42))
    with pytest.warns(UserWarning, match="index store"):
        assert load_store(saved) is None
    with pytest.raises(IndexStoreError, match="from_the_future"):
        load_store(saved, strict=True)


def test_save_store_rejects_unknown_index(world, tmp_path):
    _, _, mapper = world
    with pytest.raises(TypeError, match="cannot persist"):
        save_store(tmp_path / "x", index=object(), ref=mapper.ref,
                   pipe_cfg=mapper.pipe_cfg, sm_config=mapper.sm_config)


# ------------------------------------------------------------ hot swap ---
def test_swap_index_reused_equals_fresh_session(world, other_store):
    ref, sim, _ = world
    _, m_fresh, path_b = other_store
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), PipelineConfig(),
                     CPU)
    before = m.map(sim.reads1, sim.reads2)
    assert m.swap_index(path_b) == "reused"
    after = m.map(sim.reads1, sim.reads2)
    _assert_same(after, m_fresh.map(sim.reads1, sim.reads2))
    assert not torch.equal(after.pos1, before.pos1)


def test_swap_index_reused_replaces_the_kernel_reference(world, tmp_path):
    """A session whose backend pads the reference for the kernels
    replaces that copy too on a swap: ``kref`` equals a fresh session's
    on the new reference, with the same shape."""
    ref, _, _ = world
    ref_b = random_reference(60_000, np.random.default_rng(7))
    cfg = PipelineConfig(packed_ref=True)
    mb = Mapper.build(ref_b, SeedMapConfig(table_bits=TB), cfg, CPU)
    mb.save(tmp_path / "b")
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), cfg, CPU)
    for sess in (m, mb):           # as a CUDA session holds it
        sess.backend = "cuda"
        sess.kref = sess._kernel_ref(sess.ref)
    old = m.kref
    assert m.swap_index(tmp_path / "b") == "reused"
    assert m.kref.pad == mb.kref.pad and m.kref.data.shape == old.data.shape
    assert torch.equal(m.kref.data, mb.kref.data)
    assert not torch.equal(m.kref.data, old.data)
    assert torch.equal(m.ref, mb.ref)


def test_swap_index_mid_stream(world, other_store):
    """Swap between two dispatches: batch 0 serves the old index, batch 1
    the new one, each equal to a fresh session on that index."""
    ref, sim, _ = world
    _, m_fresh, path_b = other_store
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), PipelineConfig(),
                     dataclasses.replace(CPU, stream_batch=16))
    m_old = Mapper.build(ref, SeedMapConfig(table_bits=TB), PipelineConfig(),
                         CPU)
    got = {}

    def batches():
        yield sim.reads1, sim.reads2
        assert m.swap_index(path_b) == "reused"
        yield sim.reads1, sim.reads2

    m.map_stream(batches(),
                 on_result=lambda i, res, n: got.__setitem__(i, res))
    _assert_same(got[0], m_old.map(sim.reads1, sim.reads2))
    _assert_same(got[1], m_fresh.map(sim.reads1, sim.reads2))


def test_swap_index_rebuilds_on_shape_change(world, tmp_path):
    ref, sim, _ = world
    ref_c = random_reference(90_000, np.random.default_rng(11))
    m_c = Mapper.build(ref_c, SeedMapConfig(table_bits=TB),
                       PipelineConfig(), CPU)
    m_c.save(tmp_path / "c")
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), PipelineConfig(),
                     CPU)
    with pytest.warns(UserWarning, match="rebuilding in place"):
        assert m.swap_index(tmp_path / "c") == "rebuilt"
    _assert_same(m.map(sim.reads1, sim.reads2),
                 m_c.map(sim.reads1, sim.reads2))
    assert m.ref.shape == m_c.ref.shape


def test_swap_index_rebuilds_on_config_change(world, other_store, tmp_path):
    """A store of another resolved config (packed reference) rebuilds and
    then serves that config."""
    ref, sim, _ = world
    ref_b = other_store[0]
    cfg = PipelineConfig(packed_ref=True)
    mb = Mapper.build(ref_b, SeedMapConfig(table_bits=TB), cfg, CPU)
    mb.save(tmp_path / "p")
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), PipelineConfig(),
                     CPU)
    with pytest.warns(UserWarning, match="rebuilding in place"):
        assert m.swap_index(tmp_path / "p") == "rebuilt"
    assert m.pipe_cfg.packed_ref and m.ref.dtype == torch.int32
    _assert_same(m.map(sim.reads1, sim.reads2),
                 mb.map(sim.reads1, sim.reads2))


def test_swap_index_unreadable_keeps(world, saved):
    ref, sim, _ = world
    (saved / MANIFEST).write_text("not json at all")
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), PipelineConfig(),
                     CPU)
    before = m.map(sim.reads1, sim.reads2)
    with pytest.warns(UserWarning, match="keeping"):
        assert m.swap_index(saved) == "kept"
    _assert_same(before, m.map(sim.reads1, sim.reads2))
    with pytest.raises(IndexStoreError):
        m.swap_index(saved, strict=True)


def test_load_adopts_store_lane_config(world, tmp_path):
    ref, sim, _ = world
    from repro_torch.engine import LongReadConfig
    lr = LongReadConfig(vote_bin=32, dp_band=20)
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), PipelineConfig(),
                     dataclasses.replace(CPU, long_read=lr))
    m.save(tmp_path / "s")
    loaded = Mapper.load(tmp_path / "s", CPU)
    assert loaded.lr_cfg == m.lr_cfg and loaded.lr_cfg.vote_bin == 32
    _assert_same(loaded.map_long(_long_reads(sim)),
                 m.map_long(_long_reads(sim)))


# ------------------------------------------------------- shard_index ----
@pytest.fixture(scope="module")
def sharded(world, tmp_path_factory):
    """A shard_index session on a (1, 1) mesh of a one-rank gloo group."""
    ref = world[0]
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), device_type="cpu")
        yield Mapper.build(ref, SeedMapConfig(table_bits=TB),
                           PipelineConfig(), dataclasses.replace(
                               CPU, mesh=mesh, shard_index=True))
    finally:
        dist.destroy_process_group()


def test_shard_index_session_refuses_save_and_swap(sharded, other_store,
                                                   tmp_path):
    with pytest.raises(NotImplementedError, match="shard_index"):
        sharded.save(tmp_path / "s")
    with pytest.raises(NotImplementedError, match="shard_index"):
        sharded.swap_index(other_store[2])
