"""repro_torch's dry run on the CPU, fakes on "cpu" and fake process groups
in this process: the analytic MODEL_FLOPS and the genpair constants and
input specs equal repro's, the per-rank parameter and optimizer bytes
equal the shard shapes of repro's `spec_for`, the k / 2k-layer and
S-point extrapolations equal a direct count, a fake step's peak equals a
real CPU run's under the same tracker, a fake tensor that reaches a
kernel launch outside the dry run raises, a dry run's kernel route holds
in its own thread only, a kernel's cost without data counts its measured
rates, `Roofline` has repro's fields and the report reads repro-format
artifacts.

repro's own dry run (`repro.launch.dryrun`) sets XLA_FLAGS to 512 host
devices at import, so nothing here imports it: repro's pure functions
(`repro.roofline`, `repro.sharding.partition.spec_for`) stand in.
Counts are exact (eager runs the same ops at every depth): equality,
or 1e-9 relative where floats are summed in another order.
"""
import dataclasses
import json
import math
import threading
import types

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import roofline as jroofline
from repro.configs import genpair as jgenpair
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.genpairx_step import genpair_input_specs as jax_specs
from repro.models.model import model_abstract_params, model_param_axes
from repro.optim.adamw import _should_factor as jax_should_factor
from repro.sharding.partition import PROD_RULES as JPROD_RULES
from repro.sharding.partition import spec_for as jax_spec_for
from repro_torch import roofline
from repro_torch.configs import genpair
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.genpairx_step import genpair_input_specs
from repro_torch.kernels import _cuda
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.candidate_align.ops import (
    CANDIDATES_PER_PAIR, VALID_CANDIDATES_PER_PAIR, candidate_align_cost,
)
from repro_torch.kernels.xxhash.ops import xxhash32, xxhash32_cost
from repro_torch.launch import dryrun as D
from repro_torch.launch import report
from repro_torch.sharding.partition import PROD_RULES
from repro_torch.tree import tree_leaves

FAMILIES = ("yi-6b", "kimi-k2-1t-a32b", "mamba2-2.7b", "zamba2-2.7b",
            "qwen2-vl-7b", "musicgen-medium")
MESHES = ((1, 1), (2, 2), (1, 4))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _world(mesh_shape):
    return D.fake_world(mesh_shape[0] * mesh_shape[1]) \
        if tuple(mesh_shape) != (1, 1) else _null()


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


# ------------------------------------------------------------ constants ---
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equal_repro(arch):
    for name, jshape in JSHAPES.items():
        assert roofline.model_flops_for(get_config(arch), SHAPES[name]) == \
            jroofline.model_flops_for(jax_config(arch), jshape), name


def test_roofline_fields_equal_repro():
    names = [f.name for f in dataclasses.fields(roofline.Roofline)]
    assert names == [f.name for f in dataclasses.fields(jroofline.Roofline)]
    rf = roofline.roofline({"bfloat16": 989e12, "float32": 67e12}, 0.0,
                           3.35e12, 0.0, 0.5, 4, 1e15)
    assert (rf.compute_s, rf.memory_s, rf.collective_s) == (2.0, 1.0, 0.5)
    assert rf.bottleneck == "compute" and rf.time_s == 2.0
    assert rf.useful_ratio == pytest.approx(1e15 / (4 * 989e12 + 4 * 67e12))
    assert roofline.link_bw(range(8)) == roofline.NVLINK_BW
    assert roofline.link_bw([0, 8]) == roofline.IB_BW


@pytest.mark.parametrize("n_shards", (1, 4, 16))
def test_genpair_constants_and_specs_equal_repro(n_shards):
    assert dataclasses.asdict(genpair.SCALE) == \
        dataclasses.asdict(jgenpair.SCALE)
    assert dataclasses.asdict(genpair.SMOKE_SCALE) == \
        dataclasses.asdict(jgenpair.SMOKE_SCALE)
    for ours, theirs in ((genpair.SEEDMAP, jgenpair.SEEDMAP),
                         (genpair.SMOKE_SEEDMAP, jgenpair.SMOKE_SEEDMAP)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    shared = {f.name for f in dataclasses.fields(jgenpair.PIPELINE)} & \
        {f.name for f in dataclasses.fields(genpair.PIPELINE)}
    assert {"packed_ref", "read_len", "max_candidates"} <= shared
    for f in shared - {"scoring"}:
        assert getattr(genpair.PIPELINE, f) == \
            getattr(jgenpair.PIPELINE, f), f
    assert genpair.SHAPE_NAMES == jgenpair.SHAPE_NAMES
    for scale in ("SCALE", "SMOKE_SCALE"):
        ours = genpair_input_specs(getattr(genpair, scale), n_shards)
        theirs = jax_specs(getattr(jgenpair, scale), n_shards)
        assert ours.keys() == theirs.keys()
        for k, (shape, dtype) in ours.items():
            assert shape == tuple(theirs[k].shape), k
            assert dtype.itemsize == theirs[k].dtype.itemsize, k
            # the port holds the packed words as int32 (repro: uint32)
            want = "int32" if k == "ref_words" else theirs[k].dtype.name
            assert str(dtype).removeprefix("torch.") == want, k


# ------------------------------------------------- a rank's state bytes ---
def _expected_state_bytes(name, mesh_shape):
    """Per-rank parameter and optimizer-state bytes from repro's template
    and `spec_for` over the mesh's extents (no jax devices)."""
    jcfg = jax_smoke_config(name)
    stub = types.SimpleNamespace(shape=dict(zip(("data", "model"),
                                                mesh_shape)))
    params = model_abstract_params(jcfg)
    axes = model_param_axes(jcfg)
    factor = name.startswith("kimi")         # opt_config_for: adafactor
    opt_cfg = D.opt_config_for(get_smoke_config(name))
    p_bytes = o_bytes = 0

    def walk(p, ax):
        nonlocal p_bytes, o_bytes
        if isinstance(p, dict):
            for k in p:
                walk(p[k], ax[k])
            return
        spec = jax_spec_for(ax, JPROD_RULES, p.shape, stub)
        local = []
        for n, entry in zip(p.shape, tuple(spec) + (None,) * len(p.shape)):
            for a in (() if entry is None else entry if isinstance(
                    entry, tuple) else (entry,)):
                n //= stub.shape[a]
            local.append(n)
        p_bytes += math.prod(local) * p.dtype.itemsize
        if not factor:
            o_bytes += 2 * math.prod(local) * 4
        elif jax_should_factor(p.shape, opt_cfg):
            o_bytes += (math.prod(local[:-1]) + math.prod(
                local[:-2] + local[-1:])) * 4
        else:
            o_bytes += math.prod(local) * 4

    walk(params, axes)
    return p_bytes, o_bytes + 4              # + the int32 step


@pytest.mark.parametrize("name", FAMILIES)
def test_per_rank_state_bytes_equal_repro_specs(name):
    cfg = get_smoke_config(name)
    shape = ShapeConfig("t", 32, 4, "train")
    for mesh_shape in MESHES:
        with _world(mesh_shape):
            mesh = D._make_mesh(mesh_shape)
            build = D.lm_step(cfg, shape, mesh, PROD_RULES, "cpu")
            with FakeTensorMode():
                _, groups = build()
                counter = D.Counter(False)
                counter.add_arguments(groups)
        got = counter._args
        assert (got["params"], got["opt_state"]) == \
            _expected_state_bytes(name, mesh_shape), mesh_shape


# ------------------------------------------------------- extrapolation ----
@pytest.mark.parametrize("name,kind,mesh_shape", [
    ("yi-6b", "train", (2, 2)), ("zamba2-2.7b", "prefill", (1, 1)),
    ("kimi-k2-1t-a32b", "decode", (1, 2))])
def test_layer_extrapolation_equals_full_depth(name, kind, mesh_shape):
    cfg = D.with_layers(get_smoke_config(name), 6)
    shape = ShapeConfig("t", 32, 4, kind)
    with _world(mesh_shape):
        mesh = D._make_mesh(mesh_shape)

        def make(c):
            return D.lm_step(c, shape, mesh, PROD_RULES, "cpu")

        fit = D.trace_depth(make, cfg, "cpu")
        full = D.trace_depth(make, cfg, "cpu", full_depth=True)
    assert fit["traced"] == [1, 2] and full["traced"] == [6]
    # the peak within a few scalars: an MoE layer's loss scalars live on
    # into the next layer, which the first layer of a trace lacks
    for key in ("peak_bytes", "temp_size_in_bytes", "total_nonalias_bytes"):
        assert abs(fit["memory"][key] - full["memory"][key]) <= 64, key
    for key, v in full["memory"].items():
        if key not in ("peak_bytes", "temp_size_in_bytes",
                       "total_nonalias_bytes"):
            assert fit["memory"][key] == v, key
    for m in ("flops", "int_ops", "bytes", "coll", "coll_s"):
        assert _rel(fit["costs"][m], full["costs"][m]) < 1e-9, m
    assert full["costs"]["coll"] > 0 or mesh_shape == (1, 1)


@pytest.mark.parametrize("name,points", [("yi-6b", [256, 384, 512]),
                                         ("mamba2-2.7b", [64, 128])])
def test_seq_extrapolation_equals_full_length(name, points):
    # blocks of 128: every point runs the blockwise attention (a prompt
    # up to the block runs dense)
    cfg = dataclasses.replace(get_smoke_config(name), attn_block_q=128,
                              attn_block_k=128)
    shape = ShapeConfig("t", 1024, 2, "prefill")
    fit = D.seq_extrapolated(cfg, shape, None, PROD_RULES, points, 2, "cpu")
    full = D.trace(D.lm_step(cfg, shape, None, PROD_RULES, "cpu"),
                   "cpu")["costs"]
    for m in ("flops", "bytes"):
        assert _rel(fit[m], full[m]) < 1e-9, m


# --------------------------------------------------- fake against real ----
def _real_run(build):
    """``build()`` outside the fake mode: real CPU tensors (parameters
    normal, tokens 0) through the same `Counter`."""
    step, groups = build()
    with torch.no_grad():
        for t in tree_leaves(groups):
            if t.is_floating_point():
                t.normal_(0, 0.02)
            else:
                t.zero_()
    counter = D.Counter(False)
    counter.add_arguments(groups)
    with counter:
        out = step()
    return counter.memory(out), counter.costs()


@pytest.mark.parametrize("kind", ("prefill", "train"))
def test_fake_peak_equals_real_cpu_run(kind):
    cfg = get_smoke_config("yi-6b")
    build = D.lm_step(cfg, ShapeConfig("t", 64, 2, kind), None, PROD_RULES,
                      "cpu")
    fake = D.trace(build, "cpu", kernels=False)
    mem, costs = _real_run(build)
    assert fake["memory"] == mem
    for m in ("flops", "bytes"):
        assert _rel(fake["costs"][m], costs[m]) < 1e-12, m


# --------------------------------------------------------- the kernels ----
@pytest.mark.parametrize("prescreen", (0, 4))
def test_candidate_align_cost_without_data_counts_its_rates(prescreen):
    # a batch with the rates' counts: 65,536 pairs, 8,522 without a
    # candidate, 57,973 valid candidates in all (none above 4)
    B = 65_536
    n = torch.cat([torch.zeros(8_522), torch.ones(56_055),
                   torch.full((959,), 2.0)]).int()
    assert int(n.sum()) == round(B * VALID_CANDIDATES_PER_PAIR)
    assert int(n.clamp(min=1).sum()) * 2 == round(2 * B * CANDIDATES_PER_PAIR)
    assert candidate_align_cost(B, 150, 8, 8, True, prescreen) == \
        candidate_align_cost(B, 150, 8, 8, True, prescreen, n)
    assert D.DATA_STATISTICS["valid_candidates_per_pair"] == \
        VALID_CANDIDATES_PER_PAIR


def test_fake_tensor_reaching_a_launch_outside_the_dry_run_raises():
    kernel = _cuda.KERNELS["xxhash32"]
    with FakeTensorMode():
        words = torch.empty((10, 4), dtype=torch.int32)
        out = torch.empty(10, dtype=torch.int64)
        with pytest.raises(RuntimeError, match="outside a dry run"):
            kernel(words, 10, 0, out, stream=words, work=(10,))
        seen = []
        with _cuda.dry_run_launches(lambda n, w: seen.append((n, w)),
                                    route_kernels=True):
            got = xxhash32(words, 7)
    assert seen == [("xxhash32", xxhash32_cost(10))]
    assert got.shape == (10,) and kernel.launches == 0
    # without the dry run's kernel route the CPU runs the plain version
    with pytest.raises(ValueError, match="needs tensors on a CUDA device"):
        xxhash32(torch.zeros((1, 4), dtype=torch.int32), backend="cuda")


def test_a_dry_run_routes_only_its_own_thread():
    seen = {}

    def other():
        seen["route"] = resolve_backend("auto", "cpu")
        seen["dry"] = _cuda.routes_kernels()

    with _cuda.dry_run_launches(lambda n, w: None, route_kernels=True):
        assert resolve_backend("auto", "cpu") == "cuda"
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen == {"route": "torch", "dry": False}
    assert resolve_backend("auto", "cpu") == "torch"


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_genpair_step_records_its_kernels(mesh_shape):
    scale = genpair.SMOKE_SCALE
    with D.fake_world(mesh_shape[0] * mesh_shape[1]):
        run = D.trace(D.genpair_step(scale, genpair.PIPELINE,
                                     genpair.SMOKE_SEEDMAP, mesh_shape,
                                     "cpu"), "cpu")
    k = run["costs"]["kernels"]
    assert {n: v["launches"] for n, v in k.items()} == {
        "seed_buckets": 1, "merge_filter": 1, "candidate_align": 1,
        "residual_dp": 1}
    B = scale.global_batch // mesh_shape[0]     # this rank's rows
    R, p = scale.read_len, genpair.PIPELINE
    want = _cuda.KERNELS["candidate_align"].cost(
        B, R, p.max_candidates, p.max_gap, True, 0)
    assert k["candidate_align"]["bytes"] == want.bytes
    assert k["candidate_align"]["ops"] == want.ops
    coll = run["costs"]["coll_count_by_kind"]
    assert coll.get("all-reduce", 0) == (mesh_shape[1] > 1)
    assert coll.get("all-gather", 0) == 2 * (mesh_shape[0] > 1)
    arg = run["memory"]["argument_bytes"]
    assert arg["batch"] == 2 * scale.global_batch * R


def test_fake_group_of_256_and_its_collectives():
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa
    with D.fake_world(256):
        mesh = D._make_mesh((16, 16))
        assert list(mesh.get_coordinate()) == [0, 0]
        with FakeTensorMode():
            counter = D.Counter(True)
            with counter:
                x = torch.ones((4, 8))
                out = torch.empty((64, 8))
                torch.distributed.all_gather_into_tensor(
                    out, x, group=mesh.get_group("model"))
                torch.distributed.all_reduce(x, group=mesh.get_group("data"))
                # a layout on the meta device holds no memory
                torch.zeros((1 << 20,), device="meta")
    assert counter.coll_bytes == {"all-gather": 128, "all-reduce": 128}
    # model: 16 ranks over two nodes of 8; data: a stride of 16
    assert counter.coll_s == 2 * 128 / roofline.IB_BW
    # the caching allocator's 512-byte blocks
    assert max(counter.timeline) == 512 + 2048
    assert not torch.distributed.is_initialized()


# -------------------------------------------------------------- report ----
def test_report_reads_repro_and_port_artifacts(tmp_path):
    jax_cell = {"arch": "yi-6b", "shape": "train_4k", "mesh": "pod_256",
                "n_chips": 256, "variant": "",
                "memory": {"total_nonalias_bytes": 3 * 2**30},
                "roofline": {"compute_s": 0.5, "memory_s": 0.25,
                             "collective_s": 2e-4, "bottleneck": "compute",
                             "useful_ratio": 0.8},
                "collectives": {"bytes": {"all-reduce": 1}}}
    (tmp_path / "yi-6b__train_4k__pod_256.json").write_text(
        json.dumps(jax_cell))
    D.run_cell("kimi-k2-1t-a32b", "long_500k", out_dir=str(tmp_path),
               device="cpu")
    D.run_cell("kimi-k2-1t-a32b", "decode_32k", mesh_shape=(1, 4),
               out_dir=str(tmp_path), device="cpu")
    cells = report.load_cells(str(tmp_path))
    assert len(cells) == 3
    pod = report.table(cells, "pod_256")
    assert "| yi-6b | train_4k | 500.0ms | 250.0ms | 200µs | **compute** " \
           "| 0.80 | 3.00 |" in pod
    assert "skipped: long_500k requires sub-quadratic arch" in pod
    small = report.table(cells, "mesh_1x4")
    assert "| kimi-k2-1t-a32b | decode_32k |" in small
    assert "H100" in report.header()
