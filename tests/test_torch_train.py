"""repro_torch's trainer against repro on the CPU: the elastic re-mesh plan
and the sharding rules exactly, one train step from identical state, the
trainer's fault-tolerance cases (repro's test_system.py), and the LM data
stream.

One step: stablelm-3b's smoke config in float32, after one repro step
(its parameters, optimizer and codec states carried across with
`lm_params_from_jax`, `opt_state_from_jax`, `compress_state_from_jax`),
on the same batch.  Tolerances: the loss within 1e-5 relative and the
gradient norm within 1e-4 (float32 sums in another order); the updated
parameters within 1e-3 x lr of repro's, relative to the L2 norm of
repro's update, and elementwise within 2 x lr (an entry whose gradient
is near AdamW's eps, or near an int8 rounding boundary, may move its
update by up to its whole size); the int8 residual within 4e-6 of the
gradient's largest entry, but for at most 0.1 % of entries (a rounding
boundary).
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import batch_for_step as jax_batch_for_step
from repro.launch import train as jtrain
from repro.models.template import axes_tree as jax_axes_tree
from repro.models.transformer import model_template as jax_model_template
from repro.optim import adamw as jopt
from repro.optim.compress import CompressConfig as JCompressConfig
from repro.optim.compress import init_state as jax_comp_init
from repro.runtime import plan_remesh as jax_plan_remesh
from repro.sharding import partition as jpart
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import (
    compress_state_from_jax, lm_params_from_jax, opt_state_from_jax,
)
from repro_torch.data.pipeline import (
    DataConfig, batch_for_step, lm_batch_for_step,
)
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.template import leaves
from repro_torch.models.transformer import model_template
from repro_torch.optim import adamw as topt
from repro_torch.optim.compress import CompressConfig
from repro_torch.runtime import DEGRADED, EVICT, HEALTHY, plan_remesh
from repro_torch.sharding import partition as tpart
from repro_torch.tree import tree_leaves


# ------------------------------------------------------ re-mesh and rules --
def test_plan_remesh_equals_repro():
    grid = itertools.product((1, 2, 3, 8, 16, 17, 64, 256, 512),
                             range(0, 300, 7), (1, 2, 4, 16), (1, 2, 4))
    n = 0
    for n_total, n_failed, model, pods in grid:
        if n_failed >= n_total:
            continue
        want = jax_plan_remesh(n_total, n_failed, model=model, pods=pods)
        got = plan_remesh(n_total, n_failed, model=model, pods=pods)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (
            n_total, n_failed, model, pods)
        n += 1
    assert n > 1000
    with pytest.raises(ValueError):
        plan_remesh(4, 4)


class FakeMesh:
    """What both packages' spec_for read of a mesh: its axis names and
    sizes (repro's ``mesh.shape`` is a dict, a DeviceMesh's a tuple)."""

    def __init__(self, **sizes):
        self.sizes = sizes
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


MESHES = [None, FakeMesh(data=16, model=16), FakeMesh(data=4, model=2),
          FakeMesh(pod=2, data=16, model=16)]
RULES = [("prod", dict()), ("multipod", dict(batch_axes=("pod", "data"))),
         ("no_fsdp", dict(fsdp_axis=None)),
         ("sp", dict(seq_axis="model", act_seq_axis=None))]


@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_spec_for_equals_repro_for_every_leaf(name):
    """Every leaf of the config's template, under four rule sets, with no
    mesh and on three mesh shapes (non-divisible dims degrade)."""
    cfg = get_smoke_config(name)
    jcfg = jax_smoke_config(name)
    jleaves = dict(_jax_leaves(jax_model_template(jcfg)))
    tleaves = dict(leaves(model_template(cfg)))
    assert set(jleaves) == set(tleaves)
    for (_, kw), mesh in itertools.product(RULES, MESHES):
        if mesh is not None and "pod" in kw.get("batch_axes", ()) \
                and "pod" not in mesh.sizes:
            continue
        jr, tr = jpart.ShardingRules(**kw), tpart.ShardingRules(**kw)
        for path, lf in tleaves.items():
            jm = _ReproMesh(mesh.sizes) if mesh is not None else None
            want = jpart.spec_for(jleaves[path].axes, jr,
                                  jleaves[path].shape if mesh else None, jm)
            got = tpart.spec_for(lf.axes, tr, lf.shape if mesh else None,
                                 mesh)
            assert got == tuple(want), (path, kw, mesh)


class _ReproMesh:
    def __init__(self, sizes):
        self.shape = sizes


def _jax_leaves(template, prefix=""):
    from repro.models.template import Leaf
    if isinstance(template, Leaf):
        yield prefix, template
        return
    for k in sorted(template):
        yield from _jax_leaves(template[k], f"{prefix}/{k}" if prefix else k)


def test_tree_shardings_match_repro_on_a_one_device_mesh():
    """repro's tree_shardings on its (1, 1) CPU mesh against the port's on
    the (1, 1) shape; the port's placements on a 4 x 2 shape."""
    from repro.launch.mesh import make_auto_mesh
    jmesh = make_auto_mesh((1, 1), ("data", "model"))
    for name in ("yi-6b", "kimi-k2-1t-a32b", "zamba2-2.7b"):
        jcfg, cfg = jax_smoke_config(name), get_smoke_config(name)
        jt = jax_model_template(jcfg)
        jsh = jpart.tree_shardings(
            jmesh, jax_axes_tree(jt),
            jax.tree.map(lambda lf: jax.ShapeDtypeStruct(lf.shape,
                                                         jnp.float32),
                         jt, is_leaf=lambda x: hasattr(x, "axes")),
            jpart.ShardingRules())
        axes, shapes = _axes_and_shapes(model_template(cfg))
        tsh = tpart.tree_shardings(FakeMesh(data=1, model=1), axes, shapes,
                                   tpart.PROD_RULES)
        for (path, js), ts in zip(
                jax.tree_util.tree_flatten_with_path(jsh)[0],
                _tree_leaves(tsh)):
            assert ts.spec == tuple(js.spec), path
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(data=4, model=2)
    sh = tpart.Sharding(mesh, ("data", "model"))
    assert sh.placements == (Shard(0), Shard(1))
    sh = tpart.Sharding(mesh, (None, ("data", "model")))
    assert sh.placements == (Shard(1), Shard(1))
    assert sh.local_index((3, 16), (2, 1)) == (slice(None), slice(10, 12))
    assert tpart.Sharding(mesh, (None,)).placements == (Replicate(),
                                                        Replicate())


def _axes_and_shapes(template):
    axes, shapes = {}, {}
    for path, lf in leaves(template):
        *parents, last = path.split("/")
        a, s = axes, shapes
        for k in parents:
            a, s = a.setdefault(k, {}), s.setdefault(k, {})
        a[last], s[last] = lf.axes, torch.empty(lf.shape, device="meta")
    return axes, shapes


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k])
    else:
        yield tree


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3)
    assert tpart.constrain(x, tpart.NO_SHARD, "batch", None) is x
    assert tpart.constrain(x, None, "batch", None) is x
    assert make_host_mesh(4, 4, "cpu") is None      # no process group


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_make_host_mesh_clamps_to_the_world(one_rank_group):
    """On a one-rank group: a (1, 1) mesh whatever is asked; constrain
    passes a plain tensor and redistributes a DTensor to the spec."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_host_mesh(4, 8, "cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    x = torch.randn(4, 6)
    ctx = tpart.ShardCtx(mesh=mesh)
    assert tpart.constrain(x, ctx, "batch", None) is x
    d = DTensor.from_local(x, mesh, (Replicate(), Replicate()))
    y = tpart.constrain(d, ctx, "batch", "vocab")
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert torch.equal(y.full_tensor(), x)


# --------------------------------------------------------- one train step --
STEP_CASES = [("adamw", "none", 1), ("adamw", "bf16", 1),
              ("adamw", "int8", 1), ("adamw", "none", 2),
              ("adafactor", "none", 1), ("adafactor", "int8", 2)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kind,codec,grad_accum", STEP_CASES)
def test_train_step_matches_repro(kind, codec, grad_accum):
    jcfg = dataclasses.replace(jax_smoke_config("stablelm-3b"),
                               dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    run_kw = dict(arch="stablelm-3b", steps=10, global_batch=4, seq_len=64,
                  peak_lr=1e-3, warmup_steps=0, grad_accum=grad_accum)
    jrun = jtrain.TrainRunConfig(**run_kw)
    run = T.TrainRunConfig(**run_kw, device="cpu")
    jocfg = jopt.OptConfig(kind=kind, lr=1e-3)
    ocfg = topt.OptConfig(**dataclasses.asdict(jocfg))
    jccfg = JCompressConfig(codec=codec)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jocfg, jrun,
                                           jpart.ShardCtx(), jccfg))
    tstep = T.make_train_step(cfg, ocfg, run, CompressConfig(codec=codec))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                      seed=5)

    def jbatch(step):
        return {k: jnp.asarray(v.numpy()) for k, v in
                batch_for_step(dcfg, cfg, step, "cpu").items()}

    # repro's first step from fresh state; the port takes over after it
    jp = jax.tree.map(jnp.asarray, _np_tree(_init_np(cfg, seed=6)))
    jo = jopt.init(jp, jocfg)
    jc = jax_comp_init(jp, jccfg)
    jp, jo, jc, _ = jstep(jp, jo, jc, jbatch(0), jnp.int32(0))
    tp = lm_params_from_jax(_np_tree(jp), cfg)
    to = opt_state_from_jax(_np_tree(jo))
    tc = compress_state_from_jax(_np_tree(jc))
    before = {k: v.clone() for k, v in _flat(tp)}
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    jp2, jo2, jc2, jm = jstep(jp, jo, jc, jbatch(1), jnp.int32(1))
    tp2, to2, tc2, tm = tstep(tp, to, tc, batch_for_step(dcfg, cfg, 1,
                                                         "cpu"), 1)
    assert tp2 is tp
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tm["gnorm"].item(), float(jm["gnorm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
    lr = float(jm["lr"])
    jflat = dict(_flat(_np_tree(jp2)))
    for path, t in _flat(tp2):
        want = jflat[path] - before[path].numpy()
        got = t.detach().numpy() - before[path].numpy()
        err = got - want
        assert np.linalg.norm(err) <= 1e-3 * max(np.linalg.norm(want),
                                                 lr), path
        assert np.abs(err).max() <= 2 * lr, path
    assert int(to2.step) == int(jo2.step) == 2
    if codec == "int8":
        # the residual g - q * scale carries the gradient's float32
        # differences (up to ~2e-6 of max|g| = 127 scales = ~254 max|e|);
        # an entry within them of a rounding boundary moves by one scale
        jerr = dict(_flat(_np_tree(jc2.error)))
        for path, e in _flat(tc2.error):
            off = np.abs(e.numpy() - jerr[path]) \
                > 1e-3 * np.abs(jerr[path]).max() + 1e-12
            assert off.mean() <= 1e-3, (path, off.sum())


def _init_np(cfg, seed):
    from repro_torch.models.template import init_params
    tp = init_params(model_template(cfg), torch.Generator().manual_seed(seed),
                     cfg.param_dtype, "cpu")
    return jax.tree.map(lambda t: t.numpy(), tp)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


# --------------------------------------------- the trainer (test_system) --
@pytest.fixture
def steady_watchdog(monkeypatch):
    """A watchdog that reports every step healthy.  The real one reads wall
    time: on a loaded machine it can flag slow steps and switch one of two
    compared runs to the bf16 codec mid-run
    (`test_watchdog_degraded_turns_on_bf16_and_evict_stops` drives it)."""
    class Steady:
        def observe(self, dt):
            return HEALTHY

    monkeypatch.setattr(T, "Watchdog", Steady)


def _run_cfg(tmp_path, **kw):
    base = dict(arch="stablelm-3b", smoke=True, steps=12, global_batch=4,
                seq_len=64, ckpt_dir=str(tmp_path / "ckpt"),
                ckpt_interval=4, log_interval=100, peak_lr=1e-3,
                warmup_steps=2, device="cpu")
    base.update(kw)
    return T.TrainRunConfig(**base)


def _losses(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_loss_decreases(tmp_path, steady_watchdog):
    out = T.train(_run_cfg(tmp_path, steps=30, ckpt_interval=100))
    assert out["finished"] == 30
    losses = [m["loss"] for m in _losses(str(tmp_path / "ckpt"))]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses


def test_restart_matches_the_uninterrupted_run(tmp_path, steady_watchdog):
    """Uninterrupted run == run stopped at step 8 and restarted (the
    restart restores the step-8 checkpoint; the data stream resumes)."""
    out_a = T.train(_run_cfg(tmp_path, ckpt_dir=str(tmp_path / "a")))
    T.train(_run_cfg(tmp_path, ckpt_dir=str(tmp_path / "b"), stop_after=8))
    assert Checkpointer(str(tmp_path / "b")).latest_step() == 8
    out_b = T.train(_run_cfg(tmp_path, ckpt_dir=str(tmp_path / "b")))
    assert out_a["finished"] == out_b["finished"] == 12
    assert out_a["loss"] == pytest.approx(out_b["loss"], rel=1e-6)
    a, b = _losses(str(tmp_path / "a")), _losses(str(tmp_path / "b"))
    assert [m["step"] for m in b] == list(range(12))
    for ma, mb in zip(a, b):
        assert ma["loss"] == pytest.approx(mb["loss"], rel=1e-6), ma["step"]


def test_preemption_checkpoints_and_exits(tmp_path, monkeypatch,
                                         steady_watchdog):
    """A preemption request mid-run commits a checkpoint and stops."""
    from repro_torch.runtime import preemption

    class Guard(preemption.PreemptionGuard):
        def __init__(self):
            super().__init__(signals=())
            self.n = 0

        def should_checkpoint(self):
            self.n += 1
            if self.n >= 5:
                self.request()
            return super().should_checkpoint()

    monkeypatch.setattr(T, "PreemptionGuard", Guard)
    out = T.train(_run_cfg(tmp_path, steps=50, ckpt_interval=100))
    assert out["stopped_at"] == 5
    assert Checkpointer(str(tmp_path / "ckpt")).latest_step() == 5


def test_sigterm_checkpoints_and_exits(tmp_path, monkeypatch,
                                      steady_watchdog):
    """The real guard: a SIGTERM delivered during step 2 stops the loop
    after that step, with its checkpoint committed; the handler is
    uninstalled on the way out."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    real_step = T.make_train_step

    def make_step(*a, **kw):
        step_fn = real_step(*a, **kw)

        def wrapped(params, opt, comp, batch, step):
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(params, opt, comp, batch, step)
        return wrapped

    monkeypatch.setattr(T, "make_train_step", make_step)
    out = T.train(_run_cfg(tmp_path, steps=50, ckpt_interval=100))
    assert out["stopped_at"] == 3
    assert Checkpointer(str(tmp_path / "ckpt")).latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) == before


def test_watchdog_degraded_turns_on_bf16_and_evict_stops(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    states = iter([HEALTHY] * 3 + [DEGRADED] * 3 + [EVICT] * 10)

    class Dog:
        def observe(self, dt):
            return next(states)

    codecs = []
    real_step = T.make_train_step

    def make_step(cfg, opt_cfg, run, ccfg, mesh=None):
        codecs.append(ccfg.codec)
        return real_step(cfg, opt_cfg, run, ccfg, mesh)

    monkeypatch.setattr(T, "Watchdog", Dog)
    monkeypatch.setattr(T, "make_train_step", make_step)
    out = T.train(_run_cfg(tmp_path, steps=50, ckpt_interval=100))
    assert codecs == ["none", "bf16"]
    assert "enabling bf16 gradient compression" in capsys.readouterr().out
    assert out["stopped_at"] == 7 and out["watchdog"] == EVICT
    assert [m["watchdog"] for m in _losses(str(tmp_path / "ckpt"))] == \
        [HEALTHY] * 3 + [DEGRADED] * 3 + [EVICT]
    assert Checkpointer(str(tmp_path / "ckpt")).latest_step() == 7


def test_grad_compression_codecs_train(tmp_path, steady_watchdog):
    for codec in ("bf16", "int8"):
        out = T.train(_run_cfg(tmp_path, ckpt_dir=str(tmp_path / codec),
                               steps=6, codec=codec))
        assert np.isfinite(out["loss"])


def test_grad_accum_matches_plain(tmp_path, steady_watchdog):
    """2-way gradient accumulation == one big batch (same data)."""
    a = T.train(_run_cfg(tmp_path, ckpt_dir=str(tmp_path / "ga1"), steps=4))
    b = T.train(_run_cfg(tmp_path, ckpt_dir=str(tmp_path / "ga2"), steps=4,
                         grad_accum=2))
    assert a["loss"] == pytest.approx(b["loss"], rel=5e-3)


# One rank of a 2-rank gloo group calling `train` (argv: rank, store, dir).
_TWO_RANK_TRAIN = """
import sys
import torch.distributed as dist
from repro_torch.launch import train as T
rank, store, ckpt_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=2)
try:
    T.train(T.TrainRunConfig(arch="stablelm-3b", steps=1, device="cpu",
                             ckpt_dir=ckpt_dir))
except NotImplementedError as e:
    print("refused:", e)
finally:
    dist.destroy_process_group()
"""


def test_train_refuses_what_it_cannot_run(tmp_path):
    """The default device is the GPU: without one it raises, and never
    falls back to the CPU.  Under a real process group of 2 gloo ranks
    and the default (1, 1) mesh each rank raises before it builds any
    state: the trainer runs no rank outside its mesh."""
    assert T.TrainRunConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.train(_run_cfg(tmp_path, device="cuda"))
    env = {**os.environ,
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), os.pardir,
                                      "src")}
    ckpt_dir = tmp_path / "two_ranks"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_RANK_TRAIN, str(rank),
         str(tmp_path / "store"), str(ckpt_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = "\n".join(f"-- rank {r} (rc {p.returncode})\n{o}"
                       for r, (p, o) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), report
    assert all("refused: 1 of the group's 2 ranks lie outside the (1, 1) "
               "(data, model) mesh" in o for o in outs), report
    assert not ckpt_dir.exists(), report


def test_depth_cut_keeps_the_width(tmp_path, steady_watchdog):
    run = _run_cfg(tmp_path, n_layers=1, steps=2, smoke=True)
    cfg = T._model_cfg(run)
    assert cfg.n_layers == 1
    assert cfg.d_model == get_smoke_config("stablelm-3b").d_model
    assert T.train(run)["finished"] == 2


# ------------------------------------------------------------- data layer --
def test_data_deterministic_by_step():
    cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=4, seed=7)
    a = lm_batch_for_step(cfg, 3, "cpu")
    b = lm_batch_for_step(cfg, 3, "cpu")
    c = lm_batch_for_step(cfg, 4, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert (a["tokens"][:, 0] == cfg.bos_id).all()
    h1 = lm_batch_for_step(dataclasses.replace(cfg, n_hosts=2, host_id=1), 3,
                           "cpu")
    assert h1["tokens"].shape == (2, 32)
    assert not torch.equal(h1["tokens"], a["tokens"][:2])
    t = torch.cat([a["tokens"], a["labels"][:, -1:]], 1)
    assert t.min() >= 1 and t.max() < 1000


def test_data_family_batches_have_repros_shapes():
    dc = dict(vocab_size=100, seq_len=32, global_batch=2)
    for name in JAX_ARCH_NAMES:
        want = jax_batch_for_step(JDataConfig(**dc), jax_smoke_config(name),
                                  0)
        got = batch_for_step(DataConfig(**dc), get_smoke_config(name), 0,
                             "cpu")
        assert set(got) == set(want), name
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (name, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), \
                (name, k)
    vlm = batch_for_step(DataConfig(**dc), get_smoke_config("qwen2-vl-7b"),
                         0, "cpu")
    assert vlm["tokens"].shape[1] + vlm["vision_embeds"].shape[1] == 32
