"""repro_torch's trainer over a (data, model) mesh of gloo ranks on the CPU:
FSDP over ``data`` and tensor parallelism over ``model`` for every family
(MoE expert parallel, Mamba2 by heads), held against the port's
one-device step and against repro's GSPMD steps on 4 forced CPU devices.

The rank workers are this file's ``__main__``; one launch of 4 ranks runs
every mesh in turn, beside one repro process, and writes what each rank
saw to a JSON file, which the tests read:

    python tests/test_torch_train_mesh.py ranks OUT RANK 4 INIT_FILE
    python tests/test_torch_train_mesh.py resume OUT RANK 2 INIT_FILE
    python tests/test_torch_train_mesh.py repro OUT

(``repro`` runs repro's steps under
XLA_FLAGS=--xla_force_host_platform_device_count=4; the ranks wait for
its file before the cases that read it.)

One step from the same parameters, moments and batch (after one
one-device step, so the moments are not zero): the loss within 1e-5
relative and the gradient norm within 1e-4 (float32 sums in another
order: over the mesh's shards, and partial products summed over
``model``); each leaf's update within 1e-3 of the L2 norm of the
one-device update (AdamW's first steps move an entry near eps by up to
lr); the int8 residual within 1e-3 of the largest residual, for all but
0.1 % of entries (an entry on a rounding boundary moves by one scale).
These are chip_smoke.py's TRAIN_CPU_* tolerances.  A (1, 1) mesh equals
the one-device step bit for bit.  Every family but dense is held at the
(data, model) meshes (1, 2), (2, 2) and (1, 4) against the one-device
step and against repro's step on a mesh of that shape, both from one
state (the port's one-device state after one step); moe's routed expert
ids in every layer must equal the one-device step's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import ARCH_NAMES, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch import train as T
from repro_torch.models.model import model_param_axes, param_shardings
from repro_torch.models.template import init_params
from repro_torch.models.transformer import model_template
from repro_torch.optim import adamw as topt
from repro_torch.optim.compress import CompressConfig, init_state
from repro_torch.runtime import HEALTHY
from repro_torch.tree import tree_leaves, tree_map

WORKER_TIMEOUT = 300        # seconds for one launch of the rank workers
LOSS_RTOL, GNORM_RTOL, UPDATE_RTOL = 1e-5, 1e-4, 1e-3
RESIDUAL_RTOL, RESIDUAL_OFF = 1e-3, 1e-3
BATCH, SEQ, LR = 4, 64, 1e-3
STEP_CASES = [("none", 1), ("int8", 1), ("none", 2), ("int8", 2)]
ELASTIC_STEPS, ELASTIC_STOP = 6, 4


# --------------------------------------------------------- shared helpers --
def _cfg(arch: str, **width):
    """A smoke config in float32 activations, with ``width`` fields
    changed (depth and width only)."""
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               **width)


CONFIGS = {
    "stablelm": ("stablelm-3b", {}),
    # yi-6b's smoke GQA has one kv head: a model split of 2 or 4 cuts it
    "yi_cut_kv": ("yi-6b", {}),
    # head_dim 18: KV * hd = 18 is not divided by a model axis of 4, so
    # spec_for replicates wk / wv while wq splits (no head_dim that rope
    # takes can do that on a model axis of 2: KV * hd is even)
    "yi_repl_kv": ("yi-6b", {"head_dim": 18}),
    # 6 q heads in 2 groups: a model axis of 4 cuts q heads and kv heads
    "yi_cut_q": ("yi-6b", {"n_heads": 6, "n_kv_heads": 2}),
    "qwen_bias": ("qwen1.5-110b", {}),
    # FSDP of every other family (llama4-scout: kimi-k2's smoke config
    # keeps bf16 parameters, whose per-rank gradients round to bf16 before
    # the sum over data)
    "moe": ("llama4-scout-17b-a16e", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "vlm": ("qwen2-vl-7b", {}),
    "audio": ("musicgen-medium", {}),
    # top-k 2 (kimi-k2's smoke config), float32 parameters
    "moe_k2": ("kimi-k2-1t-a32b", {"param_dtype": "float32"}),
    # d_model 48: 6 ssm heads, which a model axis of 4 does not divide
    # (every rank runs every head); w_in's 230 columns stay whole there,
    # the conv's 128 channels and d_inner's 96 split
    "ssm_odd": ("mamba2-2.7b", {"d_model": 48}),
}
# tensor parallelism over model for every family but dense, at every mesh
# that splits model; the smoke configs' q heads (4), experts (8) and
# ssm_heads (8) divide each, and a kv head of moe (both) and vlm does not
# (their wk / wv columns are cut and gathered, as yi_cut_kv's)
TP_FAMILIES = ("moe", "moe_k2", "ssm", "hybrid", "vlm", "audio")
TP_MESHES = ((1, 2), (2, 2), (1, 4))
TP_CASES = ([(mesh, name) for mesh in TP_MESHES for name in TP_FAMILIES]
            + [((1, 4), "ssm_odd")])


def _run(arch: str, codec: str = "none", ga: int = 1, **kw):
    base = dict(arch=arch, steps=10, global_batch=BATCH, seq_len=SEQ,
                peak_lr=LR, warmup_steps=0, codec=codec, grad_accum=ga,
                device="cpu", log_interval=100)
    base.update(kw)
    return T.TrainRunConfig(**base)


def _batch(cfg, step: int) -> dict:
    return batch_for_step(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                     global_batch=BATCH, seed=5),
                          cfg, step, "cpu")


def _zipmap(fn, a, *rest):
    """``fn`` over the leaves of trees of one structure (dicts, tuples,
    NamedTuples); ``None`` leaves of ``a`` stay None."""
    if isinstance(a, dict):
        return {k: _zipmap(fn, a[k], *(r[k] for r in rest)) for k in a}
    if isinstance(a, tuple):
        out = [_zipmap(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(a)]
        return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
    return fn(a, *rest)


def _empty(tree) -> bool:
    return isinstance(tree, tuple) and len(tree) == 0


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _state_after_one_step(cfg, run, ocfg, ccfg, seed: int = 6):
    """Parameters, moments and codec state after one one-device step from
    a fresh draw (so that the compared step starts from moments that are
    not zero)."""
    params = init_params(model_template(cfg),
                         torch.Generator().manual_seed(seed),
                         cfg.param_dtype, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt, comp = topt.init(params, ocfg), init_state(params, ccfg)
    step = T.make_train_step(cfg, ocfg, run, ccfg)
    params, opt, comp, _ = step(params, opt, comp, _batch(cfg, 0), 0)
    return _clone(params), _clone(opt), _clone(comp)


def _files(d) -> dict:
    """{file name: sha256} of a checkpoint step directory."""
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(d))}


def _start(argv_of, n: int) -> list:
    """Start ``n`` worker processes (``argv_of(rank)``) and return them."""
    env = {**os.environ,
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), os.pardir,
                                      "src")}
    return [subprocess.Popen(argv_of(r), env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def _launch(argv_of, n: int) -> list[str]:
    """Start ``n`` worker processes, wait for them and return their
    outputs; every one must exit 0."""
    return _wait(_start(argv_of, n))


def _wait(procs) -> list[str]:
    """Wait for every process and return their outputs; each must exit
    0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = "\n".join(f"-- worker {r} (rc {p.returncode})\n{o}"
                       for r, (p, o) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), report
    return outs


# ------------------------------------------------- the rank workers' cases --
def _mesh(shape, ranks=None):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(shape[0] * shape[1]) if ranks is None \
        else torch.tensor(ranks)
    return DeviceMesh("cpu", ranks.reshape(shape),
                      mesh_dim_names=("data", "model"))


def _mesh_sum(values: list, mesh) -> list:
    from repro_torch.sharding.collectives import mesh_all_reduce_
    t = torch.tensor(values, dtype=torch.float64)
    return mesh_all_reduce_(t, mesh).tolist()


def _local_numels_ok(cfg, mesh, params) -> bool:
    """Each leaf holds numel / (the extents of the axes that split it)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    ok = True
    for (path, lf), sh, t in zip(_template_leaves(cfg),
                                 tree_leaves(param_shardings(cfg, mesh)),
                                 tree_leaves(params)):
        ext = 1
        for i, n in enumerate(lf.shape):
            for a in sh.split_axes(i):
                assert n % sizes[a] == 0, path
                ext *= sizes[a]
        ok &= t.numel() * ext == int(np.prod(lf.shape))
    return bool(ok)


def _template_leaves(cfg):
    from repro_torch.models.template import leaves
    return list(leaves(model_template(cfg)))


@contextlib.contextmanager
def _routes():
    """The expert ids of every routing in the block (`moe.route`'s top k),
    in call order."""
    from repro_torch.models import moe
    seen, real = [], moe.route

    def recording(logits, k):
        out = real(logits, k)
        seen.append(out[1].clone())
        return out

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = real


def step_case(mesh, cfg, run, ocfg, ccfg, start=None, want=None,
              repro=None) -> dict:
    """One mesh step against the one-device step (or ``want``: repro's
    metrics, parameters and codec state) from the same state: the numbers
    the tests hold to their tolerances; with ``repro`` (repro's step from
    the same state), the same numbers against it under "repro".  For moe
    against the one-device step, ``routes_equal``: every layer's expert
    ids equal the one-device step's for this rank's rows."""
    coord = mesh.get_coordinate()
    psh = param_shardings(cfg, mesh)
    osh = topt.opt_state_sharding(
        psh, init_params(model_template(cfg), None, cfg.param_dtype, "meta"),
        ocfg, _repl(mesh))
    params, opt, comp = start if start is not None else \
        _state_after_one_step(cfg, run, ocfg, ccfg)
    batch = _batch(cfg, 1)
    one_routes = None
    if want is None:
        rp, ro, rc = _clone(params), _clone(opt), _clone(comp)
        for p in tree_leaves(rp):
            p.requires_grad_(True)
        with _routes() as one_routes:
            rp, ro, rc, rm = T.make_train_step(cfg, ocfg, run, ccfg)(
                rp, ro, rc, batch, 1)
        want = {"loss": float(rm["loss"]), "gnorm": float(rm["gnorm"]),
                "params": _clone(rp), "error": rc.error}

    def cut(t, sh):
        return t[sh.local_index(tuple(t.shape), coord)].clone()

    lp = _zipmap(cut, params, psh)
    lo = topt.OptState(*(() if _empty(f) else _zipmap(cut, f, s)
                         for f, s in zip(opt, osh)))
    lc = type(comp)(() if _empty(comp.error)
                    else _zipmap(cut, comp.error, psh))
    for p in tree_leaves(lp):
        p.requires_grad_(True)
    numels_ok = _local_numels_ok(cfg, mesh, lp)
    start_local = _clone(lp)
    with _routes() as mesh_routes:
        lp, lo, lc, m = T.make_train_step(cfg, ocfg, run, ccfg, mesh)(
            lp, lo, lc, batch, 1)
    shs = tree_leaves(psh)

    def against(want):
        sums = []
        for sh, got, w, s0 in zip(shs, tree_leaves(lp),
                                  tree_leaves(want["params"]),
                                  tree_leaves(start_local)):
            d_want = cut(w, sh) - s0
            err = (got.detach() - s0) - d_want
            own = float(sh.counted_here(coord))
            sums += [own * float(err.double().square().sum()),
                     own * float(d_want.double().square().sum())]
        res_off = res_n = 0.0
        if ccfg.codec == "int8":
            errs = tree_leaves(lc.error)
            wants = [cut(e, sh) for e, sh in zip(tree_leaves(want["error"]),
                                                 shs)]
            # the whole leaf's largest residual, then the entries off by
            # more than RESIDUAL_RTOL of it
            mx = _mesh_max([float(w.abs().max()) for w in wants], mesh)
            for e, w, sh, top in zip(errs, wants, shs, mx):
                own = float(sh.counted_here(coord))
                res_off += own * float(((e - w).abs()
                                        > RESIDUAL_RTOL * top + 1e-12).sum())
                res_n += own * e.numel()
            res_off, res_n = _mesh_sum([res_off, res_n], mesh)
        sums = _mesh_sum(sums, mesh)
        rel = [np.sqrt(sums[i]) / max(np.sqrt(sums[i + 1]), LR)
               for i in range(0, len(sums), 2)]
        return {"loss": float(m["loss"]), "loss_want": want["loss"],
                "gnorm": float(m["gnorm"]), "gnorm_want": want["gnorm"],
                "update_rel_worst": max(rel), "numels_ok": numels_ok,
                "residual_off_share": res_off / res_n if res_n else 0.0,
                "split_leaves": sum(any(sh.split_axes(i)
                                        for i in range(len(sh.spec)))
                                    for sh in shs)}

    out = against(want)
    if repro is not None:
        out["repro"] = against(repro)
    if cfg.family == "moe" and one_routes is not None:
        out["routes_equal"] = _routes_equal(mesh_routes, one_routes, mesh)
    return out


def _routes_equal(mesh_routes: list, one_routes: list, mesh) -> bool:
    """Whether a mesh rank routed as the one-device step did, layer by
    layer: its (G / data, Ng, k) expert ids against the block of the
    one-device (G, Ng, k) that its data coordinate's rows make."""
    if len(mesh_routes) != len(one_routes) or not one_routes:
        return False
    d, n = mesh.get_local_rank("data"), mesh.size(0)
    for got, want in zip(mesh_routes, one_routes):
        g = want.shape[0] // n
        if not torch.equal(got, want[d * g:(d + 1) * g]):
            return False
    return True


def _mesh_max(values: list, mesh) -> list:
    from repro_torch.sharding.collectives import mesh_all_reduce_
    t = torch.tensor(values, dtype=torch.float64)
    return mesh_all_reduce_(t, mesh, dist.ReduceOp.MAX).tolist()


def _repl(mesh):
    from repro_torch.sharding.partition import Sharding
    return Sharding(mesh, ())


_model_cfg = T._model_cfg


def _float32_model_cfg(run):
    """The trainer's config in float32 activations (the smoke configs
    compute in bf16, where a sum in another order moves the loss by
    ~1e-5 of itself)."""
    return dataclasses.replace(_model_cfg(run), dtype="float32")


class _Steady:
    """A watchdog that reports every step healthy (wall time on a loaded
    machine would flag slow steps at random)."""

    def observe(self, dt):
        return HEALTHY


def _step_cases(tag: str, mesh, names, out: dict) -> None:
    for name in names:
        arch, width = CONFIGS[name]
        cfg = _cfg(arch, **width)
        cases = STEP_CASES if name == "stablelm" else [("none", 1)]
        for codec, ga in cases:
            run = _run(arch, codec, ga)
            out[f"{tag}/{name}/{codec}/{ga}"] = step_case(
                mesh, cfg, run, topt.OptConfig(lr=LR),
                CompressConfig(codec=codec))
    if "stablelm" in names:
        cfg = _cfg("stablelm-3b")
        ocfg = topt.OptConfig(kind="adafactor", lr=LR, factored_min_dim=16)
        out[f"{tag}/stablelm/adafactor/1"] = step_case(
            mesh, cfg, _run("stablelm-3b"), ocfg, CompressConfig())


def _checkpoint_case(out_dir: str, mesh, rank: int, out: dict,
                     name: str = "stablelm") -> None:
    """The same state saved by one device and by the mesh (sync and
    async): the same files, byte for byte."""
    arch, width = CONFIGS[name]
    cfg = _cfg(arch, **width)
    ocfg, ccfg = topt.OptConfig(lr=LR), CompressConfig()
    params, opt, _ = _state_after_one_step(cfg, _run(arch), ocfg, ccfg)
    coord = mesh.get_coordinate()
    psh = param_shardings(cfg, mesh)
    osh = topt.opt_state_sharding(psh, params, ocfg, _repl(mesh))

    def cut(t, sh):
        return t[sh.local_index(tuple(t.shape), coord)].clone()

    tree = {"params": params, "opt": opt}
    local = {"params": _zipmap(cut, params, psh),
             "opt": topt.OptState(*(_zipmap(cut, f, s)
                                    for f, s in zip(opt, osh)))}
    places = {"params": psh, "opt": osh}
    key, root = ("checkpoint", "ckpt_bytes") if name == "stablelm" else (
        f"checkpoint/{name}", f"ckpt_bytes_{name}")
    root = os.path.join(out_dir, root)
    if rank == 0:
        Checkpointer(os.path.join(root, "one")).save(4, tree, {"loss": 1.5})
    Checkpointer(os.path.join(root, "mesh")).save(
        4, local, {"loss": 1.5}, placements=places)
    ck = Checkpointer(os.path.join(root, "mesh_async"))
    ck.save_async(4, local, {"loss": 1.5}, placements=places)
    ck.wait()
    dist.barrier()
    # a restore of the mesh's save on the mesh: DTensors of the slices
    got = Checkpointer(os.path.join(root, "mesh")).restore(
        4, tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree), places)
    same = all(torch.equal(g.to_local(), w)
               for g, w in zip(tree_leaves(got), tree_leaves(local)))
    # the restored DTensors saved again
    Checkpointer(os.path.join(root, "dtensor")).save(4, got, {"loss": 1.5})
    step = f"step_{4:010d}"
    out[key] = {k: _files(os.path.join(root, k, step))
                for k in ("one", "mesh", "mesh_async", "dtensor")}
    out[key]["restored_equal"] = bool(same)


def _refusals(out_dir: str, out: dict) -> None:
    d = os.path.join(out_dir, "refuse_outside")
    try:
        T.train(_run("stablelm-3b", data_mesh=1, model_mesh=2, ckpt_dir=d))
        out["refuse/outside"] = "trained"
    except NotImplementedError as e:
        out["refuse/outside"] = str(e)
    out["refuse/outside/state"] = os.path.exists(d)


def _tp_run(arch: str, ckpt_dir: str):
    """train() of one step of ``arch``'s smoke config on a (2, 2) mesh (a
    model extent of 2) or on one device."""
    return _run(arch, steps=1, ckpt_interval=100, data_mesh=2, model_mesh=2,
                ckpt_dir=ckpt_dir)


def _tp_cases(mesh, starts, repro, out: dict) -> None:
    """Every family but dense on ``mesh``: one step from the port's
    one-device state after one step (``starts``), against the one-device
    step and against repro's step from that state (``repro``)."""
    from repro_torch.convert import lm_params_from_jax
    tag = "x".join(map(str, mesh.shape))
    for name in (n for m, n in TP_CASES if m == tuple(mesh.shape)):
        arch, width = CONFIGS[name]
        cfg = _cfg(arch, **width)
        want = {"loss": float(repro[f"{name}/{tag}/loss"]),
                "gnorm": float(repro[f"{name}/{tag}/gnorm"]),
                "params": lm_params_from_jax(
                    _npz_tree(repro, f"{name}/{tag}/p"), cfg), "error": ()}
        out[f"{tag}/{name}/none/1"] = step_case(
            mesh, cfg, _run(arch), topt.OptConfig(lr=LR), CompressConfig(),
            _load_start(starts, name, cfg), repro=want)
        out[f"codec/{tag}/{name}"] = _codec_case(mesh, cfg)


def _codec_case(mesh, cfg) -> bool:
    """The int8 codec on this rank's slices of a gradient tree (the
    scale a whole leaf's max over the mesh, the error buffers sliced like
    their leaf), against the codec on the whole tree, over two steps:
    equal wire values and residuals, bit for bit."""
    from repro_torch.optim.compress import compress
    coord = mesh.get_coordinate()
    psh = param_shardings(cfg, mesh)
    ccfg = CompressConfig(codec="int8")
    gen = torch.Generator().manual_seed(8)
    grads = [init_params(model_template(cfg), gen, "float32", "cpu")
             for _ in range(2)]

    def cut(t, sh):
        return t[sh.local_index(tuple(t.shape), coord)].clone()

    one, mine = init_state(grads[0], ccfg), init_state(_zipmap(
        cut, grads[0], psh), ccfg)
    same = True
    for g in grads:
        wire, one, dec = compress(g, one, ccfg)
        lwire, mine, ldec = compress(_zipmap(cut, g, psh), mine, ccfg, psh)
        for got, want, sh in zip(tree_leaves((ldec(lwire), mine.error)),
                                 tree_leaves((dec(wire), one.error)),
                                 tree_leaves((psh, psh))):
            same &= torch.equal(got, cut(want, sh))
    return bool(same)


def _runtime_cases(out_dir: str, rank: int, out: dict) -> None:
    """SIGTERM to rank 1 during step 2, and a watchdog DEGRADED on rank 2
    only from step 2: every rank acts at the same step."""
    real_step = T.make_train_step

    def sigterm_step(*a, **kw):
        step_fn = real_step(*a, **kw)

        def wrapped(params, opt, comp, batch, step):
            if step == 2 and rank == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(params, opt, comp, batch, step)
        return wrapped

    T.make_train_step = sigterm_step
    try:
        d = os.path.join(out_dir, "sigterm")
        got = T.train(_run("stablelm-3b", steps=50, ckpt_interval=100,
                           data_mesh=2, model_mesh=2, ckpt_dir=d))
        out["sigterm"] = {"stopped_at": got.get("stopped_at"),
                          "latest": Checkpointer(d).latest_step()}
    finally:
        T.make_train_step = real_step

    codecs = []

    def recording_step(cfg, ocfg, run, ccfg, *a, **kw):
        codecs.append(ccfg.codec)
        return real_step(cfg, ocfg, run, ccfg, *a, **kw)

    class SlowOnRank2:
        def __init__(self):
            self.n = 0

        def observe(self, dt):
            self.n += 1
            return "degraded" if rank == 2 and self.n >= 3 else HEALTHY

    T.make_train_step, T.Watchdog = recording_step, SlowOnRank2
    try:
        d = os.path.join(out_dir, "degraded")
        T.train(_run("stablelm-3b", steps=5, ckpt_interval=100,
                     data_mesh=2, model_mesh=2, ckpt_dir=d))
        out["degraded"] = {"codecs": codecs}
        if rank == 0:
            with open(os.path.join(d, "metrics.jsonl")) as f:
                out["degraded"]["watchdog"] = [json.loads(x)["watchdog"]
                                               for x in f]
    finally:
        T.make_train_step, T.Watchdog = real_step, _Steady


def _elastic_run(out_dir: str, **kw):
    return _run("stablelm-3b", steps=ELASTIC_STEPS, ckpt_interval=2,
                warmup_steps=1, ckpt_dir=os.path.join(out_dir, "elastic"),
                **kw)


def _npz_tree(z, prefix: str) -> dict:
    """The nested tree of an npz file's arrays under ``prefix/``."""
    out: dict = {}
    for k in z.files:
        if k.startswith(prefix + "/"):
            node = out
            *parents, last = k[len(prefix) + 1:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = z[k]
    return out


def _flat(tree, cfg, prefix: str) -> dict:
    """{prefix/path: numpy} of a parameter-shaped tree of tensors."""
    out = {}
    for path, _ in _template_leaves(cfg):
        node = tree
        for k in path.split("/"):
            node = node[k]
        out[f"{prefix}/{path}"] = node.detach().numpy()
    return out


def _starts(cfg, name: str) -> dict:
    """The npz entries of the port's one-device state after one step and
    of the batch of the step after it."""
    params, opt, _ = _state_after_one_step(cfg, _run(CONFIGS[name][0]),
                                           topt.OptConfig(lr=LR),
                                           CompressConfig())
    out = {**_flat(params, cfg, f"{name}/p"), **_flat(opt.m, cfg, f"{name}/m"),
           **_flat(opt.v, cfg, f"{name}/v"),
           f"{name}/step": opt.step.numpy()}
    # (vlm's bf16 patch embeddings in float32, which repro casts to its
    # float32 activations as the port casts the bf16 ones)
    out.update((f"{name}/b/{k}", (v.float() if v.is_floating_point() else v)
                .numpy()) for k, v in _batch(cfg, 1).items())
    return out


def _load_start(z, name: str, cfg):
    from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
    from repro_torch.optim.compress import CompressState
    return (lm_params_from_jax(_npz_tree(z, f"{name}/p"), cfg),
            opt_state_from_jax((_npz_tree(z, f"{name}/m"),
                                _npz_tree(z, f"{name}/v"),
                                z[f"{name}/step"])),
            CompressState(()))


def _wait_for(path: str):
    """An npz file another process writes (renamed into place whole)."""
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > WORKER_TIMEOUT:
            raise TimeoutError(path)
        time.sleep(0.2)
    return np.load(path)


def _load_repro(z):
    """repro's state after its step 0 (the port's trees) and its step 1."""
    from repro_torch.convert import (
        compress_state_from_jax, lm_params_from_jax, opt_state_from_jax,
    )

    def tree(prefix):
        return _npz_tree(z, prefix)

    cfg = _cfg("stablelm-3b")
    start = (lm_params_from_jax(tree("p0"), cfg),
             opt_state_from_jax((tree("m0"), tree("v0"), z["step0"])),
             compress_state_from_jax(
                 type("S", (), {"error": tree("e0")})()))
    want = {"loss": float(z["loss1"]), "gnorm": float(z["gnorm1"]),
            "params": lm_params_from_jax(tree("p1"), cfg),
            "error": compress_state_from_jax(
                type("S", (), {"error": tree("e1")})()).error}
    return start, want


def _restore_repro_case(out_dir: str, mesh, start) -> bool:
    """repro's checkpoint of its (2, 2) state, restored onto the port's
    (2, 2) mesh: each rank's slices of repro's arrays."""
    cfg, ocfg = _cfg("stablelm-3b"), topt.OptConfig(lr=LR)
    target, placements = T._targets(cfg, ocfg, mesh)
    got = Checkpointer(os.path.join(out_dir, "repro_ckpt")).restore(
        1, target, placements)
    coord = mesh.get_coordinate()
    want = {"params": start[0], "opt": start[1]}
    return all(
        torch.equal(g.to_local(), w[sh.local_index(tuple(w.shape), coord)])
        for g, w, sh in zip(tree_leaves(got), tree_leaves(want),
                            tree_leaves(placements)))


def ranks_worker(out_dir: str, rank: int, world: int, store: str) -> None:
    """Rank ``rank`` of the 4-rank launch: every mesh in turn."""
    T.Watchdog, T._model_cfg = _Steady, _float32_model_cfg
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    out: dict = {}
    t0 = time.time()
    try:
        # every mesh is made by every rank, in one order
        m21 = _mesh((2, 1), [0, 1])
        m12 = _mesh((1, 2), [2, 3])
        m22, m14 = _mesh((2, 2)), _mesh((1, 4))
        if rank < 2:          # (2, 1) and (1, 2) on 2 ranks each, at once
            _step_cases("2x1", m21, ("stablelm", "moe", "hybrid", "ssm",
                                     "vlm", "audio"), out)
        else:
            _step_cases("1x2", m12, ("stablelm", "yi_cut_kv", "qwen_bias"),
                        out)
        _step_cases("2x2", m22, ("stablelm", "yi_cut_kv"), out)
        _step_cases("1x4", m14, ("yi_repl_kv", "yi_cut_q"), out)
        repro = _wait_for(os.path.join(out_dir, "repro.npz"))
        starts = np.load(os.path.join(out_dir, "starts.npz"))
        for mesh in ((m12,) if rank >= 2 else ()) + (m22, m14):
            _tp_cases(mesh, starts, repro, out)
        start, want = _load_repro(repro)
        out["repro/2x2/int8"] = step_case(
            m22, _cfg("stablelm-3b"), _run("stablelm-3b", "int8"),
            topt.OptConfig(lr=LR), CompressConfig(codec="int8"), start, want)
        out["repro/restored"] = _restore_repro_case(out_dir, m22, start)
        _checkpoint_case(out_dir, m22, rank, out)
        for name in ("moe", "hybrid"):      # experts; ssm_inner / ssm_heads
            _checkpoint_case(out_dir, m14, rank, out, name)
        for name in TP_FAMILIES:
            arch = CONFIGS[name][0]
            out[f"train/{name}"] = T.train(_tp_run(
                arch, os.path.join(out_dir, f"tp_train_{name}")))
        _refusals(out_dir, out)
        _runtime_cases(out_dir, rank, out)
        out["elastic/first"] = T.train(_elastic_run(
            out_dir, stop_after=ELASTIC_STOP, data_mesh=2, model_mesh=2))
        out["seconds"] = time.time() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"ranks_{rank}.json"), "w") as f:
        json.dump(out, f)


def resume_worker(out_dir: str, rank: int, world: int, store: str) -> None:
    """Rank ``rank`` of the 2 survivors of the 4: the elastic plan's mesh,
    resuming the (2, 2) run from its committed step."""
    from repro_torch.runtime import build_mesh, plan_remesh
    T.Watchdog, T._model_cfg = _Steady, _float32_model_cfg
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        plan = plan_remesh(4, 4 - world, model=2)
        mesh = build_mesh(plan, "cpu")
        got = T.train(_elastic_run(out_dir, data_mesh=plan.shape[0],
                                   model_mesh=plan.shape[1],
                                   grad_accum=plan.grad_accum), mesh)
        out = {"plan": list(plan.shape), "grad_accum": plan.grad_accum,
               "result": got}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"resume_{rank}.json"), "w") as f:
        json.dump(out, f)


def repro_worker(out_dir: str) -> None:
    """repro's make_train_step on a (2, 2) mesh of 4 forced CPU devices,
    codec int8, from the parameters and batches in ``out_dir/inputs.npz``:
    its state after step 0 and its step 1, into ``out_dir/repro.npz``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.launch import train as jtrain
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import model_abstract_params
    from repro.models.model import model_param_axes as jaxes
    from repro.optim import adamw as jopt
    from repro.optim.compress import CompressConfig as JCC
    from repro.optim.compress import init_state as jinit
    from repro.sharding.partition import (
        ShardCtx, ShardingRules, tree_shardings,
    )
    assert len(jax.devices()) == 4, jax.devices()
    z = np.load(os.path.join(out_dir, "inputs.npz"))
    cfg = JModelConfig(**dataclasses.asdict(_cfg("stablelm-3b")))
    mesh = make_host_mesh(2, 2)
    rules = ShardingRules()
    psh = tree_shardings(mesh, jaxes(cfg), model_abstract_params(cfg), rules)
    params = {}
    for k in z.files:
        if k.startswith("p/"):
            node = params
            *parents, last = k[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = jnp.asarray(z[k])
    params = jax.device_put(params, psh)
    run = jtrain.TrainRunConfig(arch="stablelm-3b", steps=10,
                                global_batch=BATCH, seq_len=SEQ, peak_lr=LR,
                                warmup_steps=0, codec="int8")
    ocfg, ccfg = jopt.OptConfig(lr=LR), JCC(codec="int8")
    opt, comp = jopt.init(params, ocfg), jinit(params, ccfg)
    step = jax.jit(jtrain.make_train_step(
        cfg, ocfg, run, ShardCtx(mesh=mesh, rules=rules), ccfg))
    saved = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            saved[f"{prefix}/{key}"] = np.asarray(leaf)

    with mesh:
        for s in (0, 1):
            batch = {k[len(f"b{s}/"):]: jnp.asarray(z[k]) for k in z.files
                     if k.startswith(f"b{s}/")}
            if s == 1:
                # repro's own checkpoint of the sharded state, for the
                # port's ranks to restore onto their mesh
                JCheckpointer(os.path.join(out_dir, "repro_ckpt")).save(
                    1, {"params": params, "opt": opt})
                put("p0", params)
                put("m0", opt.m)
                put("v0", opt.v)
                put("e0", comp.error)
                saved["step0"] = np.asarray(opt.step)
            params, opt, comp, m = step(params, opt, comp, batch,
                                        jnp.int32(s))
    put("p1", params)
    put("e1", comp.error)
    saved["loss1"] = np.asarray(m["loss"])
    saved["gnorm1"] = np.asarray(m["gnorm"])
    # every family but dense, one step at each mesh that splits model,
    # from the port's one-device state after one step
    starts = np.load(os.path.join(out_dir, "starts.npz"))
    for shape, name in TP_CASES:
        arch, width = CONFIGS[name]
        cfg = JModelConfig(**dataclasses.asdict(_cfg(arch, **width)))
        run = jtrain.TrainRunConfig(arch=arch, steps=10, global_batch=BATCH,
                                    seq_len=SEQ, peak_lr=LR, warmup_steps=0)
        batch = jax.tree.map(jnp.asarray, _npz_tree(starts, f"{name}/b"))
        mesh = make_host_mesh(*shape)
        psh = tree_shardings(mesh, jaxes(cfg),
                             model_abstract_params(cfg), rules)

        def place(prefix):
            return jax.device_put(jax.tree.map(
                jnp.asarray, _npz_tree(starts, prefix)), psh)

        params = place(f"{name}/p")
        opt = jopt.OptState(place(f"{name}/m"), place(f"{name}/v"),
                            jnp.asarray(starts[f"{name}/step"]))
        comp = jinit(params, JCC())
        step = jax.jit(jtrain.make_train_step(
            cfg, ocfg, run, ShardCtx(mesh=mesh, rules=rules), JCC()))
        with mesh:
            params, _, _, m = step(params, opt, comp, batch, jnp.int32(1))
        tag = f"{name}/{shape[0]}x{shape[1]}"
        put(f"{tag}/p", params)
        saved[f"{tag}/loss"] = np.asarray(m["loss"])
        saved[f"{tag}/gnorm"] = np.asarray(m["gnorm"])
    # renamed into place whole: the ranks wait for it
    np.savez(os.path.join(out_dir, "repro.tmp.npz"), **saved)
    os.replace(os.path.join(out_dir, "repro.tmp.npz"),
               os.path.join(out_dir, "repro.npz"))
    print("ok: repro (2, 2) int8 steps 0 and 1, and every family's steps")


# ------------------------------------------------------------------ tests --
@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """repro's steps beside the 4-rank launch, then the 2-rank resume; and
    the one-device runs the resume and the trainer's model splits are held
    against."""
    out = tmp_path_factory.mktemp("mesh")
    cfg = _cfg("stablelm-3b")
    params = init_params(model_template(cfg), torch.Generator().manual_seed(
        6), cfg.param_dtype, "cpu")
    inputs = _flat(params, cfg, "p")
    for s in (0, 1):
        for k, v in _batch(cfg, s).items():
            inputs[f"b{s}/{k}"] = v.numpy()
    np.savez(out / "inputs.npz", **inputs)
    starts = {}
    for name in sorted({n for _, n in TP_CASES}):
        arch, width = CONFIGS[name]
        starts.update(_starts(_cfg(arch, **width), name))
    np.savez(out / "starts.npz", **starts)
    t0 = time.time()
    procs = _start(lambda r: [sys.executable, __file__, "repro", str(out)], 1)
    procs += _start(lambda r: [sys.executable, __file__, "ranks", str(out),
                               str(r), "4", str(out / "store4")], 4)
    _wait(procs)
    t1 = time.time()
    _launch(lambda r: [sys.executable, __file__, "resume", str(out), str(r),
                       "2", str(out / "store2")], 2)
    t2 = time.time()
    ranks = [json.load(open(out / f"ranks_{r}.json")) for r in range(4)]
    resume = [json.load(open(out / f"resume_{r}.json")) for r in range(2)]
    saved = T.Watchdog, T._model_cfg
    T.Watchdog, T._model_cfg = _Steady, _float32_model_cfg
    try:
        one = T.train(_elastic_run(str(out / "one")))
        one_tp = {name: T.train(_tp_run(CONFIGS[name][0],
                                        str(out / f"one_tp_{name}")))
                  for name in TP_FAMILIES}
    finally:
        T.Watchdog, T._model_cfg = saved
    print(f"repro and 4 ranks {t1 - t0:.1f} s, resume {t2 - t1:.1f} s")
    return {"dir": out, "ranks": ranks, "resume": resume, "one": one,
            "one_tp": one_tp}


def _case(mesh_runs, key):
    """A case's numbers as every rank of its mesh saw them (equal)."""
    seen = [r[key] for r in mesh_runs["ranks"] if key in r]
    assert seen, key
    return seen


STEP_KEYS = (
    [f"{t}/stablelm/{c}/{g}" for t in ("2x1", "1x2", "2x2")
     for c, g in STEP_CASES]
    + [f"{t}/stablelm/adafactor/1" for t in ("2x1", "1x2", "2x2")]
    + [f"2x1/{f}/none/1" for f in ("moe", "hybrid", "ssm", "vlm", "audio")]
    + ["1x2/yi_cut_kv/none/1",
       "1x2/qwen_bias/none/1", "2x2/yi_cut_kv/none/1",
       "1x4/yi_repl_kv/none/1", "1x4/yi_cut_q/none/1", "repro/2x2/int8"])
TP_KEYS = [f"{d}x{m}/{f}/none/1" for (d, m), f in TP_CASES]


def _hold_step(r) -> None:
    assert r["loss"] == pytest.approx(r["loss_want"], rel=LOSS_RTOL), r
    assert r["gnorm"] == pytest.approx(r["gnorm_want"], rel=GNORM_RTOL), r
    assert r["update_rel_worst"] <= UPDATE_RTOL, r
    assert r["residual_off_share"] <= RESIDUAL_OFF, r
    assert r["numels_ok"], r
    assert r["split_leaves"] >= 3, r


@pytest.mark.parametrize("key", STEP_KEYS + TP_KEYS)
def test_mesh_step_matches_one_device(mesh_runs, key):
    """One mesh step against the one-device port step (repro's GSPMD step
    for ``repro/``) from the same state and batch; moe routes every layer
    as the one-device step does."""
    seen = _case(mesh_runs, key)
    for r in seen:
        assert r == seen[0], (key, seen)     # the ranks agree exactly
    _hold_step(seen[0])
    if "/moe" in key:
        assert seen[0]["routes_equal"] is True, seen[0]


@pytest.mark.parametrize("key", TP_KEYS)
def test_mesh_step_matches_repro(mesh_runs, key):
    """The same mesh step against repro's GSPMD step on a mesh of its shape
    (4 forced CPU devices), from the same state and batch."""
    _hold_step(_case(mesh_runs, key)[0]["repro"])


@pytest.mark.parametrize("key", [f"codec/{d}x{m}/{f}"
                                 for (d, m), f in TP_CASES])
def test_int8_codec_on_model_split_leaves_equals_one_device(mesh_runs, key):
    """The int8 codec over each family's slices (experts, ssm_inner and
    ssm_heads among them) codes and carries as the one-device codec."""
    assert all(r is True for r in _case(mesh_runs, key)), key


@pytest.mark.parametrize("name", TP_FAMILIES)
def test_trainer_splits_every_family_over_model(mesh_runs, name):
    """train() of every family on a (2, 2) mesh (a model extent of 2;
    PR 24's trainer refused it for any family but dense): one step, whose
    loss is the one-device trainer's."""
    want = mesh_runs["one_tp"][name]
    for r in mesh_runs["ranks"]:
        got = r[f"train/{name}"]
        assert got["finished"] == 1, got
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)


def test_model_param_axes_equal_repros_for_every_config():
    from repro.configs.registry import get_config as jax_config
    from repro.models.model import model_param_axes as jax_axes
    import jax
    for name in ARCH_NAMES:
        from repro_torch.configs.registry import get_config
        want = jax_axes(jax_config(name))
        got = model_param_axes(get_config(name))
        flat_w = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, tuple))[0]
        flat_g = jax.tree_util.tree_flatten_with_path(
            got, is_leaf=lambda x: isinstance(x, tuple))[0]
        assert [(jax.tree_util.keystr(p), a) for p, a in flat_g] == \
            [(jax.tree_util.keystr(p), a) for p, a in flat_w], name


def test_mesh_checkpoint_bytes_equal_one_device(mesh_runs):
    """The same state saved by one device, by the (2, 2) mesh with
    ``save`` and with ``save_async``, and as the DTensors a mesh restore
    gives: every file equal byte for byte; the restore gives each rank
    its slices."""
    ck = mesh_runs["ranks"][0]["checkpoint"]
    assert ck["one"] and "manifest.json" in ck["one"]
    for k in ("mesh", "mesh_async", "dtensor"):
        assert ck[k] == ck["one"], k
    assert all(r["checkpoint"]["restored_equal"]
               for r in mesh_runs["ranks"])


@pytest.mark.parametrize("name", ["moe", "hybrid"])
def test_model_split_checkpoint_bytes_equal_one_device(mesh_runs, name):
    """The expert, ssm_inner and ssm_heads slices of a (1, 4) mesh (and
    hybrid's shared block's) saved as one device saves them: every file
    equal byte for byte."""
    ck = mesh_runs["ranks"][0][f"checkpoint/{name}"]
    assert ck["one"] and "manifest.json" in ck["one"]
    for k in ("mesh", "mesh_async", "dtensor"):
        assert ck[k] == ck["one"], k
    assert all(r[f"checkpoint/{name}"]["restored_equal"]
               for r in mesh_runs["ranks"])


def test_repro_checkpoint_restores_on_the_mesh(mesh_runs):
    """repro's checkpoint of its sharded (2, 2) state: each of the port's
    (2, 2) ranks reads its slices, equal to repro's arrays."""
    assert all(r["repro/restored"] is True for r in mesh_runs["ranks"])


def test_mesh_checkpoint_restores_in_repro(mesh_runs):
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    import jax
    d = str(mesh_runs["dir"] / "ckpt_bytes")
    cfg = _cfg("stablelm-3b")
    template = {"params": init_params(model_template(cfg), None,
                                      cfg.param_dtype, "meta"),
                "opt": None}
    template["opt"] = topt.init(template["params"], topt.OptConfig())
    target = tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                     np.float32), template)
    target["opt"] = target["opt"]._replace(
        step=jax.ShapeDtypeStruct((), np.int32))
    got = JCheckpointer(os.path.join(d, "mesh")).restore(4, target)
    want = Checkpointer(os.path.join(d, "one")).restore(4, template)
    for g, w in zip(jax.tree.leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_elastic_restart_on_two_ranks_follows_one_device(mesh_runs):
    """(2, 2) on 4 ranks, stopped after step 4; resumed on the 2 ranks of
    plan_remesh(4, 2, model=2) (a (1, 2) mesh, grad_accum 2) from the
    committed step: the losses follow the uninterrupted one-device run."""
    first = [r["elastic/first"] for r in mesh_runs["ranks"]]
    assert all(f["stopped_at"] == ELASTIC_STOP for f in first), first
    for r in mesh_runs["resume"]:
        assert r["plan"] == [1, 2] and r["grad_accum"] == 2, r
        assert r["result"]["finished"] == ELASTIC_STEPS, r
    with open(mesh_runs["dir"] / "elastic" / "metrics.jsonl") as f:
        got = [json.loads(x) for x in f]
    with open(mesh_runs["dir"] / "one" / "elastic" / "metrics.jsonl") as f:
        want = [json.loads(x) for x in f]
    assert [m["step"] for m in got] == list(range(ELASTIC_STEPS))
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=LOSS_RTOL), (g, w)
        assert g["gnorm"] == pytest.approx(w["gnorm"], rel=GNORM_RTOL), \
            (g, w)
    assert mesh_runs["resume"][0]["result"]["loss"] == pytest.approx(
        mesh_runs["one"]["loss"], rel=LOSS_RTOL)


def test_sigterm_on_one_rank_stops_every_rank(mesh_runs):
    seen = [r["sigterm"] for r in mesh_runs["ranks"]]
    assert all(s == {"stopped_at": 3, "latest": 3} for s in seen), seen


def test_degraded_on_one_rank_switches_every_rank(mesh_runs):
    seen = [r["degraded"]["codecs"] for r in mesh_runs["ranks"]]
    assert all(c == ["none", "bf16"] for c in seen), seen
    assert mesh_runs["ranks"][0]["degraded"]["watchdog"] == \
        [HEALTHY] * 2 + ["degraded"] * 3


@pytest.mark.parametrize("key", ["outside"])
def test_train_refuses_on_a_real_group(mesh_runs, key):
    """On the 4 gloo ranks: a (1, 2) mesh leaves 2 ranks outside it; each
    rank raises NotImplementedError before it builds any state (no
    checkpoint directory)."""
    want = {"outside": "2 of the group's 4 ranks lie outside the (1, 2)"}
    for r in mesh_runs["ranks"]:
        assert want[key] in r[f"refuse/{key}"], r[f"refuse/{key}"]
        assert r[f"refuse/{key}/state"] is False


# -------------------------------------------- a (1, 1) mesh, in process ----
@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("codec,ga", [("none", 1), ("int8", 2)])
def test_one_by_one_mesh_is_bit_identical(one_rank_group, codec, ga):
    from repro_torch.launch.mesh import make_host_mesh
    cfg = _cfg("stablelm-3b")
    run, ocfg, ccfg = _run("stablelm-3b", codec, ga), topt.OptConfig(
        lr=LR), CompressConfig(codec=codec)
    start = _state_after_one_step(cfg, run, ocfg, ccfg)
    outs = []
    for mesh in (None, make_host_mesh(1, 1, "cpu")):
        p, o, c = (_clone(t) for t in start)
        for t in tree_leaves(p):
            t.requires_grad_(True)
        p, o, c, m = T.make_train_step(cfg, ocfg, run, ccfg, mesh)(
            p, o, c, _batch(cfg, 1), 1)
        outs.append((m, p, o, c))
    (m0, p0, o0, c0), (m1, p1, o1, c1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["gnorm"]) == float(m1["gnorm"])
    for a, b in zip(tree_leaves((p0, o0, c0)), tree_leaves((p1, o1, c1))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", TP_FAMILIES)
def test_one_by_one_mesh_is_bit_identical_for_every_family(one_rank_group,
                                                           name):
    """Every family but dense: the (1, 1) mesh's step equals the
    one-device step bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    arch, width = CONFIGS[name]
    cfg = _cfg(arch, **width)
    run, ocfg, ccfg = _run(arch), topt.OptConfig(lr=LR), CompressConfig()
    start = _state_after_one_step(cfg, run, ocfg, ccfg)
    outs = []
    for mesh in (None, make_host_mesh(1, 1, "cpu")):
        p, o, c = (_clone(t) for t in start)
        for t in tree_leaves(p):
            t.requires_grad_(True)
        p, o, c, m = T.make_train_step(cfg, ocfg, run, ccfg, mesh)(
            p, o, c, _batch(cfg, 1), 1)
        outs.append((m, p, o))
    (m0, p0, o0), (m1, p1, o1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["gnorm"]) == float(m1["gnorm"])
    for a, b in zip(tree_leaves((p0, o0)), tree_leaves((p1, o1))):
        assert torch.equal(a, b)


def test_train_on_a_one_rank_group_equals_one_device(tmp_path,
                                                     monkeypatch):
    """train() without a group and on a (1, 1) mesh: equal metrics and
    checkpoint files, byte for byte; the mesh's checkpoint restores into
    the one-device trainer."""
    monkeypatch.setattr(T, "Watchdog", _Steady)
    run = _run("stablelm-3b", steps=3, ckpt_interval=2, warmup_steps=1)
    T.train(dataclasses.replace(run, ckpt_dir=str(tmp_path / "one")))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        T.train(dataclasses.replace(run, ckpt_dir=str(tmp_path / "mesh")))
    finally:
        dist.destroy_process_group()
    for step in (2, 3):
        d = f"step_{step:010d}"
        assert _files(tmp_path / "one" / d) == _files(tmp_path / "mesh" / d)
    lines = [open(tmp_path / k / "metrics.jsonl").read().splitlines()
             for k in ("one", "mesh")]
    strip = [[{k: v for k, v in json.loads(x).items() if k != "time_s"}
              for x in ls] for ls in lines]
    assert strip[0] == strip[1]
    # the one-device trainer resumes from the mesh's step 2
    (tmp_path / "mesh" / f"step_{3:010d}").rename(tmp_path / "x")
    got = T.train(dataclasses.replace(run, ckpt_dir=str(tmp_path / "mesh")))
    assert got["finished"] == 3
    resumed = json.loads(open(tmp_path / "mesh" / "metrics.jsonl")
                         .read().splitlines()[-1])
    assert resumed["step"] == 2 and resumed["loss"] == strip[0][2]["loss"]


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "repro":
        repro_worker(sys.argv[2])
    else:
        worker = {"ranks": ranks_worker, "resume": resume_worker}[mode]
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
