"""End-to-end fault-tolerant trainer.

Composes the substrate's layers, as the JAX package's trainer does:
  configs (arch registry) -> data (stateless-by-step stream) -> model
  (loss_fn) -> optim (AdamW + LR schedule + optional gradient
  compression) -> sharding (a (data, model) mesh + the logical rules) ->
  checkpoint (atomic, async, reshard-on-restore) -> runtime (preemption
  guard + straggler watchdog).

Fault-tolerance behaviour:
  * restart: on launch, the latest committed checkpoint is restored and
    the data stream resumes at the same step (identical batches).
  * preemption: SIGTERM (or Watchdog EVICT) sets a flag; the loop
    checkpoints at the next step boundary and exits cleanly.
  * stragglers: step times feed the Watchdog; DEGRADED switches gradient
    compression on (bf16) without restarting.

Without a process group training runs on one device.  Under one, every
rank of the group is one place of a ``(data_mesh, model_mesh)`` mesh
(`make_host_mesh`; a device ``cuda:LOCAL_RANK``, or the CPU under gloo):
parameters and AdamW / Adafactor moments are sliced by the JAX
package's rules (FSDP of ``embed`` over ``data``; tensor parallelism of
``q_heads`` / ``kv_heads`` / ``ff`` / ``vocab`` / ``experts`` /
``ssm_inner`` / ``ssm_heads`` over ``model``, for every family), each
rank trains on its rows of the global batch, and explicit collectives do
what GSPMD does for the JAX package (`models.transformer`).  The steps
equal the one-device run's within float32 summation order (bit for bit
on a (1, 1) mesh).  The ranks agree on each step's watchdog state and
stop flag, so they switch codec or stop at the same step.  `train`
refuses, before it builds any state, a group with ranks outside its
mesh.

Usage (the GPU unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --device cpu --steps 100 --batch 8 --seq 128 --ckpt-dir build/ckpt
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --data-mesh 2 --model-mesh 2 --arch stablelm-3b ...
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import contextlib

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import (
    local_rows, loss_fn, model_init_params, param_shardings,
)
from repro_torch.models.template import init_params
from repro_torch.models.transformer import model_template
from repro_torch.optim import adamw as optim
from repro_torch.optim.compress import CompressConfig, compress, init_state
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.runtime.watchdog import DEGRADED, EVICT, HEALTHY, Watchdog
from repro_torch.sharding.collectives import (
    all_reduce_, mesh_all_reduce_, mesh_axis,
)
from repro_torch.sharding.partition import PROD_RULES, ShardCtx, Sharding
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainRunConfig:
    arch: str = "yi-6b"
    smoke: bool = True              # reduced config (CPU-runnable)
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    seed: int = 0
    ckpt_dir: str = "artifacts/train_torch/ckpt"
    ckpt_interval: int = 25
    log_interval: int = 10
    codec: str = "none"             # none | bf16 | int8
    data_mesh: int = 1              # mesh extents under a process group
    model_mesh: int = 1
    grad_accum: int = 1
    stop_after: int | None = None   # stop the loop at this step (the
                                    # schedule still uses `steps`)
    device: str = "cuda"
    n_layers: int | None = None     # cut the config's depth (None: keep)


def _model_cfg(run: TrainRunConfig) -> ModelConfig:
    cfg = get_smoke_config(run.arch) if run.smoke else get_config(run.arch)
    if run.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=run.n_layers)
    return cfg


def _unflatten(like, values):
    """A dict tree of ``like``'s structure holding ``values`` (an iterator,
    in `tree_leaves` order)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], values) for k in sorted(like)}
    return next(values)


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    run: TrainRunConfig, ccfg: CompressConfig, mesh=None):
    """One update ``step_fn(params, opt_state, comp_state, batch, step)``
    -> (params, opt_state, comp_state, metrics).

    ``params`` (leaves requiring grad) and ``opt_state`` are updated in
    place (the JAX package donates them to its jitted step).  With
    ``run.grad_accum`` > 1 the batch splits into that many micro-batches
    along dim 0, whose losses and float32 gradients are summed and
    divided by it.  ``metrics``: the loss, the global norm of the
    gradients after the codec (before clipping) and the learning rate,
    as 0-d tensors.

    With ``mesh`` (a (data, model) `DeviceMesh`) the parameters, moments
    and codec state are this rank's slices (`param_shardings`) and
    ``batch`` is the global batch, of which the step keeps this rank's
    rows (`local_rows`).  Each micro-batch's gradients come back summed
    over ``data``: reduce-scattered by the FSDP gathers' backward, and
    all-reduced for a leaf not split over ``data``; the codec then codes
    the reduced gradient, and the metrics are the whole mesh's.
    """
    psh = ctx = data = None
    if mesh is not None:
        ctx = ShardCtx(mesh, PROD_RULES)
        psh = param_shardings(cfg, mesh)
        data = mesh_axis(mesh, "data")
        # leaves whose gradients the FSDP gathers do not reduce
        not_gathered = [data.name not in sh.spec for sh in tree_leaves(psh)]

    def micro_grads(params, batch):
        loss, _ = loss_fn(params, batch, cfg, ctx=ctx)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        loss = loss.detach()
        if mesh is not None:
            for g, rest in zip(grads, not_gathered):
                if rest:
                    all_reduce_(g, data)
            loss = all_reduce_(loss.clone(), data)
        return loss, _unflatten(params, iter(grads))

    def step_fn(params, opt_state, comp_state, batch, step):
        ga = run.grad_accum
        if mesh is not None:
            batch = local_rows(batch, ga, data)
        if ga > 1:
            loss, grads = 0.0, None
            for i in range(ga):
                mb = {k: v.reshape((ga, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                mloss, g = micro_grads(params, mb)
                loss = loss + mloss
                if grads is None:
                    grads = tree_map(lambda x: x.float(), g)
                else:
                    for acc, x in zip(tree_leaves(grads), tree_leaves(g)):
                        acc.add_(x)
                del g
            loss = loss / ga
            for acc in tree_leaves(grads):
                acc.div_(ga)
        else:
            loss, grads = micro_grads(params, batch)
        # wire-format compression of the reduced gradient (the JAX
        # package's GSPMD reduction comes before it too): compress ->
        # decompress bounds the bytes a reduction would move, with error
        # feedback carried.
        wire, comp_state, dec = compress(grads, comp_state, ccfg, psh)
        grads = dec(wire)
        lr = warmup_cosine(step, peak_lr=run.peak_lr,
                           warmup_steps=run.warmup_steps,
                           total_steps=run.steps)
        params, opt_state = optim.update(grads, opt_state, params, opt_cfg,
                                         lr=lr, shardings=psh)
        gnorm = optim.global_norm(grads, psh)
        return params, opt_state, comp_state, {"loss": loss, "gnorm": gnorm,
                                               "lr": lr}

    return step_fn


def _targets(cfg: ModelConfig, opt_cfg: optim.OptConfig, mesh):
    """{"params": ..., "opt": ...} of whole-array meta tensors (restore's
    targets) and, under ``mesh``, the same tree of `Sharding` (else
    None)."""
    meta = init_params(model_template(cfg), None, cfg.param_dtype, "meta")
    target = {"params": meta, "opt": optim.init(meta, opt_cfg)}
    if mesh is None:
        return target, None
    psh = param_shardings(cfg, mesh)
    return target, {"params": psh, "opt": optim.opt_state_sharding(
        psh, meta, opt_cfg, Sharding(mesh, ()))}


def _init_state(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                run: TrainRunConfig, ckpt: Checkpointer, device, mesh,
                target, placements):
    """(params, opt_state, start_step): the latest committed checkpoint,
    or fresh parameters drawn from ``run.seed`` on ``device``; under
    ``mesh`` (``placements``: `_targets`'), this rank's slices of them."""
    latest = ckpt.latest_step()
    if latest is None:
        gen = torch.Generator(device=device).manual_seed(run.seed)
        psh = placements["params"] if mesh is not None else None
        params = model_init_params(
            cfg, gen, device, psh,
            mesh.get_coordinate() if mesh is not None else None)
        return params, optim.init(params, opt_cfg, psh), 0
    # whole leaves to the host, then moved; under a mesh each rank reads
    # its slices (reshard-on-restore: a save under any mesh)
    state = ckpt.restore(latest, target, placements)
    state = tree_map(lambda t: (t if mesh is None else t.to_local())
                     .to(device), state)
    if mesh is None or dist.get_rank() == 0:
        print(f"[train] resumed from step {latest}", flush=True)
    return state["params"], state["opt"], latest


def _mesh_for(run: TrainRunConfig, device, mesh=None):
    """The run's mesh under a process group (None without one), after the
    refusal of a group with ranks outside the mesh."""
    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if mesh is None:
        # make_host_mesh's clamp, known before any group is made
        model = min(run.model_mesh, world)
        data = max(1, min(run.data_mesh, world // model))
        shape = (data, model)
    else:
        shape = tuple(mesh.shape)
    used = shape[0] * shape[1]
    if used != world:
        raise NotImplementedError(
            f"{world - used} of the group's {world} ranks lie outside the "
            f"{shape} (data, model) mesh; the trainer runs every rank in "
            f"its mesh and none alone: launch {used}, or ask for a mesh of "
            f"{world}")
    if mesh is None:
        mesh = make_host_mesh(run.data_mesh, run.model_mesh, device.type)
    return mesh


def _agree(state: str, stop: bool, mesh, device) -> tuple[str, bool]:
    """The watchdog state and the stop flag every rank acts on: the worst
    of the ranks' (an all-reduce MAX)."""
    if mesh is None:
        return state, stop
    order = (HEALTHY, DEGRADED, EVICT)
    t = torch.tensor([order.index(state), int(stop)], device=device)
    mesh_all_reduce_(t, mesh, dist.ReduceOp.MAX)
    return order[int(t[0])], bool(t[1])


def train(run: TrainRunConfig, mesh=None) -> dict:
    """Train ``run``; under a process group over ``mesh`` (a (data,
    model) `DeviceMesh` of every rank of the group, e.g. from
    `runtime.elastic.build_mesh`), or else over
    ``make_host_mesh(run.data_mesh, run.model_mesh)``."""
    device = torch.device(run.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TrainRunConfig.device is 'cuda' but no CUDA "
                           "device is available; train on the CPU with "
                           "device='cpu'")
    cfg = _model_cfg(run)
    if dist.is_initialized() and device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    mesh = _mesh_for(run, device, mesh)
    lead = mesh is None or dist.get_rank() == 0
    opt_cfg = optim.OptConfig(lr=run.peak_lr)
    ccfg = CompressConfig(codec=run.codec)
    ckpt = Checkpointer(run.ckpt_dir)
    target, placements = _targets(cfg, opt_cfg, mesh)
    params, opt_state, start_step = _init_state(
        cfg, opt_cfg, run, ckpt, device, mesh, target, placements)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    comp_state = init_state(params, ccfg)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=run.seq_len,
                          global_batch=run.global_batch, seed=run.seed)
    step_fn = make_train_step(cfg, opt_cfg, run, ccfg, mesh)

    guard = PreemptionGuard()
    dog = Watchdog()
    metrics_path = os.path.join(run.ckpt_dir, "metrics.jsonl")
    last = {}
    end_step = min(run.steps, run.stop_after or run.steps)
    try:
        with (open(metrics_path, "a") if lead
              else contextlib.nullcontext()) as mf:
            for step in range(start_step, end_step):
                t0 = time.time()
                batch = batch_for_step(data_cfg, cfg, step, device)
                params, opt_state, comp_state, m = step_fn(
                    params, opt_state, comp_state, batch, step)
                m = {k: float(v) for k, v in m.items()}
                dt = time.time() - t0
                state, stop = _agree(dog.observe(dt),
                                     guard.should_checkpoint(), mesh, device)
                stop = stop or state == EVICT
                if state == DEGRADED and ccfg.codec == "none":
                    # straggler mitigation: halve collective bytes in place
                    ccfg = CompressConfig(codec="bf16")
                    step_fn = make_train_step(cfg, opt_cfg, run, ccfg, mesh)
                    if lead:
                        print(f"[train] watchdog DEGRADED at {step}: "
                              f"enabling bf16 gradient compression",
                              flush=True)
                m.update(step=step, time_s=dt, watchdog=state)
                if lead:
                    mf.write(json.dumps(m) + "\n")
                if step % run.log_interval == 0 and lead:
                    print(f"[train] step {step} loss {m['loss']:.4f} "
                          f"lr {m['lr']:.2e} {dt*1e3:.0f}ms", flush=True)
                last = m
                if (step + 1) % run.ckpt_interval == 0 or stop \
                        or step + 1 == end_step:
                    ckpt.save_async(step + 1, {"params": params,
                                               "opt": opt_state},
                                    extra={"loss": m["loss"]},
                                    placements=placements)
                if stop:
                    ckpt.wait()
                    if lead:
                        print(f"[train] preempted at step {step}; "
                              f"checkpoint committed, exiting", flush=True)
                    return {"stopped_at": step + 1, **last}
        ckpt.wait()
    finally:
        guard.uninstall()
    if end_step < run.steps:
        return {"stopped_at": end_step, **last}
    return {"finished": run.steps, **last}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="artifacts/train_torch/ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--codec", default="none")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run = TrainRunConfig(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.batch, seq_len=args.seq, peak_lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
        codec=args.codec, data_mesh=args.data_mesh,
        model_mesh=args.model_mesh, grad_accum=args.grad_accum,
        device=args.device, n_layers=args.layers)
    # a launcher's ranks (torchrun sets WORLD_SIZE, RANK and the store's
    # address): one process group, NCCL between cards, gloo on the CPU
    group = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if group:
        dist.init_process_group("nccl" if run.device == "cuda" else "gloo")
    try:
        out = train(run)
    finally:
        if group:
            dist.destroy_process_group()
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"[train] done: {out}", flush=True)


if __name__ == "__main__":
    main()
