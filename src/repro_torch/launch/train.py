"""End-to-end fault-tolerant trainer.

Composes the substrate's layers, as the JAX package's trainer does:
  configs (arch registry) -> data (stateless-by-step stream) -> model
  (loss_fn) -> optim (AdamW + LR schedule + optional gradient
  compression) -> checkpoint (atomic, async) -> runtime (preemption
  guard + straggler watchdog).

Fault-tolerance behaviour:
  * restart: on launch, the latest committed checkpoint is restored and
    the data stream resumes at the same step (identical batches).
  * preemption: SIGTERM (or Watchdog EVICT) sets a flag; the loop
    checkpoints at the next step boundary and exits cleanly.
  * stragglers: step times feed the Watchdog; DEGRADED switches gradient
    compression on (bf16) without restarting.

Training runs on one device, with no process group or a group of world
size 1; under a larger group `train` raises before it builds any state.
Training over more ranks (FSDP over ``data``, tensor parallelism over
``model``) is not ported.

Usage (the GPU unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --device cpu --steps 100 --batch 8 --seq 128 --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.models.model import loss_fn, model_init_params
from repro_torch.models.template import init_params
from repro_torch.models.transformer import model_template
from repro_torch.optim import adamw as optim
from repro_torch.optim.compress import CompressConfig, compress, init_state
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.runtime.watchdog import DEGRADED, EVICT, Watchdog
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
                    run: TrainRunConfig, ccfg: CompressConfig):
    """One update ``step_fn(params, opt_state, comp_state, batch, step)``
    -> (params, opt_state, comp_state, metrics).

    ``params`` (leaves requiring grad) and ``opt_state`` are updated in
    place (the JAX package donates them to its jitted step).  With
    ``run.grad_accum`` > 1 the batch splits into that many micro-batches
    along dim 0, whose losses and float32 gradients are summed and
    divided by it.  ``metrics``: the loss, the global norm of the
    gradients after the codec (before clipping) and the learning rate,
    as 0-d tensors.
    """

    def micro_grads(params, batch):
        loss, _ = loss_fn(params, batch, cfg)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), _unflatten(params, iter(grads))

    def step_fn(params, opt_state, comp_state, batch, step):
        ga = run.grad_accum
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
        # wire-format compression where a data-parallel reduction would
        # sit: compress -> decompress bounds the bytes it would move, with
        # error feedback carried.
        wire, comp_state, dec = compress(grads, comp_state, ccfg)
        grads = dec(wire)
        lr = warmup_cosine(step, peak_lr=run.peak_lr,
                           warmup_steps=run.warmup_steps,
                           total_steps=run.steps)
        params, opt_state = optim.update(grads, opt_state, params, opt_cfg,
                                         lr=lr)
        gnorm = optim.global_norm(grads)
        return params, opt_state, comp_state, {"loss": loss, "gnorm": gnorm,
                                               "lr": lr}

    return step_fn


def _init_state(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                run: TrainRunConfig, ckpt: Checkpointer, device):
    """(params, opt_state, start_step): the latest committed checkpoint,
    or fresh parameters drawn from ``run.seed`` on ``device``."""
    latest = ckpt.latest_step()
    if latest is None:
        gen = torch.Generator(device=device).manual_seed(run.seed)
        params = model_init_params(cfg, gen, device)
        return params, optim.init(params, opt_cfg), 0
    # restore to the host (meta targets carry shapes and dtypes), then move
    meta = init_params(model_template(cfg), None, cfg.param_dtype, "meta")
    state = ckpt.restore(latest, {"params": meta,
                                  "opt": optim.init(meta, opt_cfg)})
    state = tree_map(lambda t: t.to(device), state)
    print(f"[train] resumed from step {latest}", flush=True)
    return state["params"], state["opt"], latest


def train(run: TrainRunConfig) -> dict:
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"training over {dist.get_world_size()} ranks is not ported; "
            f"the trainer runs on one device")
    device = torch.device(run.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TrainRunConfig.device is 'cuda' but no CUDA "
                           "device is available; train on the CPU with "
                           "device='cpu'")
    cfg = _model_cfg(run)
    opt_cfg = optim.OptConfig(lr=run.peak_lr)
    ccfg = CompressConfig(codec=run.codec)
    ckpt = Checkpointer(run.ckpt_dir)
    params, opt_state, start_step = _init_state(cfg, opt_cfg, run, ckpt,
                                                device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    comp_state = init_state(params, ccfg)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=run.seq_len,
                          global_batch=run.global_batch, seed=run.seed)
    step_fn = make_train_step(cfg, opt_cfg, run, ccfg)

    guard = PreemptionGuard()
    dog = Watchdog()
    metrics_path = os.path.join(run.ckpt_dir, "metrics.jsonl")
    last = {}
    end_step = min(run.steps, run.stop_after or run.steps)
    try:
        with open(metrics_path, "a") as mf:
            for step in range(start_step, end_step):
                t0 = time.time()
                batch = batch_for_step(data_cfg, cfg, step, device)
                params, opt_state, comp_state, m = step_fn(
                    params, opt_state, comp_state, batch, step)
                m = {k: float(v) for k, v in m.items()}
                dt = time.time() - t0
                state = dog.observe(dt)
                if state == DEGRADED and ccfg.codec == "none":
                    # straggler mitigation: halve collective bytes in place
                    ccfg = CompressConfig(codec="bf16")
                    step_fn = make_train_step(cfg, opt_cfg, run, ccfg)
                    print(f"[train] watchdog DEGRADED at {step}: "
                          f"enabling bf16 gradient compression", flush=True)
                m.update(step=step, time_s=dt, watchdog=state)
                mf.write(json.dumps(m) + "\n")
                if step % run.log_interval == 0:
                    print(f"[train] step {step} loss {m['loss']:.4f} "
                          f"lr {m['lr']:.2e} {dt*1e3:.0f}ms", flush=True)
                last = m
                stop = guard.should_checkpoint() or state == EVICT
                if (step + 1) % run.ckpt_interval == 0 or stop \
                        or step + 1 == end_step:
                    ckpt.save_async(step + 1, {"params": params,
                                               "opt": opt_state},
                                    extra={"loss": m["loss"]})
                if stop:
                    ckpt.wait()
                    print(f"[train] preempted at step {step}; checkpoint "
                          f"committed, exiting", flush=True)
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run = TrainRunConfig(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.batch, seq_len=args.seq, peak_lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
        codec=args.codec, grad_accum=args.grad_accum, device=args.device,
        n_layers=args.layers)
    out = train(run)
    print(f"[train] done: {out}", flush=True)


if __name__ == "__main__":
    main()
