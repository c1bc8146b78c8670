"""Dry run on fake tensors: one rank's peak memory and the roofline of every
(arch x shape x mesh) cell, and of the GRCh38-scale genpair step.

One process acts as rank 0 of a ``"fake"`` process group whose world size
is the mesh's (`fake_world`), builds the port's own mesh and `ShardCtx`,
and runs the port's own step on fake tensors (`FakeTensorMode`): nothing
is allocated and nothing is launched.  The step is the trainer's
`make_train_step` (the loss and its gradients, then the optimizer
update), `prefill_step`, `decode_step`, or the sharded-index
`make_genpair_serve_step`, on this rank's slices of the parameters,
optimizer state, batch, cache and index, as the port places them
(`Sharding.local_shape`, `init_cache(ctx=)`).  A `Counter` (a dispatch
mode under the fake mode) reads every aten and c10d op the step runs:

  A. memory: the live bytes of every storage (the caching allocator's
     512-byte rounding on "cuda"), as the step allocates and frees them,
     and their peak; reported in the JAX package's ``_mem_dict`` keys
     (argument, output, temp, alias, total_nonalias);
  B. costs: FLOPs by dtype (`torch.utils.flop_counter`'s formulas), HBM
     bytes (each op's inputs and outputs once, views excluded: eager's
     traffic), each hand-written kernel's `Work` (the launch records it,
     `kernels._cuda.dry_run_launches`) and each collective's operand
     bytes and link time, by kind.

Eager costs are exact for the layers a trace runs, so, as in the JAX
package, a cell traces k and 2k layer units at its full shape and
extrapolates both A and B to the model's depth (`combine_layers`):
total(L) = total(k) + (L - k) / k * (total(2k) - total(k)), with k = 1
as there.  The peak is extrapolated event by event (`_peak_at`), since
the event that peaks can move as the model deepens.  Where the
JAX package extrapolates over S (`seq_exact_points`), the same
extrapolation from short sequences is recorded beside the full-length
count as a check of the fit.

The fakes live on "cuda" (the card's kernels record their launches) unless
the caller asks for "cpu" (``--device cpu``, the tests): a CPU-only build
cannot make some fake CUDA tensors.  On "cpu" the kernel wrappers still
take their kernel route (`kernels._cuda.routes_kernels`), so a dry run on
the CPU counts the work the card would do.

Artifacts: one JSON per cell under artifacts/dryrun_torch/, in the JAX
package's format (`repro_torch.launch.report` reads either).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --arch genpair --shape serve_256k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--device cpu]
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b \\
      --shape decode_32k --mesh 1x4 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import weakref
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist
from torch._C._distributed_c10d import ProcessGroup
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import roofline as RF
from repro_torch.configs import genpair
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.core.distributed import SeedMapShard
from repro_torch.core.genpairx_step import (
    genpair_input_specs, make_genpair_serve_step,
)
from repro_torch.engine.mapper import _mask_tail
from repro_torch.kernels import _cuda
from repro_torch.kernels._util import kernel_reference
from repro_torch.kernels.candidate_align.ops import (
    CANDIDATES_PER_PAIR, VALID_CANDIDATES_PER_PAIR,
)
from repro_torch.kernels.pair_frontend.ops import HITS_PER_MATE
from repro_torch.kernels.residual_dp.ops import ITEMS_PER_ROW
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import TrainRunConfig, make_train_step
from repro_torch.models.model import decode_step, prefill_step
from repro_torch.models.template import Leaf
from repro_torch.models.transformer import (
    init_cache, model_template, param_shardings,
)
from repro_torch.optim import adamw as optim
from repro_torch.optim.compress import CompressConfig, init_state
from repro_torch.sharding.partition import (
    MULTIPOD_RULES, PROD_RULES, ShardCtx,
)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
PROD_MESH = (16, 16)
# the (pod, data, model) = (2, 16, 16) mesh: the port splits a batch over
# one axis, so pod x data is one data axis of 32
MULTIPOD_MESH = (32, 16)
ALL_SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
K_LAYERS = 1             # the layer units of the shallower trace (k)
# The per-row rates at which the genpair step's kernels count the work
# that depends on the data (the kernels' cost functions, which a dry run
# calls without data), and where they were measured.  Written into each
# genpair artifact: its kernel terms are those of this traffic, not of
# reads against GRCh38, whose repeats give a read more hits.
DATA_STATISTICS = {
    "source": "chip_smoke.py's pair-lane batch: 65,536 pairs simulated at "
              "sub_rate 0.01 from a 2^27-base random reference; not GRCh38 "
              "traffic",
    "hits_per_mate": HITS_PER_MATE,
    "aligned_candidates_per_pair": CANDIDATES_PER_PAIR,
    "valid_candidates_per_pair": VALID_CANDIDATES_PER_PAIR,
    "residual_items_per_row": ITEMS_PER_ROW,
}


# ============================================================ counting =====
def _tensors(x, out: list) -> list:
    """The tensors of a tree of tuples, lists and dicts, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _touched(t: torch.Tensor) -> int:
    """Bytes an op reads or writes of ``t``: its elements, a broadcast
    (stride 0) dim counted once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride:
            n *= size
    return n


aten = torch.ops.aten
# ops that move no data: allocation, aliasing and metadata
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.alias, aten.lift_fresh, aten.resize_, aten.set_,
               aten._unsafe_view, aten._reshape_alias}
# in-place ops that write their first argument without reading it
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
               aten.uniform_, aten.random_}
# gathers read of their source (the first argument) only the elements
# they return
_GATHERS = {aten.index, aten._unsafe_index, aten.index_select, aten.gather,
            aten.embedding, aten.take}
# in-place scatters touch of their first argument only the elements the
# values land on
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.scatter_,
             aten.scatter_add_, aten.scatter_reduce_, aten.index_add_,
             aten.index_copy_, aten.masked_scatter_}
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "broadcast",
}


def _flop_dtype(dtype: torch.dtype) -> str:
    """The `roofline.PEAKS` key a matmul in ``dtype`` runs at."""
    if dtype in (torch.bfloat16, torch.float16):
        return str(dtype).removeprefix("torch.")
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "float32"


def _process_group(args):
    """The process group among a c10d op's arguments."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a)
            except RuntimeError:        # another custom class (ReduceOp)
                continue
    raise ValueError("a c10d op without a process group")


class Counter(TorchDispatchMode):
    """Counts one step's work and tracks its live bytes (see the module
    docstring).  Register the step's arguments with `add_arguments` before
    it runs; read `memory` and `costs` after.  Works on real tensors too
    (the tests hold a fake run against a real CPU run)."""

    def __init__(self, cuda_sizes: bool):
        super().__init__()
        self.cuda_sizes = cuda_sizes
        self.flops = defaultdict(float)
        self.int_ops = 0.0
        self.bytes = 0.0
        self.coll_bytes = defaultdict(float)
        self.coll_count = defaultdict(int)
        self.coll_s = 0.0
        self.kernels: dict[str, dict] = {}
        self.live = 0
        # the live bytes after the arguments and after each op that returns
        # tensors, and the op: the timeline `_peak_at` extrapolates
        self.timeline: list[int] = []
        self.names: list = []
        self._sizes: dict[int, int] = {}       # id(storage) -> bytes
        self._refs: dict[int, weakref.ref] = {}
        self._args: dict[str, int] = {}        # group -> bytes
        self._arg_ids: set[int] = set()

    # ---- memory ----------------------------------------------------------
    def _round(self, n: int) -> int:
        if self.cuda_sizes and n:
            return (n + 511) // 512 * 512
        return n

    def _free(self, key: int, _ref) -> None:
        self.live -= self._sizes.pop(key, 0)
        self._refs.pop(key, None)

    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage once while it lives; its bytes (none on
        the "meta" device, where the port lays out shapes only)."""
        if t.device.type == "meta":
            return 0
        st = t.untyped_storage()
        key = id(st)
        n = self._round(st.nbytes())
        old = self._sizes.get(key)
        if old is None:
            self._sizes[key] = n
            self._refs[key] = weakref.ref(st, functools.partial(self._free,
                                                                key))
            self.live += n
        elif old != n:                      # resized in place
            self._sizes[key] = n
            self.live += n - old
        return n

    def add_arguments(self, groups: dict) -> None:
        """The step's inputs, by group ({name: tree}); a storage shared
        between groups counts in the first."""
        for name, tree in groups.items():
            total = 0
            for t in _tensors(tree, []):
                key = id(t.untyped_storage())
                if key in self._arg_ids:
                    continue
                self._arg_ids.add(key)
                total += self._track(t)
            self._args[name] = total
        self.timeline.append(self.live)
        self.names.append("<arguments>")

    def memory(self, outputs) -> dict:
        """The JAX package's ``_mem_dict`` of the step: arguments, outputs
        (alias: the outputs that are arguments updated in place), temp
        (the peak less the arguments and the new outputs) and
        total_nonalias (the peak); plus ``peak_bytes`` and the arguments
        by group."""
        seen, output, alias = set(), 0, 0
        for t in _tensors(outputs, []):
            key = id(t.untyped_storage())
            if key in seen:
                continue
            seen.add(key)
            n = self._sizes.get(key, 0)      # 0: not allocated by the step
            output += n
            if key in self._arg_ids:
                alias += n
        argument = sum(self._args.values())
        peak = max(self.timeline, default=0)
        temp = max(peak - argument - (output - alias), 0)
        return {
            "argument_size_in_bytes": argument,
            "output_size_in_bytes": output,
            "temp_size_in_bytes": temp,
            "alias_size_in_bytes": alias,
            "generated_code_size_in_bytes": 0,
            "total_nonalias_bytes": argument + output + temp - alias,
            "peak_bytes": peak,
            "argument_bytes": dict(self._args),
        }

    # ---- work ------------------------------------------------------------
    def kernel(self, name: str, work: _cuda.Work) -> None:
        """A kernel launch on fake tensors (`_cuda.dry_run_launches`)."""
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0.0,
                                           "ops": 0.0, "unit": work.unit})
        k["launches"] += 1
        k["bytes"] += work.bytes
        k["ops"] += work.ops
        self.bytes += work.bytes
        if work.unit == "int32":
            self.int_ops += work.ops
        else:
            self.flops[work.unit] += work.ops

    def _collective(self, func, args) -> None:
        kind = _COLLECTIVES.get(func._opname)
        if kind is None:                    # barrier, monitored waits
            return
        group = _process_group(args)
        if group.size() == 1:
            return                          # nothing leaves the rank
        operand = args[0] if kind in ("all-reduce", "broadcast") else args[1]
        n = sum(_touched(t) for t in _tensors(operand, []))
        self.coll_bytes[kind] += n
        self.coll_count[kind] += 1
        self.coll_s += n / RF.link_bw(dist.get_process_group_ranks(group))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        outs = _tensors(out, [])
        if func.is_view or not outs:        # aliases and metadata
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            first = _tensors(args, [])[0]
            self.flops[_flop_dtype(first.dtype)] += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if packet not in _NO_TRAFFIC:
            self.bytes += self._traffic(packet, args, kwargs, outs)
        for t in outs:
            self._track(t)
        self.timeline.append(self.live)
        self.names.append(func)
        return out

    @staticmethod
    def _traffic(packet, args, kwargs, outs) -> int:
        """Each input read once and each output written once; a gather's
        source only where it is read, an in-place scatter's target only
        where it is written."""
        ins = _tensors(args, [])
        _tensors(kwargs, ins)
        first = packet in _OVERWRITES or packet in _GATHERS \
            or packet in _SCATTERS
        seen, n = set(), 0
        for i, t in enumerate(ins):
            if id(t) not in seen and not (i == 0 and first):
                n += _touched(t)
            seen.add(id(t))
        if packet in _SCATTERS:     # the values, written where they land
            return n + _touched(ins[-1])
        seen.clear()
        for t in outs:
            if id(t) not in seen:
                seen.add(id(t))
                n += _touched(t) * (2 if packet in _GATHERS else 1)
        return n

    def costs(self) -> dict:
        return {
            "flops": float(sum(self.flops.values())),
            "flops_by_dtype": dict(self.flops),
            "int_ops": self.int_ops,
            "bytes": self.bytes,
            "coll": float(sum(self.coll_bytes.values())),
            "coll_by_kind": dict(self.coll_bytes),
            "coll_count_by_kind": {k: float(v)
                                   for k, v in self.coll_count.items()},
            "coll_s": self.coll_s,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


def trace(build, device: str = "cuda", kernels: bool = True) -> dict:
    """Run ``build() -> (step, groups)`` and then ``step()`` on fake tensors
    on ``device``: {"memory": ..., "costs": ...} of the step.  ``groups``
    ({name: tree}) are the step's arguments.  ``kernels``: on the CPU the
    kernel wrappers take their kernel route (a launch records its work),
    else their plain versions run (an LM step's, which the tests hold
    against a real CPU run)."""
    cuda = torch.device(device).type == "cuda"
    with FakeTensorMode():
        step, groups = build()
        counter = Counter(cuda)
        counter.add_arguments(groups)
        with _cuda.dry_run_launches(counter.kernel, kernels and not cuda), \
                counter:
            out = step()
        return {"memory": counter.memory(out), "costs": counter.costs(),
                "timeline": (counter.names, np.array(counter.timeline))}


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``"fake"`` process group of
    ``world_size`` ranks (collectives return at once, with the shapes of
    their results); destroyed on exit.  Refuses to run beside a live
    process group."""
    if dist.is_initialized():
        raise RuntimeError("a process group is live; the dry run's mesh "
                           "needs a fake one of its own (run it in a "
                           "process of its own)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ====================================================== cell configs =======
def serving_cfg(cfg: ModelConfig) -> ModelConfig:
    """bf16 parameters, as the JAX package serves, and prefill through the
    flash kernel, as the port serves on the card.  (The JAX package's
    exact passes switch to triangle attention and unrolled scans for
    XLA's cost analysis; eager counts what the step runs, exactly.)"""
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               use_flash_kernel=True)


def training_cfg(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    if shape.seq_len >= 32768:
        return dataclasses.replace(cfg, attn_block_q=4096, attn_block_k=4096)
    return cfg


def with_layers(cfg: ModelConfig, k: int) -> ModelConfig:
    """k layer-units: plain layers, or k groups for hybrid."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=k * cfg.attn_every)
    return dataclasses.replace(cfg, n_layers=k)


def layer_units(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def opt_config_for(cfg: ModelConfig) -> optim.OptConfig:
    if cfg.name.startswith("kimi"):
        return optim.OptConfig(kind="adafactor")
    return optim.OptConfig(kind="adamw")


def seq_exact_points(cfg: ModelConfig, shape: ShapeConfig):
    """The reduced-S points where the JAX package extrapolates a cell's
    costs over S (costs are polynomial in S: {1, S} attention-free,
    {1, S, S^2} with any attention), or None: its unrolled SSD chunk
    scans and triangle attention compile too slowly at S = 32k.  Here
    the fit is checked against the full-length count.  The points start
    above the length up to which the port attends densely
    (`models.layers._attend`: S <= attn_block_q or 128), so that all of
    them run the attention the full length runs."""
    if shape.kind == "decode":
        return None
    if cfg.family == "ssm":
        n_basis, need = 2, (3 * shape.seq_len // cfg.ssm_chunk) > 600
    elif cfg.family == "hybrid":
        n_basis = 3
        need = (3 * cfg.attn_every * shape.seq_len // cfg.ssm_chunk) > 600
    else:
        n_basis, need = 3, shape.seq_len > 4096
    if not need:
        return None
    lo = 512
    while cfg.family != "ssm" and lo <= max(cfg.attn_block_q, 128):
        lo *= 2
    return [lo * (2 ** i) for i in range(n_basis)]


def _scale_cfg_for_seq(cfg: ModelConfig, s_val: int,
                       s_target: int) -> ModelConfig:
    """Keep S-dependent config knobs in the same regime at reduced S.

    vlm: the vision prefix is min(vision_tokens, S//4); scale the token
    budget with S so both compile points and target sit on the same side
    of the min() (the basis would otherwise kink).
    """
    if cfg.family != "vlm":
        return cfg
    vt_eff = min(cfg.vision_tokens, s_target // 4)
    vt = max(4, vt_eff * s_val // s_target)
    return dataclasses.replace(cfg, vision_tokens=vt)


# ======================================================== cell inputs ======
def _make_mesh(mesh_shape):
    """The port's (data, model) mesh over the fake group, or None for the
    one-device (1, 1) path the card runs without a process group."""
    if tuple(mesh_shape) == (1, 1):
        return None
    return make_mesh(tuple(mesh_shape), ("data", "model"), device_type="cpu")


def fake_params(cfg: ModelConfig, mesh, rules, device, grad: bool):
    """This rank's slice of every parameter (`Sharding.local_shape`, the
    slice `model_init_params(shardings=, coordinate=)` keeps)."""
    shardings = None if mesh is None else param_shardings(cfg, mesh, rules)
    coord = None if mesh is None else mesh.get_coordinate()

    def make(node, sh):
        if isinstance(node, Leaf):
            shape = node.shape if sh is None else sh.local_shape(node.shape,
                                                                 coord)
            t = torch.empty(shape, dtype=getattr(
                torch, node.dtype or cfg.param_dtype), device=device)
            return t.requires_grad_(True) if grad else t
        return {k: make(node[k], None if sh is None else sh[k])
                for k in sorted(node)}

    return make(model_template(cfg), shardings)


def _batch(cfg: ModelConfig, shape: ShapeConfig, device) -> dict:
    """The global batch of a cell, int32 tokens as the JAX package's
    ``input_specs`` (vlm: a bf16 patch prefix of min(vision_tokens, S/4)
    positions; audio: K codebooks)."""
    B, S = shape.global_batch, shape.seq_len

    def ints(*dims):
        return torch.empty(dims, dtype=torch.int32, device=device)

    train = shape.kind == "train"
    if shape.kind == "decode":
        return {"tokens": ints(B, 1, cfg.n_codebooks)
                if cfg.family == "audio" else ints(B, 1)}
    if cfg.family == "audio":
        t = ints(B, S, cfg.n_codebooks)
        return {"tokens": t, "labels": t} if train else {"tokens": t}
    if cfg.family == "vlm":
        sv = min(cfg.vision_tokens, S // 4)
        out = {"tokens": ints(B, S - sv),
               "vision_embeds": torch.empty((B, sv, cfg.d_model),
                                            dtype=torch.bfloat16,
                                            device=device)}
        if train:
            out["labels"] = ints(B, S - sv)
        return out
    t = ints(B, S)
    return {"tokens": t, "labels": t} if train else {"tokens": t}


def lm_step(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, device):
    """``build`` of one LM cell for `trace`: the step and its arguments."""
    ctx = None if mesh is None else ShardCtx(mesh, rules)

    def build():
        train = shape.kind == "train"
        params = fake_params(cfg, mesh, rules, device, grad=train)
        batch = _batch(cfg, shape, device)
        if train:
            opt_cfg = opt_config_for(cfg)
            psh = None if mesh is None else param_shardings(cfg, mesh, rules)
            opt_state = optim.init(params, opt_cfg, psh)
            ccfg = CompressConfig()
            comp = init_state(params, ccfg)
            run = TrainRunConfig(arch=cfg.name, smoke=False,
                                 global_batch=shape.global_batch,
                                 seq_len=shape.seq_len, device=str(device))
            step_fn = make_train_step(cfg, opt_cfg, run, ccfg, mesh)
            return (lambda: step_fn(params, opt_state, comp, batch, 0),
                    {"params": params, "opt_state": opt_state,
                     "batch": batch})
        if shape.kind == "prefill":
            return (lambda: prefill_step(params, batch, cfg,
                                         max_len=shape.seq_len, ctx=ctx),
                    {"params": params, "batch": batch})
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           torch.bfloat16, device, ctx)
        # decoding the last position of a full cache
        cache = cache._replace(length=shape.seq_len - 1)
        return (lambda: decode_step(params, cache, batch["tokens"], cfg,
                                    ctx=ctx),
                {"params": params, "cache": cache, "batch": batch})

    return build


def genpair_step(scale, pipe, sm_cfg, mesh_shape, device):
    """``build`` of the sharded-index serve step at ``scale`` for `trace`
    (run inside a `fake_world` of the mesh's size): this rank's index
    shard, the packed reference and its kernel padding, the global batch;
    the step as `Mapper.map` runs it on the card (`make_genpair_serve_step`
    on its kernels, then the tail mask)."""
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device_type="cpu")

    def build():
        specs = genpair_input_specs(scale, mesh_shape[1])

        def empty(name, drop_lead=False):
            shape, dtype = specs[name]
            return torch.empty(shape[1:] if drop_lead else shape,
                               dtype=dtype, device=device)

        shard = SeedMapShard(empty("offsets", True), empty("locations", True),
                             mesh.get_local_rank("model"), sm_cfg)
        ref, r1, r2 = empty("ref_words"), empty("reads1"), empty("reads2")
        kref = kernel_reference(
            ref, pipe.read_len + 2 * max(pipe.max_gap, pipe.dp_pad),
            pipe.packed(default=True))
        step = make_genpair_serve_step(mesh, pipe, sm_cfg, "cuda", kref=kref)
        index = (shard.offsets, shard.locations, ref, kref.data)
        return (lambda: _mask_tail(step(shard, ref, r1, r2), r1.shape[0]),
                {"index": index, "batch": (r1, r2)})

    return build


# ====================================================== extrapolation ======
def _combine(a, b, t: float):
    """``a + t * (b - a)`` over nested dicts of numbers (a key missing from
    one side counts 0); strings are taken from whichever side has them."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _combine(a.get(k), b.get(k), t) for k in {**a, **b}}
    if isinstance(a, str) or isinstance(b, str):
        return a if a is not None else b
    a, b = a or 0, b or 0
    return a + t * (b - a)


def combine_layers(costs: dict, k: int, L: int):
    """(totals, coll_kinds) for L layer-units from the k- and 2k-unit
    traces' counts (`trace`'s "costs", or its "memory")."""
    total = _combine(costs[k], costs[2 * k], (L - k) / k)
    return total, total.get("coll_by_kind", {})


def _run(a: np.ndarray, i: int, b: np.ndarray, j: int) -> int:
    """The length of the equal run of ``a`` from ``i`` and ``b`` from
    ``j``."""
    n, step = 0, 64
    top = min(len(a) - i, len(b) - j)
    while n < top:
        m = min(step, top - n)
        neq = np.flatnonzero(a[i + n:i + n + m] != b[j + n:j + n + m])
        if len(neq):
            return n + int(neq[0])
        n, step = n + m, step * 4
    return n


def _align(a: np.ndarray, b: np.ndarray):
    """Index pairs (i, j) of an alignment of the op sequence ``a`` into
    ``b`` (``a`` with runs inserted: the extra layers of each repeated
    region), walking from the start: equal ops pair up, and at a mismatch
    ``b`` skips the run after which the equal run is longest (a shorter
    skip, a period of a loop inside a layer, soon breaks off)."""
    ii, jj = [], []
    i = j = 0
    N, M = len(a), len(b)
    while i < N and j < M:
        run = _run(a, i, b, j)
        ii.append(np.arange(i, i + run))
        jj.append(np.arange(j, j + run))
        i, j = i + run, j + run
        if i >= N or j >= M:
            break
        most = (M - N) - (j - i)            # what is left to skip
        cands = np.flatnonzero(b[j + 1:j + 1 + most] == a[i]) + j + 1
        if not len(cands):
            break
        runs = [_run(a, i, b, int(p)) for p in cands]
        j = int(cands[int(np.argmax(runs))])
    if not ii:
        return np.zeros(0, int), np.zeros(0, int)
    return np.concatenate(ii), np.concatenate(jj)


def _peak_at(line_k, line_2k, t: float) -> int:
    """The peak live bytes of the program of k + t * k layer units, from
    the timelines (`Counter.timeline` and its op names) of its k- and
    2k-unit traces.

    An event (an op) of the deep program sits in a prologue, an epilogue
    or between them, or in one of the layers of a repeated region (the
    forward's layers, the backward's); its live bytes are affine in the
    depth and in its layer's index (the parameters, and the state each
    layer leaves behind, add a layer's worth).  So each event of the
    k-unit trace, paired with the same op of the 2k-unit trace, is
    extrapolated to an event of the deep program: paired with the same
    layer of a region, to that region's first layers; paired with the
    layer k later, to its last.  The pairs come from aligning the two op
    sequences from the start and from the end (`_align`); a region's
    middle layers lie between its first's and its last's.  (Extrapolating
    the peak itself would miss a peak that moves between events as the
    model deepens: the start of a backward, an epilogue's stack.)"""
    (n_k, f_k), (n_2k, f_2k) = line_k, line_2k
    ids = {}
    a = np.array([ids.setdefault(n, len(ids)) for n in n_k])
    b = np.array([ids.setdefault(n, len(ids)) for n in n_2k])
    fi, fj = _align(a, b)
    ri, rj = _align(a[::-1], b[::-1])
    i = np.concatenate([fi, len(a) - 1 - ri])
    j = np.concatenate([fj, len(b) - 1 - rj])
    fa, fb = f_k[i].astype(float), f_2k[j].astype(float)
    return int(round(float((fa + t * (fb - fa)).max())))


def exact_costs_at(make_build, cfg: ModelConfig, k: int, device) -> dict:
    """`trace`s of ``make_build``'s step at k and 2k layer units of
    ``cfg``: {kk: {"memory", "costs", "timeline"}}."""
    return {kk: trace(make_build(with_layers(cfg, kk)), device)
            for kk in (k, 2 * k)}


def trace_depth(make_build, cfg: ModelConfig, device: str = "cuda",
                k: int = K_LAYERS, full_depth: bool = False) -> dict:
    """`trace` of ``make_build(cfg)`` at ``cfg``'s depth: traced whole where
    it has at most 2k layer units (or ``full_depth``), else extrapolated
    from ``make_build`` of k and 2k units (`combine_layers`, memory and
    costs alike).  Adds "traced": the layer units traced."""
    L = layer_units(cfg)
    if full_depth or L <= 2 * k:
        return {**trace(make_build(cfg), device), "traced": [L]}
    runs = exact_costs_at(make_build, cfg, k, device)
    mem = combine_layers({kk: r["memory"] for kk, r in runs.items()}, k,
                         L)[0]
    mem = {key: (int(round(v)) if isinstance(v, float) else v)
           for key, v in mem.items()}
    mem["peak_bytes"] = _peak_at(runs[k]["timeline"],
                                 runs[2 * k]["timeline"], (L - k) / k)
    fresh = mem["output_size_in_bytes"] - mem["alias_size_in_bytes"]
    arg = mem["argument_size_in_bytes"]
    mem["temp_size_in_bytes"] = max(mem["peak_bytes"] - arg - fresh, 0)
    mem["total_nonalias_bytes"] = arg + fresh + mem["temp_size_in_bytes"]
    return {"memory": mem,
            "costs": combine_layers({kk: r["costs"] for kk, r in
                                     runs.items()}, k, L)[0],
            "traced": [k, 2 * k]}


def _seq_extrap(points, values: list, s_target: int):
    """The polynomial through ``values`` at ``points`` (a Vandermonde
    solve), at ``s_target``; with the JAX package's monotone guard (a fit
    below the last point falls back to the line through the last two)."""
    V = np.vander(np.array(points, float), N=len(points), increasing=True)
    basis = np.array([float(s_target) ** i for i in range(len(points))])

    def one(vals):
        if any(isinstance(v, dict) for v in vals):
            keys = set().union(*(v.keys() for v in vals if v))
            return {k: one([(v or {}).get(k, 0.0) for v in vals])
                    for k in keys}
        if any(isinstance(v, str) for v in vals):
            return next(v for v in vals if isinstance(v, str))
        vals = [float(v or 0.0) for v in vals]
        fit = float(np.linalg.solve(V, np.asarray(vals)) @ basis)
        s1, s2 = points[-2], points[-1]
        lin = vals[-1] + (vals[-1] - vals[-2]) / (s2 - s1) * (s_target - s2)
        out = fit if fit >= vals[-1] else float(max(lin, vals[-1]))
        return max(out, 0.0)

    return one(values)


def seq_extrapolated(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                     points, k: int, device) -> dict:
    """The cell's counts at full depth, extrapolated over S from
    ``points`` (each at k and 2k layer units)."""
    per_s = []
    for s_val in points:
        sh = dataclasses.replace(shape, seq_len=s_val)
        c_cfg = _scale_cfg_for_seq(cfg, s_val, shape.seq_len)
        per_s.append(trace_depth(
            lambda c: lm_step(c, sh, mesh, rules, device), c_cfg, device,
            k)["costs"])
    return _seq_extrap(points, per_s, shape.seq_len)


# ============================================================== cells ======
def _mesh_name(mesh_shape, multi_pod: bool) -> str:
    if mesh_shape is None:
        return "multipod_512" if multi_pod else "pod_256"
    return "mesh_" + "x".join(str(n) for n in mesh_shape)


def _roofline_dict(costs: dict, n_chips: int, model_flops: float) -> dict:
    return RF.roofline(costs["flops_by_dtype"], costs["int_ops"],
                       costs["bytes"], costs["coll"], costs["coll_s"],
                       n_chips, model_flops).as_dict()


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             exact: bool = True, out_dir: str | None = None,
             mesh_shape=None, device: str = "cuda") -> dict:
    """One cell's artifact, written under ``out_dir``: rank 0's memory and
    the step's roofline on ``mesh_shape`` ((data, model); default the
    production mesh, (32, 16) with ``multi_pod``).  ``exact``: also check
    the S extrapolation where the JAX package uses it."""
    shape_mesh = tuple(mesh_shape or (MULTIPOD_MESH if multi_pod
                                      else PROD_MESH))
    n_chips = shape_mesh[0] * shape_mesh[1]
    rules = MULTIPOD_RULES if multi_pod else PROD_RULES
    rules = dataclasses.replace(rules, batch_axes=("data",))
    # the JAX package's serving cells of attention / MoE archs keep no
    # sequence split of the residual stream (Megatron-SP); the port
    # never follows that constraint, and records the rules it ran
    if arch != "genpair" and SHAPES[shape_name].kind != "train" \
            and get_config(arch).family not in ("ssm", "hybrid"):
        rules = dataclasses.replace(rules, act_seq_axis=None)
    result = {"arch": arch, "shape": shape_name,
              "mesh": _mesh_name(mesh_shape, multi_pod),
              "mesh_shape": list(shape_mesh), "n_chips": n_chips,
              "device": device, "hardware": RF.HARDWARE,
              "rules": dataclasses.asdict(rules)}
    t0 = time.time()

    if arch == "genpair":
        with fake_world(n_chips):
            run = trace(genpair_step(genpair.SCALE, genpair.PIPELINE,
                                     genpair.SEEDMAP, shape_mesh, device),
                        device)
        # the kernels' data-dependent work has no data here: it is counted
        # at per-row rates measured on other traffic (`DATA_STATISTICS`)
        result["data_statistics"] = DATA_STATISTICS
        result["memory"] = run["memory"]
        result["costs"] = run["costs"]
        result["roofline"] = _roofline_dict(run["costs"], n_chips, 0.0)
        result["collectives"] = {
            "bytes": run["costs"]["coll_by_kind"],
            "counts": run["costs"]["coll_count_by_kind"]}
        result["trace_s"] = {"full": time.time() - t0}
        return _write(result, out_dir)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        result["skipped"] = "long_500k requires sub-quadratic arch"
        return _write(result, out_dir)
    cfg = (training_cfg(cfg, shape) if shape.kind == "train"
           else serving_cfg(cfg))
    L = layer_units(cfg)
    k = K_LAYERS
    world = contextlib.nullcontext() if shape_mesh == (1, 1) \
        else fake_world(n_chips)
    with world:
        mesh = _make_mesh(shape_mesh)
        run = trace_depth(lambda c: lm_step(c, shape, mesh, rules, device),
                          cfg, device, k)
        mem, total = run["memory"], run["costs"]
        result["extrapolation"] = {"k": k, "layer_units": L,
                                   "traced": run["traced"]}
        t_a = time.time() - t0
        s_pts = seq_exact_points(cfg, shape) if exact else None
        if s_pts is not None:
            fit = seq_extrapolated(cfg, shape, mesh, rules, s_pts, k, device)
            result["extrapolation"]["seq_points"] = s_pts
            result["extrapolation"]["seq_fit"] = {
                m: fit[m] for m in ("flops", "bytes", "coll")}
            result["extrapolation"]["seq_fit_rel_err"] = {
                m: (fit[m] - total[m]) / total[m] if total[m] else 0.0
                for m in ("flops", "bytes", "coll")}
    result["memory"] = mem
    result["costs"] = total
    result["roofline"] = _roofline_dict(total, n_chips,
                                        RF.model_flops_for(cfg, shape))
    result["collectives"] = {"bytes": total["coll_by_kind"],
                             "counts": total["coll_count_by_kind"]}
    result["trace_s"] = {"full_shape": t_a, "seq_points": time.time() - t0
                         - t_a}
    return _write(result, out_dir)


def _write(result: dict, out_dir: str | None) -> dict:
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}"
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    rl = result.get("roofline", {})
    mem = result.get("memory", {}).get("total_nonalias_bytes", 0)
    print(f"[dryrun] {name}: bottleneck={rl.get('bottleneck', '-')} "
          f"compute={rl.get('compute_s', 0):.4g}s "
          f"memory={rl.get('memory_s', 0):.4g}s "
          f"coll={rl.get('collective_s', 0):.4g}s "
          f"mem_total={mem / 2**30:.2f}GiB"
          + (f" skipped: {result['skipped']}" if "skipped" in result
             else ""), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch name or 'genpair'")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh: pod x data as one data "
                         "axis of 32")
    ap.add_argument("--mesh", default=None,
                    help="a (data, model) mesh as DxM, e.g. 1x4")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", action="append", default=[],
                    help="ARCH:SHAPE[:DxM], repeatable (one process for "
                         "several cells on their own meshes)")
    ap.add_argument("--no-exact", action="store_true",
                    help="skip the S-extrapolation check")
    ap.add_argument("--device", default="cuda",
                    help="where the fakes live: cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose artifact JSON already exists")
    ap.add_argument("--budget-s", type=float, default=0,
                    help="stop starting new cells after this many seconds")
    args = ap.parse_args(argv)

    def parse_mesh(text):
        return tuple(int(n) for n in text.split("x")) if text else None

    mesh = parse_mesh(args.mesh)
    if args.all:
        cells = [(a, s, mesh) for a in ARCH_NAMES for s in ALL_SHAPE_NAMES]
        cells.append(("genpair", "serve_256k", mesh))
    elif args.cell:
        cells = [(c.split(":") + [None])[:3] for c in args.cell]
        cells = [(a, s, parse_mesh(m)) for a, s, m in cells]
    else:
        cells = [(args.arch, args.shape, mesh)]
    out_dir = args.out or ARTIFACT_DIR
    t_start = time.time()
    remaining = failed = 0
    for arch, shape, mesh_shape in cells:
        name = f"{arch}__{shape}__{_mesh_name(mesh_shape, args.multi_pod)}"
        if args.skip_existing and os.path.exists(
                os.path.join(out_dir, name + ".json")):
            continue
        if args.budget_s and time.time() - t_start > args.budget_s:
            remaining += 1
            continue
        try:
            run_cell(arch, shape, args.multi_pod, exact=not args.no_exact,
                     out_dir=args.out, mesh_shape=mesh_shape,
                     device=args.device)
        except Exception as e:  # noqa: BLE001 — report and continue
            failed += 1
            print(f"[dryrun] FAILED {arch} {shape}: {type(e).__name__}: {e}",
                  flush=True)
            if not args.all:
                raise
    if remaining:
        print(f"[dryrun] budget exhausted; {remaining} cells remaining "
              f"(re-run with --skip-existing to resume)", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
