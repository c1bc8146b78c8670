"""Roofline terms of one step from counts of its work, at the H100's peaks.

Terms (one device, NVIDIA H100 SXM 80GB):
  compute    = sum over op types of ops / that type's peak
               (989 TFLOP/s bf16 and fp16, 495 TFLOP/s TF32, 67 TFLOP/s
               float32 outside the tensor cores, 16.7 Tops/s int32)
  memory     = HBM bytes / 3.35 TB/s
  collective = sum over collectives of operand bytes / the link rate of
               the group's ranks (450 GB/s NVLink a direction within one
               8-GPU node, 50 GB/s of 400 Gb/s InfiniBand a GPU across
               nodes)

The counts come from `repro_torch.launch.dryrun`, which runs a step on
fake tensors: FLOPs by dtype from `torch.utils.flop_counter`'s formulas,
HBM bytes as each aten op's inputs and outputs once (eager's traffic),
each hand-written kernel's bytes and operations from its cost function
(`kernels/*/ops.py`), and each collective's operand bytes where it is
issued.  The JAX package parses optimized HLO for the collectives and
reads XLA's cost analysis for the rest; its `Roofline` has the same
fields, so one report reads the artifacts of either package.
"""
from __future__ import annotations

import dataclasses

# ----------------------------------------------------------------- HW ------
# H100 SXM5 80GB data sheet: dense tensor-core bf16 / fp16 989.4 TFLOP/s,
# TF32 494.7, float32 outside the tensor cores 66.9; HBM3 3.35 TB/s;
# NVLink 4 900 GB/s a GPU over both directions.  int32: 132 SMs x 64 INT32
# lanes x 1.98 GHz boost (Hopper architecture white paper).
PEAK_FLOPS = 989e12        # bf16 FLOP/s per device (the headline peak)
PEAKS = {                  # ops/s per device, by the type the ops run in
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
    "int32": 132 * 64 * 1.98e9,
}
HBM_BW = 3.35e12           # bytes/s per device
NVLINK_BW = 450e9          # bytes/s a direction, ranks within one node
IB_BW = 50e9               # bytes/s a GPU (400 Gb/s), ranks across nodes
GPUS_PER_NODE = 8          # an HGX H100 node

HARDWARE = ("NVIDIA H100 SXM 80GB: 989 TFLOP/s bf16, 495 TF32, 67 float32, "
            "16.7 Tops/s int32, 3.35 TB/s HBM3, 450 GB/s NVLink within a "
            "node of 8, 50 GB/s InfiniBand across nodes")


def link_bw(ranks) -> float:
    """The link rate of a group of global ``ranks``: NVLink where they sit
    in one node of `GPUS_PER_NODE` (ranks numbered node by node), else
    InfiniBand."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else IB_BW


def bound_s(n_bytes: float, n_ops: float, unit: str) -> tuple[float, str]:
    """Least time in seconds for ``n_bytes`` of HBM traffic and ``n_ops``
    operations of ``unit`` (a `PEAKS` key), and which of the two bounds
    it: "bytes" or "operations"."""
    t_b = n_bytes / HBM_BW
    t_o = n_ops / PEAKS[unit]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


@dataclasses.dataclass
class Roofline:
    flops: float              # per device
    hbm_bytes: float          # per device
    coll_bytes: float         # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float        # 6*N*D (analytic, global)
    useful_ratio: float       # model_flops / (flops * n_chips)
    n_chips: int

    @property
    def time_s(self) -> float:
        """The roofline time: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline(flops_by_dtype: dict, int_ops: float, hbm_bytes: float,
             coll_bytes: float, collective_s: float, n_chips: int,
             model_flops: float) -> Roofline:
    """The `Roofline` of one device's counts: ``flops_by_dtype`` ({`PEAKS`
    key: FLOPs}, "tf32" for float32 matmuls run with TF32 on) each at its
    peak, ``int_ops`` at the int32 peak, ``hbm_bytes`` at HBM's rate, and
    ``collective_s`` the collectives' time (operand bytes over each
    group's link, `link_bw`)."""
    flops = float(sum(flops_by_dtype.values()))
    c = sum(f / PEAKS[d] for d, f in flops_by_dtype.items()) \
        + int_ops / PEAKS["int32"]
    m = hbm_bytes / HBM_BW
    terms = {"compute": c, "memory": m, "collective": collective_s}
    total = flops * n_chips
    return Roofline(
        flops=flops, hbm_bytes=float(hbm_bytes), coll_bytes=float(coll_bytes),
        compute_s=c, memory_s=m, collective_s=float(collective_s),
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        useful_ratio=(model_flops / total) if total else 0.0,
        n_chips=n_chips)


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE).

    train: 6*N*D per step; prefill: 2*N*D forward-only; decode: 2*N*D with
    D = global_batch tokens (one token per sequence).
    """
    n = cfg.n_active_params() if cfg.family == "moe" else cfg.n_params()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
