"""GenPairX sharded-index serve step: the paper's workload on a device mesh.

The front door is the engine: a `repro_torch.engine.Mapper` built with
``ExecutionConfig(mesh=..., shard_index=True)`` shards the SeedMap, keeps
this rank's shard and the (by default 2-bit packed) reference on its
device, and calls the step built here on every global batch.

The step (the genome-scale ``--arch genpair`` step): seed bucket ids
(the `seed_buckets` kernel; on the CPU its plain version), the
bucket-sharded SeedMap lookup plus one ``all_reduce(MIN)`` over the
``model`` group (`core.distributed`), the fused merge + Δ filter of the
front end on the gathered locations (the `merge_filter` kernel), then
Light Alignment and the residual DP fallback exactly as `map_pairs_impl`
runs them (`core.pipeline.map_batch`).  Like repro's step it maps the
global batch: each rank runs steps 1-4 on its rows of the ``data`` axis,
and the residual DP buffer is the global batch's.

At human-genome scale (GRCh38, `GenPairScale`): T = 2^30 buckets, ~3.0e9
locations, a 2-bit packed reference of 0.75 GB on every rank, and a
Location Table of 12 GB split over the model ranks.
`genpair_input_specs` gives the shapes of one such step's inputs, from
which `repro_torch.launch.dryrun` makes fake tensors.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.distributed import (
    RowSplit,
    SeedMapShard,
    make_sharded_locs,
)
from repro_torch.core.pipeline import MapResult, PipelineConfig, map_batch
from repro_torch.core.seeding import seed_offsets_tuple
from repro_torch.core.seedmap import SeedMapConfig
from repro_torch.kernels._util import KernelRef
from repro_torch.kernels.pair_frontend.ops import (
    frontend_merge_filter,
    seed_buckets,
)
from repro_torch.kernels.pair_frontend.ref import seed_buckets_ref


@dataclasses.dataclass(frozen=True)
class GenPairScale:
    """Genome-scale dimensioning of the serve step for the dry run."""

    genome_len: int = 3_000_000_000
    table_bits: int = 30
    n_locations: int = 3_000_000_000
    global_batch: int = 262_144     # read pairs per step
    read_len: int = 150


def genpair_input_specs(scale: GenPairScale, n_model_shards: int) -> dict:
    """``{name: (shape, dtype)}`` of the serve step's inputs at ``scale``
    with the index split over ``n_model_shards`` ranks: every shard's
    CSR offsets and padded locations (one row a shard), the packed
    reference words (int32 holding the 2-bit packing's bits, as the
    port's sessions hold them) and both mates of the global batch."""
    T = 1 << scale.table_bits
    per = T // n_model_shards
    nmax = scale.n_locations // n_model_shards
    lw = scale.genome_len // 16 + 1
    B, R = scale.global_batch, scale.read_len
    return {
        "offsets": ((n_model_shards, per + 1), torch.int32),
        "locations": ((n_model_shards, nmax), torch.int32),
        "ref_words": ((lw,), torch.int32),
        "reads1": ((B, R), torch.uint8),
        "reads2": ((B, R), torch.uint8),
    }


def make_genpair_serve_step(mesh, pipe_cfg: PipelineConfig,
                            sm_cfg: SeedMapConfig, backend: str,
                            batch_axes: tuple[str, ...] = ("data",),
                            model_axis: str = "model",
                            kref: KernelRef | None = None):
    """Returns ``serve_step(shard, ref, reads1, reads2) -> MapResult`` of
    the global batch, which every rank is handed.

    ``shard`` is this rank's `SeedMapShard` (its model coordinate's bucket
    range), ``ref`` the session reference: the packed words, or with
    ``pipe_cfg.packed_ref=False`` the bases unpacked from them (the final
    word's pad bases included, as repro's unpacked debug flavor of this
    step has them).  ``pipe_cfg`` is resolved and ``backend`` is "cuda" or
    "torch"; ``kref`` is ``ref`` padded for the window kernels.
    """
    cfg = pipe_cfg
    K = cfg.max_locs_per_seed
    offs = seed_offsets_tuple(cfg.read_len, cfg.seed_len, cfg.seeds_per_read)
    locs_fn = make_sharded_locs(mesh, model_axis)
    model_rank = mesh.get_local_rank(model_axis)
    split = RowSplit.from_mesh(mesh, batch_axes[0])

    def front(shard, r1, r2_fwd):
        if backend == "cuda":
            buckets = seed_buckets(r1, r2_fwd, cfg.seed_len,
                                   cfg.seeds_per_read, sm_cfg.hash_seed,
                                   sm_cfg.table_size)
        else:
            buckets = seed_buckets_ref(torch.cat([r1, r2_fwd]), cfg.seed_len,
                                       cfg.seeds_per_read, sm_cfg.hash_seed,
                                       sm_cfg.table_size)
        locs = locs_fn(shard, buckets, K)        # (2B, S, K), mate 1 first
        B = r1.shape[0]
        fe = frontend_merge_filter(locs[:B], locs[B:], offs, cfg.delta,
                                   cfg.max_candidates,
                                   block=cfg.frontend_block, backend=backend)
        return (fe.n_hits1 > 0) & (fe.n_hits2 > 0), fe

    def serve_step(shard: SeedMapShard, ref: torch.Tensor,
                   reads1: torch.Tensor, reads2: torch.Tensor) -> MapResult:
        if shard.shard_id != model_rank:
            raise ValueError(f"rank {model_rank} of the {model_axis!r} axis "
                             f"holds shard {shard.shard_id}")
        return map_batch(functools.partial(front, shard), ref, reads1,
                         reads2, cfg, backend, kref, split)

    return serve_step
