"""The bucket-sharded SeedMap (the paper's NMSL channel striping, §5.2) and
the collectives of the mesh plans.

The paper's NMSL stripes the Seed/Location tables across memory channels.
On a device mesh the channels are the devices along the ``model`` axis:
both tables are split by bucket range, each rank keeps only its own shard
on its device and answers for the buckets it owns (INVALID_LOC for the
rest), and one ``all_reduce(MIN)`` over the model group picks the owner's
answer (INVALID_LOC is int32-max).  Batches split over the ``data`` axis
(`RowSplit`): every rank is handed the same global batch, maps its rows
and all_gathers what it computed, so every rank returns the global
result.  The caller initialises the process group
(`repro_torch.launch.mesh.make_mesh`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.seedmap import INVALID_LOC, SeedMap, SeedMapConfig


class SeedMapShard(NamedTuple):
    """One rank's bucket range of a `ShardedSeedMap`.

    offsets:   int32[T/D + 1]  local CSR offsets (rebased to 0)
    locations: int32[Nmax]     local locations (INVALID_LOC padded)
    shard_id:  which of the D bucket ranges this is
    """

    offsets: torch.Tensor
    locations: torch.Tensor
    shard_id: int
    config: SeedMapConfig


class ShardedSeedMap(NamedTuple):
    """SeedMap sharded by bucket range along the ``model`` axis.

    offsets:   int32[D, T/D + 1]  per-shard CSR offsets (local, rebased)
    locations: int32[D, Nmax]     per-shard locations (INVALID_LOC padded)
    config:    SeedMapConfig
    """

    offsets: torch.Tensor
    locations: torch.Tensor
    config: SeedMapConfig

    @property
    def n_shards(self) -> int:
        return self.offsets.shape[0]

    def shard(self, d: int, device=None) -> SeedMapShard:
        """Shard ``d`` as its own contiguous tensors on ``device``."""
        return SeedMapShard(
            offsets=self.offsets[d].to(device).contiguous(),
            locations=self.locations[d].to(device).contiguous(),
            shard_id=d, config=self.config)


def shard_seedmap(sm: SeedMap, n_shards: int) -> ShardedSeedMap:
    """Split a CSR SeedMap into ``n_shards`` bucket-range shards, on the
    host (CPU tensors, whatever device ``sm`` lives on)."""
    T = sm.config.table_size
    if T % n_shards:
        raise ValueError("table_size must divide by shard count")
    per = T // n_shards
    offsets = sm.offsets.cpu().numpy()
    locations = sm.locations.cpu().numpy()
    shard_off = []
    shard_loc = []
    for d in range(n_shards):
        o = offsets[d * per: (d + 1) * per + 1].astype(np.int64)
        shard_off.append((o - o[0]).astype(np.int32))
        shard_loc.append(locations[o[0]: o[-1]])
    nmax = max(max(len(l) for l in shard_loc), 1)
    loc = np.full((n_shards, nmax), INVALID_LOC, np.int32)
    for d, l in enumerate(shard_loc):
        loc[d, : len(l)] = l
    return ShardedSeedMap(offsets=torch.from_numpy(np.stack(shard_off)),
                          locations=torch.from_numpy(loc), config=sm.config)


def _local_query(offsets: torch.Tensor, locations: torch.Tensor,
                 shard_id: int, hashes: torch.Tensor, cfg: SeedMapConfig,
                 K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-rank bucket-range query: INVALID for buckets we don't own.

    ``hashes`` (...,) are seed hashes or bucket ids (only ``hash & (T-1)``
    is read) -> locations (..., K) int32 and counts (...,) int32.
    """
    T = cfg.table_size
    per = offsets.shape[-1] - 1
    bucket = hashes.to(torch.int64) & (T - 1)
    local_b = bucket - shard_id * per
    owned = (local_b >= 0) & (local_b < per)
    lb = local_b.clamp(0, per - 1)
    start = offsets[lb].to(torch.int64)
    end = offsets[lb + 1].to(torch.int64)
    count = torch.where(owned, (end - start).clamp(max=K), 0)
    ar = torch.arange(K, device=offsets.device)
    idx = start[..., None] + ar
    valid = ar < count[..., None]
    locs = locations[idx.clamp(0, locations.shape[0] - 1)]
    locs = torch.where(valid, locs, INVALID_LOC)
    return locs, count.to(torch.int32)


def make_sharded_locs(mesh, model_axis: str = "model"):
    """The bucket-sharded SeedMap lookup over ``mesh``'s model group.

    Returns ``locs_fn(shard, hashes (...,), K) -> (..., K) int32``
    locations (INVALID_LOC padded): this rank's `_local_query` on its own
    shard, then an in-place ``all_reduce(MIN)`` over the model group, which
    runs however many ranks the group has.
    """
    group = mesh.get_group(model_axis)

    def locs_fn(shard: SeedMapShard, hashes: torch.Tensor,
                K: int) -> torch.Tensor:
        locs, _ = _local_query(shard.offsets, shard.locations, shard.shard_id,
                               hashes, shard.config, K)
        dist.all_reduce(locs, op=dist.ReduceOp.MIN, group=group)
        return locs

    return locs_fn


class RowSplit(NamedTuple):
    """How a global batch splits over one mesh axis: this rank's
    coordinate on it, the axis size and its process group."""

    rank: int
    size: int
    group: object

    @classmethod
    def from_mesh(cls, mesh, axis: str) -> "RowSplit":
        return cls(rank=mesh.get_local_rank(axis),
                   size=mesh.shape[mesh.mesh_dim_names.index(axis)],
                   group=mesh.get_group(axis))

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch."""
        B = x.shape[0]
        if B % self.size:
            raise ValueError(f"a batch of {B} rows does not divide over the "
                             f"mesh's {self.size} data ranks")
        n = B // self.size
        return x[self.rank * n:(self.rank + 1) * n]

    def gather(self, tensors) -> list[torch.Tensor]:
        """all_gather (B_local, ...) int32 or bool tensors into
        (B_local * size, ...) ones, in the group's rank order: one
        collective, every tensor packed into one (B_local, W) int32
        tensor."""
        cols = []
        for t in tensors:
            if t.dtype not in (torch.int32, torch.bool):
                raise TypeError(f"RowSplit.gather packs int32 and bool "
                                f"tensors, got {t.dtype}")
            cols.append(t.reshape(t.shape[0], -1).to(torch.int32))
        packed = torch.cat(cols, 1).contiguous()
        parts = [torch.empty_like(packed) for _ in range(self.size)]
        dist.all_gather(parts, packed, group=self.group)
        full = torch.cat(parts)
        out, c = [], 0
        for t, col in zip(tensors, cols):
            w = col.shape[1]
            out.append(full[:, c:c + w].reshape((-1,) + tuple(t.shape[1:]))
                       .to(t.dtype).contiguous())
            c += w
        return out
