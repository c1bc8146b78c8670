"""ExecutionConfig + the once-per-session resolution of the pipeline knobs.

`resolved_pipeline` returns a `PipelineConfig` with a concrete
``packed_ref`` bool and the session's concrete kernel backend (``"cuda"``
or ``"torch"``), and `resolved_long_read` the long-read lane's config, so
nothing on the per-batch path resolves anything again.

With ``mesh`` set the session runs one of the two mesh plans: the
replicated-index data-parallel plan, or with ``shard_index=True`` the
bucket-sharded SeedMap of the genome-scale serve step.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.long_read import LongReadConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.kernels.backend import resolve_backend


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How a `Mapper` session executes.

    device:       where the index, the reference and every step live.
                  ``"cuda"`` (default) raises when no GPU is available;
                  pass ``"cpu"`` to run the plain PyTorch versions.
    backend:      "auto" (the CUDA kernels on a CUDA device, their plain
                  PyTorch versions on the CPU), "cuda" or "torch" (the
                  plain versions wherever the session lives).
    packed_ref:   overrides `PipelineConfig.packed_ref` (None: the
                  config's tri-state, default unpacked).
    stream_batch: fixed batch shape for `map_stream` / `map_long_stream`
                  (None: the first batch's row count); ragged tails are
                  padded and masked.
    long_read:    the session's long-read lane (`Mapper.map_long` /
                  `map_long_stream`); None: `LongReadConfig()`.  Refused
                  on a ``shard_index`` plan, which has no lane.
    mesh:         a `torch.distributed` DeviceMesh
                  (`repro_torch.launch.mesh.make_mesh`) to run on (None:
                  one device).  Every rank calls `map` / `map_stream`
                  with the same global batch, maps its rows of the
                  ``batch_axes`` axis and returns the all_gathered global
                  result.  The session's device is the rank's own: the
                  current CUDA device on a ``"cuda"`` mesh, the CPU on a
                  ``"cpu"`` (gloo) one; ``device`` must name that type.
    batch_axes:   the mesh axis the batch splits over (one axis).
    model_axis:   the mesh axis the SeedMap shards over (``shard_index``).
    shard_index:  shard the SeedMap by bucket range along ``model_axis``
                  (the NMSL channel-striping serve plan,
                  `core.genpairx_step`); False replicates the index and
                  runs data-parallel.  Requires ``mesh``; the reference
                  is packed by default on this plan.
    tune:         read the tuner's cache (`repro_torch.tune`) once, at
                  build: a path names the cache file, True is its default
                  path, None (default) and False never tune.  Cached
                  winners fill only the knobs the configs left unset:
                  explicit config > tune cache > defaults.  No
                  environment variable is read.
    """

    device: str = "cuda"
    backend: str = "auto"
    packed_ref: bool | None = None
    stream_batch: int | None = None
    long_read: LongReadConfig | None = None
    mesh: DeviceMesh | None = None
    batch_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    shard_index: bool = False
    tune: bool | str | None = None

    def __post_init__(self):
        if self.shard_index and self.mesh is None:
            raise ValueError("shard_index=True requires a mesh")
        if self.shard_index and self.long_read is not None:
            raise ValueError(
                "the long-read lane is not available on shard_index plans")
        if self.mesh is None:
            return
        names = self.mesh.mesh_dim_names or ()
        if len(self.batch_axes) != 1:
            raise ValueError(f"the batch splits over one mesh axis, got "
                             f"batch_axes={self.batch_axes}")
        needed = self.batch_axes + ((self.model_axis,) if self.shard_index
                                    else ())
        missing = [a for a in needed if a not in names]
        if missing:
            raise ValueError(f"mesh axes {names} lack {missing}")

    def torch_device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExecutionConfig(device='cuda') but torch.cuda.is_available()"
                " is False; pass device='cpu' to run on the CPU")
        if self.mesh is None:
            return dev
        if dev.type != self.mesh.device_type:
            raise ValueError(f"device={self.device!r} but the mesh is a "
                             f"{self.mesh.device_type!r} mesh")
        if dev.type == "cuda":
            own = torch.cuda.current_device()
            if dev.index not in (None, own):
                raise ValueError(f"device={self.device!r} but this rank's "
                                 f"mesh device is cuda:{own}")
            dev = torch.device("cuda", own)
        return dev


def _tune_batch(exec_cfg: ExecutionConfig) -> int:
    """The batch a session's tune-cache buckets are looked up at."""
    return exec_cfg.stream_batch or 1024


def resolved_pipeline(pipe_cfg: PipelineConfig, exec_cfg: ExecutionConfig,
                      tune_cache: dict | None = None
                      ) -> tuple[PipelineConfig, str]:
    """Resolve every deferred knob for the session: the pipeline config
    with a concrete ``packed_ref`` (default: packed on the sharded-index
    plan, unpacked otherwise), and the backend of every step.
    ``tune_cache`` (entries of `repro_torch.tune`) fills the knobs the
    config left unset first, so explicit settings win over cached
    winners."""
    dev = exec_cfg.torch_device()
    backend = resolve_backend(exec_cfg.backend, dev)
    if tune_cache:
        from repro_torch.tune import apply_tuned_pipeline
        pipe_cfg = apply_tuned_pipeline(pipe_cfg, tune_cache,
                                        _tune_batch(exec_cfg), backend,
                                        exec_packed=exec_cfg.packed_ref)
    packed = exec_cfg.packed_ref
    if packed is None:
        packed = pipe_cfg.packed(default=exec_cfg.shard_index)
    return dataclasses.replace(pipe_cfg, packed_ref=bool(packed)), backend


def resolved_long_read(pipe_cfg: PipelineConfig, exec_cfg: ExecutionConfig,
                       tune_cache: dict | None = None) -> LongReadConfig:
    """The session's long-read lane config, resolved once at build.

    Two knobs of the lane's ``pipe`` are forced to the session's resolved
    values because they are tied to state built once: ``max_locs_per_seed``
    (the padded SeedMap row width) and ``packed_ref`` (the reference
    flavor).  ``tune_cache`` fills the lane's unset knobs (``vote_block``,
    and the ``pipe``'s as `resolved_pipeline` does); every other lane knob
    keeps the lane config's own value.  ``pipe_cfg`` must already be
    resolved.
    """
    lr = exec_cfg.long_read or LongReadConfig()
    lane_pipe = dataclasses.replace(
        lr.pipe, max_locs_per_seed=pipe_cfg.max_locs_per_seed,
        packed_ref=pipe_cfg.packed_ref)
    if tune_cache:
        from repro_torch.tune import apply_tuned_long_read
        backend = resolve_backend(exec_cfg.backend, exec_cfg.torch_device())
        lr = apply_tuned_long_read(lr, tune_cache, _tune_batch(exec_cfg),
                                   backend)
        lane_pipe, _ = resolved_pipeline(lane_pipe, exec_cfg, tune_cache)
    return dataclasses.replace(lr, pipe=lane_pipe)
