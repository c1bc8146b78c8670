"""ExecutionConfig + the once-per-session resolution of the pipeline knobs.

`resolved_pipeline` returns a `PipelineConfig` with a concrete
``packed_ref`` bool and the session's concrete kernel backend (``"cuda"``
or ``"torch"``), and `resolved_long_read` the long-read lane's config, so
nothing on the per-batch path resolves anything again.
"""
from __future__ import annotations

import dataclasses

import torch

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
                  `map_long_stream`); None: `LongReadConfig()`.
    """

    device: str = "cuda"
    backend: str = "auto"
    packed_ref: bool | None = None
    stream_batch: int | None = None
    long_read: LongReadConfig | None = None

    def torch_device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExecutionConfig(device='cuda') but torch.cuda.is_available()"
                " is False; pass device='cpu' to run on the CPU")
        return dev


def resolved_pipeline(pipe_cfg: PipelineConfig, exec_cfg: ExecutionConfig
                      ) -> tuple[PipelineConfig, str]:
    """Resolve every deferred knob for the session: the pipeline config
    with a concrete ``packed_ref``, and the backend of every step."""
    dev = exec_cfg.torch_device()
    packed = exec_cfg.packed_ref
    if packed is None:
        packed = pipe_cfg.packed(default=False)
    return (dataclasses.replace(pipe_cfg, packed_ref=bool(packed)),
            resolve_backend(exec_cfg.backend, dev))


def resolved_long_read(pipe_cfg: PipelineConfig, exec_cfg: ExecutionConfig
                       ) -> LongReadConfig:
    """The session's long-read lane config, resolved once at build.

    Two knobs of the lane's ``pipe`` are forced to the session's resolved
    values because they are tied to state built once: ``max_locs_per_seed``
    (the padded SeedMap row width) and ``packed_ref`` (the reference
    flavor).  Every other lane knob keeps the lane config's own value.
    ``pipe_cfg`` must already be resolved.
    """
    lr = exec_cfg.long_read or LongReadConfig()
    return dataclasses.replace(lr, pipe=dataclasses.replace(
        lr.pipe, max_locs_per_seed=pipe_cfg.max_locs_per_seed,
        packed_ref=pipe_cfg.packed_ref))
