"""GenPairX paired-end read mapping in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a), and the serving and training paths
of the LM substrate that repro carries beside it.

The package mirrors `repro`'s layout (`core/`, `kernels/<family>/`,
`engine/`, `configs/`, `models/`) so each module has an obvious counterpart, but it imports
neither JAX nor `repro`: the JAX package is only the reference the tests
hold this one against.  Entry point::

    from repro_torch.engine import ExecutionConfig, Mapper
    mapper = Mapper.build(ref, seedmap_cfg, pipe_cfg, ExecutionConfig())
    res = mapper.map(reads1, reads2)          # read pairs
    long_res = mapper.map_long(long_reads)    # long reads (§4.7)

Sessions are served through `engine.FrontDoor` (continuous batching of
ragged requests of both lanes), persisted with ``mapper.save`` /
``Mapper.load`` / ``mapper.swap_index`` (`engine.index_store`, the JAX
package's on-disk format), and driven by ``python -m
repro_torch.launch.serve`` (``--chaos``: a fault schedule served through
the fleet stream, `engine.multihost.map_stream`); `core.baseline.
map_single_end` is the paper's full-DP single-end comparison point.
`repro_torch.tune` times the kernels' launch geometry and the pipeline's
knobs, and a session reads its cache once at build
(``ExecutionConfig(tune=...)``).

The package also serves every family of repro's LM substrate (dense,
moe, ssm, hybrid, vlm, audio) with prefill attention through the
hand-written flash attention kernel::

    from repro_torch.models.model import prefill_step, decode_step
    logits, cache = prefill_step(params, {"tokens": tokens}, cfg, max_len)
    logits, cache = decode_step(params, cache, next_tokens, cfg)

and trains it on one device or over a (data, model) mesh of ranks
(``python -m repro_torch.launch.train``, under ``torchrun`` for a mesh:
`models.model.loss_fn`, `optim`, `checkpoint.Checkpointer`, the
sharding rules of `sharding.partition` with the collectives of
`sharding.collectives`, and `runtime.elastic`).

Its parameters, caches, batches and trainer are made on the GPU
(``device="cuda"``) unless the caller asks for the CPU.  Mapper sessions
run on the GPU (``ExecutionConfig.device="cuda"``) unless the caller
asks for the CPU, where every kernel is replaced by its plain PyTorch
version.  ``ExecutionConfig(mesh=...)`` runs a session on a
`torch.distributed` mesh (`repro_torch.launch.mesh.make_mesh`), with the
SeedMap sharded over its ``model`` axis when ``shard_index=True``.
"""

from repro_torch.engine import (  # noqa: E402
    ExecutionConfig,
    LongReadConfig,
    LongReadResult,
    Mapper,
    StreamResult,
)

__all__ = ["ExecutionConfig", "LongReadConfig", "LongReadResult", "Mapper",
           "StreamResult"]
