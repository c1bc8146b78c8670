"""GenPairX paired-end read mapping in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The package mirrors `repro`'s layout (`core/`, `kernels/<family>/`,
`engine/`) so each module has an obvious counterpart, but it imports
neither JAX nor `repro`: the JAX package is only the reference the tests
hold this one against.  Entry point::

    from repro_torch.engine import ExecutionConfig, Mapper
    mapper = Mapper.build(ref, seedmap_cfg, pipe_cfg, ExecutionConfig())
    res = mapper.map(reads1, reads2)          # read pairs
    long_res = mapper.map_long(long_reads)    # long reads (§4.7)

Sessions run on the GPU (``ExecutionConfig.device="cuda"``) unless the
caller asks for the CPU, where every kernel is replaced by its plain
PyTorch version.  ``ExecutionConfig(mesh=...)`` runs a session on a
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
