"""The paper's own workload as a selectable config (``--arch genpair``).

Unlike the LM archs this is a genomics *serving* workload: the "model" is
the SeedMap index + the GenPair pipeline; the "shape" is read pairs per
step.  Scales:

  serve_256k  — 262,144 pairs/step at human-genome scale (GRCh38-sized
                index: 2^30 buckets, ~3e9 locations).  The dry-run cell.
  smoke       — CPU-testable miniature of the same topology.

The GenPairScale / PipelineConfig pair plays the role ModelConfig plays
for the LM archs; `repro_torch.launch.dryrun` runs
`make_genpair_serve_step` on fake shards of these shapes.
"""
from __future__ import annotations

from repro_torch.core.genpairx_step import GenPairScale
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import SeedMapConfig

# dry-run scale (the paper's deployment: GRCh38 + 100M-pair datasets)
SCALE = GenPairScale(
    genome_len=3_000_000_000,
    table_bits=30,
    n_locations=3_000_000_000,
    global_batch=262_144,
    read_len=150,
)

# The dry run's pipeline: the 2-bit packed reference (0.75 GB a rank at
# GRCh38 scale against 3 GB unpacked; the window kernels read 4x fewer
# bytes a window).  `packed_ref` is the tri-state PipelineConfig knob
# (None = the entry point's default).
PIPELINE = PipelineConfig(packed_ref=True)
SEEDMAP = SeedMapConfig(table_bits=SCALE.table_bits)

# CPU-testable miniature (same topology, ~1e5 reference)
SMOKE_SCALE = GenPairScale(
    genome_len=100_000,
    table_bits=16,
    n_locations=100_000,
    global_batch=64,
    read_len=150,
)
SMOKE_SEEDMAP = SeedMapConfig(table_bits=SMOKE_SCALE.table_bits)

SHAPE_NAMES = ("serve_256k",)
