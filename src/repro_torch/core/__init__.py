"""The GenPair pipeline math in PyTorch (steps 1-5 of the paper).

Public API re-exports, under the JAX package's names (its deprecated
one-shot `map_pairs` has no counterpart: sessions go through
`repro_torch.engine.Mapper`).
"""
from repro_torch.core.encoding import (
    encode_str,
    pack_2bit,
    revcomp,
    unpack_2bit,
)
from repro_torch.core.hashing import xxhash32_words
from repro_torch.core.light_align import LightAlignResult, light_align
from repro_torch.core.pair_filter import CandidateSet, paired_adjacency_filter
from repro_torch.core.pipeline import (
    MapResult,
    PipelineConfig,
    map_pairs_impl,
    stage_stat_counts,
    stage_stats,
)
from repro_torch.core.query import QueryResult, query_csr, query_read_batch
from repro_torch.core.scoring import Scoring
from repro_torch.core.seeding import SeedSet, hash_seeds, seed_read_batch
from repro_torch.core.seedmap import (
    INVALID_LOC,
    PaddedSeedMap,
    SeedMap,
    SeedMapConfig,
    build_seedmap,
    seedmap_stats,
    to_padded,
)
from repro_torch.core.long_read import (
    LongReadConfig,
    LongReadResult,
    map_long_reads,
)
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_long_reads,
    simulate_pairs,
)

__all__ = [
    "encode_str", "pack_2bit", "revcomp", "unpack_2bit", "xxhash32_words",
    "LightAlignResult", "light_align", "CandidateSet",
    "paired_adjacency_filter", "MapResult", "PipelineConfig",
    "map_pairs_impl", "stage_stat_counts", "stage_stats",
    "QueryResult", "query_csr", "query_read_batch", "Scoring",
    "SeedSet", "hash_seeds", "seed_read_batch", "INVALID_LOC", "PaddedSeedMap",
    "SeedMap", "SeedMapConfig", "build_seedmap", "seedmap_stats", "to_padded",
    "LongReadConfig", "LongReadResult", "map_long_reads",
    "ReadSimConfig", "random_reference", "simulate_long_reads",
    "simulate_pairs",
]
