"""The plain reference against ``repro_torch`` on its torch backend at a
tiny size: the same SeedMap, the same windows, the same MapResult field
for field, the same stage counts.  The reference itself imports nothing
of the program."""
from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import generate as G  # noqa: E402
from portbench.lanes.pairs import library, params  # noqa: E402
from portbench.reference import plain  # noqa: E402

CPU = torch.device("cpu")
GENOME, TABLE_BITS, BATCH = 1 << 16, 14, 384


def _config(name):
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


def _traffic(name):
    return json.loads((ROOT / "portbench" / "traffic"
                       / f"{name}.json").read_text())


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax")


def test_csr_equals_the_programs_build():
    from repro_torch.core.seedmap import SeedMapConfig, build_seedmap
    ref = G.random_genome(GENOME, G.generator(3, 1, CPU), CPU)
    # a small table forces over-full buckets out
    p = params(_config("pe150-775m"), table_bits=10, max_locations=70)
    sm = build_seedmap(ref, SeedMapConfig(table_bits=10, max_locations=70))
    mine = plain.build_csr(ref, p)
    assert torch.equal(mine.offsets, sm.offsets)
    assert torch.equal(mine.locations, sm.locations)


@pytest.mark.parametrize("width", [166, 182, 266])
def test_windows_equal_the_packed_gather_at_every_edge(width):
    from repro_torch.core.encoding import gather_windows_packed, pack_2bit
    ref = G.random_genome(1000 + 7, G.generator(4, 1, CPU), CPU)
    lead = 8
    pos = torch.tensor([-500, -9, -1, 0, 3, 17, 500, 1007 - width,
                        1000, 1006, 2**31 - 1, -(2**31)], dtype=torch.int32)
    valid = pos != plain.INVALID_LOC
    got = plain.windows(plain.padded_bases(ref), ref.shape[0], pos, valid,
                        width - 2 * lead, lead)
    want = gather_windows_packed(pack_2bit(ref),
                                 torch.where(valid, pos - lead, 0), width)
    assert torch.equal(got, want)


@pytest.mark.parametrize("config,traffic,foreign_share", [
    ("pe150-775m", "illumina", 0.0), ("pe150-775m", "diverged", 0.0),
    ("pe150-775m", "illumina", 0.8), ("pe250-775m", "illumina", 0.0)])
def test_reference_equals_the_programs_torch_path(config, traffic,
                                                  foreign_share):
    from repro_torch.core.pipeline import PipelineConfig, stage_stat_counts
    from repro_torch.core.seedmap import SeedMapConfig, build_seedmap
    from repro_torch.engine import ExecutionConfig, Mapper

    cfg = dict(_config(config), genome_bases=GENOME, table_bits=TABLE_BITS)
    tr = dict(_traffic(traffic), foreign_share=foreign_share)
    p = params(cfg)
    ref = G.random_genome(GENOME, G.generator(5, 1, CPU), CPU)
    foreign = G.random_genome(GENOME, G.generator(5, 2, CPU), CPU)
    r1, r2, *_ = G.batch(ref, foreign, BATCH, library(cfg, tr),
                         G.generator(5, 16, CPU))
    mapper = Mapper.from_index(
        build_seedmap(ref, SeedMapConfig(table_bits=TABLE_BITS)), ref,
        PipelineConfig(read_len=cfg["read_len"], packed_ref=True),
        ExecutionConfig(device="cpu"))
    got = mapper.map(r1, r2)
    want, w = plain.map_batch(plain.build_csr(ref, p),
                              plain.padded_bases(ref), GENOME, r1, r2, p,
                              block=100)
    for f in plain.RESULT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    counts = {k: int(v) for k, v in stage_stat_counts(got).items()}
    assert counts == plain.stage_counts(want)
    assert w.dp_rows == p.residual_cap(BATCH)
    assert int(w.n_cand.sum()) > 0
    if foreign_share:   # pairs from an unindexed genome fail the filter
        assert counts["adjacency_fail"] > BATCH // 10
