"""repro_torch's full-DP baseline against repro's on the CPU, exact
equality: `map_single_end` (pos, score, mapped) at max_cands 4 and 16 on
the baseline case of tests/test_core_pipeline.py, with reads that have no
seed hit at all and reads of the other strand in the batch, and
`exact_match_rate` on the §3.2 observation's reads."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ReadSimConfig as JReadSimConfig
from repro.core import SeedMapConfig as JSeedMapConfig
from repro.core import build_seedmap as j_build_seedmap
from repro.core import simulate_pairs as j_simulate_pairs
from repro.core.baseline import exact_match_rate as j_exact_match_rate
from repro.core.baseline import map_single_end as j_map_single_end
from repro_torch.convert import seedmap_from_numpy
from repro_torch.core.baseline import exact_match_rate, map_single_end
from repro_torch.core.encoding import revcomp
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.query import query_read_batch
from repro_torch.core.seeding import seed_read_batch
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_pairs,
)


@pytest.fixture(scope="module")
def world():
    """tests/test_core_pipeline.py's world and baseline batch (32 reads,
    sub_rate 0.005, seed 10), plus the forward mate 2 of the same pairs
    and 24 random reads whose three seeds all hit empty buckets."""
    ref = random_reference(150_000, np.random.default_rng(0))
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=18,
                                              max_locations=128))
    sm = seedmap_from_numpy(np.asarray(jsm.offsets),
                            np.asarray(jsm.locations),
                            dataclasses.asdict(jsm.config))
    sim = simulate_pairs(ref, 32, ReadSimConfig(sub_rate=0.005), seed=10)
    jsim = j_simulate_pairs(ref, 32, JReadSimConfig(sub_rate=0.005), seed=10)
    np.testing.assert_array_equal(sim.reads1, jsim.reads1)
    cfg = PipelineConfig()
    rand = np.random.default_rng(1).integers(0, 4, (400, 150),
                                             dtype=np.uint8)
    q = query_read_batch(sm, seed_read_batch(
        torch.from_numpy(rand), cfg.seed_len, cfg.seeds_per_read,
        sm.config.hash_seed), cfg.max_locs_per_seed)
    no_hit = rand[(q.n_hits == 0).numpy()][:24]
    assert len(no_hit) == 24
    r2_fwd = revcomp(torch.from_numpy(sim.reads2)).numpy()
    reads = np.concatenate([sim.reads1, no_hit, r2_fwd])
    return ref, jsm, sm, sim, reads


@pytest.mark.parametrize("max_cands", [4, 16])
def test_map_single_end_matches_repro(world, max_cands):
    ref, jsm, sm, sim, reads = world
    want = j_map_single_end(jsm, jnp.asarray(ref), jnp.asarray(reads),
                            max_cands=max_cands)
    got = map_single_end(sm, torch.from_numpy(ref), torch.from_numpy(reads),
                         max_cands=max_cands)
    for f in want._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    mapped = got.mapped.numpy()
    assert not mapped[32:56].any()              # no seed hit: unmapped
    assert mapped[:32].mean() > 0.9 and mapped[56:].mean() > 0.9
    # repro's test_baseline_single_end rule, on the mate-1 reads
    pos = got.pos.numpy()[:32]
    ok = mapped[:32]
    assert (np.abs(pos[ok] - sim.true_start1[ok]) <= 16).mean() > 0.95


def test_exact_match_rate_matches_repro(world):
    ref = world[0]
    sim = simulate_pairs(ref, 256, ReadSimConfig(sub_rate=0.004), seed=9)
    r2_fwd = revcomp(torch.from_numpy(sim.reads2)).numpy()
    for reads, starts in ((sim.reads1, sim.true_start1),
                          (r2_fwd, sim.true_start2)):
        want = j_exact_match_rate(jnp.asarray(reads), jnp.asarray(ref),
                                  jnp.asarray(starts))
        got = exact_match_rate(torch.from_numpy(reads),
                               torch.from_numpy(ref),
                               torch.from_numpy(starts))
        assert got.dtype == torch.float32
        assert float(got) == float(want)
        assert 0 < float(got) < 1
