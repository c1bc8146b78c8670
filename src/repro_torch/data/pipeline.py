"""Deterministic synthetic read source for the serve CLI.

Stateless by step: `read_pairs_for_step(step)` is a pure function of
(seed, step, host), so a restarted or added host regenerates any batch
without iterator state, and each host generates only its own batches.
The JAX package's LM token stream (`DataConfig`, `lm_batch_for_step`,
`batch_for_step`) belongs to training and is not part of this package.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ReadStreamConfig:
    """Deterministic read-pair stream over a fixed reference."""

    batch: int = 4096
    read_len: int = 150
    seed: int = 0
    host_id: int = 0


def read_pairs_for_step(ref: np.ndarray, cfg: ReadStreamConfig, step: int,
                        sim_cfg=None):
    """Simulate one batch of FR pairs keyed by (seed, step, host)."""
    from repro_torch.core.simulate import ReadSimConfig, simulate_pairs
    sim_cfg = sim_cfg or ReadSimConfig(read_len=cfg.read_len)
    # deterministic in (seed, step, host): a tuple of ints hashes the same
    # in every process, so any host can regenerate any batch
    seed = hash((cfg.seed, step, cfg.host_id)) & 0x7FFFFFFF
    return simulate_pairs(ref, cfg.batch, sim_cfg, seed=seed)
