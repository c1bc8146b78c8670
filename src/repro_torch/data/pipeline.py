"""Deterministic synthetic data: the LM token stream of the trainer and
the read source of the serve CLI.

Stateless by step: `lm_batch_for_step(step)`, `batch_for_step(step)` and
`read_pairs_for_step(step)` are pure functions of (seed, step, host), so
a restarted or added host regenerates any batch without iterator state
(a restart from a checkpoint at step k sees the same tokens), and each
host generates only its own slice of the global batch.

The LM stream emulates document packing: bos markers at geometric
boundaries (mean ``mean_doc_len``).  Its numbers come from numpy's
generator keyed by (seed, step, host); they differ from the JAX
package's ``jax.random`` stream, whose shapes, dtypes and structure they
keep.  Batches land on ``device`` (the GPU unless the caller asks for
the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bos_id: int = 1
    mean_doc_len: int = 512
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


def _rng(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng([seed, step, host])


def lm_batch_for_step(cfg: DataConfig, step: int, device="cuda") -> dict:
    """One host-local {tokens, labels} batch of int32, deterministic in
    (seed, step, host).

    Labels are next-token shifted (labels[t] = tokens[t + 1]; the last
    position predicts a fresh sample); tokens are drawn from [2, V), and
    a position starts a document (bos_id) with probability
    1 / mean_doc_len, the first one always.
    """
    rng = _rng(cfg.seed, step, cfg.host_id)
    B, S = cfg.host_batch, cfg.seq_len
    toks = rng.integers(2, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    bos = rng.random((B, S + 1)) < (1.0 / cfg.mean_doc_len)
    bos[:, 0] = True
    toks = torch.as_tensor(np.where(bos, np.int32(cfg.bos_id), toks),
                           device=device)
    return {"tokens": toks[:, :S], "labels": toks[:, 1:]}


def batch_for_step(cfg: DataConfig, model_cfg: ModelConfig, step: int,
                   device="cuda") -> dict:
    """Family-aware batch: audio gets (B, S, K) codebook tokens, vlm a
    bf16 prefix of max(4, S // 4) patch embeddings (normal x 0.02, the
    modality frontend's stub) before S minus that many text tokens."""
    if model_cfg.family == "audio":
        rng = _rng(cfg.seed ^ 0x5EED, step, cfg.host_id)
        B, S = cfg.host_batch, cfg.seq_len
        t = torch.as_tensor(rng.integers(
            0, model_cfg.vocab_size, (B, S + 1, model_cfg.n_codebooks),
            dtype=np.int32), device=device)
        return {"tokens": t[:, :S], "labels": t[:, 1:]}
    base = lm_batch_for_step(cfg, step, device)
    if model_cfg.family == "vlm":
        rng = _rng(cfg.seed ^ 0xABCD, step, cfg.host_id)
        sv = max(4, cfg.seq_len // 4)
        emb = torch.as_tensor(rng.standard_normal(
            (cfg.host_batch, sv, model_cfg.d_model), dtype=np.float32),
            device=device).to(torch.bfloat16) * 0.02
        st = cfg.seq_len - sv
        return {"tokens": base["tokens"][:, :st],
                "labels": base["labels"][:, :st],
                "vision_embeds": emb}
    return base


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
