"""Architecture registry of the ported families: `get_config(name)`,
`get_smoke_config(name)`.

Smoke configs keep the family topology (GQA ratio, QKV bias, head width
rule) at CPU-testable width, by the JAX package's reduction rules.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import minitron_8b, qwen1p5_110b, stablelm_3b, yi_6b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "yi-6b": yi_6b,
    "qwen1.5-110b": qwen1p5_110b,
    "stablelm-3b": stablelm_3b,
    "minitron-8b": minitron_8b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; have "
                       f"{sorted(_MODULES)}")
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small width/depth, tiny vocab."""
    cfg = get_config(name)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, d_ff=128, vocab_size=256, remat=False,
        attn_block_q=64, attn_block_k=64, n_heads=4,
        n_kv_heads=max(1, round(4 * cfg.n_kv_heads / cfg.n_heads)),
        head_dim=16)
