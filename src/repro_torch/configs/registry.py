"""Architecture registry: `get_config(name)`, `get_smoke_config(name)`.

Smoke configs keep the exact family topology (GQA ratios, MoE routing,
SSM state machinery, hybrid period, codebooks) at CPU-testable width, by
the JAX package's reduction rules.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    kimi_k2_1t_a32b, llama4_scout_17b_a16e, mamba2_2p7b, minitron_8b,
    musicgen_medium, qwen1p5_110b, qwen2_vl_7b, stablelm_3b, yi_6b,
    zamba2_2p7b,
)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "zamba2-2.7b": zamba2_2p7b,
    "yi-6b": yi_6b,
    "qwen1.5-110b": qwen1p5_110b,
    "stablelm-3b": stablelm_3b,
    "minitron-8b": minitron_8b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "qwen2-vl-7b": qwen2_vl_7b,
    "musicgen-medium": musicgen_medium,
    "mamba2-2.7b": mamba2_2p7b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small width/depth, tiny vocab."""
    cfg = get_config(name)
    kw = dict(
        n_layers=2 if cfg.family != "hybrid" else 2 * max(cfg.attn_every, 1),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        remat=False,
        attn_block_q=64,
        attn_block_k=64,
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, round(4 * cfg.n_kv_heads / cfg.n_heads))
        kw["head_dim"] = 16
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 16
        kw["ssm_chunk"] = 16
    if cfg.family == "hybrid":
        kw["attn_every"] = cfg.attn_every and 2
        kw["n_layers"] = 4
    if cfg.family == "moe":
        kw["n_experts"] = 8
        kw["moe_top_k"] = min(cfg.moe_top_k, 2)
    if cfg.family == "vlm":
        kw["vision_tokens"] = 16
    return dataclasses.replace(cfg, **kw)
