"""Public model API of the serving path: parameters, prefill and decode
steps, and a smoke batch.

Runs on the GPU unless the caller asks for the CPU (``device="cpu"``);
the steps run wherever the parameters live.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.template import init_params
from repro_torch.models.transformer import (
    DecodeCache, _logits, forward, model_template,
)


# ------------------------------------------------------------- params ------
def model_init_params(cfg: ModelConfig, generator: torch.Generator,
                      device="cuda"):
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (a `torch.Generator` on that device)."""
    return init_params(model_template(cfg), generator, cfg.param_dtype,
                       device)


# ------------------------------------------------------------ serving ------
def prefill_step(params, batch, cfg: ModelConfig, max_len: int,
                 cache_dtype=torch.bfloat16, backend: str = "auto"):
    """Full-sequence prefill that fills a fresh KV / SSM cache.

    Collects the per-layer KV and pads it into ``max_len`` decode buffers
    of ``cache_dtype``; SSM states are carried as they are (float32
    recurrent state; the conv window in the activation dtype), and an
    attention-free model keeps no KV.  Returns (last_token_logits, cache):
    (B, V), audio (B, K, V).  Only the last position's logits are
    computed (the JAX package computes all S and keeps the last: the same
    value, without a (B, S, V) float32 tensor).
    """
    x, _, c = forward(params, cfg, batch, return_cache=True,
                      return_hidden=True, backend=backend)
    if c.length > max_len:
        raise ValueError(f"a prompt of {c.length} tokens does not fit a "
                         f"cache of {max_len}")

    def pad_kv(kv):
        if isinstance(kv, tuple):          # () : no KV (ssm)
            return ()
        Ls, B, S, KV, hd = kv.shape
        buf = torch.zeros((Ls, B, max_len, KV, hd), dtype=cache_dtype,
                          device=kv.device)
        buf[:, :, :S] = kv
        return buf

    cache = DecodeCache(pad_kv(c.kv_k), pad_kv(c.kv_v), c.ssm, c.length)
    return _logits(params, cfg, x[:, -1:])[:, -1], cache


def decode_step(params, cache: DecodeCache, tokens, cfg: ModelConfig,
                backend: str = "auto"):
    """One-token decode against an existing cache.

    tokens: (B, 1), audio (B, 1, K).  Returns (logits, new_cache); the new
    cache shares the old one's buffers, which this call updates in place.
    """
    logits, _, new_cache = forward(params, cfg, {"tokens": tokens},
                                   cache=cache, backend=backend)
    return logits[:, -1], new_cache


# --------------------------------------------------------- smoke batch -----
def make_smoke_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
                     device="cuda") -> dict:
    """Uniform random tokens from numpy's generator under ``seed``; audio
    (batch, seq, K) codebook tokens; vlm a quarter (at least 4) of ``seq``
    as bf16 patch embeddings (normal x 0.02) before the text tokens."""
    rng = np.random.default_rng(seed)

    def ints(shape):
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                               device=device)

    if cfg.family == "audio":
        t = ints((batch, seq, cfg.n_codebooks))
        return {"tokens": t, "labels": t}
    if cfg.family == "vlm":
        sv = max(4, seq // 4)
        st = seq - sv
        tokens, labels = ints((batch, st)), ints((batch, st))
        ve = torch.as_tensor(rng.standard_normal((batch, sv, cfg.d_model),
                                                 dtype=np.float32),
                             device=device).to(torch.bfloat16) * 0.02
        return {"tokens": tokens, "labels": labels, "vision_embeds": ve}
    t = ints((batch, seq))
    return {"tokens": t, "labels": t}
