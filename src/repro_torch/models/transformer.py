"""The dense transformer (yi-6b, qwen1.5-110b, stablelm-3b, minitron-8b):
template, KV cache and forward.

Cache protocol, as in the JAX package:
  forward(cache=None)                      no KV kept
  forward(cache=None, return_cache=True)   prefill: per-layer KV of length
                                           S is collected
  forward(cache=DecodeCache, S == 1)       decode: one token

Layers run as a Python loop over the layer-stacked ``(L, ...)``
parameters (the JAX package's lax.scan); remat and unroll change no value
and have no counterpart here, nor do the sharding constraints, which are
the identity without a mesh.  The other families (moe, ssm, hybrid, vlm,
audio) are not ported yet: `forward` raises for them.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.seed_gather.ref import normalise_ids
from repro_torch.models import layers as L
from repro_torch.models.template import Leaf

PORTED_FAMILIES = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported to "
            f"repro_torch yet; ported: {PORTED_FAMILIES}")


# =========================================================== templates =====
def _block_template(cfg: ModelConfig, stacked: tuple) -> dict:
    sta = tuple("layers" for _ in stacked)
    d = cfg.d_model
    return {
        "ln1": Leaf(stacked + (d,), sta + ("norep",), init="ones"),
        "attn": L.attention_template(cfg, stacked),
        "ln2": Leaf(stacked + (d,), sta + ("norep",), init="ones"),
        "mlp": L.mlp_template(cfg, stacked),
    }


def model_template(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    t: dict[str, Any] = {
        "final_norm": Leaf((d,), ("norep",), init="ones"),
        "embed": Leaf((V, d), ("vocab", "embed"), scale=0.02,
                      fan_in_dims=()),
        "layers": _block_template(cfg, (cfg.n_layers,)),
    }
    if not cfg.tie_embeddings:
        t["out_head"] = Leaf((d, V), ("embed", "vocab"))
    return t


def layer_params(lp, i: int):
    """Layer ``i``'s parameters: views of the layer-stacked tree."""
    if isinstance(lp, dict):
        return {k: layer_params(v, i) for k, v in lp.items()}
    return lp[i]


# ============================================================= caches ======
class DecodeCache(NamedTuple):
    """Layer-stacked KV caches (L, B, Smax, KV, hd); ``ssm`` is () for the
    dense family; ``length`` (a Python int) is the current fill."""

    kv_k: Any
    kv_v: Any
    ssm: Any
    length: int


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> DecodeCache:
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return DecodeCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), (), 0)


# ============================================================ blocks =======
def _dense_block(p, x, cfg, positions, kv_cache, cache_len, backend):
    """One attn + FFN block.  kv_cache: None (full-seq) or (k, v) buffers."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    attn_out, new_kv = L.attention_forward(
        p["attn"], h, cfg, positions, kv_cache, cache_len, backend)
    x = x + attn_out
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.mlp_forward(p["mlp"], h), new_kv


# ========================================================== embedding ======
def take_fill(table, ids):
    """Rows ``table[ids]`` as ``jnp.take(table, ids, axis=0)`` gives them in
    its default "fill" mode: an id in [-V, -1] wraps, and an id outside
    [-V, V-1] gives a row of NaN.  The gather index is clamped first, so
    nothing indexes out of range on either device."""
    V = table.shape[0]
    rows = table[normalise_ids(ids, V)]
    inside = (ids >= -V) & (ids < V)
    return torch.where(inside[..., None], rows, torch.nan)


def _embed(params, cfg: ModelConfig, batch: dict):
    tokens = batch["tokens"]
    x = take_fill(params["embed"], tokens).to(cfg.act_dtype)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    return x, positions, torch.ones((B, S), dtype=torch.bool,
                                    device=tokens.device)


def _logits(params, cfg: ModelConfig, x):
    """Float32 logits against the float32 (tied) embedding or head."""
    xf = x.float()
    if cfg.tie_embeddings:
        return xf @ params["embed"].float().T
    return xf @ params["out_head"].float()


# ============================================================ forward ======
def forward(params, cfg: ModelConfig, batch: dict,
            cache: DecodeCache | None = None, return_cache: bool = False,
            return_hidden: bool = False, backend: str = "auto"):
    """Returns (logits, aux) or (logits, aux, cache_out).

    cache=None: full-sequence forward; with return_cache=True the
    per-layer KV (length S) is collected (prefill).  cache=DecodeCache:
    single-token decode (S must be 1); the cache's buffers are updated in
    place (the returned cache shares them) rather than copied.
    return_hidden=True returns the final-normed hidden states in place of
    the logits.  ``backend`` is the flash kernel's (`flash_attention`).
    """
    _check_family(cfg)
    decode = cache is not None
    collect = return_cache and not decode
    x, positions, loss_mask = _embed(params, cfg, batch)
    B, S, _ = x.shape
    if decode:
        if S != 1:
            raise ValueError(f"the decode path takes one token per row, got "
                             f"{S}; use prefill for S > 1")
        positions = positions + cache.length
    cache_len = cache.length if decode else None
    lp = params["layers"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        kv = (cache.kv_k[i], cache.kv_v[i]) if decode else None
        x, nkv = _dense_block(layer_params(lp, i), x, cfg, positions, kv,
                              cache_len, backend)
        if collect:
            ks.append(nkv[0])
            vs.append(nkv[1])
    cache_out = None
    if decode:
        cache_out = cache._replace(length=cache.length + S)
    elif collect:
        cache_out = DecodeCache(torch.stack(ks), torch.stack(vs), (), S)

    x = L.rmsnorm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    aux = {"balance_loss": torch.zeros((), device=x.device),
           "z_loss": torch.zeros((), device=x.device),
           "loss_mask": loss_mask}
    out = x if return_hidden else _logits(params, cfg, x)
    if decode or collect:
        return out, aux, cache_out
    return out, aux
