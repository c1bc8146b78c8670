"""Shared transformer layers: RMSNorm, RoPE / M-RoPE, GQA attention and
the SwiGLU MLP.

Prefill attention takes one of four routes, as in the JAX package: the
lower-triangle block loop (`triangle_attention`, ``attn_impl="triangle"``),
the plain O(S^2) `dense_attention` for short prompts, the blockwise online
softmax (`blockwise_attention`, no S x S scores) and, with
``cfg.use_flash_kernel``, the hand-written flash kernel
(`repro_torch.kernels.flash_attention`).  Decode attends one query against
the KV cache (`decode_attention`).  Shapes keep the JAX package's layout:
activations (B, S, H, D), weights (d_in, d_out).

Under tensor parallelism over the mesh's ``model`` axis (`TensorParallel`)
the projections are Megatron's: ``wq`` / ``wk`` / ``wv`` and ``w_gate`` /
``w_up`` split by columns, ``wo`` and ``w_down`` by rows, whose partial
products are summed over the axis.  A decode there attends this rank's
slice of the cache: its kv heads, or a run of positions of all of them
whose partial softmax statistics are combined over the axis.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.template import Leaf
from repro_torch.sharding.collectives import (
    MeshAxis, all_gather, combine_softmax, gather, grad_sum, reduce_sum,
)

NEG_INF = -1e30


# ------------------------------------------------------------------ norms --
def rmsnorm(x, scale, eps: float):
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def silu(x):
    """x * sigmoid(x) in the JAX package's form, x * (1 / (1 + exp(-x))),
    one rounding per op in x's dtype: ``F.silu`` rounds a bf16 result
    once, which differs from it in the last bit of ~40 % of values."""
    return x * (1 / (1 + torch.exp(-x)))


# ------------------------------------------------------------------- rope --
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x, ang):
    """x: (B, S, H, D) rotated by angles ``ang`` (B, S, D/2): the
    concatenated halves [x1 cos - x2 sin, x2 cos + x1 sin] in float32."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Qwen2-VL M-RoPE frequency split (t, h, w) in half-dim units.

    head_dim=128 -> (16, 24, 24), matching the published config.
    """
    half = head_dim // 2
    s_hw = 3 * half // 8
    return (half - 2 * s_hw, s_hw, s_hw)


def apply_mrope(x, positions_thw, theta: float):
    """M-RoPE: three position streams rotate disjoint frequency sections.

    x: (B, S, H, D); positions_thw: (B, S, 3) int (t, h, w ids; equal for
    text tokens, spatial for vision-patch tokens).
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec = mrope_sections(x.shape[-1])
    idx = torch.arange(x.shape[-1] // 2, device=x.device)
    which = torch.where(idx < sec[0], 0, torch.where(idx < sec[0] + sec[1],
                                                     1, 2))
    return _rotate(x, positions_thw[..., which].float() * freqs)


# -------------------------------------------------- blockwise attention ----
def _softmax_step(m, l, acc, s, vblk):
    """One kv block of the online softmax: the running max, sum and
    output after scores ``s`` (B, KV, G, bq, bk) against ``vblk``."""
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    return (m_new, l * alpha + p.sum(-1, keepdim=True),
            acc * alpha + torch.einsum("bkgqc,bckd->bkgqd", p, vblk))


def blockwise_attention(q, k, v, block_q: int, block_k: int,
                        causal: bool = True):
    """Flash-style attention without S x S scores (plain torch).

    q: (B, S, H, D); k, v: (B, S, KV, D) with H = KV * G.  Every kv block
    is visited and future ones are masked, as the JAX scan does.  Returns
    (nq, B, KV, G, bq, D) float32; see `_assemble_blockwise`.
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    bq = min(block_q, S)
    bk = min(block_k, S)
    assert S % bq == 0 and S % bk == 0, (S, bq, bk)
    nq, nk = S // bq, S // bk
    scale = D ** -0.5
    qb = q.reshape(B, nq, bq, KV, G, D).float()
    kb = k.reshape(B, nk, bk, KV, D).float()
    vb = v.reshape(B, nk, bk, KV, D).float()
    pos_q = torch.arange(bq, device=q.device)
    pos_k = torch.arange(bk, device=q.device)
    outs = []
    for qi in range(nq):
        qblk = qb[:, qi]                                  # (B, bq, KV, G, D)
        m = torch.full((B, KV, G, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, bq, 1), device=q.device)
        acc = torch.zeros((B, KV, G, bq, D), device=q.device)
        for ki in range(nk):
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kb[:, ki]) * scale
            if causal:
                mask = (qi * bq + pos_q)[:, None] >= (ki * bk + pos_k)[None]
                s = torch.where(mask, s, NEG_INF)
            m, l, acc = _softmax_step(m, l, acc, s, vb[:, ki])
        outs.append(acc / torch.where(l == 0, 1.0, l))
    return torch.stack(outs)


def _assemble_blockwise(outs, B, S, H, D, KV, G, nq, bq):
    """(nq, B, KV, G, bq, D) -> (B, S, H, D)."""
    x = outs.movedim(0, 1)                  # (B, nq, KV, G, bq, D)
    x = x.permute(0, 1, 4, 2, 3, 5)         # (B, nq, bq, KV, G, D)
    return x.reshape(B, S, H, D)


def triangle_attention(q, k, v, block_q: int, block_k: int):
    """Causal blockwise attention over the lower triangle of blocks only:
    kv blocks past a query block's diagonal are skipped, not masked.
    q: (B, S, H, D); k, v: (B, S, KV, D).  Returns (B, S, H, D) float32.
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    bq = min(block_q, S)
    bk = min(block_k, S)
    if S % bq or S % bk:
        raise ValueError(f"triangle_attention needs S a multiple of the "
                         f"blocks ({bq}, {bk}), got {S}")
    nq = S // bq
    scale = D ** -0.5
    out_blocks = []
    for qi in range(nq):
        qblk = q[:, qi * bq: (qi + 1) * bq].reshape(B, bq, KV, G, D).float()
        m = torch.full((B, KV, G, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, bq, 1), device=q.device)
        acc = torch.zeros((B, KV, G, bq, D), device=q.device)
        hi = ((qi + 1) * bq + bk - 1) // bk   # kv blocks meeting the triangle
        for ki in range(hi):
            kblk = k[:, ki * bk: (ki + 1) * bk].float()
            vblk = v[:, ki * bk: (ki + 1) * bk].float()
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kblk) * scale
            if ki * bk + bk > qi * bq:        # diagonal block: mask inside
                qp = qi * bq + torch.arange(bq, device=q.device)
                kp = ki * bk + torch.arange(bk, device=q.device)
                s = torch.where(qp[:, None] >= kp[None], s, NEG_INF)
            m, l, acc = _softmax_step(m, l, acc, s, vblk)
        o = acc / torch.where(l == 0, 1.0, l)          # (B, KV, G, bq, D)
        out_blocks.append(o.permute(0, 3, 1, 2, 4).reshape(B, bq, H, D))
    return torch.cat(out_blocks, dim=1)


def dense_attention(q, k, v, causal: bool = True):
    """Reference O(S^2)-memory attention (short prompts); float32 out."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.float(), k.float()) * (D ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return out.reshape(B, S, H, D)


def decode_attention(q, k_cache, v_cache, cache_len: int):
    """One-token attention over a KV cache.

    q: (B, 1, H, D); caches: (B, Smax, KV, D); positions >= cache_len are
    masked.
    """
    B, Smax, KV, D = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * (D ** -0.5)
    pos = torch.arange(Smax, device=q.device)
    s = torch.where(pos < cache_len, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgc,bckd->bkgd", p / l, v_cache.float())
    return out.reshape(B, 1, H, D)


def cache_write_start(cache_len: int, n: int, max_len: int) -> int:
    """Where `n` new rows go in a `max_len` cache filled to `cache_len`:
    clamped so they fit, as ``jax.lax.dynamic_update_slice`` clamps (a
    decode at ``cache_len >= max_len`` overwrites row max_len - 1)."""
    return min(max(cache_len, 0), max_len - n)


# ------------------------------------------------- tensor parallelism ------
@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """How one layer's leaves lie over the ``model`` axis: which of them
    the parameter specs split (a dim the axis does not divide stays
    whole on every rank), and whether a decode cache splits its sequence
    over the axis (``seq_split``: the kv heads do not divide by it) or
    its kv heads (`repro_torch.sharding.partition.cache_specs`).  One
    layout serves every family: attention and the SwiGLU MLP read the
    first four fields, MoE ``experts_split`` (`models.moe`) and Mamba2
    ``ssm_split`` (`models.mamba2`)."""

    axis: MeshAxis
    q_split: bool = False       # wq, bq (columns) and wo (rows)
    kv_split: bool = False      # wk, wv, bk, bv (columns)
    ff_split: bool = False      # w_gate, w_up (columns) and w_down (rows)
    seq_split: bool = False     # the decode cache splits its positions,
                                # not kv heads
    experts_split: bool = False  # the router's columns and the experts
    ssm_split: frozenset = frozenset()  # the Mamba2 leaves split (their
                                        # ssm_inner / ssm_heads dim)


def _kv_heads_of(q0: int, nq: int, G: int, kv0: int, k, v):
    """k, v (B, S, KV', hd) holding kv heads from ``kv0`` on, cut to the
    kv heads of q heads [q0, q0 + nq): a block of them with the group
    size G kept, or one kv head per q head (G 1) where the q heads do not
    start and end on a group's edge."""
    if q0 % G == 0 and nq % G == 0:
        lo = q0 // G - kv0
        return k[:, :, lo:lo + nq // G], v[:, :, lo:lo + nq // G]
    idx = torch.arange(q0, q0 + nq, device=k.device) // G - kv0
    return k[:, :, idx], v[:, :, idx]


def _attention_tp(p, x, cfg: ModelConfig, positions, positions_thw,
                  backend, tp: TensorParallel, cache=None,
                  cache_len: int | None = None):
    """GQA attention with wq split over the ``model`` axis.

    Each rank computes the q heads whose columns it holds (all H where
    the split cuts a head, with wq gathered), their kv heads (from its own
    wk / wv columns where those are whole heads aligned with its q heads;
    else from the whole kv projection, gathered, or replicated and its
    gradient summed over the axis), and multiplies its own rows of wo; the
    partial products are summed over the axis.

    Full sequence (``cache`` None) returns the kv heads it computed,
    before they are cut to its q heads': its own, or all of them (from
    which a prefill keeps its run of positions, ``tp.seq_split``).  A
    decode writes the new rows into ``cache``, this rank's slice
    (`_decode_tp`)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    M, m = tp.axis.size, tp.axis.index
    G = H // KV
    dt = x.dtype
    x = grad_sum(x, tp.axis)

    def whole(names, split):
        """Leaves' whole columns: gathered if split, else replicated (the
        gradient of a rank's part summed over the axis)."""
        return {n: gather(p[n], -1, tp.axis) if split
                else grad_sum(p[n], tp.axis) for n in names if n in p}

    if H % M == 0:
        q0, nq = m * H // M, H // M
        wq = {n: p[n] for n in ("wq", "bq") if n in p}
    else:
        q0, nq = 0, H
        wq = whole(("wq", "bq"), True)
    kv_names = ("wk", "wv", "bk", "bv")
    if tp.kv_split and KV % M == 0 and H % M == 0:
        kv0, nkv = m * KV // M, KV // M
        wkv = {n: p[n] for n in kv_names if n in p}
    else:
        kv0, nkv = 0, KV
        wkv = whole(kv_names, tp.kv_split)
    q = x @ wq["wq"].to(dt)
    k = x @ wkv["wk"].to(dt)
    v = x @ wkv["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + wq["bq"].to(dt)
        k = k + wkv["bk"].to(dt)
        v = v + wkv["bv"].to(dt)
    q = q.reshape(B, S, nq, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    q, k = _rotate_qk(q, k, cfg, positions, positions_thw)
    if cache is not None:
        out = _decode_tp(q, k, v, cache, cache_len, tp, q0, H)
        new = cache
    else:
        new = (k, v)
        if (kv0, nkv) != (q0 // G, nq // G) or nq % G:
            k, v = _kv_heads_of(q0, nq, G, kv0, k, v)
        out = _attend(q, k, v, cfg, backend)
    out = out.to(dt).reshape(B, S, nq * hd)
    if nq == H and M > 1:
        w = H * hd // M          # the rows of wo this rank holds
        out = out[..., m * w:(m + 1) * w]
    return reduce_sum(out @ p["wo"].to(dt), tp.axis), new


def _decode_tp(q, k, v, cache, cache_len: int, tp: TensorParallel,
               q0: int, H: int):
    """A decode's attention under tensor parallelism: q (B, S, nq, hd)
    this rank's q heads from ``q0`` (or all H); k, v (B, S, nkv, hd) the
    new rows of its kv heads (all KV where the cache splits its
    sequence); ``cache`` this rank's (k, v) slice, written in place.

    kv heads split: its q heads over its kv heads' cache, as
    `decode_attention`.  Sequence split (each rank holds Smax / M
    positions of every kv head): the rank whose run holds the write
    position (`cache_write_start`'s clamp against the global Smax) writes
    the new rows; every rank attends all H q heads (gathered over the
    axis) over its own positions, masked past the fill, and
    `combine_softmax` joins the partial statistics; it keeps its own
    heads' output."""
    k_cache, v_cache = cache
    B, S, nq, hd = q.shape
    if not tp.seq_split:
        at = cache_write_start(cache_len, S, k_cache.shape[1])
        k_cache[:, at:at + S] = k.to(k_cache.dtype)
        v_cache[:, at:at + S] = v.to(v_cache.dtype)
        return decode_attention(q, k_cache, v_cache, cache_len + S)
    axis = tp.axis
    n = k_cache.shape[1]
    lo = axis.index * n
    at = cache_write_start(cache_len, S, n * axis.size)
    a, b = max(at, lo), min(at + S, lo + n)
    if a < b:
        k_cache[:, a - lo:b - lo] = k[:, a - at:b - at].to(k_cache.dtype)
        v_cache[:, a - lo:b - lo] = v[:, a - at:b - at].to(v_cache.dtype)
    if nq != H:
        q = all_gather(q, 2, axis)
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * (hd ** -0.5)
    pos = lo + torch.arange(n, device=q.device)
    s = torch.where(pos < cache_len + S, s, NEG_INF)
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx)
    acc = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    out = combine_softmax(mx, p.sum(-1, keepdim=True), acc, axis)
    return out.reshape(B, 1, H, hd)[:, :, q0:q0 + nq]


# ------------------------------------------------------------ GQA module ---
def attention_template(cfg: ModelConfig, stacked: tuple = ()) -> dict:
    """Template for one (optionally layer-stacked) GQA attention block."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    st = stacked
    sta = tuple("layers" for _ in stacked)
    t = {
        "wq": Leaf(st + (d, H * hd), sta + ("embed", "q_heads")),
        "wk": Leaf(st + (d, KV * hd), sta + ("embed", "kv_heads")),
        "wv": Leaf(st + (d, KV * hd), sta + ("embed", "kv_heads")),
        "wo": Leaf(st + (H * hd, d), sta + ("q_heads", "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = Leaf(st + (H * hd,), sta + ("q_heads",), init="zeros")
        t["bk"] = Leaf(st + (KV * hd,), sta + ("kv_heads",), init="zeros")
        t["bv"] = Leaf(st + (KV * hd,), sta + ("kv_heads",), init="zeros")
    return t


def attention_forward(p, x, cfg: ModelConfig, positions, cache=None,
                      cache_len: int | None = None, positions_thw=None,
                      backend: str = "auto",
                      tp: TensorParallel | None = None):
    """GQA attention.  cache=None: full causal (prefill), returns
    (out, (k, v)); cache=(k_cache, v_cache): decode, writes the new rows
    into the caches in place and returns (out, (k_cache, v_cache)).
    With ``cfg.m_rope`` and ``positions_thw`` (B, S, 3) the rotation is
    M-RoPE's.  ``backend`` picks the flash kernel's backend
    (`flash_attention`).  With ``tp`` and wq split over its axis, ``p``
    holds this rank's slices and ``cache`` its slice (`_attention_tp`).
    """
    if tp is not None and tp.q_split:
        return _attention_tp(p, x, cfg, positions, positions_thw, backend,
                             tp, cache, cache_len)
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    q, k = _rotate_qk(q, k, cfg, positions, positions_thw)

    if cache is not None and tp is not None:
        # wq whole on every rank (the axis cuts no column block of it):
        # all H heads here, over this rank's slice of the cache
        out = _decode_tp(q, k, v, cache, cache_len, tp, 0, H)
        new_cache = cache
    elif cache is not None:
        k_cache, v_cache = cache
        at = cache_write_start(cache_len, S, k_cache.shape[1])
        k_cache[:, at:at + S] = k.to(k_cache.dtype)
        v_cache[:, at:at + S] = v.to(v_cache.dtype)
        out = decode_attention(q, k_cache, v_cache, cache_len + S)
        new_cache = (k_cache, v_cache)
    else:
        out = _attend(q, k, v, cfg, backend)
        new_cache = (k, v)
    out = out.to(dt).reshape(B, S, H * hd)
    return out @ p["wo"].to(dt), new_cache


def _rotate_qk(q, k, cfg: ModelConfig, positions, positions_thw):
    if cfg.m_rope and positions_thw is not None:
        return (apply_mrope(q, positions_thw, cfg.rope_theta),
                apply_mrope(k, positions_thw, cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _attend(q, k, v, cfg: ModelConfig, backend):
    """Causal full-sequence attention of q (B, S, H, hd) against k, v
    (B, S, KV, hd) by the config's route: (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if cfg.attn_impl == "triangle":
        return triangle_attention(q, k, v, cfg.attn_block_q,
                                  cfg.attn_block_k)
    if S <= cfg.attn_block_q or S <= 128:
        return dense_attention(q, k, v)
    if cfg.use_flash_kernel:
        # (B, S, heads, D) -> (B * heads, S, D); the kernel reads K/V
        # row bh // G, the rows jnp.repeat(k, G, axis=2) would give
        def bhd(t):
            return t.transpose(1, 2).reshape(-1, S, hd)
        o = flash_attention(bhd(q), bhd(k), bhd(v), causal=True,
                            backend=backend)
        return o.reshape(B, H, S, hd).transpose(1, 2)
    bq = min(cfg.attn_block_q, S)
    outs = blockwise_attention(q, k, v, cfg.attn_block_q, cfg.attn_block_k,
                               causal=True)
    return _assemble_blockwise(outs, B, S, H, hd, KV, H // KV, S // bq, bq)


# -------------------------------------------------------------- SwiGLU -----
def mlp_template(cfg: ModelConfig, stacked: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    st = stacked
    sta = tuple("layers" for _ in stacked)
    return {
        "w_gate": Leaf(st + (d, f), sta + ("embed", "ff")),
        "w_up": Leaf(st + (d, f), sta + ("embed", "ff")),
        "w_down": Leaf(st + (f, d), sta + ("ff", "embed")),
    }


def mlp_forward(p, x, tp: TensorParallel | None = None):
    """SwiGLU; with ``tp`` and the ff dim split over its axis, ``p`` holds
    this rank's columns of w_gate / w_up and rows of w_down, and the
    partial products are summed over the axis."""
    if tp is not None and tp.ff_split:
        return reduce_sum(mlp_forward(p, grad_sum(x, tp.axis)), tp.axis)
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (silu(g) * u) @ p["w_down"].to(dt)
