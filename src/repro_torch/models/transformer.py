"""Model assembly for every architecture family: template, decode cache
and forward.

  dense  — GQA transformer (yi-6b, qwen1.5-110b, stablelm-3b, minitron-8b)
  moe    — GQA + grouped-dispatch MoE FFN (kimi-k2, llama4-scout)
  ssm    — attention-free Mamba2/SSD stack (mamba2-2.7b)
  hybrid — Mamba2 stack with one *shared* attention block applied after
           every `attn_every` layers (zamba2-2.7b)
  vlm    — dense backbone + precomputed patch-embedding prefix + M-RoPE
           (qwen2-vl-7b; the frontend is a stub)
  audio  — dense backbone over K EnCodec codebook streams: summed codebook
           embeddings, K output heads (musicgen-medium)

Cache protocol, as in the JAX package:
  forward(cache=None)                      no KV kept
  forward(cache=None, return_cache=True)   prefill: per-layer KV (length
                                           S) / final SSM states collected
  forward(cache=DecodeCache, S == 1)       decode: one token

Layers run as a Python loop over the layer-stacked ``(L, ...)`` (hybrid:
``(G, per, ...)``) parameters, the JAX package's lax.scan: each stacked
leaf is unbound once a forward (`unstack_layers`), so a backward pass
stacks the per-layer gradients once.  With ``cfg.remat`` a forward that
builds a graph runs each layer body (hybrid: each group body) under
`torch.utils.checkpoint`, the JAX package's ``jax.checkpoint``; unroll
changes no value and has no counterpart here.

Under a (data, model) mesh (``ctx``, a `ShardCtx`; `ModelParallel`) each
rank holds its slices of the parameters, placed by their specs, and its
rows of the batch (or every row, where they do not split over ``data``:
``rows_split`` False).  Where the JAX package's GSPMD places by sharding
constraints, this forward gathers and reduces explicitly: each layer's
leaves are gathered over ``data`` just before it runs, inside its remat
region (so a recompute gathers again and the whole copy lives for one
layer), and reduce-scattered back in backward (FSDP); the embedding, the
head and the hybrid shared block are gathered where they are used.  At
a ``model`` extent above 1 every family runs tensor parallel, each
layer by its `layers.TensorParallel` layout (hybrid's shared block by a
layout of its own): attention and the SwiGLU MLP as Megatron's, MoE
expert parallel (`models.moe`), Mamba2 by heads (`models.mamba2`), and
a vocab-parallel embedding (audio: one a codebook) and head.  The
Megatron-SP activation constraint changes no value and is not followed.

Prefill and decode run under the mesh too: a decode cache holds this
rank's slice, placed by `repro_torch.sharding.partition.cache_specs`
(rows over ``data``; kv heads over ``model``, or its positions where the
kv heads do not divide), and the logits come back whole over the vocab
(`head_logits`) for each of this rank's rows.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.seed_gather.ref import normalise_ids
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (
    MambaState, init_mamba_state, mamba_forward, mamba_template,
)
from repro_torch.models.moe import moe_forward, moe_template
from repro_torch.models.template import Leaf, axes_tree
from repro_torch.sharding.collectives import (
    MeshAxis, all_gather, gather, mesh_axis, reduce_sum,
)
from repro_torch.sharding.partition import (
    PROD_RULES, ShardCtx, Sharding, ShardingRules, cache_specs,
    tree_shardings,
)

DEFAULT_MOE_GROUPS = 32


# =========================================================== templates =====
def _block_template(cfg: ModelConfig, stacked: tuple) -> dict:
    sta = tuple("layers" for _ in stacked)
    d = cfg.d_model
    t = {
        "ln1": Leaf(stacked + (d,), sta + ("norep",), init="ones"),
        "attn": L.attention_template(cfg, stacked),
        "ln2": Leaf(stacked + (d,), sta + ("norep",), init="ones"),
    }
    if cfg.family == "moe":
        t["moe"] = moe_template(cfg, stacked)
    else:
        t["mlp"] = L.mlp_template(cfg, stacked)
    return t


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """Hybrid: (groups, SSM layers a group); the shared block runs once
    after each group."""
    return cfg.n_layers // cfg.attn_every, cfg.attn_every


def model_template(cfg: ModelConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab_size
    t: dict[str, Any] = {"final_norm": Leaf((d,), ("norep",), init="ones")}
    if cfg.family == "audio":
        K = cfg.n_codebooks
        t["embed"] = Leaf((K, V, d), ("codebooks", "vocab", "embed"),
                          scale=0.02, fan_in_dims=())
        t["out_head"] = Leaf((K, d, V), ("codebooks", "embed", "vocab"))
    else:
        t["embed"] = Leaf((V, d), ("vocab", "embed"), scale=0.02,
                          fan_in_dims=())
        if not cfg.tie_embeddings:
            t["out_head"] = Leaf((d, V), ("embed", "vocab"))
    if cfg.family == "ssm":
        Ln = cfg.n_layers
        t["layers"] = {
            "ln": Leaf((Ln, d), ("layers", "norep"), init="ones"),
            "mamba": mamba_template(cfg, (Ln,)),
        }
    elif cfg.family == "hybrid":
        G, per = _groups(cfg)
        t["layers"] = {
            "ln": Leaf((G, per, d), ("groups", "layers", "norep"),
                       init="ones"),
            "mamba": mamba_template(cfg, (G, per)),
        }
        t["shared"] = _block_template(
            dataclasses.replace(cfg, family="dense"), ())
    else:  # dense / moe / vlm / audio
        t["layers"] = _block_template(cfg, (cfg.n_layers,))
    return t


def unstack_layers(lp) -> list:
    """Each layer's parameters of a layer-stacked tree: every leaf unbound
    once along its leading dim.  Under autograd one ``UnbindBackward``
    then stacks a leaf's per-layer gradients once, where indexing
    ``leaf[i]`` would give each layer's gradient a zero tensor the size of
    the whole stack."""
    if isinstance(lp, dict):
        per_key = {k: unstack_layers(v) for k, v in lp.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(lp.unbind(0))


def _builds_graph(params) -> bool:
    """Whether a forward over ``params`` records a graph for backward."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(params, dict):
        return any(_builds_graph(v) for v in params.values())
    return params.requires_grad


def _remat(fn, on: bool):
    """``fn``, or ``fn`` under `torch.utils.checkpoint` (its activations
    recomputed in backward, as ``jax.checkpoint`` does)."""
    if not on:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


# ================================================================ mesh =====
@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """A forward's view of the mesh: its ``data`` and ``model`` axes, each
    parameter's spec (`spec_for` of its logical axes on the mesh, a tree
    in the parameters' structure), the layers' tensor-parallel layout
    and hybrid's shared block's (None at a model extent of 1, and
    ``shared_tp`` for the other families), and ``rows``: the data axis
    where the batch's rows split over it, None where each rank holds all
    of them."""

    data: MeshAxis
    model: MeshAxis
    specs: dict
    tp: L.TensorParallel | None
    vocab_split: bool
    rows: MeshAxis | None
    shared_tp: L.TensorParallel | None = None

    @property
    def n_shards(self) -> int:
        """The mesh's extent, over which MoE spreads its routing groups."""
        return self.data.size * self.model.size

    def gather_data(self, tree, specs, lead: int = 0):
        """``tree``'s leaves gathered over ``data`` along each dim their
        spec splits over it; ``lead`` leading (stacked) dims of the specs
        are ones the leaves no longer have (a layer's slices)."""
        if isinstance(tree, dict):
            return {k: self.gather_data(tree[k], specs[k], lead)
                    for k in tree}
        if self.data.size == 1:
            return tree                 # nothing to gather
        for i, entry in enumerate(specs.spec[lead:]):
            if entry == self.data.name:
                tree = gather(tree, i, self.data)
        return tree

    def head(self, params, cfg: ModelConfig) -> dict:
        """The output head's leaf ({name: leaf}, as `_logits` reads it),
        gathered over ``data``."""
        name = "embed" if cfg.tie_embeddings and cfg.family != "audio" \
            else "out_head"
        return {name: self.gather_data(params[name], self.specs[name])}


def param_shardings(cfg: ModelConfig, mesh, rules: ShardingRules = PROD_RULES):
    """Each parameter's `Sharding` on ``mesh`` (a `DeviceMesh`): its
    logical axes through ``rules``, a dim its mesh axes do not divide
    kept whole."""
    template = model_template(cfg)
    return tree_shardings(mesh, axes_tree(template), template, rules)


def tensor_parallel(axis: MeshAxis, specs: dict,
                    cfg: ModelConfig) -> L.TensorParallel:
    """The layout over ``axis`` of one block's leaves, from their specs
    (a block's subtree of `param_shardings`: attention, MLP, MoE or
    Mamba2 leaves, whichever it has)."""
    def split(sh) -> bool:
        return axis.name in sh.spec

    attn, mlp = specs.get("attn"), specs.get("mlp")
    moe, mamba = specs.get("moe"), specs.get("mamba")
    return L.TensorParallel(
        axis,
        q_split=attn is not None and split(attn["wq"]),
        kv_split=attn is not None and split(attn["wk"]),
        ff_split=mlp is not None and split(mlp["w_gate"]),
        seq_split=attn is not None and cfg.n_kv_heads % axis.size != 0,
        experts_split=moe is not None and split(moe["w_gate"]),
        ssm_split=frozenset(() if mamba is None else
                            (k for k, sh in mamba.items() if split(sh))))


def model_parallel(cfg: ModelConfig, ctx: ShardCtx | None,
                   rows_split: bool = True) -> ModelParallel | None:
    """None without a mesh.  ``rows_split``: whether the batch's rows
    split over ``data``."""
    if ctx is None or ctx.mesh is None:
        return None
    specs = param_shardings(cfg, ctx.mesh, ctx.rules)
    data, model = mesh_axis(ctx.mesh, "data"), mesh_axis(ctx.mesh, "model")
    tp = shared_tp = None
    vocab_split = False
    if model.size > 1:
        tp = tensor_parallel(model, specs["layers"], cfg)
        if cfg.family == "hybrid":
            shared_tp = tensor_parallel(
                model, specs["shared"], dataclasses.replace(cfg,
                                                            family="dense"))
        vocab_split = model.name in specs["embed"].spec
    return ModelParallel(data, model, specs, tp, vocab_split,
                         data if rows_split else None, shared_tp)


# ============================================================= caches ======
class DecodeCache(NamedTuple):
    """KV caches + SSM states, layer-stacked; unused leaves are ().

    kv_k, kv_v: (L, B, Smax, KV, hd); hybrid (G, B, Smax, KV, hd).
    ssm: a `MambaState` of (L, ...) (hybrid (G, per, ...)) leaves.
    length (a Python int): the current fill.
    """

    kv_k: Any
    kv_v: Any
    ssm: Any
    length: int


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda",
               ctx: ShardCtx | None = None) -> DecodeCache:
    """A zero cache.  Every layer's buffers are allocated (a decode writes
    them in place), where the JAX package broadcasts one zero state; the
    SSM states are float32 whatever ``dtype`` (the KV's) is.  Under
    ``ctx``'s mesh, only this rank's slice of a ``batch``-row cache
    (`cache_specs`)."""
    if ctx is not None and ctx.mesh is not None:
        whole = init_cache(cfg, batch, max_len, dtype, "meta")
        coord = ctx.mesh.get_coordinate()

        def local(t, spec):
            if isinstance(t, tuple):
                return ()
            shape = Sharding(ctx.mesh, spec).local_shape(tuple(t.shape),
                                                         coord)
            return torch.zeros(shape, dtype=t.dtype, device=device)

        specs = cache_specs(whole, ctx.mesh, ctx.rules)
        ssm = whole.ssm if not len(whole.ssm) else MambaState(
            *map(local, whole.ssm, specs.ssm))
        return DecodeCache(local(whole.kv_k, specs.kv_k),
                           local(whole.kv_v, specs.kv_v), ssm, 0)
    kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.family == "ssm":
        st = init_mamba_state(cfg, batch, lead=(cfg.n_layers,),
                              device=device)
        return DecodeCache((), (), st, 0)
    if cfg.family == "hybrid":
        G, per = _groups(cfg)
        st = init_mamba_state(cfg, batch, lead=(G, per), device=device)
        return DecodeCache(
            torch.zeros((G,) + kv_shape, dtype=dtype, device=device),
            torch.zeros((G,) + kv_shape, dtype=dtype, device=device), st, 0)
    shape = (cfg.n_layers,) + kv_shape
    return DecodeCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), (), 0)


# ============================================================ blocks =======
def _dense_block(p, x, cfg, positions, kv_cache, cache_len, positions_thw,
                 n_groups, backend, par=None):
    """One attn + FFN block.  kv_cache: None (full-seq) or (k, v) buffers.
    Returns (x, new_kv, aux): aux is the MoE losses, or None.  ``par``: a
    `ModelParallel` (``p`` holds this rank's slices, whole over data)."""
    tp = par.tp if par is not None else None
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    attn_out, new_kv = L.attention_forward(
        p["attn"], h, cfg, positions, kv_cache, cache_len, positions_thw,
        backend, tp)
    x = x + attn_out
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    aux = None
    if "moe" in p:
        rows, shards = (None, 1) if par is None else (par.rows,
                                                       par.n_shards)
        experts = tp.axis if tp is not None and tp.experts_split else None
        ff, aux = moe_forward(p["moe"], h, cfg, n_groups, rows, shards,
                              experts)
    else:
        ff = L.mlp_forward(p["mlp"], h, tp)
    return x + ff, new_kv, aux


def _ssm_block(p, x, cfg, state, tp=None):
    h = L.rmsnorm(x, p["ln"].to(x.dtype), cfg.norm_eps)
    out, new_state = mamba_forward(p["mamba"], h, cfg, state, tp)
    return x + out, new_state


def _state_at(st: MambaState, idx) -> MambaState:
    """Layer ``idx``'s views of the stacked states."""
    return MambaState(st.conv[idx], st.ssm[idx])


def _write_state(st: MambaState, idx, new: MambaState) -> None:
    """A decode step's new state, into the cache's buffers in place."""
    st.conv[idx].copy_(new.conv)
    st.ssm[idx].copy_(new.ssm)


def _stack_states(states: list, lead: tuple) -> MambaState:
    """Per-layer states, in layer order, stacked to ``lead`` dims."""
    return MambaState(*(torch.stack(f).reshape(lead + f[0].shape)
                        for f in zip(*states)))


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


def take_fill_vocab_parallel(table, ids, n_rows: int, axis: MeshAxis):
    """`take_fill` of an ``n_rows``-row table whose rows are split over
    ``axis`` (``table``: this rank's block): each rank gives the rows it
    holds and zeros, summed over the axis, so every id reads the one row
    `take_fill` reads (wrapped in [-V, -1], NaN outside [-V, V-1])."""
    n = table.shape[0]
    local = normalise_ids(ids, n_rows) - axis.index * n
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[..., None], table[local.clamp(0, n - 1)], 0)
    rows = reduce_sum(rows, axis)
    inside = (ids >= -n_rows) & (ids < n_rows)
    return torch.where(inside[..., None], rows, torch.nan)


def _embed(params, cfg: ModelConfig, batch: dict, par=None):
    """(x, positions, positions_thw or None, loss_mask)."""
    dt = cfg.act_dtype
    tokens = batch["tokens"]
    dev = tokens.device
    table = params["embed"]
    if par is not None:
        table = par.gather_data(table, par.specs["embed"])
    if cfg.family == "audio":
        # (K, V, d); where its vocab splits over model, this rank's block
        # of each codebook's table
        if par is not None and par.vocab_split:
            def rows(k):
                return take_fill_vocab_parallel(table[k], tokens[..., k],
                                                cfg.vocab_size, par.model)
        else:
            def rows(k):
                return take_fill(table[k], tokens[..., k])
        # summed in the parameter dtype, cast once
        x = sum(rows(k) for k in range(cfg.n_codebooks)).to(dt)
        B, S = tokens.shape[:2]
        positions = torch.arange(S, device=dev).expand(B, S)
        return x, positions, None, torch.ones((B, S), dtype=torch.bool,
                                              device=dev)
    if par is not None and par.vocab_split:
        x = take_fill_vocab_parallel(table, tokens, cfg.vocab_size,
                                     par.model).to(dt)
    else:
        x = take_fill(table, tokens).to(dt)
    B, S = tokens.shape
    loss_mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(dt)    # (B, Sv, d) before the text
        x = torch.cat([ve, x], dim=1)
        Sv = ve.shape[1]
        S = S + Sv
        loss_mask = torch.cat([torch.zeros((B, Sv), dtype=torch.bool,
                                           device=dev), loss_mask], dim=1)
    positions = torch.arange(S, device=dev).expand(B, S)
    positions_thw = batch.get("positions_thw") if cfg.m_rope else None
    return x, positions, positions_thw, loss_mask


def _logits(params, cfg: ModelConfig, x):
    """Float32 logits against the float32 (tied) embedding or head(s);
    audio: (B, S, K, V) from its K heads."""
    xf = x.float()
    if cfg.family == "audio":
        return torch.einsum("bsd,kdv->bskv", xf, params["out_head"].float())
    if cfg.tie_embeddings:
        return xf @ params["embed"].float().T
    return xf @ params["out_head"].float()


def head_logits(params, cfg: ModelConfig, x, par: ModelParallel | None):
    """`_logits` of the final hidden states ``x`` under ``par``'s mesh: the
    head gathered over ``data``; where its vocab splits over ``model``,
    each rank's block of the logits, gathered whole over the axis (a
    server samples from every rank's rows).  Serving only: the gather has
    no backward (training takes the loss through `loss_fn`)."""
    if par is None:
        return _logits(params, cfg, x)
    head = par.head(params, cfg)
    (name, leaf), = head.items()
    out = _logits(head, cfg, x)
    vocab_dim = 0 if name == "embed" else leaf.ndim - 1
    if par.model.size > 1 and \
            par.model.name in par.specs[name].split_axes(vocab_dim):
        out = all_gather(out, -1, par.model)
    return out


# ============================================================ forward ======
def forward(params, cfg: ModelConfig, batch: dict,
            cache: DecodeCache | None = None, return_cache: bool = False,
            return_hidden: bool = False, backend: str = "auto",
            moe_groups: int = DEFAULT_MOE_GROUPS, ctx: ShardCtx | None = None,
            rows_split: bool = True):
    """Returns (logits, aux) or (logits, aux, cache_out).

    cache=None: full-sequence forward; with return_cache=True the
    per-layer KV (length S) and final SSM states are collected (prefill).
    cache=DecodeCache: single-token decode (S must be 1); the cache's
    buffers are updated in place (the returned cache shares them) rather
    than copied.  return_hidden=True returns the final-normed hidden
    states in place of the logits.  ``aux`` holds the MoE losses summed
    over layers (zeros in decode, whose layer scan drops them, and for
    the other families) and the ``loss_mask``.  ``backend`` is the flash
    kernel's (`flash_attention`); ``moe_groups`` the routing groups asked
    for.  ``ctx`` with a mesh: ``params`` hold this rank's slices,
    ``batch`` its rows (every row where ``rows_split`` is False) and
    ``cache`` its slice (see the module docstring); a prefill collects
    the kv heads this rank computes, all of them where the cache splits
    its positions over ``model``.
    """
    par = model_parallel(cfg, ctx, rows_split)
    decode = cache is not None
    collect = return_cache and not decode
    x, positions, positions_thw, loss_mask = _embed(params, cfg, batch, par)
    B, S, _ = x.shape
    if decode:
        if S != 1:
            raise ValueError(f"the decode path takes one token per row, got "
                             f"{S}; use prefill for S > 1")
        positions = positions + cache.length
    if cfg.m_rope and positions_thw is None:
        # text-default M-RoPE: t = h = w = (cache-offset) position
        positions_thw = positions[..., None].expand(B, S, 3)
    cache_len = cache.length if decode else None
    zero = torch.zeros((), device=x.device)
    aux = {"balance_loss": zero, "z_loss": zero}
    remat = cfg.remat and not decode and _builds_graph(params)
    lp = params["layers"]
    tp = par.tp if par is not None else None
    cache_out = None

    def layer_leaves(p, specs, lead):
        """A layer's slices, gathered over data (inside its remat region:
        a recompute gathers again)."""
        return p if par is None else par.gather_data(p, specs, lead)

    if cfg.family == "ssm":
        states = []

        def ssm_layer(pi, x, st):
            return _ssm_block(layer_leaves(pi, lp_specs, 1), x, cfg, st,
                              tp)

        lp_specs = par.specs["layers"] if par is not None else None
        ssm_block = _remat(ssm_layer, remat)
        for i, pi in enumerate(unstack_layers(lp)):
            st = _state_at(cache.ssm, i) if decode else None
            x, nst = ssm_block(pi, x, st)
            if decode:
                _write_state(cache.ssm, i, nst)
            elif collect:
                states.append(nst)
        if decode:
            cache_out = cache._replace(length=cache.length + S)
        elif collect:
            cache_out = DecodeCache(
                (), (), _stack_states(states, (cfg.n_layers,)), S)

    elif cfg.family == "hybrid":
        G, per = _groups(cfg)
        dense_cfg = dataclasses.replace(cfg, family="dense")
        # the shared block's own layout over model
        shared_par = par if par is None else dataclasses.replace(
            par, tp=par.shared_tp)

        def group_body(x, pg, g):
            """``per`` SSM layers, then the shared block: (x, the SSM
            layers' new states, the shared block's (k, v))."""
            if par is not None:
                pg = par.gather_data(pg, par.specs["layers"], 1)
                shared = par.gather_data(params["shared"],
                                         par.specs["shared"])
            else:
                shared = params["shared"]
            nsts = []
            for j, pj in enumerate(unstack_layers(pg)):
                st = _state_at(cache.ssm, (g, j)) if decode else None
                x, nst = _ssm_block(pj, x, cfg, st, tp)
                if decode:
                    _write_state(cache.ssm, (g, j), nst)
                nsts.append(nst)
            kv = (cache.kv_k[g], cache.kv_v[g]) if decode else None
            x, nkv, _ = _dense_block(shared, x, dense_cfg,
                                     positions, kv, cache_len, positions_thw,
                                     moe_groups, backend, shared_par)
            return x, nsts, nkv

        group_body = _remat(group_body, remat)
        states, ks, vs = [], [], []
        for g, pg in enumerate(unstack_layers(lp)):
            x, nsts, nkv = group_body(x, pg, g)
            if collect:
                states.extend(nsts)
                ks.append(nkv[0])
                vs.append(nkv[1])
        if decode:
            cache_out = cache._replace(length=cache.length + S)
        elif collect:
            cache_out = DecodeCache(torch.stack(ks), torch.stack(vs),
                                    _stack_states(states, (G, per)), S)

    else:  # dense / moe / vlm / audio
        ks, vs = [], []

        def dense_layer(pi, x, kv):
            return _dense_block(
                layer_leaves(pi, lp_specs, 1), x, cfg, positions, kv,
                cache_len, positions_thw, moe_groups, backend, par)

        lp_specs = par.specs["layers"] if par is not None else None
        block = _remat(dense_layer, remat)
        for i, pi in enumerate(unstack_layers(lp)):
            kv = (cache.kv_k[i], cache.kv_v[i]) if decode else None
            x, nkv, layer_aux = block(pi, x, kv)
            if layer_aux is not None and not decode:
                aux = {k: aux[k] + layer_aux[k] for k in aux}
            if collect:
                ks.append(nkv[0])
                vs.append(nkv[1])
        if decode:
            cache_out = cache._replace(length=cache.length + S)
        elif collect:
            cache_out = DecodeCache(torch.stack(ks), torch.stack(vs), (), S)

    x = L.rmsnorm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    aux["loss_mask"] = loss_mask
    out = x if return_hidden else head_logits(params, cfg, x, par)
    if decode or collect:
        return out, aux, cache_out
    return out, aux
