"""Mixture-of-Experts layer: grouped, sort-based dispatch with capacity.

Tokens are split into routing groups; within a group, expert assignment
is resolved with an argsort + rank-within-segment and tokens are
scattered into a (G, E, C, d) buffer, as in the JAX package.  Under a
mesh the group count is the JAX package's: ``pick_groups`` of the global
token count over the mesh's data x model shards.  Where the rows split
over ``data`` that count is a multiple of the data extent (a data rank's
rows are a run of whole groups, which it routes), and the aux losses are
each rank's share of the global batch's; where every rank holds every
row, each routes all the groups.

Under expert parallelism (``experts``: the ``model`` axis, over which
the router's columns and the experts split, as the JAX package's rules
place them) every rank of the axis routes every group of its rows, from
the router gathered whole, and computes its own experts' slots only; the
slots are gathered over the axis along E, and every rank runs the same
combine.  Both gathers keep this rank's block of the gradient in
backward (`gather_replicated`: every rank repeats what follows them),
and the dispatch input's gradient is summed over the axis (each rank's
experts give a part of it).
Top-k gates are renormalised; capacity overflow drops tokens (the
residual connection carries them).

Three choices keep the result equal to the JAX package's and the same
on every run:
  - the top k come from a stable descending sort, so among equal
    probabilities the lower expert index wins, as ``jax.lax.top_k``;
  - the router multiplies activation-dtype operands in float32;
  - each token's k expert outputs are summed in ascending expert order
    in the activation dtype, one add at a time, with no atomics (the
    order ``y.at[tok].add`` visits them in the expert-sorted updates).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import silu
from repro_torch.models.template import Leaf
from repro_torch.sharding.collectives import (
    MeshAxis, all_reduce_, gather_replicated, grad_sum,
)


def moe_template(cfg: ModelConfig, stacked: tuple = ()) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    st = stacked
    sta = tuple("layers" for _ in stacked)
    return {
        "router": Leaf(st + (d, E), sta + ("embed", "experts"),
                       scale=0.02, fan_in_dims=()),
        "w_gate": Leaf(st + (E, d, f), sta + ("experts", "embed", "ff_expert")),
        "w_up": Leaf(st + (E, d, f), sta + ("experts", "embed", "ff_expert")),
        "w_down": Leaf(st + (E, f, d), sta + ("experts", "ff_expert", "embed")),
    }


def capacity_per_group(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = tokens_per_group * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor
    # round up to a multiple of 8 for friendlier layouts
    return max(8, int(math.ceil(c / 8.0)) * 8)


def pick_groups(n_tokens: int, n_shards: int, requested: int) -> int:
    """Routing-group count: a multiple of the shard count that divides the
    token count where one does, else the largest divisor up to the
    request."""
    G = max(requested, n_shards)
    G = min(G, n_tokens)
    for g in range(G, 0, -1):
        if n_tokens % g == 0 and g % n_shards == 0:
            return g
    for g in range(G, 0, -1):
        if n_tokens % g == 0:
            return g
    return 1


def route(logits: torch.Tensor, k: int):
    """Top-k of the router's softmax: (gate values renormalised, expert
    ids), each (..., k); ties go to the lower expert index."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = vals[..., :k]
    return gate_vals / gate_vals.sum(-1, keepdim=True), idx[..., :k]


def dispatch(expert_idx: torch.Tensor, E: int, C: int):
    """Per group, the expert-sorted order of the (token, choice) items and
    each item's buffer slot: (order, tok_s, slot, keep), each (G, Ng*k).
    ``slot`` is ``E * C`` (the overflow bin) where ``keep`` is False."""
    G, Ng, k = expert_idx.shape
    dev = expert_idx.device
    eid = expert_idx.reshape(G, Ng * k)
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = eid.gather(-1, order)
    tok_s = order // k                 # the token of each sorted item
    experts = torch.arange(E, device=dev, dtype=eid_s.dtype)
    seg_start = torch.searchsorted(eid_s, experts.expand(G, E).contiguous(),
                                   right=False)
    rank = torch.arange(Ng * k, device=dev) - seg_start.gather(-1, eid_s)
    keep = rank < C
    slot = torch.where(keep, eid_s * C + rank.clamp(0, C - 1), E * C)
    return order, tok_s, slot, keep


def moe_forward(p, x, cfg: ModelConfig, n_groups: int,
                data: MeshAxis | None = None, n_shards: int = 1,
                experts: MeshAxis | None = None):
    """x: (B, S, d) -> ((B, S, d), aux losses).  ``data``: the mesh axis
    that splits the batch (x holds this rank's rows of it), None where x
    holds every row; ``n_shards``: the mesh's extent (data x model), which
    the group count is a multiple of where it can be; ``experts``: the
    axis that splits the router's columns and the experts (``p`` holds
    this rank's block of them), or None."""
    B, S, d = x.shape
    dt = x.dtype
    E, k = cfg.n_experts, cfg.moe_top_k
    N = B * S
    D = 1 if data is None else data.size
    G = pick_groups(N * D, n_shards, n_groups)
    if G % D:
        raise ValueError(f"{G} routing groups of {N * D} tokens do not "
                         f"split over {D} data ranks")
    G //= D
    Ng = N // G
    C = capacity_per_group(Ng, cfg)

    xg = x.reshape(G, Ng, d)
    router, xd, e0, ne = p["router"], xg, 0, E
    if experts is not None:
        router = gather_replicated(router, -1, experts)
        xd = grad_sum(xg, experts)
        ne = E // experts.size
        e0 = experts.index * ne
    # router: activation-dtype operands, float32 products and sums
    logits = xg.float() @ router.to(dt).float()
    gate_vals, expert_idx = route(logits, k)             # (G, Ng, k)

    # ---- sort-based dispatch (per group) -----------------------------------
    order, tok_s, slot, _ = dispatch(expert_idx, E, C)
    gate_s = gate_vals.reshape(G, Ng * k).gather(-1, order)
    gi = torch.arange(G, device=x.device)[:, None]
    buf = torch.zeros((G, E * C + 1, d), dtype=dt, device=x.device)
    buf[gi, slot] = xd[gi, tok_s]     # dropped items all land in the bin
    buf = buf[:, :E * C].reshape(G, E, C, d)[:, e0:e0 + ne]

    # ---- expert computation (SwiGLU) ---------------------------------------
    g = torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dt))
    del buf
    h = silu(g) * u
    del g, u
    out_buf = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    del h
    if experts is not None:
        out_buf = gather_replicated(out_buf, 1, experts)

    # ---- combine: each token's k terms in ascending expert order -----------
    flat = torch.cat([out_buf.reshape(G, E * C, d),
                      torch.zeros((G, 1, d), dtype=dt, device=x.device)], 1)
    back = flat[gi, slot] * gate_s[..., None].to(dt)     # (G, Ng*k, d)
    # position of each (token, choice) item in the sorted order; sorted
    # per token, they run in ascending expert id (a token's k are distinct)
    pos = torch.empty_like(order).scatter_(
        -1, order, torch.arange(Ng * k, device=x.device).expand(G, -1))
    pos = pos.reshape(G, Ng, k).sort(-1).values
    y = torch.zeros((G, Ng, d), dtype=dt, device=x.device)
    for j in range(k):
        y = y + back[gi, pos[..., j]]

    aux = router_z_and_balance_loss(logits, expert_idx, E, data)
    return y.reshape(B, S, d), aux


def router_z_and_balance_loss(logits, expert_idx, E: int,
                              data: MeshAxis | None = None):
    """Standard aux losses: load-balance (switch-style) + router z-loss.

    With ``data`` (each rank holding an equal share of the tokens) the
    top-1 fractions are the global batch's, and each loss is this rank's
    share: the shares sum over the axis to the global batch's losses, and
    so do their gradients."""
    probs = torch.softmax(logits, dim=-1)                # (G, Ng, E)
    me = probs.mean(dim=(0, 1))
    one_hot = F.one_hot(expert_idx[..., 0], E).float()   # top-1 counts
    ce = one_hot.mean(dim=(0, 1))
    if data is not None:
        ce = all_reduce_(ce, data) / data.size
    balance = E * (me * ce).sum()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    if data is not None:
        balance, z = balance / data.size, z / data.size
    return {"balance_loss": balance, "z_loss": z}
