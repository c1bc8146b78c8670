"""Mamba2 / SSD (state-space duality) layer: the chunked scan formulation.

Within a chunk the recurrence is computed as masked matmuls (the
"attention duality"); across chunks a loop carries the (H, P, N) state.
Scalar-per-head decay a_t = exp(-softplus(dt) * exp(A_log)), B/C shared
across heads (single group), depthwise causal conv on x/B/C, as the JAX
package computes them.

Decode keeps (conv window, SSM state) per layer: O(1) per token.
`ssd_reference` (the naive sequential recurrence) is the oracle the tests
hold `ssd_chunked` against.

Tensor parallelism over the mesh's ``model`` axis (`mamba_forward` with a
`layers.TensorParallel`).  The JAX package's rules split ``ssm_inner``
and ``ssm_heads`` over it, and its GSPMD places the rest.  Here each rank
runs the SSD scan for its own heads, which is where the work is:

  - ``A_log`` / ``dt_bias`` / ``D`` split by heads, and so do the
    ``(B, H, P, N)`` state, ``norm`` and ``w_out``'s rows, whose
    ``d_inner`` is head-major: a contiguous block of it is whole heads
    when H divides by the axis;
  - ``w_in``'s fused ``2 d_inner + 2 N + H`` columns and the conv's
    ``d_inner + 2 N`` channels are cut by the rules into blocks that cross
    z, x, B, C and dt, so they are gathered whole (their gradient
    reduce-scattered back) and each rank takes its heads' z, x and dt
    columns and all of B and C, which every head reads; where the input
    has fewer rows than ``d`` (a decode step), each rank projects onto
    its block of ``w_in``'s columns and the projection is gathered
    instead, the fewer bytes;
  - the gated RMSNorm's sum of squares over ``d_inner`` is summed over
    the axis (and so is its gradient: every rank's block depends on it);
  - ``w_out`` runs row-parallel, its partial products summed over the
    axis, and the input's gradient is summed as in Megatron's MLP;
  - the decode cache keeps the rules' placement
    (`sharding.partition.cache_specs`): the conv window splits its
    ``d_inner + 2 N`` channels in contiguous blocks, which do not follow
    heads, so each step gathers the window whole, and each rank keeps the
    block of the new window its slice holds (every rank computes x, B and
    C of every channel for that).

Where the heads do not divide by the axis, every rank runs every head
from the whole leaves (gathered with the slice backward of
`gather_replicated`) and nothing is summed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import TensorParallel, rmsnorm, silu
from repro_torch.models.template import Leaf
from repro_torch.sharding.collectives import (
    all_gather, gather, gather_replicated, grad_sum, reduce_sum,
)


def mamba_template(cfg: ModelConfig, stacked: tuple = ()) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    K = cfg.ssm_conv
    st = stacked
    sta = tuple("layers" for _ in stacked)
    conv_dim = di + 2 * N
    return {
        "w_in": Leaf(st + (d, 2 * di + 2 * N + H), sta + ("embed", "ssm_inner")),
        "conv_w": Leaf(st + (K, conv_dim), sta + ("conv", "ssm_inner"),
                       init="normal", scale=0.5),
        "conv_b": Leaf(st + (conv_dim,), sta + ("ssm_inner",), init="zeros"),
        "A_log": Leaf(st + (H,), sta + ("ssm_heads",), init="zeros"),
        "dt_bias": Leaf(st + (H,), sta + ("ssm_heads",), init="zeros"),
        "D": Leaf(st + (H,), sta + ("ssm_heads",), init="ones"),
        "norm": Leaf(st + (di,), sta + ("ssm_inner",), init="ones"),
        "w_out": Leaf(st + (di, d), sta + ("ssm_inner", "embed")),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor  # (..., B, K-1, conv_dim) the conv window's inputs
    ssm: torch.Tensor   # (..., B, H, P, N) recurrent state (float32)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     lead: tuple = (), device="cuda") -> MambaState:
    """Zero states, with ``lead`` leading (layer) dimensions allocated in
    full: a decode writes each layer's state in place."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    conv_dim = di + 2 * N
    return MambaState(
        conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                         dtype=dtype, device=device),
        ssm=torch.zeros(lead + (batch, H, P, N), dtype=torch.float32,
                        device=device),
    )


def _split_proj(zxbcdt, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, prev=None):
    """Depthwise causal conv1d.  xbc: (B, S, C); conv_w: (K, C).

    prev: (B, K-1, C) left context (decode); returns (out, new_prev).
    ``cat`` promotes as jnp.concatenate does: a float32 ``prev`` (a fresh
    decode cache) makes the conv float32, one in xbc's dtype keeps it.
    """
    B, S, C = xbc.shape
    K = conv_w.shape[0]
    if prev is None:
        prev = torch.zeros((B, K - 1, C), dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prev, xbc], dim=1)          # (B, S+K-1, C)
    out = torch.zeros((B, S, C), dtype=xbc.dtype, device=xbc.device)
    for i in range(K):                          # K adds, in the JAX order
        out = out + xp[:, i: i + S] * conv_w[i]
    out = silu(out + conv_b)
    return out, xp[:, -(K - 1):]


def ssd_chunked(x, dt, A, B_, C, chunk: int, state0=None):
    """Chunked SSD scan.

    x:  (B, S, H, P) inputs per head
    dt: (B, S, H)    softplus-ed timestep (>0)
    A:  (H,)         negative decay rate (A = -exp(A_log))
    B_: (B, S, N)    input projection (single group, shared across heads)
    C:  (B, S, N)    output projection
    Returns y (B, S, H, P), final state (B, H, P, N).

    Recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T;  y_t = C_t h_t.
    """
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked needs S a multiple of the chunk "
                         f"{Q}, got S {S}")
    nc = S // Q
    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = B_.reshape(Bb, nc, Q, N)
    Cc = C.reshape(Bb, nc, Q, N)

    la = dtc * A                                 # log decay per step
    cum = torch.cumsum(la, dim=2)                # within-chunk cumulative

    # --- intra-chunk (dual/attention form) ---------------------------------
    # M[t, s] = exp(cum[t] - cum[s]) for t >= s else 0
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qt,Qs,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.where(tri[:, :, None], torch.exp(diff), 0.0)
    del diff
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)  # shared across heads
    W = G[..., None] * Lmat                      # (B,nc,Q,Q,H)
    del Lmat
    xdt = xc * dtc[..., None]                    # dt-weighted input
    y_intra = torch.einsum("bctsh,bcshp->bcthp", W, xdt)
    del W, xdt

    # --- chunk states -------------------------------------------------------
    # sum_s exp(cum[Q-1] - cum[s]) dt_s B_s x_s^T, as two products (no
    # (B, nc, Q, H, P, N) intermediate)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # (B,nc,Q,H)
    wx = xc * (decay_to_end * dtc)[..., None]           # (B,nc,Q,H,P)
    SB = torch.einsum("bcshp,bcsn->bchpn", wx, Bc)      # (B,nc,H,P,N)
    del wx
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B,nc,H)

    h = state0 if state0 is not None else torch.zeros(
        (Bb, H, P, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):                 # emit the state *before* chunk c
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + SB[:, c]
    del SB
    h_prevs = torch.stack(h_prevs, dim=1)               # (B,nc,H,P,N)

    # --- inter-chunk --------------------------------------------------------
    # y_inter[t] = exp(cum[t]) * C_t @ h_prev
    y_inter = torch.einsum("bctn,bchpn->bcthp", Cc, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y, h


def ssd_reference(x, dt, A, B_, C, state0=None):
    """Naive sequential recurrence (oracle for tests)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    h = state0 if state0 is not None else torch.zeros(
        (Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)                       # (B,H)
        h = h * a[:, :, None, None] + _outer(dt[:, t], x[:, t], B_[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], h))
    return torch.stack(ys, dim=1), h


def _outer(dt, x, B_):
    """dt (B, H), x (B, H, P), B_ (B, N) -> dt x B^T (B, H, P, N)."""
    return (dt[:, :, None] * x)[..., None] * B_[:, None, None, :]


def mamba_forward(p, x, cfg: ModelConfig, state: MambaState | None = None,
                  tp: TensorParallel | None = None):
    """Mamba2 block.  x: (B, S, d).  state!=None -> stateful (decode).
    With ``tp`` (a model axis above 1), ``p`` and ``state`` hold this
    rank's slices (`_mamba_tp`).

    Returns (out, new_state).
    """
    if tp is not None:
        return _mamba_tp(p, x, cfg, state, tp)
    B, S, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype
    zxbcdt = x @ p["w_in"].to(dt_)
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    prev = state.conv if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(dt_),
                                 p["conv_b"].to(dt_), prev)
    xin = xbc[..., :di]
    B_ = xbc[..., di: di + N].float()
    C = xbc[..., di + N:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, S, H, P).float()

    state0 = state.ssm if state is not None else None
    if S == 1 and state is not None:
        # O(1) decode recurrence
        a = torch.exp(dt[:, 0] * A)
        h = state0 * a[:, :, None, None] + _outer(dt[:, 0], xh[:, 0],
                                                  B_[:, 0])
        y = torch.einsum("bn,bhpn->bhp", C[:, 0], h)[:, None]
        h_final = h
    else:
        y, h_final = ssd_chunked(xh, dt, A, B_, C, cfg.ssm_chunk, state0)
    y = y + xh * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, di).to(dt_)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = rmsnorm(y * silu(z), p["norm"].to(dt_), cfg.norm_eps)
    out = y @ p["w_out"].to(dt_)
    return out, MambaState(conv=new_conv, ssm=h_final)


def _mamba_tp(p, x, cfg: ModelConfig, state: MambaState | None,
              tp: TensorParallel):
    """`mamba_forward` under tensor parallelism (the module docstring):
    this rank's heads [h0, h0 + nh), or every head where H does not
    divide by the axis; ``state`` and the returned state are this rank's
    slices of the cache's."""
    ax = tp.axis
    B, S, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cd, K = di + 2 * N, cfg.ssm_conv
    dt_ = x.dtype
    part = H % ax.size == 0             # each rank its heads' share
    nh = H // ax.size if part else H
    h0 = ax.index * nh if part else 0
    if part:
        x = grad_sum(x, ax)

    def whole(name, dim=-1):
        """A leaf whole along ``dim``: gathered where split, its gradient
        reduce-scattered (each rank runs a share of the layer from it) or
        kept as this rank's block (each rank runs all of it)."""
        if name in tp.ssm_split:
            return (gather if part else gather_replicated)(p[name], dim, ax)
        return grad_sum(p[name], ax) if part else p[name]

    def heads(name, dim=-1, unit=1):
        """The block of this rank's heads of a leaf split by heads (unit
        1) or by head-major d_inner (unit P)."""
        if part and name in tp.ssm_split:
            return p[name]
        return whole(name, dim).narrow(dim, h0 * unit, nh * unit)

    if part and "w_in" in tp.ssm_split and B * S < d:
        # fewer rows than d (a decode step): the projection's columns
        # gathered, not the weight's
        zxbcdt = gather(x @ p["w_in"].to(dt_), -1, ax)
    else:
        zxbcdt = x @ whole("w_in").to(dt_)
    z = zxbcdt[..., h0 * P:(h0 + nh) * P]
    xbc = zxbcdt[..., di:di + cd]
    dt_raw = zxbcdt[..., di + cd + h0:di + cd + h0 + nh]
    prev = None if state is None else state.conv
    if prev is not None and prev.shape[-1] != cd:
        prev = all_gather(prev, -1, ax)
    # the conv of this rank's x channels and of every B / C channel
    keep = torch.cat([torch.arange(h0 * P, (h0 + nh) * P),
                      torch.arange(di, cd)]).to(x.device)
    conv_out, _ = _causal_conv(
        xbc[..., keep], whole("conv_w").to(dt_)[:, keep],
        whole("conv_b").to(dt_)[keep],
        None if prev is None else prev[..., keep])
    # the new window of every channel, and this rank's block of it
    if prev is None:
        prev = torch.zeros((B, K - 1, cd), dtype=xbc.dtype, device=x.device)
    new_conv = torch.cat([prev, xbc], dim=1)[:, -(K - 1):]
    if "conv_b" in tp.ssm_split:
        n = cd // ax.size
        new_conv = new_conv[..., ax.index * n:(ax.index + 1) * n]
    xin = conv_out[..., :nh * P]
    B_ = conv_out[..., nh * P:nh * P + N].float()
    C = conv_out[..., nh * P + N:].float()
    dt = F.softplus(dt_raw.float() + heads("dt_bias").float())
    A = -torch.exp(heads("A_log").float())
    xh = xin.reshape(B, S, nh, P).float()
    state0 = state.ssm if state is not None else None
    if S == 1 and state is not None:
        a = torch.exp(dt[:, 0] * A)
        h = state0 * a[:, :, None, None] + _outer(dt[:, 0], xh[:, 0],
                                                  B_[:, 0])
        y = torch.einsum("bn,bhpn->bhp", C[:, 0], h)[:, None]
        h_final = h
    else:
        y, h_final = ssd_chunked(xh, dt, A, B_, C, cfg.ssm_chunk, state0)
    y = y + xh * heads("D").float()[None, None, :, None]
    y = y.reshape(B, S, nh * P).to(dt_)
    v = y * silu(z)
    scale = heads("norm", unit=P).to(dt_)
    w_out = heads("w_out", 0, P).to(dt_)
    if not part:
        return (rmsnorm(v, scale, cfg.norm_eps) @ w_out,
                MambaState(conv=new_conv, ssm=h_final))
    # the gated RMSNorm's squares over the whole d_inner, summed over the
    # axis (and so is their gradient: every rank's block reads the sum)
    v32 = v.float()
    ss = grad_sum(reduce_sum((v32 * v32).sum(-1, keepdim=True), ax), ax)
    y = (v32 * torch.rsqrt(ss / di + cfg.norm_eps)).to(dt_) * scale
    return reduce_sum(y @ w_out, ax), MambaState(conv=new_conv, ssm=h_final)
