"""Public model API: parameters, the training loss, prefill and decode
steps, and a smoke batch.

Runs on the GPU unless the caller asks for the CPU (``device="cpu"``);
the loss and the steps run wherever the parameters live.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.template import axes_tree, init_params
from repro_torch.models.transformer import (  # noqa: F401 (re-exported)
    DecodeCache, _logits, forward, head_logits, init_cache, model_parallel,
    model_template, param_shardings,
)
from repro_torch.sharding.collectives import (
    MeshAxis, all_reduce_, grad_sum, mesh_axis, reduce_sum,
)
from repro_torch.sharding.partition import ShardCtx, batch_lead


# ------------------------------------------------------------- params ------
def model_param_axes(cfg: ModelConfig):
    """The logical-axes tuple of every parameter, in their tree."""
    return axes_tree(model_template(cfg))


def model_init_params(cfg: ModelConfig, generator: torch.Generator,
                      device="cuda", shardings=None, coordinate=None):
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (a `torch.Generator` on that device).  With
    ``shardings`` (a tree of `Sharding`) and a mesh ``coordinate``, each
    leaf is this rank's slice of the one-device draw (`init_params`)."""
    return init_params(model_template(cfg), generator, cfg.param_dtype,
                       device, shardings, coordinate)


# --------------------------------------------------------------- loss ------
MOE_AUX_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-3


def _lse_and_label_logit(logits, labels):
    """logsumexp(logits) and logits[label] at each position: the label
    logit picked by an iota compare and a select-sum, as the JAX package
    picks it (a label outside [0, V) picks 0)."""
    lse = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.where(iota == labels[..., None], logits, 0).sum(-1)
    return lse, ll


def _lse_and_label_logit_vocab_parallel(logits, labels, axis: MeshAxis):
    """`_lse_and_label_logit` of logits whose vocab is split over
    ``axis`` (``logits``: this rank's block of columns): the max and the
    sum of exponentials over every block, and the label's logit from the
    rank that holds it."""
    n = logits.shape[-1]
    mx = all_reduce_(logits.detach().amax(-1), axis, dist.ReduceOp.MAX)
    lse = torch.log(reduce_sum(torch.exp(logits - mx[..., None]).sum(-1),
                               axis)) + mx
    iota = torch.arange(axis.index * n, (axis.index + 1) * n,
                        device=logits.device)
    ll = reduce_sum(torch.where(iota == labels[..., None], logits, 0).sum(-1),
                    axis)
    return lse, ll


def cross_entropy(logits, labels, mask):
    """Mean next-token loss over the masked positions.

    logits (..., V) float32, labels (...) int, mask (...) bool.
    """
    lse, ll = _lse_and_label_logit(logits, labels)
    nll = (lse - ll) * mask
    return nll.sum() / mask.sum().clamp(min=1)


def chunked_xent(params, x, labels, cfg: ModelConfig, n_chunks: int = 8,
                 par=None):
    """Head projection + cross-entropy in sequence chunks.

    Each chunk's (B, S / nc, V) float32 logits are computed under
    `torch.utils.checkpoint` and recomputed in backward (the JAX
    package's ``jax.checkpoint`` of its scan body), so one chunk's block
    is live at a time.  ``nc`` is the largest count up to ``n_chunks``
    that divides S.  Returns the mean over all B * S positions.  With
    ``par`` (a `ModelParallel`) the head is gathered over ``data`` once,
    and where the vocab is split over ``model`` each rank computes its
    block of the logits (V / model columns a chunk).
    """
    B, S, _ = x.shape
    nc = n_chunks
    while S % nc:
        nc -= 1
    vocab_split = par is not None and par.vocab_split
    if par is not None:
        params = par.head(params, cfg)
    if vocab_split:
        x = grad_sum(x, par.model)

    def body(xc, lc):
        logits = _logits(params, cfg, xc)
        lse, ll = (_lse_and_label_logit_vocab_parallel(logits, lc, par.model)
                   if vocab_split else _lse_and_label_logit(logits, lc))
        return (lse - ll).sum()

    tot = torch.zeros((), device=x.device)
    for xc, lc in zip(x.chunk(nc, dim=1), labels.chunk(nc, dim=1)):
        tot = tot + torch.utils.checkpoint.checkpoint(
            body, xc, lc, use_reentrant=False)
    return tot / (B * S)


def audio_xent(params, x, labels, cfg: ModelConfig, par):
    """audio's loss: the mean cross-entropy over the (B, S, K, V) logits of
    its K heads, from the final hidden states ``x``.  Where the vocab
    splits over ``model`` (``par.vocab_split``), each rank computes its
    (B, S, K, V / model) block of the logits, and the log-sum-exp and
    each label's logit are reduced over the axis, codebook by codebook."""
    head = par.head(params, cfg)
    x = grad_sum(x, par.model)
    logits = _logits(head, cfg, x)
    lse, ll = _lse_and_label_logit_vocab_parallel(logits, labels, par.model)
    return (lse - ll).sum() / labels.numel()


def loss_fn(params, batch, cfg: ModelConfig, backend: str = "auto",
            ctx: ShardCtx | None = None):
    """The training loss of ``batch`` ({tokens, labels}; vlm also
    vision_embeds): (loss, {"loss": loss}).

    audio: cross-entropy over the (B, S, K, V) logits of its K heads
    (`audio_xent` where the vocab splits over ``model``); vlm: over the
    text positions only (the patch prefix is input only); the other
    families through `chunked_xent`; moe adds
    ``MOE_AUX_WEIGHT * balance_loss + Z_LOSS_WEIGHT * z_loss``.
    ``backend`` is the flash kernel's (`forward`).  Under ``ctx``'s mesh
    (``params``: this rank's slices, ``batch``: its equal share of the
    rows) the loss is this rank's share of the global batch's: the shares
    sum over ``data`` to it, and so do their gradients.
    """
    par = model_parallel(cfg, ctx)
    labels = batch["labels"]
    if cfg.family == "audio" and par is not None and par.vocab_split:
        x, aux = forward(params, cfg, batch, return_hidden=True,
                         backend=backend, ctx=ctx)
        loss = audio_xent(params, x, labels, cfg, par)
    elif cfg.family == "audio":
        logits, aux = forward(params, cfg, batch, backend=backend, ctx=ctx)
        mask = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
        loss = cross_entropy(logits, labels, mask)
    else:
        x, aux = forward(params, cfg, batch, return_hidden=True,
                         backend=backend, ctx=ctx)
        if cfg.family == "vlm":
            x = x[:, -labels.shape[1]:]
        loss = chunked_xent(params, x, labels, cfg, par=par)
    if par is not None:
        loss = loss / par.data.size
    if cfg.family == "moe":
        loss = loss + MOE_AUX_WEIGHT * aux["balance_loss"] \
            + Z_LOSS_WEIGHT * aux["z_loss"]
    return loss, {"loss": loss}


# ----------------------------------------------------- a rank's rows -------
def local_rows(batch: dict, grad_accum: int, data: MeshAxis) -> dict:
    """This ``data`` rank's rows of the global batch: of each of the
    ``grad_accum`` micro-batches (runs of rows along dim 0), its
    coordinate's equal share, so that its k-th local micro-batch is its
    share of the global k-th."""
    def cut(v):
        B = v.shape[0]
        if B % (grad_accum * data.size):
            raise ValueError(f"a global batch of {B} does not split into "
                             f"{grad_accum} micro-batches over {data.size} "
                             f"data ranks")
        b = B // (grad_accum * data.size)
        rest = tuple(v.shape[1:])
        return v.reshape((grad_accum, data.size, b) + rest)[:, data.index] \
            .reshape((grad_accum * b,) + rest)
    return {k: cut(v) for k, v in batch.items()}


def _rows(batch: dict, ctx: ShardCtx | None) -> tuple[dict, bool]:
    """This ``data`` rank's rows of a global batch, and whether they split
    (`batch_lead`: where the data extent does not divide the rows, every
    rank takes all of them)."""
    if ctx is None or ctx.mesh is None:
        return batch, True
    if batch_lead(ctx.mesh, ctx.rules,
                  next(iter(batch.values())).shape[0]) is None:
        return batch, False
    return local_rows(batch, 1, mesh_axis(ctx.mesh, "data")), True


# ------------------------------------------------------------ serving ------
def prefill_step(params, batch, cfg: ModelConfig, max_len: int,
                 cache_dtype=torch.bfloat16, backend: str = "auto",
                 ctx: ShardCtx | None = None):
    """Full-sequence prefill that fills a fresh KV / SSM cache.

    Collects the per-layer KV and pads it into ``max_len`` decode buffers
    of ``cache_dtype``; SSM states are carried as they are (float32
    recurrent state; the conv window in the activation dtype), and an
    attention-free model keeps no KV.  Returns (last_token_logits, cache):
    (B, V), audio (B, K, V).  Only the last position's logits are
    computed (the JAX package computes all S and keeps the last: the same
    value, without a (B, S, V) float32 tensor).

    Under ``ctx``'s mesh ``params`` hold this rank's slices
    (`param_shardings`) and ``batch`` is the global batch, of which the
    rank serves its rows (all of them where they do not split over
    ``data``): the logits are those rows' (whole over the vocab), and the
    cache is the rank's slice of theirs (`cache_specs`; where it splits
    the sequence, the prompt positions that fall in the rank's run).
    """
    rows, split = _rows(batch, ctx)
    par = model_parallel(cfg, ctx, split)
    # this rank's slice of the cache (which may refuse the mesh) first
    place = None if par is None else init_cache(
        cfg, next(iter(batch.values())).shape[0], max_len, cache_dtype,
        "meta", ctx)
    x, _, c = forward(params, cfg, rows, return_cache=True,
                      return_hidden=True, backend=backend, ctx=ctx,
                      rows_split=split)
    if c.length > max_len:
        raise ValueError(f"a prompt of {c.length} tokens does not fit a "
                         f"cache of {max_len}")

    def pad_kv(kv, like):
        if isinstance(kv, tuple):          # () : no KV (ssm)
            return ()
        Ls, B, S, KV, hd = kv.shape
        shape = (Ls, B, max_len, KV, hd) if like is None else like.shape
        buf = torch.zeros(shape, dtype=cache_dtype, device=kv.device)
        n = shape[2]
        # where the sequence splits over model, this rank's run of it
        lo = 0 if n == max_len else par.model.index * n
        hi = min(lo + n, S)
        if hi > lo:
            buf[:, :, :hi - lo] = kv[:, :, lo:hi]
        return buf

    like = (None, None) if place is None else (place.kv_k, place.kv_v)
    cache = DecodeCache(pad_kv(c.kv_k, like[0]), pad_kv(c.kv_v, like[1]),
                        c.ssm, c.length)
    return head_logits(params, cfg, x[:, -1:], par)[:, -1], cache


def decode_step(params, cache: DecodeCache, tokens, cfg: ModelConfig,
                backend: str = "auto", ctx: ShardCtx | None = None):
    """One-token decode against an existing cache.

    tokens: (B, 1), audio (B, 1, K).  Returns (logits, new_cache); the new
    cache shares the old one's buffers, which this call updates in place.
    Under ``ctx``'s mesh, as `prefill_step`: ``tokens`` are the global
    batch's, ``cache`` the rank's slice, the logits its rows'.
    """
    rows, split = _rows({"tokens": tokens}, ctx)
    logits, _, new_cache = forward(params, cfg, rows, cache=cache,
                                   backend=backend, ctx=ctx,
                                   rows_split=split)
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
