"""repro_torch's training loss and its gradients against repro on the CPU.

For each of the ten smoke configs in float32, `loss_fn` and every
gradient leaf against repro's ``jax.value_and_grad(loss_fn)`` from the
same parameters (one numpy tree, drawn from a seed, given to repro and
carried across with `lm_params_from_jax`) and the same numpy batch, at
256 positions (the blockwise attention route of the smoke configs' 64-wide
blocks; vlm 64 patch embeddings + 192 text tokens).  Remat on and off
give equal results.  The flash kernel's wrapper refuses autograd, and
the plain attention's gradient matches repro's.

Tolerances: the loss within 1e-5 relative (float32 sums in another
order), each gradient leaf within 2e-4 of its largest entry plus 1e-7
(a gradient sums over every position and layer in another order than
XLA's; moe adds the routing's gathers and scatters); a bf16 leaf
(kimi-k2's bf16 parameters) within one bf16 ulp (2^-7 relative) of
its largest entry plus one of each entry: both packages accumulate a
gathered embedding row's gradient in bf16, in other orders.  Remat on
and off: the same loss, and gradients within 1e-6 of each leaf's
largest entry (the recomputed graph sums the residual stream's
gradients in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.model import (
    chunked_xent, cross_entropy, loss_fn, model_init_params,
)
from repro_torch.models.template import init_params
from repro_torch.models.transformer import model_template

B, S = 2, 256
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-7


def _configs(name, **kw):
    jc = dataclasses.replace(jax_smoke_config(name), dtype="float32", **kw)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _batch(cfg, seed):
    """numpy batch in repro's smoke layout: labels are the tokens (audio)
    or a fresh draw; vlm: max(4, S // 4) bf16 patch embeddings first."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        t = rng.integers(0, cfg.vocab_size, (B, S, cfg.n_codebooks),
                         dtype=np.int32)
        return {"tokens": t, "labels": t}
    if cfg.family == "vlm":
        sv = max(4, S // 4)
        ve = (rng.standard_normal((B, sv, cfg.d_model), dtype=np.float32)
              * 0.02)
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - sv),
                                       dtype=np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S - sv),
                                       dtype=np.int32),
                "vision_embeds": ve}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32)}


def _jax_batch(nb):
    out = {k: jnp.asarray(v) for k, v in nb.items()}
    if "vision_embeds" in out:
        out["vision_embeds"] = out["vision_embeds"].astype(jnp.bfloat16)
    return out


def _torch_batch(nb):
    out = {k: torch.as_tensor(v) for k, v in nb.items()}
    if "vision_embeds" in out:
        out["vision_embeds"] = out["vision_embeds"].to(torch.bfloat16)
    return out


def _params(tc, seed):
    """One random parameter tree as numpy (bf16 leaves as ml_dtypes): for
    repro as it is, and for this package through `lm_params_from_jax`."""
    tp = init_params(model_template(tc), torch.Generator().manual_seed(seed),
                     tc.param_dtype, "cpu")

    def to_np(t):
        if isinstance(t, dict):
            return {k: to_np(v) for k, v in t.items()}
        if t.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
        return t.numpy()
    np_tree = to_np(tp)
    return (jax.tree.map(jnp.asarray, np_tree),
            lm_params_from_jax(np_tree, tc))


def _as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _torch_value_and_grad(tp, tc, batch):
    leaves = dict(_flat(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, aux = loss_fn(tp, batch, tc)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), aux, dict(zip(leaves, grads))


@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_loss_and_grads_match_repro(name):
    jc, tc = _configs(name)
    jp, tp = _params(tc, seed=1)
    nb = _batch(tc, seed=2)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jc), has_aux=True))(jp, _jax_batch(nb))
    tloss, taux, tgrads = _torch_value_and_grad(tp, tc, _torch_batch(nb))
    assert tloss.isfinite()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]),
                               rtol=LOSS_RTOL)
    jflat = dict(_flat(jgrads))
    assert set(jflat) == set(tgrads)
    for path, jg in jflat.items():
        bf16 = tgrads[path].dtype == torch.bfloat16
        assert bf16 == (jg.dtype == jnp.bfloat16), path
        tg, jg = tgrads[path].float().numpy(), _as_f32(jg)
        assert tg.shape == jg.shape, path
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(
            tg, jg, rtol=2 ** -7 if bf16 else 0,
            atol=(2 ** -7 if bf16 else GRAD_RTOL) * scale + GRAD_ATOL,
            err_msg=f"{name}: d loss / d {path}")


@pytest.mark.parametrize("name", ["stablelm-3b", "llama4-scout-17b-a16e",
                                  "zamba2-2.7b", "mamba2-2.7b"])
def test_remat_gives_equal_loss_and_grads(name):
    """Remat recomputes each layer body (hybrid: each group) in backward;
    the values are the ones the stored activations would give."""
    results = []
    for remat in (False, True):
        _, tc = _configs(name, remat=remat)
        gen = torch.Generator().manual_seed(3)
        tp = model_init_params(tc, gen, device="cpu")
        results.append(_torch_value_and_grad(tp, tc,
                                             _torch_batch(_batch(tc, 4))))
    (l0, _, g0), (l1, _, g1) = results
    assert torch.equal(l0, l1)
    for path in g0:
        torch.testing.assert_close(g1[path], g0[path], rtol=0,
                                   atol=1e-6 * g0[path].abs().max().item())


def test_remat_recomputes_under_checkpoint(monkeypatch):
    """With cfg.remat a layer body runs once in forward and once more in
    backward; without it, and in a forward that builds no graph, once."""
    from repro_torch.models import transformer as T
    calls = []
    orig = T._dense_block

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(T, "_dense_block", counting)
    for remat, grad, want in ((True, True, 4), (False, True, 2),
                              (True, False, 2)):
        calls.clear()
        _, tc = _configs("stablelm-3b", remat=remat)
        tp = model_init_params(tc, torch.Generator().manual_seed(0),
                               device="cpu")
        nb = _torch_batch(_batch(tc, 5))
        for t in dict(_flat(tp)).values():
            t.requires_grad_(grad)
        loss, _ = loss_fn(tp, nb, tc)
        if grad:
            loss.backward()
        assert len(calls) == want, (remat, grad, len(calls))


def test_cross_entropy_matches_repro():
    from repro.models.model import cross_entropy as jax_xent
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 7, 50), dtype=np.float32) * 3
    labels = rng.integers(-2, 52, (3, 7)).astype(np.int32)  # some outside V
    mask = rng.random((3, 7)) < 0.7
    want = float(jax_xent(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(mask)))
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                        torch.as_tensor(mask))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    empty = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                          torch.zeros((3, 7), dtype=torch.bool))
    assert empty.item() == 0.0


@pytest.mark.parametrize("seq", [64, 60, 7])
def test_chunked_xent_matches_repro(seq):
    """S a multiple of 8, and S with fewer chunks (60 -> 6, 7 -> 7)."""
    from repro.models.model import chunked_xent as jax_chunked
    from repro.sharding.partition import ShardCtx
    jc, tc = _configs("yi-6b")
    jp, tp = _params(tc, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, seq, tc.d_model), dtype=np.float32)
    labels = rng.integers(0, tc.vocab_size, (2, seq)).astype(np.int32)
    want = float(jax_chunked(jp, jnp.asarray(x), jnp.asarray(labels), jc,
                             ShardCtx()))
    got = chunked_xent(tp, torch.as_tensor(x), torch.as_tensor(labels), tc)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_flash_kernel_refuses_autograd(monkeypatch):
    """The kernel has no backward: with q, k or v requiring grad under
    grad mode the wrapper raises before any launch, where its output
    would have no grad_fn.  Without autograd it goes on to the kernel's
    checks (here: CPU tensors, refused)."""
    monkeypatch.setattr(flash_ops, "resolve_backend",
                        lambda backend, device, family=None: "cuda")
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 128, 64),
                                                   dtype=np.float32))
               for _ in range(3))
    for needs in ("q", "k", "v"):
        args = {"q": q.clone(), "k": k.clone(), "v": v.clone()}
        args[needs].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_ops.flash_attention(args["q"], args["k"], args["v"])
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            flash_ops.flash_attention(args["q"], args["k"], args["v"])
    with pytest.raises(ValueError, match="CUDA"):
        flash_ops.flash_attention(q, k, v)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_gradient_matches_repro(causal):
    """attention_ref (the flash wrapper's plain backend) stays
    differentiable: d sum(o * w) / d (q, k, v) against repro's, with GQA
    G 2 (repro's side repeats K / V rows, as its model's caller does)."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((4, 128, 64), dtype=np.float32)
    k = rng.standard_normal((2, 128, 64), dtype=np.float32)
    v = rng.standard_normal((2, 128, 64), dtype=np.float32)
    w = rng.standard_normal((4, 128, 64), dtype=np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(jax_attn_ref(
        a, jnp.repeat(b, 2, axis=0), jnp.repeat(c, 2, axis=0),
        causal=causal) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for fn in (attention_ref, lambda a, b, c, causal: flash_ops.
               flash_attention(a, b, c, causal=causal, backend="torch")):
        tq, tk, tv = (torch.as_tensor(x).requires_grad_(True)
                      for x in (q, k, v))
        out = fn(tq, tk, tv, causal=causal)
        got = torch.autograd.grad((out * torch.as_tensor(w)).sum(),
                                  (tq, tk, tv))
        for g, jg in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-5,
                                       rtol=2e-5)
