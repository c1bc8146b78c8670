"""repro_torch's LM families beyond dense (moe, ssm, hybrid, vlm, audio),
its configs and registry, M-RoPE and triangle attention, against repro on
the CPU.

Every input is made from a seed with numpy; repro's parameters are carried
across with `lm_params_from_jax`.  Where repro reaches its flash kernel it
runs in interpret mode (``REPRO_BACKEND=interpret``); the port runs its
plain version there.

Tolerances of prefill + 8 decode steps: float32 within 1e-4 (sums in
another order); bf16 within 2 % of the largest logit (the dense test's),
except
  - moe: atol = rtol = 6e-2 (repro's own bf16 scan-vs-unroll tolerance in
    test_arch_smoke.py: a reordered bf16 sum flips a near-tie expert pick
    and moves a few logits by ~0.05; the routing itself is held exactly
    in float32 by test_torch_moe.py);
  - hybrid: the larger of that and 1.5x the distance between repro's own
    bf16 and float32 logits on the same tokens.  Its SSM layers carry one
    bf16 ulp, which the two frameworks place differently (a bf16 matmul
    element, an attention output), to 1.4-2.7 % of the smoke logits in
    repro itself; each block alone agrees within one ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels.flash_attention import ops as jfa_ops
from repro.models import layers as JL
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import make_smoke_batch as jax_make_smoke_batch
from repro.models.model import model_init_params as jax_init_params
from repro.models.model import prefill_step as jax_prefill_step
from repro.models.template import count_params as jax_count_params
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import model_template as jax_model_template
from repro.sharding.partition import ShardCtx
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention.ops import kernel_head_dim
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttrans
from repro_torch.models.template import count_params

NEW_FAMILIES = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "mamba2-2.7b",
                "zamba2-2.7b", "qwen2-vl-7b", "musicgen-medium")
# one config of each family with attention takes the flash route
FLASH = {"kimi-k2-1t-a32b", "zamba2-2.7b", "qwen2-vl-7b", "musicgen-medium"}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.fixture
def interpret_model(monkeypatch):
    """repro's model attention through its interpret-mode flash kernel."""
    monkeypatch.setenv("REPRO_BACKEND", "interpret")
    jfa_ops.flash_attention.clear_cache()
    yield
    jfa_ops.flash_attention.clear_cache()


def _configs(name, dtype, **kw):
    jc = dataclasses.replace(jreg.get_smoke_config(name), dtype=dtype, **kw)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _params(jc, tc, seed=0):
    jp = jax_init_params(jc, jax.random.PRNGKey(seed))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), tc)


# ------------------------------------------------------- configs, registry --
def test_registry_and_every_config_method_match_repro():
    assert treg.ARCH_NAMES == jreg.ARCH_NAMES
    for name in jreg.ARCH_NAMES:
        jc, tc = jreg.get_config(name), treg.get_config(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for attr in ("hd", "d_inner", "ssm_heads", "is_attention_free",
                     "is_subquadratic"):
            assert getattr(tc, attr) == getattr(jc, attr), (name, attr)
        assert tc.n_params() == jc.n_params(), name
        assert tc.n_active_params() == jc.n_active_params(), name
        assert str(tc.act_dtype).split(".")[-1] == jc.act_dtype.name
        assert str(tc.p_dtype).split(".")[-1] == jc.p_dtype.name
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("gpt-5")


@pytest.mark.parametrize("name", jreg.ARCH_NAMES)
def test_smoke_config_matches_repro(name):
    tc = treg.get_smoke_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(
        jreg.get_smoke_config(name))
    assert count_params(ttrans.model_template(tc)) == jax_count_params(
        jax_model_template(jreg.get_smoke_config(name)))


def test_flash_wrapper_takes_every_registered_head_width():
    """The kernel's width rule (`kernel_head_dim`) accepts every
    registered config's head, in both dtypes, and still refuses > 128."""
    for name in treg.ARCH_NAMES:
        cfg = treg.get_config(name)
        if cfg.is_attention_free:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            width = kernel_head_dim(cfg.hd, dtype)
            assert cfg.hd <= width <= 128, (name, dtype)
    assert kernel_head_dim(112, torch.bfloat16) == 128
    assert kernel_head_dim(112, torch.float32) == 128
    assert kernel_head_dim(80, torch.bfloat16) == 128
    assert kernel_head_dim(80, torch.float32) == 80
    assert kernel_head_dim(64, torch.bfloat16) == 64
    with pytest.raises(ValueError, match="up to 128, got 160"):
        kernel_head_dim(160, torch.bfloat16)
    with pytest.raises(TypeError):
        kernel_head_dim(64, torch.float16)


# ------------------------------------------------------ M-RoPE, triangle --
def test_mrope_matches_repro():
    for hd in (16, 64, 80, 112, 128):
        assert TL.mrope_sections(hd) == JL.mrope_sections(hd)
    assert TL.mrope_sections(128) == (16, 24, 24)
    rng = np.random.default_rng(30)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    thw = rng.integers(0, 3000, (2, 12, 3)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_mrope(_t(x), _t(thw).long(), 1e6).numpy(),
        _np(JL.apply_mrope(x, thw, 1e6)), atol=1e-5, rtol=1e-5)
    # equal t, h, w ids rotate as plain RoPE does
    same = np.repeat(thw[..., :1], 3, axis=-1)
    np.testing.assert_allclose(
        TL.apply_mrope(_t(x), _t(same).long(), 1e4).numpy(),
        TL.apply_rope(_t(x), _t(same[..., 0]).long(), 1e4).numpy(),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bq,bk", [(32, 64), (64, 32), (128, 128)])
def test_triangle_attention_matches_repro(bq, bk):
    rng = np.random.default_rng(31)
    B, S, H, KV, D = 2, 128, 4, 2, 16
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    got = TL.triangle_attention(_t(q), _t(k), _t(v), bq, bk).numpy()
    want = jax.jit(JL.triangle_attention, static_argnums=(3, 4))(q, k, v, bq,
                                                                 bk)
    np.testing.assert_allclose(got, _np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, _np(JL.dense_attention(q, k, v)),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        TL.triangle_attention(_t(q)[:, :100], _t(k)[:, :100],
                              _t(v)[:, :100], 64, 64)


def test_attention_forward_triangle_and_mrope_match_repro():
    """qwen2-vl's attention (M-RoPE) with attn_impl="triangle", at S 160
    (past the dense route's 128)."""
    jc, tc = _configs("qwen2-vl-7b", "float32", attn_impl="triangle",
                      attn_block_q=32, attn_block_k=32)
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(32)
    x = rng.normal(size=(2, 160, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(160, dtype=np.int32), (2, 160))
    thw = rng.integers(0, 160, (2, 160, 3)).astype(np.int32)
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    ta = ttrans.unstack_layers(tp["layers"]["attn"])[0]
    want, (jk, _) = jax.jit(JL.attention_forward, static_argnums=(2, 3))(
        ja, x, jc, ShardCtx(), pos, positions_thw=thw)
    got, (tk, _) = TL.attention_forward(ta, _t(x), tc, _t(pos).long(),
                                        positions_thw=_t(thw).long())
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ parameters --
@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_lm_params_from_jax_carries_every_family(name):
    jc, tc = _configs(name, "float32")
    jp, tp = _params(jc, tc)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got = tp
        for p in path:
            got = got[p.key]
        assert tuple(got.shape) == leaf.shape
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name
        np.testing.assert_array_equal(got.float().numpy(), _np(leaf))


# ------------------------------------------------------- vlm, audio forward --
def test_vlm_prefix_and_audio_heads_match_repro():
    """The cacheless forward on `make_smoke_batch` (shapes and dtypes as
    repro's): vlm's vision prefix (loss_mask False on it) and audio's
    (B, S, K, V) logits from K codebooks."""
    for name in ("qwen2-vl-7b", "musicgen-medium"):
        jc, tc = _configs(name, "float32")
        jp, tp = _params(jc, tc)
        tb = tmodel.make_smoke_batch(tc, 2, 24, seed=33, device="cpu")
        shapes = jax_make_smoke_batch(jc, 2, 24, jax.random.PRNGKey(0))
        assert set(tb) == set(shapes)
        jb = {}
        for k, v in tb.items():
            assert tuple(v.shape) == shapes[k].shape, k
            assert v.is_floating_point() == jnp.issubdtype(shapes[k].dtype,
                                                           jnp.floating)
            jb[k] = jnp.asarray(v.float().numpy()).astype(shapes[k].dtype)
        jl, jaux = jax.jit(jax_forward, static_argnums=(1,))(jp, jc, jb)
        tl, taux = ttrans.forward(tp, tc, tb)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
        assert np.array_equal(taux["loss_mask"].numpy(),
                              np.asarray(jaux["loss_mask"]))
        if name == "qwen2-vl-7b":
            assert tb["vision_embeds"].dtype == torch.bfloat16
            assert not taux["loss_mask"][:, :6].any()   # max(4, 24 // 4)
    assert tl.shape == (2, 24, 4, tc.vocab_size)


# ------------------------------------------------------- the whole slice --
def _prefill_decode(jc, tc, jp, tp, toks, extra, cache_jdt, cache_tdt,
                    max_len, steps, feed=None):
    """repro's and the port's prefill + ``steps`` greedy decode steps on
    the same tokens (repro's argmax, or ``feed``).  Returns both logit
    sequences, both caches and the fed tokens."""
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.as_tensor(toks),
          **{k: torch.as_tensor(v) for k, v in extra.items()}}
    jl, jcache = jax.jit(jax_prefill_step, static_argnums=(2, 3),
                         static_argnames="cache_dtype")(
        jp, jb, jc, max_len, cache_dtype=cache_jdt)
    tl, tcache = tmodel.prefill_step(tp, tb, tc, max_len,
                                     cache_dtype=cache_tdt)
    js, ts, fed = [_np(jl)], [tl.float().numpy()], []
    jdecode = jax.jit(jax_decode_step, static_argnums=(3,))
    for i in range(steps):
        nxt = np.array(jnp.argmax(jl, -1))[:, None] if feed is None \
            else feed[i]
        fed.append(nxt)
        jl, jcache = jdecode(jp, jcache, jnp.asarray(nxt, jnp.int32), jc)
        tl, tcache = tmodel.decode_step(tp, tcache, torch.as_tensor(nxt), tc)
        js.append(_np(jl))
        ts.append(tl.float().numpy())
    return np.stack(js), np.stack(ts), jcache, tcache, fed


def check_prefill_decode(name, dtype, monkeypatch):
    """Prefill, then 8 greedy decode steps, of ``name``'s smoke config in
    ``dtype`` against repro's (logits, KV caches, SSM states), at the
    tolerances of the module docstring; S 256 (> 128, past the dense
    route) on the flash route for one config of each family with
    attention (`FLASH`), the blockwise route for llama4-scout, and S 64
    (4 SSD chunks) for mamba2.  Run under `interpret_model`."""
    flash = name in FLASH
    jc, tc = _configs(name, dtype, use_flash_kernel=flash)
    jp, tp = _params(jc, tc)
    S = 64 if jc.family == "ssm" else 256
    rng = np.random.default_rng(40)
    extra = {}
    if jc.family == "audio":
        toks = rng.integers(0, jc.vocab_size, (2, S, jc.n_codebooks))
    elif jc.family == "vlm":
        toks = rng.integers(0, jc.vocab_size, (2, S - jc.vision_tokens))
        extra["vision_embeds"] = (rng.standard_normal(
            (2, jc.vision_tokens, jc.d_model)) * 0.02).astype(np.float32)
    else:
        toks = rng.integers(0, jc.vocab_size, (2, S))
    max_len = S + 8
    f32 = dtype == "float32"
    cache_jdt = jnp.float32 if f32 else jnp.bfloat16
    cache_tdt = torch.float32 if f32 else torch.bfloat16
    calls = []
    real = TL.flash_attention
    monkeypatch.setattr(TL, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want, got, jcache, tcache, fed = _prefill_decode(
        jc, tc, jp, tp, toks, extra, cache_jdt, cache_tdt, max_len, 8)
    n_attn = 0 if jc.family == "ssm" else (
        jc.n_layers // jc.attn_every if jc.family == "hybrid"
        else jc.n_layers)
    assert len(calls) == (n_attn if flash else 0)
    logit_shape = (2, jc.n_codebooks, jc.vocab_size) \
        if jc.family == "audio" else (2, jc.vocab_size)
    assert got.shape == (9,) + logit_shape
    assert tcache.length == S + 8 == int(jcache.length)

    if f32:
        tol = np.full(9, 1e-4)
        np.testing.assert_array_equal(got[:-1].argmax(-1),
                                      want[:-1].argmax(-1))
    else:
        tol = 0.02 * np.abs(want).reshape(9, -1).max(1)
    j32 = None
    if jc.family == "hybrid" and not f32:
        j32, _, j32cache, _, _ = _prefill_decode(
            dataclasses.replace(jc, dtype="float32"),
            dataclasses.replace(tc, dtype="float32"), jp, tp, toks, extra,
            jnp.float32, torch.float32, max_len, 8, feed=fed)
        floor = np.abs(want - j32).reshape(9, -1).max(1)
        tol = np.maximum(tol, 1.5 * floor)
    if jc.family == "moe" and not f32:
        np.testing.assert_allclose(got, want, atol=6e-2, rtol=6e-2)
    else:
        err = np.abs(got - want).reshape(9, -1).max(1)
        assert (err <= tol).all(), (err, tol)

    # the caches: KV (cache dtype) and SSM states (float32 recurrent
    # state; the conv window in the activation dtype after a prefill)
    leaves = []
    if jc.family != "ssm":
        assert tcache.kv_k.dtype == cache_tdt
        leaves.append((tcache.kv_k, jcache.kv_k,
                       j32 is not None and j32cache.kv_k))
    if jc.family in ("ssm", "hybrid"):
        for f in ("conv", "ssm"):
            w = getattr(jcache.ssm, f)
            assert str(getattr(tcache.ssm, f).dtype).split(".")[-1] == \
                w.dtype.name
            leaves.append((getattr(tcache.ssm, f), w,
                           j32 is not None and getattr(j32cache.ssm, f)))
    for g, w, w32 in leaves:
        g, w = g.float().numpy(), _np(w)
        assert g.shape == w.shape
        err = np.abs(g - w)
        if f32:
            assert err.max() <= 1e-4
        elif jc.family == "moe":
            # layer 0 comes before any expert pick; after it, a flipped
            # near-tie pick moves that token's K rows by O(1)
            assert err[0].max() <= 0.02 * np.abs(w[0]).max()
            assert (err[1:] <= 0.02 * np.abs(w).max()).mean() >= 0.99
        else:
            lim = 0.02 * np.abs(w).max()
            if w32 is not False:
                lim = max(lim, 1.5 * np.abs(w - _np(w32)).max())
            assert err.max() <= lim, (err.max(), lim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-vl-7b", "musicgen-medium"])
def test_prefill_then_decode_matches_repro(name, dtype, interpret_model,
                                           monkeypatch):
    check_prefill_decode(name, dtype, monkeypatch)
