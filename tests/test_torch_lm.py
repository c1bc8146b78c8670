"""repro_torch's LM serving path (dense family, the registry and
templates of every family) against repro on the CPU.

Every input is made from a seed with numpy; repro's parameters are carried
across with `lm_params_from_jax`, so both packages compute one function.
repro's flash kernel runs as its own tests run it (``backend="interpret"``;
the model under ``REPRO_BACKEND=interpret``, read when a call is traced).

Tolerances: float32 within 2e-5 for the attention op (repro's own kernel
tolerance), 1e-5 for the layers and 1e-4 for whole-model logits (sums in
another order); bf16 within 3e-2 for the op (repro's bf16 kernel test) and
2 % of the largest logit for the model, where the two frameworks round
intermediate bf16 values at different places.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_NAMES as jax_arch_names
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models import layers as JL
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import model_init_params as jax_init_params
from repro.models.model import prefill_step as jax_prefill_step
from repro.models.template import count_params as jax_count_params
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import model_template as jax_model_template
from repro.sharding.partition import ShardCtx
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from repro_torch.models.mamba2 import init_mamba_state
from repro_torch.models import transformer as ttrans
from repro_torch.models.template import count_params, init_params

DENSE = ("yi-6b", "qwen1.5-110b", "stablelm-3b", "minitron-8b")


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
    jc = dataclasses.replace(jax_smoke_config(name), dtype=dtype, **kw)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _params(jc, tc, seed=0):
    """repro's random parameters (biases made non-zero) and their copy."""
    jp = jax_init_params(jc, jax.random.PRNGKey(seed))
    if jc.qkv_bias:
        rng = np.random.default_rng(seed)
        for b in ("bq", "bk", "bv"):
            shape = jp["layers"]["attn"][b].shape
            jp["layers"]["attn"][b] = jnp.asarray(
                rng.normal(0, 0.1, shape).astype(np.float32))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), tc)


# ------------------------------------------------------ flash attention op --
def _qkv(shape, seed, n_kv=None):
    rng = np.random.default_rng(seed)
    bh, s, d = shape
    q = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(n_kv or bh, s, d)).astype(np.float32)
    v = rng.normal(size=(n_kv or bh, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape,causal", [
    ((2, 128, 64), True), ((2, 128, 64), False),
    ((4, 256, 64), True), ((4, 256, 64), False),
    ((1, 384, 128), True), ((1, 384, 128), False),
    ((2, 200, 64), True)])
def test_flash_attention_matches_repro_f32(shape, causal):
    q, k, v = _qkv(shape, sum(shape))
    want_ref = _np(jax_attn_ref(q, k, v, causal=causal))
    want_kernel = _np(jfa_ops.flash_attention(q, k, v, causal=causal,
                                              backend="interpret"))
    for got in (attention_ref(_t(q), _t(k), _t(v), causal),
                flash_attention(_t(q), _t(k), _t(v), causal=causal)):
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5,
                                       rtol=2e-5)


@pytest.mark.parametrize("shape", [(2, 128, 64), (2, 200, 64)])
def test_flash_attention_matches_repro_bf16(shape):
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16)
               for x in _qkv(shape, 3))
    want = _np(jfa_ops.flash_attention(q, k, v, backend="interpret"))
    tq, tk, tv = (_t(_np(x), torch.bfloat16) for x in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


def test_flash_attention_gqa_reads_kv_row_bh_over_g():
    """K/V with BH / G rows equal repro on jnp.repeat(k, G) rows."""
    q, k, v = _qkv((8, 128, 64), 5, n_kv=2)
    want = _np(jfa_ops.flash_attention(
        q, np.repeat(k, 4, axis=0), np.repeat(v, 4, axis=0),
        backend="interpret"))
    got = flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_attention_refuses_what_repro_refuses():
    q, k, v = (_t(x) for x in _qkv((2, 200, 64), 6))
    with pytest.raises(ValueError, match="pads S only under causal"):
        jfa_ops.flash_attention(q.numpy(), k.numpy(), v.numpy(),
                                causal=False, backend="interpret")
    with pytest.raises(ValueError, match="pads S only under causal"):
        flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="K/V rows|BH / G"):
        flash_attention(q, k[:1, :100], v[:1, :100])
    with pytest.raises(ValueError, match="needs tensors on a CUDA device"):
        flash_attention(q, k, v, backend="cuda")


# ----------------------------------------------------------------- layers --
def _layer_cfgs():
    return _configs("yi-6b", "float32")   # 4 query heads over 1 KV head


def test_rmsnorm_and_rope_match_repro():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rmsnorm(_t(x), _t(scale), 1e-5).numpy(),
        _np(JL.rmsnorm(x, scale, 1e-5)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), _t(pos).long(), 10_000.0).numpy(),
        _np(JL.apply_rope(x, pos, 10_000.0)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_variants_match_repro(causal):
    rng = np.random.default_rng(11)
    B, S, H, KV, D = 2, 128, 4, 2, 16
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    np.testing.assert_allclose(
        TL.dense_attention(_t(q), _t(k), _t(v), causal).numpy(),
        _np(JL.dense_attention(q, k, v, causal)), atol=1e-5, rtol=1e-5)
    outs_t = TL.blockwise_attention(_t(q), _t(k), _t(v), 32, 64, causal)
    outs_j = JL.blockwise_attention(q, k, v, 32, 64, causal)
    np.testing.assert_allclose(outs_t.numpy(), _np(outs_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        TL._assemble_blockwise(outs_t, B, S, H, D, KV, H // KV, 4,
                               32).numpy(),
        _np(JL._assemble_blockwise(outs_j, B, S, H, D, KV, H // KV, 4, 32)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cache_len", [0, 9, 31])
def test_decode_attention_matches_repro(cache_len):
    rng = np.random.default_rng(12 + cache_len)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TL.decode_attention(_t(q), _t(kc), _t(vc), cache_len + 1).numpy(),
        _np(JL.decode_attention(q, kc, vc, cache_len + 1)), atol=1e-5,
        rtol=1e-5)


def test_mlp_forward_matches_repro():
    jc, tc = _layer_cfgs()
    jp, tp = _params(jc, tc)
    x = np.random.default_rng(13).normal(size=(2, 8, 64)).astype(np.float32)
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    tm = ttrans.unstack_layers(tp["layers"]["mlp"])[0]
    np.testing.assert_allclose(TL.mlp_forward(tm, _t(x)).numpy(),
                               _np(JL.mlp_forward(jm, x, ShardCtx())),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("flash", [True, False])
def test_attention_forward_gqa_matches_repro(flash, interpret_model,
                                             monkeypatch):
    """Smoke yi-6b (4 heads over 1 KV head) at S 256: the flash route, or
    the blockwise route with flash off."""
    jc, tc = _configs("yi-6b", "float32", use_flash_kernel=flash)
    jp, tp = _params(jc, tc)
    x = np.random.default_rng(14).normal(size=(2, 256, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(256, dtype=np.int32), (2, 256))
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    ta = ttrans.unstack_layers(tp["layers"]["attn"])[0]
    calls = []
    real = TL.flash_attention
    monkeypatch.setattr(TL, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want, (jk, jv) = JL.attention_forward(ja, x, jc, ShardCtx(), pos)
    got, (tk, tv) = TL.attention_forward(ta, _t(x), tc, _t(pos).long())
    assert len(calls) == int(flash)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- parameters --
def test_lm_params_from_jax_carries_every_leaf():
    jc, tc = _configs("qwen1.5-110b", "float32")
    jp, tp = _params(jc, tc)
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jl) == 14   # embed, final_norm, 2 norms, 4 + 3 attn, 3 mlp

    def get(tree, path):
        for p in path:
            tree = tree[p.key]
        return tree

    for path, leaf in jl:
        got = get(tp, path)
        assert tuple(got.shape) == leaf.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    flat = dict(jax.tree.map(np.asarray, jp))
    flat.pop("final_norm")
    with pytest.raises(ValueError, match="missing \\['final_norm'\\]"):
        lm_params_from_jax(flat, tc)
    bad = jax.tree.map(np.asarray, jp)
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError, match="embed: shape"):
        lm_params_from_jax(bad, tc)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_template_and_init_follow_repro(name):
    jc, tc = _configs(name, "float32")
    assert count_params(ttrans.model_template(tc)) == \
        jax_count_params(jax_model_template(jc))
    p = init_params(ttrans.model_template(tc), torch.Generator().manual_seed(0),
                    tc.param_dtype, device="cpu")
    assert p["final_norm"].eq(1).all()
    norm = p["layers"]["ln"] if "ln" in p["layers"] else p["layers"]["ln1"]
    assert norm.eq(1).all()
    if tc.qkv_bias:
        assert p["layers"]["attn"]["bq"].eq(0).all()
    assert abs(float(p["embed"].float().std()) - 0.02) < 2e-3
    # a weight of fan-in 128 in each family: d_ff, the expert d_ff, d_inner
    if tc.family == "moe":
        w = p["layers"]["moe"]["w_down"]
    elif tc.family == "ssm":
        w = p["layers"]["mamba"]["w_out"]
    else:
        w = (p["shared"] if tc.family == "hybrid" else p["layers"])["mlp"][
            "w_down"]
    assert abs(float(w.float().std()) - 128 ** -0.5) < 0.01
    assert w.dtype == tc.p_dtype


def test_registry_lists_only_ported_families():
    """Every family of repro's registry is ported: the same names, and
    no family's forward raises."""
    assert ARCH_NAMES == jax_arch_names
    assert {get_config(n).family for n in ARCH_NAMES} == {
        "dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    for name in ARCH_NAMES:
        jc, tc = _configs(name, "float32")
        p = init_params(ttrans.model_template(tc),
                        torch.Generator().manual_seed(0), tc.param_dtype,
                        device="cpu")
        shape = (1, 16, tc.n_codebooks) if tc.family == "audio" else (1, 16)
        logits, _ = ttrans.forward(p, tc, {"tokens": torch.zeros(
            shape, dtype=torch.long)})
        assert logits.isfinite().all()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-model")


def test_entry_points_default_to_cuda():
    """A CPU run is reached only by asking for it."""
    for fn in (tmodel.model_init_params, tmodel.make_smoke_batch,
               ttrans.init_cache, init_params, init_mamba_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ttrans.init_cache(_layer_cfgs()[1], 1, 4)


# ---------------------------------------------------------- the whole slice --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_then_decode_matches_repro(name, dtype, interpret_model,
                                           monkeypatch):
    """S = 256 > 128 takes the flash route; then 8 greedy decode steps."""
    jc, tc = _configs(name, dtype, use_flash_kernel=True)
    jp, tp = _params(jc, tc)
    S, max_len = 256, 264
    toks = np.random.default_rng(20).integers(0, jc.vocab_size, (2, S))
    cache_jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cache_tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    calls = []
    real = TL.flash_attention
    monkeypatch.setattr(TL, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jl, jcache = jax.jit(jax_prefill_step, static_argnums=(2, 3),
                         static_argnames="cache_dtype")(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc, max_len,
        cache_dtype=cache_jdt)
    tl, tcache = tmodel.prefill_step(tp, {"tokens": torch.as_tensor(toks)},
                                     tc, max_len, cache_dtype=cache_tdt)
    assert len(calls) == tc.n_layers
    assert tl.shape == (2, tc.vocab_size) and tcache.length == S
    tol = 1e-4 if dtype == "float32" else 0.02 * float(np.abs(_np(jl)).max())
    assert np.abs(tl.numpy() - _np(jl)).max() <= tol
    jdecode = jax.jit(jax_decode_step, static_argnums=(3,))
    for _ in range(8):
        jt = np.array(jnp.argmax(jl, -1))[:, None]
        if dtype == "float32":
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), jt[:, 0])
        jl, jcache = jdecode(jp, jcache, jnp.asarray(jt, jnp.int32), jc)
        tl, tcache = tmodel.decode_step(tp, tcache, torch.as_tensor(jt), tc)
        assert np.abs(tl.numpy() - _np(jl)).max() <= tol
    assert tcache.length == S + 8 == int(jcache.length)
    want_k = _np(jcache.kv_k)
    kv_tol = 1e-5 if dtype == "float32" else 0.02 * np.abs(want_k).max()
    assert np.abs(tcache.kv_k.float().numpy() - want_k).max() <= kv_tol


def test_decode_cache_write_clamps_like_repro():
    """A decode at length >= max_len overwrites row max_len - 1, as
    jax.lax.dynamic_update_slice clamps its start; positions keep going."""
    jc, tc = _configs("yi-6b", "float32")
    jp, tp = _params(jc, tc)
    S = 16
    toks = np.random.default_rng(21).integers(0, jc.vocab_size, (2, S + 2))
    _, jcache = jax_prefill_step(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                 jc, S, cache_dtype=jnp.float32)
    _, tcache = tmodel.prefill_step(tp, {"tokens": torch.as_tensor(
        toks[:, :S])}, tc, S, cache_dtype=torch.float32)
    before = tcache.kv_k[:, :, :S - 1].clone()
    for t in (S, S + 1):
        jl, jcache = jax_decode_step(jp, jcache,
                                     jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tcache = tmodel.decode_step(tp, tcache,
                                        torch.as_tensor(toks[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
        np.testing.assert_allclose(tcache.kv_k.numpy(), _np(jcache.kv_k),
                                   atol=1e-5, rtol=1e-5)
    assert tcache.length == S + 2 == int(jcache.length)
    assert torch.equal(tcache.kv_k[:, :, :S - 1], before)
    assert [TL.cache_write_start(n, 4, 16) for n in (0, 3, 12, 16, 40)] == \
        [0, 3, 12, 12, 12]


def test_forward_hidden_and_logits_match_repro():
    """The cacheless forward: full logits, and the hidden states that
    prefill_step reads its last position from."""
    jc, tc = _configs("stablelm-3b", "float32")
    jp, tp = _params(jc, tc)
    toks = np.random.default_rng(22).integers(0, jc.vocab_size, (2, 24))
    jl, jaux = jax_forward(jp, jc, {"tokens": jnp.asarray(toks)})
    tl, taux = ttrans.forward(tp, tc, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    assert torch.equal(taux["loss_mask"], torch.ones((2, 24), dtype=bool))
    th, _ = ttrans.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                           return_hidden=True)
    jh, _ = jax_forward(jp, jc, {"tokens": jnp.asarray(toks)},
                        return_hidden=True)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=1e-5, rtol=1e-5)


def test_out_of_range_token_ids_follow_jnp_take_fill():
    """jnp.take's "fill" mode: an id in [-V, -1] wraps and an id outside
    [-V, V-1] embeds as NaN, through prefill_step and decode_step."""
    jc, tc = _configs("yi-6b", "float32")
    jp, tp = _params(jc, tc)
    V, S = jc.vocab_size, 12
    toks = np.random.default_rng(23).integers(0, V, (3, S))
    toks[0, -4:] = [-1, V, -V - 1, V + 3]       # NaN from position S-3 on
    toks[1, -1] = -1                            # wraps to V - 1
    jl, jcache = jax_prefill_step(jp, {"tokens": jnp.asarray(toks)}, jc,
                                  S + 2, cache_dtype=jnp.float32)
    tl, tcache = tmodel.prefill_step(tp, {"tokens": torch.as_tensor(toks)},
                                     tc, S + 2, cache_dtype=torch.float32)
    steps = (np.array([[-V], [V], [-2]]),       # wrap, NaN, wrap
             np.array([[3], [-V - 1], [V - 1]]))
    for step in range(len(steps) + 1):
        want = _np(jl)
        got = tl.numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        finite = ~np.isnan(want)
        np.testing.assert_allclose(got[finite], want[finite], atol=1e-4)
        if step == len(steps):
            break
        jl, jcache = jax_decode_step(jp, jcache, jnp.asarray(steps[step]),
                                     jc)
        tl, tcache = tmodel.decode_step(tp, tcache,
                                        torch.as_tensor(steps[step]), tc)
    assert np.isnan(_np(jl)[:2]).all() and np.isfinite(_np(jl)[2]).all()
