"""repro_torch's Mamba2 / SSD layer (`models/mamba2.py`) and the ssm and
hybrid stacks against repro on the CPU.

`ssd_chunked` is held within 1e-5 of the largest value of repro's
`ssd_chunked` and of its sequential `ssd_reference` (each sums in
another order); `_causal_conv` exactly, dtype included (with
a bf16 window through repro's silu, x * (1 / (1 + exp(-x))); with a
float32 one the conv sum exactly, with silu set to the identity in both
packages, and the output within 2 ulps, because float32 exp differs
between the frameworks in the last bit); `mamba_forward` within 1e-5 in
float32, for a prefill and for the one-token step on its state.  The ssm
and hybrid smoke configs' prefill + 8 decode steps run through
`test_torch_lm_families.check_prefill_decode`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import mamba2 as JM
from repro.models.model import model_init_params as jax_init_params
from repro.sharding.partition import ShardCtx
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as ttrans
from test_torch_lm_families import check_prefill_decode, interpret_model

_ = interpret_model     # a fixture of the parity check below


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ssd_inputs(S, seed, H=3, P=4, N=5, B=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    C = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, C, h0


@pytest.mark.parametrize("chunk,S,state", [
    (8, 32, False), (16, 32, True), (32, 32, False), (64, 32, True),
    (1, 8, True)])
def test_ssd_chunked_matches_repro(chunk, S, state):
    x, dt, A, Bm, C, h0 = _ssd_inputs(S, chunk + S)
    s0 = h0 if state else None
    ty, th = TM.ssd_chunked(*(torch.as_tensor(a) for a in (x, dt, A, Bm, C)),
                            chunk, None if s0 is None else torch.as_tensor(s0))
    jy, jh = JM.ssd_chunked(x, dt, A, Bm, C, chunk, s0)
    ry, rh = JM.ssd_reference(x, dt, A, Bm, C, s0)
    for want_y, want_h in ((jy, jh), (ry, rh)):
        for got, want in ((ty, want_y), (th, want_h)):
            want = _np(want)
            # sums of up to 32 terms in another order: 1e-5 of the
            # largest value (~8 here)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
    py, ph = TM.ssd_reference(*(torch.as_tensor(a) for a in (x, dt, A, Bm, C)),
                              None if s0 is None else torch.as_tensor(s0))
    np.testing.assert_allclose(py.numpy(), _np(ry), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ph.numpy(), _np(rh), atol=1e-5, rtol=1e-5)


def test_ssd_chunked_refuses_a_ragged_sequence():
    x, dt, A, Bm, C, _ = _ssd_inputs(30, 3)
    with pytest.raises(AssertionError):
        JM.ssd_chunked(x, dt, A, Bm, C, 8)
    with pytest.raises(ValueError, match="multiple of the chunk 8"):
        TM.ssd_chunked(*(torch.as_tensor(a) for a in (x, dt, A, Bm, C)), 8)


@pytest.mark.parametrize("prev", [None, "float32", "bfloat16"])
def test_causal_conv_matches_repro(prev, monkeypatch):
    rng = np.random.default_rng(60)
    B, S, Cd, K = 2, 7, 40, 4
    xbc = jnp.asarray(rng.normal(size=(B, S, Cd)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(K, Cd)) * 0.5, jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(Cd,)) * 0.1, jnp.bfloat16)
    p = None if prev is None else jnp.asarray(
        rng.normal(size=(B, K - 1, Cd)), prev)

    def tt(a):
        return None if a is None else torch.as_tensor(_np(a)).to(
            getattr(torch, a.dtype.name))

    def both():
        jo, jn = JM._causal_conv(xbc, w, b, p)
        to, tn = TM._causal_conv(tt(xbc), tt(w), tt(b), tt(p))
        for g, want in ((to, jo), (tn, jn)):
            assert str(g.dtype).split(".")[-1] == want.dtype.name
        np.testing.assert_array_equal(tn.float().numpy(), _np(jn))
        return to.float().numpy(), _np(jo)

    got, want = both()
    if prev == "float32":
        assert np.abs(got - want).max() <= 2 * np.spacing(
            np.abs(want).max())
        monkeypatch.setattr(jax.nn, "silu", lambda v: v)
        monkeypatch.setattr(TM, "silu", lambda v: v)
        got, want = both()
    np.testing.assert_array_equal(got, want)


def _mamba(name="mamba2-2.7b", dtype="float32"):
    jc = dataclasses.replace(jreg.get_smoke_config(name), dtype=dtype)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = jax_init_params(jc, jax.random.PRNGKey(3))
    # non-trivial decay, step bias and conv bias
    rng = np.random.default_rng(61)
    for leaf in ("A_log", "dt_bias", "conv_b"):
        shape = jp["layers"]["mamba"][leaf].shape
        jp["layers"]["mamba"][leaf] = jnp.asarray(
            rng.normal(size=shape).astype(np.float32) * 0.5)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return (jc, tc, jax.tree.map(lambda a: a[0], jp["layers"]["mamba"]),
            ttrans.unstack_layers(tp["layers"]["mamba"])[0])


def test_mamba_forward_prefill_and_step_match_repro():
    jc, tc, jm, tm_ = _mamba()
    x = np.random.default_rng(62).normal(size=(2, 33, 64)).astype(np.float32)
    # prefill of 32 (two chunks of 16), then one stateful step
    jfwd = jax.jit(JM.mamba_forward, static_argnums=(2, 3))
    jy, jst = jfwd(jm, jnp.asarray(x[:, :32]), jc, ShardCtx())
    ty, tst = TM.mamba_forward(tm_, torch.as_tensor(x[:, :32]), tc)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=1e-5)
    jy, jst = jfwd(jm, jnp.asarray(x[:, 32:]), jc, ShardCtx(), jst)
    ty, tst = TM.mamba_forward(tm_, torch.as_tensor(x[:, 32:]), tc, tst)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=1e-5)


def test_init_cache_allocates_every_layer():
    """Each layer's SSM state and KV buffer is its own memory (a decode
    writes them in place), float32 states whatever the KV dtype is, and
    shapes as repro's init_cache."""
    from repro.models.transformer import init_cache as jax_init_cache
    for name in ("mamba2-2.7b", "zamba2-2.7b"):
        jc = jreg.get_smoke_config(name)
        tc = ModelConfig(**dataclasses.asdict(jc))
        t = ttrans.init_cache(tc, 3, 20, torch.bfloat16, device="cpu")
        j = jax_init_cache(jc, 3, 20, jnp.bfloat16)
        n_lead = 1 if name == "mamba2-2.7b" else 2
        for g, w in zip(t.ssm, j.ssm):
            assert g.shape == w.shape and g.dtype == torch.float32
            layers = g.view(-1, *g.shape[n_lead:])
            layers[0].fill_(1)
            assert layers[1:].eq(0).all()
        if name == "zamba2-2.7b":
            assert t.kv_k.shape == j.kv_k.shape
            assert t.kv_k.dtype == torch.bfloat16
            assert t.kv_k.data_ptr() != t.kv_v.data_ptr()
        else:
            assert t.kv_k == () and t.kv_v == ()
        assert t.length == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-2.7b"])
def test_prefill_then_decode_matches_repro(name, dtype, interpret_model,
                                           monkeypatch):
    check_prefill_decode(name, dtype, monkeypatch)
