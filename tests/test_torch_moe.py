"""repro_torch's MoE layer (`models/moe.py`) against repro on the CPU.

The routing integers (expert ids, the expert-sorted order, each item's
buffer slot and whether it is kept) are held exactly on the same float32
router logits, with a zero router (every probability tied: experts
0..k-1, as jax.lax.top_k picks) and a capacity factor of 0.25 (tokens
dropped); repro's integers come from its own ops (top_k, a stable
argsort, searchsorted), as its `moe_forward` computes them.  The layer is
held within 1e-5 in float32, the aux losses within 1e-6.  The moe
smoke configs' prefill + 8 decode steps run through
`test_torch_lm_families.check_prefill_decode`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as JM
from repro.models.model import model_init_params as jax_init_params
from repro.sharding.partition import ShardCtx
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import moe as TM
from repro_torch.models import transformer as ttrans
from test_torch_lm_families import check_prefill_decode, interpret_model

_ = interpret_model     # a fixture of the parity check below


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(name, **kw):
    jc = dataclasses.replace(jreg.get_smoke_config(name), dtype="float32",
                             **kw)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _jax_routing(logits, k, E, C):
    """repro's routing of `moe_forward` (moe.py:86-105) on given logits."""
    G, Ng, _ = logits.shape
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, -1, keepdims=True)
    eid = expert_idx.reshape(G, Ng * k)
    tok = jnp.broadcast_to(jnp.arange(Ng)[:, None], (Ng, k)).reshape(Ng * k)
    order = jnp.argsort(eid, axis=-1, stable=True)
    eid_s = jnp.take_along_axis(eid, order, -1)
    seg_start = jax.vmap(
        lambda e: jnp.searchsorted(e, jnp.arange(E), side="left"))(eid_s)
    rank = jnp.arange(Ng * k)[None, :] - jnp.take_along_axis(
        seg_start, eid_s, -1)
    keep = rank < C
    slot = jnp.where(keep, eid_s * C + jnp.clip(rank, 0, C - 1), E * C)
    return gate_vals, expert_idx, order, tok[order], slot, keep


def test_capacity_and_groups_match_repro():
    for name in ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b"):
        for cf in (0.25, 1.0, 1.25, 2.0, 192.0):
            jc = dataclasses.replace(jreg.get_config(name),
                                     capacity_factor=cf)
            tc = ModelConfig(**dataclasses.asdict(jc))
            for n in (1, 7, 8, 36, 512, 516, 4096):
                assert TM.capacity_per_group(n, tc) == \
                    JM.capacity_per_group(n, jc), (name, cf, n)
    for n in (1, 2, 8, 31, 32, 64, 100, 1152, 16384, 16512, 8 * 2064):
        for shards in (1, 2, 3, 8):
            for req in (1, 4, 32, 64):
                assert TM.pick_groups(n, shards, req) == \
                    JM.pick_groups(n, shards, req), (n, shards, req)
    # the sizes the chip run routes: kimi-k2's teacher-forced 8 x 144
    # tokens at no-drop capacity (C 40), llama4-scout's 8 x 2,048 prefill
    kimi = dataclasses.replace(jreg.get_config("kimi-k2-1t-a32b"),
                               capacity_factor=384 / 8)
    assert TM.pick_groups(8 * 144, 1, 32) == 32
    assert TM.capacity_per_group(36, ModelConfig(
        **dataclasses.asdict(kimi))) == 40


@pytest.mark.parametrize("case", ["random", "zero_router", "drops"])
def test_routing_integers_match_repro(case):
    E, k, G, Ng = 8, 2, 4, 24
    rng = np.random.default_rng(50)
    logits = rng.normal(size=(G, Ng, E)).astype(np.float32) * 2
    cf = 1.25
    if case == "zero_router":
        logits[:] = 0
    if case == "drops":
        cf = 0.25
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(
        jreg.get_smoke_config("kimi-k2-1t-a32b"), capacity_factor=cf)))
    C = TM.capacity_per_group(Ng, cfg)
    want = _jax_routing(jnp.asarray(logits), k, E, C)
    gates, idx = TM.route(torch.as_tensor(logits), k)
    order, tok_s, slot, keep = TM.dispatch(idx, E, C)
    for got, w in zip((idx, order, tok_s, slot, keep), want[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    np.testing.assert_allclose(gates.numpy(), _np(want[0]), atol=1e-6)
    if case == "zero_router":
        assert (idx.numpy() == np.arange(k)).all()
    if case == "drops":
        assert C == 8 and not keep.all()
        assert (slot[~keep] == E * C).all()


@pytest.mark.parametrize("name,cf,groups,zero", [
    ("llama4-scout-17b-a16e", 1.25, 32, False),
    ("kimi-k2-1t-a32b", 1.25, 32, False),
    ("kimi-k2-1t-a32b", 0.25, 4, False),
    ("kimi-k2-1t-a32b", 1.25, 3, True),
])
def test_moe_forward_matches_repro(name, cf, groups, zero):
    jc, tc = _configs(name, capacity_factor=cf)
    jp = jax_init_params(jc, jax.random.PRNGKey(1))
    if zero:
        jp["layers"]["moe"]["router"] = jnp.zeros_like(
            jp["layers"]["moe"]["router"])
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc)
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tm_ = ttrans.unstack_layers(tp["layers"]["moe"])[0]
    x = np.random.default_rng(51).normal(size=(2, 24, 64)).astype(
        np.float32)
    want, jaux = jax.jit(JM.moe_forward, static_argnums=(2, 3, 4))(
        jm, jnp.asarray(x), jc, ShardCtx(), groups)
    got, taux = TM.moe_forward(tm_, torch.as_tensor(x), tc, groups)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    for key in ("balance_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   atol=1e-6, rtol=1e-6)


def test_router_z_and_balance_loss_matches_repro():
    rng = np.random.default_rng(52)
    logits = rng.normal(size=(3, 40, 16)).astype(np.float32) * 3
    idx = np.argsort(-logits, -1, kind="stable")[..., :2]
    want = JM.router_z_and_balance_loss(jnp.asarray(logits),
                                        jnp.asarray(idx), 16)
    got = TM.router_z_and_balance_loss(torch.as_tensor(logits),
                                       torch.as_tensor(idx), 16)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=1e-6, rtol=1e-6)


def test_forward_sums_aux_over_layers_and_drops_it_in_decode():
    """Prefill sums balance and z losses over the moe layers, as repro's
    layer scan does; decode returns zeros."""
    jc, tc = _configs("llama4-scout-17b-a16e")
    jp = jax_init_params(jc, jax.random.PRNGKey(2))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc)
    toks = np.random.default_rng(53).integers(0, jc.vocab_size, (2, 16))
    from repro.models.transformer import forward as jax_forward
    _, jaux, jcache = jax_forward(jp, jc, {"tokens": jnp.asarray(toks)},
                                  return_cache=True)
    _, taux, tcache = ttrans.forward(tp, tc, {"tokens": torch.as_tensor(
        toks)}, return_cache=True)
    for key in ("balance_loss", "z_loss"):
        assert float(jaux[key]) > 0
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6)
    cache = ttrans.init_cache(tc, 2, 4, torch.float32, device="cpu")
    _, daux, _ = ttrans.forward(tp, tc, {"tokens": torch.as_tensor(
        toks[:, :1])}, cache=cache)
    assert float(daux["balance_loss"]) == 0 and float(daux["z_loss"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_prefill_then_decode_matches_repro(name, dtype, interpret_model,
                                           monkeypatch):
    check_prefill_decode(name, dtype, monkeypatch)
