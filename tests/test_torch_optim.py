"""repro_torch's optimizers, LR schedule and gradient codecs against repro
on the CPU.

The same numpy parameters, gradients and states go through both packages
(`opt_state_from_jax` / `compress_state_from_jax` carry repro's states
across).  Tolerances: float32 results within 1e-6 relative + 1e-7 (XLA
and PyTorch round ``b ** step`` and the reductions of the global norm
and of adafactor's factored moments in other orders); a bf16 moment
within one bf16 ulp (2^-7 relative) plus half an ulp of the leaf's
largest entry (2^-8 of it) of repro's, where the float32 value it
rounds differs in a last bit and the next step carries that, and then a
parameter within
lr x 2^-6 (its m / sqrt(v) moves by at most ~1.5 bf16 ulps); the codecs
exactly (int8: the same
float32 scale, rounding half to even and the clip to +-127).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jopt
from repro.optim import compress as jcomp
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro_torch.convert import compress_state_from_jax, opt_state_from_jax
from repro_torch.optim import adamw as topt
from repro_torch.optim import compress as tcomp
from repro_torch.optim.schedules import warmup_cosine

F32_RTOL, F32_ATOL = 1e-6, 1e-7
BF16_RTOL = 2 ** -7


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(seed, dtype_w=np.float32):
    """A parameter-shaped tree: a factored (160, 144) matrix, a stacked
    (2, 128, 136) one, a small matrix, a vector, a bf16 matrix."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((160, 144), dtype=np.float32),
        "layers": {"w": rng.standard_normal((2, 128, 136), dtype=np.float32),
                   "small": rng.standard_normal((8, 200), dtype=np.float32)},
        "b": rng.standard_normal((17,), dtype=np.float32),
        "h": rng.standard_normal((130, 129), dtype=np.float32),
    }


def _jax(tree, bf16=("h",)):
    return {k: (_jax(v, ()) if isinstance(v, dict)
                else jnp.asarray(v, jnp.bfloat16 if k in bf16
                                 else jnp.float32))
            for k, v in tree.items()}


def _torch(tree, bf16=("h",)):
    return {k: (_torch(v, ()) if isinstance(v, dict)
                else torch.as_tensor(v).to(torch.bfloat16 if k in bf16
                                           else torch.float32))
            for k, v in tree.items()}


def _pairs(jt, tt, prefix=""):
    """(name, repro leaf, port leaf) of two trees of one structure."""
    if isinstance(jt, dict):
        for k in sorted(jt):
            yield from _pairs(jt[k], tt[k], f"{prefix}/{k}")
    elif isinstance(jt, tuple):
        assert isinstance(tt, tuple) and len(jt) == len(tt), prefix
        for i, (a, b) in enumerate(zip(jt, tt)):
            yield from _pairs(a, b, f"{prefix}.{i}")
    else:
        yield prefix, jt, tt


def _close(jt, tt, what, atol=F32_ATOL):
    for name, j, t in _pairs(jt, tt):
        assert tuple(t.shape) == tuple(j.shape), (what, name)
        bf16 = t.dtype == torch.bfloat16
        assert bf16 == (j.dtype == jnp.bfloat16), (what, name)
        if bf16:
            atol = max(atol, 2 ** -8 * float(np.abs(_np(j)).max()))
        np.testing.assert_allclose(
            t.float().numpy(), _np(j), rtol=BF16_RTOL if bf16 else F32_RTOL,
            atol=atol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (20, 20)])
def test_warmup_cosine_matches_repro(warmup, total):
    for s in range(total + 3):
        want = float(jax_warmup_cosine(jnp.int32(s), peak_lr=3e-4,
                                       warmup_steps=warmup,
                                       total_steps=total))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup,
                                total_steps=total)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_warmup_cosine_shape():
    """repro's test_substrate case."""
    lr = [warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                        total_steps=100).item() for s in range(101)]
    assert lr[0] == 0.0
    assert lr[10] == pytest.approx(1.0)
    assert lr[100] == pytest.approx(0.1, abs=1e-6)
    assert all(a >= b - 1e-9 for a, b in zip(lr[10:], lr[11:]))


def test_global_norm_matches_repro():
    t = _tree(0)
    want = float(jopt.global_norm(_jax(t)))
    got = topt.global_norm(_torch(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("kind,moment_dtype", [
    ("adamw", "float32"), ("adamw", "bfloat16"),
    ("adafactor", "float32"), ("adafactor", "bfloat16")])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_update_matches_repro(kind, moment_dtype, n_steps):
    """n_steps updates from the same parameters with the same gradients
    (clipped in step 1: their norm is ~10x grad_clip) and a changing lr;
    both the parameters and the state, and `init`."""
    cfg = dict(kind=kind, moment_dtype=moment_dtype, lr=1e-2)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp, tp = _jax(_tree(1)), _torch(_tree(1))
    js, ts = jopt.init(jp, jcfg), topt.init(tp, tcfg)
    _close(js.m, ts.m, "init m")
    _close(js.v, ts.v, "init v")
    assert ts.step.dtype == torch.int32 and ts.step.item() == 0
    for k in range(n_steps):
        g = _tree(10 + k)
        lr = 1e-2 / (k + 1)
        jp, js = jopt.update(_jax(g), js, jp, jcfg, lr=jnp.float32(lr))
        tp_out, ts = topt.update(_torch(g), ts, tp, tcfg,
                                 lr=torch.tensor(lr))
        assert tp_out is tp        # updated in place
        bf16_m = kind == "adamw" and moment_dtype == "bfloat16"
        _close(jp, tp, f"step {k + 1} params",
               atol=1e-2 * 2 ** -6 if bf16_m and k else F32_ATOL)
        _close(js.m, ts.m, f"step {k + 1} m")
        _close(js.v, ts.v, f"step {k + 1} v")
        assert ts.step.item() == int(js.step) == k + 1


def test_update_from_repro_state():
    """A repro state carried across with opt_state_from_jax continues as
    repro's does (adafactor's factored tuples and an adamw bf16 state)."""
    for kind, mdt in (("adafactor", "float32"), ("adamw", "bfloat16")):
        jcfg = jopt.OptConfig(kind=kind, moment_dtype=mdt, lr=1e-2)
        tcfg = topt.OptConfig(**dataclasses.asdict(jcfg))
        jp = _jax(_tree(2))
        js = jopt.init(jp, jcfg)
        jp, js = jopt.update(_jax(_tree(3)), js, jp, jcfg)
        ts = opt_state_from_jax(jax.tree.map(np.asarray, js))
        tp = {k: v for k, v in _torch(_tree(2)).items()}
        # the port starts from repro's step-1 parameters and state
        for name, j, t in _pairs(jp, tp):
            t.copy_(torch.from_numpy(np.array(_np(j))).to(t.dtype))
        jp, js = jopt.update(_jax(_tree(4)), js, jp, jcfg)
        topt.update(_torch(_tree(4)), ts, tp, tcfg)
        _close(jp, tp, f"{kind} params",
               atol=1e-2 * 2 ** -6 if mdt == "bfloat16" else F32_ATOL)
        _close(js.v, ts.v, f"{kind} v")
        assert int(js.step) == 2


def test_opt_state_sharding_mirrors_params():
    from repro_torch.sharding.partition import Sharding

    class Mesh:            # a 2 x 2 mesh's names and shape
        mesh_dim_names, shape = ("data", "model"), (2, 2)
    mesh = Mesh()
    tp = _torch(_tree(0))
    psh = {"w": Sharding(mesh, ("data", "model")),
           "layers": {"w": Sharding(mesh, (None, "data", "model")),
                      "small": Sharding(mesh, (None, None))},
           "b": Sharding(mesh, ()), "h": Sharding(mesh, ("data",))}
    repl = Sharding(mesh, ())
    st = topt.opt_state_sharding(psh, tp, topt.OptConfig(), repl)
    assert st == topt.OptState(psh, psh, repl)
    st = topt.opt_state_sharding(psh, tp, topt.OptConfig(kind="adafactor"),
                                 repl)
    assert st.m == () and st.step == repl
    assert st.v["w"] == (Sharding(mesh, ("data",)), Sharding(mesh, ("model",)))
    assert st.v["layers"]["w"] == (Sharding(mesh, (None, "data")),
                                   Sharding(mesh, (None, "model")))
    assert st.v["h"] == (Sharding(mesh, ("data",)), Sharding(mesh, (None,)))
    assert st.v["layers"]["small"] == psh["layers"]["small"]  # not factored


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("error_feedback", [True, False])
def test_codecs_match_repro(codec, error_feedback):
    """Three steps of compress -> decompress, the wire, the decoded
    gradients and the error state, exactly (a repro state carried in
    with compress_state_from_jax after step 1)."""
    cfg = dict(codec=codec, error_feedback=error_feedback)
    jcfg, tcfg = jcomp.CompressConfig(**cfg), tcomp.CompressConfig(**cfg)
    g0 = _tree(20)
    js = jcomp.init_state(_jax(g0, ()), jcfg)
    ts = tcomp.init_state(_torch(g0, ()), tcfg)
    for k in range(3):
        g = {n: (v * 10.0 ** (k - 3) if not isinstance(v, dict) else v)
             for n, v in _tree(21 + k).items()}
        jw, js, jdec = jcomp.compress(_jax(g, ()), js, jcfg)
        tw, ts, tdec = tcomp.compress(_torch(g, ()), ts, tcfg)
        wire_dtypes = {"none": (torch.float32,), "bf16": (torch.bfloat16,),
                       "int8": (torch.int8, torch.float32)}[codec]
        for name, j, t in _pairs(jw, tw):
            assert t.dtype in wire_dtypes, name
            np.testing.assert_array_equal(t.float().numpy(), _np(j), name)
        for name, j, t in _pairs(jdec(jw), tdec(tw)):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), _np(j), name)
        assert (ts.error == ()) == (js.error == ())
        if js.error != ():
            for name, j, t in _pairs(js.error, ts.error):
                np.testing.assert_array_equal(t.numpy(), _np(j), name)
        if k == 0:
            ts = compress_state_from_jax(jax.tree.map(np.asarray, js))


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_compress_roundtrip_error_bounds(codec):
    """repro's test_substrate case."""
    rng = np.random.default_rng(0)
    grads = {"a": torch.as_tensor(rng.normal(size=(64, 64)).astype(
                 np.float32)),
             "b": torch.as_tensor(rng.normal(size=(17,)).astype(np.float32))}
    cfg = tcomp.CompressConfig(codec=codec)
    state = tcomp.init_state(grads, cfg)
    wire, state, dec = tcomp.compress(grads, state, cfg)
    out = dec(wire)
    for k in grads:
        err = (out[k] - grads[k]).abs().max().item()
        scale = grads[k].abs().max().item()
        tol = {"none": 0.0, "bf16": 0.01 * scale, "int8": scale / 100}[codec]
        assert err <= tol + 1e-12


def test_int8_error_feedback_reduces_bias():
    """repro's test_substrate case: with error feedback the sum of the
    decoded gradients tracks the true sum."""
    rng = np.random.default_rng(1)
    g = torch.as_tensor(rng.normal(size=(256,)).astype(np.float32) * 1e-3)
    errs = []
    for fb in (True, False):
        cfg = tcomp.CompressConfig(codec="int8", error_feedback=fb)
        state = tcomp.init_state({"g": g}, cfg)
        total = torch.zeros(256)
        for _ in range(50):
            wire, state, dec = tcomp.compress({"g": g}, state, cfg)
            total += dec(wire)["g"]
        errs.append((total - 50 * g).abs().mean().item())
    assert errs[0] <= errs[1]
