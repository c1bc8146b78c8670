"""repro_torch's Checkpointer: repro's checkpoint cases, checkpoints moving
both ways between the packages, and reshard-on-restore over 2 gloo ranks.

Layout: one .npy per leaf named by its path ("params.layers.attn.wq",
"opt.m.embed", "opt.step"), a manifest.json and a COMMITTED marker; a
float32 / int32 leaf is the same .npy bytes whichever package wrote it,
and a bf16 leaf the same 2-byte records.  The reshard check runs this
file's ``__main__`` as 2 gloo ranks:

    python tests/test_torch_checkpoint.py CKPT_DIR RANK 2 INIT_FILE
"""
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs.registry import get_smoke_config
from repro_torch.optim import adamw as topt
from repro_torch.tree import tree_map

WORKER_TIMEOUT = 300  # seconds for the 2-rank subprocess run


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(8, 16)).astype(np.float32),
                   "b": rng.normal(size=(16,)).astype(np.float32)},
        "opt": [np.int32(3), rng.normal(size=(4, 4)).astype(np.float32)],
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.as_tensor(np.array(tree))


def _target(tree):
    """Meta tensors of each leaf's shape and dtype (restore's target)."""
    if isinstance(tree, dict):
        return {k: _target(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_target(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_target(v) for v in tree)
    t = torch.as_tensor(np.array(tree)) if not isinstance(
        tree, torch.Tensor) else tree
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)) and not hasattr(want, "shape"):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        def host(x):
            if not isinstance(x, torch.Tensor):
                return np.asarray(x)
            if x.dtype == torch.bfloat16:     # compared as their bits
                return x.view(torch.int16).numpy()
            return x.numpy()
        w, g = host(want), host(got)
        assert isinstance(got, torch.Tensor)
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------- repro's cases ------
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _torch_tree(_tree())
    ck.save(5, t, extra={"loss": 1.25})
    assert ck.latest_step() == 5
    out = ck.restore(5, _target(t))
    _assert_trees_equal(out, t)
    assert ck.restore_extra(5)["loss"] == 1.25
    assert out["params"]["w"].device.type == "cpu"


def test_checkpoint_atomicity_uncommitted_invisible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    # a crash mid-save: the step dir exists but no COMMIT marker
    os.makedirs(str(tmp_path / "step_0000000002"))
    assert ck.latest_step() == 1
    with pytest.raises(FileNotFoundError, match="not committed"):
        ck.restore(2, _target(_tree()))


def test_checkpoint_gc_keeps_last_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.all_steps() == [3, 4]


def test_checkpoint_keep_every(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1, keep_every=2)
    for s in (1, 2, 3):
        ck.save(s, _tree(s))
    assert ck.all_steps() == [2, 3]  # 2 kept by keep_every, 3 by keep


def test_checkpoint_async_overlaps_and_commits(tmp_path):
    """save_async copies to the host first: changing the tensors after it
    returns does not change what it writes."""
    ck = Checkpointer(str(tmp_path))
    t = _torch_tree(_tree())
    want = _torch_tree(_tree())
    ck.save_async(7, t)
    t["params"]["w"].add_(1.0)
    ck.wait()
    assert ck.latest_step() == 7
    _assert_trees_equal(ck.restore(7, _target(t)), want)


def test_checkpoint_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def failing_save(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "save", failing_save)
    ck.save_async(3, _tree())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.latest_step() is None
    ck.wait()        # the error is raised once


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"w": torch.empty((3, 2), device="meta")})


def test_restore_takes_the_target_dtype_and_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "h": torch.tensor([1.5, -2.0]).bfloat16()})
    out = ck.restore(1, {"w": torch.empty((2, 3), dtype=torch.float64),
                         "h": torch.empty((2,), dtype=torch.bfloat16,
                                          device="meta")})
    assert out["w"].dtype == torch.float64
    assert out["h"].dtype == torch.bfloat16 and out["h"].device.type == "cpu"
    assert out["h"].tolist() == [1.5, -2.0]
    assert ck.manifest(1)["leaves"][0] == {"name": "h", "shape": [2],
                                           "dtype": "bfloat16"}


# ------------------------------------------------- between the packages ---
def _train_state(seed=0):
    """A stablelm-3b smoke parameter tree and an AdamW state in numpy,
    plus an extra bf16 leaf: repro's train checkpoint layout."""
    from repro_torch.models.template import init_params
    from repro_torch.models.transformer import model_template
    cfg = get_smoke_config("stablelm-3b")
    tp = init_params(model_template(cfg), torch.Generator().manual_seed(seed),
                     cfg.param_dtype, "cpu")
    ts = topt.OptState(tree_map(lambda p: p * 0.5 + 0.25, tp),
                       tree_map(lambda p: p.square(), tp),
                       torch.tensor(4, dtype=torch.int32))
    return {"params": tp, "opt": ts,
            "aux": [torch.linspace(-3, 3, 7).bfloat16()]}


def _to_jax(tree):
    """The port's tree -> repro's (jnp arrays; OptState -> repro's)."""
    from repro.optim.adamw import OptState as JOptState
    if isinstance(tree, topt.OptState):
        return JOptState(*(_to_jax(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".npy"):
            with open(os.path.join(d, name), "rb") as f:
                data = f.read()
            # the header names bf16 records '<V2' (ml_dtypes) or '|V2'
            out[name] = hashlib.sha256(data.replace(b"'<V2'", b"'|V2'")
                                       ).hexdigest()
    return out


def test_layout_and_bytes_match_repro(tmp_path):
    """The same train state saved by both: the same file names, manifest
    and .npy bytes (bf16 records included)."""
    from repro.checkpoint import Checkpointer as JCheckpointer
    state = _train_state()
    Checkpointer(str(tmp_path / "port")).save(3, state, extra={"loss": 2.5})
    JCheckpointer(str(tmp_path / "repro")).save(3, _to_jax(state),
                                                extra={"loss": 2.5})
    pd, jd = (str(tmp_path / k / "step_0000000003") for k in ("port",
                                                              "repro"))
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    assert "opt.step.npy" in os.listdir(pd)
    assert "params.layers.attn.wq.npy" in os.listdir(pd)
    assert "opt.m.layers.mlp.w_up.npy" in os.listdir(pd)
    with open(os.path.join(pd, "manifest.json")) as f:
        pm = json.load(f)
    with open(os.path.join(jd, "manifest.json")) as f:
        jm = json.load(f)
    assert pm == jm
    assert _files(pd) == _files(jd)


def test_repro_checkpoint_restores_in_port(tmp_path):
    from repro.checkpoint import Checkpointer as JCheckpointer
    state = _train_state(1)
    JCheckpointer(str(tmp_path)).save(6, _to_jax(state))
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 6
    _assert_trees_equal(ck.restore(6, _target(state)), state)


def test_port_checkpoint_restores_in_repro(tmp_path):
    """float32 / int32 leaves come back equal; a bf16 leaf comes back as
    the records repro reads back from its own checkpoints (V2 without
    ml_dtypes' dtype attached), with the same bits."""
    from repro.checkpoint import Checkpointer as JCheckpointer
    state = _train_state(2)
    Checkpointer(str(tmp_path)).save(9, state)
    spec = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        _to_jax(state))
    out = JCheckpointer(str(tmp_path)).restore(9, spec)
    want = jax.tree.map(np.asarray, _to_jax(state))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(out)):
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(np.asarray(g).view(np.uint16),
                                          w.view(np.uint16), str(path))
        else:
            assert g.dtype == w.dtype, path
            np.testing.assert_array_equal(g, w, str(path))


# ------------------------------------------------- reshard-on-restore ----
def test_reshard_on_restore_over_two_gloo_ranks(tmp_path):
    """Saved whole by one process; restored by 2 gloo ranks under the
    FSDP rule on a (data 2, model 1) mesh (`build_mesh` of
    `plan_remesh`) and the TP rule on a (1, 2) one (`make_host_mesh`):
    each rank's DTensor shard equals its slice, and each rank read from
    each memory-mapped .npy only that slice."""
    state = _train_state(3)
    Checkpointer(str(tmp_path / "ckpt")).save(2, {"params": state["params"],
                                                  "opt": state["opt"]})
    env = {**os.environ,
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), os.pardir,
                                      "src")}
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp_path / "ckpt"), str(rank), "2",
         str(store)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = "\n".join(f"-- rank {r} (rc {p.returncode})\n{o}"
                       for r, (p, o) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), report
    assert all(o.count("ok:") == 2 for o in outs), report


def _worker(ckpt_dir: str, rank: int, world_size: int, store: str) -> None:
    """One rank of the reshard check (see the test above)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.template import leaves
    from repro_torch.models.transformer import model_template
    from repro_torch.runtime import build_mesh, plan_remesh
    from repro_torch.sharding.partition import (
        PROD_RULES, Sharding, tree_shardings,
    )
    reads = {}
    real_load = np.load

    class Recorder:
        """A memory-mapped .npy that notes each index read from it."""

        def __init__(self, path, mmap_mode=None):
            self.mm = real_load(path, mmap_mode=mmap_mode)
            self.name = os.path.basename(path)[:-len(".npy")]
            self.shape, self.dtype = self.mm.shape, self.mm.dtype

        def __getitem__(self, index):
            reads.setdefault(self.name, []).append(index)
            return self.mm[index]

    cfg = get_smoke_config("stablelm-3b")
    template = model_template(cfg)
    axes, meta = {}, {}
    for path, lf in leaves(template):
        *parents, last = path.split("/")
        a, m = axes, meta
        for k in parents:
            a, m = a.setdefault(k, {}), m.setdefault(k, {})
        a[last] = lf.axes
        m[last] = torch.empty(lf.shape, device="meta")
    full = Checkpointer(ckpt_dir).restore(
        2, {"params": meta, "opt": topt.init(meta, topt.OptConfig())})
    ckpt_mod.np.load = Recorder
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    try:
        plan = plan_remesh(2, 0, model=1)
        assert plan.shape == (2, 1) and plan.n_devices == 2
        for tag, mesh in (("fsdp (2, 1)", build_mesh(plan, "cpu")),
                          ("tp (1, 2)", make_host_mesh(1, 2, "cpu"))):
            reads.clear()
            psh = tree_shardings(mesh, axes, meta, PROD_RULES)
            repl = Sharding(mesh, ())
            placements = {"params": psh, "opt": topt.opt_state_sharding(
                psh, meta, topt.OptConfig(), repl)}
            got = Checkpointer(ckpt_dir).restore(
                2, {"params": meta, "opt": topt.init(meta, topt.OptConfig())},
                placements)
            coord = mesh.get_coordinate()
            n_split = 0
            for name, sh, g, w in _leaves4(placements, got, full):
                assert isinstance(g, DTensor), name
                assert tuple(g.placements) == sh.placements, name
                index = sh.local_index(tuple(w.shape), coord)
                local = g.to_local()
                np.testing.assert_array_equal(local.numpy(),
                                              w.numpy()[index], name)
                assert reads[name] == [index], (name, reads[name], index)
                n_split += any(s != slice(None) for s in index)
                np.testing.assert_array_equal(g.full_tensor().numpy(),
                                              w.numpy(), name)
            assert n_split >= 7, (tag, n_split)   # most matrices are split
            print(f"ok: rank {rank} {tag}: {n_split} leaves split, each "
                  f"read as its slice")
    finally:
        dist.destroy_process_group()


def _leaves4(placements, got, full, path=()):
    """(name, Sharding, restored leaf, whole leaf) of the three trees."""
    if isinstance(full, dict):
        for k in sorted(full):
            yield from _leaves4(placements[k], got[k], full[k], path + (k,))
    elif isinstance(full, tuple):
        fields = getattr(full, "_fields", range(len(full)))
        for i, f in enumerate(fields):
            yield from _leaves4(placements[i], got[i], full[i],
                                path + (str(f),))
    else:
        yield ".".join(path), placements, got, full


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
