"""repro_torch's LM serving steps over a (data, model) mesh of gloo ranks on
the CPU: `prefill_step` and `decode_step` with ``ctx=ShardCtx(mesh)`` for
every family with FSDP over ``data`` and tensor parallelism over
``model`` (the decode cache split over kv heads or over positions, the
SSM states over their inner channels and heads, as repro's dry run splits
them), held against the port's one-device steps and against repro's
GSPMD steps on 4 forced CPU devices.

The rank workers are this file's ``__main__``; one launch of 4 ranks runs
every mesh in turn while one repro process runs the same cases, and each
writes what it saw to files that the tests read:

    python tests/test_torch_serve_mesh.py ranks OUT RANK 4 INIT_FILE
    python tests/test_torch_serve_mesh.py repro OUT

(``repro`` runs under XLA_FLAGS=--xla_force_host_platform_device_count=4;
both read OUT/params.npz, which the fixture writes.)

Each case is one prefill of a global batch and DECODE teacher-forced
decode steps (fixed tokens, so that a near-tie of two logits cannot fork
the runs), in float32 activations, parameters and cache.  Against the
one-device port: the logits of this rank's rows and its slice of the
final cache within ONE_DEVICE_RTOL of the largest |value|, and bit for
bit on a (1, 1) mesh.  Against repro on a mesh of the same shape: within
REPRO_RTOL of the largest |value|.  MoE is held against the one-device
port only where the mesh routes in the one-device group count (repro
counts groups over the mesh's shards), and there its routed expert ids
in every layer and step must equal the one-device steps'.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCH_NAMES, get_smoke_config
from repro_torch.models.moe import pick_groups
from repro_torch.models.template import init_params, leaves
from repro_torch.models.transformer import (
    DEFAULT_MOE_GROUPS, model_template,
)

WORKER_TIMEOUT = 300        # seconds for one launch of the workers
ONE_DEVICE_RTOL, REPRO_RTOL = 1e-5, 1e-4
DECODE = 4
ROWS, MAX_LEN = 4, 20

CONFIGS = {
    # 4 kv heads: a model axis of 2 or 4 splits the cache by kv heads
    "stablelm": ("stablelm-3b", {}),
    # one kv head: the cache splits its positions, and a model axis cuts
    # wk / wv's 16 columns
    "yi_cut_kv": ("yi-6b", {}),
    # head_dim 18: at a model axis of 4 wk / wv stay whole (18 columns)
    "yi_repl_kv": ("yi-6b", {"head_dim": 18}),
    # 6 q heads in 2 groups: a model axis of 4 cuts q heads, so every
    # rank computes all 6 (wq gathered) and keeps its rows of wo
    "yi_cut_q": ("yi-6b", {"n_heads": 6, "n_kv_heads": 2}),
    "moe": ("llama4-scout-17b-a16e", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "vlm": ("qwen2-vl-7b", {}),
    "audio": ("musicgen-medium", {}),
    # top-k 2 (kimi-k2's smoke config)
    "moe_k2": ("kimi-k2-1t-a32b", {}),
    # d_model 48: 6 ssm heads, which a model axis of 4 does not divide
    # (every rank runs every head; the ssm state stays whole, the conv
    # window's 128 channels split)
    "ssm_odd": ("mamba2-2.7b", {"d_model": 48}),
}
FAMILIES = ("stablelm", "moe", "hybrid", "ssm", "vlm", "audio")
DENSE = ("stablelm", "yi_cut_kv", "yi_repl_kv")
# tensor parallelism over model for every family but dense: the smoke
# configs' q heads (4), experts (8) and ssm_heads (8) divide every model
# extent here; one kv head (moe, moe_k2, vlm) does not, so their caches
# split their positions (and a model extent of 4 leaves audio's and
# hybrid's 4 kv heads one a rank)
TP_FAMILIES = ("moe", "moe_k2", "ssm", "hybrid", "vlm", "audio")
TP_MESHES = ((1, 2), (2, 2), (1, 4))
# prompt positions: 17 where nothing needs a multiple of 16 (so that the
# last of the DECODE steps of a MAX_LEN cache writes at the clamp), 16
# for SSD's chunks and for moe (whose group count then does not change
# with the mesh)
PROMPT = {"moe": 16, "moe_k2": 16, "hybrid": 16, "ssm": 16, "ssm_odd": 16,
          "vlm": 17, "audio": 17}
VISION = 4                  # vlm: patch embeddings before the text


def _cfg(name: str):
    arch, width = CONFIGS[name]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32", **width)


@dataclasses.dataclass(frozen=True)
class Case:
    mesh: tuple
    name: str
    rows: int = ROWS
    prompt: int | None = None
    max_len: int = MAX_LEN
    tag: str = ""

    @property
    def key(self) -> str:
        return f"{self.mesh[0]}x{self.mesh[1]}/{self.name}{self.tag}"

    @property
    def positions(self) -> int:
        return self.prompt or PROMPT.get(self.name, 17)


CASES = (
    [Case((1, 1), n) for n in FAMILIES + ("moe_k2",)]
    + [Case((2, 1), n) for n in FAMILIES]
    # rows that do not divide data: every data rank serves all 3
    + [Case((2, 1), n, rows=3, tag="/3rows") for n in ("stablelm", "moe")]
    # an odd prompt on a moe mesh: 2 x 21 tokens route in 14 groups
    + [Case((2, 1), "moe", rows=2, prompt=21, max_len=24, tag="/2x21")]
    + [Case((1, 2), n) for n in DENSE]
    + [Case((4, 1), n) for n in FAMILIES]
    + [Case((2, 2), n) for n in DENSE]
    + [Case((1, 4), n) for n in DENSE + ("yi_cut_q",)]
    + [Case(m, n) for m in TP_MESHES for n in TP_FAMILIES]
    + [Case((1, 4), "ssm_odd")]
)


def _inputs(case: Case) -> dict:
    """The case's global prompt batch and decode tokens, from numpy under
    a seed of its own (numpy arrays; vlm's positions start with VISION
    patch embeddings)."""
    cfg = _cfg(case.name)
    B, S = case.rows, case.positions
    rng = np.random.default_rng([B, S, sum(map(ord, case.name))])
    if cfg.family == "audio":
        toks = rng.integers(0, cfg.vocab_size, (B, S, cfg.n_codebooks))
        dec = rng.integers(0, cfg.vocab_size, (DECODE, B, 1,
                                               cfg.n_codebooks))
    else:
        n_text = S - (VISION if cfg.family == "vlm" else 0)
        toks = rng.integers(0, cfg.vocab_size, (B, n_text))
        dec = rng.integers(0, cfg.vocab_size, (DECODE, B, 1))
    batch = {"tokens": toks.astype(np.int64)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (rng.standard_normal(
            (B, VISION, cfg.d_model)) * 0.02).astype(np.float32)
    return {"batch": batch, "decode": dec.astype(np.int64)}


def _groups_equal(case: Case) -> bool:
    """Whether the mesh routes every forward of the case in the one-device
    group count (always true but for moe)."""
    if _cfg(case.name).family != "moe":
        return True
    shards = case.mesh[0] * case.mesh[1]
    return all(pick_groups(n, 1, DEFAULT_MOE_GROUPS)
               == pick_groups(n, shards, DEFAULT_MOE_GROUPS)
               for n in (case.rows * case.positions, case.rows))


def _seq_split(case: Case) -> bool:
    """Whether the case's decode cache splits its positions over model
    (its kv heads do not divide by the model extent)."""
    m = case.mesh[1]
    return m > 1 and _cfg(case.name).n_kv_heads % m != 0


def _first_clamped(case: Case) -> int:
    """The first of the case's logits (0: the prefill's, t: decode step
    t's) whose step writes at the cache's clamp (cache_len >= max_len),
    or DECODE + 1."""
    for t in range(1, DECODE + 1):
        if case.positions + t - 1 >= case.max_len:
            return t
    return DECODE + 1


def _param_arrays(path: str, name: str) -> dict:
    """repro's nested tree of numpy leaves of config ``name``."""
    z = np.load(path)
    out: dict = {}
    for k in z.files:
        if k.startswith(name + "/"):
            node = out
            *parents, last = k[len(name) + 1:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = z[k]
    return out


def _cache_leaves(cache) -> dict:
    """{name: array} of a DecodeCache's buffers (either package's)."""
    out = {}
    if not isinstance(cache.kv_k, tuple):
        out["kv_k"], out["kv_v"] = cache.kv_k, cache.kv_v
    if len(cache.ssm):
        out["conv"], out["ssm"] = cache.ssm.conv, cache.ssm.ssm
    return out


@contextlib.contextmanager
def _routes():
    """The expert ids of every routing in the block (`moe.route`'s top k),
    in call order."""
    from repro_torch.models import moe
    seen, real = [], moe.route

    def recording(logits, k):
        out = real(logits, k)
        seen.append(out[1].clone())
        return out

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = real


def _routes_equal(got: list, want: list, rows: tuple, n_rows: int) -> bool:
    """Whether a mesh rank's routings, layer by layer and step by step,
    gave each of its rows' tokens the expert ids the one-device steps
    gave them (``want``: those of all ``n_rows`` rows)."""
    if len(got) != len(want) or not want:
        return False
    for g, w in zip(got, want):
        w = w.reshape(-1, w.shape[-1])
        n = w.shape[0] // n_rows
        if not torch.equal(g.reshape(-1, g.shape[-1]),
                           w[rows[0] * n:rows[1] * n]):
            return False
    return True


def _launch(argv_of, n: int) -> list:
    """Start ``n`` worker processes (``argv_of(rank)``) and return them."""
    env = {**os.environ,
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), os.pardir,
                                      "src")}
    return [subprocess.Popen(argv_of(r), env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def _wait(procs) -> None:
    """Wait for every process; each must exit 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = "\n".join(f"-- worker {r} (rc {p.returncode})\n{o}"
                       for r, (p, o) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), report


# ------------------------------------------------- the rank workers' cases --
def _mesh(shape, ranks=None):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(shape[0] * shape[1]) if ranks is None \
        else torch.tensor(ranks)
    return DeviceMesh("cpu", ranks.reshape(shape),
                      mesh_dim_names=("data", "model"))


def _serve(params, case: Case, ctx=None):
    """Prefill + the decode steps: (logits (DECODE + 1, B, ...), cache)."""
    from repro_torch.models.model import decode_step, prefill_step
    cfg = _cfg(case.name)
    inp = _inputs(case)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    with torch.no_grad():
        logits, cache = prefill_step(params, batch, cfg, case.max_len,
                                     torch.float32, ctx=ctx)
        out = [logits]
        for t in inp["decode"]:
            lg, cache = decode_step(params, cache, torch.from_numpy(t), cfg,
                                    ctx=ctx)
            out.append(lg)
    return torch.stack(out), cache


def _local(whole: dict, cfg, mesh) -> dict:
    """This rank's slices of the parameters ``whole``, by their specs."""
    from repro_torch.models.model import param_shardings
    coord = mesh.get_coordinate()

    def cut(t, sh):
        if isinstance(t, dict):
            return {k: cut(t[k], sh[k]) for k in t}
        return t[sh.local_index(tuple(t.shape), coord)].clone()
    return cut(whole, param_shardings(cfg, mesh))


def serve_case(case: Case, mesh, whole: dict, one: dict) -> tuple:
    """One case on ``mesh`` against the one-device steps (memoised in
    ``one``): the numbers the tests hold, and this rank's arrays with the
    global index of each."""
    from repro_torch.sharding.partition import (
        ShardCtx, Sharding, batch_lead, cache_specs,
    )
    coord = mesh.get_coordinate()
    local = _local(whole, _cfg(case.name), mesh)
    t0 = time.time()
    with _routes() as routes:
        logits, cache = _serve(local, case, ShardCtx(mesh))
    seconds = time.time() - t0
    key = (case.name, case.rows, case.positions, case.max_len)
    if key not in one:
        with _routes() as one_routes:
            one[key] = (*_serve(whole, case), one_routes)
    w_logits, w_cache, w_routes = one[key]
    # this rank's rows, and its slice of each cache buffer
    d = mesh.get_local_rank("data")
    if batch_lead(mesh, ShardCtx().rules, case.rows) is None:
        r0, r1 = 0, case.rows
    else:
        b = case.rows // mesh.size(0)
        r0, r1 = d * b, (d + 1) * b
    sp = cache_specs(w_cache, mesh)
    specs = {"kv_k": sp.kv_k, "kv_v": sp.kv_v}
    if len(sp.ssm):
        specs.update(conv=sp.ssm.conv, ssm=sp.ssm.ssm)
    got, want, index = _cache_leaves(cache), {}, {}
    for k, w in _cache_leaves(w_cache).items():
        idx = Sharding(mesh, specs[k]).local_index(tuple(w.shape), coord)
        want[k] = w[idx]
        index[k] = [list(s.indices(n))[:2] for s, n in zip(idx, w.shape)]
    want_logits = w_logits[:, r0:r1]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rec = {"rows": [r0, r1], "cache_index": index, "seconds": seconds,
           "logits_shape": list(logits.shape),
           "want_logits_shape": list(want_logits.shape),
           "cache_shapes": {k: list(v.shape) for k, v in got.items()},
           "want_cache_shapes": {k: list(v.shape) for k, v in want.items()},
           "groups_equal": _groups_equal(case)}
    if w_routes:
        rec["routes_equal"] = _routes_equal(routes, w_routes, (r0, r1),
                                            case.rows)
    if rec["logits_shape"] == rec["want_logits_shape"] and \
            rec["cache_shapes"] == rec["want_cache_shapes"]:
        rec["logits_rel"] = rel(logits, want_logits)
        rec["cache_rel"] = {k: rel(got[k], want[k]) for k in got}
        rec["bit_identical"] = bool(
            torch.equal(logits, want_logits)
            and all(torch.equal(got[k], want[k]) for k in got))
    arrays = {"logits": logits.numpy(), **{k: v.numpy()
                                           for k, v in got.items()}}
    return rec, arrays


def _refusals(mesh, whole: dict, out: dict) -> None:
    """A sequence split that the cache's positions do not divide raises
    before it serves."""
    from repro_torch.models.model import prefill_step
    from repro_torch.sharding.partition import ShardCtx
    name = "yi_cut_kv"
    batch = {k: torch.from_numpy(v) for k, v in
             _inputs(Case((1, 2), name))["batch"].items()}
    try:
        prefill_step(_local(whole[name], _cfg(name), mesh), batch,
                     _cfg(name), 21, torch.float32, ctx=ShardCtx(mesh))
        out["refuse/seq_split"] = "served"
    except ValueError as e:
        out["refuse/seq_split"] = f"{type(e).__name__}: {e}"


def _audio_embed_case(mesh, whole: dict, out: dict) -> None:
    """audio's embedding on a model axis that splits its vocab: the
    embedding of this rank's blocks of the K tables (summed over the axis)
    against `take_fill` of each whole table, and the former whole-table
    `_embed` run on the rank's blocks (which reads other rows), over
    ids that wrap ([-V, -1]) and fall outside [-V, V - 1] too."""
    from repro_torch.models.transformer import (
        _embed, model_parallel, take_fill,
    )
    from repro_torch.sharding.partition import ShardCtx
    cfg = _cfg("audio")
    V, K = cfg.vocab_size, cfg.n_codebooks
    tokens = torch.from_numpy(_inputs(Case((1, 2), "audio"))["batch"]
                              ["tokens"]).clone()
    tokens[0, :4] = torch.tensor([-1, -V, V, -V - 1])[:, None]
    local = _local(whole, cfg, mesh)
    par = model_parallel(cfg, ShardCtx(mesh))
    got = _embed(local, cfg, {"tokens": tokens}, par)[0]

    def embed(table):
        return sum(take_fill(table[k], tokens[..., k]) for k in range(K))
    want = embed(whole["embed"])
    old = embed(local["embed"])

    def same(a, b):
        return (a == b) | (a.isnan() & b.isnan())
    out["embed/audio"] = {
        "vocab_split": par.vocab_split,
        "block_rows": int(local["embed"].shape[1]),
        "equal": bool(same(got, want).all()),
        "old_rows_off": float((~same(old, want).all(-1)).float().mean())}


def ranks_worker(out_dir: str, rank: int, world: int, store: str) -> None:
    """Rank ``rank`` of the 4-rank launch: every mesh in turn."""
    from repro_torch.convert import lm_params_from_jax
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    whole = {n: lm_params_from_jax(_param_arrays(
        os.path.join(out_dir, "params.npz"), n), _cfg(n)) for n in CONFIGS}
    out, arrays, one = {}, {}, {}
    t0 = time.time()
    try:
        # every mesh is made by every rank, in one order
        meshes = {(1, 1): [_mesh((1, 1), [r]) for r in range(world)],
                  (2, 1): _mesh((2, 1), [0, 1]), (1, 2): _mesh((1, 2), [2, 3]),
                  (4, 1): _mesh((4, 1)), (2, 2): _mesh((2, 2)),
                  (1, 4): _mesh((1, 4))}
        for i, case in enumerate(CASES):
            if case.mesh == (1, 1):
                # one family a rank at a time, each on its own (1, 1) mesh
                if i % world != rank:
                    continue
                mesh = meshes[(1, 1)][rank]
            else:
                mesh = meshes[case.mesh]
                if mesh.get_coordinate() is None:
                    continue
            rec, arr = serve_case(case, mesh, whole[case.name], one)
            out[case.key] = rec
            for k, v in arr.items():
                arrays[f"{case.key}/{k}"] = v
            if case.mesh == (1, 2) and case.name == DENSE[-1]:
                _refusals(mesh, whole, out)
                _audio_embed_case(mesh, whole["audio"], out)
        out["seconds"] = time.time() - t0
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"ranks_{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"ranks_{rank}.json"), "w") as f:
        json.dump(out, f)


def repro_worker(out_dir: str) -> None:
    """repro's prefill_step / decode_step of every case, jitted on a mesh of
    its shape over 4 forced CPU devices with parameter shardings from
    ``tree_shardings`` and batch and cache shardings as its dry run builds
    them: the logits and the final cache into ``out_dir/repro.npz``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import (
        decode_step, model_abstract_params, model_param_axes, prefill_step,
    )
    from repro.sharding.partition import (
        ShardCtx, ShardingRules, spec_for, tree_shardings,
    )
    assert len(jax.devices()) == 4, jax.devices()
    rules = ShardingRules()
    saved = {}
    t0 = time.time()

    def run(case: Case, prefix: str) -> None:
        cfg = JModelConfig(**dataclasses.asdict(_cfg(case.name)))
        mesh = make_host_mesh(*case.mesh)
        ctx = ShardCtx(mesh=mesh, rules=rules)
        n_b = mesh.shape["data"]
        lead = rules.batch_axes if case.rows % n_b == 0 else None

        def rows_sharding(ndim):
            return NamedSharding(mesh, P(lead, *([None] * (ndim - 1))))

        def cache_shardings(cache):
            """The dry run's cache_pspecs, with rows placed as its batch."""
            m = mesh.shape["model"]

            def kv(x):
                if isinstance(x, tuple):
                    return ()
                if x.shape[3] % m == 0:
                    s = spec_for(("layers", "batch", None, "kv_heads", None),
                                 rules, x.shape, mesh)
                else:
                    s = P(None, lead, "model", None, None)
                return NamedSharding(mesh, P(*s))

            ssm = cache.ssm
            if len(ssm):
                ld = ("layers",) * (ssm.conv.ndim - 3)
                ssm = type(ssm)(
                    NamedSharding(mesh, P(*spec_for(
                        ld + ("batch", None, "ssm_inner"), rules,
                        ssm.conv.shape, mesh))),
                    NamedSharding(mesh, P(*spec_for(
                        ld + ("batch", "ssm_heads", None, None), rules,
                        ssm.ssm.shape, mesh))))
            return cache._replace(kv_k=kv(cache.kv_k), kv_v=kv(cache.kv_v),
                                  ssm=ssm, length=NamedSharding(mesh, P()))

        psh = tree_shardings(mesh, model_param_axes(cfg),
                             model_abstract_params(cfg), rules)
        params = jax.device_put(jax.tree.map(
            jnp.asarray, _param_arrays(os.path.join(out_dir, "params.npz"),
                                       case.name)), psh)
        inp = _inputs(case)
        batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
        bsh = {k: rows_sharding(v.ndim) for k, v in batch.items()}

        def pre(p, b):
            return prefill_step(p, b, cfg, case.max_len, ctx=ctx,
                                cache_dtype=jnp.float32)

        cache_abs = jax.eval_shape(pre, params, batch)[1]
        csh = cache_shardings(cache_abs)
        n_logit = 3 if cfg.family == "audio" else 2
        lsh = rows_sharding(n_logit)
        with mesh:
            logits, cache = jax.jit(pre, in_shardings=(psh, bsh),
                                    out_shardings=(lsh, csh))(params, batch)
            dec = jax.jit(lambda p, c, t: decode_step(p, c, t, cfg, ctx=ctx),
                          in_shardings=(psh, csh, rows_sharding(
                              inp["decode"].ndim - 1)),
                          out_shardings=(lsh, csh))
            out = [logits]
            for t in inp["decode"]:
                lg, cache = dec(params, cache, jnp.asarray(t))
                out.append(lg)
        saved[f"{prefix}/logits"] = np.stack([np.asarray(x) for x in out])
        for k, v in _cache_leaves(cache).items():
            saved[f"{prefix}/{k}"] = np.asarray(v)

    for case in CASES:
        run(case, case.key)
    # repro's one-device steps of each case whose cache splits its
    # positions (see _seq_split)
    for name in sorted({c.name for c in CASES if _seq_split(c)}):
        run(Case((1, 1), name), f"one/{name}")
    np.savez(os.path.join(out_dir, "repro.npz"), **saved)
    print(f"ok: repro's {len(CASES)} cases in {time.time() - t0:.1f} s")


# ------------------------------------------------------------------ tests --
@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The parameters of every config (a seeded torch draw), then repro's
    process and the 4-rank launch at once."""
    out = tmp_path_factory.mktemp("serve_mesh")
    arrays = {}
    for i, name in enumerate(CONFIGS):
        cfg = _cfg(name)
        params = init_params(model_template(cfg), torch.Generator()
                             .manual_seed(20 + i), cfg.param_dtype, "cpu")
        for path, _ in leaves(model_template(cfg)):
            node = params
            for k in path.split("/"):
                node = node[k]
            arrays[f"{name}/{path}"] = node.numpy()
    np.savez(out / "params.npz", **arrays)
    t0 = time.time()
    procs = _launch(lambda r: [sys.executable, __file__, "repro", str(out)],
                    1)
    procs += _launch(lambda r: [sys.executable, __file__, "ranks", str(out),
                                str(r), "4", str(out / "store")], 4)
    _wait(procs)
    print(f"repro and 4 ranks: {time.time() - t0:.1f} s")
    ranks = [json.load(open(out / f"ranks_{r}.json")) for r in range(4)]
    arrays = [dict(np.load(out / f"ranks_{r}.npz")) for r in range(4)]
    return {"ranks": ranks, "arrays": arrays,
            "repro": dict(np.load(out / "repro.npz"))}


def _seen(mesh_runs, key) -> list:
    """(rank, record) of every rank that served case ``key``."""
    seen = [(r, rec[key]) for r, rec in enumerate(mesh_runs["ranks"])
            if key in rec]
    assert seen, key
    return seen


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.key)
def test_serve_mesh_matches_one_device(mesh_runs, case):
    """Each rank's logits and cache slice against its rows and slice of
    the one-device steps: bit for bit on a (1, 1) mesh."""
    seen = _seen(mesh_runs, case.key)
    assert len(seen) == case.mesh[0] * case.mesh[1], seen
    for r, rec in seen:
        assert rec["logits_shape"] == rec["want_logits_shape"], (r, rec)
        assert rec["cache_shapes"] == rec["want_cache_shapes"], (r, rec)
        if case.mesh == (1, 1):
            assert rec["bit_identical"], (r, rec)
        if rec["groups_equal"]:
            assert rec["logits_rel"] <= ONE_DEVICE_RTOL, (r, rec)
            for k, e in rec["cache_rel"].items():
                assert e <= ONE_DEVICE_RTOL, (r, k, rec)
            if _cfg(case.name).family == "moe":
                assert rec["routes_equal"] is True, (r, rec)
        else:
            # the one-device port routes in other groups: repro's test
            assert _cfg(case.name).family == "moe", rec


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.key)
def test_serve_mesh_matches_repro(mesh_runs, case):
    """Each rank's logits and cache slice against repro's GSPMD steps on a
    mesh of the same shape (its rows, its slice of each cache buffer).

    Where the cache splits its positions over model, a decode that writes
    at the clamp (cache_len >= max_len) is held, with the cache after it,
    against repro's one-device steps: XLA's partitioner drops such a
    write on a split dimension where ``dynamic_update_slice`` clamps it
    (test_repro_mesh_drops_a_clamped_write)."""
    def of(prefix):
        return {k[len(prefix) + 1:]: v for k, v in mesh_runs["repro"].items()
                if k.startswith(prefix + "/")}
    want = of(case.key)
    assert "logits" in want, case.key
    t = _first_clamped(case) if _seq_split(case) else DECODE + 1
    if t <= DECODE:
        one = of(f"one/{case.name}")
        want["logits"] = np.concatenate([want["logits"][:t],
                                         one["logits"][t:]])
        want.update((k, v) for k, v in one.items() if k != "logits")
    for r, rec in _seen(mesh_runs, case.key):
        got = {k[len(case.key) + 1:]: v
               for k, v in mesh_runs["arrays"][r].items()
               if k.startswith(case.key + "/")}
        assert set(got) == set(want), (got.keys(), want.keys())
        r0, r1 = rec["rows"]
        w = want["logits"][:, r0:r1]
        np.testing.assert_allclose(got["logits"], w, rtol=0,
                                   atol=REPRO_RTOL * np.abs(w).max())
        for k, idx in rec["cache_index"].items():
            w = want[k][tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=REPRO_RTOL * np.abs(w).max(),
                                       err_msg=f"{case.key} rank {r} {k}")


def test_repro_mesh_drops_a_clamped_write(mesh_runs):
    """repro's decode on a (1, 2) mesh whose cache splits its 20 positions
    over model: the steps before the clamp equal its one-device steps;
    the step at cache_len 20 does not (its write is dropped, where one
    device overwrites position 19), so the port follows one device."""
    case = Case((1, 2), "yi_cut_kv")
    t = _first_clamped(case)
    assert t == DECODE and _seq_split(case)
    mesh = mesh_runs["repro"][f"{case.key}/logits"]
    one = mesh_runs["repro"]["one/yi_cut_kv/logits"]
    top = np.abs(one).max()
    assert np.abs(mesh[:t] - one[:t]).max() <= REPRO_RTOL * top
    assert np.abs(mesh[t] - one[t]).max() > 1e-2 * top


@pytest.mark.parametrize("case", [c for c in CASES if c.mesh[1] > 1
                                  or c.rows % c.mesh[0]],
                         ids=lambda c: c.key)
def test_ranks_serving_the_same_rows_agree_bit_for_bit(mesh_runs, case):
    """The ranks along ``model`` (and, where the rows do not divide it,
    along ``data``) return the same logits for the same rows, bit for
    bit: the sums over ``model`` and the softmax combine reach every rank
    in one order."""
    seen = {}
    for r, rec in _seen(mesh_runs, case.key):
        got = mesh_runs["arrays"][r][f"{case.key}/logits"]
        rows = tuple(rec["rows"])
        if rows in seen:
            np.testing.assert_array_equal(got, seen[rows])
        seen.setdefault(rows, got)
    assert len(seen) < len(_seen(mesh_runs, case.key))


def test_cache_is_split_as_repros_dry_run(mesh_runs):
    """The slices the ranks hold: kv heads over model where they divide
    (stablelm), positions otherwise (yi); rows over data, and all rows
    where they do not divide it."""
    def index(key, rank):
        return mesh_runs["ranks"][rank][key]["cache_index"]
    # (1, 4) stablelm: KV 4 -> one kv head a rank, every position
    for r in range(4):
        assert index("1x4/stablelm", r)["kv_k"][3] == [r, r + 1]
        assert index("1x4/stablelm", r)["kv_k"][2] == [0, MAX_LEN]
    # (2, 2) yi: one kv head -> half the positions a model rank, half the
    # rows a data rank
    for r in range(4):
        d, m = divmod(r, 2)
        idx = index("2x2/yi_cut_kv", r)["kv_k"]
        assert idx[1] == [2 * d, 2 * d + 2] and idx[2] == [10 * m,
                                                           10 * m + 10]
    # 3 rows on data 2: each rank all of them
    for r in (0, 1):
        assert mesh_runs["ranks"][r]["2x1/stablelm/3rows"]["rows"] == [0, 3]
        assert index("2x1/moe/3rows", r)["kv_k"][1] == [0, 3]


def test_odd_moe_prompt_routes_in_repros_groups(mesh_runs):
    """2 x 21 tokens on data 2: repro's 14 groups, 7 a rank (the port
    raised here before it counted groups over the mesh); its result is
    held against repro's by test_serve_mesh_matches_repro."""
    assert pick_groups(42, 2, DEFAULT_MOE_GROUPS) == 14
    assert not _groups_equal(Case((2, 1), "moe", rows=2, prompt=21))
    assert len(_seen(mesh_runs, "2x1/moe/2x21")) == 2


@pytest.mark.parametrize("key", ["seq_split"])
def test_serving_refuses_on_a_mesh(mesh_runs, key):
    """A 21-position cache whose positions a model axis of 2 would split:
    it raises."""
    want = {"seq_split": "ValueError: a decode cache of 21 positions and 1 "
                         "kv heads splits over neither"}
    for r in (2, 3):
        assert mesh_runs["ranks"][r][f"refuse/{key}"].startswith(want[key])


def test_audio_embedding_reads_the_rank_block(mesh_runs):
    """On the (1, 2) mesh, audio's (K, V, d) embedding splits its vocab:
    each rank holds V / 2 rows of each codebook's table.  The vocab-split
    embedding equals `take_fill` of the whole tables bit for bit (wrapped
    ids and NaN rows too); the former `_embed`, `take_fill` over each
    table a rank holds, reads other rows or NaN for most tokens."""
    for r in (2, 3):
        got = mesh_runs["ranks"][r]["embed/audio"]
        assert got["vocab_split"] and got["block_rows"] == 128, got
        assert got["equal"], got
        assert got["old_rows_off"] > 0.5, got


# ------------------------------------ placement at the published widths --
class _Mesh:
    """A (data, model) mesh's shape as `cache_specs` and `init_cache` read
    it (and as repro's ``spec_for`` reads ``mesh.shape``), held at one
    coordinate: no ranks needed."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model, coordinate=(0, 0)):
        self._shape, self._coordinate = (data, model), list(coordinate)
        self.shape = _Shape(zip(self.mesh_dim_names, self._shape))

    def get_coordinate(self):
        return self._coordinate


class _Shape(dict):
    """``mesh.shape``: a dict by axis name for repro, iterable in mesh-dim
    order for the port."""

    def __iter__(self):
        return iter(self.values())


def _spec(entries) -> tuple:
    """A spec with one-axis tuples written as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


@pytest.mark.parametrize("rows", [8, 3])
@pytest.mark.parametrize("arch", sorted(ARCH_NAMES))
def test_cache_specs_follow_repros_dry_run(arch, rows):
    """Every published config's decode cache of ``rows`` rows and 4,096
    positions on a (2, 8) mesh: each buffer's spec is the one repro's dry
    run builds (`cache_pspecs`, from repro's ``spec_for``; the row entry
    of a sequence split by `batch_lead`), and `init_cache(ctx=)` holds
    the slice of it at coordinate (1, 3)."""
    from repro.sharding.partition import ShardingRules as JRules
    from repro.sharding.partition import spec_for as jspec_for
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_cache
    from repro_torch.sharding.partition import (
        ShardCtx, Sharding, cache_specs,
    )
    cfg, mesh, jr = get_config(arch), _Mesh(2, 8, (1, 3)), JRules()
    whole = init_cache(cfg, rows, 4096, device="meta")
    got = cache_specs(whole, mesh)
    lead = "data" if rows % 2 == 0 else None
    want = {}
    if not isinstance(whole.kv_k, tuple):
        kv = whole.kv_k
        if kv.shape[3] % 8 == 0:
            want["kv"] = jspec_for(("layers", "batch", None, "kv_heads",
                                    None), jr, kv.shape, mesh)
        else:
            want["kv"] = (None, lead, "model", None, None)
        assert _spec(got.kv_k) == _spec(want["kv"]) == _spec(got.kv_v)
    if len(whole.ssm):
        ld = ("layers",) * (whole.ssm.conv.ndim - 3)
        assert _spec(got.ssm.conv) == _spec(jspec_for(
            ld + ("batch", None, "ssm_inner"), jr, whole.ssm.conv.shape,
            mesh))
        assert _spec(got.ssm.ssm) == _spec(jspec_for(
            ld + ("batch", "ssm_heads", None, None), jr,
            whole.ssm.ssm.shape, mesh))
    local = init_cache(cfg, rows, 4096, device="meta", ctx=ShardCtx(mesh))
    for w, spec, t in ((whole.kv_k, got.kv_k, local.kv_k),
                       (whole.kv_v, got.kv_v, local.kv_v),
                       *zip(whole.ssm, got.ssm, local.ssm)):
        if isinstance(w, tuple):
            continue
        assert tuple(t.shape) == Sharding(mesh, spec).local_shape(
            tuple(w.shape), [1, 3])
        assert t.dtype == w.dtype


def test_sequence_split_needs_positions_the_model_axis_divides():
    """yi-6b's 4 kv heads on a model axis of 8: the cache splits its
    positions, which 4,100 do not divide by 8 (refused), 4,096 do."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_cache
    from repro_torch.sharding.partition import ShardCtx
    cfg, ctx = get_config("yi-6b"), ShardCtx(_Mesh(1, 8, (0, 5)))
    with pytest.raises(ValueError, match="4100 positions and 4 kv heads"):
        init_cache(cfg, 8, 4100, device="meta", ctx=ctx)
    got = init_cache(cfg, 8, 4096, device="meta", ctx=ctx)
    assert tuple(got.kv_k.shape) == (cfg.n_layers, 8, 512, 4, cfg.hd)


# ------------------------------------------ the moe group count (Queue C) --
# (data extent, global tokens, groups asked for): counts where the port's
# former pick_groups(N, 1, n_groups) did not divide by the data extent
MOE_GROUP_CASES = [(2, 42, 32), (2, 34, 32), (4, 36, 32), (4, 100, 32),
                   (8, 40, 32), (8, 120, 32), (2, 10, 8), (4, 12, 8),
                   (2, 6, 1), (4, 8, 1)]


@pytest.mark.parametrize("D,N,asked", MOE_GROUP_CASES)
def test_moe_groups_follow_repro_under_a_data_mesh(D, N, asked,
                                                   monkeypatch):
    """The routing groups of N global tokens on a data axis of D (model
    1): repro's ``pick_groups(N, D, n_groups)``, a multiple of D, so each
    data rank routes G / D whole groups of its own rows.  The port used
    to count ``pick_groups(N, 1, n_groups)`` (21 groups for 2 x 21
    tokens, where repro routes in 14) and raise where that did not divide
    by D."""
    import repro.models.moe as jmoe
    from repro_torch.models import moe
    want = jmoe.pick_groups(N, D, asked)
    assert moe.pick_groups(N, D, asked) == want and want % D == 0
    assert moe.pick_groups(N, 1, asked) % D      # the former count
    # moe_forward on one data rank's N / D tokens routes want / D groups
    cfg = _cfg("moe")
    sizes = []
    real = moe.capacity_per_group
    monkeypatch.setattr(moe, "capacity_per_group",
                        lambda ng, c: sizes.append(ng) or real(ng, c))
    monkeypatch.setattr(moe, "all_reduce_", lambda t, axis: t)
    p = init_params(moe.moe_template(cfg), torch.Generator().manual_seed(3),
                    "float32", "cpu")
    x = torch.randn(1, N // D, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    y, _ = moe.moe_forward(p, x, cfg, asked, data=_DataAxis(D), n_shards=D)
    assert sizes == [N // want] and y.shape == x.shape
    assert y.isfinite().all()


class _DataAxis:
    """A data axis of ``size`` ranks, as moe_forward reads it."""

    def __init__(self, size):
        self.size, self.index, self.name, self.group = size, 0, "data", None


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "repro":
        repro_worker(sys.argv[2])
    else:
        ranks_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                     sys.argv[5])
