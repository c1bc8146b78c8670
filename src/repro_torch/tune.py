"""Per-(backend, kernel family, shape bucket) autotuner and tune cache.

Each kernel hand-picks its launch geometry (warps or pairs a block) and
the pipeline hand-picks the semantic knobs (``prescreen_top``, the
residual ``dp_band``, the ``packed_ref`` flavor).  `tune_session` times
each family over a small grid of both and writes the winners to a JSON
cache; `Mapper.build` / `from_index` read it once, at session build
(`engine/config.py`), and nothing on the per-batch path reads it again.

Resolution order per knob: **explicit config > tune cache > hand-picked
defaults**.  A knob the caller set on `PipelineConfig` / `LongReadConfig`
/ `ExecutionConfig` is never overridden by a cached winner.

Cache file format (version 1, the JAX package's layout)::

    {"version": 1,
     "entries": {
       "<backend>/<family>/<bucket>": {
         "params": {"block": 16, "prescreen_top": 4, ...},
         "us": 812.4, "staged_us": 1203.0, "plain_faster": false,
         "meta": {"batch": 65536, "platform": "gpu", ...}}}}

What differs from the JAX package's tuner, on purpose:

  * keys lead with this package's backends, ``cuda/...`` and
    ``torch/...``; a JAX store's ``pallas/...`` or ``jnp/...`` entries
    pass through `Mapper.save` / `load` unchanged and are never applied;
  * no environment variable is read: `ExecutionConfig.tune` None or False
    is off, True is `DEFAULT_CACHE`, a string names the file;
  * a session has one backend, so a cached ``backend`` param has no field
    to go to and is never applied.  The plain version stays a timed
    candidate (its time is ``staged_us``), but on a ``cuda`` session the
    winner is the fastest kernel configuration, and an entry whose plain
    version beat every one of them records ``"plain_faster": true``: a
    finding about the kernel, never a switch to the plain path;
  * a candidate that fails to launch raises (the grids hold only values
    each wrapper's own check accepts), and each kernel candidate's output
    must equal its plain version's on the same inputs, or the sweep
    raises.

Retuning is one command::

    PYTHONPATH=src python -m repro_torch.tune --batch 1024
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import time
import warnings

import numpy as np
import torch

from repro_torch.core.long_read import LongReadConfig
from repro_torch.core.pipeline import PipelineConfig

CACHE_VERSION = 1
DEFAULT_CACHE = os.path.join("artifacts", "tune_torch", "tune_cache.json")

#: The tuned kernel families, in pipeline order.
FAMILIES = ("pair_frontend", "candidate_align", "residual_dp",
            "location_vote")

#: Launch-geometry grids per family (each holds the hand-picked default):
#: warps (pairs) a block of pair_frontend, pairs a block of
#: candidate_align, warps (slots) a block of residual_dp, warps (reads) a
#: block of location_vote.  A value the wrapper's check refuses at the
#: session's shapes is left out of the sweep.
BLOCK_GRID = {
    "pair_frontend": (4, 8, 16, 32),
    "candidate_align": (16, 32, 48, 96),
    "residual_dp": (2, 4, 8),
    "location_vote": (4, 8, 16, 32),
}


# --------------------------------------------------------------- cache --
def cache_path(path: str | os.PathLike | None = None) -> str:
    """The cache file: ``path``, or `DEFAULT_CACHE`."""
    return os.fspath(path) if path else DEFAULT_CACHE


def load_cache(path: str | os.PathLike | None = None) -> dict:
    """The cache's entries; a missing file is empty, and a corrupt or
    stale one degrades to the hand-picked defaults (an empty dict) with a
    warning, never an error."""
    p = cache_path(path)
    if not os.path.exists(p):
        return {}
    try:
        with open(p) as f:
            data = json.load(f)
        if (not isinstance(data, dict)
                or data.get("version") != CACHE_VERSION
                or not isinstance(data.get("entries"), dict)):
            raise ValueError(
                f"expected {{'version': {CACHE_VERSION}, 'entries': ...}}")
        return data["entries"]
    except (OSError, ValueError) as e:   # json.JSONDecodeError included
        warnings.warn(
            f"ignoring unreadable tune cache {p!r} ({e!r}); "
            "falling back to hand-picked kernel defaults", stacklevel=2)
        return {}


def save_cache(entries: dict, path: str | os.PathLike | None = None) -> str:
    p = cache_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                  indent=1, sort_keys=True)
    return p


def session_cache(tune: bool | str | os.PathLike | None) -> dict:
    """`ExecutionConfig.tune` -> cache entries, read once per build: None
    or False off, True `DEFAULT_CACHE`, a path that file."""
    if tune is None or tune is False:
        return {}
    return load_cache(None if tune is True else tune)


# ------------------------------------------------------ buckets/lookup --
def _bucket_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length()) if n > 1 else 1


def pipeline_buckets(cfg: PipelineConfig, batch: int,
                     lr_cfg: LongReadConfig | None = None) -> dict:
    """family -> shape-bucket string for a session's pipeline geometry:
    the batch rounded up to a power of two, the static shape knobs exact
    (the JAX package's buckets)."""
    b = _bucket_pow2(batch)
    out = {
        "pair_frontend": (f"B{b}_S{cfg.seeds_per_read}"
                          f"_K{cfg.max_locs_per_seed}"
                          f"_C{cfg.max_candidates}_R{cfg.read_len}"),
        "candidate_align": (f"B{b}_C{cfg.max_candidates}"
                            f"_R{cfg.read_len}_E{cfg.max_gap}"),
        "residual_dp": (f"B{_bucket_pow2(max(1, cfg.residual_cap(batch)))}"
                        f"_R{cfg.read_len}_pad{cfg.dp_pad}"),
    }
    if lr_cfg is not None:
        out["location_vote"] = f"B{b}_bin{lr_cfg.vote_bin}"
    return out


def entry_key(backend: str, family: str, bucket: str) -> str:
    return f"{backend}/{family}/{bucket}"


def _split_bucket(bucket: str) -> tuple[int, str]:
    head, _, rest = bucket.partition("_")
    return int(head[1:]), rest


def lookup(entries: dict, backend: str, family: str, bucket: str):
    """Exact-key lookup, else the entry of the same backend, family and
    static shape whose batch bucket is nearest on a log scale (a cache
    tuned at B = 65,536 still serves a B = 1,024 session)."""
    hit = entries.get(entry_key(backend, family, bucket))
    if hit is not None:
        return hit
    try:
        want_b, suffix = _split_bucket(bucket)
    except ValueError:
        return None
    best = None
    for k, v in entries.items():
        parts = k.split("/", 2)
        if len(parts) != 3 or parts[0] != backend or parts[1] != family:
            continue
        try:
            got_b, got_suffix = _split_bucket(parts[2])
        except ValueError:
            continue
        if got_suffix != suffix:
            continue
        d = abs(math.log2(max(got_b, 1)) - math.log2(max(want_b, 1)))
        if best is None or d < best[0]:
            best = (d, v)
    return best[1] if best else None


# ------------------------------------------------- config application --
def apply_tuned_pipeline(pipe_cfg: PipelineConfig, entries: dict,
                         batch: int, backend: str,
                         exec_packed: bool | None = None
                         ) -> PipelineConfig:
    """Fill the *unset* `PipelineConfig` knobs from the cache entries of
    the session's ``backend`` ("cuda" or "torch") and shape buckets: the
    three launch blocks, ``prescreen_top``, ``packed_ref`` (unless
    `ExecutionConfig.packed_ref` forces it) and ``dp_band``.  A set knob
    is left alone; a cached ``backend`` param is never applied."""
    if not entries:
        return pipe_cfg
    buckets = pipeline_buckets(pipe_cfg, batch)
    upd: dict = {}

    def params(family):
        e = lookup(entries, backend, family, buckets[family])
        return e.get("params", {}) if e else {}

    p = params("pair_frontend")
    if pipe_cfg.frontend_block is None and p.get("block"):
        upd["frontend_block"] = int(p["block"])
    p = params("candidate_align")
    if pipe_cfg.light_block is None and p.get("block"):
        upd["light_block"] = int(p["block"])
    if pipe_cfg.prescreen_top is None and "prescreen_top" in p:
        upd["prescreen_top"] = int(p["prescreen_top"])
    if (pipe_cfg.packed_ref is None and exec_packed is None
            and "packed_ref" in p):
        upd["packed_ref"] = bool(p["packed_ref"])
    p = params("residual_dp")
    if pipe_cfg.residual_block is None and p.get("block"):
        upd["residual_block"] = int(p["block"])
    if pipe_cfg.dp_band is None and p.get("dp_band") is not None:
        upd["dp_band"] = int(p["dp_band"])
    return dataclasses.replace(pipe_cfg, **upd) if upd else pipe_cfg


def apply_tuned_long_read(lr_cfg: LongReadConfig, entries: dict,
                          batch: int, backend: str) -> LongReadConfig:
    """The lane's `apply_tuned_pipeline`: ``vote_block`` (the lane's
    ``pipe`` is tuned by the caller through the pipeline path)."""
    if not entries:
        return lr_cfg
    bucket = pipeline_buckets(lr_cfg.pipe, batch, lr_cfg)["location_vote"]
    e = lookup(entries, backend, "location_vote", bucket)
    p = e.get("params", {}) if e else {}
    if lr_cfg.vote_block is None and p.get("block"):
        return dataclasses.replace(lr_cfg, vote_block=int(p["block"]))
    return lr_cfg


# -------------------------------------------------------------- tuner --
def _same(a, b) -> bool:
    """Every field of two results equal (tensors exactly)."""
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _time_candidates(cands: list, reps: int = 3, sync=lambda: None
                     ) -> dict:
    """Warm every candidate once, then time them round-robin (each call
    between two ``sync()``s), so drift hits all alike.

    ``cands`` are ``(label, params, fn, same_as)``: a candidate with
    ``same_as`` must give the same output as that earlier candidate's
    (a kernel configuration against its plain version on the same
    inputs), or this raises; so does a candidate that fails to run.
    Returns label -> (params, median us)."""
    kept = {}
    for label, _, fn, same_as in cands:
        out = fn()
        if same_as is None:
            kept[label] = out
        else:
            sync()
            if not _same(out, kept[same_as]):
                raise RuntimeError(f"tune candidate {label!r} differs from "
                                   f"{same_as!r} on the same inputs")
    del kept
    times = {label: [] for label, *_ in cands}
    for _ in range(reps):
        for label, _, fn, _ in cands:
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times[label].append(time.perf_counter() - t0)
    return {label: (params, statistics.median(times[label]) * 1e6)
            for label, params, _, _ in cands}


def _winner(timed: dict, staged_label: str, plain: tuple = ()
            ) -> tuple[dict, float, float, bool]:
    """``(params, us, staged_us, plain_faster)``: the fastest kernel
    configuration (the fastest candidate where every one is ``plain``),
    the staged plain version's time, and whether a plain candidate beat
    every kernel configuration."""
    kernel = [k for k in timed if k not in plain] or list(timed)
    label = min(kernel, key=lambda k: timed[k][1])
    params, us = timed[label]
    staged_us = timed.get(staged_label, (None, float("nan")))[1]
    plain_us = min((timed[k][1] for k in plain), default=float("inf"))
    return dict(params), us, staged_us, label not in plain and plain_us < us


def _allowed(check, grid) -> list:
    """The grid values the wrapper's own check accepts."""
    out = []
    for b in grid:
        try:
            check(b)
        except ValueError:
            continue
        out.append(b)
    return out


def tune_session(ref, sm, pipe_cfg: PipelineConfig | None = None,
                 exec_cfg=None, *, batch: int = 1024,
                 lr_cfg: LongReadConfig | None = None,
                 families=FAMILIES, reps: int = 3, seed: int = 0,
                 long_read_len: int = 3000,
                 path: str | os.PathLike | None = None,
                 save: bool = True) -> dict:
    """Time each family's grid on the session's device and persist the
    winners.

    ``ref`` is the (L,) uint8 reference (array or tensor), ``sm`` the CSR
    `SeedMap` or a `PaddedSeedMap`.  The workload is ``batch`` pairs
    simulated from ``ref`` at the session's read length (the tuner needs
    the real shapes, not real biology), a residual buffer of the batch's
    capacity, and diagonal rows of ``batch`` long reads of
    ``long_read_len`` bases.  Returns the (merged) entries; with ``save``
    they are written to `cache_path(path)`, where a later
    ``Mapper.build(..., ExecutionConfig(tune=path))`` picks them up.
    """
    from repro_torch.core.encoding import pack_2bit, revcomp
    from repro_torch.core.seedmap import INVALID_LOC, PaddedSeedMap, \
        to_padded
    from repro_torch.core.simulate import ReadSimConfig, simulate_pairs
    from repro_torch.engine.config import ExecutionConfig, resolved_pipeline
    from repro_torch.kernels._util import kernel_reference
    from repro_torch.kernels.candidate_align.ops import (
        candidate_pair_align, launch_shape)
    from repro_torch.kernels.location_vote.ops import location_vote, \
        vote_warps
    from repro_torch.kernels.pair_frontend.ops import frontend_warps, \
        pair_frontend
    from repro_torch.kernels.residual_dp.ops import residual_pair_dp, \
        residual_warps

    exec_cfg = exec_cfg or ExecutionConfig()
    cfg, backend = resolved_pipeline(pipe_cfg or PipelineConfig(), exec_cfg)
    dev = exec_cfg.torch_device()
    lr_cfg = lr_cfg or LongReadConfig(
        pipe=dataclasses.replace(cfg, packed_ref=None))
    buckets = pipeline_buckets(cfg, batch, lr_cfg)
    cuda = backend == "cuda"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if isinstance(ref, torch.Tensor):
        ref = ref.cpu().numpy()
    ref_np = np.asarray(ref, dtype=np.uint8)
    ref_t = torch.as_tensor(ref_np, device=dev)
    sim = simulate_pairs(ref_np, batch, ReadSimConfig(read_len=cfg.read_len),
                         seed=seed)
    reads1 = torch.as_tensor(sim.reads1, device=dev)
    reads2_fwd = revcomp(torch.as_tensor(sim.reads2, device=dev)
                         ).contiguous()
    padded = (sm if isinstance(sm, PaddedSeedMap)
              else to_padded(sm, cap=cfg.max_locs_per_seed))
    rows = padded.rows.to(dev)
    S, K = cfg.seeds_per_read, rows.shape[1]
    hs = sm.config.hash_seed
    rng = np.random.default_rng(seed + 1)
    meta = {"batch": batch, "reps": reps,
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}
    entries = load_cache(path) if save else {}

    def record(family, cands, staged_label):
        t0 = time.perf_counter()
        timed = _time_candidates(cands, reps, sync)
        plain = tuple(c[0] for c in cands if c[3] is None)
        params, us, staged_us, plain_faster = _winner(timed, staged_label,
                                                      plain)
        entry = {"params": params, "us": round(us, 2),
                 "staged_us": round(staged_us, 2),
                 "meta": {**meta, "tune_s": time.perf_counter() - t0,
                          "candidates_us": {k: round(v[1], 2)
                                            for k, v in timed.items()}}}
        if cuda:
            entry["plain_faster"] = plain_faster
        entries[entry_key(backend, family, buckets[family])] = entry

    # ---- pair_frontend --------------------------------------------------
    def fe(block=None, backend=backend):
        return pair_frontend(rows, reads1, reads2_fwd, cfg.seed_len, S, hs,
                             cfg.delta, cfg.max_candidates, block=block,
                             backend=backend)

    if "pair_frontend" in families:
        cands = [("staged", {"backend": "torch"},
                  lambda: fe(backend="torch"), None)]
        if cuda:
            for b in _allowed(lambda b: frontend_warps(S, K, b),
                              BLOCK_GRID["pair_frontend"]):
                cands.append((f"block{b}", {"block": b},
                              lambda b=b: fe(block=b), "staged"))
        record("pair_frontend", cands, "staged")

    # ---- candidate_align ------------------------------------------------
    R, E, C = cfg.read_len, cfg.max_gap, cfg.max_candidates
    width = R + 2 * max(E, cfg.dp_pad)
    kref_u = kernel_reference(ref_t, width, False) if cuda else None
    if "candidate_align" in families:
        cand = fe()       # the front end's real candidate set
        words = pack_2bit(ref_t)
        kref_p = kernel_reference(words, width, True) if cuda else None

        def la(block=None, ps=0, packed=False, backend=backend):
            return candidate_pair_align(
                words if packed else ref_t, reads1, reads2_fwd, cand.pos1,
                cand.pos2, E, scoring=cfg.scoring, threshold=cfg.threshold(),
                mode=cfg.light_mode, prescreen_top=ps, packed_ref=packed,
                backend=backend, block=block,
                kref=(kref_p if packed else kref_u) if cuda else None)

        ps_grid = sorted({0, max(1, C // 2)})
        knobs = [(ps, pk) for ps in ps_grid for pk in (False, True)]
        cands = [(f"staged_ps{ps}_pk{int(pk)}",
                  {"backend": "torch", "prescreen_top": ps, "packed_ref": pk},
                  lambda ps=ps, pk=pk: la(ps=ps, packed=pk, backend="torch"),
                  None) for ps, pk in knobs]
        if cuda:
            for b in _allowed(lambda b: launch_shape(R, R + 2 * E, C, b),
                              BLOCK_GRID["candidate_align"]):
                cands += [(f"block{b}_ps{ps}_pk{int(pk)}",
                           {"block": b, "prescreen_top": ps, "packed_ref": pk},
                           lambda b=b, ps=ps, pk=pk: la(block=b, ps=ps,
                                                        packed=pk),
                           f"staged_ps{ps}_pk{int(pk)}") for ps, pk in knobs]
        record("candidate_align", cands, "staged_ps0_pk0")
        del cand, words, kref_p

    # ---- residual_dp ----------------------------------------------------
    if "residual_dp" in families:
        cap = max(1, cfg.residual_cap(batch))
        L = int(ref_np.shape[0])
        W = R + 2 * cfg.dp_pad
        p1, p2 = (torch.as_tensor(rng.integers(
            cfg.dp_pad, max(cfg.dp_pad + 1, L - W), (cap,)).astype(np.int32),
            device=dev) for _ in range(2))
        # the typical residual mix: mostly one failed mate a row
        n1 = rng.random(cap) < 0.55
        n2 = np.where(n1, rng.random(cap) < 0.15, True)
        n1, n2 = (torch.as_tensor(x, device=dev) for x in (n1, n2))
        r1, r2 = reads1[:cap].contiguous(), reads2_fwd[:cap].contiguous()

        def dp(block=None, band=None, backend=backend):
            return residual_pair_dp(
                ref_t, r1, r2, p1, p2, n1, n2, cfg.dp_pad, band=band,
                scoring=cfg.scoring, backend=backend, block=block,
                kref=kref_u if cuda else None)

        bands = [("staged", cfg.band(), {}), ("staged_full", W,
                                              {"dp_band": W})]
        cands = [(label, {"backend": "torch", **extra},
                  lambda band=band: dp(band=band, backend="torch"), None)
                 for label, band, extra in bands]
        if cuda:
            for label, band, extra in bands:
                for b in _allowed(lambda b: residual_warps(R, W, band, b),
                                  BLOCK_GRID["residual_dp"]):
                    cands.append((f"block{b}_band{band}",
                                  {"block": b, **extra},
                                  lambda b=b, band=band: dp(block=b,
                                                            band=band),
                                  label))
        record("residual_dp", cands, "staged")

    # ---- location_vote --------------------------------------------------
    if "location_vote" in families:
        M = max(1, lr_cfg.n_segments(long_read_len) - 1) * C
        diag_np = rng.integers(0, max(2, len(ref_np) - 256),
                               (batch, M)).astype(np.int32)
        diag_np[rng.random((batch, M)) < 0.5] = INVALID_LOC
        diag = torch.as_tensor(diag_np, device=dev)
        cands = [("staged", {"backend": "torch"},
                  lambda: location_vote(diag, lr_cfg.vote_bin,
                                        backend="torch"), None)]
        if cuda:
            for b in _allowed(lambda b: vote_warps(M, b),
                              BLOCK_GRID["location_vote"]):
                cands.append((f"block{b}", {"block": b},
                              lambda b=b: location_vote(
                                  diag, lr_cfg.vote_bin, block=b),
                              "staged"))
        record("location_vote", cands, "staged")

    if save:
        save_cache(entries, path)
    return entries


# ---------------------------------------------------------------- CLI --
def main(argv=None) -> None:
    from repro_torch.core.seedmap import SeedMapConfig, build_seedmap
    from repro_torch.core.simulate import random_reference
    from repro_torch.engine.config import ExecutionConfig

    ap = argparse.ArgumentParser(
        description="Autotune the CUDA kernels' launch geometry and the "
                    "pipeline's knobs; write the tune cache.")
    ap.add_argument("--ref-len", type=int, default=300_000)
    ap.add_argument("--table-bits", type=int, default=19)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="comma-separated subset of " + ",".join(FAMILIES))
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default {DEFAULT_CACHE})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the session runs (default: the GPU)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    ref = random_reference(args.ref_len, rng)
    exec_cfg = ExecutionConfig(device=args.device)
    sm = build_seedmap(ref, SeedMapConfig(table_bits=args.table_bits),
                       device=exec_cfg.torch_device())
    entries = tune_session(
        ref, sm, exec_cfg=exec_cfg, batch=args.batch, reps=args.reps,
        families=tuple(args.families.split(",")), path=args.cache)
    print(f"wrote {cache_path(args.cache)} ({len(entries)} entries)")
    for k in sorted(entries):
        e = entries[k]
        print(f"  {k}: {e['params']} us={e['us']} "
              f"staged_us={e['staged_us']}"
              + (f" plain_faster={e['plain_faster']}"
                 if "plain_faster" in e else ""))


if __name__ == "__main__":
    main()
