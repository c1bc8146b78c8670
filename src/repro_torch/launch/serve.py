"""Genomics serving CLI: batched paired-end read mapping on the GPU.

Offline stage: build the reference + SeedMap index and a `Mapper` session
(backend, reference flavor and SeedMap layout resolved once).  Online
stage: stream fixed-size batches of FR read pairs through
``mapper.map_stream``, which overlaps read simulation and the pinned
host-to-device copy with the step in flight, accumulates the stage totals
(Fig. 10) *and* the accuracy counters on the device, and syncs the host
once at the end.  Accuracy is checked per mate (``pos1`` vs
``true_start1``, ``pos2`` vs ``true_start2``) and per pair.

``--loop legacy`` is the blocking loop (one `map_pairs_impl` call and a
host fetch of the stage fractions per batch), the measured baseline;
``--compare`` runs both and writes the speedup JSON.

``--workload long`` serves the long-read lane: `serve_long` streams
simulated PacBio-like batches through ``mapper.map_long_stream`` with a
device-side vote-accuracy reduction.

``--loop frontdoor`` serves a synthetic *bursty ragged-arrival* trace
(requests of 1..batch read pairs or long reads, both lanes interleaved)
through the continuous-batching front door (`engine.frontdoor`): queue
coalescing, admission control and the per-request latency ledger,
reported next to throughput.

``--save-index PATH`` builds the session and writes its index store;
``--index PATH`` serves from one without rebuilding.  ``--chaos SPEC``
wraps the stream loop's batch source with a deterministic fault schedule
(`runtime.faultinject`) and serves it through the fault-tolerant fleet
stream (`engine.multihost.map_stream`): the serve drains instead of
crashing, and the output carries the health ledger (``--health-out PATH``
writes it as JSON).  Everything runs on the GPU unless ``--device cpu``
asks for the CPU (the plain PyTorch versions of the kernels).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --ref-len 500000 \\
      --batches 10 --batch 512
  PYTHONPATH=src python -m repro_torch.launch.serve --loop frontdoor
  PYTHONPATH=src python -m repro_torch.launch.serve --save-index /tmp/idx
  PYTHONPATH=src python -m repro_torch.launch.serve --index /tmp/idx
  PYTHONPATH=src python -m repro_torch.launch.serve --chaos sigterm@0:2 \\
      --health-out /tmp/health.json
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core.pipeline import (
    PipelineConfig,
    map_pairs_impl,
    stage_stats,
)
from repro_torch.core.seedmap import INVALID_LOC, SeedMapConfig, build_seedmap
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_long_reads,
    simulate_pairs,
)
from repro_torch.data.pipeline import ReadStreamConfig, read_pairs_for_step
from repro_torch.engine import (
    ExecutionConfig,
    FrontDoor,
    FrontDoorConfig,
    LongReadConfig,
    Mapper,
)
from repro_torch.engine import multihost
from repro_torch.engine.index_store import store_size_bytes
from repro_torch.runtime import ChaosSpec, PreemptionGuard, inject
from repro_torch.runtime.watchdog import STRAGGLE_DEMO_WATCHDOG

ACC_KEYS = ("mapped1", "mapped2", "correct1", "correct2",
            "pair_mapped", "pair_correct")


def _make_accuracy_reduce(max_gap: int):
    """Device-side per-batch accuracy reduction (both mates + pair).

    Scores ``pos1`` against ``true_start1`` and ``pos2`` against
    ``true_start2``, plus pair-level correctness (both mates mapped /
    both within ``max_gap``).  It runs after each `map_stream` batch on
    the device; padded tail rows are excluded via ``res.n_valid``.
    """

    def reduce(acc, res, aux):
        t1, t2 = aux
        v = res.n_valid
        m1 = (res.pos1 != INVALID_LOC) & v
        m2 = (res.pos2 != INVALID_LOC) & v
        c1 = m1 & ((res.pos1.long() - t1.long()).abs() <= max_gap)
        c2 = m2 & ((res.pos2.long() - t2.long()).abs() <= max_gap)
        new = {
            "mapped1": m1, "mapped2": m2, "correct1": c1, "correct2": c2,
            "pair_mapped": m1 & m2, "pair_correct": c1 & c2,
        }
        return {k: acc[k] + new[k].sum() for k in ACC_KEYS}

    return reduce


def _make_vote_accuracy_reduce(vote_bin: int):
    """Device-side long-read accuracy reduction (mapped / vote-correct)."""

    def reduce(acc, res, aux):
        (true,) = aux
        m = res.mapped & res.n_valid
        c = m & ((res.position.long() - true.long()).abs() <= vote_bin)
        return {"mapped": acc["mapped"] + m.sum(),
                "correct": acc["correct"] + c.sum()}

    return reduce


def _zeros(keys, device) -> dict:
    return {k: torch.zeros((), dtype=torch.int64, device=device)
            for k in keys}


def _session_from_store(index_path, ref, table_bits, pipe_cfg, exec_cfg,
                        ) -> tuple[Mapper, float]:
    """Cold-start a serve session from a saved index store.

    Returns ``(mapper, seconds_to_ready)``.  An unreadable store warns
    and degrades to a full ``Mapper.build`` on the CLI's reference, so
    the worker comes up either way (`Mapper.load`'s fallback contract).
    """
    t0 = time.time()
    mapper = Mapper.load(index_path, exec_cfg, fallback_ref=ref,
                         seedmap_cfg=SeedMapConfig(table_bits=table_bits),
                         pipe_cfg=pipe_cfg)
    return mapper, time.time() - t0


def serve(ref_len: int = 500_000, batch: int = 512, batches: int = 10,
          table_bits: int = 20, sub_rate: float = 1e-3,
          pipe_cfg: PipelineConfig = PipelineConfig(),
          seed: int = 0, verbose: bool = True, loop: str = "stream",
          index_path: str | None = None, chaos: str | None = None,
          device: str = "cuda") -> dict:
    """The pair-lane serve workload (``--loop stream`` or ``legacy``;
    ``chaos``, a `ChaosSpec` string, drives the stream loop through the
    fault-tolerant fleet stream)."""
    rng = np.random.default_rng(seed)
    t0 = time.time()
    ref = random_reference(ref_len, rng)
    mapper = sm = None
    if index_path is not None:
        if loop == "legacy":
            raise ValueError("--index serves through the engine session; "
                             "the legacy loop has no store path")
        mapper, t_index = _session_from_store(
            index_path, ref, table_bits, pipe_cfg,
            ExecutionConfig(device=device, stream_batch=batch))
    else:
        sm = build_seedmap(ref, SeedMapConfig(table_bits=table_bits),
                           device=ExecutionConfig(device=device)
                           .torch_device())
        t_index = time.time() - t0

    stream = ReadStreamConfig(batch=batch, read_len=pipe_cfg.read_len,
                              seed=seed)
    sim_cfg = ReadSimConfig(read_len=pipe_cfg.read_len, sub_rate=sub_rate)

    if loop == "legacy":
        if chaos:
            raise ValueError("--chaos drives the fault-tolerant stream "
                             "loop; the legacy loop has no drain path")
        out = _serve_legacy(ref, sm, stream, sim_cfg, batch, batches,
                            pipe_cfg, t_index)
    elif loop == "stream":
        out = _serve_stream(ref, sm, stream, sim_cfg, batch, batches,
                            pipe_cfg, t_index, mapper=mapper, chaos=chaos,
                            device=device)
    else:
        raise ValueError(f"unknown loop {loop!r}; expected stream|legacy")
    if verbose:
        print(json.dumps(out, indent=1), flush=True)
    return out


def _serve_stream(ref, sm, stream, sim_cfg, batch, batches, pipe_cfg,
                  t_index, mapper: Mapper | None = None,
                  chaos: str | None = None, device: str = "cuda") -> dict:
    if mapper is None:
        mapper = Mapper.from_index(
            sm, ref, pipe_cfg, ExecutionConfig(device=device,
                                               stream_batch=batch))

    def gen():
        for step in range(batches):
            sim = read_pairs_for_step(ref, stream, step, sim_cfg)
            yield sim.reads1, sim.reads2, (sim.true_start1, sim.true_start2)

    # warm up on batch 0 (the legacy loop warms the same way)
    sim0 = read_pairs_for_step(ref, stream, 0, sim_cfg)
    warmup = (sim0.reads1, sim0.reads2,
              (sim0.true_start1, sim0.true_start2))
    reduce_kw = dict(reduce_fn=_make_accuracy_reduce(pipe_cfg.max_gap),
                     reduce_init=_zeros(ACC_KEYS, mapper.device))
    if chaos is not None:
        # the batch source under the fault schedule, through the fleet
        # stream: on one host no keep-alive rounds, but SIGTERM still
        # drains between batches and the watchdog tracks stalls
        spec = ChaosSpec.parse(chaos)
        guard = PreemptionGuard()
        try:
            sr = multihost.map_stream(
                mapper, inject(gen(), spec, host=multihost.process_index()),
                guard=guard,
                watchdog=STRAGGLE_DEMO_WATCHDOG
                if any(f.kind == "straggle" for f in spec.faults) else None,
                warmup_batch=warmup, **reduce_kw)
        finally:
            guard.uninstall()
        a = {k: int(v) for k, v in sr.reduced.items()}
        n = max(sr.n_pairs, 1)
        return {
            "pairs": sr.n_pairs,
            "pairs_per_s": sr.pairs_per_s,
            "index_build_s": t_index,
            "loop": "stream",
            "chaos": chaos,
            "health": sr.health,
            "mapped_frac": a["mapped1"] / n,
            "correct_of_mapped": a["correct1"] / max(a["mapped1"], 1),
            **sr.fractions,
        }
    sr = mapper.map_stream(gen(), warmup_batch=warmup, **reduce_kw)
    a = {k: int(v) for k, v in sr.reduced.items()}
    n = max(sr.n_pairs, 1)
    return {
        "pairs": sr.n_pairs,
        "pairs_per_s": sr.pairs_per_s,
        "mbp_per_s": sr.mbp_per_s(pipe_cfg.read_len),
        "index_build_s": t_index,
        "loop": "stream",
        # mate-1 keys keep their historical names
        "mapped_frac": a["mapped1"] / n,
        "correct_of_mapped": a["correct1"] / max(a["mapped1"], 1),
        "mapped_frac2": a["mapped2"] / n,
        "correct_of_mapped2": a["correct2"] / max(a["mapped2"], 1),
        "pair_mapped_frac": a["pair_mapped"] / n,
        "pair_correct_of_mapped": a["pair_correct"] / max(a["pair_mapped"],
                                                          1),
        **sr.fractions,
        # the stream's spans, device markers and counters
        "trace": sr.trace,
    }


def serve_long(ref_len: int = 500_000, batch: int = 64, batches: int = 10,
               table_bits: int = 20, read_len: int = 4500,
               sub_rate: float = 0.01,
               lr_cfg: LongReadConfig = LongReadConfig(),
               seed: int = 0, verbose: bool = True,
               index_path: str | None = None, device: str = "cuda") -> dict:
    """The long-read serve workload (``--workload long``): the offline
    index + session build, then `map_long_stream` over simulated
    PacBio-like batches with a device-side accuracy reduction (mapped /
    voted position within one vote bin of the truth) and one host sync at
    the end."""
    rng = np.random.default_rng(seed)
    t0 = time.time()
    ref = random_reference(ref_len, rng)
    exec_cfg = ExecutionConfig(device=device, stream_batch=batch,
                               long_read=lr_cfg)
    if index_path is not None:
        mapper, t_index = _session_from_store(index_path, ref, table_bits,
                                              lr_cfg.pipe, exec_cfg)
    else:
        sm = build_seedmap(ref, SeedMapConfig(table_bits=table_bits),
                           device=exec_cfg.torch_device())
        t_index = time.time() - t0
        mapper = Mapper.from_index(sm, ref, lr_cfg.pipe, exec_cfg)
    bin_ = mapper.lr_cfg.vote_bin

    def gen():
        for step in range(batches):
            reads, starts = simulate_long_reads(
                ref, batch, read_len, sub_rate, seed=seed + 1 + step)
            yield reads, (starts,)

    w_reads, w_starts = simulate_long_reads(ref, batch, read_len, sub_rate,
                                            seed=seed)
    sr = mapper.map_long_stream(
        gen(), reduce_fn=_make_vote_accuracy_reduce(bin_),
        reduce_init=_zeros(("mapped", "correct"), mapper.device),
        warmup_batch=(w_reads, (w_starts,)))
    a = {k: int(v) for k, v in sr.reduced.items()}
    out = {
        "reads": sr.n_pairs,
        "reads_per_s": sr.pairs_per_s,
        "mbp_per_s": sr.mbp_per_s(read_len),
        "index_build_s": t_index,
        "loop": "stream",
        "workload": "long",
        "mapped_frac": a["mapped"] / max(sr.n_pairs, 1),
        "correct_of_mapped": a["correct"] / max(a["mapped"], 1),
        **sr.fractions,
    }
    if verbose:
        print(json.dumps(out, indent=1), flush=True)
    return out


def bursty_arrivals(rng: np.random.Generator, batch: int, reads1, reads2,
                    long_reads=None, long_frac: float = 0.0):
    """Ragged bursty request trace over pools of read pairs and long
    reads, lanes interleaved, until both pools are spent: a request is a
    long one with probability ``long_frac`` while long reads remain, and
    its size is drawn from 1..batch one time in four, from
    1..max(2, batch // 8) otherwise.  Yields the front door's
    ``(lane, reads)`` items."""
    n_pair_rows = len(reads1)
    n_long_rows = 0 if long_reads is None else len(long_reads)
    pair_off = long_off = 0
    while pair_off < n_pair_rows or long_off < n_long_rows:
        go_long = (long_off < n_long_rows
                   and (pair_off >= n_pair_rows
                        or rng.random() < long_frac))
        # mostly small requests, occasional near-batch bursts
        hi = batch if rng.random() < 0.25 else max(2, batch // 8)
        n = int(rng.integers(1, hi + 1))
        if go_long:
            n = min(n, n_long_rows - long_off)
            yield ("long", (long_reads[long_off:long_off + n],))
            long_off += n
        else:
            n = min(n, n_pair_rows - pair_off)
            yield ("pairs", (reads1[pair_off:pair_off + n],
                             reads2[pair_off:pair_off + n]))
            pair_off += n


def serve_frontdoor(ref_len: int = 500_000, batch: int = 256,
                    batches: int = 10, table_bits: int = 20,
                    sub_rate: float = 1e-3, long_sub_rate: float = 0.01,
                    read_len: int = 2000, long_frac: float = 0.2,
                    max_queue_rows: int | None = None,
                    deadline_s: float | None = None,
                    pipe_cfg: PipelineConfig = PipelineConfig(),
                    seed: int = 0, verbose: bool = True,
                    index_path: str | None = None,
                    device: str = "cuda") -> dict:
    """Bursty ragged-arrival serving through the continuous-batching
    front door (``--loop frontdoor``): `bursty_arrivals` over simulated
    pools of ``batch * batches`` pairs and ``long_frac`` as many long
    reads, driven through one `FrontDoor` (coalescing, admission
    control, the per-request latency ledger, two-lane scheduling).
    Reports throughput next to the queue-latency percentiles and the
    shed / reject accounting."""
    rng = np.random.default_rng(seed)
    t0 = time.time()
    ref = random_reference(ref_len, rng)
    exec_cfg = ExecutionConfig(device=device, stream_batch=batch)
    if index_path is not None:
        mapper, t_index = _session_from_store(index_path, ref, table_bits,
                                              pipe_cfg, exec_cfg)
    else:
        sm = build_seedmap(ref, SeedMapConfig(table_bits=table_bits),
                           device=exec_cfg.torch_device())
        t_index = time.time() - t0
        mapper = Mapper.from_index(sm, ref, pipe_cfg, exec_cfg)

    # Request pools are simulated up front so arrivals pay no host-side
    # generation inside the latency-stamped serve window.
    n_pair_rows = batch * batches
    sim = simulate_pairs(
        ref, n_pair_rows,
        ReadSimConfig(read_len=pipe_cfg.read_len, sub_rate=sub_rate),
        seed=seed)
    n_long_rows = int(round(n_pair_rows * long_frac)) if long_frac > 0 else 0
    long_reads = None
    if n_long_rows:
        long_reads, _ = simulate_long_reads(ref, n_long_rows, read_len,
                                            long_sub_rate, seed=seed + 1)

    fd = FrontDoor(mapper, FrontDoorConfig(
        max_queue_rows=max_queue_rows, default_deadline_s=deadline_s))
    try:
        fd.warmup(long_reads=long_reads[:1] if n_long_rows else None)
        t1 = time.time()
        report = fd.serve(bursty_arrivals(rng, batch, sim.reads1,
                                          sim.reads2, long_reads, long_frac))
        seconds = time.time() - t1
    finally:
        fd.close()

    pair_rows = report["stage_totals"]["pairs"]["n_pairs"]
    long_rows = report["stage_totals"].get("long", {}).get("n_reads", 0)
    out = {
        "loop": "frontdoor",
        "index_build_s": t_index,
        "seconds": seconds,
        "pairs": pair_rows,
        "long_reads": long_rows,
        "pairs_per_s": pair_rows / max(seconds, 1e-9),
        "mbp_per_s": (pair_rows * 2 * pipe_cfg.read_len
                      + long_rows * read_len) / max(seconds, 1e-9) / 1e6,
        **report["serve"],
        "stage_totals": report["stage_totals"],
        "watchdog": report["watchdog"],
    }
    if verbose:
        print(json.dumps(out, indent=1), flush=True)
    return out


def _serve_legacy(ref, sm, stream, sim_cfg, batch, batches, pipe_cfg,
                  t_index) -> dict:
    """The blocking loop, the measured baseline: per batch, simulate ->
    map -> a host fetch of the stage fractions (``.tolist()``) ->
    host-side mate-1 accuracy."""
    dev = sm.offsets.device
    ref_t = torch.as_tensor(ref, device=dev)

    def step(sim):
        return map_pairs_impl(sm, ref_t, torch.as_tensor(sim.reads1,
                                                         device=dev),
                              torch.as_tensor(sim.reads2, device=dev),
                              pipe_cfg)

    sim0 = read_pairs_for_step(ref, stream, 0, sim_cfg)
    step(sim0).pos1.cpu()

    n_pairs = 0
    correct = 0
    mapped = 0
    agg: dict[str, float] = {}
    t1 = time.time()
    for k in range(batches):
        sim = read_pairs_for_step(ref, stream, k, sim_cfg)
        res = step(sim)
        pos1 = res.pos1.cpu().numpy()
        ok = pos1 != INVALID_LOC
        mapped += int(ok.sum())
        correct += int((np.abs(pos1[ok] - sim.true_start1[ok])
                        <= pipe_cfg.max_gap).sum())
        n_pairs += batch
        fr = stage_stats(res)
        for key, v in zip(fr, torch.stack(list(fr.values())).tolist()):
            agg[key] = agg.get(key, 0.0) + v
    dt = time.time() - t1
    return {
        "pairs": n_pairs,
        "pairs_per_s": n_pairs / dt,
        "mbp_per_s": n_pairs * 2 * pipe_cfg.read_len / dt / 1e6,
        "index_build_s": t_index,
        "loop": "legacy",
        "mapped_frac": mapped / n_pairs,
        "correct_of_mapped": correct / max(mapped, 1),
        **{k: v / batches for k, v in agg.items()},
    }


def compare_loops(out_path: str | None = None, reps: int = 3,
                  ref_len: int = 500_000, batch: int = 512,
                  batches: int = 10, table_bits: int = 20,
                  sub_rate: float = 1e-3,
                  pipe_cfg: PipelineConfig = PipelineConfig(),
                  seed: int = 0, device: str = "cuda") -> dict:
    """Run the legacy and stream loops on identical work; report the
    speedup as the median of same-rep ratios, the two loops alternating
    which goes first, after one index build for both."""
    rng = np.random.default_rng(seed)
    t0 = time.time()
    ref = random_reference(ref_len, rng)
    exec_cfg = ExecutionConfig(device=device, stream_batch=batch)
    sm = build_seedmap(ref, SeedMapConfig(table_bits=table_bits),
                       device=exec_cfg.torch_device())
    t_index = time.time() - t0
    stream = ReadStreamConfig(batch=batch, read_len=pipe_cfg.read_len,
                              seed=seed)
    sim_cfg = ReadSimConfig(read_len=pipe_cfg.read_len, sub_rate=sub_rate)
    mapper = Mapper.from_index(sm, ref, pipe_cfg, exec_cfg)

    run = {
        "legacy": lambda: _serve_legacy(ref, sm, stream, sim_cfg, batch,
                                        batches, pipe_cfg, t_index),
        "stream": lambda: _serve_stream(ref, sm, stream, sim_cfg, batch,
                                        batches, pipe_cfg, t_index,
                                        mapper=mapper),
    }
    runs: dict[str, list] = {"legacy": [], "stream": []}
    ratios = []
    for rep in range(reps):
        order = ("legacy", "stream") if rep % 2 == 0 else ("stream",
                                                           "legacy")
        pair = {}
        for loop in order:
            pair[loop] = run[loop]()
            runs[loop].append(pair[loop])
        ratios.append(pair["stream"]["pairs_per_s"]
                      / max(pair["legacy"]["pairs_per_s"], 1e-9))
    # best-of runs may come from different reps, so the headline ratio is
    # the median of same-rep pairs, not stream_best / legacy_best
    legacy = max(runs["legacy"], key=lambda r: r["pairs_per_s"])
    streamed = max(runs["stream"], key=lambda r: r["pairs_per_s"])
    result = {
        "legacy_best": legacy,
        "stream_best": streamed,
        "legacy_runs_pairs_per_s": [r["pairs_per_s"]
                                    for r in runs["legacy"]],
        "stream_runs_pairs_per_s": [r["pairs_per_s"]
                                    for r in runs["stream"]],
        "per_rep_speedups": ratios,
        "speedup_pairs_per_s": float(np.median(ratios)),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"speedup_pairs_per_s": result["speedup_pairs_per_s"],
                      "per_rep_speedups": ratios,
                      "legacy_best_pairs_per_s": legacy["pairs_per_s"],
                      "stream_best_pairs_per_s": streamed["pairs_per_s"]},
                     indent=1), flush=True)
    return result


def save_index(path: str, ref_len: int = 500_000, batch: int = 512,
               table_bits: int = 20, sub_rate: float = 1e-3,
               pipe_cfg: PipelineConfig = PipelineConfig(),
               seed: int = 0, verbose: bool = True, device: str = "cuda",
               **_ignored) -> dict:
    """``--save-index``: build the session once and persist its store.

    The store carries the resolved session (index layout, reference
    flavor, configs), so a later ``--index`` serve of the same shapes
    cold-starts without `build_seedmap` and maps identically.
    """
    rng = np.random.default_rng(seed)
    t0 = time.time()
    ref = random_reference(ref_len, rng)
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=table_bits),
                          pipe_cfg, ExecutionConfig(device=device,
                                                    stream_batch=batch))
    t_build = time.time() - t0
    t0 = time.time()
    manifest = mapper.save(path)
    out = {
        "store": path,
        "manifest": manifest,
        "index_build_s": t_build,
        "save_s": time.time() - t0,
        "store_mb": store_size_bytes(path) / 1e6,
        "layout": type(mapper.index).__name__,
    }
    if verbose:
        print(json.dumps(out, indent=1), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-len", type=int, default=500_000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--table-bits", type=int, default=20)
    ap.add_argument("--sub-rate", type=float, default=None,
                    help="substitution rate; defaults per workload "
                         "(1e-3 short pairs, PacBio-like 0.01 long)")
    ap.add_argument("--loop", choices=("stream", "legacy", "frontdoor"),
                    default="stream",
                    help="host loop: pre-batched map_stream (default), "
                         "the blocking baseline, or the "
                         "continuous-batching front door (bursty ragged "
                         "arrivals, two lanes interleaved)")
    ap.add_argument("--workload", choices=("pairs", "long"),
                    default="pairs",
                    help="short FR pairs (default) or the long-read lane")
    ap.add_argument("--read-len", type=int, default=4500,
                    help="long-read length (bp): --workload long and the "
                         "frontdoor long lane")
    ap.add_argument("--long-frac", type=float, default=0.2,
                    help="--loop frontdoor: fraction of request traffic "
                         "on the long-read lane")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="--loop frontdoor: per-request deadline")
    ap.add_argument("--max-queue-rows", type=int, default=None,
                    help="--loop frontdoor: admission-control queue bound")
    ap.add_argument("--compare", action="store_true",
                    help="run legacy + stream loops and report the speedup")
    ap.add_argument("--reps", type=int, default=3,
                    help="--compare repetitions (median of per-rep ratios)")
    ap.add_argument("--out", default=None,
                    help="write the result JSON here")
    ap.add_argument("--save-index", default=None, metavar="PATH",
                    help="build the index + session, persist the store "
                         "to PATH (engine.index_store) and exit")
    ap.add_argument("--index", default=None, metavar="PATH",
                    help="serve from a saved index store instead of "
                         "rebuilding (composes with --loop frontdoor and "
                         "--workload long; unreadable stores degrade to "
                         "a full build)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection on the stream "
                         "loop (runtime.faultinject grammar, e.g. "
                         "'dry@0:3' or 'sigterm@0:2,straggle@0:1:0.05'): "
                         "the serve drains instead of crashing and the "
                         "output carries the health ledger")
    ap.add_argument("--health-out", default=None, metavar="PATH",
                    help="write the --chaos health ledger JSON here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the session runs (default: the GPU)")
    args = ap.parse_args(argv)
    # the shared flag must not clobber per-workload defaults: short pairs
    # default 1e-3, the long lane the PacBio-like 0.01
    sub_rate = args.sub_rate
    if sub_rate is None:
        sub_rate = 0.01 if args.workload == "long" else 1e-3
    kwargs = dict(ref_len=args.ref_len, batch=args.batch,
                  batches=args.batches, table_bits=args.table_bits,
                  sub_rate=sub_rate, device=args.device)
    if args.save_index:
        out = save_index(args.save_index, **kwargs)
    elif args.compare:
        compare_loops(out_path=args.out, reps=args.reps, **kwargs)
        return
    elif args.loop == "frontdoor":
        if args.chaos:
            raise SystemExit("--chaos composes with --loop stream; the "
                             "front door has its own guard/watchdog path")
        out = serve_frontdoor(read_len=args.read_len,
                              long_frac=args.long_frac,
                              deadline_s=args.deadline_s,
                              max_queue_rows=args.max_queue_rows,
                              index_path=args.index,
                              **kwargs)
    elif args.workload == "long":
        if args.chaos:
            raise SystemExit("--chaos currently drives the pairs stream "
                             "loop only")
        out = serve_long(read_len=args.read_len, index_path=args.index,
                         **kwargs)
    else:
        out = serve(loop=args.loop, index_path=args.index, chaos=args.chaos,
                    **kwargs)
    if args.health_out and out.get("health") is not None:
        os.makedirs(os.path.dirname(args.health_out) or ".", exist_ok=True)
        with open(args.health_out, "w") as f:
            json.dump(out["health"], f, indent=2, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
