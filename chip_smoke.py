#!/usr/bin/env python3
"""Drive repro_torch's paired-end mapping path on one NVIDIA GPU and hold
each hand-written CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card and build: the card's name and power limit, the kernel build;
  2. main path at chromosome scale: a 2^27-base random reference (about
     GRCh38 chr10), a 2^26-bucket SeedMap built on the card, one
     `Mapper.map` of 65,536 pairs (sub_rate 0.01) and a `map_stream` of 4
     batches of 65,536 pairs (the last one ragged), with every kernel's
     launches counted over exactly this phase;
  3. each kernel against its plain version at the shapes the main path
     gives it: the same 65,536-pair batch `map` got, and the 16,384-row
     residual buffer that step 5 builds from it (extra checks at that
     size: the unpacked flavor, prescreen_top 4, a band >= W DP); exact
     equality, timed with CUDA events;
  4. the same 65,536-pair batch through the kernel Mapper and a
     plain-backend Mapper on the card: equal MapResults, field by field;
  5. the card line, the `kernels` JSON line and the final `ok` line.

Exits 1 without a result when no CUDA device is available.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REF_LEN = 1 << 27            # ~GRCh38 chr10 (133.8 Mbp)
TABLE_BITS = 26
BATCH = 65_536
STREAM_BATCHES = 4
RAGGED_TAIL = 40_000
SEED = 0

# H100 SXM peaks used for the bounds: HBM3 at 3.35 TB/s (data sheet), and
# non-tensor int32 at 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock =
# 16.7 Tops/s (Hopper architecture white paper: 64 INT32 units per SM).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

REPLACES = {
    "seed_buckets": "src/repro/kernels/pair_frontend/kernel.py:118",
    "pair_frontend": "src/repro/kernels/pair_frontend/kernel.py:298",
    "candidate_align": "src/repro/kernels/candidate_align/kernel.py:310",
    "residual_dp": "src/repro/kernels/residual_dp/kernel.py:171",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two bounds it."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(got, want) -> int:
    """Largest |got - want| over every field of two result tuples."""
    worst = 0
    for a, b in zip(got, want):
        d = (a.to("cpu").long() - b.to("cpu").long()).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def profile_step(mapper, sim, record: dict, out_dir: Path) -> None:
    """Steady-state time of one `map` step on reads already on the card,
    and where its device time goes (torch.profiler), after the launch
    counts of the main path were read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = mapper.device
    r1 = torch.as_tensor(sim.reads1, device=dev)
    r2 = torch.as_tensor(sim.reads2, device=dev)

    def step():
        return mapper.map(r1, r2)

    step_ms = time_ms(step, 10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): operator rows repeat the
    # device time of the kernels they launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [{"name": e.key[:80], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3} for e in events[:12]]
    (out_dir / "profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    record["step"] = {"pairs": len(sim.reads1), "step_ms": step_ms,
                      "pairs_per_s": len(sim.reads1) / step_ms * 1e3,
                      "profiled_wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "device_idle_share": 1 - busy_ms / wall_ms, "top": top}
    print(f"[2] steady map step: {len(sim.reads1)} pairs in {step_ms:.3f} ms"
          f" ({len(sim.reads1) / step_ms * 1e3:.0f} pairs/s); profiled "
          f"step {wall_ms:.3f} ms wall, {busy_ms:.3f} ms device-busy")
    for t in top:
        print(f"[2]   {t['device_ms']:9.3f} ms  x{t['calls']:<3d} "
              f"{t['name']}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.encoding import revcomp
    from repro_torch.core.pipeline import (
        M_LIGHT, PipelineConfig, residual_buffer)
    from repro_torch.core.seeding import seed_offsets_tuple
    from repro_torch.core.seedmap import INVALID_LOC, SeedMapConfig
    from repro_torch.core.simulate import (
        ReadSimConfig, random_reference, simulate_pairs)
    from repro_torch.engine import ExecutionConfig, Mapper
    from repro_torch.kernels import _cuda
    from repro_torch.kernels._util import kernel_reference
    from repro_torch.kernels.candidate_align.ops import candidate_pair_align
    from repro_torch.kernels.pair_frontend.ops import (
        frontend_from_buckets, seed_buckets)
    from repro_torch.kernels.pair_frontend.ref import (
        frontend_from_buckets_ref, seed_buckets_ref)
    from repro_torch.kernels.residual_dp.ops import residual_pair_dp

    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    record = {}

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    print(f"[1] card: {card}; {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _cuda.library()
    record["build_s"] = time.time() - t0
    (out_dir / "build.log").write_text(_cuda.build_log())
    print(f"[1] kernels built in {record['build_s']:.1f} s "
          f"(nvcc output: chiprun_out/build.log)")

    # ---- 2. main path at chromosome scale ---------------------------------
    pipe = PipelineConfig(packed_ref=True)
    sm_cfg = SeedMapConfig(table_bits=TABLE_BITS)
    rng = np.random.default_rng(SEED)
    ref = random_reference(REF_LEN, rng)
    noisy = simulate_pairs(ref, BATCH, ReadSimConfig(sub_rate=0.01),
                           seed=SEED + 1)

    # simulated up front, so the stream's clock covers mapping only
    stream_batches = []
    for k in range(STREAM_BATCHES):
        n = RAGGED_TAIL if k == STREAM_BATCHES - 1 else BATCH
        s = simulate_pairs(ref, n, ReadSimConfig(), seed=SEED + 2 + k)
        stream_batches.append((s.reads1, s.reads2, s.true_start1))

    def count_correct(state, res, true1):
        hit = (res.pos1 != INVALID_LOC) & res.n_valid \
            & ((res.pos1.long() - true1.long()).abs() <= 5)
        return state + hit.sum()

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    mapper = Mapper.build(ref, sm_cfg, pipe, ExecutionConfig(device="cuda"))
    torch.cuda.synchronize()
    record["index_build_s"] = time.time() - t0
    print(f"[2] index: {REF_LEN} bases, {sm_cfg.table_size} buckets, "
          f"{mapper.pipe_cfg.max_locs_per_seed}-wide rows, built on the card in "
          f"{record['index_build_s']:.1f} s")

    _cuda.reset_launches()
    t0 = time.time()
    res = mapper.map(noisy.reads1, noisy.reads2)
    torch.cuda.synchronize()
    record["map_s"] = time.time() - t0
    sr = mapper.map_stream(stream_batches, reduce_fn=count_correct,
                           reduce_init=torch.zeros((), dtype=torch.int64,
                                                   device=dev))
    launches = _cuda.launch_counts()
    record["launches"] = launches
    print(f"[2] launches on the main path: {launches}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel never launched on the main path: "
                           f"{launches}")

    pos1 = res.pos1.cpu().numpy()
    mapped = pos1 != INVALID_LOC
    within = mapped & (np.abs(pos1.astype(np.int64) - noisy.true_start1) <= 5)
    methods = np.bincount(res.method.cpu().numpy(), minlength=5).tolist()
    record["map"] = {"pairs": BATCH, "sub_rate": 0.01,
                     "mapped": float(mapped.mean()),
                     "within_5": float(within.mean()),
                     "methods_0to4": methods}
    stream_within = int(sr.reduced) / sr.n_pairs
    record["stream"] = {"pairs": sr.n_pairs, "batches": sr.n_batches,
                        "seconds": sr.seconds,
                        "pairs_per_s": sr.pairs_per_s,
                        "totals": sr.totals, "within_5": stream_within}
    record["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[2] map: {BATCH} pairs in {record['map_s']:.3f} s, methods "
          f"{methods}, mapped {mapped.mean():.4f}, within 5 bp of truth "
          f"{within.mean():.4f}")
    print(f"[2] map_stream: {sr.n_pairs} pairs in {sr.n_batches} batches, "
          f"{sr.seconds:.3f} s ({sr.pairs_per_s:.0f} pairs/s), within 5 bp "
          f"{stream_within:.4f}")
    print(f"[2] stage totals: {sr.totals}")
    print(f"[2] peak device memory: {record['peak_mem_bytes'] / 2**30:.2f} "
          f"GiB")
    if sr.totals["n_pairs"] != (STREAM_BATCHES - 1) * BATCH + RAGGED_TAIL:
        raise RuntimeError("stream totals miss pairs or count padding")
    if within.mean() < 0.7 or stream_within < 0.95:
        raise RuntimeError("mapping accuracy below the expected floor")
    profile_step(mapper, noisy, record, out_dir)

    # ---- 3. each kernel against its plain version --------------------------
    # The main path's shapes: the batch `map` got above, and the residual
    # buffer its step 5 builds.
    B, C, E, R = BATCH, pipe.max_candidates, pipe.max_gap, pipe.read_len
    S, K = pipe.seeds_per_read, mapper.pipe_cfg.max_locs_per_seed
    M = S * K
    T = sm_cfg.table_size
    words, kref = mapper.ref, mapper.kref
    bases = torch.as_tensor(ref, device=dev)
    bases_kref = kernel_reference(bases, kref.pad, False)
    r1 = torch.as_tensor(noisy.reads1, device=dev)
    r2 = revcomp(torch.as_tensor(noisy.reads2, device=dev)).contiguous()
    rows = mapper.index.rows
    offs = seed_offsets_tuple(R, pipe.seed_len, S)
    offs_t = torch.tensor(offs, device=dev)
    kernels = {}

    def compare(name, run_kernel, run_plain, n_bytes, n_ops, timed=True,
                iters=20):
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        entry = kernels.setdefault(name, {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": 0, "match": True, "library_ms": None,
            "checks": 0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["match"] = entry["match"] and err == 0
        entry["checks"] += 1
        if timed:
            entry["ms"] = time_ms(run_kernel, iters)
            entry["plain_ms"] = time_ms(run_plain, 3, warmup=1)
            entry["bound_ms"], entry["bound_by"] = bound(n_bytes, n_ops)
            entry["bound_bytes"], entry["bound_ops"] = n_bytes, n_ops
        print(f"[3] {name}: max |kernel - plain| = {err}")

    # kernel 1: seed_buckets over both mates
    compare("seed_buckets",
            lambda: (seed_buckets(r1, r2, pipe.seed_len, S, 0, T),),
            lambda: (seed_buckets_ref(torch.cat([r1, r2]), pipe.seed_len, S,
                                      0, T),),
            n_bytes=2 * B * R + 2 * B * S * 4,
            n_ops=2 * B * S * (2 * pipe.seed_len + 40))
    buckets = seed_buckets(r1, r2, pipe.seed_len, S, 0, T)

    # kernel 2: row gather + stable sort + Δ filter + compaction.  The
    # function's own work: each mate's M row slots scanned, its h valid
    # starts sorted (2 h log2 h), a searchsorted of mate 1's into mate 2's
    # (2 h1 log2 h2), and O(h1) probing, dedup and compaction.
    fe = frontend_from_buckets(rows, buckets, offs, pipe.delta, C)
    h1 = fe.n_hits1.double()
    h2 = fe.n_hits2.double()

    def nlogn(h, n):
        return h * torch.log2(n.clamp(min=2))

    fe_ops = 2 * B * M + float(
        (2 * nlogn(h1, h1) + 2 * nlogn(h2, h2) + 2 * nlogn(h1, h2)
         + 12 * h1).sum())
    compare("pair_frontend",
            lambda: frontend_from_buckets(rows, buckets, offs, pipe.delta, C),
            lambda: frontend_from_buckets_ref(rows, buckets[:B], buckets[B:],
                                              offs_t, pipe.delta, C),
            n_bytes=2 * B * S * 4 + 2 * B * M * 4 + B * (2 * C + 3) * 4,
            n_ops=fe_ops)
    record["frontend_hits_per_mate"] = float((h1 + h2).mean() / 2)

    # kernel 3: candidate alignment, both flavors, prescreen 0 and 4.  The
    # function aligns each valid candidate of both mates (one window at 0
    # for a pair without any) and, with a prescreen, takes the zero-shift
    # Hamming distance of every valid candidate first.
    W = R + 2 * E
    n_cand = fe.n.long()
    light = dict(scoring=pipe.scoring, threshold=pipe.threshold(),
                 mode=pipe.light_mode)
    for packed in (True, False):
        for prescreen in (0, 4):
            aligned = n_cand.clamp(min=1)
            if prescreen:
                aligned = aligned.clamp(max=prescreen)
            n_align = 2 * int(aligned.sum())
            win_bytes = (W // 16 + 2) * 4 if packed else W
            ref_in, kref_in = (words, kref) if packed else (bases, bases_kref)
            compare(
                "candidate_align",
                lambda p=packed, q=prescreen, x=ref_in, k=kref_in:
                candidate_pair_align(
                    x, r1, r2, fe.pos1, fe.pos2, E, prescreen_top=q,
                    packed_ref=p, backend="cuda", kref=k, **light),
                lambda p=packed, q=prescreen, x=ref_in: candidate_pair_align(
                    x, r1, r2, fe.pos1, fe.pos2, E, prescreen_top=q,
                    packed_ref=p, backend="torch", **light),
                n_bytes=2 * B * R + 2 * B * C * 4 + n_align * win_bytes
                + 12 * B * 4,
                n_ops=n_align * R * (2 * E + 1) * 6
                + (2 * int(n_cand.sum()) * R * 2 if prescreen else 0),
                timed=packed and prescreen == 0)
    pair = candidate_pair_align(words, r1, r2, fe.pos1, fe.pos2, E,
                                packed_ref=True, backend="cuda", kref=kref,
                                **light)

    # kernel 4: residual DP of the failed mates in step 5's buffer (the
    # main path's band, and the full DP)
    passed = fe.n > 0
    light_ok = passed & pair.ok1 & pair.ok2
    cap = pipe.residual_cap(B)
    buf = residual_buffer(pair, passed & ~light_ok, cap)
    idx = buf.idx
    dp_in = (r1[idx], r2[idx], pair.pos1[idx], pair.pos2[idx], buf.need1,
             buf.need2, pipe.dp_pad)
    n_items = int(buf.need1.sum() + buf.need2.sum())
    Wd = R + 2 * pipe.dp_pad
    for packed, band in ((True, pipe.band()), (False, pipe.band()),
                         (True, Wd)):
        cols = 2 * band + 1 if band < Wd else Wd + 1
        win_bytes = (Wd // 16 + 2) * 4 if packed else Wd
        ref_in, kref_in = (words, kref) if packed else (bases, bases_kref)
        compare(
            "residual_dp",
            lambda p=packed, bd=band, x=ref_in, k=kref_in: residual_pair_dp(
                x, *dp_in, band=bd, scoring=pipe.scoring, packed_ref=p,
                backend="cuda", kref=k),
            lambda p=packed, bd=band, x=ref_in: residual_pair_dp(
                x, *dp_in, band=bd, scoring=pipe.scoring, packed_ref=p,
                backend="torch"),
            n_bytes=n_items * (R + win_bytes) + cap * (2 * 4 + 2 + 4 * 4),
            n_ops=n_items * R * cols * 14,
            timed=packed and band == pipe.band(), iters=10)
    record["residual_buffer"] = {"rows": cap, "items": n_items}
    print(f"[3] residual buffer: {cap} rows, {n_items} live items")

    # ---- 4. whole step against the plain-backend Mapper --------------------
    plain = Mapper.from_index(mapper.index, mapper.ref, pipe,
                              ExecutionConfig(device="cuda", backend="torch"))
    got = mapper.map(noisy.reads1, noisy.reads2)
    want = plain.map(noisy.reads1, noisy.reads2)
    torch.cuda.synchronize()
    for f in got._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise RuntimeError(f"kernel and plain Mappers differ in {f}")
    share = float((got.method == M_LIGHT).float().mean())
    print(f"[4] {B}-pair batch: kernel and plain Mappers agree on all "
          f"{len(got._fields)} MapResult fields (light-mapped {share:.4f})")

    # ---- 5. results -----------------------------------------------------
    bad = [k["name"] for k in kernels.values() if not k["match"]]
    if bad:
        raise RuntimeError(f"kernels differ from their plain versions: {bad}")
    line = {"kernels": [kernels[n] for n in REPLACES]}
    record.update(card=card, kernels=line["kernels"])
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
