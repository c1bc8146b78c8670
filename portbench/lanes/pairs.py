"""The pair lane: paired-end short reads streamed through
``Mapper.map_stream`` against a SeedMap on the device, as a mapping job
runs one sample.

Set-up makes the reference from the seed, builds the program's index on
the device, draws a pool of distinct host batches and warms the stream up
on them.  The pool lies in pinned host memory, as a reader that decodes
reads into pinned staging buffers holds them, so the stream copies each
batch to the card without a host copy first (fed from ordinary memory,
the rate follows the host's memory bandwidth, which the card's host
shares).  The window feeds the pool round and round to ``map_stream``
(the mapper keeps no state between batches, so a batch maps the same
whenever it comes) until the window's seconds have passed: one client,
dispatching ahead as fast as the stream takes batches.  No mapping job
sends a batch twice, so reuse keyed on a batch's identity or address (a
cached pinned copy, device copy or result) is out of bounds for the
program: ``test_the_stream_keeps_no_pulled_batch`` holds the stream to
letting go of each batch.  A fresh host copy of every batch would cost
most of the rate (on one H100 80GB HBM3 with 8 host cores, a producer
thread copying the pool's batches fed 19-21 batches a second against
163-190 from the pool itself).  ``check`` then
maps every pool batch with the plain reference (`reference.plain`, its
own SeedMap) and holds the program to it field for field on a sample of
the window's batches, drawn from the seed, and on the stream's stage
totals over every batch.
"""
from __future__ import annotations

import random
import time

import torch

from portbench import generate
from portbench.reference import plain
from portbench.roofline import work

#: the numbers ``check`` compares, each with its limit (exact paths)
LIMITS = {"pair_mismatches": 0, "total_mismatches": 0}
#: the window's results kept for the field-by-field comparison
SAMPLE_BATCHES = 8
#: generator streams of one run seed
_REF, _FOREIGN, _POOL, _SAMPLE = 1, 2, 16, 3


def params(config: dict, **override) -> plain.Params:
    """The reference's view of a configuration file."""
    keys = plain.Params.__dataclass_fields__
    return plain.Params(**{**{k: config[k] for k in keys if k in config},
                           **override})


def library(config: dict, traffic: dict) -> generate.Library:
    return generate.Library(
        read_len=config["read_len"], insert_mean=config["insert_mean"],
        insert_std=config["insert_std"], sub_rate=traffic["sub_rate"],
        ins_rate=traffic["ins_rate"], del_rate=traffic["del_rate"],
        foreign_share=traffic.get("foreign_share", 0.0),
        edge_pad=config.get("edge_pad", 64))


def host_batch(reads: torch.Tensor):
    """A batch drawn on the device as the host array the stream is fed: in
    pinned memory where it was drawn on a card, as a reader that decodes
    its reads straight into pinned staging buffers hands them over (the
    stream's ``to_device`` then copies it to the card without a host copy
    first); in ordinary memory on the CPU."""
    if reads.device.type != "cuda":
        return reads.cpu().numpy()
    host = torch.empty(reads.shape, dtype=reads.dtype, pin_memory=True)
    host.copy_(reads)
    return host.numpy()


class _Feed:
    """The window's batches: the pool, round and round, until ``seconds``
    have passed since the first pull or ``batches`` were pulled.  Times
    how long the stream keeps the host between two pulls."""

    def __init__(self, pool, seconds=None, batches=None):
        self.pool, self.seconds, self.batches = pool, seconds, batches
        self.n = 0
        self.first = None
        self.host_s = 0.0
        self.host_intervals = 0
        self.pulls = []        # the clock at each batch's pull

    def __iter__(self):
        last = None
        while True:
            now = time.perf_counter()
            if self.first is None:
                self.first = now
            else:
                self.host_s += now - last
                self.host_intervals += 1
            if self.seconds is not None and now - self.first >= self.seconds:
                return
            if self.batches is not None and self.n >= self.batches:
                return
            item = self.pool[self.n % len(self.pool)]
            self.pulls.append(now)
            self.n += 1
            last = time.perf_counter()
            yield item


class _Sample:
    """``on_result``: a reservoir of ``k`` of the window's batch results,
    each batch equally likely, drawn from the run's seed; memory stays at
    ``k`` results however long the window."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng = k, rng
        self.kept: list = []
        self.seen = 0

    def __call__(self, idx, res, n):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((idx, res))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (idx, res)


class Lane:
    """One run of a pair-lane cell on ``device``."""

    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        self.config = cell.config
        self.params = params(cell.config)
        self.library = library(cell.config, cell.traffic)
        self.batch = int(cell.config["batch"])
        self.streams = []      # (pool batches sent by index, stage totals)
        self.sample = None
        self.work = None
        self._plain = None     # the reference's pool results, once made

    # ------------------------------------------------------------ set-up --
    def setup(self, log) -> None:
        from repro_torch.core.pipeline import PipelineConfig
        from repro_torch.core.seedmap import SeedMapConfig, build_seedmap
        from repro_torch.engine import ExecutionConfig, Mapper

        c, dev = self.config, self.device
        if dev.type == "cuda":
            from repro_torch.kernels import _cuda
            t = time.perf_counter()
            _cuda.library()
            log(f"kernel library loaded in {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        self.ref = generate.random_genome(
            c["genome_bases"], generate.generator(self.seed, _REF, dev), dev)
        sm_cfg = SeedMapConfig(
            seed_len=c["seed_len"], table_bits=c["table_bits"],
            max_locations=c["max_locations"], hash_seed=c["hash_seed"],
            padded_cap=c["padded_cap"])
        pipe = dict(read_len=c["read_len"], seed_len=c["seed_len"],
                    seeds_per_read=c["seeds_per_read"],
                    max_locs_per_seed=c["padded_cap"], delta=c["delta"],
                    max_candidates=c["max_candidates"], max_gap=c["max_gap"],
                    dp_pad=c["dp_pad"], light_mode=c["light_mode"],
                    residual_capacity_frac=c["residual_capacity_frac"],
                    packed_ref=c["packed_ref"])
        self.pipe = pipe
        self.mapper = Mapper.from_index(
            build_seedmap(self.ref, sm_cfg), self.ref,
            PipelineConfig(**pipe),
            ExecutionConfig(device=dev.type, stream_batch=self.batch))
        self._sync()
        log(f"reference and index built in {time.perf_counter() - t:.3f} s")

        t = time.perf_counter()
        foreign = None
        if self.library.foreign_share > 0:
            foreign = generate.random_genome(
                c["genome_bases"], generate.generator(self.seed, _FOREIGN,
                                                      dev), dev)
        self.pool = []
        for k in range(int(self.cell.traffic["pool_batches"])):
            r1, r2, *_ = generate.batch(
                self.ref, foreign, self.batch, self.library,
                generate.generator(self.seed, _POOL + k, dev))
            self.pool.append((host_batch(r1), host_batch(r2)))
        del foreign
        log(f"pool of {len(self.pool)} x {self.batch} pairs drawn in "
            f"{time.perf_counter() - t:.3f} s")

        t = time.perf_counter()
        self.mapper.map_stream(_Feed(self.pool, batches=2 * len(self.pool)),
                               on_result=_Sample(1, random.Random(0)))
        self._sync()
        log(f"warm-up stream of {2 * len(self.pool)} batches in "
            f"{time.perf_counter() - t:.3f} s")

    def reconfigure(self, **program_config) -> None:
        """Serve the same index with other pipeline fields (the control's
        paper-mode Light Alignment); forgets the streams sent so far."""
        from repro_torch.core.pipeline import PipelineConfig
        from repro_torch.engine import ExecutionConfig, Mapper

        self.mapper = Mapper.from_index(
            self.mapper.index, self.mapper.ref,
            PipelineConfig(**{**self.pipe, **program_config}),
            ExecutionConfig(device=self.device.type,
                            stream_batch=self.batch))
        self.streams = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window --
    def window(self, seconds: float) -> dict:
        """The measured stream: every batch sent until ``seconds`` passed,
        timed from the first pull to the stream's return after its final
        sync."""
        self.sample = _Sample(SAMPLE_BATCHES,
                              random.Random(generate.stream_seed(
                                  self.seed, _SAMPLE)))
        feed = _Feed(self.pool, seconds=seconds)
        sr = self.mapper.map_stream(feed, on_result=self.sample)
        end = time.perf_counter()
        self.streams.append((feed.n, sr.totals))
        per_s = [0] * (int(end - feed.first) + 1)
        for t in feed.pulls:
            per_s[int(t - feed.first)] += 1
        return {"seconds": end - feed.first, "batches": feed.n,
                "batches_per_s": per_s,
                "pairs": sr.n_pairs,
                "bases": sr.n_pairs * 2 * self.params.read_len,
                "host_s": feed.host_s,
                "host_intervals": feed.host_intervals,
                "totals": sr.totals}

    def traced(self, batches: int, trace_fn) -> dict:
        """``batches`` more batches, whole cycles of the pool, under
        ``trace_fn(body)`` (the profiler); returns its reduction."""
        feed = _Feed(self.pool, batches=batches)
        out = {}

        def body():
            out["stream"] = self.mapper.map_stream(feed)

        red = trace_fn(body)
        self.streams.append((feed.n, out["stream"].totals))
        red["batches"] = feed.n
        return red

    def launch_counts(self) -> dict:
        if self.device.type != "cuda":
            return {}
        from repro_torch.kernels import _cuda
        return {k: v for k, v in _cuda.launch_counts().items()
                if k in work.SYMBOLS}

    def release_program(self) -> None:
        """Free the program's session (its index above all); the sampled
        results stay."""
        del self.mapper
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check --
    def check(self, log) -> dict:
        """Map every pool batch with the plain reference and compare.

        Returns ``{"compared": {name: value}, "failed": pairs,
        "checked_pairs": n}`` and sets ``self.work`` (each kernel's
        bound a launch, averaged over the pool)."""
        dev = self.device
        if self._plain is None:
            self._plain = self._reference(log)
        refs, counts, works = self._plain

        P = len(self.pool)
        total_bad = 0
        for n_sent, totals in self.streams:
            sent = [n_sent // P + (1 if k < n_sent % P else 0)
                    for k in range(P)]
            want = {key: sum(s * cnt[key] for s, cnt in zip(sent, counts))
                    for key in plain.STAT_KEYS}
            bad = [k for k in plain.STAT_KEYS if totals[k] != want[k]]
            if bad:
                log(f"stage totals differ at {bad}: program {totals}, "
                    f"reference {want}")
            total_bad += len(bad)

        bad_pairs = checked = 0
        for idx, res in self.sample.kept:
            ref = refs[idx % P]
            row_bad = torch.zeros(self.batch, dtype=torch.bool, device=dev)
            for f in plain.RESULT_FIELDS:
                a, b = getattr(res, f).to(dev), getattr(ref, f)
                diff = a != b
                if diff.dim() > 1:
                    diff = diff.reshape(diff.shape[0], -1).any(1)
                if bool(diff.any()):
                    log(f"batch {idx}: {f} differs in {int(diff.sum())} "
                        f"pairs")
                row_bad |= diff
            bad_pairs += int(row_bad.sum())
            checked += self.batch
        self.work = self._bounds(works)
        return {"compared": {"pair_mismatches": bad_pairs,
                             "total_mismatches": total_bad},
                "failed": bad_pairs, "checked_pairs": checked,
                "checked_batches": len(self.sample.kept)}

    def _reference(self, log):
        """The plain reference's result, stage counts and work of every
        pool batch, from its own SeedMap of the reference bases."""
        p, dev = self.params, self.device
        t = time.perf_counter()
        sm = plain.build_csr(self.ref, p)
        refp = plain.padded_bases(self.ref)
        refs, counts, works = [], [], []
        for r1, r2 in self.pool:
            res, w = plain.map_batch(sm, refp, self.ref.shape[0],
                                     torch.from_numpy(r1).to(dev),
                                     torch.from_numpy(r2).to(dev), p)
            refs.append(res)
            counts.append(plain.stage_counts(res))
            works.append(w)
        del sm, refp
        self._sync()
        log(f"plain reference over {len(self.pool)} pool batches in "
            f"{time.perf_counter() - t:.3f} s")
        return refs, counts, works

    def _bounds(self, works) -> dict:
        """Each kernel's bound a launch, the mean over the pool's batches
        (the traced window sends whole cycles of the pool)."""
        p, B = self.params, self.batch
        R, S, K, C, E = (p.read_len, p.seeds_per_read, p.padded_cap,
                         p.max_candidates, p.max_gap)
        out = {k: 0.0 for k in work.SYMBOLS}
        for w in works:
            out["seed_buckets"] += work.bound_s(
                work.seed_buckets(B, R, S, p.seed_len))
            out["pair_frontend"] += work.bound_s(work.pair_frontend(
                B, S, K, C, w.hits1.cpu().numpy(), w.hits2.cpu().numpy()))
            out["candidate_align"] += work.bound_s(work.candidate_align(
                B, R, C, E, w.n_cand.cpu().numpy()))
            out["residual_dp"] += work.bound_s(work.residual_dp(
                w.dp_rows, R, R + 2 * p.dp_pad, p.band, w.dp_items))
        return {k: v / len(works) for k, v in out.items()}
