"""The stream path's spans, device markers and counters
(`repro_torch.engine.spans`) on the CPU: span counts and nesting, exact
counters, the profiler mirror (only while the profiler runs), the marker
arithmetic and pool on scripted events, and the benchmark's readers of
the measured window.  One test, on the card, reads the real markers."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import SeedMapConfig
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, Mapper, spans

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest  # noqa: E402

B, R = 32, 150
MARKERS = ("launch_queue_ms", "h2d_device_ms", "step_device_ms",
           "h2d_exposed_ms")
LONG_STEP_SPANS = ("step.segfront", "step.vote", "step.anchor")


@pytest.fixture(scope="module")
def world():
    ref = random_reference(60_000, np.random.default_rng(5))
    sim = simulate_pairs(ref, 4 * B, ReadSimConfig(sub_rate=0.01), seed=9)
    return ref, sim


def _mapper(ref, device="cpu"):
    return Mapper.build(ref, SeedMapConfig(table_bits=14), PipelineConfig(),
                        ExecutionConfig(device=device, stream_batch=B))


def _batches(sim, n=3, tail=None):
    out = [(sim.reads1[k * B:(k + 1) * B], sim.reads2[k * B:(k + 1) * B])
           for k in range(n)]
    if tail is not None:
        out.append((sim.reads1[:tail], sim.reads2[:tail]))
    return out


def test_every_span_once_a_batch_and_exact_counters(world):
    ref, sim = world
    mapper = _mapper(ref)
    seen = []
    sr = mapper.map_stream(iter(_batches(sim, 3, tail=7)),
                           on_result=lambda i, r, n: seen.append(i))
    tr = sr.trace
    n = sr.n_batches
    assert n == 4 and seen == [0, 1, 2, 3]
    assert spans.recent()[-1] is tr
    assert tr["profiled"] is False and tr["markers"] is None
    assert (tr["batches"], tr["items"]) == (n, 3 * B + 7)
    assert tr["pseudo_pairs"] == 0
    # no graph on the CPU: every step eager
    assert (tr["graph_replays"], tr["graph_captures"]) == (0, 0)
    # the reads' bytes, the ragged tail padded to the stream shape
    assert tr["h2d_bytes"] == 2 * B * R * n
    assert tr["staged_bytes"] == 0          # nothing is pinned on the CPU
    assert tr["launches"] == {}             # the plain path launches none
    assert tr["light_lanes"] == 0
    got = tr["spans"]
    assert set(got) == set(spans.SPANS)
    for name, s in got.items():
        # one more pull than batches: the last finds the iterator empty;
        # the long lane's step spans are never entered on the pair lane
        want = 1 if name in ("stream", "stream.drain") else \
            n + 1 if name == "stream.pull" else \
            0 if name in LONG_STEP_SPANS else n
        assert s["count"] == want, name
        assert s["parent"] == spans.SPANS[name], name
        assert 0 <= s["self_ms"] <= s["total_ms"], name
    for parent in ("stream", "step"):
        kids = [s["total_ms"] for k, s in got.items()
                if spans.SPANS[k] == parent]
        assert sum(kids) <= got[parent]["total_ms"]
        assert got[parent]["self_ms"] == pytest.approx(
            got[parent]["total_ms"] - sum(kids), abs=1e-6)


def test_no_span_outside_a_stream(world):
    ref, sim = world
    mapper = _mapper(ref)
    before = spans.recent()
    mapper.map(sim.reads1[:B], sim.reads2[:B])
    assert spans.recent() == before
    assert spans.span("step.front") is spans.span("step")


def test_recent_keeps_the_last_streams(world):
    ref, sim = world
    mapper = _mapper(ref)
    for k in range(spans.RECENT + 2):
        mapper.map_stream(iter(_batches(sim, 1 + k % 2)))
    got = spans.recent()
    assert len(got) == spans.RECENT
    assert [s["batches"] for s in got] == [1 + k % 2 for k in
                                           range(2, spans.RECENT + 2)]


def test_the_profiler_holds_the_spans_nested_with_batch_ids(world):
    from torch.profiler import ProfilerActivity, profile

    ref, sim = world
    mapper = _mapper(ref)
    for _ in range(2):   # a process's first record_function sets up ~ms
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sr = mapper.map_stream(iter(_batches(sim, 3)))
    tr = sr.trace
    assert tr["profiled"] is True
    ev = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            ev.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    (stream,) = ev["stream"]
    assert abs(stream[0] - tr["start_ns"]) < 1_000_000
    assert len(ev["stream.drain"]) == 1
    for name, parent in spans.SPANS.items():
        if name in ("stream", "stream.drain", "stream.on_result",
                    *LONG_STEP_SPANS):
            continue
        for b in range(3):
            (p0, p1), = (stream,) if parent == "stream" else \
                ev[f"{parent}#{b}"]
            (s0, s1), = ev[f"{name}#{b}"]
            assert p0 <= s0 <= s1 <= p1, (name, b)
    assert f"step#{3}" not in ev
    assert not any(k.startswith(LONG_STEP_SPANS) for k in ev)


def test_no_record_function_without_the_profiler(world, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    ref, sim = world
    mapper = _mapper(ref)
    entered = []
    real = spans.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(spans, "record_function", counting)
    mapper.map_stream(iter(_batches(sim, 2)))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        sr = mapper.map_stream(iter(_batches(sim, 2)))
    assert len(entered) == sum(
        s["count"] for s in sr.trace["spans"].values())
    assert entered[0] == "stream" and "step.front#1" in entered


class _Card:
    """`kernels._cuda.TimingEvents` on a scripted card: each recorded event
    runs at the next of ``runs`` (ns, on the host's clock) once the test
    lets the card reach it (``done_until``)."""

    NOT_READY = 600

    def __init__(self, runs):
        self.runs = list(runs)
        self.done_until = -1
        self.host = 0
        self.t = {}
        self.made = self.freed = 0

    def time_ns(self):
        return self.host

    def create(self, device):
        self.made += 1
        return self.made

    def destroy(self, ev):
        self.freed += 1

    def record(self, ev, stream):
        self.t[ev] = self.runs.pop(0)

    def synchronize(self, ev):
        self.done_until = max(self.done_until, self.t[ev])

    def elapsed(self, a, b):
        assert max(self.t[a], self.t[b]) <= self.done_until
        return (self.t[b] - self.t[a]) / 1e6

    def times(self, prev, m0, m1, r, s, m2):
        if self.t[m2] > self.done_until:
            return None
        return (self.elapsed(prev, m0), self.elapsed(m0, m1),
                self.elapsed(r, s), self.elapsed(s, m2))


COMPUTE, COPY = 7, 8


class _Streams(_Card):
    """`_Card` that also notes the stream each event is recorded on."""

    def __init__(self, runs):
        super().__init__(runs)
        self.on = {}

    def record(self, ev, stream):
        super().record(ev, stream)
        self.on[ev] = stream


def _markers(monkeypatch, card):
    monkeypatch.setattr(spans, "time_ns", card.time_ns)
    monkeypatch.setattr(spans, "MARKER_EVERY", 1)
    mk = spans._Markers(torch.device("cuda", 0), 0, card)
    mk.compute, mk.copy = COMPUTE, COPY
    return mk


def _batch(mk, batch=0):
    mk.copy_start(batch)
    mk.copy_end()
    mk.wait_start()
    mk.wait_end()
    mk.step_end()


def test_one_batch_in_marker_every_is_marked(monkeypatch):
    """Batch 0 and one in MARKER_EVERY of the rest, as often in each
    residue of a small period (a pool cycled by the caller)."""
    card = _Card(range(1, 5 * 8000 + 1))
    card.done_until = 10**18
    mk = _markers(monkeypatch, card)
    monkeypatch.setattr(spans, "MARKER_EVERY", 8)
    marked = []
    for b in range(8000):
        mk.copy_start(b)
        if mk.staged[-1] is not None:
            marked.append(b)
        mk.copy_end()
        mk.wait_start()
        mk.wait_end()
        mk.step_end()
    assert marked[0] == 0 and 0.12 < len(marked) / 8000 < 0.13
    for period in (2, 3, 4, 5, 16):
        for r in range(period):
            share = sum(b % period == r for b in marked) / len(marked)
            assert abs(share - 1 / period) < 0.01, (period, r)


def test_markers_place_the_card_on_the_host_clock(monkeypatch):
    """Three batches whose copies are enqueued at 0, 1 and 10 ms on the
    host, each batch's copies before the step of the batch before (as the
    stream issues them), run by the card at the times below: the queue
    waits, copies, exposed copies and steps come out exact, each marker
    lies on its stream, nothing is resolved before it ran, and every event
    is freed.  Batch 0's step waits 1 ms for its copy, batch 1's copy ran
    before its step was reached, batch 2's step waits for the 2 ms of its
    copy that outlast batch 1's step."""
    ms = 1_000_000
    # in the order recorded: copy 0 (M0, M1 on the copy stream), copy 1,
    # step 0 (R, S, M2 on the compute stream), copy 2, step 1, step 2; Z
    card = _Streams([1 * ms, 3 * ms,
                     3 * ms, 5 * ms,
                     2 * ms, 3 * ms, 7 * ms,
                     12 * ms, 22 * ms,
                     11 * ms, 11 * ms, 16 * ms,
                     20 * ms, 22 * ms, 29 * ms,
                     30 * ms])
    mk = _markers(monkeypatch, card)

    def copy(host):
        card.host = host
        mk.copy_start(0)
        mk.copy_end()

    def step():
        mk.wait_start()
        mk.wait_end()
        mk.step_end()

    copy(0)
    copy(1 * ms)
    step()
    copy(10 * ms)
    step()
    step()
    assert [card.on[e] for e in range(1, 16)] == \
        3 * [COPY, COPY, COMPUTE, COMPUTE, COMPUTE]
    assert mk.n == 0                    # nothing ran yet: nothing resolved
    card.done_until = 16 * ms           # the card finished batches 0 and 1
    card.host = 17 * ms
    mk.resolve()
    assert mk.n == 2 and len(mk.flight) == 1
    card.host = 30 * ms                 # Z runs at 30 ms, seen at once
    mk.anchor()
    assert card.on[16] == COMPUTE
    out = mk.out
    assert (out["batches"], out["skipped"]) == (3, 0)
    # M0 ran at 1, 3, 12 ms against host stamps 0, 1, 10 ms
    assert out["launch_queue_ms"] == pytest.approx((1 + 2 + 2) / 3)
    assert out["h2d_device_ms"] == pytest.approx((2 + 2 + 10) / 3)
    assert out["h2d_exposed_ms"] == pytest.approx((1 + 0 + 2) / 3)
    assert out["step_device_ms"] == pytest.approx((4 + 5 + 7) / 3)
    assert out["anchor_us"] == 0
    mk.close()
    assert card.freed == card.made == 16


def test_a_full_marker_pool_skips_and_counts(monkeypatch):
    ms = 1_000_000
    card = _Card([k * ms for k in range(1, 40)])
    monkeypatch.setattr(spans, "MARKER_POOL", 2)
    mk = _markers(monkeypatch, card)
    for _ in range(5):                  # the card runs nothing meanwhile
        _batch(mk)
    assert len(mk.flight) == 2 and mk.skipped == 3
    card.done_until = 10**18            # the card catches up
    _batch(mk)                          # resolves both, reuses a set
    assert mk.n == 2 and len(mk.free) == 0 and card.made == 10
    card.host = 39 * ms
    mk.anchor()
    assert (mk.out["batches"], mk.out["skipped"]) == (3, 3)
    mk.close()
    assert card.freed == card.made == 11


def _summary(profiled, batches, value):
    return {"profiled": profiled, "batches": batches,
            "markers": None if value is None else
            {"batches": batches, "skipped": 0,
             **{k: value + i for i, k in enumerate(MARKERS)}}}


@pytest.mark.parametrize("traced_batches", [32, 500])
def test_readers_take_the_measured_window(monkeypatch, traced_batches):
    """The untraced stream with the window's batch count, not the traced
    one after it (also where both hold as many batches), nor the
    warm-up."""
    cell = manifest.find_cell("pe150-775m.illumina")
    readers = {m.name: m.reader for m in cell.per_layer
               if m.name in MARKERS}
    assert set(readers) == set(MARKERS)
    recent = [_summary(False, 8, 1.0), _summary(False, 500, 10.0),
              _summary(True, traced_batches, 100.0)]
    monkeypatch.setattr(spans, "recent", lambda: list(recent))
    run = {"window": {"batches": 500}}
    assert [readers[k].read(run) for k in MARKERS] == [10.0, 11.0, 12.0,
                                                       13.0]
    # markers without the exposed copy (a program whose copy runs on the
    # compute stream): that one reader gives nothing
    del recent[1]["markers"]["h2d_exposed_ms"]
    assert [readers[k].read(run) for k in MARKERS] == [10.0, 11.0, 12.0,
                                                       None]
    # without markers (the CPU), or without the window's stream: nothing
    recent[1] = _summary(False, 500, None)
    assert [readers[k].read(run) for k in MARKERS] == [None] * len(MARKERS)
    recent[1] = _summary(False, 499, 10.0)
    assert [readers[k].read(run) for k in MARKERS] == [None] * len(MARKERS)


def test_step_graph_pct_reads_the_windows_replays(monkeypatch, world):
    """`step_graph_pct`: 100 x replays / batches of the untraced window's
    stream (not the traced one, nor the warm-up); None off the card, for
    a program without the counter and on the long lane."""
    reader, = (m.reader for m in
               manifest.find_cell("pe150-775m.illumina").per_layer
               if m.name == "step_graph_pct")
    ref, sim = world
    sr = _mapper(ref).map_stream(iter(_batches(sim, 2)))
    assert sr.trace["graph_replays"] == 0
    assert reader.read({"window": {"batches": sr.n_batches}}) is None

    def summary(profiled, batches, replays, pseudo_pairs=0):
        return {"profiled": profiled, "batches": batches,
                "pseudo_pairs": pseudo_pairs, "graph_replays": replays,
                "markers": {"batches": 0}}

    recent = [summary(False, 8, 6), summary(False, 400, 399),
              summary(True, 400, 400)]
    monkeypatch.setattr(spans, "recent", lambda: list(recent))
    run = {"window": {"batches": 400}}
    assert reader.read(run) == pytest.approx(99.75)
    recent[1]["graph_replays"] = 0
    assert reader.read(run) == 0.0
    recent[1]["markers"] = None
    assert reader.read(run) is None
    recent[1] = summary(False, 400, 0, pseudo_pairs=12_800)
    assert reader.read(run) is None
    del recent[1]["graph_replays"]
    recent[1]["pseudo_pairs"] = 0
    assert reader.read(run) is None


def test_the_cpu_run_reports_no_marker_metric():
    cell = manifest.find_cell("pe250-775m.illumina")
    readers = [m.reader for m in cell.per_layer if m.name in MARKERS]
    ref = random_reference(30_000, np.random.default_rng(1))
    sim = simulate_pairs(ref, B, ReadSimConfig(), seed=2)
    sr = _mapper(ref).map_stream(iter(_batches(sim, 1)))
    run = {"window": {"batches": sr.n_batches}}
    assert [r.read(run) for r in readers] == [None] * len(MARKERS)


@pytest.mark.cuda
def test_markers_on_the_card(world, monkeypatch):
    """The markers of small pageable and pinned streams; then a stream
    whose step outlasts its copy (262,144 pairs of 2x250 bp a batch at 1 %
    substitutions, so that about a sixth of the mates take the residual
    DP; the card behind the host, every batch marked): the copies are
    hidden behind the step before them, so the compute stream stalls on
    them far less than they take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    ref, sim = world
    mapper = _mapper(ref, "cuda")
    pageable = _batches(sim, 4)
    pinned = [tuple(torch.from_numpy(np.ascontiguousarray(r)).pin_memory()
                    .numpy() for r in item) for item in pageable]
    for batches, staged in ((pageable, True), (pinned, False)):
        tr = mapper.map_stream(iter(batches)).trace
        m = tr["markers"]
        assert m["skipped"] == 0 and 1 <= m["batches"] <= 4
        assert m["launch_queue_ms"] >= 0 and m["h2d_device_ms"] > 0
        assert m["step_device_ms"] > 0 and m["h2d_exposed_ms"] >= 0
        assert tr["h2d_bytes"] == 2 * B * R * 4
        assert tr["staged_bytes"] == (tr["h2d_bytes"] if staged else 0)
        assert sum(tr["launches"].values()) > 0
        # R 150: every candidate_align launch aligns on lane groups
        assert tr["light_lanes"] == tr["launches"]["candidate_align"] > 0

    big, r250 = 262_144, 250
    ref = random_reference(2_000_000, np.random.default_rng(31))
    sim = simulate_pairs(ref, 16_384, ReadSimConfig(
        read_len=r250, insert_mean=550, insert_std=50, sub_rate=0.01),
        seed=32)
    rng = np.random.default_rng(33)
    pool = []
    for _ in range(3):
        rows = rng.integers(0, 16_384, big)
        pool.append(tuple(
            torch.from_numpy(r[rows]).pin_memory().numpy()
            for r in (sim.reads1, sim.reads2)))
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=20),
                          PipelineConfig(read_len=r250),
                          ExecutionConfig(device="cuda", stream_batch=big))
    mapper.map_stream(iter(pool))                 # warm-up
    monkeypatch.setattr(spans, "MARKER_EVERY", 1)
    m = mapper.map_stream(iter(4 * pool)).trace["markers"]
    assert (m["batches"], m["skipped"]) == (12, 0)
    assert m["step_device_ms"] > m["h2d_device_ms"] > 0
    assert 0 <= m["h2d_exposed_ms"] < 0.5 * m["h2d_device_ms"]
