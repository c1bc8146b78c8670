"""The stream's copy ring (`repro_torch.engine.stream.CopyRing`).

On the CPU the card's stream calls are scripted (`_Card`): the order of
the copies, the steps and the events between them, slot reuse, a change
of shape, the close, and `Mapper.map_stream` / `map_long_stream` through
a ring against the CPU's own stream.  On the card (`cuda`-marked, they
skip elsewhere): `map_stream` and `map_long_stream` through the real ring
against `Mapper.map` / `map_long` on the same batches, bit for bit, every
result kept until the stream ends, and the stage totals.

Run the card tests on a machine with an NVIDIA GPU and nvcc:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_stream.py
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.core.long_read import long_stage_stat_counts
from repro_torch.core.pipeline import PipelineConfig, stage_stat_counts
from repro_torch.core.seedmap import SeedMapConfig
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_long_reads,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, Mapper, graph, spans, stream
from repro_torch.engine.stream import pad_tail
from repro_torch.kernels import _cuda

COMPUTE = types.SimpleNamespace(cuda_stream=1)
COPY = types.SimpleNamespace(cuda_stream=2)
CPU = torch.device("cpu")


class _Card:
    """`kernels._cuda.TimingEvents`' calls, ``use`` (the current stream)
    and the steps, logged in the order the host issues them."""

    def __init__(self):
        self.log: list = []
        self.made = 0
        self.freed: list = []
        self.current = COMPUTE.cuda_stream

    def create(self, device):
        self.made += 1
        return self.made

    def destroy(self, ev):
        self.freed.append(ev)

    def record(self, ev, stream_):
        self.log.append(("record", stream_, ev))

    def wait(self, stream_, ev):
        self.log.append(("wait", stream_, ev))

    def use(self, stream_):
        self.current = stream_.cuda_stream
        self.log.append(("use", stream_.cuda_stream))


def _scripted_ring(monkeypatch):
    """Every stream gets a ring on the CPU whose stream calls go to a
    `_Card`; returns the card and the list of rings made."""
    card, made = _Card(), []

    def on(cls, device, owner=None):
        made.append(cls(device, card, COMPUTE, COPY, card.use, owner=owner))
        return made[-1]

    monkeypatch.setattr(stream.CopyRing, "on", classmethod(on))
    return card, made


def _host_batches(widths, rows=8, tail=None, seed=0):
    """One batch of two (rows, w) read arrays for each w of ``widths``,
    then a ragged tail of batch 0's first ``tail`` rows."""
    rng = np.random.default_rng(seed)
    out = [tuple(rng.integers(0, 4, (rows, w), dtype=np.uint8)
                 for _ in range(2)) for w in widths]
    if tail is not None:
        out.append(tuple(r[:tail] for r in out[0]))
    return out


def _run(card, batches, stream_batch=None):
    """`run_stream` over ``batches`` with a step that logs itself, the
    current stream and the reads it was handed."""
    seen = []

    def dispatch(*args):
        *reads, n, aux = args
        card.log.append(("dispatch", len(seen), card.current))
        seen.append(([r.clone() for r in reads],
                     [r.data_ptr() for r in reads], n))
        return len(seen) - 1

    with spans.StreamTrace(CPU) as trace:
        got = stream.run_stream(dispatch, iter(batches), trace, CPU,
                                stream_batch=stream_batch,
                                drain=lambda: "drained")
    return got, seen


def _last_record(log, ev, before):
    """Where ``ev`` was last recorded before position ``before``."""
    return max(i for i in range(before)
               if log[i][0] == "record" and log[i][2] == ev)


def _copies(log):
    """Each batch's copies: the positions where the copy stream became
    the current one."""
    return [i for i, e in enumerate(log) if e == ("use", COPY.cuda_stream)]


def test_the_cpu_stream_has_no_ring():
    assert stream.CopyRing.on(CPU) is None


@pytest.mark.parametrize("n,tail", [(6, None), (7, 3)])
def test_each_copy_waits_for_the_step_two_batches_back(monkeypatch, n,
                                                       tail):
    """For every batch k: its copies run on the copy stream after a wait
    on slot k % 2's release, which for k >= 2 was recorded on the compute
    stream right after ``dispatch(k - 2)`` returned, and are enqueued
    before ``dispatch(k - 1)``; ``dispatch(k)`` runs on the compute stream
    after a wait on the event recorded after batch k's copies, reads slot
    k % 2, and finds batch k's reads there (the ragged tail padded)."""
    card, rings = _scripted_ring(monkeypatch)
    batches = _host_batches([12] * n, tail=tail)
    (items, n_batches, _, drained), seen = _run(card, batches)
    total = n + (tail is not None)
    assert (n_batches, drained) == (total, "drained")
    assert items == 8 * n + (tail or 0)
    log = card.log
    ring, = rings
    copies = _copies(log)
    steps = [log.index(("dispatch", k, COMPUTE.cuda_stream))
             for k in range(total)]
    assert len(copies) == total
    for k in range(total):
        s = k % 2
        kind, on, rel = log[copies[k] - 1]
        assert (kind, on, rel) == ("wait", COPY.cuda_stream,
                                   ring.released[s])
        j = _last_record(log, rel, copies[k] - 1)
        assert log[j][1] == COMPUTE.cuda_stream
        if k >= 2:
            assert log[j - 1] == ("dispatch", k - 2, COMPUTE.cuda_stream)
        else:                       # the slot's first use: made just now
            assert j == copies[k] - 2
        if k >= 1:
            assert steps[k - 2] < copies[k] < steps[k - 1] if k >= 2 \
                else copies[k] < steps[k - 1]
        # the compute stream's wait right before dispatch(k) ...
        w = max(i for i in range(steps[k]) if log[i][0] == "wait")
        assert log[w][:2] == ("wait", COMPUTE.cuda_stream)
        assert log[w][2] == ring.copied[s]
        # ... is on the event recorded on the copy stream after batch k's
        # copies, and the compute stream is current again in between
        c = _last_record(log, ring.copied[s], w)
        assert copies[k] < c < w and log[c][1] == COPY.cuda_stream
        assert ("use", COMPUTE.cuda_stream) in log[c:w]
        # the step's release follows it at once
        assert log[steps[k] + 1] == ("record", COMPUTE.cuda_stream,
                                     ring.released[s])
        reads, ptrs, rows = seen[k]
        assert ptrs == seen[s][1] and ptrs != seen[1 - s][1]
        want = [pad_tail(r, 8) for r in batches[k]]
        assert all(torch.equal(got, torch.from_numpy(w_))
                   for got, w_ in zip(reads, want))
        assert rows == batches[k][0].shape[0]
    # close: the compute stream waits for both slots' last copies, the
    # caller's stream is current again, every event is freed
    assert log[-3:] == [("wait", COMPUTE.cuda_stream, ring.copied[0]),
                        ("wait", COMPUTE.cuda_stream, ring.copied[1]),
                        ("use", COMPUTE.cuda_stream)]
    assert sorted(card.freed) == [1, 2, 3, 4] and card.made == 4
    assert ring.slots == [None, None]


def test_a_new_shape_takes_a_new_slot_after_every_step_so_far(monkeypatch):
    """Batches 0-2 of 12 bases, 3-5 of 20: batches 3 and 4 make new slots,
    each releasing it at once, after every dispatch launched so far
    (dispatch(k - 2), which may still read the memory a new slot takes
    over); from batch 5 on the ring is as before."""
    card, rings = _scripted_ring(monkeypatch)
    batches = _host_batches([12, 12, 12, 20, 20, 20])
    _, seen = _run(card, batches)
    log, ring = card.log, rings[0]
    copies = _copies(log)
    steps = [log.index(("dispatch", k, COMPUTE.cuda_stream))
             for k in range(6)]
    for k in (3, 4):
        rel = log[copies[k] - 1][2]
        j = _last_record(log, rel, copies[k] - 1)
        assert steps[k - 2] + 1 < j < steps[k - 1]
        assert log[j] == ("record", COMPUTE.cuda_stream, rel)
        assert seen[k][0][0].shape == (8, 20)
    rel = log[copies[5] - 1][2]
    j = _last_record(log, rel, copies[5] - 1)
    assert log[j - 1] == ("dispatch", 3, COMPUTE.cuda_stream)
    assert seen[5][1] == seen[3][1] and seen[4][1] != seen[3][1]
    for k in range(6):
        assert torch.equal(seen[k][0][0], torch.from_numpy(batches[k][0]))


@pytest.fixture(scope="module")
def small_world():
    ref = random_reference(60_000, np.random.default_rng(5))
    sim = simulate_pairs(ref, 96, ReadSimConfig(sub_rate=0.01), seed=9)
    reads, _ = simulate_long_reads(ref, 40, 600, 0.01, seed=7)
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=14),
                          PipelineConfig(),
                          ExecutionConfig(device="cpu", stream_batch=32))
    return mapper, sim, reads


def _same(a, b, msg=""):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{f} {msg}"


@pytest.mark.parametrize("lane", ["pairs", "long"])
def test_mapper_stream_through_a_ring_equals_the_plain_stream(
        monkeypatch, small_world, lane):
    """`Mapper` streams through a scripted ring on the CPU: every kept
    result equals the stream without a ring, and none shares memory with
    a slot of the ring (so a later copy cannot overwrite what the
    consumer kept)."""
    mapper, sim, reads = small_world
    if lane == "pairs":
        batches = [(sim.reads1[k:k + 32], sim.reads2[k:k + 32])
                   for k in (0, 32, 64)] + [(sim.reads1[:7], sim.reads2[:7])]
        run = mapper.map_stream
    else:
        batches = [(reads[:16],), (reads[16:32],), (reads[32:],)]
        run = mapper.map_long_stream

    def collect(kept, rings):
        def on_result(idx, res, n):
            slots = {t.untyped_storage().data_ptr()
                     for ring in rings for slot in ring.slots if slot
                     for t in slot}
            assert not slots & {getattr(res, f).untyped_storage().data_ptr()
                                for f in res._fields}
            kept.append((idx, res, n))
        return on_result

    plain: list = []
    want = run(iter(batches), on_result=collect(plain, []))
    card, rings = _scripted_ring(monkeypatch)
    kept: list = []
    got = run(iter(batches), on_result=collect(kept, rings))
    assert len(rings) == 1
    assert rings[0].copies == rings[0].taken == len(batches)
    assert got.totals == want.totals and got.n_pairs == want.n_pairs
    assert [i for i, _, _ in kept] == list(range(len(batches)))
    for (i, a, n), (_, b, m) in zip(kept, plain):
        assert n == m
        _same(a, b, f"batch {i}")


class _ScriptedGraph:
    """`engine.graph.StepGraph` on the CPU: the capture runs the step once
    with its launches recorded and no stream active, as the card's capture
    records it, and each replay runs it again on what the slot holds then
    (no span entered), packed and copied out as a replay's result is."""

    def __init__(self, body, pool):
        self.body = body
        self.launches = {}
        with spans.no_stream(), _cuda.recorded_launches(self.launches):
            body()

    def replay(self):
        with spans.no_stream():
            res, counts = self.body()
        flat, layout = graph.pack(res)
        _cuda.count_launches(self.launches)
        return graph.unpack(type(res), flat.clone(), layout), counts


def test_a_full_batch_replays_its_slots_graph(monkeypatch, small_world):
    """A session with step graphs, on the CPU through a scripted ring and
    scripted graphs: the first full batch of each slot runs eagerly and
    captures the slot's graph, every later full batch replays it, the
    ragged tail runs eagerly; a second stream replays every full batch.
    Each kept result equals the stream without graphs, lies in memory of
    its own (neither a slot's nor another result's) and the stage totals
    are the same."""
    mapper, sim, _ = small_world
    batches = [(sim.reads1[k:k + 32], sim.reads2[k:k + 32])
               for k in range(0, 72, 12)] + [(sim.reads1[:7],
                                               sim.reads2[:7])]

    def stream_of(kept):
        return mapper.map_stream(
            iter(batches), on_result=lambda i, r, n: kept.append((i, r)))

    plain: list = []
    want = stream_of(plain)
    graphs = graph.StepGraphs(CPU)
    graphs.pool = "pool"
    monkeypatch.setattr(mapper, "_graphs", graphs)
    monkeypatch.setattr(graph, "StepGraph", _ScriptedGraph)
    card, rings = _scripted_ring(monkeypatch)
    for n_rings, captures, eager in ((1, 2, 3), (2, 0, 1)):
        kept: list = []
        got = stream_of(kept)
        tr = got.trace
        assert got.totals == want.totals
        assert (tr["batches"], tr["graph_captures"]) == (7, captures)
        assert tr["graph_replays"] == 6 - captures
        assert tr["spans"]["step"]["count"] == 7
        assert tr["spans"]["step.front"]["count"] == eager
        assert all(g is not None for g in graphs.graphs)
        owned = {t.untyped_storage().data_ptr()
                 for slot in graphs.slots for t in slot}
        assert len(rings) == n_rings and rings[-1].owner is graphs
        seen = set()
        for (i, a), (_, b) in zip(kept, plain):
            _same(a, b, f"batch {i}")
            ptrs = {getattr(a, f).untyped_storage().data_ptr()
                    for f in a._fields}
            assert not ptrs & (owned | seen), f"batch {i}"
            seen |= ptrs


def test_a_recorded_launch_counts_at_each_replay(monkeypatch):
    """`_cuda.recorded_launches` leaves every kernel's counts as they were
    and returns what the block launched, by path; `count_launches` adds
    that, once a replay."""
    def probe(name, *args):
        return 0

    lib = types.SimpleNamespace(probe_a=probe, probe_b=probe)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    a = _cuda.Kernel("probe_a", "probe_a", (_cuda.PTR,), lambda: None)
    b = _cuda.Kernel("probe_b", "probe_b", (_cuda.PTR,), lambda: None)
    monkeypatch.setitem(_cuda.KERNELS, "probe_a", a)
    x = torch.zeros(4)
    a(x, stream=x, work=(), path="lanes")
    out: dict = {}
    with _cuda.recorded_launches(out):
        monkeypatch.setitem(_cuda.KERNELS, "probe_b", b)   # registered late
        for path in ("lanes", "lanes", None):
            a(x, stream=x, work=(), path=path)
        b(x, stream=x, work=())
    assert (a.launches, a.paths, b.launches, b.paths) == (1, {"lanes": 1},
                                                          0, {})
    assert out == {"probe_a": (3, {"lanes": 2}), "probe_b": (1, {})}
    for _ in range(2):
        _cuda.count_launches(out)
    assert (a.launches, a.paths, b.launches) == (7, {"lanes": 5}, 2)


# ---------------------------------------------------------------- card --
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _pinned(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(r)).pin_memory()
                 .numpy() for r in batch)


def _kept_stream(run, batches):
    kept = []
    sr = run(iter(batches), on_result=lambda i, r, n: kept.append((i, r, n)))
    assert [i for i, _, _ in kept] == list(range(len(batches)))
    return sr, kept


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True])
def test_map_stream_on_the_card_equals_map(dev, pinned):
    """Seven distinct 262,144-pair batches and a ragged tail of 12,345
    (the card runs behind the host, so each copy overlaps the step before
    it), every result kept until the stream ends: each equals
    `Mapper.map` of the same (padded) batch bit for bit, and the stage
    totals equal their sum."""
    B = 262_144
    ref = random_reference(2_000_000, np.random.default_rng(11))
    sim = simulate_pairs(ref, 16_384, ReadSimConfig(sub_rate=0.01), seed=12)
    rng = np.random.default_rng(13)
    batches = []
    for _ in range(7):
        rows = rng.integers(0, 16_384, B)
        batches.append((sim.reads1[rows], sim.reads2[rows]))
    batches.append(tuple(r[:12_345] for r in batches[3][::-1]))
    if pinned:
        batches = [_pinned(b) for b in batches]
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=20),
                          PipelineConfig(),
                          ExecutionConfig(device="cuda", stream_batch=B))
    sr, kept = _kept_stream(mapper.map_stream, batches)
    assert sr.trace["h2d_bytes"] == 2 * B * 150 * len(batches)
    want_totals = dict.fromkeys(sr.totals, 0)
    for (i, res, n), (r1, r2) in zip(kept, batches):
        assert n == r1.shape[0]
        want = mapper.map(pad_tail(r1, B), pad_tail(r2, B))
        want = want._replace(n_valid=torch.arange(B, device=dev) < n)
        _same(res, want, f"batch {i}")
        for k, v in stage_stat_counts(want).items():
            want_totals[k] += int(v)
    assert sr.totals == want_totals


@pytest.mark.cuda
def test_map_long_stream_on_the_card_equals_map_long(dev):
    """`map_long_stream` over six distinct batches of 256 reads of 3 kbp
    and a ragged tail of 77, every result kept: each equals `map_long` of
    the same (padded) batch bit for bit, and the stage totals their
    sum."""
    B = 256
    ref = random_reference(2_000_000, np.random.default_rng(21))
    reads, _ = simulate_long_reads(ref, 6 * B + 77, 3000, 0.01, seed=22)
    batches = [(reads[k * B:(k + 1) * B],) for k in range(6)]
    batches.append((reads[6 * B:],))
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=20),
                          PipelineConfig(),
                          ExecutionConfig(device="cuda", stream_batch=B))
    sr, kept = _kept_stream(mapper.map_long_stream, batches)
    want_totals = dict.fromkeys(sr.totals, 0)
    for (i, res, n), (r,) in zip(kept, batches):
        assert n == r.shape[0]
        want = mapper.map_long(pad_tail(r, B))
        want = want._replace(n_valid=torch.arange(B, device=dev) < n)
        _same(res, want, f"batch {i}")
        for k, v in long_stage_stat_counts(want).items():
            want_totals[k] += int(v)
    assert sr.totals == want_totals


@pytest.mark.cuda
def test_map_stream_replays_a_graph_a_slot_on_the_card(dev, tmp_path):
    """Eight distinct full batches of 65,536 pairs and a ragged tail of
    777, every result kept until the stream ends: the first full batch of
    each slot runs eagerly and captures the slot's graph, the six after
    it replay, the tail runs eagerly.  Each result equals `Mapper.map` of
    the same (padded) batch bit for bit (a result that viewed the graph's
    memory would hold a later batch's), and the stage totals, launches
    and lane launches equal an eager stream's.  A second stream replays
    every full batch; after a swap to another index of the same shape the
    graphs are captured again and the results are the new index's."""
    B = 65_536
    ref = random_reference(2_000_000, np.random.default_rng(41))
    sim = simulate_pairs(ref, 16_384, ReadSimConfig(sub_rate=0.01), seed=42)
    rng = np.random.default_rng(43)
    batches = []
    for _ in range(8):
        rows = rng.integers(0, 16_384, B)
        batches.append((sim.reads1[rows], sim.reads2[rows]))
    batches.append(tuple(r[:777] for r in batches[5][::-1]))
    batches = [_pinned(b) for b in batches]
    cfg = ExecutionConfig(device="cuda", stream_batch=B)
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=20),
                          PipelineConfig(), cfg)
    graphs = mapper._graphs
    assert graphs is not None
    mapper._graphs = None
    eager = mapper.map_stream(iter(batches)).trace
    assert (eager["graph_captures"], eager["graph_replays"]) == (0, 0)
    mapper._graphs = graphs

    def check(session, captures):
        sr, kept = _kept_stream(mapper.map_stream, batches)
        tr = sr.trace
        assert (tr["graph_captures"], tr["graph_replays"]) == (
            captures, 8 - captures)
        assert tr["launches"] == eager["launches"]
        assert tr["light_lanes"] == eager["light_lanes"] > 0
        want_totals = dict.fromkeys(sr.totals, 0)
        for (i, res, n), (r1, r2) in zip(kept, batches):
            assert n == r1.shape[0]
            want = session.map(pad_tail(r1, B), pad_tail(r2, B))
            want = want._replace(n_valid=torch.arange(B, device=dev) < n)
            _same(res, want, f"batch {i}")
            for k, v in stage_stat_counts(want).items():
                want_totals[k] += int(v)
        assert sr.totals == want_totals
        return sr.totals

    totals = check(mapper, 2)
    assert check(mapper, 0) == totals
    other = random_reference(2_000_000, np.random.default_rng(44))
    fresh = Mapper.build(other, SeedMapConfig(table_bits=20),
                         PipelineConfig(), cfg)
    fresh.save(tmp_path / "other")
    assert mapper.swap_index(tmp_path / "other") == "reused"
    assert graphs.graphs == [None, None]
    check(fresh, 2)
