"""repro_torch's continuous-batching front door against repro's on the
CPU: a bursty two-lane trace gives every request the rows of a direct
`map` / `map_long` of its reads and the same rows, stage totals, batch
fills and ledger counts as repro's `FrontDoor` on the same trace; the
queue bound, deadline expiry, request validation, SIGTERM drain,
long-lane starvation guard, degraded watchdog, EVICT -> drain,
`reload_index`, `observe_fleet` and `request_drain` behave as repro's
tests/test_frontdoor.py pins them."""
import json
import os
import signal

import numpy as np
import pytest

from repro.core import PipelineConfig as JPipelineConfig
from repro.core import SeedMapConfig as JSeedMapConfig
from repro.core import build_seedmap as j_build_seedmap
from repro.engine import ExecutionConfig as JExecutionConfig
from repro.engine import FrontDoor as JFrontDoor
from repro.engine import FrontDoorConfig as JFrontDoorConfig
from repro.engine import Mapper as JMapper
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import SeedMapConfig
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_long_reads,
    simulate_pairs,
)
from repro_torch.engine import (
    ExecutionConfig,
    FrontDoor,
    FrontDoorConfig,
    Mapper,
)
from repro_torch.engine.frontdoor import DONE, EXPIRED, REJECTED, SHED
from repro_torch.engine.stream import pad_tail
from repro_torch.runtime import DEGRADED, EVICT, HEALTHY, PreemptionGuard

B = 16          # the sessions' fixed stream batch
LONG_LEN = 600  # long-lane read length (bp)
TB = 14


@pytest.fixture(scope="module")
def served_world():
    ref = random_reference(60_000, np.random.default_rng(0))
    # residual_capacity_frac=1.0: no DP-buffer overflow, so per-row
    # results do not depend on batch composition
    mapper = Mapper.build(ref, SeedMapConfig(table_bits=TB),
                          PipelineConfig(residual_capacity_frac=1.0),
                          ExecutionConfig(device="cpu", stream_batch=B))
    sim = simulate_pairs(ref, 4 * B, ReadSimConfig(sub_rate=3e-3), seed=1)
    lreads, _ = simulate_long_reads(ref, B, LONG_LEN, 0.01, seed=2)
    return ref, mapper, sim, lreads


@pytest.fixture(scope="module")
def repro_mapper(served_world):
    ref = served_world[0]
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=TB))
    return JMapper.from_index(
        jsm, ref, JPipelineConfig(residual_capacity_frac=1.0),
        JExecutionConfig(backend="jnp", stream_batch=B))


def _door(mapper, cls=FrontDoor, cfg_cls=FrontDoorConfig, **cfg):
    fd = cls(mapper, cfg_cls(**cfg))
    fd._guard.uninstall()   # tests drive preemption programmatically
    return fd


def _rows_equal(sliced, direct, n, skip=("n_valid",)):
    for f in sliced._fields:
        if f in skip:
            continue
        np.testing.assert_array_equal(
            np.asarray(getattr(sliced, f)),
            np.asarray(getattr(direct, f))[:n], err_msg=f)


def _trace(sim, lreads):
    """Ragged sizes, both lanes interleaved."""
    out, off, li = [], 0, 0
    for i, n in enumerate([5, 16, 1, 9, 3, 16, 7, 7]):
        out.append(("pairs", (sim.reads1[off:off + n],
                              sim.reads2[off:off + n])))
        off += n
        if i % 3 == 1 and li < len(lreads):
            m = min(3, len(lreads) - li)
            out.append(("long", (lreads[li:li + m],)))
            li += m
    return out


def _no_timing(ledger):
    return {k: v for k, v in ledger.items() if k != "latency"}


# ------------------------------------------------- the acceptance test ---
def test_bursty_two_lane_identity_and_repro_parity(served_world,
                                                   repro_mapper):
    ref, mapper, sim, lreads = served_world
    trace = _trace(sim, lreads)
    fd = _door(mapper, long_every=2)
    fd.warmup(long_reads=lreads[:1])
    report = fd.serve(iter(trace))

    serve_stats = report["serve"]
    assert serve_stats["accepted"] == serve_stats["completed"] == \
        len(fd.requests)
    assert serve_stats["rejected"] == serve_stats["shed"] == 0
    assert report["stage_totals"]["pairs"]["n_pairs"] == 64
    assert report["stage_totals"]["long"]["n_reads"] == 9
    lat = serve_stats["latency"]
    for comp in ("queue_wait_s", "service_s", "total_s"):
        assert lat[comp]["p99"] >= lat[comp]["p50"] >= 0.0
    json.dumps(report)

    # each request's rows == a direct map/map_long of exactly its reads
    for req in fd.requests:
        assert req.status == DONE
        if req.lane == "pairs":
            direct = mapper.map(pad_tail(req.reads[0], B),
                                pad_tail(req.reads[1], B))
        else:
            direct = mapper.map_long(pad_tail(req.reads[0], B))
        _rows_equal(req.result, direct, req.n)
        assert req.result.n_valid.all()

    # repro's door on the same trace: same rows, totals and ledger
    jfd = _door(repro_mapper, JFrontDoor, JFrontDoorConfig, long_every=2)
    jfd.warmup(long_reads=lreads[:1])
    jreport = jfd.serve(iter(trace))
    for k in ("lanes", "stream_batch", "max_queue_rows", "stage_totals",
              "watchdog", "drained"):
        assert report[k] == jreport[k], k
    assert _no_timing(report["serve"]) == _no_timing(jreport["serve"])
    assert [(r.lane, r.n, r.status) for r in fd.requests] == \
        [(r.lane, r.n, r.status) for r in jfd.requests]
    for req, jreq in zip(fd.requests, jfd.requests):
        _rows_equal(req.result, jreq.result, req.n, skip=())


def test_ledger_counts_match_repro_under_rejection(served_world,
                                                   repro_mapper):
    """A trace past the queue bound: the same requests are rejected and
    the ledger's counts and batch fills are repro's."""
    _, mapper, sim, lreads = served_world
    trace = _trace(sim, lreads) * 2
    reports = []
    for m, cls, cfg_cls in ((mapper, FrontDoor, FrontDoorConfig),
                            (repro_mapper, JFrontDoor, JFrontDoorConfig)):
        fd = _door(m, cls, cfg_cls, max_queue_rows=B + 4, long_every=1)
        reports.append((fd.serve(iter(trace)),
                        [r.status for r in fd.requests]))
    (got, got_status), (want, want_status) = reports
    assert got_status == want_status and REJECTED in got_status
    assert _no_timing(got["serve"]) == _no_timing(want["serve"])
    assert got["stage_totals"] == want["stage_totals"]


# ------------------------------------------------- admission control -----
def test_rejects_at_queue_bound(served_world):
    _, mapper, sim, _ = served_world
    fd = _door(mapper, max_queue_rows=B)
    a = fd.submit("pairs", (sim.reads1[:10], sim.reads2[:10]))
    b = fd.submit("pairs", (sim.reads1[10:16], sim.reads2[10:16]))
    over = fd.submit("pairs", (sim.reads1[16:17], sim.reads2[16:17]))
    assert over.status == REJECTED and over.result is None
    assert fd.stats.rejected == 1 and fd.stats.rejected_rows == 1
    fd.drain()
    assert a.status == DONE and b.status == DONE
    assert fd.stats.completed_rows == 16


def test_deadline_expiry(served_world):
    _, mapper, sim, _ = served_world
    fd = _door(mapper)
    dead = fd.submit("pairs", (sim.reads1[:4], sim.reads2[:4]),
                     deadline_s=-1.0)     # already expired
    live = fd.submit("pairs", (sim.reads1[4:8], sim.reads2[4:8]))
    fd.drain()
    assert dead.status == EXPIRED and dead.result is None
    assert live.status == DONE
    assert fd.stats.expired == 1 and fd.stats.expired_rows == 4
    assert fd.stats.completed_rows == 4


def test_request_validation(served_world):
    _, mapper, sim, _ = served_world
    fd = _door(mapper)
    with pytest.raises(ValueError, match="unknown lane"):
        fd.submit("nope", (sim.reads1[:1], sim.reads2[:1]))
    with pytest.raises(ValueError, match="read arrays"):
        fd.submit("pairs", (sim.reads1[:1],))
    with pytest.raises(ValueError, match="stream_batch"):
        fd.submit("pairs", (sim.reads1[:B + 1], sim.reads2[:B + 1]))
    with pytest.raises(ValueError, match="row count"):
        fd.submit("pairs", (sim.reads1[:2], sim.reads2[:3]))
    with pytest.raises(ValueError, match="stream_batch"):
        FrontDoor(Mapper.from_index(mapper.index, mapper.ref,
                                    mapper.pipe_cfg,
                                    ExecutionConfig(device="cpu")))


# ---------------------------------------------- preemption drain ---------
def test_sigterm_drains_accepted_requests(served_world):
    """A real SIGTERM, caught by the door's own guard mid-trace: every
    accepted request completes, the rest is shed, and closing the door
    restores the handler it replaced."""
    _, mapper, sim, lreads = served_world
    prev = signal.getsignal(signal.SIGTERM)
    fd = FrontDoor(mapper, FrontDoorConfig(long_every=2))

    def arrivals():
        off = 0
        for n in [6, 16, 5, 3]:
            yield ("pairs", (sim.reads1[off:off + n],
                             sim.reads2[off:off + n]))
            off += n
        os.kill(os.getpid(), signal.SIGTERM)
        yield ("pairs", (sim.reads1[off:off + 2], sim.reads2[off:off + 2]))
        yield ("long", (lreads[:2],))

    with fd:
        report = fd.serve(arrivals())
    assert signal.getsignal(signal.SIGTERM) == prev
    accepted = [r for r in fd.requests if r.status not in (SHED, REJECTED)]
    shed = [r for r in fd.requests if r.status == SHED]
    assert len(accepted) == 4 and all(r.status == DONE for r in accepted)
    assert len(shed) == 2 and report["serve"]["shed"] == 2
    assert report["serve"]["shed_rows"] == 4
    assert report["serve"]["completed"] == 4
    assert report["drained"]
    assert report["serve"]["drain_reason"] == "preemption"
    assert report["stage_totals"]["pairs"]["n_pairs"] == 6 + 16 + 5 + 3


def test_given_guard_is_not_uninstalled(served_world):
    _, mapper, _, _ = served_world
    guard = PreemptionGuard()
    try:
        FrontDoor(mapper, FrontDoorConfig(), guard=guard).close()
        assert signal.getsignal(signal.SIGTERM) == guard._handler
    finally:
        guard.uninstall()


# ------------------------------------------- two-lane scheduling ---------
def test_long_lane_is_starvation_free(served_world):
    _, mapper, sim, lreads = served_world
    fd = _door(mapper, long_every=2)

    def arrivals():
        # a small long request lands early and never fills a batch...
        yield ("long", (lreads[:2],))
        # ...while full pair batches keep the priority lane ready
        for i in range(6):
            off = (i % 4) * B
            yield ("pairs", (sim.reads1[off:off + B],
                             sim.reads2[off:off + B]))

    fd.serve(arrivals())
    long_req = next(r for r in fd.requests if r.lane == "long")
    assert long_req.status == DONE
    pair_after = [r for r in fd.requests if r.lane == "pairs"
                  and r.t_dispatch > long_req.t_dispatch]
    assert len(pair_after) >= 1
    assert fd.stats.batches["long"] == 1


# ------------------------------------------- straggler degrade -----------
def test_degraded_watchdog_shrinks_batches(served_world):
    _, mapper, sim, _ = served_world
    fd = _door(mapper, degrade_factor=0.5)
    fd._watchdogs["pairs"].state = DEGRADED
    assert fd._target("pairs") == B // 2
    for i in range(4):
        fd.submit("pairs", (sim.reads1[4 * i:4 * i + 4],
                            sim.reads2[4 * i:4 * i + 4]))
    n = fd.dispatch_ready()
    fd.drain()
    assert n == 2
    assert fd.stats.batches["pairs"] == 2
    assert fd.stats.batch_rows["pairs"] == 16
    assert fd.stats.degraded_batches == 2
    assert all(r.status == DONE for r in fd.requests)


def test_evict_escalates_to_drain(served_world):
    _, mapper, sim, _ = served_world
    fd = _door(mapper)

    class _Evicting:
        state = DEGRADED

        def observe(self, t):
            return EVICT

    fd._watchdogs["pairs"] = _Evicting()
    fd.submit("pairs", (sim.reads1[:B], sim.reads2[:B]))
    fd.dispatch_ready()
    fd.drain()      # retires the batch -> EVICT -> guard.request()
    assert fd._guard.should_checkpoint()
    assert fd.stats.drain_reason == "watchdog-evict"
    late = fd.submit("pairs", (sim.reads1[:1], sim.reads2[:1]))
    assert late.status == SHED


# ------------------------------------------------------ index reload ----
def test_reload_index_quiesces_one_boundary(served_world, tmp_path):
    """Requests accepted before the swap retire against the old index,
    requests after it serve the new one, and every accepted request
    completes; an unreadable store keeps the index."""
    ref, _, sim, _ = served_world
    cfg = PipelineConfig(residual_capacity_frac=1.0)
    exec_cfg = ExecutionConfig(device="cpu", stream_batch=B)
    ref_b = random_reference(60_000, np.random.default_rng(7))
    m_new = Mapper.build(ref_b, SeedMapConfig(table_bits=TB), cfg, exec_cfg)
    m_new.save(tmp_path / "b")
    m = Mapper.build(ref, SeedMapConfig(table_bits=TB), cfg, exec_cfg)
    r1, r2 = sim.reads1[:B], sim.reads2[:B]
    old_res = m.map(r1, r2)
    new_res = m_new.map(r1, r2)

    fd = _door(m)
    r_pre = fd.submit("pairs", (r1, r2))
    fd.dispatch_ready()                  # in flight against the old index
    assert fd.reload_index(tmp_path / "b") == "reused"
    assert r_pre.status == DONE          # quiesced at the boundary
    r_post = fd.submit("pairs", (r1, r2))
    (tmp_path / "b" / "manifest.json").write_text("{}")
    with pytest.warns(UserWarning, match="keeping"):
        assert fd.reload_index(tmp_path / "b") == "kept"
    fd.drain()
    assert r_post.status == DONE
    _rows_equal(r_pre.result, old_res, B)
    _rows_equal(r_post.result, new_res, B)
    assert fd.stats.accepted == fd.stats.completed == 2
    assert fd.report()["stage_totals"]["pairs"]["n_pairs"] == 2 * B


# ------------------------------------------------ fleet health hooks ----
def test_observe_fleet_degrades_and_drains(served_world):
    _, mapper, sim, _ = served_world
    fd = FrontDoor(mapper, FrontDoorConfig(degrade_factor=0.5,
                                           record_requests=False))
    try:
        assert fd._target("pairs") == B
        fd.observe_fleet([{"host": 0, "state": HEALTHY},
                          {"host": 1, "state": DEGRADED}])
        assert fd._target("pairs") == B // 2
        assert not fd._draining
        fd.observe_fleet([{"host": 0, "state": HEALTHY},
                          {"host": 1, "state": HEALTHY}])
        assert fd._target("pairs") == B
        fd.observe_fleet([{"host": 0, "state": HEALTHY, "draining": True},
                          {"host": 1, "state": HEALTHY}])
        assert fd._draining
        assert fd.stats.drain_reason == "fleet"
        r = fd.submit("pairs", (sim.reads1[:2], sim.reads2[:2]))
        assert r.status == SHED and fd.requests == []
        assert fd.stats.fleet[0]["batches"] >= 1
        assert fd.report()["serve"]["fleet"]["1"]["state"] == HEALTHY
    finally:
        fd.close()


def test_request_drain_sheds(served_world):
    _, mapper, sim, _ = served_world
    fd = FrontDoor(mapper, FrontDoorConfig(record_requests=False))
    try:
        fd.request_drain("requested")
        assert fd.stats.drain_reason == "requested"
        assert fd.submit("pairs",
                         (sim.reads1[:2], sim.reads2[:2])).status == SHED
        report = fd.report()
        assert report["serve"]["drain_reason"] == "requested"
        assert report["drained"]
    finally:
        fd.close()
