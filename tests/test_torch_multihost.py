"""repro_torch's fleet stream (`engine.multihost.map_stream`) against
repro's single-device results on the CPU, exact equality.

Two gloo processes (this file's ``__main__``, one CPU rank a host) stream
disjoint per-host slices of a 29-pair pool under the chaos scenarios of
repro's two-process suite (`runtime.faultinject`): every accepted round's
global result equals repro's single-device map of the same global rows
(computed here and saved as ``.npz``), the totals equal the masked
reference's, and the health ledger is the scenario's.  In this process:
the one-host path equals `Mapper.map_stream`, the host-side keep-alive
source, `door_health`, and the serve CLI's ``--chaos`` / ``--health-out``
against repro's, with repro's refusals.

    python tests/test_torch_multihost.py NPZ RANK WORLD INIT_FILE
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.serve as jserve
from repro.core import PipelineConfig as JPipelineConfig
from repro.core import SeedMapConfig as JSeedMapConfig
from repro.core import build_seedmap as j_build_seedmap
from repro.core import stage_stat_counts as j_stage_stat_counts
from repro.engine import ExecutionConfig as JExecutionConfig
from repro.engine import Mapper as JMapper
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import SeedMapConfig, build_seedmap
from repro_torch.core.simulate import (
    ReadSimConfig,
    random_reference,
    simulate_pairs,
)
from repro_torch.engine import ExecutionConfig, FrontDoor, Mapper
from repro_torch.engine import multihost
from repro_torch.engine.stats import ServeStats
from repro_torch.launch import serve as tserve
from repro_torch.runtime import ChaosSpec, PreemptionGuard, inject
from repro_torch.runtime.watchdog import DEGRADED, HEALTHY, WatchdogConfig

REF_LEN, TB, POOL = 60_000, 15, 29
LOCAL_B = 4                  # a host's rows; the global batch is 8
WORKER_TIMEOUT = 240         # seconds for both ranks, every scenario

#: repro's two-process scenarios (tests/_multihost_worker.py): each host's
#: batch slices of the pool, the chaos spec, guard and watchdog, and the
#: protocol's outcome: ``rounds`` lists each round carrying real data as
#: {host: (lo, hi)} (a missing host keeps alive), ``n_rounds`` counts the
#: all-padding consensus round(s), ``keepalive`` is each host's padded
#: rounds and ``drain`` its drain reason.
SCENARIOS = {
    "base": dict(
        slices={0: [(0, 4), (4, 8)], 1: [(8, 12), (12, 15)]},
        chaos=None, guard=False, watchdog=False,
        rounds=[{0: (0, 4), 1: (8, 12)}, {0: (4, 8), 1: (12, 15)}],
        n_rounds=3, n_pairs=15,
        drain={0: None, 1: None}, keepalive={0: 1, 1: 1}, error_host=None),
    "dry": dict(
        slices={0: [(0, 4), (4, 8), (8, 12)], 1: [(12, 16), (16, 20)]},
        chaos="dry@1:1", guard=False, watchdog=False,
        rounds=[{0: (0, 4), 1: (12, 16)}, {0: (4, 8)}, {0: (8, 12)}],
        n_rounds=4, n_pairs=16,
        drain={0: None, 1: None}, keepalive={0: 1, 1: 3}, error_host=None),
    "sigterm": dict(
        slices={0: [(0, 4), (4, 8), (8, 12), (12, 16)],
                1: [(16, 20), (20, 24), (24, 28), (28, 29)]},
        chaos="sigterm@0:1", guard=True, watchdog=False,
        # host 0 is preempted while pulling batch 1, which still lands;
        # host 1 pulls batch 2 before it reads the drain (one-round lag)
        rounds=[{0: (0, 4), 1: (16, 20)}, {0: (4, 8), 1: (20, 24)},
                {1: (24, 28)}],
        n_rounds=4, n_pairs=20,
        drain={0: "preemption", 1: "fleet"}, keepalive={0: 2, 1: 1},
        error_host=None),
    "straggle": dict(
        slices={0: [(0, 4), (4, 8)], 1: [(8, 12), (12, 15)]},
        chaos="straggle@1:1:0.05", guard=False, watchdog=True,
        rounds=[{0: (0, 4), 1: (8, 12)}, {0: (4, 8), 1: (12, 15)}],
        n_rounds=3, n_pairs=15,
        drain={0: None, 1: None}, keepalive={0: 1, 1: 1}, error_host=None),
    "torn": dict(
        slices={0: [(0, 4), (4, 8), (8, 12)],
                1: [(12, 16), (16, 20), (20, 24)]},
        chaos="torn@1:1", guard=False, watchdog=False,
        rounds=[{0: (0, 4), 1: (12, 16)}, {0: (4, 8)}, {0: (8, 12)}],
        n_rounds=4, n_pairs=16,
        drain={0: "fleet", 1: "error"}, keepalive={0: 1, 1: 3},
        error_host=1),
}

#: the serve CLI's keys that are times or rates
TIMING = {"pairs_per_s", "mbp_per_s", "index_build_s"}
TINY = dict(ref_len=REF_LEN, batch=16, batches=3, table_bits=TB,
            verbose=False)


def _pool():
    ref = random_reference(REF_LEN, np.random.default_rng(0))
    return ref, simulate_pairs(ref, POOL, ReadSimConfig(sub_rate=2e-3),
                               seed=1)


def _round_rows(sim, spec):
    """The global (2 * LOCAL_B) reads and validity mask of one round: host
    0's half then host 1's, each padded with zero reads; a keep-alive half
    is all zeros and all invalid."""
    L = sim.reads1.shape[1]
    r1, r2, mask = [], [], []
    for h in (0, 1):
        lo, hi = spec.get(h, (0, 0))
        pad = np.zeros((LOCAL_B - (hi - lo), L), np.uint8)
        r1.append(np.concatenate([sim.reads1[lo:hi], pad]))
        r2.append(np.concatenate([sim.reads2[lo:hi], pad]))
        mask.append(np.arange(LOCAL_B) < hi - lo)
    return np.concatenate(r1), np.concatenate(r2), np.concatenate(mask)


@pytest.fixture(scope="module")
def world():
    ref, sim = _pool()
    jsm = j_build_seedmap(ref, JSeedMapConfig(table_bits=TB))
    return ref, sim, jsm


# ------------------------------------------------- two gloo processes ----
@pytest.fixture(scope="module")
def fleet(world, tmp_path_factory):
    """Both hosts' output of every scenario: repro's single-device map of
    each accepted round's global rows saved as ``.npz``, then one run of
    two gloo ranks (this file's ``__main__``) over all the scenarios."""
    ref, sim, jsm = world
    jm = JMapper.from_index(jsm, ref, JPipelineConfig(),
                            JExecutionConfig(backend="jnp"))
    arrays = {}
    for name, scen in SCENARIOS.items():
        totals = None
        for k, spec in enumerate(scen["rounds"]):
            r1, r2, mask = _round_rows(sim, spec)
            res = jm.map(r1, r2)
            arrays.update({f"{name}.{k}.{f}": np.asarray(getattr(res, f))
                           for f in res._fields if f != "n_valid"})
            arrays[f"{name}.{k}.n_valid"] = mask
            counts = {key: int(v) for key, v in j_stage_stat_counts(
                res._replace(n_valid=mask)).items()}
            totals = counts if totals is None else {
                key: totals[key] + counts[key] for key in counts}
        arrays[f"{name}.totals"] = np.array(json.dumps(totals))
    tmp = tmp_path_factory.mktemp("fleet")
    npz = tmp / "want.npz"
    np.savez(npz, **arrays)
    env = {**os.environ,
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), os.pardir,
                                      "src")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(npz), str(rank), "2",
         str(tmp / "store")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_two_host_stream_matches_repro(fleet, scenario):
    """Each host's scenario: a clean stop at the same round, every
    accepted round and the totals equal to repro's, the health ledger."""
    report = "\n".join(f"-- rank {r} (rc {rc})\n{o}"
                       for r, (rc, o) in enumerate(fleet))
    for rc, out in fleet:
        lines = out.splitlines()
        assert sum(ln.startswith(f"ok: [{scenario}]") for ln in lines) == 3, \
            report
        assert f"ok: done {scenario}" in lines, report
    assert all(rc == 0 for rc, _ in fleet), report


def _run_scenario(data, mapper, sim, rank, scenario) -> None:
    """One host's run of one scenario (see `fleet`)."""
    scen = SCENARIOS[scenario]

    def batches():
        for lo, hi in scen["slices"][rank]:
            yield sim.reads1[lo:hi], sim.reads2[lo:hi]

    src = batches()
    if scen["chaos"] is not None:
        src = inject(src, ChaosSpec.parse(scen["chaos"]), host=rank)
    guard = PreemptionGuard() if scen["guard"] else None
    watchdog = (WatchdogConfig(warmup_steps=0, patience=1)
                if scen["watchdog"] else None)
    seen = {}
    err = None
    try:
        sr = multihost.map_stream(
            mapper, src, guard=guard, watchdog=watchdog,
            on_result=lambda i, res, mask: seen.__setitem__(i, res))
    except ValueError as e:
        assert "aux pytree structure" in str(e), e
        sr, err = e.stream_result, e
    finally:
        if guard is not None:
            guard.uninstall()
    assert (err is not None) == (scen["error_host"] == rank), err
    print(f"ok: [{scenario}] rank {rank} stopped after {sr.n_batches} "
          f"rounds")

    for k in range(len(scen["rounds"])):
        for f in seen[k]._fields:
            np.testing.assert_array_equal(
                getattr(seen[k], f).numpy(), data[f"{scenario}.{k}.{f}"],
                err_msg=f"{scenario} round {k} {f} rank {rank}")
    for k in range(len(scen["rounds"]), sr.n_batches):
        assert not seen[k].n_valid.any(), (scenario, k)
    assert sr.totals == json.loads(str(data[f"{scenario}.totals"])), \
        sr.totals
    assert sr.n_pairs == scen["n_pairs"], sr.n_pairs
    assert sr.n_batches == scen["n_rounds"], sr.n_batches
    print(f"ok: [{scenario}] rank {rank} accepted rounds and totals == "
          f"repro")

    h = sr.health
    assert h["n_hosts"] == 2 and h["host"] == rank, h
    assert h["rounds"] == scen["n_rounds"], h
    assert h["keepalive_rounds"] == scen["keepalive"][rank], h
    assert h["drain_reason"] == scen["drain"][rank], h
    assert len(h["ctrl_log"]) == scen["n_rounds"], h["ctrl_log"]
    for host in (0, 1):
        rec = h["per_host"][str(host)]
        assert rec["keepalive"] == scen["keepalive"][host], (host, rec)
        assert rec["batches"] == \
            scen["n_rounds"] - scen["keepalive"][host], (host, rec)
    if scenario == "straggle":
        assert h["per_host"]["1"]["state"] == DEGRADED, h["per_host"]
        assert rank == 0 or h["watchdog"] == DEGRADED, h
    if scenario == "sigterm":
        assert h["per_host"]["0"]["draining"], h["per_host"]
    if scenario == "torn":
        assert h["per_host"]["1"]["error"], h["per_host"]
        assert rank == 0 or h["error"] is not None, h
    json.dumps(h)
    print(f"ok: [{scenario}] rank {rank} health ledger matches")


def _worker(npz, rank: int, world_size: int, store: str) -> None:
    """One host of the two-host check: every scenario in turn on one
    process group and one session."""
    import traceback

    from repro_torch.launch.mesh import make_mesh

    data = np.load(npz)
    ref, sim = _pool()
    sm = build_seedmap(ref, SeedMapConfig(table_bits=TB))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    try:
        mesh = make_mesh((world_size,), ("data",), device_type="cpu")
        mapper = Mapper.from_index(sm, ref, PipelineConfig(), ExecutionConfig(
            device="cpu", mesh=mesh, stream_batch=world_size * LOCAL_B))
        for scenario in sorted(SCENARIOS):
            try:
                _run_scenario(data, mapper, sim, rank, scenario)
            except AssertionError:
                print(f"FAILED [{scenario}]\n{traceback.format_exc()}")
            else:
                print(f"ok: done {scenario}")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- one host ----
def _cpu_session(ref, sm, stream_batch=None):
    return Mapper.from_index(sm, ref, PipelineConfig(), ExecutionConfig(
        device="cpu", stream_batch=stream_batch))


def _slices(sim, bounds):
    return [(sim.reads1[lo:hi], sim.reads2[lo:hi]) for lo, hi in bounds]


def test_one_host_stream_is_map_stream(world):
    """No process group: `multihost.map_stream` is `Mapper.map_stream`,
    and with a guard or a watchdog it drains between batches and reports
    a one-host ledger."""
    ref, sim, _ = world
    mapper = _cpu_session(ref, build_seedmap(ref, SeedMapConfig(
        table_bits=TB)), stream_batch=8)
    bounds = [(0, 8), (8, 16), (16, 24), (24, 29)]
    assert multihost.process_count() == 1 and multihost.is_coordinator()
    want = mapper.map_stream(_slices(sim, bounds))
    seen = []
    got = multihost.map_stream(mapper, _slices(sim, bounds),
                               on_result=lambda i, r, n: seen.append(r))
    assert got.totals == want.totals and got.n_pairs == POOL
    assert got.health is None and len(seen) == 4
    guard = PreemptionGuard()
    try:
        guard.request()
        stats = ServeStats()
        drained = multihost.map_stream(mapper, _slices(sim, bounds),
                                       guard=guard, serve_stats=stats)
    finally:
        guard.uninstall()
    assert drained.n_batches == 0 and stats.drain_reason == "preemption"
    h = drained.health
    assert (h["n_hosts"], h["keepalive_rounds"], h["ctrl_log"]) == (1, 0, [])
    ok = multihost.map_stream(mapper, _slices(sim, bounds),
                              watchdog=WatchdogConfig())
    assert ok.totals == want.totals and ok.health["watchdog"] == HEALTHY
    assert ok.health["rounds"] == 4 and not ok.health["drained"]


def test_one_host_sigterm_drains_after_the_pulled_batch(world):
    """A SIGTERM while batch 2 is pulled: that batch lands, the stream
    drains, and every accepted batch equals `map_stream` of the prefix."""
    ref, sim, _ = world
    mapper = _cpu_session(ref, build_seedmap(ref, SeedMapConfig(
        table_bits=TB)), stream_batch=8)
    bounds = [(0, 8), (8, 16), (16, 24), (24, 29)]
    want = []
    mapper.map_stream(_slices(sim, bounds[:3]),
                      on_result=lambda i, r, n: want.append(r))
    guard = PreemptionGuard()
    got = []
    try:
        sr = multihost.map_stream(
            mapper, inject(_slices(sim, bounds), ChaosSpec.parse(
                "sigterm@0:2"), host=0), guard=guard,
            on_result=lambda i, r, n: got.append(r))
    finally:
        guard.uninstall()
    assert sr.n_batches == 3 and sr.n_pairs == 24
    assert sr.health["drain_reason"] == "preemption"
    for a, b in zip(got, want, strict=True):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_host_source_flags():
    """The keep-alive source's permanent flags and control words."""
    src = multihost._HostSource(it=iter([1, 2]))
    assert src.pull() == 1 and not src.idle
    assert src.ctrl_word(True).tolist() == [1, 0, 0, 0]
    assert src.pull() == 2
    assert src.pull() is None and src.exhausted and src.idle

    def boom():
        yield 1
        raise RuntimeError("disk")

    src = multihost._HostSource(it=boom())
    src.pull()
    assert src.pull() is None and src.draining
    assert isinstance(src.error, RuntimeError)
    assert src.stats.drain_reason == "error"
    assert src.ctrl_word(False).tolist() == [0, 0, 1, 1]
    src = multihost._HostSource(it=iter([1]))
    src.drain_for_fleet()
    assert src.pull() is None and src.stats.drain_reason == "fleet"
    with pytest.raises(ValueError, match="host 1: batch 3 has 9 rows"):
        multihost.check_local_rows(1, 3, 9, 8)


def test_fleet_target_and_door_health(world):
    """`fleet_batch_target` as repro's; `door_health` folds a round into a
    front door: a degraded peer halves its target, a draining one drains
    it."""
    assert multihost.fleet_batch_target([HEALTHY, HEALTHY], 16) == 16
    assert multihost.fleet_batch_target([HEALTHY, DEGRADED], 16) == 8
    assert multihost.fleet_batch_target([DEGRADED], 1) == 1
    ref, sim, _ = world
    mapper = _cpu_session(ref, build_seedmap(ref, SeedMapConfig(
        table_bits=TB)), stream_batch=16)
    fd = FrontDoor(mapper)
    try:
        on_health = multihost.door_health(fd)
        on_health(0, [{"host": 0, "state": HEALTHY},
                      {"host": 1, "state": DEGRADED}])
        assert fd._target("pairs") == 8
        assert fd.stats.fleet[1]["state"] == DEGRADED
        on_health(1, [{"host": 0, "state": HEALTHY},
                      {"host": 1, "state": HEALTHY, "draining": True}])
        assert fd._target("pairs") == 16
        assert fd.stats.drain_reason == "fleet"
    finally:
        fd.close()


# --------------------------------------------------------- serve CLI ----
@pytest.mark.parametrize("chaos", ["sigterm@0:1", "dry@0:2"])
def test_serve_chaos_matches_repro(chaos, tmp_path):
    """``serve --chaos`` through the fleet stream: every key that is not a
    time equals repro's, the health ledger included; ``--health-out``
    writes that ledger."""
    got = tserve.serve(chaos=chaos, device="cpu", **TINY)
    want = jserve.serve(chaos=chaos, **TINY)
    assert set(got) == set(want)
    for k in set(want) - TIMING:
        assert got[k] == want[k], k
    assert got["health"]["drained"] == chaos.startswith("sigterm")
    out = tmp_path / "h" / "health.json"
    tserve.main(["--chaos", chaos, "--device", "cpu", "--ref-len",
                 str(REF_LEN), "--batch", "16", "--batches", "3",
                 "--table-bits", str(TB), "--health-out", str(out)])
    assert json.loads(out.read_text()) == want["health"]


@pytest.mark.parametrize("argv,match", [
    (["--loop", "frontdoor"], "composes with --loop stream"),
    (["--workload", "long"], "pairs stream loop only"),
])
def test_serve_chaos_refusals_match_repro(argv, match, monkeypatch):
    """repro's own refusals: --chaos with the front door or the long
    lane (and the legacy loop) exits before any work."""
    args = ["--chaos", "dry@0:1", *argv]
    with pytest.raises(SystemExit, match=match):
        tserve.main([*args, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    with pytest.raises(SystemExit, match=match):
        jserve.main()
    with pytest.raises(ValueError, match="legacy loop has no drain path"):
        tserve.serve(loop="legacy", chaos="dry@0:1", device="cpu", **TINY)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
