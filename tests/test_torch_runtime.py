"""repro_torch's host-side serving runtime against repro's: the watchdog's
state sequences over the same step times, the chaos grammar and
injector, the SIGTERM preemption guard, and the `ServeStats` ledger."""
import dataclasses
import signal
import time

import numpy as np
import pytest

from repro.engine.stats import ServeStats as JServeStats
from repro.engine.stats import _percentiles as j_percentiles
from repro.runtime import ChaosSpec as JChaosSpec
from repro.runtime import inject as j_inject
from repro.runtime.watchdog import STRAGGLE_DEMO_WATCHDOG as J_DEMO
from repro.runtime.watchdog import Watchdog as JWatchdog
from repro.runtime.watchdog import WatchdogConfig as JWatchdogConfig
from repro_torch.engine.stats import ServeStats, _percentiles
from repro_torch.runtime import (
    DEGRADED,
    EVICT,
    HEALTHY,
    ChaosSpec,
    Fault,
    PreemptionGuard,
    Watchdog,
    WatchdogConfig,
    inject,
)
from repro_torch.runtime.faultinject import TORN_KEY, torn_item
from repro_torch.runtime.watchdog import STRAGGLE_DEMO_WATCHDOG


def _step_times(seed, n=120):
    """Steady steps with bursts of stragglers and recoveries."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.9e-3, 1.1e-3, n)
    for start in rng.integers(0, n - 12, 4):
        t[start:start + rng.integers(2, 12)] *= rng.uniform(2.5, 6.0)
    return t.tolist()


@pytest.mark.parametrize("cfg", [
    {}, dict(warmup_steps=0, patience=1), dict(patience=2, evict_patience=3,
                                               recovery=4),
    dict(slow_factor=1.5, ema_decay=0.5, warmup_steps=2)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watchdog_state_sequence_matches_repro(cfg, seed):
    dog, jdog = Watchdog(WatchdogConfig(**cfg)), JWatchdog(
        JWatchdogConfig(**cfg))
    times = _step_times(seed)
    got = [dog.observe(t) for t in times]
    want = [jdog.observe(t) for t in times]
    assert got == want
    assert (dog.ema, dog.slow_streak, dog.healthy_streak) == (
        jdog.ema, jdog.slow_streak, jdog.healthy_streak)


def test_watchdog_reaches_every_state():
    dog = Watchdog(STRAGGLE_DEMO_WATCHDOG)
    assert dataclasses.asdict(STRAGGLE_DEMO_WATCHDOG) == \
        dataclasses.asdict(J_DEMO)
    states = [dog.observe(t) for t in [1.0] + [5.0] * 7 + [1.0] * 10]
    assert states[0] == HEALTHY and states[1] == DEGRADED
    assert EVICT in states and states[-1] == HEALTHY


def test_chaos_spec_parse_roundtrip_matches_repro():
    s = "dry@1:2,sigterm@0:3,straggle@1:1:0.05,torn@0:2"
    spec, jspec = ChaosSpec.parse(s), JChaosSpec.parse(s)
    assert str(spec) == str(jspec) == s
    assert [dataclasses.asdict(f) for f in spec.faults] == \
        [dataclasses.asdict(f) for f in jspec.faults]
    assert spec.for_host(1) == (spec.faults[0], spec.faults[2])
    assert spec.for_host(7) == ()


@pytest.mark.parametrize("bad", ["dry", "dry@x:1", "dry@0", "boom@0:1",
                                 "straggle@0:1", "dry@-1:0"])
def test_chaos_spec_rejects_bad_terms(bad):
    with pytest.raises(ValueError,
                       match="chaos term|straggle fault|fault kind|>= 0"):
        ChaosSpec.parse(bad)
    with pytest.raises(ValueError):
        JChaosSpec.parse(bad)


def _items(n):
    return [(np.full((2, 4), i, np.uint8),
             np.full((2, 4), 10 + i, np.uint8)) for i in range(n)]


def _same_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(u, dict):
                assert u == v
            else:
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("spec", ["dry@0:2", "dry@1:2", "torn@0:1",
                                  "torn@0:1,dry@0:3"])
def test_inject_dry_and_torn_match_repro(spec):
    got = list(inject(iter(_items(5)), ChaosSpec.parse(spec), host=0))
    want = list(j_inject(iter(_items(5)), JChaosSpec.parse(spec), host=0))
    _same_items(got, want)
    if spec.startswith("torn"):
        assert got[1][2] == {TORN_KEY: 0}
    assert torn_item(_items(1)[0])[2] == {TORN_KEY: 0}


def test_inject_straggle_sleeps_from_at():
    t0 = time.time()
    got = list(inject(iter(_items(3)),
                      ChaosSpec.parse("straggle@0:1:0.05"), host=0))
    assert len(got) == 3
    assert time.time() - t0 >= 0.1    # batches 1 and 2 each slept


def test_inject_sigterm_sets_guard_not_stop():
    guard = PreemptionGuard()
    try:
        got = list(inject(iter(_items(3)),
                          ChaosSpec.parse("sigterm@0:1"), host=0))
        # the wrapper keeps yielding: reacting is the consumer's job
        assert len(got) == 3
        assert guard.should_checkpoint()
    finally:
        guard.uninstall()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_preemption_guard_uninstall_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    assert signal.getsignal(signal.SIGTERM) == guard._handler
    assert not guard.should_checkpoint()
    guard.request()
    assert guard.should_checkpoint()
    guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_fault_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("boom", 0, 0)
    with pytest.raises(ValueError, match="delay_s > 0"):
        Fault("straggle", 0, 0)


def test_serve_stats_ledger_matches_repro():
    st, jst = ServeStats(), JServeStats()
    rng = np.random.default_rng(3)
    for s in (st, jst):
        s.count("accepted", 5)
        s.count("rejected", 2)
        s.count("shed", 1)
        s.count("expired", 4)
        s.observe_batch("pairs", 12)
        s.observe_batch("pairs", 3, degraded=True)
        s.observe_batch("long", 7)
        s.observe_host(0, have=True, state=HEALTHY, draining=False)
        s.observe_host(1, have=False, state=DEGRADED, draining=True)
        s.observe_host(1, have=False, state=DEGRADED, draining=False,
                       error=True)
        s.mark_drain("fleet")
        s.mark_drain("preemption")             # the first cause sticks
    for _ in range(9):
        t = sorted(rng.uniform(0, 1, 3))
        for s in (st, jst):
            s.observe_request(rows=2, t_enqueue=t[0], t_dispatch=t[1],
                              t_result=t[2])
    assert st.ledger(capacity=16) == jst.ledger(capacity=16)
    assert st.ledger()["drain_reason"] == "fleet"
    assert _percentiles([]) == j_percentiles([])
    assert _percentiles(st.total_s, (10, 50, 90)) == \
        j_percentiles(jst.total_s, (10, 50, 90))
