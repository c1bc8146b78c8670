"""Straggler-mitigation watchdog.

A single slow step source stalls every request queued behind it.  The
watchdog tracks a robust EMA of step wall-times and drives a small state
machine:

  HEALTHY --(step > slow_factor x ema, `patience` times)--> DEGRADED
  DEGRADED: the caller degrades (the front door shrinks its coalescing
            target, so requests stop waiting for full batches) and keeps
            running.
  DEGRADED --(sustained slowness, `evict_patience` more times)--> EVICT
  EVICT:    the caller gives up on the slow source (the front door
            drains).
  any slow counter resets after `recovery` consecutive healthy steps.

Pure decision logic — no threads, no timers — so it is unit-testable and
the caller stays in control of side effects.
"""
from __future__ import annotations

import dataclasses

HEALTHY, DEGRADED, EVICT = "healthy", "degraded", "evict"


@dataclasses.dataclass
class WatchdogConfig:
    slow_factor: float = 2.0     # step is "slow" if > slow_factor * ema
    patience: int = 3            # slow steps before DEGRADED
    evict_patience: int = 6      # additional slow steps before EVICT
    ema_decay: float = 0.9
    warmup_steps: int = 5        # ignore compile/first-step noise
    recovery: int = 10           # healthy steps to fully reset


#: zero-warmup, hair-trigger config for chaos runs: the very first
#: observation seeds the EMA — the ``warmup_steps=0`` path — and one slow
#: batch is enough to go DEGRADED, while EVICT keeps the default extra
#: patience.
STRAGGLE_DEMO_WATCHDOG = WatchdogConfig(warmup_steps=0, patience=1)


@dataclasses.dataclass
class Watchdog:
    config: WatchdogConfig = dataclasses.field(default_factory=WatchdogConfig)
    ema: float | None = None
    n_seen: int = 0
    slow_streak: int = 0
    healthy_streak: int = 0
    state: str = HEALTHY

    def observe(self, step_time_s: float) -> str:
        """Feed one step time; returns the (possibly new) state."""
        cfg = self.config
        self.n_seen += 1
        if self.n_seen <= cfg.warmup_steps:
            # warmup: build the EMA but never trigger
            self._fold(step_time_s)
            return self.state
        if self.ema is None:
            # warmup_steps=0: no EMA folded yet.  Seed it from the first
            # sample — a lone sample has no baseline to be slow against.
            self._fold(step_time_s)
            return self.state
        slow = step_time_s > cfg.slow_factor * self.ema
        if slow:
            self.slow_streak += 1
            self.healthy_streak = 0
        else:
            self.healthy_streak += 1
            if self.healthy_streak >= cfg.recovery:
                self.slow_streak = 0
                self.state = HEALTHY
            # slow EMA only folds healthy steps so stragglers don't
            # poison the baseline
            self._fold(step_time_s)
        if self.slow_streak >= cfg.patience + cfg.evict_patience:
            self.state = EVICT
        elif self.slow_streak >= cfg.patience:
            self.state = DEGRADED
        return self.state

    def _fold(self, t: float) -> None:
        d = self.config.ema_decay
        self.ema = t if self.ema is None else d * self.ema + (1 - d) * t
