"""Host-side fault tolerance for serving: the straggler watchdog, the
SIGTERM preemption guard and the deterministic chaos schedule."""
from repro_torch.runtime.faultinject import ChaosSpec, Fault, inject
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.runtime.watchdog import (
    DEGRADED, EVICT, HEALTHY, Watchdog, WatchdogConfig,
)

__all__ = [
    "ChaosSpec", "DEGRADED", "EVICT", "Fault", "HEALTHY",
    "PreemptionGuard", "Watchdog", "WatchdogConfig", "inject",
]
