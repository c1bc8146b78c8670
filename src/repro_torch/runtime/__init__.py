"""Host-side fault tolerance: the straggler watchdog, the SIGTERM
preemption guard, the deterministic chaos schedule and elastic
re-meshing."""
from repro_torch.runtime.elastic import RemeshPlan, build_mesh, plan_remesh
from repro_torch.runtime.faultinject import ChaosSpec, Fault, inject
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.runtime.watchdog import (
    DEGRADED, EVICT, HEALTHY, Watchdog, WatchdogConfig,
)

__all__ = [
    "ChaosSpec", "DEGRADED", "EVICT", "Fault", "HEALTHY",
    "PreemptionGuard", "RemeshPlan", "Watchdog", "WatchdogConfig",
    "build_mesh", "inject", "plan_remesh",
]
