"""Frozen roofline formulas and peaks (`work`), and the share the
per-layer metrics report."""
from __future__ import annotations


def share_pct(run: dict, kernels: tuple) -> float | None:
    """100 x the kernels' summed bound a launch over their summed mean
    device time a launch in the traced window; None where the run holds no
    trace, no bound or no traced launch of one of them."""
    trace, bounds = run.get("trace"), run.get("bounds")
    if not trace or not bounds:
        return None
    bound = mean = 0.0
    for k in kernels:
        launches = trace["kernels"].get(k)
        if k not in bounds or not launches or launches["count"] == 0:
            return None
        bound += bounds[k]
        mean += launches["seconds"] / launches["count"]
    return 100.0 * bound / mean if mean > 0 else None
