"""One run of one cell: set-up, the measured window, the traced window,
the check, and the result line.  Lane-generic: the lane module named by
the cell's traffic file does the lane's work."""
from __future__ import annotations

import sys
import time

from portbench import manifest
from portbench import trace as tracing
from portbench.roofline import work

#: top-level modules the run's process must not hold: JAX and the JAX
#: package (compared whole: ``repro_torch`` is the program, ``repro`` not)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: batches of the traced window (whole cycles of a pool of 4)
TRACE_BATCHES = 32


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _profile(body):
    """Run ``body()`` under torch.profiler with the window span around it
    and reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW_SPAN):
            body()
    return tracing.reduce(prof, work.SYMBOLS)


def _device(device, chips: int, peak: int, red: dict | None) -> dict:
    import torch
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    out = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": chips, "memory_peak_bytes": peak}
    if red is not None:
        out["busy_s"] = red["busy_s"]
        out["window_s"] = red["window_s"]
    return out


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float,
             trace_batches: int = TRACE_BATCHES) -> dict | None:
    """Run ``cell`` once; returns the result line's object, or None where
    the process holds a forbidden module (named on standard error)."""
    import torch

    lane_mod = manifest.lane_module(cell.traffic.get("lane", "pairs"))
    lane = lane_mod.Lane(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lane.setup(log)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    win = lane.window(seconds)
    log(f"window: {win['batches']} batches, {win['pairs']} pairs in "
        f"{win['seconds']:.4f} s; stage totals {win['totals']}")
    log(f"window: batches pulled in each second {win['batches_per_s']}")
    red = None
    if trace:
        red = lane.traced(trace_batches, _profile)
        counts = lane.launch_counts()
        for k, v in red["kernels"].items():
            log(f"trace holds {v['count']} launches of {k} "
                f"({counts.get(k, 'n/a')} launched in the run)")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded once the window closed: {bad}")
        return None
    lane.release_program()
    chk = lane.check(log)

    record = {"setup_s": setup_s,
              "mbp_per_s": win["bases"] / win["seconds"] / 1e6,
              "peak_mem_gib": peak / 2**30}
    run = {"window": win, "trace": red, "bounds": lane.work,
           "record": record}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = m.reader.read(run)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        for m in cell.end_to_end:
            metrics[m.name] = {"value": record[m.spec["record"]],
                               "unit": m.unit}

    compared = {k: {"value": v, "limit": lane_mod.LIMITS[k]}
                for k, v in chk["compared"].items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    out = {"correct": correct, "attempted": win["pairs"],
           "failed": chk["failed"], "metrics": metrics,
           "device": _device(device, cell.chips, peak, red)}
    if red is not None:
        out["breakdown"] = {"device_ops": red["device_ops"],
                            "idle_gaps": red["idle_gaps"]}
    out["compared"] = compared
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return None
    log(f"checked {chk['checked_batches']} batches "
        f"({chk['checked_pairs']} pairs) and the stage totals")
    for k, c in compared.items():
        log(f"compared {k} {c['value']} limit {c['limit']}")
    return out
