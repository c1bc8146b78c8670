"""Reduce a torch.profiler trace of the traced window to what the
per-layer metrics and the ``breakdown`` read.

The window is marked by a ``record_function`` span, so its start and end
are in the trace's own clock.  Device activity is every event the trace
holds on the card (kernels, copies, sets), merged into busy intervals and
clipped to the window.  An idle gap is named after the innermost host
event that was running at its middle: the operator, runtime call or
annotation the host was in while the card waited.
"""
from __future__ import annotations

import re
from collections import defaultdict

WINDOW_SPAN = "portbench.window"
_NAME_CHARS = 80


def _short(name: str) -> str:
    return name if len(name) <= _NAME_CHARS else name[:_NAME_CHARS]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(prof, symbols: dict) -> dict:
    """``prof``: a finished ``torch.profiler.profile`` around the window.
    ``symbols``: kernel -> device symbol whose launches to total.

    Returns busy_s, window_s, the totals of each named kernel
    ({kernel: {"seconds", "count"}}), and the top device operations and
    idle gaps (at most 10 each, seconds as measured)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    device, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.is_user_annotation() or e.name() == WINDOW_SPAN:
            continue       # the window's span and its mirror on the card
        if e.device_type() == DeviceType.CUDA:
            device.append((s, s + d, e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in device
                   if e > w0 and s < w1])
    busy_ns = sum(e - s for s, e in busy)

    by_name = defaultdict(float)
    for s, e, name in device:
        by_name[name] += (e - s) / 1e9
    patterns = {k: re.compile(rf"\b{re.escape(sym)}\b")
                for k, sym in symbols.items()}
    kernels = {k: {"seconds": 0.0, "count": 0} for k in symbols}
    for s, e, name in device:
        for k, pat in patterns.items():
            if pat.search(name):
                kernels[k]["seconds"] += (e - s) / 1e9
                kernels[k]["count"] += 1

    # idle gaps inside the window, named by the innermost host event
    gaps = []
    edge = w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    host.sort()
    by_host = defaultdict(float)
    live, nxt = [], 0          # host events begun before the gap's middle
    for g0, g1 in gaps:        # in time order
        mid = (g0 + g1) // 2
        while nxt < len(host) and host[nxt][0] <= mid:
            live.append(host[nxt])
            nxt += 1
        live = [h for h in live if h[1] >= mid]
        inner = min(live, key=lambda h: h[1] - h[0], default=None)
        by_host["host outside any traced op" if inner is None
                else _short(inner[2])] += (g1 - g0) / 1e9

    def top(d):
        return [[_short(n), v] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": kernels, "device_ops": top(by_name),
            "idle_gaps": top(by_host)}
