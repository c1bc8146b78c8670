"""The program's own summary of the measured window's stream: the newest
of ``repro_torch.engine.spans.recent()`` that ran without the profiler
and holds as many batches as the window, i.e. the untraced window of the
same run (the traced window runs under the profiler; the warm-up stream
is shorter).  A program without that module, or a window without device
markers (the CPU), gives None."""
from __future__ import annotations


def window_markers(run: dict) -> dict | None:
    """The measured window's device markers (``launch_queue_ms``,
    ``h2d_device_ms``, ``step_device_ms``, ...), or None."""
    try:
        from repro_torch.engine import spans
    except ImportError:
        return None
    w = run.get("window")
    if not w:
        return None
    for s in reversed(spans.recent()):
        if not s["profiled"] and s["batches"] == w["batches"]:
            m = s["markers"]
            return m if m and m["batches"] else None
    return None
