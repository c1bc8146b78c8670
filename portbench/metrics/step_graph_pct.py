"""The share of the measured window's pair steps that the program replayed
from a CUDA graph instead of launching op by op, in %: 100 x
``graph_replays`` / ``batches`` of the program's own summary of the
untraced window (the newest of ``repro_torch.engine.spans.recent()`` that
ran without the profiler and holds as many batches as the window).  None
where the program keeps no such counter, off the card (the summary holds
no device markers) and on the long lane (its summary counts
pseudo-pairs): no graph serves either."""


def read(run):
    try:
        from repro_torch.engine import spans
    except ImportError:
        return None
    w = run.get("window")
    if not w or not w["batches"]:
        return None
    for s in reversed(spans.recent()):
        if not s["profiled"] and s["batches"] == w["batches"]:
            if "graph_replays" not in s or s["markers"] is None \
                    or s["pseudo_pairs"]:
                return None
            return 100.0 * s["graph_replays"] / s["batches"]
    return None
