"""How long ``map_stream`` keeps the host between two pulls of the
measured window's generator (padding, pinning, enqueueing the copies,
the pair step's launches), in ms a batch: the window's total over the
intervals it timed."""


def read(run):
    w = run.get("window")
    if not w or not w["host_intervals"]:
        return None
    return 1e3 * w["host_s"] / w["host_intervals"]
