"""The card's busy time in the traced window (the union of its kernels,
copies and sets) over the window's batches, in ms a batch."""


def read(run):
    t = run.get("trace")
    if not t or t["busy_s"] <= 0 or not t.get("batches"):
        return None
    return 1e3 * t["busy_s"] / t["batches"]
