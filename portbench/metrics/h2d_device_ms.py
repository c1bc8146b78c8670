"""The card's time from marker M0 to M1 (the batch's H2D copies of its
reads, on the compute stream) in the measured window, the mean over its
batches, in ms."""
from portbench.spans import window_markers


def read(run):
    m = window_markers(run)
    return None if m is None else m["h2d_device_ms"]
