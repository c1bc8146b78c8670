"""The card's time from marker M1 to M2 (the pair step: its kernels and the
eager glue between them) in the measured window, the mean over its
batches, in ms."""
from portbench.spans import window_markers


def read(run):
    m = window_markers(run)
    return None if m is None else m["step_device_ms"]
