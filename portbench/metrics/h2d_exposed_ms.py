"""How long the compute stream stalled on its batch's H2D copies in the
measured window: the mean of S - R, where R is recorded on the compute
stream just before it waits for the batch's copies (on the copy stream)
and S just after, in ms.  Near 0 the copy is hidden behind the step
before it; near ``h2d_device_ms`` it runs in line.  A program whose
markers lack it (the copy on the compute stream) gives None."""
from portbench.spans import window_markers


def read(run):
    m = window_markers(run)
    return None if m is None else m.get("h2d_exposed_ms")
