"""How long each batch's first command (marker M0, before its reads'
copies) waited in the card's queue in the measured window: the mean of
d(M0) - h(M0), the card's clock placed on the host's by the stream's
anchor event, in ms.  Near 0 the host sets the pace; many batches' time,
the card does."""
from portbench.spans import window_markers


def read(run):
    m = window_markers(run)
    return None if m is None else m["launch_queue_ms"]
