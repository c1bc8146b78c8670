"""Light alignment's share of its roofline (candidate_align, bound by its
int32 operations at the derived 16.7 Tops/s): its frozen bound a launch
over its mean device time a launch in the traced window, in %."""
from portbench.roofline import share_pct


def read(run):
    return share_pct(run, ("candidate_align",))
