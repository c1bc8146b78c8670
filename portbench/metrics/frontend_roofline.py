"""The front-end kernels' share of their roofline (seed_buckets and
pair_frontend, bound by HBM bytes at the published 3.35 TB/s): the sum of
their frozen bounds a launch over the sum of their mean device times a
launch in the traced window, in %."""
from portbench.roofline import share_pct


def read(run):
    return share_pct(run, ("seed_buckets", "pair_frontend"))
