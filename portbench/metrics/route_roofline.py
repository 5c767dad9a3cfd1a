"""Percent of the route kernels' memory roofline (``csrc/route.cu``, the
walk and the receive kernels): ``roofline/route.py``'s bytes a round
over their device time a round."""
from portbench.metrics._roofline import share_pct


def read(ctx):
    return share_pct(ctx, "route")
