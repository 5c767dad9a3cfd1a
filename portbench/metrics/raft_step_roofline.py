"""Percent of the raft step kernel's memory roofline
(``csrc/raft_step.cu``): ``roofline/raft_step.py``'s bytes a round over
its device time a round."""
from portbench.metrics._roofline import share_pct


def read(ctx):
    return share_pct(ctx, "raft_step")
