"""Native kernel launches a consensus round enqueues: the count of the
program's ``launch.<entry>`` spans over a ``--trace 1`` window's rounds
(``raft_step``, ``merge_escalated`` and ``route`` today: 3).  A CUDA
graph or a fused kernel moves it."""
from portbench.metrics._dispatch import launches_per_round


def read(ctx):
    return launches_per_round(ctx)
