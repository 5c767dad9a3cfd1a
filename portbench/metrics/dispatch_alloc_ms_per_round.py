"""Host milliseconds a consensus round spends allocating the fused
wave's outputs: the program's ``*.alloc`` spans (``raft_step``'s new
state and outbox views, the route's inbox and workspace views), summed
over a ``--trace 1`` window and divided by its rounds."""
from portbench.metrics._dispatch import is_alloc, ms_per_round


def read(ctx):
    return ms_per_round(ctx, is_alloc)
