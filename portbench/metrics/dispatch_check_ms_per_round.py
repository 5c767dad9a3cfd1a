"""Host milliseconds a consensus round spends in the fused wave's shape
and argument checks: the program's ``*.check`` spans (``raft_step``'s
P/W/O checks and shape loop, the escalation merge's row shapes, the
route's layout and table checks), summed over a ``--trace 1`` window
and divided by its rounds."""
from portbench.metrics._dispatch import is_check, ms_per_round


def read(ctx):
    return ms_per_round(ctx, is_check)
