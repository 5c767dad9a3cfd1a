"""Host milliseconds a consensus round spends in the fused wave's own
Python (the round loop, tuple building, listing the operands): the
program's ``fused_rounds`` span less its ``*.check``, ``*.alloc`` and
``launch.*`` spans, over a ``--trace 1`` window's rounds.  With the
three beside it, it adds up to the program's ``fused_rounds`` span, the
call ``dispatch_ms_per_round`` times from outside."""
from portbench.metrics._dispatch import self_ms_per_round


def read(ctx):
    return self_ms_per_round(ctx)
