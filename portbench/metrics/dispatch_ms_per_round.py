"""Host milliseconds a consensus round spends in the fused wave's call
(``ops/route.py`` + ``ops/kernel.py`` enqueueing ``raft_step``,
``merge_escalated`` and ``route``; no sync inside): the benchmark's own
host spans around each ``fused_rounds`` call, summed over the window and
divided by its rounds."""


def read(ctx):
    if not ctx["rounds"]:
        return None
    return ctx["dispatch_s"] * 1e3 / ctx["rounds"]
