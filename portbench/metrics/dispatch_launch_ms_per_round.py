"""Host milliseconds a consensus round spends in the native bindings'
calls: the program's ``launch.<entry>`` spans (``ops/_native.launch``:
the module lookup, the argument conversion and tensor checks, the CUDA
launch), summed over a ``--trace 1`` window and divided by its
rounds."""
from portbench.metrics._dispatch import is_launch, ms_per_round


def read(ctx):
    return ms_per_round(ctx, is_launch)
