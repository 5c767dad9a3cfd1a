"""Mean milliseconds from a launch's readback request (its non-blocking
copy of the round counters into pinned memory, then an event) to the
host seeing that event complete: the benchmark's span, over every
launch of the window."""


def read(ctx):
    spans = ctx["readback_spans"]
    if not spans:
        return None
    return sum(spans) * 1e3 / len(spans)
