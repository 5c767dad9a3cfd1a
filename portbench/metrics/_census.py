"""Shared arithmetic of the election census readers: the program's
census (``dragonboat_tpu_torch.profiling.census()``: the pre-vote and
vote requests, and the pre-vote and vote responses that grant, which the
route took from the outboxes, delivered or dropped), which only a
``--trace 1`` window, the one stretch a profiler runs, accumulates, over
the window's rounds.  A program without the census, or a run in which
the recorder saw no fused wave, reads None."""
from __future__ import annotations

from typing import Sequence

from portbench.metrics._dispatch import _window_totals


def per_round(ctx, kinds: Sequence[str]):
    """The census's ``kinds`` summed, a round of the window."""
    from dragonboat_tpu_torch import profiling

    census = getattr(profiling, "census", None)
    if census is None or _window_totals(ctx) is None:
        return None
    counts = census()
    return sum(counts[k] for k in kinds) / ctx["rounds"]
