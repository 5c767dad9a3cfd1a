"""Shared arithmetic of the host dispatch split: the program's recorder
totals (``dragonboat_tpu_torch.profiling.totals()``: count and
nanoseconds by span name), which only a ``--trace 1`` window, the one
stretch a profiler runs, accumulates, over the window's rounds.

The spans, all inside the fused wave's call (``ops/route.py``
``fused_rounds``, itself the span ``fused_rounds``): ``<kernel>.check``
(shape and argument checks), ``<kernel>.alloc`` (output allocations),
``launch.<entry>`` (the binding's call: argument conversion, tensor
checks, the CUDA launch).  A program without the recorder, or a run in
which it saw no ``fused_rounds`` span, reads None."""
from __future__ import annotations

from typing import Callable, Optional


def _window_totals(ctx) -> Optional[dict]:
    """The recorder's totals, or None where the program's ``profiling``
    has no ``totals`` (a version before the recorder) or the recorder
    saw no fused wave."""
    from dragonboat_tpu_torch import profiling

    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    tot = totals()
    if "fused_rounds" not in tot or not ctx["rounds"]:
        return None
    return tot


def _sum(tot: dict, keep: Callable[[str], bool], field: int) -> float:
    return float(sum(v[field] for k, v in tot.items() if keep(k)))


def is_check(name: str) -> bool:
    return name.endswith(".check")


def is_alloc(name: str) -> bool:
    return name.endswith(".alloc")


def is_launch(name: str) -> bool:
    return name.startswith("launch.")


def ms_per_round(ctx, keep: Callable[[str], bool]):
    """Milliseconds a round in the spans ``keep`` selects."""
    tot = _window_totals(ctx)
    if tot is None:
        return None
    return _sum(tot, keep, 1) / 1e6 / ctx["rounds"]


def self_ms_per_round(ctx):
    """The fused wave's own time a round: its span less the checks,
    allocations and launches inside it."""
    tot = _window_totals(ctx)
    if tot is None:
        return None
    inner = _sum(tot, lambda k: is_check(k) or is_alloc(k) or is_launch(k), 1)
    return (tot["fused_rounds"][1] - inner) / 1e6 / ctx["rounds"]


def launches_per_round(ctx):
    """``launch.*`` spans a round."""
    tot = _window_totals(ctx)
    if tot is None:
        return None
    return _sum(tot, is_launch, 0) / ctx["rounds"]
