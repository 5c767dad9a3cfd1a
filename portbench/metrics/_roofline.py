"""Shared arithmetic of the ``<kernel>_roofline`` readers: the least
bytes a round needs (``roofline/<kernel>.py``, over the checked
launches' rounds as the reference recomputed them) over the profiler's
device time of that kernel a round, against the card's published HBM
rate (``roofline/_peaks.py``)."""
from __future__ import annotations

import importlib

from portbench.roofline._peaks import hbm_bytes_per_s


def share_pct(ctx, kernel: str):
    """Percent of ``kernel``'s memory roofline, or None where the run
    traced no launch of it or has no byte count for it."""
    tr = ctx.get("trace")
    nbytes = ctx["round_bytes"].get(kernel)
    if not tr or not nbytes or not ctx["rounds"]:
        return None
    mod = importlib.import_module(f"portbench.roofline.{kernel}")
    secs = sum(tr["kernel_s"].get(k, 0.0) for k in mod.KERNELS)
    if secs <= 0:
        return None
    return 100.0 * (nbytes / hbm_bytes_per_s(ctx["kind"])) / (secs / ctx["rounds"])
