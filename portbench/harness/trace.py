"""The profiler's trace of the timed window, reduced.

The window of a ``--trace 1`` run runs under ``torch.profiler`` with the
CUDA activity alone (CUPTI's records of the device; no host-side op
recording, which would slow the host's enqueue).  The benchmark keeps
its own host spans (``dispatch``: inside the fused wave's call;
``readback_wait``: blocked on a launch's event) on the same clock,
``time.time_ns()``.  Read from the raw events:

* ``busy_s``: the union of the device's kernel, copy and set intervals,
  clipped to the window (overlapping operations count once);
* ``kernel_s``: device seconds by kernel name;
* ``idle_by_host``: the device's idle time inside the window, by the
  host span under way when each idle gap began.
"""
from __future__ import annotations

import re
from typing import Dict, List

import torch

def _events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def _is_device(e) -> bool:
    """A kernel, copy or set on the card (not a host label's mirror on
    the device timeline)."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation())


def kernel_name(name: str) -> str:
    """The ``__global__``'s name out of a demangled signature."""
    m = re.search(r"(\w+_kernel)\b", name)
    return m.group(1) if m else name[:80]


def union_s(intervals: List[tuple]) -> float:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def reduce(prof, lo: int, hi: int, spans: list) -> Dict[str, object]:
    """Reduce ``prof``'s device events over the window ``[lo, hi]``
    (``time.time_ns()``: its first enqueue to its closing synchronize);
    ``spans`` are the host's (label, start, end)."""
    evs = _events(prof)
    dev = [(e.start_ns(), e.end_ns(), e.name()) for e in evs if _is_device(e)]
    if not dev:
        return dict(busy_s=0.0, window_s=0.0, kernel_s={}, idle_by_host={},
                    device_ops=[], clock_skew_ns=None)
    clipped = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    busy = union_s([(a, b) for a, b, _ in clipped])
    kernel_s: Dict[str, float] = {}
    for a, b, n in clipped:
        k = kernel_name(n)
        kernel_s[k] = kernel_s.get(k, 0.0) + (b - a) / 1e9
    host = sorted((a, b, n) for n, a, b in spans)
    idle: Dict[str, float] = {}
    gaps, end = [], lo
    for a, b, _ in sorted(clipped):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    j = 0
    for a, b in gaps:
        while j < len(host) and host[j][1] < a:
            j += 1
        label = "host_other"
        for k in range(j, len(host)):
            if host[k][0] > a:
                break
            if host[k][0] <= a <= host[k][1]:
                label = host[k][2]
                break
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    # the first device event after the window opened: a check that the
    # device's and the host's timestamps share a clock
    skew = min((a for a, _, _ in dev if a >= lo), default=hi) - lo
    return dict(busy_s=busy, window_s=(hi - lo) / 1e9, kernel_s=kernel_s,
                idle_by_host=idle,
                device_ops=[[k, v] for k, v in ops], clock_skew_ns=skew)
