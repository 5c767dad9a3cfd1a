"""The port's span recorder, on the profiler's clock and switch.

A span is a named interval of host time on one thread, timed with
``time.time_ns()``: the clock ``torch.profiler``'s events carry, so a
span and the ops and kernels it enqueued line up on one timeline.  The
recorder is on exactly while a ``torch.profiler`` session is active in
the process (any activity set, the CUDA-only one included): the switch
is the profiler's own flag, read live, so the device trace and the
program's spans share a window.  There is no other knob.

Hot path, two calls and one flag load a site when off::

    t = profiling.begin()          # 0 while no profiler runs
    ... work ...
    profiling.end("route.check", t)

When on, ``end`` adds one to the name's count and the interval to its
nanosecond total in its thread's own totals (no lock; ``totals()`` sums
the threads and never drops a record), and appends
``(name, start, end, thread)`` to a ring of ``CAPACITY`` records
allocated once, by the first record (``spans()``; the oldest are
overwritten and counted in ``dropped()``).  ``thread`` is the thread's native id, the profiler's
``tid``.  A span's parent is the innermost span of the same thread that
contains it; no stack is kept.  ``annotate(name)`` is the same span as
a context manager, and ``stage(name, t0)`` closes a stage that is timed
whether or not the recorder is on.

While the recorder is on, the fused wave (``ops/route.py``
``fused_rounds``) also takes the election census: the route counts the
pre-vote and vote requests and the granted pre-vote and vote responses it
takes from the outboxes into a per-device int64 vector
(``census_buffer``), on the device and without a sync; ``census()`` reads
the totals back once the work has been synchronized.

``trace(log_dir)`` is the operator's capture: CPU and (when present)
CUDA activity, with the session's spans merged into the one Chrome
trace it writes, ``log_dir/trace.json``::

    from dragonboat_tpu_torch.profiling import trace

    with trace("/tmp/raft-trace"):
        ... run a workload ...
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

# records the ring holds; a 10 s benchmark window records under 10^5
CAPACITY = 1 << 18

_now = time.time_ns
# the ring: four parallel lists, so a record allocates no object the
# garbage collector tracks; a record's slot is its sequence number
# (``next`` on a count is atomic under the interpreter lock).  Allocated
# once, by the first record, so a process that never profiles holds none.
_names = _starts = _ends = _threads = None
_seq = itertools.count()
_lock = threading.Lock()      # registration, reset and the readers
_local = threading.local()    # .totals: this thread's _Totals
_all: list = []               # every recording thread's _Totals

# the election census, in the order of its vector (csrc/route.cu
# ``route_lane_census``, ops/route_ref.py ``census_counts``)
CENSUS = ("prevote_requests", "vote_requests", "prevote_grants",
          "vote_grants")
_census: Dict[str, torch.Tensor] = {}  # device -> its [4] int64 vector


class _Totals(dict):
    """One thread's {name: [count, nanoseconds]}.  Only its thread writes
    it, so a record takes no lock."""

    __slots__ = ("tid",)


def _register() -> _Totals:
    mine = _Totals()
    mine.tid = threading.get_native_id()  # one system call a thread
    with _lock:
        _all.append(mine)
    _local.totals = mine
    return mine


def _alloc_ring() -> None:
    global _names, _starts, _ends, _threads
    with _lock:
        if _names is None:
            _starts, _ends, _threads = ([0] * CAPACITY for _ in range(3))
            _names = [None] * CAPACITY


def begin() -> int:
    """The span's start (``time.time_ns()``), or 0 when the recorder is
    off."""
    return _now() if _autograd_profiler._is_profiler_enabled else 0


def end(name: str, t: int) -> None:
    """Close the span ``name`` begun at ``t`` (``begin()``'s value);
    nothing when ``t`` is 0."""
    if t:
        _record(name, t, _now())


def stage(name: str, t0: int) -> float:
    """Close the always-timed stage ``name`` begun at ``t0``
    (``time.time_ns()``): record it as a span when the recorder is on,
    and return its milliseconds."""
    t1 = _now()
    if _autograd_profiler._is_profiler_enabled:
        _record(name, t0, t1)
    return (t1 - t0) / 1e6


def _record(name: str, t0: int, t1: int) -> None:
    try:
        mine = _local.totals
    except AttributeError:
        mine = _register()
    tot = mine.get(name)
    if tot is None:
        mine[name] = [1, t1 - t0]
    else:
        tot[0] += 1
        tot[1] += t1 - t0
    if _names is None:
        _alloc_ring()
    i = next(_seq) % CAPACITY
    _names[i] = name
    _starts[i] = t0
    _ends[i] = t1
    _threads[i] = mine.tid


class _Span:
    __slots__ = ("name", "t")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = _now()
        return self

    def __exit__(self, *exc):
        _record(self.name, self.t, _now())
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span over a ``with`` block; the shared null context when the
    recorder is off."""
    return _Span(name) if _autograd_profiler._is_profiler_enabled else _OFF


def totals() -> Dict[str, Tuple[int, int]]:
    """{name: (count, nanoseconds)} of every span since the last reset,
    over all threads."""
    out: Dict[str, Tuple[int, int]] = {}
    with _lock:
        for mine in _all:
            for k, (n, ns) in list(mine.items()):
                c, t = out.get(k, (0, 0))
                out[k] = (c + n, t + ns)
    return out


def _count() -> int:
    return sum(n for n, _ in totals().values())


def spans() -> List[Tuple[str, int, int, int]]:
    """The ring's records, oldest first: (name, start, end, thread).
    Read them once the recording threads are done."""
    n = _count()
    if _names is None:
        return []
    recs = list(zip(_names, _starts, _ends, _threads))
    if n <= CAPACITY:
        return recs[:n]
    i = n % CAPACITY
    return recs[i:] + recs[:i]


def dropped() -> int:
    """Records the ring overwrote since the last reset (the totals keep
    them)."""
    return max(0, _count() - CAPACITY)


def census_buffer(device) -> Optional[torch.Tensor]:
    """The census vector of ``device`` for a fused wave to add to while
    the recorder is on, else None (the wave counts nothing).  Made, zeroed,
    by the first wave that asks on that device, and kept."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    key = str(device)
    buf = _census.get(key)
    if buf is None:
        with _lock:
            buf = _census.get(key)
            if buf is None:
                buf = _census[key] = torch.zeros(
                    len(CENSUS), dtype=torch.int64, device=device)
    return buf


def census() -> Dict[str, int]:
    """{kind: count} of the election census since the last reset, over
    every device (``CENSUS``'s kinds; 0 where no wave counted).  Reads each
    device's vector back: call it after the counted work's closing
    synchronize."""
    out = dict.fromkeys(CENSUS, 0)
    with _lock:
        bufs = list(_census.values())
    for buf in bufs:
        for k, v in zip(CENSUS, buf.tolist()):
            out[k] += v
    return out


def reset() -> None:
    """Forget every span, total and drop (the ring, once allocated, is
    kept), and zero the census.  Call it while no profiler runs."""
    global _seq
    with _lock:
        for mine in _all:
            mine.clear()
        _seq = itertools.count()
        for buf in _census.values():
            buf.zero_()


def interval_union(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals:
    overlapping intervals count once."""
    total, last = 0, None
    for a, b in sorted(intervals):
        if last is None or a > last:
            total += b - a
            last = b
        elif b > last:
            total += b - last
            last = b
    return total


def _merge_into_chrome_trace(path: str, records: Iterable[tuple]) -> None:
    """Append ``records`` (``spans()``'s tuples) to the Chrome trace at
    ``path`` as complete (``X``) events of this process, each on its
    thread's lane, converted to the file's timebase (microseconds since
    its ``baseTimeNanoseconds``, 0 where it has none)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    evs = [dict(ph="X", cat="program", name=name, pid=pid, tid=tid,
                ts=(t0 - base) / 1e3, dur=(t1 - t0) / 1e3)
           for name, t0, t1, tid in records]
    doc.setdefault("traceEvents", []).extend(evs)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile CPU and (when present) CUDA activity into
    ``log_dir/trace.json``, with the program's spans of the session
    merged into it.  Resets the recorder first."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _merge_into_chrome_trace(path, spans())
