"""The device loop: launches of the system's fused consensus round.

Each launch is one call of ``route.fused_rounds(..., rounds=K)``, then a
non-blocking copy of its ``stats [K, 6]`` and ``n_esc [K]`` into pinned
buffers and an event, dispatched ahead ``depth`` deep: before launch
``i`` the host waits for launch ``i - depth``'s event and reads its
counters.  Set-up and the timed window run the same code, so every
shape, buffer and allocator block the window uses is warmed.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from dragonboat_tpu_torch.ops import route as program_route

N_STATS = 6  # delivered, off_device, budget, ring, suppressed, host_carried


def program_rounds(state, inbox, dest, rank, **kw):
    """The system under test: one fused wave of K rounds."""
    return program_route.fused_rounds(state, inbox, dest, rank, **kw)


class Loop:
    """Runs launches on ``state`` / ``inbox`` and keeps the host's view
    of them: per-launch counters, host spans and device events.

    ``rounds_fn`` is the program's fused wave (tests put a broken one in
    its place).  With ``schedule`` (a ``partition.Schedule``) set, each
    launch is passed its phase's peer table in place of ``dest``.
    ``hold`` is called with (launch index, inputs, outputs, phase) after
    every launch is enqueued, so a caller can keep the operands of the
    launches it will check.  With ``spans`` a list, the host spans
    ``dispatch`` and ``readback_wait`` are appended to it as (label,
    start, end) in ``time.time_ns()`` (the profiler's clock)."""

    def __init__(self, cell, state, inbox, dest, rank, *,
                 rounds_fn: Callable = program_rounds,
                 spans: Optional[list] = None):
        cfg = cell.config
        self.K = int(cfg["rounds_per_launch"])
        self.depth = int(cfg["pipeline_depth"])
        self.kw = dict(rounds=self.K, out_capacity=int(cfg["O"]),
                       budget=int(cfg["budget"]), base=int(cfg["base"]),
                       propose_leaders=bool(cell.traffic["propose_leaders"]),
                       propose_n=int(cell.traffic["propose_n"]))
        self.state, self.inbox, self.dest, self.rank = state, inbox, dest, rank
        self.rounds_fn = rounds_fn
        self.schedule = None
        self.cuda = state.term.device.type == "cuda"
        nbuf = self.depth + 1
        pin = self.cuda
        self._stats = [torch.zeros((self.K, N_STATS), dtype=torch.int32,
                                   pin_memory=pin) for _ in range(nbuf)]
        self._esc = [torch.zeros((self.K,), dtype=torch.int32,
                                 pin_memory=pin) for _ in range(nbuf)]
        self._inflight: deque = deque()
        self.n = 0                       # launches enqueued
        self.spans = spans
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launch_stats: list = []     # [K, 6] int64 a launch, in order
        self.launch_esc: list = []       # [K] a launch
        self.dispatch_s = 0.0            # host time inside the fused wave
        self.readback_spans: list = []   # request -> event seen, seconds
        self.events: list = []           # (start, done) device events a launch
        self.first = self.n              # index of the first counted launch

    # -- one launch -------------------------------------------------------
    def _collect(self) -> None:
        i, ev, slot, t_req = self._inflight.popleft()
        if ev is not None:
            a = time.time_ns()
            ev.synchronize()
            if self.spans is not None:
                self.spans.append(("readback_wait", a, time.time_ns()))
        seen = time.perf_counter()
        if i >= self.first:
            self.readback_spans.append(seen - t_req)
            self.launch_stats.append(self._stats[slot].numpy().astype(np.int64))
            self.launch_esc.append(self._esc[slot].numpy().astype(np.int64))

    def launch(self, hold: Optional[Callable] = None):
        while len(self._inflight) >= self.depth:
            self._collect()
        slot = self.n % len(self._stats)
        ev0 = ev1 = None
        if self.cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        s_in, i_in = self.state, self.inbox
        phase = None if self.schedule is None else self.schedule.phase_of(self.n)
        dest = self.dest if phase is None else self.schedule.device[phase]
        a = time.time_ns()
        t = time.perf_counter()
        st, ib, stats, n_esc = self.rounds_fn(
            s_in, i_in, dest, self.rank, **self.kw)
        self.dispatch_s += time.perf_counter() - t
        if self.spans is not None:
            self.spans.append(("dispatch", a, time.time_ns()))
        self._stats[slot].copy_(stats, non_blocking=True)
        self._esc[slot].copy_(n_esc, non_blocking=True)
        t_req = time.perf_counter()
        if self.cuda:
            ev1.record()
            self.events.append((ev0, ev1))
        self._inflight.append((self.n, ev1, slot, t_req))
        self.state, self.inbox = st, ib
        if hold is not None:
            hold(self.n, (s_in, i_in), (st, ib), phase)
        self.n += 1

    def drain(self) -> None:
        while self._inflight:
            self._collect()

    # -- results ------------------------------------------------------------
    def launch_ms(self) -> list:
        """Device milliseconds of each timed launch, from its first
        kernel to its readback (CUDA events; call after a sync)."""
        return [a.elapsed_time(b) for a, b in self.events]

    def totals(self) -> dict:
        st = (np.sum(self.launch_stats, axis=(0, 1)) if self.launch_stats
              else np.zeros(N_STATS, np.int64))
        esc = int(np.sum(self.launch_esc)) if self.launch_esc else 0
        return dict(delivered=int(st[0]), dropped_off_device=int(st[1]),
                    dropped_budget=int(st[2]), dropped_ring=int(st[3]),
                    suppressed=int(st[4]), host_carried=int(st[5]),
                    escalated_rows=esc)
