"""One run of one cell: set-up, the timed window, the checks, the result.

Set-up builds the cell's rows from the seed, hands them to the program,
and runs launches until every group has a leader and the pipeline is
steady; the allocator sentry is marked there.  The window then launches
for ``seconds`` and closes with ``torch.cuda.synchronize()``.  After it,
the peak memory is read, the program's buffers other than the checked
launches' are freed, and the reference and the guarantees decide
``correct``.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import check, layout
from .loop import Loop, program_rounds
from .manifest import metric_reader, roofline_modules

# the start check: this many groups, followed through this many launches
START_GROUPS = 256
START_LAUNCHES = 11
# set-up ends once every group has a leader (tested every few launches,
# given up after the last), then runs the steady launches
ELECT_EVERY = 8
MAX_ELECT_LAUNCHES = 600
STEADY_LAUNCHES = 24
# the window's checked launches: one drawn from the seed among the first
# few, and the last
SAMPLE_SPAN = 8
# rows a block of the reference's recompute holds at most
BLOCK_ROWS = 1 << 19


def _program_tree(cls, cols: dict, dev):
    return cls(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in cols.items()})


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Holder:
    """Keeps the operands of the launches the check will recompute: the
    launch numbered ``sample`` and always the latest one."""

    def __init__(self, sample: Optional[int]):
        self.sample = sample
        self.held = None
        self.last = None

    def __call__(self, n, inputs, outputs):
        if n == self.sample:
            self.held = (n, inputs, outputs)
        self.last = (n, inputs, outputs)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, *,
        device: str = "cuda",
        rounds_fn: Callable = program_rounds,
        block_rows: int = BLOCK_ROWS,
        after_window: Callable = lambda: None) -> Dict[str, object]:
    """Run ``cell``; returns the result's fields and the compared
    numbers (``checks``: name -> (value, limit)).  ``rounds_fn`` is the
    fused wave the timed window calls (the program's; ``faults.py``
    puts a broken one in its place); set-up always runs the program's.
    ``after_window`` is called once the window has closed (the card's
    clocks are read there)."""
    from dragonboat_tpu_torch.analysis.jitcheck import Sentry
    from dragonboat_tpu_torch.ops import types as T

    dev = torch.device(device)
    cfg = cell.config
    phases = {"imports": time.perf_counter() - t_start}
    lay = layout.build(cfg, seed)
    phases["layout"] = time.perf_counter() - t_start
    state = _program_tree(T.DeviceState, lay.state, dev)
    inbox = _program_tree(T.Inbox, lay.inbox, dev)
    dest = torch.from_numpy(lay.dest_row).to(dev)
    rank = torch.from_numpy(lay.rank_in_dest).to(dev)
    gid = torch.from_numpy(lay.group.astype(np.int64)).to(dev)
    _sync(dev)
    phases["upload"] = time.perf_counter() - t_start

    prof = None
    spans: Optional[list] = None
    if trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        spans = []

    loop = Loop(cell, state, inbox, dest, rank)
    del state, inbox

    # -- set-up: the start check's launches, the elections, steady state ---
    s_rows, s_dest, s_rank = check.start_rows(lay, START_GROUPS, seed)
    rows_t = torch.from_numpy(s_rows).to(dev)
    for _ in range(START_LAUNCHES):
        loop.launch()
    loop.drain()
    phases["start_launches"] = time.perf_counter() - t_start
    start_program = (T.DeviceState(*[t[rows_t].cpu() for t in loop.state]),
                     T.Inbox(*[t[rows_t].cpu() for t in loop.inbox]))
    groups = lay.groups
    elect = 0
    while elect < MAX_ELECT_LAUNCHES:
        for _ in range(ELECT_EVERY):
            loop.launch()
        elect += ELECT_EVERY
        led = check.group_commit_max(
            (loop.state.role == T.ROLE_LEADER).to(torch.int32), gid, groups)
        if int(led.sum()) == groups:
            break
    phases["elections"] = time.perf_counter() - t_start
    warm_hold = _Holder(sample=loop.n + 1)
    for _ in range(STEADY_LAUNCHES):
        loop.launch(hold=warm_hold)
        check.group_commit_max(loop.state.committed.clone(), gid, groups)
    loop.drain()
    _sync(dev)
    setup_launches = loop.n
    del warm_hold
    gc.collect()
    sentry = Sentry()
    sentry.mark()
    if prof is not None:
        prof.start()

    # -- the timed window ------------------------------------------------------
    rng = np.random.default_rng([int(seed) % 2**64, 2])
    holder = _Holder(sample=loop.n + int(rng.integers(0, SAMPLE_SPAN)))
    loop.reset_counts()
    loop.spans = spans
    loop.rounds_fn = rounds_fn
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    committed0 = loop.state.committed.clone()
    cmax0 = check.group_commit_max(committed0, gid, groups)
    while time.perf_counter() - t0 < seconds:
        loop.launch(hold=holder)
    cmax1 = check.group_commit_max(loop.state.committed, gid, groups)
    _sync(dev)
    t1 = time.perf_counter()
    t1_ns = time.time_ns()
    loop.spans = None
    if prof is not None:
        prof.stop()
    card = after_window()
    loop.drain()
    window_s = t1 - t0
    launches = loop.n - loop.first
    rounds = launches * loop.K

    # -- read the device before the reference runs -----------------------------
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    grown = sentry.retraces()
    allocs_after_warm = sum(now - before for _, before, now in grown)
    launch_ms = loop.launch_ms() if dev.type == "cuda" else []
    totals = loop.totals()
    entries = int((cmax1 - cmax0).sum())
    final = (loop.state, loop.inbox)
    held, last = holder.held, holder.last
    loop.state = loop.inbox = None

    # -- the checks ---------------------------------------------------------------
    t_check = time.perf_counter()
    checks: Dict[str, tuple] = {}
    rooflines = roofline_modules() if trace else None
    round_bytes: Dict[str, list] = {k: [] for k in (rooflines or {})}
    checked = [x for x in (held, last) if x is not None]
    if held is not None and last is not None and held[0] == last[0]:
        checked = [last]
    n_checked = len(checked)
    words = counters = 0
    for n, inputs, outputs in checked:
        i = n - loop.first
        res = check.compare_launch(
            lay, loop.kw, inputs, outputs, loop.launch_stats[i],
            loop.launch_esc[i], dev, block_rows, rooflines=rooflines)
        words += res["words"]
        counters += res["counters"]
        for k, v in res["round_bytes"].items():
            round_bytes[k].append(v)
    del held, last, checked
    check_parts = {"window_launches": time.perf_counter() - t_check}
    checks["window_launches_unchecked"] = (0 if n_checked else 1, 0)
    checks["window_words_differ"] = (words, 0)
    checks["window_counters_differ"] = (counters, 0)
    checks["start_words_differ"] = (check.start_check(
        lay, loop.kw, s_rows, s_dest, s_rank, START_LAUNCHES, start_program,
        dev), 0)
    check_parts["start"] = time.perf_counter() - t_check
    g = check.guarantees(final[0], committed0, gid, groups)
    for k, v in g.items():
        checks[k] = (v, 0)
    # the commit counts the rates are computed from, recomputed on the host
    c0 = committed0.cpu().numpy().astype(np.int64)
    c1 = final[0].committed.cpu().numpy().astype(np.int64)
    host_entries = int(np.maximum.reduceat(c1, lay.start).sum()
                       - np.maximum.reduceat(c0, lay.start).sum())
    checks["commit_count_differs"] = (abs(host_entries - entries), 0)
    correct = all(v <= lim for v, lim in checks.values())
    check_s = time.perf_counter() - t_check

    # -- metrics ------------------------------------------------------------------
    attempted = groups * rounds
    failed = (totals["escalated_rows"] + totals["dropped_off_device"]
              + totals["dropped_budget"] + totals["dropped_ring"])
    e2e = dict(
        group_rounds_per_s=(attempted - totals["escalated_rows"]) / window_s,
        entries_committed_per_s=entries / window_s,
        launch_p95_ms=(statistics.quantiles(launch_ms, n=20)[18]
                       if len(launch_ms) >= 2 else None),
        setup_s=setup_s,
    )
    tr = None
    if prof is not None:
        from . import trace as trace_mod

        tr = trace_mod.reduce(prof, t0_ns, t1_ns, spans)
    ctx = dict(cell=cell, window_s=window_s, launches=launches, rounds=rounds,
               groups=groups, entries=entries, dispatch_s=loop.dispatch_s,
               readback_spans=loop.readback_spans, trace=tr,
               round_bytes={k: float(np.mean(v)) for k, v in round_bytes.items() if v},
               allocs_after_warm=allocs_after_warm,
               kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=units[m["name"]])
    else:
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=units[m["name"]])
    return dict(
        correct=correct, attempted=attempted, failed=failed, metrics=metrics,
        checks=checks, trace=tr, peak=peak, totals=totals,
        setup_launches=setup_launches, launches=launches, rounds=rounds,
        window_s=window_s, entries=entries, grown=grown, check_s=check_s,
        setup_phases=phases, check_parts=check_parts, after_window=card,
        leaders=int((final[0].role == T.ROLE_LEADER).sum()),
    )
