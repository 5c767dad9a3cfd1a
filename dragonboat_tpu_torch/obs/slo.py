"""SLO layer: declarative objectives evaluated from fleet metric
deltas into burn-rate ledgers (docs/OBSERVABILITY.md "Fleet scope").

reference: the multiwindow burn-rate alerting idiom (SRE workbook ch.5)
— an objective owns an error budget, each observation window's
bad/good ratio divided by that budget is the window's burn rate, and a
burn rate above 1.0 means the budget is being spent faster than the
objective allows.  Here the windows are :class:`~.fleetscope.
FleetScope` poll deltas: every row says which objective burned, in
which wall window, across which processes — the triage answer a
production day's verdict owes its operator.

Objectives select COUNTER series (monotone, so a per-window delta is a
rate) or a histogram (latency objectives: the fraction of observations
past the bound).  Gauges are levels, not budgets, and are deliberately
not selectable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..metrics import _base_name


@dataclass(frozen=True)
class Objective:
    """One declarative objective.

    ``kind``:

    * ``ratio`` — ``bad``/``good`` are counter selectors; the budget is
      the tolerated bad fraction of (bad + good);
    * ``latency`` — ``hist`` is a histogram base name; the budget is
      the tolerated fraction of observations slower than ``bound_s``;
    * ``event`` — ``bad`` is a counter selector; ANY delta burns (the
      burn rate is the event count itself — recovery-SLA misses have
      no denominator).

    A selector is a base name (matches every labelled series of that
    family) or a full labelled series name (exact match).
    """

    name: str
    kind: str
    bad: str = ""
    good: str = ""
    hist: str = ""
    bound_s: float = 0.0
    budget: float = 0.01
    description: str = ""


#: The catalog the scenario day reports evaluate (ISSUE 19): commit
#: latency, bounded-read overruns, admission sheds and recovery-SLA
#: misses.  Callers pass their own list to tighten/extend.
DEFAULT_OBJECTIVES: Sequence[Objective] = (
    Objective(
        name="commit_p99",
        kind="latency",
        hist="gateway_request_seconds",
        bound_s=0.5,
        budget=0.01,
        description="gateway request latency: <=1% of requests past "
                    "500ms",
    ),
    Objective(
        name="read_bound_overruns",
        kind="ratio",
        bad='nodehost_read_total{path="bounded_shed"}',
        good='nodehost_read_total{path="bounded"}',
        budget=0.05,
        description="bounded-staleness reads shed past the bound: <=5%",
    ),
    Objective(
        name="shed_ratio",
        kind="ratio",
        bad="gateway_shed_total",
        good="gateway_committed_total",
        budget=0.05,
        description="admission sheds vs commits: <=5%",
    ),
    Objective(
        name="recovery_sla_misses",
        kind="event",
        bad="churn_sla_violations_total",
        budget=0.0,
        description="recovery-SLA violations: any is a burn",
    ),
)


def _matches(series: str, selector: str) -> bool:
    if not selector:
        return False
    if "{" in selector:
        return series == selector
    return _base_name(series) == selector


def _sum_counter(delta: dict, selector: str) -> float:
    return float(sum(
        v for name, v in delta.get("counters", {}).items()
        if _matches(name, selector)
    ))


def _hist_over_bound(delta: dict, base: str, bound_s: float):
    """(observations past bound, total observations) from a window's
    histogram bucket deltas.  Bucket granularity rounds DOWN the
    overrun count (an observation counts as over only when its whole
    bucket lies past the bound) — burn rates err conservative."""
    over = total = 0.0
    for name, h in delta.get("histograms", {}).items():
        if _base_name(name) != base:
            continue
        bounds = h.get("bounds", ())
        buckets = h.get("buckets", ())
        total += float(h.get("count", 0))
        for i, b in enumerate(bounds):
            if b > bound_s and i < len(buckets):
                over += float(buckets[i])
        if len(buckets) > len(bounds):
            over += float(buckets[-1])  # +Inf overflow bucket
    return over, total


def _window_counts(o: Objective, window: dict):
    """(bad, good, procs-that-contributed-bad) for one poll window."""
    bad = good = 0.0
    procs: List[str] = []
    for key, delta in window.get("deltas", {}).items():
        if o.kind == "latency":
            b, total = _hist_over_bound(delta, o.hist, o.bound_s)
            g = max(0.0, total - b)
        else:
            b = _sum_counter(delta, o.bad)
            g = _sum_counter(delta, o.good) if o.good else 0.0
        bad += b
        good += g
        if b > 0:
            procs.append(key)
    return bad, good, procs


def _burn_rate(o: Objective, bad: float, good: float) -> float:
    if o.kind == "event" or o.budget <= 0.0:
        return bad
    total = bad + good
    if total <= 0:
        return 0.0
    return (bad / total) / o.budget


def evaluate(
    windows: Sequence[dict],
    objectives: Optional[Sequence[Objective]] = None,
    *,
    mark_horizon_s: float = 10.0,
) -> List[dict]:
    """Burn-rate rows, one per objective, from FleetScope poll windows
    (each ``{"t0", "t1", "marks", "deltas": {proc: metric deltas}}``).

    Each row aggregates the whole run and lists every BURNING window
    (burn rate > 1.0) with its wall bounds, contributing processes and
    the collector marks attributed to it — a mid-day kill window shows
    up attributed on exactly the objectives it burned.  Attribution
    looks BACK ``mark_horizon_s`` seconds from the burning window: a
    ``proc_kill`` mark lands in the short poll window where it was
    stamped, but the damage it causes (timeouts, sheds) burns the
    windows that close during the recovery — those later windows must
    still name their cause."""
    all_marks: List[list] = sorted(
        (list(m) for w in windows for m in w.get("marks", ())),
        key=lambda m: float(m[0]),
    )
    rows: List[dict] = []
    for o in objectives if objectives is not None else DEFAULT_OBJECTIVES:
        total_bad = total_good = 0.0
        procs: set = set()
        burn_windows: List[dict] = []
        for w in windows:
            bad, good, wprocs = _window_counts(o, w)
            total_bad += bad
            total_good += good
            procs.update(wprocs)
            rate = _burn_rate(o, bad, good)
            if rate > 1.0:
                t0 = float(w.get("t0", 0.0))
                t1 = float(w.get("t1", 0.0))
                burn_windows.append({
                    "t0": round(t0, 6),
                    "t1": round(t1, 6),
                    "bad": bad,
                    "good": good,
                    "burn_rate": round(rate, 4),
                    "procs": sorted(wprocs),
                    "marks": [
                        m for m in all_marks
                        if t0 - mark_horizon_s <= float(m[0]) <= t1
                    ],
                })
        rate = _burn_rate(o, total_bad, total_good)
        total = total_bad + total_good
        rows.append({
            "objective": o.name,
            "kind": o.kind,
            "budget": o.budget,
            "bad": total_bad,
            "good": total_good,
            "ratio": round(total_bad / total, 6) if total else 0.0,
            "burn_rate": round(rate, 4),
            "burning": bool(burn_windows),
            "windows": burn_windows,
            "procs": sorted(procs),
            "description": o.description,
        })
    return rows
