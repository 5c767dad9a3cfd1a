"""The day's ledger: per-phase measurements + the per-fault-class
recovery/dip table, serializable as JSON and printable as a table
(``scripts/day_soak.sh`` prints it; tests assert on the dict form).

Every number is a measured delta over one phase's wall window, sampled
from the planes' own counters (gateway stats, transport stream totals,
nemesis stats, :data:`dragonboat_tpu.faults.RECOVERY_STATS`) — the
report never keeps its own timers, so "throughput dip per fault class"
reads from the same sources the operators' dashboards would.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class DayReport:
    """The outcome of one :class:`~.runner.ScenarioRunner` run."""

    seed: int = 0
    gear: str = "mini"
    plan: str = ""
    wall_s: float = 0.0
    phases: List[dict] = field(default_factory=list)
    baseline_committed_per_s: float = 0.0
    #: fault_class -> committed/s during that class's phase relative to
    #: the warmup baseline (1.0 = no dip; smaller = throughput dip)
    fault_dips: Dict[str, float] = field(default_factory=dict)
    #: RECOVERY_STATS.snapshot() at day end (count/worst/p99/margins
    #: per fault class)
    recovery: Dict[str, dict] = field(default_factory=dict)
    audit: Dict[str, object] = field(default_factory=dict)
    #: the plan's disturbance classes — ok requires EVERY one of these
    #: to have fired, not just the ones that happened to be recorded
    #: (the standard gears plan all five DISTURBANCE_CLASSES)
    classes_planned: List[str] = field(default_factory=list)
    disturbances_fired: Dict[str, int] = field(default_factory=dict)
    violations: List[str] = field(default_factory=list)
    aborted: str = ""
    timeline: str = ""
    #: device-path counters from the colocated fleet member's engine
    #: group (empty when the day ran host-only)
    colocated: Dict[str, int] = field(default_factory=dict)
    #: SLO burn-rate rows from the fleet scope (obs/slo.py) — the
    #: day's objective ledger with burning windows attributed to the
    #: collector marks (kill windows, phase boundaries) inside them.
    #: Carried, not gating: ``ok`` stays the recovery/audit verdict.
    slo: List[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (
            not self.aborted
            and not self.violations
            and bool(self.audit.get("ok", False))
            and all(
                self.disturbances_fired.get(c, 0) > 0
                for c in self.classes_planned
            )
            and all(
                r.get("violations", 0) == 0 for r in self.recovery.values()
            )
        )

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "seed": self.seed,
            "gear": self.gear,
            "wall_s": round(self.wall_s, 3),
            "baseline_committed_per_s": round(
                self.baseline_committed_per_s, 2
            ),
            "phases": self.phases,
            "fault_dips": {
                k: round(v, 4) for k, v in sorted(self.fault_dips.items())
            },
            "recovery": self.recovery,
            "audit": self.audit,
            "classes_planned": list(self.classes_planned),
            "disturbances_fired": self.disturbances_fired,
            "violations": self.violations,
            "aborted": self.aborted,
            "plan": self.plan,
            "colocated": dict(self.colocated),
            "slo": list(self.slo),
        }

    def to_json(self, path: str = "") -> str:
        text = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def format_table(self) -> str:
        """The operator-facing ledger table (phases + the per-class
        recovery/dip summary)."""
        cols = (
            "phase", "class", "wall_s", "comm/s", "shed/s", "p99_ms",
            "lease%", "resumes",
        )
        rows = [cols]
        for p in self.phases:
            rows.append((
                p["name"],
                p.get("fault_class", "") or "-",
                f"{p['wall_s']:.1f}",
                f"{p['committed_per_s']:.0f}",
                f"{p['shed_per_s']:.0f}",
                f"{p['p99_s'] * 1000:.0f}",
                f"{p['lease_share'] * 100:.0f}",
                str(p.get("stream_resumes", 0)),
            ))
        widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
        lines = [
            "  ".join(c.ljust(widths[i]) for i, c in enumerate(r))
            for r in rows
        ]
        lines.append("")
        lines.append("fault class         dip    recoveries  worst_s  "
                     "p99_s  min_margin_s")
        for cls in sorted(set(self.fault_dips) | set(self.recovery)):
            r = self.recovery.get(cls, {})
            dip = self.fault_dips.get(cls)
            dip_s = "-" if dip is None else f"{dip:.2f}"
            lines.append(
                f"{cls:<18}  {dip_s:>5}"
                f"  {r.get('count', 0):>10}  {r.get('worst_s', 0.0):>7}"
                f"  {r.get('p99_s', 0.0):>5}  {r.get('min_margin_s', 0.0)}"
            )
        if self.slo:
            lines.append("")
            lines.append("objective             burn   bad/good      "
                         "burning-windows")
            for r in self.slo:
                lines.append(
                    f"{r['objective']:<20}  {r['burn_rate']:>5}"
                    f"  {r['bad']:.0f}/{r['good']:.0f}"
                    f"{'':<6}  {len(r.get('windows', ()))}"
                )
        verdict = "OK" if self.ok else (
            f"ABORTED in {self.aborted}" if self.aborted else "VIOLATIONS"
        )
        lines.append("")
        lines.append(
            f"day[{self.gear}] seed={self.seed} wall={self.wall_s:.1f}s "
            f"baseline={self.baseline_committed_per_s:.0f}/s "
            f"audit={'green' if self.audit.get('ok') else 'RED'} "
            f"-> {verdict}"
        )
        return "\n".join(lines)
