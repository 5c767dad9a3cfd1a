"""Offline linearizability + exactly-once session checker.

reference: Wing & Gong's simulation search as used by the Knossos /
Porcupine checkers [U].  The search exploits two structural facts of
the audited workload:

* **per-key partitioning** — the model is an independent register per
  key, and linearizability is compositional (Herlihy–Wing locality), so
  each key's sub-history is checked alone;
* **unique write values** — every write carries a globally-unique
  value, so a read pins exactly which write it observed.

For one key the search walks all real-time-respecting linearization
orders: an op may be linearized next iff no other still-pending op
*returned* before it was *invoked*; a write sets the register, a read
must observe it.  Ambiguous (``maybe committed``) writes have
``ret = +inf`` and may be linearized anywhere after their invoke — or
never (success only requires every ``ok`` op to be placed).  Memoizing
on (placed-set, register-value) makes repeated interleavings cheap; a
``bound`` on visited states is the escape hatch for adversarial
histories (the result then says *bounded*, not *ok*).

On violation the failing key's sub-history is shrunk to a 1-minimal
counterexample (greedy delta-debugging: drop any op whose removal keeps
the history non-linearizable) and reported with its real-time window.

Two further passes cover what linearizability alone cannot:

* :func:`check_stale_reads` — ``stale_read`` results are exempt from
  recency but must never surface a value that was *never committed*
  (a definitely-failed write) or one invoked only after the read
  returned;
* :func:`check_sessions` — the exactly-once pass over the replicas'
  apply journals (:class:`dragonboat_tpu.audit.model.AuditKV`):
  replicas agree on apply order, every acked write applied exactly
  once (no lost acks, no duplicate applies), every failed write zero
  times, every ambiguous write at most once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..logger import get_logger
from .history import Op

_log = get_logger("audit")

DEFAULT_BOUND = 200_000


@dataclass
class Violation:
    key: object
    reason: str
    window: Tuple[float, float]
    ops: List[Op] = field(default_factory=list)

    def describe(self) -> str:
        lines = [
            f"key={self.key!r}: {self.reason} "
            f"(window [{self.window[0]:.6f}, {self.window[1]:.6f}], "
            f"{len(self.ops)} op(s))"
        ]
        lines += [f"  {o.describe()}" for o in self.ops]
        return "\n".join(lines)


@dataclass
class CheckResult:
    ok: bool
    bounded: bool = False
    violations: List[Violation] = field(default_factory=list)
    states: int = 0
    keys_checked: int = 0

    def describe(self) -> str:
        if self.ok:
            extra = " (BOUNDED: some keys not fully searched)" if self.bounded else ""
            return (
                f"linearizable: {self.keys_checked} key(s), "
                f"{self.states} state(s) explored{extra}"
            )
        return "NOT linearizable:\n" + "\n".join(
            v.describe() for v in self.violations
        )


def _window(ops: Sequence[Op]) -> Tuple[float, float]:
    lo = min((o.invoke for o in ops), default=0.0)
    hi = max(
        (o.ret for o in ops if o.ret != math.inf),
        default=max((o.invoke for o in ops), default=0.0),
    )
    return (lo, hi)


def _linearize_key(
    ops: Sequence[Op], initial, bound: int
) -> Tuple[Optional[bool], int]:
    """Search one key's sub-history.  Returns (verdict, states): verdict
    True = linearizable, False = provably not, None = bound exhausted."""
    n = len(ops)
    required = frozenset(i for i in range(n) if ops[i].status == "ok")
    if not required:
        return True, 0
    seen = set()
    states = 0
    stack = [(frozenset(), initial)]
    while stack:
        done, val = stack.pop()
        if (done, val) in seen:
            continue
        seen.add((done, val))
        states += 1
        if states > bound:
            return None, states
        if required <= done:
            return True, states
        pending = [i for i in range(n) if i not in done]
        min_ret = min(ops[i].ret for i in pending)
        for i in pending:
            o = ops[i]
            if o.invoke > min_ret:
                # some still-pending op returned before o was invoked;
                # that op must be linearized first
                continue
            if o.kind == "w":
                stack.append((done | {i}, o.value))
            elif o.output == val:
                stack.append((done | {i}, val))
    return False, states


_MINIMIZE_CAP = 128  # delta-debug is O(n^2) searches; skip huge windows


def _minimize(ops: List[Op], initial, bound: int) -> List[Op]:
    """Greedy 1-minimal shrink of a non-linearizable sub-history."""
    if len(ops) > _MINIMIZE_CAP:
        return ops
    cur = list(ops)
    changed = True
    while changed:
        changed = False
        for i in range(len(cur)):
            cand = cur[:i] + cur[i + 1:]
            verdict, _ = _linearize_key(cand, initial, bound)
            if verdict is False:
                cur = cand
                changed = True
                break
    return cur


def check_linearizable(
    ops: Sequence[Op], *, initial=None, bound: int = DEFAULT_BOUND
) -> CheckResult:
    """Per-key Wing–Gong search over a recorded history.

    Participants: ``ok``/``ambig`` writes and ``ok`` linearizable
    reads.  ``fail`` ops definitely had no effect and ``stale``/failed
    reads constrain nothing — both are excluded here (stale reads have
    their own pass)."""
    by_key: Dict[object, List[Op]] = {}
    for o in ops:
        # a still-pending write (workload stopped mid-op) is ambiguous:
        # it may have committed, so it participates with ret=+inf
        if o.kind == "w" and o.status in ("ok", "ambig", "pending"):
            by_key.setdefault(o.key, []).append(o)
        elif o.kind == "r" and o.status == "ok":
            by_key.setdefault(o.key, []).append(o)
    result = CheckResult(ok=True)
    for key in sorted(by_key, key=repr):
        kops = sorted(by_key[key], key=lambda o: (o.invoke, o.ret))
        verdict, states = _linearize_key(kops, initial, bound)
        result.states += states
        result.keys_checked += 1
        if verdict is None:
            result.bounded = True
        elif verdict is False:
            minimal = _minimize(kops, initial, bound)
            result.ok = False
            result.violations.append(
                Violation(
                    key=key,
                    reason="no linearization order exists",
                    window=_window(minimal),
                    ops=minimal,
                )
            )
    return result


def check_stale_reads(ops: Sequence[Op]) -> List[Violation]:
    """The weaker contract stale reads still owe: a returned value must
    be the initial value or some possibly-committed write invoked
    before the read returned — never a definitely-aborted proposal's
    value, never a value from the future."""
    writes = {o.value: o for o in ops if o.kind == "w"}
    out: List[Violation] = []
    for o in ops:
        if o.kind != "stale" or o.status != "ok" or o.output is None:
            continue
        w = writes.get(o.output)
        if w is None:
            out.append(
                Violation(o.key, "stale read observed a never-written value",
                          _window([o]), [o])
            )
        elif w.key != o.key:
            # values are globally unique, so a cross-key hit means the
            # register leaked another key's value
            out.append(
                Violation(o.key,
                          "stale read observed another key's value",
                          _window([w, o]), [w, o])
            )
        elif w.status == "fail":
            out.append(
                Violation(o.key,
                          "stale read observed an aborted proposal's value",
                          _window([w, o]), [w, o])
            )
        elif w.invoke > o.ret:
            out.append(
                Violation(o.key, "stale read observed a future write",
                          _window([w, o]), [w, o])
            )
    return out


def check_bounded_reads(ops: Sequence[Op]) -> List[Violation]:
    """BOUNDED_STALENESS's two promises (docs/READPLANE.md): the
    stamped staleness never exceeds the caller's bound (a read past
    the bound must SHED, not serve), and the value obeys the same
    containment stale reads owe — some possibly-committed write of
    this key invoked before the read returned, never an aborted
    proposal's value, never a value from the future.  The stamp rides
    ``op.value`` as (applied_index, staleness_ticks, bound_ticks)."""
    writes = {o.value: o for o in ops if o.kind == "w"}
    out: List[Violation] = []
    for o in ops:
        if o.kind != "bounded" or o.status != "ok":
            continue
        stamp = o.value
        if not isinstance(stamp, (tuple, list)) or len(stamp) != 3:
            out.append(
                Violation(o.key, "bounded read served without a stamp",
                          _window([o]), [o])
            )
            continue
        _applied, staleness, bound = stamp
        if staleness > bound:
            out.append(
                Violation(
                    o.key,
                    f"bounded read served PAST its bound "
                    f"(staleness {staleness} > bound {bound} ticks)",
                    _window([o]), [o],
                )
            )
        if o.output is None:
            continue
        w = writes.get(o.output)
        if w is None:
            out.append(
                Violation(o.key,
                          "bounded read observed a never-written value",
                          _window([o]), [o])
            )
        elif w.key != o.key:
            out.append(
                Violation(o.key,
                          "bounded read observed another key's value",
                          _window([w, o]), [w, o])
            )
        elif w.status == "fail":
            out.append(
                Violation(o.key,
                          "bounded read observed an aborted proposal's value",
                          _window([w, o]), [w, o])
            )
        elif w.invoke > o.ret:
            out.append(
                Violation(o.key, "bounded read observed a future write",
                          _window([w, o]), [w, o])
            )
    return out


@dataclass
class SessionReport:
    ok: bool
    problems: List[str] = field(default_factory=list)
    acked: int = 0
    applied: int = 0

    def describe(self) -> str:
        if self.ok:
            return (
                f"exactly-once: {self.acked} acked write(s) all applied "
                f"once across {self.applied} journal entr(ies)"
            )
        return "session semantics violated:\n" + "\n".join(
            f"  {p}" for p in self.problems
        )


def check_sessions(
    ops: Sequence[Op], journals: Dict[str, Sequence[tuple]]
) -> SessionReport:
    """The exactly-once pass (see module docstring).  ``journals`` maps
    a replica label to its ``[(key, value), ...]`` apply journal; only
    values present in the recorded history are judged — probe/SLA
    traffic sharing the shard is ignored."""
    report = SessionReport(ok=True)
    if not journals:
        report.ok = False
        report.problems.append("no replica journals to audit")
        return report
    labels = sorted(journals, key=lambda k: len(journals[k]))
    longest = list(journals[labels[-1]])
    report.applied = len(longest)
    for lab in labels[:-1]:
        j = list(journals[lab])
        if longest[: len(j)] != j:
            report.ok = False
            report.problems.append(
                f"replica {lab} journal is not a prefix of "
                f"{labels[-1]}'s (apply-order divergence)"
            )
    counts: Dict[object, int] = {}
    for _, v in longest:
        counts[v] = counts.get(v, 0) + 1
    for o in ops:
        if o.kind != "w":
            continue
        n = counts.get(o.value, 0)
        if o.status == "ok":
            report.acked += 1
            if n == 0:
                report.ok = False
                report.problems.append(
                    f"lost ack: acked write never applied: {o.describe()}"
                )
            elif n > 1:
                report.ok = False
                report.problems.append(
                    f"duplicate apply ({n}x): {o.describe()}"
                )
        elif o.status == "fail" and n > 0:
            report.ok = False
            report.problems.append(
                f"aborted proposal applied ({n}x): {o.describe()}"
            )
        elif o.status in ("ambig", "pending") and n > 1:
            report.ok = False
            report.problems.append(
                f"ambiguous write applied {n}x (exactly-once broken): "
                f"{o.describe()}"
            )
    return report


@dataclass
class AuditReport:
    linearizability: CheckResult
    stale: List[Violation]
    sessions: Optional[SessionReport]
    bounded: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        """The audit gate: passes only if every pass passed AND the
        linearizability search ran to completion — a bound-exhausted
        key was never actually checked, and an audit must not report
        "checked" for it.  Callers that want "no violation found,
        search possibly incomplete" read ``linearizability.ok`` and
        ``linearizability.bounded`` directly."""
        return (
            self.linearizability.ok
            and not self.linearizability.bounded
            and not self.stale
            and not self.bounded
            and (self.sessions is None or self.sessions.ok)
        )

    def describe(self) -> str:
        parts = [self.linearizability.describe()]
        if self.stale:
            parts.append("stale-read violations:")
            parts += [v.describe() for v in self.stale]
        else:
            parts.append("stale reads: ok")
        if self.bounded:
            parts.append("bounded-read violations:")
            parts += [v.describe() for v in self.bounded]
        else:
            parts.append("bounded reads: ok")
        if self.sessions is not None:
            parts.append(self.sessions.describe())
        return "\n".join(parts)


def run_audit(
    ops: Sequence[Op],
    journals: Optional[Dict[str, Sequence[tuple]]] = None,
    *,
    initial=None,
    bound: int = DEFAULT_BOUND,
) -> AuditReport:
    """The full offline audit: linearizability (leader AND follower-
    linearizable reads — both record kind "r") + stale-read pass +
    bounded-read containment + (when journals are given) the
    exactly-once session pass."""
    return AuditReport(
        linearizability=check_linearizable(ops, initial=initial, bound=bound),
        stale=check_stale_reads(ops),
        sessions=None if journals is None else check_sessions(ops, journals),
        bounded=check_bounded_reads(ops),
    )


class AuditGateError(AssertionError):
    """The audit gate failed.  ``timeline`` carries the merged
    flight-recorder/trace timeline of the audited hosts at failure
    time when any of them has observability enabled (obs/,
    docs/OBSERVABILITY.md) — the incident evidence is captured the
    moment the gate trips, not reconstructed afterwards."""

    timeline: str = ""


def assert_audit_ok(report: AuditReport, hosts=(), label: str = "audit"):
    """The audit gate with flight-recorder auto-dump: raise
    :class:`AuditGateError` unless ``report.ok``.  ``hosts`` is the
    audited cluster ({key: NodeHost} dict or iterable of NodeHosts);
    hosts with ``enable_flight_recorder``/``enable_tracing`` contribute
    their rings to the dump attached as ``exc.timeline`` (also logged,
    tail-truncated)."""
    if report.ok:
        return
    exc = AuditGateError(f"{label} gate failed:\n{report.describe()}")
    try:
        from ..obs import attach_timeline
    except Exception:  # noqa: BLE001 — the dump must not mask the verdict
        raise exc from None
    raise attach_timeline(
        exc, hosts, label=f"{label} gate failed", log=_log
    ) from None
