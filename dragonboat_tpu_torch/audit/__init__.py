"""Churn-nemesis linearizability audit harness.

reference: Jepsen's nemesis + offline-checker methodology (Knossos /
Porcupine lineage) and dragonboat's drummer harness [U].  The chaos
suite's invariants (acked writes survive, replicas agree) say a shaken
cluster *recovers*; this package checks the stronger claim — that the
histories clients actually observe while the cluster is being broken
are **linearizable**, and that registered-session retries are
**exactly-once** across ambiguous timeouts.

Three pieces:

* :mod:`.history` — an instrumented client (``AuditClient``) wrapping
  ``Session``-based ``sync_propose`` / ``sync_read`` / ``stale_read``
  that logs invoke/ok/fail/ambiguous events into a concurrent
  ``HistoryRecorder`` (timeouts are *ambiguous*: "maybe committed");
* :mod:`.model` — ``AuditKV``, the journaled kv/register state machine
  the audited cluster runs, plus the pure replay model;
* :mod:`.checker` — the offline checker: per-key Wing–Gong
  linearizability search with a bounded-search escape hatch and a
  minimal failing-window report, a stale-read pass, a bounded-read
  containment pass (readplane: stamped staleness never exceeds the
  bound, docs/READPLANE.md), and the exactly-once session pass over
  replica apply journals.

The churn nemesis itself (scheduled leader kills / transfers /
membership churn / balancer moves) is the ``churn`` plane of
:class:`dragonboat_tpu.faults.FaultController` — see docs/AUDIT.md and
docs/FAULTS.md.
"""
from .checker import (
    AuditGateError,
    AuditReport,
    CheckResult,
    Violation,
    assert_audit_ok,
    check_bounded_reads,
    check_linearizable,
    check_sessions,
    check_stale_reads,
    run_audit,
)
from .history import AuditClient, HistoryRecorder, Op
from .model import AuditKV, audit_set_cmd, collect_journals, settle_journals

__all__ = [
    "AuditClient",
    "AuditGateError",
    "AuditKV",
    "AuditReport",
    "assert_audit_ok",
    "CheckResult",
    "HistoryRecorder",
    "Op",
    "Violation",
    "audit_set_cmd",
    "check_bounded_reads",
    "check_linearizable",
    "check_sessions",
    "check_stale_reads",
    "collect_journals",
    "run_audit",
    "settle_journals",
]
