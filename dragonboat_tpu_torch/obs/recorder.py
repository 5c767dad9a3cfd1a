"""Per-shard flight recorder: fixed-size ring buffers of state
transitions, dumpable on demand and dumped automatically when a
recovery SLA trips or an audit gate fails.

reference: aviation FDR semantics — always on, bounded memory, read
AFTER the incident.  The PR 3 quiesce-parked-election liveness bug took
a bespoke harness to localize precisely because no timeline of
per-shard state existed; this is that timeline, recorded continuously:

* leader changes (``NodeHost._on_leader_updated``),
* membership ops / snapshot send + recv / log compaction (via the
  ``EventFanout`` tap — every ISystemEventListener callback),
* quiesce park / unpark (the host ticker and ``_wake_node``),
* fault-plane activations/heals and churn actions (via
  ``FaultController.install_recorder``).

Events are ``(monotonic_ts, host, shard_id, kind, detail)`` tuples in a
per-shard ``deque(maxlen=...)`` — recording is a lock + append, old
events fall off, a recorder can run for weeks.  ``shard_id 0`` is the
global lane (host-level and fault-plane events).

Internally each ring entry additionally carries a recorder-wide
monotone sequence number (assigned under the record lock) so
:meth:`FlightRecorder.tail` gives remote collectors an EXACT resume
cursor: seq gaps in a slice are events that fell off a ring, a reply
whose ``epoch`` changed (or whose seq regressed) is a restarted
process.  ``events()`` strips the seq — the public Event tuple shape
is unchanged.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from random import getrandbits
from typing import Dict, List, Optional, Tuple

Event = Tuple[float, str, int, str, str]


class FlightRecorder:
    def __init__(
        self,
        host: str = "",
        capacity: int = 256,
        global_capacity: int = 1024,
    ):
        self.host = host
        self.capacity = capacity
        self._lock = threading.Lock()
        self._rings: Dict[int, deque] = {}
        self._global: deque = deque(maxlen=global_capacity)
        self.recorded = 0
        # restart identity: a collector that sees a different epoch (or
        # a regressed seq) on the same address knows the rings belong
        # to a NEW process incarnation and resets its cursor
        self.epoch = getrandbits(63) | 1
        self._seq = 0

    def record(self, shard_id: int, kind: str, detail: str = "") -> None:
        ts = time.monotonic()
        with self._lock:
            self._seq += 1
            self.recorded += 1
            e = (self._seq, ts, self.host, int(shard_id), kind,
                 str(detail))
            if shard_id:
                ring = self._rings.get(shard_id)
                if ring is None:
                    ring = self._rings[shard_id] = deque(maxlen=self.capacity)
                ring.append(e)
            else:
                self._global.append(e)

    def events(self, shard_id: Optional[int] = None) -> List[Event]:
        """Chronological events: one shard's ring merged with the global
        lane, or every ring when ``shard_id`` is None."""
        with self._lock:
            if shard_id is None:
                out = [e[1:] for ring in self._rings.values() for e in ring]
            else:
                out = [e[1:] for e in self._rings.get(shard_id, ())]
            out.extend(e[1:] for e in self._global)
        out.sort(key=lambda e: e[0])
        return out

    def tail(self, cursor: int = 0, *, limit: int = 256) -> dict:
        """Bounded ring slice past a client-held cursor, for remote
        collectors (``RPC_OBS_RECORDER``): the oldest ``limit`` events
        whose seq is past ``cursor``, oldest first, each as
        ``[seq, ts, host, shard_id, kind, detail]``.  ``next_cursor``
        resumes the poll exactly; ``dropped`` counts seqs in the window
        that already fell off a ring (the wrap the cursor can't hide);
        ``epoch``/``seq`` let the collector detect a restarted process
        (new epoch, or seq below its cursor)."""
        with self._lock:
            rows = [e for ring in self._rings.values()
                    for e in ring if e[0] > cursor]
            rows.extend(e for e in self._global if e[0] > cursor)
            seq = self._seq
        rows.sort(key=lambda e: e[0])
        dropped = (rows[-1][0] - cursor - len(rows)) if rows else 0
        rows = rows[:max(0, int(limit))]
        return {
            "epoch": self.epoch,
            "seq": seq,
            "next_cursor": rows[-1][0] if rows else cursor,
            "dropped": dropped,
            "events": [list(e) for e in rows],
        }

    def dump(self, shard_id: Optional[int] = None) -> str:
        """Human-readable timeline (the auto-dump format)."""
        return (
            format_timeline(self.events(shard_id))
            or "(flight recorder empty)"
        )


def merged_timeline(
    recorders=(),
    tracers=(),
    shard_id: Optional[int] = None,
) -> List[Event]:
    """One chronological timeline across hosts: flight-recorder events
    merged with span starts/ends/annotations from the tracers (spans
    appear as ``span:<name>`` / ``span-end:<name>`` events).  This is
    the view the churn acceptance criterion reads: the injected
    leader-kill event lands between the victim shard's last pre-kill
    apply span and its first post-re-election commit annotation."""
    out: List[Event] = []
    for r in recorders:
        if r is not None:
            out.extend(r.events(shard_id))
    for t in tracers:
        if t is None:
            continue
        for s in t.spans():
            if shard_id is not None and s.shard_id not in (0, shard_id):
                continue
            out.append(
                (s.start, s.host, s.shard_id, f"span:{s.name}",
                 f"trace={s.trace_id:x}")
            )
            for ts, label in list(s.annotations):
                out.append(
                    (ts, s.host, s.shard_id, f"ann:{label}",
                     f"trace={s.trace_id:x}")
                )
            if s.end_ts:
                out.append(
                    (s.end_ts, s.host, s.shard_id, f"span-end:{s.name}",
                     f"trace={s.trace_id:x} status={s.status}")
                )
    out.sort(key=lambda e: e[0])
    return out


def format_timeline(events: List[Event]) -> str:
    return "\n".join(
        f"[{t:.6f}] {host} shard={sid} {kind} {detail}".rstrip()
        for t, host, sid, kind, detail in events
    )


def attach_timeline(
    exc,
    hosts,
    shard_id: Optional[int] = None,
    label: str = "",
    log=None,
) -> "BaseException":
    """The shared auto-dump: attach the merged cross-host timeline to
    ``exc.timeline`` and log an 80-line tail.  Serves both failure
    gates (``assert_recovery_sla`` violations, ``assert_audit_ok``) —
    best-effort by contract: a dump failure must never mask the verdict
    being raised, so this never raises and always returns ``exc``.
    ``hosts`` is a {key: NodeHost} dict or an iterable of NodeHosts."""
    if log is None:
        from ..logger import get_logger

        log = get_logger("obs")
    try:
        hs = hosts.values() if hasattr(hosts, "values") else hosts
        text = hosts_timeline(hs, shard_id=shard_id)
    except Exception:  # noqa: BLE001 — observability is best-effort
        log.exception("flight-recorder auto-dump failed")
        return exc
    if text:
        exc.timeline = text
        tail = "\n".join(text.splitlines()[-80:])
        log.error(
            "%s — flight-recorder timeline (tail):\n%s",
            label or type(exc).__name__, tail,
        )
    return exc


def record_all(hosts, shard_id: int, kind: str, detail: str = "") -> None:
    """Stamp one marker event into EVERY given host's flight recorder
    (hosts without a recorder contribute nothing; never raises — same
    best-effort contract as :func:`attach_timeline`).  The scenario
    orchestrator uses this for phase boundaries: a post-incident dump
    must show WHICH production-day phase the cluster was in when the
    state transitions around the failure happened (docs/SCENARIO.md)."""
    hs = hosts.values() if hasattr(hosts, "values") else hosts
    for nh in hs:
        rec = getattr(nh, "recorder", None)
        if rec is None:
            continue
        try:
            rec.record(shard_id, kind, detail)
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass


def hosts_timeline(hosts, shard_id: Optional[int] = None) -> str:
    """The auto-dump entry point (``assert_recovery_sla`` violations,
    audit-gate failures): one formatted cross-host timeline from every
    given NodeHost's flight recorder AND tracer.  Hosts with
    observability disabled contribute nothing; with it disabled
    everywhere the result is the empty string (callers skip logging)."""
    recorders = [getattr(nh, "recorder", None) for nh in hosts]
    tracers = [getattr(nh, "tracer", None) for nh in hosts]
    if not any(r is not None for r in recorders) and not any(
        t is not None for t in tracers
    ):
        return ""
    return format_timeline(
        merged_timeline(recorders=recorders, tracers=tracers,
                        shard_id=shard_id)
    )
