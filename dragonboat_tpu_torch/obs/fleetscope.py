"""Fleet scope: the cross-process telemetry plane
(docs/OBSERVABILITY.md "Fleet scope").

reference: dragonboat ships fleet-level visibility via
``raftio.ISystemEventListener`` + per-NodeHost metrics because
multi-process Raft is undebuggable without a merged view; Dapper-style
context propagation answers the RPC boundary.  This module is both
halves for the PR 16-18 fleet:

* :class:`ObsService` — the server side of ``RPC_OP_OBS``
  (gateway/rpc.py dispatches here): ``metrics_snapshot`` (structured
  :meth:`~dragonboat_tpu.metrics.MetricsRegistry.snapshot`, tagged
  with host/pid/uptime), ``recorder_tail`` and ``trace_spans``
  (bounded ring slices past a client-held cursor — every slice passes
  an EXPLICIT limit; raftlint's obs-bound rule bans unbounded
  replies).
* :class:`FleetScope` — the collector: polls every fleet process
  (remote handles over the wire, in-proc hosts directly), rebases
  remote monotonic timestamps onto the collector's clock, merges
  recorder events + span starts/ends into ONE cross-process timeline
  (reusing :func:`~.recorder.merged_timeline`'s interleave), survives
  process death by keeping the dead process's last tail and stamping
  the gap (``obs_gap``/``obs_gap_end`` marker events), detects
  restarts by epoch change / sequence regression, and turns per-poll
  metric deltas into :mod:`.slo` burn-rate rows
  (:meth:`FleetScope.slo_report`).

Degrade matrix: a process answering ``RPC_ERR "unknown op 7"``
predates the obs surface — the scope marks it ``no_obs`` and the rest
of the fleet still merges; a process that stops answering at all keeps
its last tail with the gap marked.  Everything here is best-effort
observability: no poll failure ever propagates into the planes being
observed.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..logger import get_logger
from . import slo as slo_mod
from .recorder import Event, format_timeline, merged_timeline

_log = get_logger("obs")


class ObsUnsupported(Exception):
    """The polled process predates RPC_OP_OBS (old server binary)."""


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------
class ObsService:
    """Answers the three obs queries for ONE process's NodeHost.

    Works against anything exposing the NodeHost obs surface
    (``metrics``/``recorder``/``tracer`` attributes, any of them
    optional) — the RpcServer binds one per ingress, the FleetScope
    wraps one directly for in-proc targets.  Every reply is tagged with
    the process identity (host/nhid/pid/uptime) plus ``mono``, the
    server's monotonic clock at snapshot time, which the collector uses
    to rebase remote timestamps (cross-process clocks don't share an
    origin)."""

    def __init__(self, nh):
        self._nh = nh
        self._t0 = time.monotonic()

    def _identity(self) -> dict:
        nh = self._nh
        host = ""
        fn = getattr(nh, "raft_address", None)
        if callable(fn):
            try:
                host = fn() or ""
            except Exception:  # noqa: BLE001 — identity is best-effort
                host = ""
        if not host:
            host = str(getattr(nh, "host", "") or "")
        up = getattr(nh, "uptime_s", None)
        if not isinstance(up, (int, float)):
            up = time.monotonic() - self._t0
        return {
            "host": host,
            "nhid": str(getattr(nh, "nodehost_id", "") or ""),
            "pid": os.getpid(),
            "uptime_s": round(float(up), 3),
            "mono": time.monotonic(),
        }

    def metrics_snapshot(self) -> dict:
        out = self._identity()
        m = getattr(self._nh, "metrics", None)
        snap = getattr(m, "snapshot", None)
        out["metrics"] = snap() if callable(snap) else {}
        return out

    def recorder_tail(self, cursor: int, *, limit: int) -> dict:
        out = self._identity()
        rec = getattr(self._nh, "recorder", None)
        if rec is None:
            out.update({"enabled": False, "epoch": 0, "seq": 0,
                        "next_cursor": cursor, "dropped": 0, "events": []})
            return out
        out["enabled"] = True
        out.update(rec.tail(cursor, limit=limit))
        return out

    def trace_spans(self, cursor: int, *, limit: int) -> dict:
        out = self._identity()
        tr = getattr(self._nh, "tracer", None)
        if tr is None:
            out.update({"enabled": False, "epoch": 0, "seq": 0,
                        "next_cursor": cursor, "dropped": 0, "spans": []})
            return out
        out["enabled"] = True
        out.update(tr.finished_tail(cursor, limit=limit))
        return out


# ---------------------------------------------------------------------------
# collector side
# ---------------------------------------------------------------------------
class SpanRecord:
    """A finished span as collected over the wire — duck-types exactly
    what :func:`~.recorder.merged_timeline` and the stitch predicates
    read off a live :class:`~.trace.Span` (start/end_ts in COLLECTOR
    monotonic time after rebase)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "host",
                 "shard_id", "start", "end_ts", "status", "annotations",
                 "seq")

    def __init__(self, d: dict, offset: float):
        self.trace_id = int(d.get("trace_id", 0))
        self.span_id = int(d.get("span_id", 0))
        self.parent_id = int(d.get("parent_id", 0))
        self.name = str(d.get("name", ""))
        self.host = str(d.get("host", ""))
        self.shard_id = int(d.get("shard_id", 0))
        self.start = float(d.get("start", 0.0)) + offset
        end = float(d.get("end", 0.0))
        self.end_ts = end + offset if end else 0.0
        self.status = str(d.get("status", ""))
        self.annotations: List[Tuple[float, str]] = [
            (float(ts) + offset, str(label))
            for ts, label in d.get("ann", ())
        ]
        self.seq = int(d.get("seq", 0))


class _EventsView:
    """FlightRecorder-shaped view over already-collected events, so the
    fleet merge genuinely reuses recorder.merged_timeline."""

    def __init__(self, events: List[Event]):
        self._events = events

    def events(self, shard_id: Optional[int] = None) -> List[Event]:
        if shard_id is None:
            return list(self._events)
        return [e for e in self._events if e[2] in (0, shard_id)]


class _SpansView:
    """Tracer-shaped view over collected SpanRecords (same reuse)."""

    def __init__(self, spans: List[SpanRecord]):
        self._spans = spans

    def spans(self) -> List[SpanRecord]:
        return list(self._spans)


class _RemoteTarget:
    """Adapter over a RemoteHostHandle's ``obs_query`` method family."""

    def __init__(self, handle):
        self._h = handle

    def metrics(self) -> dict:
        return self._h.obs_query("metrics")

    def recorder_tail(self, cursor: int, *, limit: int) -> dict:
        return self._h.obs_query("recorder", cursor=cursor, limit=limit)

    def trace_spans(self, cursor: int, *, limit: int) -> dict:
        return self._h.obs_query("spans", cursor=cursor, limit=limit)


class _LocalTarget:
    """Adapter over an in-proc NodeHost (or anything with the obs
    attribute surface) — the in-proc production day's path."""

    def __init__(self, nh):
        self._svc = ObsService(nh)

    def metrics(self) -> dict:
        return self._svc.metrics_snapshot()

    def recorder_tail(self, cursor: int, *, limit: int) -> dict:
        return self._svc.recorder_tail(cursor, limit=limit)

    def trace_spans(self, cursor: int, *, limit: int) -> dict:
        return self._svc.trace_spans(cursor, limit=limit)


class _ProcScope:
    """Per-process collector state: cursors, epochs, the kept tail."""

    def __init__(self, key: str, target, keep: int):
        self.key = key
        self.target = target
        self.no_obs = False
        self.dead = False
        self.gap_open = False
        self.restarts = 0
        self.rec_epoch = 0
        self.rec_cursor = 0
        self.span_epoch = 0
        self.span_cursor = 0
        self.offset = 0.0
        self.identity: dict = {}
        self.prev: Optional[dict] = None
        self.last: Optional[dict] = None
        # the kept tails are bounded like the rings they mirror; a dead
        # process's tail stays here — that survival is the point
        self.events: List[Event] = []
        self.spans: List[SpanRecord] = []
        self._keep = keep

    def _trim(self) -> None:
        if len(self.events) > self._keep:
            del self.events[:len(self.events) - self._keep]
        if len(self.spans) > self._keep:
            del self.spans[:len(self.spans) - self._keep]

    @property
    def host(self) -> str:
        return str(self.identity.get("host") or self.key)


class FleetScope:
    """The fleet collector (see module docstring).

    ``add_process`` accepts a RemoteHostHandle (polled over
    ``RPC_OP_OBS``) or an in-proc NodeHost-like object (polled
    directly) — a mixed fleet (networked workers + the parent's own
    gateway process) merges into one timeline.  ``poll()`` is one
    sweep; ``start_poller`` runs it on an interval.  Collector marks
    (:meth:`mark`) land on the timeline AND on the poll window that
    closes over them, which is how a kill window gets attributed to
    the SLO rows that burned during it."""

    def __init__(self, *, limit: int = 256, keep: int = 4096,
                 objectives=None, max_windows: int = 1024):
        self._limit = limit
        self._keep = keep
        self._objectives = objectives
        self._max_windows = max_windows
        self._lock = threading.RLock()
        self._procs: Dict[str, _ProcScope] = {}
        self._pending_marks: List[Event] = []
        self.marks: List[Event] = []
        self.windows: List[dict] = []
        self.polls = 0
        self.reply_bytes = 0
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None

    # -- membership -------------------------------------------------------
    def add_process(self, key: str, target) -> None:
        """Register one fleet process.  ``target``: RemoteHostHandle
        (has ``obs_query``) or an in-proc NodeHost-like object."""
        adapter = (
            _RemoteTarget(target) if hasattr(target, "obs_query")
            else _LocalTarget(target)
        )
        with self._lock:
            self._procs[key] = _ProcScope(key, adapter, self._keep)

    def mark(self, kind: str, detail: str = "") -> None:
        """Stamp a collector-lane marker (phase boundary, kill window)
        onto the merged timeline and the current poll window."""
        e: Event = (time.monotonic(), "fleetscope", 0, str(kind),
                    str(detail))
        with self._lock:
            self.marks.append(e)
            self._pending_marks.append(e)

    # -- polling ----------------------------------------------------------
    def poll(self) -> dict:
        """One sweep over every process: metrics deltas, recorder and
        span tails, gap/restart bookkeeping.  Never raises — a dead or
        obs-less process is recorded, not fatal."""
        t0 = time.monotonic()
        with self._lock:
            procs = list(self._procs.values())
            marks, self._pending_marks = self._pending_marks, []
        deltas: Dict[str, dict] = {}
        polled = dead = 0
        for p in procs:
            try:
                self._poll_one(p)
            except ObsUnsupported:
                if not p.no_obs:
                    p.no_obs = True
                    _log.warning(
                        "fleetscope: %s predates the obs op (no-obs)",
                        p.key,
                    )
                continue
            except Exception as e:  # noqa: BLE001 — dead/unreachable
                self._mark_gap(p, e)
                dead += 1
                continue
            polled += 1
            d = _metrics_delta(p.prev, p.last)
            if d:
                deltas[p.key] = d
        window = {
            "t0": t0,
            "t1": time.monotonic(),
            "marks": [list(m) for m in marks],
            "deltas": deltas,
        }
        with self._lock:
            self.windows.append(window)
            if len(self.windows) > self._max_windows:
                del self.windows[:len(self.windows) - self._max_windows]
            self.polls += 1
        return {
            "polled": polled,
            "dead": dead,
            "no_obs": sum(1 for p in procs if p.no_obs),
        }

    def _poll_one(self, p: _ProcScope) -> None:
        t_req = time.monotonic()
        m = p.target.metrics()
        t_resp = time.monotonic()
        self._count_bytes(m)
        # rebase: the remote stamped its monotonic clock between our
        # request and its reply — the midpoint estimate bounds the
        # offset error at half the RTT
        remote_mono = float(m.get("mono", 0.0) or 0.0)
        p.offset = ((t_req + t_resp) / 2.0 - remote_mono
                    if remote_mono else 0.0)
        p.identity = {
            k: m.get(k) for k in ("host", "nhid", "pid", "uptime_s")
        }
        if p.gap_open:
            p.gap_open = False
            p.events.append((
                time.monotonic(), p.host, 0, "obs_gap_end",
                f"pid={m.get('pid')} uptime={m.get('uptime_s')}s",
            ))
        p.dead = False

        rt = p.target.recorder_tail(p.rec_cursor, limit=self._limit)
        self._count_bytes(rt)
        if rt.get("enabled", True) and rt.get("epoch"):
            if p.rec_epoch and (
                rt["epoch"] != p.rec_epoch
                or int(rt.get("seq", 0)) < p.rec_cursor
            ):
                # restarted process: fresh rings under the same address
                # — note it, reset the cursor and take the new tail
                # from its beginning
                p.restarts += 1
                p.events.append((
                    time.monotonic(), p.host, 0, "obs_restart",
                    f"epoch {p.rec_epoch:x}->{int(rt['epoch']):x}",
                ))
                p.rec_cursor = 0
                rt = p.target.recorder_tail(0, limit=self._limit)
                self._count_bytes(rt)
            p.rec_epoch = int(rt["epoch"])
            if rt.get("dropped"):
                p.events.append((
                    time.monotonic(), p.host, 0, "obs_dropped",
                    f"{rt['dropped']} events fell off the ring between "
                    f"polls",
                ))
            for row in rt.get("events", ()):
                _seq, ts, host, sid, kind, detail = row
                p.events.append((
                    float(ts) + p.offset, str(host), int(sid), str(kind),
                    str(detail),
                ))
            p.rec_cursor = int(rt.get("next_cursor", p.rec_cursor))

        st = p.target.trace_spans(p.span_cursor, limit=self._limit)
        self._count_bytes(st)
        if st.get("enabled", True) and st.get("epoch"):
            if p.span_epoch and (
                st["epoch"] != p.span_epoch
                or int(st.get("seq", 0)) < p.span_cursor
            ):
                p.span_cursor = 0
                st = p.target.trace_spans(0, limit=self._limit)
                self._count_bytes(st)
            p.span_epoch = int(st["epoch"])
            for d in st.get("spans", ()):
                p.spans.append(SpanRecord(d, p.offset))
            p.span_cursor = int(st.get("next_cursor", p.span_cursor))

        p.prev, p.last = p.last, m
        p._trim()

    def _count_bytes(self, reply: dict) -> None:
        n = reply.pop("bytes", 0) if isinstance(reply, dict) else 0
        if n:
            self.reply_bytes += int(n)

    def _mark_gap(self, p: _ProcScope, exc: BaseException) -> None:
        p.dead = True
        if not p.gap_open:
            p.gap_open = True
            p.events.append((
                time.monotonic(), p.host, 0, "obs_gap",
                f"poll failed: {type(exc).__name__}: {exc}",
            ))

    # -- background poller ------------------------------------------------
    def start_poller(self, interval: float = 0.25) -> None:
        def _main() -> None:
            while not self._stop.wait(interval):
                try:
                    self.poll()
                except Exception:  # noqa: BLE001 — observability is
                    # best-effort; the poller must outlive a bad sweep
                    _log.exception("fleetscope poll failed")

        t = threading.Thread(target=_main, daemon=True,
                             name="tpu-fleetscope")
        self._poller = t
        t.start()

    def close(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=2.0)
            self._poller = None

    # -- merged views -----------------------------------------------------
    def merged_timeline(self, shard_id: Optional[int] = None) -> List[Event]:
        """ONE chronological timeline across every polled process —
        recorder events interleaved with span start/end pseudo-events
        via recorder.merged_timeline, collector marks included.  Dead
        processes contribute their last collected tail plus the
        ``obs_gap`` marker (the acceptance view: the SIGKILLed
        leader's silence sits between its last pre-kill events and the
        survivors' re-election)."""
        with self._lock:
            recs = [_EventsView(list(p.events))
                    for p in self._procs.values()]
            recs.append(_EventsView(list(self.marks)))
            trs = [_SpansView(list(p.spans))
                   for p in self._procs.values()]
        return merged_timeline(recorders=recs, tracers=trs,
                               shard_id=shard_id)

    def dump(self, shard_id: Optional[int] = None) -> str:
        return (
            format_timeline(self.merged_timeline(shard_id))
            or "(fleet scope empty)"
        )

    def stitched_traces(self) -> Dict[int, List[SpanRecord]]:
        """trace_id -> collected spans across every process (the
        cross-process analogue of trace.stitched_traces)."""
        by: Dict[int, List[SpanRecord]] = {}
        with self._lock:
            spans = [s for p in self._procs.values() for s in p.spans]
        for s in spans:
            by.setdefault(s.trace_id, []).append(s)
        return by

    def cross_process_stitches(self) -> int:
        """Traces whose spans span >1 distinct host — the smoke's
        acceptance predicate for RPC trace stitching."""
        return sum(
            1 for spans in self.stitched_traces().values()
            if len({s.host for s in spans}) > 1
        )

    # -- reports ----------------------------------------------------------
    def proc_report(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "key": p.key,
                    "host": p.host,
                    "pid": p.identity.get("pid"),
                    "no_obs": p.no_obs,
                    "dead": p.dead,
                    "restarts": p.restarts,
                    "events": len(p.events),
                    "spans": len(p.spans),
                }
                for p in self._procs.values()
            ]

    def slo_report(self, objectives=None) -> List[dict]:
        """Burn-rate rows over every poll window so far (obs/slo.py);
        the scenario runners attach these to the DayReport."""
        with self._lock:
            windows = list(self.windows)
        return slo_mod.evaluate(
            windows,
            objectives=(objectives if objectives is not None
                        else self._objectives),
        )


def _metrics_delta(prev: Optional[dict], cur: Optional[dict]) -> dict:
    """Window delta between two tagged metric snapshots: monotone
    series (counters, histogram count/sum/buckets) are differenced,
    gauges carried as levels.  Zero-delta series are omitted so a
    quiet window costs almost nothing to keep."""
    if not cur:
        return {}
    pm = (prev or {}).get("metrics") or {}
    cm = cur.get("metrics") or {}
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    pc = pm.get("counters") or {}
    for name, e in (cm.get("counters") or {}).items():
        d = e.get("value", 0) - (pc.get(name) or {}).get("value", 0)
        if d:
            out["counters"][name] = d
    for name, e in (cm.get("gauges") or {}).items():
        out["gauges"][name] = e.get("value", 0.0)
    ph = pm.get("histograms") or {}
    for name, e in (cm.get("histograms") or {}).items():
        pe = ph.get(name) or {}
        count_d = e.get("count", 0) - pe.get("count", 0)
        if not count_d:
            continue
        pb = pe.get("buckets") or [0] * len(e.get("buckets") or ())
        out["histograms"][name] = {
            "bounds": list(e.get("bounds") or ()),
            "buckets": [
                c - p for c, p in zip(e.get("buckets") or (), pb)
            ],
            "count": count_d,
            "sum": e.get("sum", 0.0) - pe.get("sum", 0.0),
        }
    return out if any(out.values()) else {}
