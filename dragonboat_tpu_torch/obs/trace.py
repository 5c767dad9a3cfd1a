"""Dependency-light request tracing: spans, annotations, Perfetto export.

reference: the reference leans on Go pprof + expvar counters for
visibility (SURVEY §5.1); counters answer "how many / how fast" but not
"where did these 4 seconds go?" for ONE proposal.  This module is the
missing half: a minimal span model (no OpenTelemetry dependency — the
container bakes nothing in) threaded through the proposal/read path

    client -> nodehost.propose -> request queue -> engine step batch
           -> raft append/replicate -> commit -> rsm apply
           -> future completion

with trace context carried inside wire messages (``pb.Message.trace_id``
/ ``span_id``; transport/wire.py encodes them) so a follower's append
span stitches into the SAME cross-host trace as the leader's proposal.

Cost contract: a disabled tracer is ``None`` on every hot object — the
hot paths pay one attribute load and a falsy test, nothing else
(verified by scripts/obs_smoke.sh's bench guard).  An enabled tracer
records into a bounded ring (old traces fall off; a tracer can run
forever without growing) and sampling (``trace_sample_rate``) bounds
the per-request cost at high rates.

Timebase: ``time.monotonic()`` — one clock per process.  All-in-one-
process clusters (the test/bench topology) merge exactly; cross-process
merges are subject to clock skew between processes (noted in
docs/OBSERVABILITY.md).
"""
from __future__ import annotations

import json
import threading
import time
import weakref
from collections import deque
from random import Random
from typing import Dict, List, Optional, Tuple


# sentinel parent for "the root made a sampling decision and the answer
# was NO" — distinct from parent=None ("no caller-held trace"), which
# lets the callee start its own root.  Without it, an unsampled
# client:propose_with_retry root would be re-sampled by nodehost.propose
# (a second independent draw, violating the sampled-once-at-the-root
# contract and inflating the effective rate).
UNSAMPLED = object()


class Span:
    """One timed operation in a trace.  ``annotate`` appends timestamped
    labels (list.append is atomic under the GIL — annotations may come
    from producer, step and apply threads); ``end`` is idempotent and
    hands the span to the tracer's ring."""

    __slots__ = (
        "tracer", "trace_id", "span_id", "parent_id", "name", "host",
        "shard_id", "start", "end_ts", "status", "annotations", "seq",
        "__weakref__",
    )

    def __init__(self, tracer, trace_id, span_id, parent_id, name,
                 host, shard_id):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.host = host
        self.shard_id = shard_id
        self.start = time.monotonic()
        self.end_ts = 0.0
        self.status = ""
        self.annotations: List[Tuple[float, str]] = []
        # finished-ring position, assigned in end() under the tracer
        # lock: the cursor remote collectors resume finished_tail by
        self.seq = 0

    def annotate(self, label: str) -> None:
        self.annotations.append((time.monotonic(), label))

    def end(self, status: str = "ok") -> None:
        # the claim must be atomic: the request path sanctions racing
        # notifies (request.py's drop_all can sweep between applied()'s
        # two lock holds) — a check-then-act here would ring the span
        # twice
        tracer = self.tracer
        with tracer._lock:
            if self.end_ts:
                return
            self.end_ts = time.monotonic()
            self.status = status
            tracer._fin_seq += 1
            self.seq = tracer._fin_seq
            tracer._live.discard(self)
            tracer._spans.append(self)

    @property
    def ended(self) -> bool:
        return self.end_ts != 0.0


class Tracer:
    """Per-NodeHost span factory + bounded finished-span ring.

    ``start_trace`` makes the per-request sampling decision (one RNG
    draw) and returns ``None`` for unsampled requests — callers
    propagate the ``None`` so the rest of the path costs nothing.
    ``start_span`` never samples: it continues a trace whose context
    arrived from elsewhere (a wire message), which was already sampled
    at its root.
    """

    def __init__(
        self,
        host: str = "",
        sample_rate: float = 1.0,
        capacity: int = 8192,
        seed: Optional[int] = None,
    ):
        self.host = host
        self.sample_rate = sample_rate
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        # open spans, weakly held: a hung request's span must show up
        # in dumps/exports (the auto-dump exists for exactly those),
        # but a span whose holder dropped it without end() must not
        # accumulate forever
        self._live: "weakref.WeakSet[Span]" = weakref.WeakSet()
        self._rng = Random(seed)
        self.started = 0
        self.unsampled = 0
        # finished-ring sequencing for remote tails (same restart-
        # detection contract as FlightRecorder.epoch/_seq)
        self._fin_seq = 0
        self.epoch = self._rng.getrandbits(63) | 1

    def _id(self) -> int:
        # caller holds self._lock.  63-bit so ids ride u64 wire fields
        # with headroom; nonzero (0 means "no trace context" on the
        # wire)
        return self._rng.getrandbits(63) | 1

    def start_trace(self, name: str, shard_id: int = 0) -> Optional[Span]:
        # one lock acquisition per root span: sampling draw, both ids,
        # counters and live-set registration all under the same hold
        # (this is the traced-propose hot path, contending with
        # Span.end from apply workers)
        with self._lock:
            if (
                self.sample_rate < 1.0
                and not self._rng.random() < self.sample_rate
            ):
                self.unsampled += 1
                return None
            self.started += 1
            s = Span(
                self, self._id(), self._id(), 0, name, self.host, shard_id
            )
            self._live.add(s)
        return s

    def start_span(
        self, name: str, trace_id: int, parent_id: int, shard_id: int = 0
    ) -> Span:
        with self._lock:
            s = Span(
                self, trace_id, self._id(), parent_id, name, self.host,
                shard_id,
            )
            self._live.add(s)
        return s

    def spans(self) -> List[Span]:
        """Finished spans (the ring) plus still-open ones — an open
        span is exported with status "open" / no span-end marker, so a
        request stuck mid-path is visible in the very dump that fires
        because it is stuck."""
        with self._lock:
            return list(self._spans) + list(self._live)

    def finished_tail(self, cursor: int = 0, *, limit: int = 256) -> dict:
        """Bounded finished-span ring slice past a client-held cursor
        (``RPC_OBS_SPANS``): the oldest ``limit`` spans ended after
        ``cursor``, serialized as plain dicts.  Mirrors
        ``FlightRecorder.tail``'s cursor/epoch/dropped contract; open
        spans are NOT included (they have no seq yet — a collector sees
        them on the poll after they end)."""
        with self._lock:
            rows = [s for s in self._spans if s.seq > cursor]
            seq = self._fin_seq
        rows.sort(key=lambda s: s.seq)
        dropped = (rows[-1].seq - cursor - len(rows)) if rows else 0
        rows = rows[:max(0, int(limit))]
        return {
            "epoch": self.epoch,
            "seq": seq,
            "next_cursor": rows[-1].seq if rows else cursor,
            "dropped": dropped,
            "spans": [
                {
                    "seq": s.seq,
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "name": s.name,
                    "host": s.host,
                    "shard_id": s.shard_id,
                    "start": s.start,
                    "end": s.end_ts,
                    "status": s.status,
                    "ann": [[ts, label] for ts, label in list(s.annotations)],
                }
                for s in rows
            ],
        }

    # -- export ----------------------------------------------------------
    def trace_events(self) -> List[dict]:
        """Chrome/Perfetto ``trace_event`` records (one complete event
        per span, one instant event per annotation).  Open either in
        ui.perfetto.dev or chrome://tracing."""
        return spans_to_trace_events(self.spans())

    def export_json(self) -> str:
        return json.dumps(
            {"traceEvents": self.trace_events(), "displayTimeUnit": "ms"}
        )


def spans_to_trace_events(spans: List[Span]) -> List[dict]:
    """The Chrome ``trace_event`` encoding shared by Tracer.export_json
    and multi-host merges: pid = host, tid = shard, ts/dur in
    microseconds of the process-wide monotonic clock."""
    out: List[dict] = []
    for s in spans:
        end = s.end_ts or time.monotonic()
        out.append(
            {
                "ph": "X",
                "name": s.name,
                "cat": "raft",
                "pid": s.host,
                "tid": f"shard-{s.shard_id}",
                "ts": s.start * 1e6,
                "dur": max(0.0, end - s.start) * 1e6,
                "args": {
                    "trace_id": f"{s.trace_id:x}",
                    "span_id": f"{s.span_id:x}",
                    "parent_id": f"{s.parent_id:x}" if s.parent_id else "",
                    "status": s.status or "open",
                },
            }
        )
        for ts, label in list(s.annotations):
            out.append(
                {
                    "ph": "i",
                    "s": "t",
                    "name": label,
                    "cat": "raft",
                    "pid": s.host,
                    "tid": f"shard-{s.shard_id}",
                    "ts": ts * 1e6,
                    "args": {"trace_id": f"{s.trace_id:x}"},
                }
            )
    return out


def export_merged_json(tracers) -> str:
    """One Perfetto file for a whole (in-process) cluster: the per-host
    pid lanes make the cross-host stitch visible as same-trace_id spans
    in different lanes."""
    events: List[dict] = []
    for t in tracers:
        if t is not None:
            events.extend(t.trace_events())
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})


def stitched_traces(tracers) -> Dict[int, List[Span]]:
    """trace_id -> spans from EVERY given tracer; a trace whose spans
    carry more than one distinct host is a cross-host stitch (the
    obs-smoke acceptance predicate)."""
    by_trace: Dict[int, List[Span]] = {}
    for t in tracers:
        if t is None:
            continue
        for s in t.spans():
            by_trace.setdefault(s.trace_id, []).append(s)
    return by_trace
