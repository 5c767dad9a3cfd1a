"""Transport core: per-target async send queues, batch coalescing and a
circuit breaker, over any pluggable ITransport.

reference: internal/transport/transport.go (+ job.go) [U].  The raft step
path calls ``send(msg)`` which never blocks: messages go to a bounded
per-target queue drained by a sender thread that coalesces them into one
``MessageBatch`` per wakeup.  Send failures trip a per-target breaker and
surface as ReportUnreachableNode so leaders back off (reference: circuit
breaker util [U]).
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from .. import settings
from ..bigstate.pacing import TokenBucket
from ..logger import get_logger
from ..pb import Message, MessageBatch, MessageType
from ..raftio import ITransport

_log = get_logger("transport")

# breaker states (exported as a gauge value: 0=closed 1=half-open 2=open)
_CLOSED, _HALF_OPEN, _OPEN = 0, 1, 2
_STATE_NAMES = {_CLOSED: "closed", _HALF_OPEN: "half-open", _OPEN: "open"}


class _Breaker:
    """Circuit breaker with exponential backoff and half-open probing.

    Opens after ``threshold`` consecutive failures.  After a jittered
    cooldown, ``ready()`` admits exactly ONE probe batch (half-open); a
    probe success closes the breaker and resets the cooldown, a probe
    failure reopens it with the cooldown doubled (capped) — so a peer
    that stays dead costs geometrically fewer connection attempts,
    while a healed peer is rediscovered within one cooldown.  The
    jitter desynchronizes many senders probing one recovered peer.

    Single-threaded per target (only its sender thread touches it);
    the metrics accessors read plain ints/floats, safe under the GIL.
    """

    def __init__(
        self,
        threshold: int = 3,
        cooldown: float = 0.5,
        max_cooldown: float = 10.0,
        jitter: float = 0.25,
        rng: Optional[random.Random] = None,
    ):
        self.threshold = threshold
        self.base_cooldown = cooldown
        self.max_cooldown = max_cooldown
        self.jitter = jitter
        self._rng = rng or random.Random()
        self.failures = 0
        self.state = _CLOSED
        self.opened_at = 0.0
        self.cooldown = cooldown
        self._wait = cooldown  # jittered effective cooldown
        # per-target observability (surfaced through metrics.py)
        self.open_count = 0
        self._open_seconds = 0.0  # completed open/half-open intervals

    def ready(self) -> bool:
        if self.state == _CLOSED:
            return True
        if self.state == _OPEN:
            if time.monotonic() - self.opened_at >= self._wait:
                self.state = _HALF_OPEN
                return True  # the one probe
            return False
        return False  # half-open: probe already in flight

    def success(self) -> None:
        if self.state != _CLOSED:
            self._open_seconds += time.monotonic() - self.opened_at
        self.state = _CLOSED
        self.failures = 0
        self.cooldown = self.base_cooldown

    def failure(self) -> None:
        self.failures += 1
        if self.state == _HALF_OPEN:
            # probe failed: back off exponentially
            self.cooldown = min(self.cooldown * 2.0, self.max_cooldown)
            self._reopen(accumulate=True)
        elif self.state == _CLOSED and self.failures >= self.threshold:
            self.cooldown = self.base_cooldown
            self._reopen(accumulate=False)

    def _reopen(self, accumulate: bool) -> None:
        now = time.monotonic()
        if accumulate:
            self._open_seconds += now - self.opened_at
        self.state = _OPEN
        self.open_count += 1
        self.opened_at = now
        self._wait = self.cooldown * (
            1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        )

    # -- metrics ----------------------------------------------------------
    def state_name(self) -> str:
        return _STATE_NAMES[self.state]

    def open_seconds(self) -> float:
        """Total time spent open/half-open, including a current stint."""
        if self.state == _CLOSED:
            return self._open_seconds
        return self._open_seconds + (time.monotonic() - self.opened_at)


class _SendQueue:
    def __init__(self, maxlen: int):
        self.q: deque = deque()
        self.maxlen = maxlen
        self.cond = threading.Condition()
        self.closed = False


class Transport:
    """The messaging service shared by all shards of a NodeHost."""

    def __init__(
        self,
        raw: ITransport,
        resolver: Callable[[int, int], Optional[str]],
        source_address: str,
        deployment_id: int = 0,
        unreachable_cb: Optional[Callable[[Message], None]] = None,
        snapshot_source_opener: Optional[Callable[[object], object]] = None,
        snapshot_status_cb: Optional[Callable[[int, int, bool], None]] = None,
        max_snapshot_send_bytes_per_second: int = 0,
        metrics_registry=None,
        stream_event_cb: Optional[Callable[[int, str, str], None]] = None,
    ):
        self.raw = raw
        self.resolver = resolver
        self.source_address = source_address
        self.deployment_id = deployment_id
        self.unreachable_cb = unreachable_cb
        # opens a leased incremental reader over the snapshot dir; ALL
        # payload reads happen on the stream-job thread, never on the
        # step worker (storage/snapshotter.SnapshotSource)
        self.snapshot_source_opener = snapshot_source_opener
        # (shard_id, to_replica, failed) -> report to the sending raft peer
        self.snapshot_status_cb = snapshot_status_cb
        self.max_snapshot_send_rate = max_snapshot_send_bytes_per_second
        # ONE bucket shared by every stream job: the cap bounds this
        # host's aggregate snapshot egress, not each stream's (N
        # concurrent catch-ups used to multiply the cap N-fold).  The
        # bucket is live-retunable (set_snapshot_send_rate / the
        # bigstate.pacing.CapFeedback loop).
        self.snapshot_pacer: Optional[TokenBucket] = (
            TokenBucket(max_snapshot_send_bytes_per_second)
            if max_snapshot_send_bytes_per_second > 0
            else None
        )
        # throttle seconds of DISCARDED buckets: the *_total metric must
        # stay monotone across cap off->on transitions (a counter that
        # resets breaks every rate()/delta consumer)
        self._stream_throttled_base = 0.0
        # (shard_id, kind, detail) -> flight-recorder lane (nodehost)
        self.stream_event_cb = stream_event_cb
        self._stream_jobs = 0
        self._stream_lock = threading.Lock()
        self._queues: Dict[str, _SendQueue] = {}
        self._breakers: Dict[str, _Breaker] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        self._stopped = False
        self.metrics = {
            "sent": 0, "dropped": 0, "failed": 0, "snapshots_sent": 0,
            # the snapshot_stream_* surface (docs/BIGSTATE.md): chunk and
            # byte egress, resume events (a retry that continued from a
            # non-zero receiver cursor instead of restarting), and the
            # cumulative seconds the bandwidth cap held senders back
            "stream_chunks": 0, "stream_bytes": 0, "stream_resumes": 0,
        }
        self._metrics_registry = metrics_registry
        # the unified fault plane (faults.FaultController); propagated
        # to the raw ITransport so every outbound batch/chunk crosses it
        self.fault_injector = None

    def set_fault_injector(self, injector) -> None:
        self.fault_injector = injector
        self.raw.fault_injector = injector
        # fault plans target raft addresses; make the raw transport
        # report that identity (not its bind address) to on_wire
        self.raw.fault_source = self.source_address

    def start(self) -> None:
        self.raw.start()

    def close(self) -> None:
        self._stopped = True
        with self._lock:
            queues = list(self._queues.values())
        for sq in queues:
            with sq.cond:
                sq.closed = True
                sq.cond.notify_all()
        for t in list(self._threads.values()):
            t.join(timeout=2.0)
        self.raw.close()

    # -- send path --------------------------------------------------------
    def send(self, m: Message) -> bool:
        """Non-blocking enqueue; False if the message was dropped."""
        if self._stopped:
            return False
        if m.type == MessageType.INSTALL_SNAPSHOT:
            return self.send_snapshot(m)
        target = self.resolver(m.shard_id, m.to)
        if target is None:
            self.metrics["dropped"] += 1
            return False
        sq = self._get_queue(target)
        with sq.cond:
            if sq.closed or len(sq.q) >= sq.maxlen:
                self.metrics["dropped"] += 1
                full = not sq.closed
            else:
                sq.q.append(m)
                sq.cond.notify()
                return True
        if full:
            # a full queue means the peer isn't draining: report it
            # unreachable so the leader backs off (silently dropping
            # here left congested peers hammered at full rate)
            self._notify_unreachable([m])
        return False

    def _get_queue(self, target: str) -> _SendQueue:
        with self._lock:
            sq = self._queues.get(target)
            if sq is None:
                sq = _SendQueue(settings.Soft.send_queue_length)
                self._queues[target] = sq
                self._breakers[target] = b = _Breaker()
                self._register_breaker_metrics(target, b)
                t = threading.Thread(
                    target=self._sender_main,
                    args=(target, sq),
                    daemon=True,
                    name=f"tpu-raft-send-{target}",
                )
                self._threads[target] = t
                t.start()
            return sq

    def _register_breaker_metrics(self, target: str, b: _Breaker) -> None:
        """Per-target breaker observability: state, open transitions and
        cumulative time-in-open, labelled by target (chaos runs watch
        these to see breaker flaps)."""
        reg = self._metrics_registry
        if reg is None:
            return
        labels = {"target": target}
        reg.gauge(
            "raft_transport_breaker_state", lambda b=b: b.state, labels=labels
        )
        reg.gauge(
            "raft_transport_breaker_opens_total",
            lambda b=b: b.open_count,
            labels=labels,
        )
        reg.gauge(
            "raft_transport_breaker_open_seconds_total",
            lambda b=b: b.open_seconds(),
            labels=labels,
        )

    def breaker_stats(self) -> Dict[str, Dict]:
        """Snapshot of every per-target breaker (tests + debugging)."""
        with self._lock:
            breakers = dict(self._breakers)
        return {
            t: {
                "state": b.state_name(),
                "failures": b.failures,
                "open_count": b.open_count,
                "open_seconds": b.open_seconds(),
                "cooldown": b.cooldown,
            }
            for t, b in breakers.items()
        }

    def _sender_main(self, target: str, sq: _SendQueue) -> None:
        breaker = self._breakers[target]
        conn = None
        while True:
            with sq.cond:
                while not sq.q and not sq.closed:
                    sq.cond.wait(timeout=1.0)
                    if self._stopped:
                        return
                if sq.closed and not sq.q:
                    return
                msgs = list(sq.q)
                sq.q.clear()
            if not breaker.ready():
                self.metrics["dropped"] += len(msgs)
                self._notify_unreachable(msgs)
                continue
            batch = MessageBatch(
                messages=tuple(msgs),
                source_address=self.source_address,
                deployment_id=self.deployment_id,
            )
            try:
                if conn is None:
                    conn = self.raw.get_connection(target)
                conn.send_message_batch(batch)
                breaker.success()
                self.metrics["sent"] += len(msgs)
            except Exception as e:  # noqa: BLE001 — any transport error
                _log.debug("send to %s failed: %s", target, e)
                breaker.failure()
                self.metrics["failed"] += len(msgs)
                conn = None
                self._notify_unreachable(msgs)

    # -- snapshot lane ----------------------------------------------------
    def send_snapshot(self, m: Message) -> bool:
        """Stream a snapshot to the target over the chunk lane
        (reference: Transport.SendSnapshot -> stream job [U]).

        NOTHING is read on the calling step worker: the job thread opens
        a ``SnapshotSource`` (which takes a storage GC lease) and reads
        the container incrementally, one chunk in memory at a time — a
        snapshot far larger than RAM streams fine and the step worker's
        stall is bounded by a thread spawn (reference: job.go incremental
        chunk reads [U]).
        """
        if self._stopped:
            return False
        target = self.resolver(m.shard_id, m.to)
        if target is None:
            self._snapshot_failed(m)
            return False
        with self._stream_lock:
            if self._stream_jobs >= settings.Soft.max_concurrent_streaming_snapshots:
                self._snapshot_failed(m)
                return False
            self._stream_jobs += 1
        t = threading.Thread(
            target=self._stream_job,
            args=(m, target),
            daemon=True,
            name=f"tpu-raft-snapshot-{target}",
        )
        t.start()
        return True

    def set_snapshot_send_rate(self, rate: int) -> None:
        """Retune the shared stream cap at runtime (the CapFeedback
        loop's knob; 0/negative removes the cap).  In-flight streams
        pick the new rate up at their next chunk."""
        self.max_snapshot_send_rate = rate
        if rate > 0:
            if self.snapshot_pacer is None:
                self.snapshot_pacer = TokenBucket(rate)
            else:
                self.snapshot_pacer.set_rate(rate)
        elif self.snapshot_pacer is not None:
            # keep the *_total throttle counter monotone past the
            # bucket's retirement
            self._stream_throttled_base += self.snapshot_pacer.throttled_seconds
            self.snapshot_pacer = None

    def active_stream_jobs(self) -> int:
        """Snapshot stream jobs currently in flight (the
        snapshot_stream_active gauge source; public accessor so
        consumers like the balance executor's catchup progress report
        don't reach into the private counter)."""
        return self._stream_jobs

    def stream_throttled_seconds(self) -> float:
        """Cumulative cap-induced sleep across ALL buckets this
        transport ever ran (the snapshot_stream_throttle_seconds_total
        gauge source — monotone even when the cap is toggled)."""
        p = self.snapshot_pacer
        return self._stream_throttled_base + (
            p.throttled_seconds if p is not None else 0.0
        )

    def _stream_event(self, shard_id: int, kind: str, detail: str) -> None:
        cb = self.stream_event_cb
        if cb is None:
            return
        try:
            cb(shard_id, kind, detail)
        except Exception:  # noqa: BLE001 — observability must not
            # break the stream job
            _log.exception("stream event callback raised")

    def _stream_job(self, m: Message, target: str) -> None:
        """One stream job with BOUNDED retry: a transient failure (peer
        restarting, a fault window, one torn connection) RESUMES after a
        short backoff instead of immediately reporting the snapshot
        failed — reporting failure resets the remote to WAIT and costs a
        full leader round trip before the next attempt.  Each retry asks
        the receiver for its receive cursor (``query_resume``) and
        continues from there; chunks already on the receiver's disk are
        neither read nor re-sent.  Only after
        ``snapshot_stream_max_tries`` consecutive failures is the
        failure surfaced (snapshot_status_cb + unreachable)."""
        source = None
        tries = max(1, settings.Soft.snapshot_stream_max_tries)
        self._stream_event(
            m.shard_id, "snapshot_stream_start",
            f"to={m.to} index={m.snapshot.index} target={target}",
        )
        try:
            if not m.snapshot.dummy and self.snapshot_source_opener is not None:
                source = self.snapshot_source_opener(m.snapshot)
            for attempt in range(tries):
                try:
                    self._stream_once(m, target, source, attempt)
                    self.metrics["snapshots_sent"] += 1
                    self._stream_event(
                        m.shard_id, "snapshot_stream_complete",
                        f"to={m.to} index={m.snapshot.index}",
                    )
                    return
                except Exception as e:  # noqa: BLE001 — any transport error
                    if self._stopped or attempt == tries - 1:
                        raise
                    _log.warning(
                        "snapshot stream to %s failed (attempt %d/%d): %s",
                        target, attempt + 1, tries, e,
                    )
                    # sliced backoff so close() interrupts promptly
                    wait = 0.05 * (2 ** attempt)
                    deadline = time.monotonic() + wait
                    while not self._stopped and time.monotonic() < deadline:
                        time.sleep(0.02)
                    if self._stopped:
                        raise
        except Exception as e:  # noqa: BLE001 — retries exhausted
            _log.warning("snapshot stream to %s failed: %s", target, e)
            self._stream_event(
                m.shard_id, "snapshot_stream_fail",
                f"to={m.to} index={m.snapshot.index}: {e}",
            )
            self._snapshot_failed(m)
            if self.unreachable_cb is not None:
                self.unreachable_cb(m)
        finally:
            if source is not None:
                source.close()  # releases the storage GC lease
            with self._stream_lock:
                self._stream_jobs -= 1

    def _stream_once(
        self, m: Message, target: str, source, attempt: int = 0
    ) -> None:
        from .chunk import iter_snapshot_chunks, resume_probe

        start = 0
        if attempt > 0 and source is not None and not m.snapshot.dummy:
            # a RETRY of a partially-delivered stream: ask the receiver
            # where its cursor stands.  The query rides its OWN probe
            # connection: an old receiver closes the socket on the
            # unknown frame kind, and chunks sent down that same dead
            # socket would burn the whole attempt — a fresh chunk
            # connection below keeps restart-from-zero working against
            # pre-resume peers.  Any query failure answers 0, which the
            # receiver's idempotent re-delivery tolerates.
            probe_conn = self.raw.get_snapshot_connection(target)
            try:
                start = probe_conn.query_resume(resume_probe(m, source))
            except Exception:  # noqa: BLE001 — degrade to restart
                start = 0
            finally:
                probe_conn.close()
        conn = self.raw.get_snapshot_connection(target)
        sent_chunks = 0
        sent_bytes = 0
        try:
            if start > 0:
                with self._stream_lock:
                    self.metrics["stream_resumes"] += 1
                self._stream_event(
                    m.shard_id, "snapshot_stream_resume",
                    f"to={m.to} index={m.snapshot.index} "
                    f"from_chunk={start}",
                )
            inj = self.fault_injector
            # the nemesis stream plane (faults.STREAM_KINDS); getattr so
            # bespoke test injectors with only on_wire keep working
            stream_hook = getattr(inj, "on_snapshot_stream", None)
            for c in iter_snapshot_chunks(m, source, start_chunk=start):
                if self._stopped:
                    raise ConnectionError("transport stopped")
                if stream_hook is not None:
                    # snapshot_stream_kill raises here — the streamer
                    # dies mid-transfer and the retry/resume path above
                    # picks the transfer back up
                    stream_hook(self.source_address, target, c)
                conn.send_chunk(c)
                sent_chunks += 1
                sent_bytes += len(c.data)
                # re-read per chunk: set_snapshot_send_rate promises
                # in-flight streams pick a NEW/removed cap up at their
                # next chunk, not just a retuned existing bucket
                pacer = self.snapshot_pacer
                if pacer is not None:
                    # token-bucket cap shared across ALL stream jobs:
                    # follower catch-up cannot starve the commit path
                    # of bandwidth (bigstate.pacing; the cumulative
                    # sleep surfaces as snapshot_stream_throttle_*)
                    pacer.throttle(
                        len(c.data), should_abort=lambda: self._stopped
                    )
        finally:
            conn.close()
            with self._stream_lock:
                self.metrics["stream_chunks"] += sent_chunks
                self.metrics["stream_bytes"] += sent_bytes

    def _snapshot_failed(self, m: Message) -> None:
        if self.snapshot_status_cb is not None:
            self.snapshot_status_cb(m.shard_id, m.to, True)

    def _notify_unreachable(self, msgs) -> None:
        if self.unreachable_cb is None:
            return
        seen = set()
        for m in msgs:
            key = (m.shard_id, m.to)
            if key not in seen:
                seen.add(key)
                self.unreachable_cb(m)
