"""NodeHost: the process-level host multiplexing many raft shards.

reference: nodehost.go [U].  One NodeHost owns the engine, transport,
LogDB, registry and ticker; shards are started/stopped dynamically and all
public request APIs (SyncPropose/SyncRead/membership/snapshot/transfer)
live here.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Callable, Dict, Optional

from .client import Session
from .config import Config, ConfigError, NodeHostConfig
from .engine.execengine import ExecEngine
from .events import EventFanout
from .logger import get_logger
from .metrics import MetricsRegistry
from .node import Node
from .obs.trace import UNSAMPLED
from .pb import (
    ConfigChange,
    ConfigChangeType,
    Membership,
    MessageBatch,
    MessageType,
)
from .pb import Message
from .raftio import LeaderInfo, NodeInfoEvent
from .readplane import (
    BOUND_TICKS_DEFAULT,
    Consistency,
    ReadResult,
    StaleBoundExceeded,
)
from .request import (
    RequestError,
    RequestResultCode,
    RequestState,
    ShardNotFound,
    SystemBusy,
)
from .statemachine import Result
from .storage.snapshotter import FileSnapshotStorage
from .transport import InProcTransport, Registry, Transport
from .transport.chunk import ChunkSink

_log = get_logger("nodehost")


class NodeHostClosed(RequestError):
    pass


class TimeoutError_(RequestError):
    pass


class RequestRejected(RequestError):
    pass


class RequestDropped(RequestError):
    pass


class RequestTerminated(RequestError):
    pass


_CODE_ERRORS = {
    RequestResultCode.TIMEOUT: TimeoutError_,
    RequestResultCode.REJECTED: RequestRejected,
    RequestResultCode.DROPPED: RequestDropped,
    RequestResultCode.TERMINATED: RequestTerminated,
    RequestResultCode.ABORTED: RequestTerminated,
}


def _check(code: RequestResultCode, rs: RequestState) -> Result:
    if code == RequestResultCode.COMPLETED:
        return rs.result
    raise _CODE_ERRORS.get(code, RequestError)(code.name)


class NodeHost:
    def __init__(self, config: NodeHostConfig):
        config.validate()
        self.config = config
        # process-identity timestamp the fleet scope reports in every
        # obs reply: a collector cross-checks uptime against its
        # epoch-based restart detection (docs/OBSERVABILITY.md)
        self._started_mono = time.monotonic()
        # shard_id -> node (one replica/shard); guarded-by: _nodes_lock
        self._nodes: Dict[int, Node] = {}
        # quiesce tick-parking: quiesced-idle nodes leave the active
        # tick set entirely (their logical clocks freeze) and rejoin via
        # node.wake() when any producer touches them — the host-side
        # analogue of the reference's 'millions of idle groups cost ~0'
        # (quiesce + workReady [U]); at 50k rows the flat per-tick
        # fan-out alone was ~1M lock-ops/sec of pure Python
        self._parked: Dict[int, Node] = {}  # shard_id -> parked node; guarded-by: _nodes_lock
        self._global_ticks = 0
        self._nodes_lock = threading.RLock()
        self._closed = False

        # exclusive dir lock + deployment-id check (reference:
        # internal/server environment [U])
        from .env import Env

        self._env = Env(config.nodehost_dir, config.deployment_id)

        try:

            expert = config.expert
            if expert.logdb_factory:
                self.logdb = expert.logdb_factory(config)
            else:
                # durable by default, like the reference (tan is its v4
                # default LogDB [U]); volatile storage is opt-in via
                # storage.logdb.in_mem_logdb_factory
                from .storage.tan import tan_logdb_factory

                self.logdb = tan_logdb_factory(config)
            if expert.snapshot_storage_factory:
                self.snapshot_storage = expert.snapshot_storage_factory(config)
            else:
                # snapshots are durable by default, rooted in the nodehost dir
                # (reference: snapshot dirs under NodeHostDir [U])
                import os

                self.snapshot_storage = FileSnapshotStorage(
                    os.path.join(config.nodehost_dir, "snapshots")
                )
            self.gossip: Optional[object] = None
            if config.address_by_nodehost_id:
                from .id import get_nodehost_id
                from .transport.gossip import GossipManager, GossipRegistry

                self.nodehost_id = get_nodehost_id(config.nodehost_dir)
                self.gossip = GossipManager(
                    self.nodehost_id,
                    config.raft_address,
                    config.gossip.bind_address,
                    list(config.gossip.seed),
                    advertise_address=config.gossip.advertise_address,
                )
                self.gossip.start()
                self.registry = GossipRegistry(self.gossip)
            else:
                self.registry = Registry()
            # metrics exist before everything that registers series
            # (event fanout, per-target breakers, the engine)
            self.metrics = MetricsRegistry(enabled=config.enable_metrics)
            # readplane per-path read counters (docs/READPLANE.md).
            # Plain dict bumps: observability only, and a GIL-preempted
            # lost increment is the same benign race every other scrape
            # surface here accepts — no lock on the read hot paths.
            self._read_paths: Dict[str, int] = {
                "lease": 0, "read_index": 0, "follower": 0,
                "bounded": 0, "bounded_shed": 0,
            }
            # pre-resolved labeled counters: counter() takes the
            # registry lock; resolving once keeps the per-read cost at
            # one dict load + one GIL-atomic add
            self._read_counters = {
                p: self.metrics.counter("nodehost_read_total", {"path": p})
                for p in self._read_paths
            }
            # observability (obs/, docs/OBSERVABILITY.md): both gates
            # default off and leave the attribute None — every hot-path
            # check is one attribute load
            from .obs import FlightRecorder, Tracer

            self.tracer = (
                Tracer(
                    host=config.raft_address,
                    sample_rate=config.trace_sample_rate,
                )
                if config.enable_tracing
                else None
            )
            self.recorder = (
                FlightRecorder(host=config.raft_address)
                if config.enable_flight_recorder
                else None
            )
            self.events = EventFanout(
                config.raft_event_listener,
                config.system_event_listener,
                metrics=self.metrics,
                tap=self._recorder_tap if self.recorder is not None else None,
            )

            # received snapshots get a unique suffix: re-streams of the same
            # index must never clobber a file a queued recover task still wants
            self._rx_snapshot_seq = itertools.count(1)
            self._chunk_sink = ChunkSink(
                begin_fn=lambda s, r, i: self.snapshot_storage.begin_receive(
                    s, r, i, suffix=f"rx{next(self._rx_snapshot_seq)}"
                ),
                deliver_fn=self._deliver_received_snapshot,
                confirm_fn=self._confirm_received_snapshot,
                reject_fn=self._reject_received_snapshot,
            )
            raw_transport = (
                expert.transport_factory(
                    config, self._handle_message_batch, self._chunk_sink.add
                )
                if expert.transport_factory
                else InProcTransport(
                    config.raft_address,
                    self._handle_message_batch,
                    self._chunk_sink.add,
                )
            )
            # resumable streams: reconnecting senders query this host's
            # receive cursor before re-streaming (docs/BIGSTATE.md);
            # getattr-guarded set so bespoke transport factories without
            # the attribute keep working (they degrade to restart+
            # idempotent re-delivery)
            if hasattr(raw_transport, "resume_handler"):
                raw_transport.resume_handler = self._chunk_sink.resume_cursor
            self.transport = Transport(
                raw_transport,
                self.registry.resolve,
                config.raft_address,
                config.deployment_id,
                unreachable_cb=self._report_unreachable,
                snapshot_source_opener=self._open_snapshot_source,
                snapshot_status_cb=self._report_snapshot_status,
                max_snapshot_send_bytes_per_second=(
                    config.max_snapshot_send_bytes_per_second
                ),
                metrics_registry=self.metrics,
                stream_event_cb=self._stream_event,
            )
            self.transport.start()

            self.metrics.gauge(
                "raft_nodehost_shards", lambda: len(self._nodes)
            )
            self.metrics.gauge(
                "raft_transport_sent_total", lambda: self.transport.metrics["sent"]
            )
            self.metrics.gauge(
                "raft_transport_dropped_total",
                lambda: self.transport.metrics["dropped"],
            )
            self.metrics.gauge(
                "raft_transport_failed_total",
                lambda: self.transport.metrics["failed"],
            )
            self.metrics.gauge(
                "raft_transport_snapshots_sent_total",
                lambda: self.transport.metrics["snapshots_sent"],
            )
            # the snapshot_stream_* surface (docs/BIGSTATE.md): stream
            # egress, resume events, cap-induced sleep and live jobs
            self.metrics.gauge(
                "snapshot_stream_chunks_total",
                lambda: self.transport.metrics["stream_chunks"],
            )
            self.metrics.gauge(
                "snapshot_stream_bytes_total",
                lambda: self.transport.metrics["stream_bytes"],
            )
            self.metrics.gauge(
                "snapshot_stream_resumes_total",
                lambda: self.transport.metrics["stream_resumes"],
            )
            self.metrics.gauge(
                "snapshot_stream_throttle_seconds_total",
                lambda: self.transport.stream_throttled_seconds(),
            )
            self.metrics.gauge(
                "snapshot_stream_active", lambda: self.transport._stream_jobs
            )
            def _proposals_total():
                with self._nodes_lock:
                    return sum(n.proposal_count for n in self._nodes.values())

            self.metrics.gauge(
                "raft_nodehost_proposals_total", _proposals_total
            )
            # engine-health gauges (obs tentpole): scrape-time O(nodes)
            # walks over lock-free per-node counters — the step/apply
            # hot paths pay nothing
            self.metrics.gauge(
                "raft_nodehost_tick_lag_max", self._tick_lag_max
            )
            self.metrics.gauge(
                "raft_nodehost_queue_depth_total", self._queue_depth_total
            )
            self.metrics.gauge(
                "raft_nodehost_apply_lag_max", self._apply_lag_max
            )

            step_engine = (
                expert.step_engine_factory(self) if expert.step_engine_factory else None
            )
            self.engine = ExecEngine(
                self.logdb,
                step_workers=expert.engine.exec_shards,
                apply_workers=expert.engine.apply_shards,
                step_engine=step_engine,
                metrics=self.metrics,
            )
            self.engine.start()

            self._ticks_paused = False
            self._ticker_stop = threading.Event()
            self._ticker = threading.Thread(
                target=self._ticker_main, daemon=True, name="tpu-raft-ticker"
            )
            self._ticker.start()
        except Exception:
            # release everything already started — a same-process retry
            # must not hit DirLockedError, EADDRINUSE or orphan threads
            for closer in ("engine", "transport", "gossip", "logdb"):
                obj = getattr(self, closer, None)
                if obj is not None:
                    try:
                        obj.stop() if closer == "engine" else obj.close()
                    except Exception:  # noqa: BLE001
                        pass
            self._env.close()
            raise

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.events.node_host_shutting_down()
        self._ticker_stop.set()
        self._ticker.join(timeout=2.0)
        with self._nodes_lock:
            nodes = list(self._nodes.values())
            self._nodes.clear()
            self._parked.clear()
        # announce shutdown BEFORE unregistering: step engines must stop
        # letting these replicas participate (win elections, route
        # appends) while the teardown drains — in colocated mode a
        # still-participating row of a closing host strands routed
        # payloads and fail-stops healthy peers
        for n in nodes:
            n.stopping = True
        self.engine.unregister_many([n.shard_id for n in nodes])
        # join worker threads before closing the user SMs: an apply worker
        # may still be inside sm.handle
        self.engine.stop()
        if self.gossip is not None:
            self.gossip.close()
        for n in nodes:
            n.stop()
        self.transport.close()
        self.logdb.close()
        self.events.close()
        # release the dir flock LAST: another process may acquire the dir
        # the moment this unlocks, and the WAL must be closed by then
        self._env.close()

    def _ticker_main(self) -> None:
        import os as _os

        # sweep the per-node loop only every Nth period, crediting N
        # ticks at once (same logical tick rate, 1/N the per-node host
        # cost); see NodeHostConfig.tick_sweep_batch for the timing-
        # granularity caveats.  The env var remains the fallback for
        # deployments that predate the config field.
        batch = self.config.tick_sweep_batch or max(
            1, int(_os.environ.get("TICK_SWEEP_BATCH", "1"))
        )
        period = self.config.rtt_millisecond / 1000.0 * batch
        while not self._ticker_stop.wait(period):
            if self._ticks_paused:
                continue
            self._global_ticks += batch
            with self._nodes_lock:
                nodes = [
                    n for sid, n in self._nodes.items()
                    if sid not in self._parked
                ]
            ready = []
            for n in nodes:
                if n.is_parkable():
                    with self._nodes_lock:
                        # re-check under the lock: a producer may have
                        # raced a wake() between the test and the park,
                        # and stop_shard may have removed the node — a
                        # stale _parked entry would block all ticks to a
                        # later start_replica of the same shard id
                        if (
                            n.is_parkable()
                            and self._nodes.get(n.shard_id) is n
                        ):
                            n.parked_at_tick = self._global_ticks
                            self._parked[n.shard_id] = n
                            rec = self.recorder
                            if rec is not None:
                                rec.record(
                                    n.shard_id, "park",
                                    f"tick={self._global_ticks}",
                                )
                            continue
                for _ in range(batch):
                    n.add_tick()
                ready.append(n.shard_id)
            if ready:
                self.engine.notify_many(ready)

    def _wake_node(self, node) -> None:
        """Producer-side unpark (node.wake): rejoin the active tick set
        and credit the ticks that elapsed while parked."""
        # raftlint: ignore[guarded-by] lock-free fast path; see below
        if node.shard_id not in self._parked:
            # lock-free fast path: wake() rides EVERY producer call
            # (propose, enqueue_received, ...); taking the host-global
            # lock per message would reintroduce the very contention
            # parking removes.  The race is safe: a producer appends to
            # the node's queue BEFORE calling wake, so the ticker's
            # under-lock is_parkable re-check sees the entry and
            # declines to park.
            return
        with self._nodes_lock:
            n = self._parked.pop(node.shard_id, None)
        if n is not None:
            n.grant_ticks(self._global_ticks - n.parked_at_tick)
            rec = self.recorder
            if rec is not None:
                rec.record(
                    n.shard_id, "unpark",
                    f"tick={self._global_ticks} "
                    f"parked_at={n.parked_at_tick}",
                )
            if n.notify_work is not None:
                n.notify_work()

    def pause_ticks(self) -> None:
        """Suspend the logical clock (mass-start tooling).

        Starting tens of thousands of replicas takes wall-clock time
        during which already-started shards would otherwise hit their
        election timeouts and launch full engine step generations,
        starving the start loop of CPU (the r03 10k-shard run spent 13
        minutes in start_replica for this reason).  Pausing ticks while
        loading keeps registration-driven steps (which are cheap) and
        freezes election clocks; ``resume_ticks`` lets every shard's
        randomized timeout start from the same instant.  No reference
        equivalent — Go hosts start replicas in microseconds [U]."""
        self._ticks_paused = True

    def resume_ticks(self) -> None:
        self._ticks_paused = False

    # ------------------------------------------------------------------
    # shard lifecycle
    # ------------------------------------------------------------------
    def start_replica(
        self,
        initial_members: Dict[int, str],
        join: bool,
        sm_factory: Callable,
        config: Config,
    ) -> None:
        """Start this replica of a shard (reference: StartReplica /
        StartConcurrentReplica / StartOnDiskReplica — the SM tier is
        detected from the factory's return type) [U]."""
        if self._closed:
            raise NodeHostClosed("nodehost closed")
        config.validate()
        if not join and not initial_members:
            raise ConfigError("initial members not given for a non-join start")
        with self._nodes_lock:
            if config.shard_id in self._nodes:
                raise ConfigError(f"shard {config.shard_id} already started")
            for pid, addr in initial_members.items():
                self.registry.add(config.shard_id, pid, addr)
            node = Node(
                config=config,
                initial_members=initial_members,
                join=join,
                sm_factory=sm_factory,
                logdb=self.logdb,
                snapshot_storage=self.snapshot_storage,
                transport=self.transport,
                on_leader_updated=self._on_leader_updated,
                event_listener=self.events,
                registry=self.registry,
                tracer=self.tracer,
            )
            self._nodes[config.shard_id] = node
            node.wake = functools.partial(self._wake_node, node)
            self.engine.register(node)
        self.events.node_ready(NodeInfoEvent(config.shard_id, config.replica_id))

    def stop_shard(self, shard_id: int) -> None:
        with self._nodes_lock:
            node = self._nodes.pop(shard_id, None)
            self._parked.pop(shard_id, None)
        if node is None:
            raise ShardNotFound(f"shard {shard_id}")
        self.engine.unregister(shard_id)
        node.stop()

    def stop_replica(self, shard_id: int, replica_id: int) -> None:
        self.stop_shard(shard_id)

    # ------------------------------------------------------------------
    # message plumbing
    # ------------------------------------------------------------------
    def _handle_message_batch(self, batch: MessageBatch) -> None:
        if self._closed:
            return
        if (
            self.config.deployment_id
            and batch.deployment_id
            and batch.deployment_id != self.config.deployment_id
        ):
            _log.warning("dropping batch with wrong deployment id")
            return
        touched = set()
        with self._nodes_lock:
            for m in batch.messages:
                node = self._nodes.get(m.shard_id)
                if node is None or node.replica_id != m.to:
                    continue
                # learn the sender's return address from the batch (the
                # reference's MessageBatch.SourceAddress): a replica that
                # joined with empty members can respond BEFORE the
                # membership config change commits — without this the
                # first contact deadlocks (it cannot ack, so the leader
                # never resends)
                if batch.source_address and m.from_:
                    self.registry.learn(
                        m.shard_id, m.from_, batch.source_address
                    )
                node.enqueue_received(m)
                touched.add(m.shard_id)
        if touched:
            self.engine.notify_many(touched)

    # -- snapshot streaming plumbing -----------------------------------
    def _open_snapshot_source(self, ss):
        from .storage.snapshotter import SnapshotSource

        return SnapshotSource(self.snapshot_storage, ss)

    def _stream_event(self, shard_id: int, kind: str, detail: str) -> None:
        """Stream-job lifecycle (start/resume/complete/fail) lands in
        the shard's flight-recorder lane: the post-incident timeline of
        a laggard catch-up shows exactly when the streamer died and from
        which chunk it resumed (docs/BIGSTATE.md)."""
        rec = self.recorder
        if rec is not None:
            rec.record(shard_id, kind, detail)

    def set_snapshot_send_rate(self, bytes_per_second: int) -> None:
        """Retune the host-wide snapshot-stream bandwidth cap at
        runtime (0 removes it).  The cap is one token bucket shared by
        every stream job of this host; the ``bigstate.pacing.
        CapFeedback`` loop drives this knob to keep follower catch-up
        from starving the commit path.  A host fronted by a
        ``gateway.Gateway`` gets that loop wired to a LIVE latency
        source automatically — the gateway feeds its LatencyBudget's
        commit latencies into a per-host AIMD loop unless
        ``GatewayConfig(cap_feedback=False)`` opts out
        (docs/GATEWAY.md "Snapshot-cap feedback")."""
        self.transport.set_snapshot_send_rate(bytes_per_second)

    def _deliver_received_snapshot(self, m: Message) -> None:
        """A fully-reassembled snapshot enters the raft path like any other
        received message."""
        self._handle_message_batch(MessageBatch(messages=(m,)))

    def _confirm_received_snapshot(
        self, shard_id: int, from_replica: int, to_replica: int
    ) -> None:
        """Tell the sender its stream arrived (reference: the receiving
        side's SnapshotReceived message [U])."""
        self.transport.send(
            Message(
                type=MessageType.SNAPSHOT_RECEIVED,
                shard_id=shard_id,
                from_=to_replica,
                to=from_replica,
            )
        )

    def _reject_received_snapshot(
        self, shard_id: int, from_replica: int, to_replica: int
    ) -> None:
        """A completed stream failed container validation: tell the
        SENDER over the wire so its raft peer clears the pending
        snapshot and retries (without this the remote would stay in
        SNAPSHOT wait forever on transports where the sender cannot
        observe the final-chunk rejection)."""
        self.transport.send(
            Message(
                type=MessageType.SNAPSHOT_STATUS,
                shard_id=shard_id,
                from_=to_replica,
                to=from_replica,
                reject=True,
            )
        )

    def _report_snapshot_status(
        self, shard_id: int, to_replica: int, failed: bool
    ) -> None:
        """A stream job finished/failed: tell the local sending peer
        (reference: ReportSnapshotStatus [U])."""
        with self._nodes_lock:
            node = self._nodes.get(shard_id)
        if node is None:
            return
        node.enqueue_received(
            Message(
                type=MessageType.SNAPSHOT_STATUS,
                shard_id=shard_id,
                from_=to_replica,
                to=node.replica_id,
                reject=failed,
            )
        )
        self.engine.notify(shard_id)

    def _report_unreachable(self, m) -> None:
        with self._nodes_lock:
            node = self._nodes.get(m.shard_id)
        if node is None:
            return
        node.enqueue_received(Message(type=MessageType.UNREACHABLE, from_=m.to))
        self.engine.notify(m.shard_id)

    def _on_leader_updated(
        self, shard_id: int, replica_id: int, term: int, leader_id: int
    ) -> None:
        rec = self.recorder
        if rec is not None:
            rec.record(
                shard_id, "leader_change",
                f"replica={replica_id} term={term} leader={leader_id}",
            )
        self.events.leader_updated(
            LeaderInfo(
                shard_id=shard_id,
                replica_id=replica_id,
                term=term,
                leader_id=leader_id,
            )
        )

    # ------------------------------------------------------------------
    # request APIs
    # ------------------------------------------------------------------
    def _get_node(self, shard_id: int) -> Node:
        if self._closed:
            raise NodeHostClosed("nodehost closed")
        with self._nodes_lock:
            node = self._nodes.get(shard_id)
        if node is None:
            raise ShardNotFound(f"shard {shard_id} not found")
        return node

    def _timeout_ticks(self, timeout: float) -> int:
        return max(1, int(timeout * 1000 / self.config.rtt_millisecond))

    def get_noop_session(self, shard_id: int) -> Session:
        return Session.noop(shard_id)

    # -- proposals --------------------------------------------------------
    def propose(
        self, session: Session, cmd: bytes, timeout: float, parent=None
    ) -> RequestState:
        node = self._get_node(session.shard_id)
        tracer = self.tracer  # None when disabled: one attribute load
        span = None
        if tracer is not None and parent is not UNSAMPLED:
            if parent is not None:
                # continue a caller-held trace (e.g. the client retry
                # loop's root span) — already sampled at its root
                span = tracer.start_span(
                    "propose", parent.trace_id, parent.span_id,
                    shard_id=session.shard_id,
                )
            else:
                span = tracer.start_trace("propose", shard_id=session.shard_id)
            if span is not None:
                span.annotate(f"client:propose bytes={len(cmd)}")
        try:
            rs = node.propose(
                session, cmd, self._timeout_ticks(timeout), span=span
            )
        except Exception as e:
            # a rejected request (SystemBusy, closed shard, ...) must
            # still reach the finished-span ring — the weakly-held open
            # span would otherwise be GC'd unended and the very
            # requests an operator debugs would vanish from dumps
            if span is not None:
                span.end(status=type(e).__name__)
            raise
        self.engine.notify(session.shard_id)
        return rs

    def sync_propose(
        self, session: Session, cmd: bytes, timeout: float = 5.0, parent=None
    ) -> Result:
        rs = self.propose(session, cmd, timeout, parent=parent)
        return _check(rs.wait(timeout), rs)

    # -- sessions ---------------------------------------------------------
    def sync_get_session(self, shard_id: int, timeout: float = 5.0) -> Session:
        s = Session.new_session(shard_id)
        node = self._get_node(shard_id)
        rs = node.propose_session_op(s, self._timeout_ticks(timeout))
        self.engine.notify(shard_id)
        _check(rs.wait(timeout), rs)
        s.prepare_for_propose()
        return s

    def sync_close_session(self, session: Session, timeout: float = 5.0) -> None:
        session.prepare_for_unregister()
        node = self._get_node(session.shard_id)
        rs = node.propose_session_op(session, self._timeout_ticks(timeout))
        self.engine.notify(session.shard_id)
        _check(rs.wait(timeout), rs)

    # -- reads ------------------------------------------------------------
    def read_index(self, shard_id: int, timeout: float) -> RequestState:
        node = self._get_node(shard_id)
        tracer = self.tracer
        span = None
        if tracer is not None:
            span = tracer.start_trace("read_index", shard_id=shard_id)
        try:
            rs = node.read_index(self._timeout_ticks(timeout), span=span)
        except Exception as e:
            if span is not None:
                span.end(status=type(e).__name__)
            raise
        self.engine.notify(shard_id)
        return rs

    def sync_read(self, shard_id: int, query, timeout: float = 5.0):
        rs = self.read_index(shard_id, timeout)
        _check(rs.wait(timeout), rs)
        self._count_read("read_index")
        return self._get_node(shard_id).lookup(query)

    def stale_read(self, shard_id: int, query):
        return self._get_node(shard_id).stale_read(query)

    def _count_read(self, path: str) -> None:
        self._read_paths[path] = self._read_paths.get(path, 0) + 1
        c = self._read_counters.get(path)
        if c is not None:
            c.add()

    def read_path_counts(self) -> Dict[str, int]:
        """Cumulative reads served per readplane path on this host
        (lease / read_index / follower / bounded / bounded_shed) —
        surfaced through RPC STATS and the readplane smoke."""
        return dict(self._read_paths)

    def follower_read(self, shard_id: int, query, timeout: float = 5.0):
        """FOLLOWER_LINEARIZABLE: run the ReadIndex confirmation round
        through the leader (the raft layer forwards when this replica
        is a follower), wait until the local RSM has applied past the
        confirmed index, then serve from the LOCAL state machine.
        Returns ``(value, applied_index)``.  Linearizable — safety
        argument in docs/READPLANE.md; a leadership change mid-round
        fails the future fast (Raft.drop_pending_read_indexes) so the
        caller re-confirms instead of trusting a deposed leader."""
        rs = self.read_index(shard_id, timeout)
        _check(rs.wait(timeout), rs)
        node = self._get_node(shard_id)
        value = node.lookup(query)
        self._count_read("follower")
        return value, node.sm.last_applied

    def bounded_read(
        self, shard_id: int, query, bound_ticks: int = BOUND_TICKS_DEFAULT
    ) -> ReadResult:
        """BOUNDED_STALENESS: serve immediately from the local state
        machine, stamped with the applied index and staleness in ticks;
        raise :class:`StaleBoundExceeded` when the replica cannot prove
        the stamp stays within ``bound_ticks`` (Node.bounded_read_probe
        has the gate)."""
        node = self._get_node(shard_id)
        ok, applied, staleness = node.bounded_read_probe(bound_ticks)
        if not ok:
            self._count_read("bounded_shed")
            raise StaleBoundExceeded(
                f"shard {shard_id}: staleness {staleness} ticks exceeds "
                f"bound {bound_ticks}"
            )
        value = node.lookup(query)
        self._count_read("bounded")
        return ReadResult(
            value=value, path="bounded",
            applied_index=applied, staleness_ticks=staleness,
        )

    def read_at_replica(
        self,
        shard_id: int,
        query,
        consistency: Consistency = Consistency.LINEARIZABLE,
        timeout: float = 5.0,
        bound_ticks: int = BOUND_TICKS_DEFAULT,
        lease_margin_ticks: int = 2,
    ) -> ReadResult:
        """One explicit-consistency read against THIS host's replica
        (docs/READPLANE.md; the cross-replica routing lives in the
        gateway).  LINEARIZABLE tries the lease fast path and falls
        back to the ReadIndex quorum round; the other levels map to
        :meth:`follower_read` / :meth:`bounded_read`."""
        if consistency == Consistency.FOLLOWER_LINEARIZABLE:
            value, applied = self.follower_read(shard_id, query, timeout)
            return ReadResult(
                value=value, path="follower", applied_index=applied
            )
        if consistency == Consistency.BOUNDED_STALENESS:
            return self.bounded_read(shard_id, query, bound_ticks)
        ok, value = self.try_lease_read(shard_id, query, lease_margin_ticks)
        if ok:
            return ReadResult(value=value, path="lease")
        value = self.sync_read(shard_id, query, timeout)
        return ReadResult(value=value, path="read_index")

    def try_lease_read(
        self, shard_id: int, query, margin_ticks: int = 2
    ) -> tuple:
        """Serve a linearizable read from the local replica WITHOUT the
        per-read ReadIndex quorum round trip, iff this replica holds a
        CheckQuorum leader lease with more than ``margin_ticks`` to
        spare (gateway/ fast-read path; safety argument in
        ``Node.lease_remaining_ticks`` and docs/GATEWAY.md).  Returns
        ``(True, value)`` on a lease-served read, ``(False, None)``
        when the caller must fall back to :meth:`read_index`/
        :meth:`sync_read`.  The margin absorbs tick drift between
        hosts and the probe-to-lookup race; requires the shard's
        ``Config.check_quorum`` or the lease is never held."""
        node = self._get_node(shard_id)
        if not node.lease_held(margin_ticks):
            return False, None
        self._count_read("lease")
        return True, node.lookup(query)

    def lease_status(self, shard_id: int) -> dict:
        """Lease observability probe (tests, metrics scrapes)."""
        node = self._get_node(shard_id)
        return {
            "is_leader": node.peer.is_leader(),
            "check_quorum": node.peer.raft.check_quorum,
            "remaining_ticks": node.lease_remaining_ticks(),
        }

    # -- membership -------------------------------------------------------
    def _sync_config_change(
        self,
        shard_id: int,
        cc: ConfigChange,
        timeout: float,
    ) -> None:
        node = self._get_node(shard_id)
        rs = node.request_config_change(cc, self._timeout_ticks(timeout))
        self.engine.notify(shard_id)
        _check(rs.wait(timeout), rs)
        # registry sync happens in Node._complete_applied on every replica
        # when the config-change entry applies; nothing extra to do here

    def sync_request_add_replica(
        self,
        shard_id: int,
        replica_id: int,
        target: str,
        config_change_index: int = 0,
        timeout: float = 5.0,
    ) -> None:
        self._sync_config_change(
            shard_id,
            ConfigChange(
                config_change_id=config_change_index,
                type=ConfigChangeType.ADD_REPLICA,
                replica_id=replica_id,
                address=target,
            ),
            timeout,
        )

    def sync_request_add_non_voting(
        self, shard_id, replica_id, target, config_change_index=0, timeout=5.0
    ) -> None:
        self._sync_config_change(
            shard_id,
            ConfigChange(
                config_change_id=config_change_index,
                type=ConfigChangeType.ADD_NON_VOTING,
                replica_id=replica_id,
                address=target,
            ),
            timeout,
        )

    def sync_request_add_witness(
        self, shard_id, replica_id, target, config_change_index=0, timeout=5.0
    ) -> None:
        self._sync_config_change(
            shard_id,
            ConfigChange(
                config_change_id=config_change_index,
                type=ConfigChangeType.ADD_WITNESS,
                replica_id=replica_id,
                address=target,
            ),
            timeout,
        )

    def sync_request_delete_replica(
        self, shard_id, replica_id, config_change_index=0, timeout=5.0
    ) -> None:
        self._sync_config_change(
            shard_id,
            ConfigChange(
                config_change_id=config_change_index,
                type=ConfigChangeType.REMOVE_REPLICA,
                replica_id=replica_id,
            ),
            timeout,
        )

    def sync_get_shard_membership(self, shard_id: int, timeout: float = 5.0) -> Membership:
        rs = self.read_index(shard_id, timeout)
        _check(rs.wait(timeout), rs)
        return self._get_node(shard_id).get_membership()

    def get_shard_membership(self, shard_id: int) -> Membership:
        return self._get_node(shard_id).get_membership()

    # -- snapshots --------------------------------------------------------
    def sync_request_snapshot(
        self, shard_id: int, compaction_overhead: int = 0, timeout: float = 5.0
    ) -> int:
        node = self._get_node(shard_id)
        rs = node.request_snapshot(
            compaction_overhead or node.config.compaction_overhead,
            self._timeout_ticks(timeout),
        )
        self.engine.notify(shard_id)
        return _check(rs.wait(timeout), rs).value

    # -- disaster recovery (bigstate/dr.py; docs/BIGSTATE.md) -----------
    def export_snapshot(
        self, shard_id: int, export_dir: str, timeout: float = 10.0
    ):
        """DR export: snapshot the shard's current applied state and
        write a self-describing portable archive to ``export_dir``
        (container + external files + ``MANIFEST.json`` with
        shard/replica/index/term/membership and per-chunk checksums).
        Streamed end to end — a GB-scale state machine never
        materializes in memory.  Returns the ``pb.SnapshotManifest``.
        """
        from .bigstate.dr import write_archive

        node = self._get_node(shard_id)
        try:
            self.sync_request_snapshot(shard_id, timeout=timeout)
        except RequestRejected:
            pass  # applied index unchanged since the last snapshot: use it
        ss = self.logdb.get_snapshot(shard_id, node.replica_id)
        if ss.is_empty():
            raise RequestError(
                f"shard {shard_id} has no snapshot to export (no applied "
                "entries yet?)"
            )
        return write_archive(self.snapshot_storage, ss, export_dir)

    def import_snapshot(
        self,
        export_dir: str,
        shard_id: int,
        replica_id: int,
        members: Dict[int, str],
    ):
        """DR import: seed this host with an exported archive under a
        REWRITTEN membership, before ``start_replica`` for the shard.
        Every member listed must import the same archive with the same
        membership on its own host (reference: tools.ImportSnapshot
        preconditions [U]).  Verifies the manifest's per-chunk checksums
        and the container's own block CRCs before touching the logdb.
        Returns the seeded ``pb.Snapshot``."""
        from .bigstate.dr import import_archive

        return import_archive(self, export_dir, shard_id, replica_id, members)

    # -- leadership -------------------------------------------------------
    def request_leader_transfer(self, shard_id: int, target_id: int) -> None:
        node = self._get_node(shard_id)
        node.request_leader_transfer(target_id, self._timeout_ticks(5.0))
        self.engine.notify(shard_id)

    def get_leader_id(self, shard_id: int):
        node = self._get_node(shard_id)
        lid = node.peer.leader_id()
        return lid, lid != 0

    def is_leader_of(self, shard_id: int) -> bool:
        """True iff this host's replica of ``shard_id`` currently leads
        it (routing-cache discovery probe; False for absent shards —
        discovery sweeps hosts that may not carry the shard at all)."""
        with self._nodes_lock:
            node = self._nodes.get(shard_id)
        if node is None or node.stopped or node.stopping:
            return False
        lid = node.leader_id
        return bool(lid) and lid == node.replica_id

    # -- info -------------------------------------------------------------
    def pending_request_counts(self, shard_id: int) -> Dict[str, int]:
        """Outstanding request futures per table for one LIVE shard
        (the audit harness' leak probe; raises ShardNotFound once the
        shard is stopped — to assert a stopped node's tables drained to
        zero, hold the Node reference across ``stop_shard`` and len()
        its tables directly, as tests/test_scale.py's churn phase
        does)."""
        node = self._get_node(shard_id)
        return {
            "proposal": len(node.pending_proposal),
            "read_index": len(node.pending_read_index),
            "config_change": len(node.pending_config_change),
            "snapshot": len(node.pending_snapshot),
            "leader_transfer": len(node.pending_leader_transfer),
        }

    def write_health_metrics(self, writer) -> None:
        """Prometheus-text metric export (reference:
        NodeHost.WriteHealthMetrics [U]); enable via
        NodeHostConfig.enable_metrics."""
        writer.write(self.metrics.export_text())

    # -- event taps (gateway/ routing-cache invalidation) --------------
    def add_event_tap(self, fn) -> None:
        """Attach a synchronous ``fn(name, args)`` tap to this host's
        event fanout; sees every system event plus ``leader_updated``
        (events.EventFanout.add_tap)."""
        self.events.add_tap(fn)

    def remove_event_tap(self, fn) -> None:
        self.events.remove_tap(fn)

    # -- observability (obs/, docs/OBSERVABILITY.md) -------------------
    def _recorder_tap(self, name: str, args) -> None:
        """EventFanout tap: every system event also lands in the flight
        recorder, synchronously (the fanout queue can drop under
        pressure; the recorder must not miss state transitions)."""
        rec = self.recorder
        if rec is None:
            return
        info = args[0] if args else None
        shard = getattr(info, "shard_id", 0) or 0
        rec.record(shard, f"event:{name}", repr(info) if info is not None else "")

    def _tick_lag_max(self) -> int:
        with self._nodes_lock:
            nodes = list(self._nodes.values())
        return max((n.tick_lag() for n in nodes), default=0)

    def _queue_depth_total(self) -> int:
        with self._nodes_lock:
            nodes = list(self._nodes.values())
        return sum(n.queued_inputs() for n in nodes)

    def _apply_lag_max(self) -> int:
        with self._nodes_lock:
            nodes = list(self._nodes.values())
        lag = 0
        for n in nodes:
            try:
                lag = max(lag, n.peer.committed() - n.sm.last_applied)
            except Exception:  # noqa: BLE001 — node mid-stop
                continue
        return lag

    def dump_timeline(self, shard_id=None, writer=None) -> str:
        """Merged human-readable timeline for this host: flight-recorder
        state transitions interleaved with trace spans/annotations.
        This is the "where did these 4 seconds go?" view; cross-host
        merges use :func:`dragonboat_tpu.obs.merged_timeline` over the
        hosts' recorders/tracers."""
        from .obs import format_timeline, merged_timeline

        out = format_timeline(
            merged_timeline(
                recorders=(self.recorder,),
                tracers=(self.tracer,),
                shard_id=shard_id,
            )
        )
        if writer is not None:
            writer.write(out)
        return out

    def export_trace_json(self, path: Optional[str] = None) -> str:
        """Chrome/Perfetto ``trace_event`` JSON of this host's recorded
        spans (open in ui.perfetto.dev).  Empty trace when tracing is
        disabled."""
        data = (
            self.tracer.export_json()
            if self.tracer is not None
            else '{"traceEvents": []}'
        )
        if path:
            with open(path, "w") as f:
                f.write(data)
        return data

    def get_nodehost_info(self) -> dict:
        with self._nodes_lock:
            return {
                "raft_address": self.config.raft_address,
                "shards": [
                    {
                        "shard_id": n.shard_id,
                        "replica_id": n.replica_id,
                        "leader_id": n.leader_id,
                        "term": n.peer.term(),
                        "committed": n.peer.committed(),
                        "applied": n.sm.last_applied,
                    }
                    for n in self._nodes.values()
                ],
            }

    def balance_shard_stats(self) -> list:
        """Per-replica stats for the balance control plane's collector
        (balance/view.py): leader identity, applied index, cumulative
        proposal count and the replica's view of the shard membership.
        Cheap reads off producer threads — same benign races as
        :meth:`get_nodehost_info`."""
        with self._nodes_lock:
            nodes = list(self._nodes.values())
        out = []
        for n in nodes:
            if n.stopped or n.stopping:
                continue
            dev = self.engine.device_coordinate(n.shard_id)
            out.append(
                {
                    "shard_id": n.shard_id,
                    "replica_id": n.replica_id,
                    "leader_id": n.leader_id,
                    "term": n.peer.term(),
                    "applied": n.sm.last_applied,
                    "proposals": n.proposal_count,
                    "membership": n.get_membership(),
                    # chip coordinate of the engine row (None: host
                    # path / no mesh) — the balance plane's new
                    # placement dimension (docs/MULTICHIP.md)
                    "device": -1 if dev is None else dev,
                }
            )
        return out

    def device_chip_count(self) -> int:
        """Chips this host's step engine spreads rows over (collector
        input for the per-chip-capacity balance dimension)."""
        return self.engine.device_chip_count()

    def raft_address(self) -> str:
        return self.config.raft_address

    @property
    def uptime_s(self) -> float:
        """Seconds since this NodeHost was constructed (obs identity)."""
        return time.monotonic() - self._started_mono
