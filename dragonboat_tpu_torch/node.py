"""Per-(shard, replica) node: binds the pure raft peer to queues, the RSM,
the LogDB and the transport.

reference: node.go [U].  Threading contract (same as the reference's):
``step()``/``process_update()`` run only on the one step worker that owns
this shard; ``apply()`` only on its apply worker; public-API threads touch
only the thread-safe queues and pending tables.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
from typing import Callable, Dict, List, Optional, Tuple

from .client import Session
from .config import Config
from .invariants import check
from .logger import get_logger
from .pb import (
    Bootstrap,
    CompressionType,
    ConfigChange,
    ConfigChangeType,
    Entry,
    EntryType,
    Membership,
    Message,
    MessageType,
    Snapshot,
    State,
    SystemCtx,
    Update,
)
from .raft.peer import Peer
from .raft.quiesce import QuiesceManager
from .raft.read_index import ReadIndex as _DeviceReadIndex
from .raftio import EntryInfo, NodeInfoEvent, SnapshotInfo
from .request import (
    NO_DEADLINE,
    PendingConfigChange,
    PendingLeaderTransfer,
    PendingProposal,
    PendingReadIndex,
    PendingSnapshot,
    RequestState,
    SystemBusy,
    gc_tables,
)
from .rsm.managed import wrap_state_machine
from .rsm.statemachine import (
    ApplyResult,
    SnapshotFileCollection,
    StateMachine,
    Task,
    TaskType,
)
from .statemachine import Result
from .storage.logdb import LogDBLogReader
from .storage.snapshotio import SnapshotReader, _try_snappy

_SYSRAND = random.SystemRandom()

_log = get_logger("nodehost")


class StepInputs:
    """One atomic drain of a node's input queues (see drain_step_inputs)."""

    __slots__ = (
        "received",
        "proposals",
        "read_indexes",
        "config_changes",
        "cc_results",
        "transfers",
        "snapshot_reqs",
        "ticks",
        "gc_ticks",
    )

    def __init__(
        self,
        received=(),
        proposals=(),
        read_indexes=(),
        config_changes=(),
        cc_results=(),
        transfers=(),
        snapshot_reqs=(),
        ticks=0,
        gc_ticks=0,
    ):
        # empty inputs stay the shared () — consumers only iterate and
        # slice, and the idle per-tick drain at 50k rows must not build
        # seven throwaway lists per row
        self.received = list(received) if received else ()
        self.proposals = list(proposals) if proposals else ()
        self.read_indexes = list(read_indexes) if read_indexes else ()
        self.config_changes = list(config_changes) if config_changes else ()
        self.cc_results = list(cc_results) if cc_results else ()
        self.transfers = list(transfers) if transfers else ()
        self.snapshot_reqs = list(snapshot_reqs) if snapshot_reqs else ()
        self.ticks = ticks
        # ticks DROPPED by the add_tick backlog cap: they advance the
        # logical clock (future deadlines are measured on it, so client
        # timeouts stay bounded in wall time during step stalls) but
        # drive no raft ticks
        self.gc_ticks = gc_ticks


class Node:
    # __slots__: a NodeHost hosts tens of thousands of these (reference
    # hosts millions of groups via quiesce [U]); the per-instance dict
    # plus seven deques were the bulk of the r03 112-412 KB/row host
    # footprint.  Queues are plain lists (append + swap-drain only).
    __slots__ = (
        "config", "shard_id", "replica_id", "logdb", "snapshot_storage",
        "transport", "on_leader_updated", "events", "registry",
        "_qlock", "_received", "_proposals", "_read_indexes",
        "_config_changes", "_cc_to_apply", "_snapshot_reqs",
        "_leader_transfers", "_pending_ticks",
        "_ticks_in", "_ticks_taken",
        "pending_proposal", "pending_read_index", "pending_config_change",
        "pending_snapshot", "pending_leader_transfer", "pending_tables",
        "pending_deadline_hint", "device_reads", "hs_lane_slot",
        "tick_count", "leader_id", "proposal_count", "stopped", "stopping",
        "_snapshotting",
        "_applied_since_snapshot", "_retired_snapshots", "_apply_lock",
        "_sm_close_lock", "notify_work", "engine_apply_ready",
        "apply_work_ready",
        "log_reader", "sm", "_stop_event", "peer", "quiesce",
        "wake", "parked_at_tick", "tracer", "_trace_spans",
    )

    def __init__(
        self,
        config: Config,
        initial_members: Dict[int, str],
        join: bool,
        sm_factory: Callable,
        logdb,
        snapshot_storage,
        transport,
        on_leader_updated: Optional[Callable] = None,
        event_listener=None,
        registry=None,
        tracer=None,
    ):
        self.config = config
        self.shard_id = config.shard_id
        self.replica_id = config.replica_id
        # obs/ tracing: None when disabled — every hot-path gate is one
        # attribute load.  _trace_spans maps in-flight entry key ->
        # root span so the step/apply workers can annotate the path;
        # eager (not lazy) when tracing is on, because a lazy create
        # races concurrent producer threads (one fresh dict overwrites
        # the other, losing registrations).  Untraced nodes keep None.
        self.tracer = tracer
        self._trace_spans: Optional[Dict[int, object]] = (
            {} if tracer is not None else None
        )
        self.logdb = logdb
        self.snapshot_storage = snapshot_storage
        self.transport = transport
        self.on_leader_updated = on_leader_updated
        self.events = event_listener
        self.registry = registry

        # --- queues (thread-safe inputs to step) -------------------------
        # plain lists, not deques: producers only append and the drain
        # swaps the whole list out, and an empty deque costs ~750 B — at
        # 50k replica rows the seven deques alone were ~250 MB of idle
        # host footprint
        self._qlock = threading.Lock()
        self._received: list = []  # guarded-by: _qlock
        self._proposals: list = []  # Entry; guarded-by: _qlock
        self._read_indexes: list = []  # SystemCtx; guarded-by: _qlock
        self._config_changes: list = []  # (key, ConfigChange); guarded-by: _qlock
        self._cc_to_apply: list = []  # (ConfigChange|None, accepted); guarded-by: _qlock
        self._snapshot_reqs: list = []  # (key, overhead); guarded-by: _qlock
        self._leader_transfers: list = []  # target; guarded-by: _qlock
        self._pending_ticks = 0  # guarded-by: _qlock
        # single-writer tick lane: the HOST TICKER is the only writer of
        # _ticks_in and the owning step worker the only writer of
        # _ticks_taken, so the per-tick fan-out needs NO lock — at 50k
        # rows the per-node _qlock acquisition in add_tick was the
        # largest single host cost of the r5 scale run (the cap and
        # gc-overflow accounting moved to drain_step_inputs)
        self._ticks_in = 0
        self._ticks_taken = 0

        # --- pending futures --------------------------------------------
        # keys must be unique across NODE INCARNATIONS, not just within
        # one: a restarted replica re-applies its whole log, and if an old
        # in-log entry's key collided with a freshly allocated one, the
        # replayed apply would complete the NEW future — a false ack for a
        # proposal that may never commit (observed as acked-write loss in
        # chaos).  The reference seeds its key generator randomly per
        # start [U]; 47 random bits leave the counter ~2^47 of headroom.
        # request._PendingBase randomizes its own base when none is given;
        # the replica-id salt here additionally makes CROSS-REPLICA
        # distinctness structural (top bits differ by construction, not
        # by luck), closing the ROADMAP cross-replica collision window —
        # ALL five tables get a base, snapshot/transfer included.
        def key_base() -> int:
            # 60 bits (< request.KEY_BASE_BITS): read-index ctx keys must
            # split into two sub-2^31 halves for the device inbox
            # (request.PendingReadIndex.read)
            return ((config.replica_id & 0xFFF) << 48) | _SYSRAND.getrandbits(47)

        _tables_lock = threading.Lock()  # shared: see _PendingBase
        # shared earliest-deadline hint cell: the tick paths (scalar
        # tail below, ops/engine._tick_bookkeeping) probe it lock-free
        # and sweep all five tables under ONE lock acquisition only
        # when the clock reaches it (request.gc_tables)
        self.pending_deadline_hint = [NO_DEADLINE]
        self.pending_proposal = PendingProposal(
            _tables_lock, key_base=key_base(),
            deadline_hint=self.pending_deadline_hint,
        )
        self.pending_read_index = PendingReadIndex(
            _tables_lock, key_base=key_base(),
            deadline_hint=self.pending_deadline_hint,
        )
        self.pending_config_change = PendingConfigChange(
            _tables_lock, key_base=key_base(),
            deadline_hint=self.pending_deadline_hint,
        )
        self.pending_snapshot = PendingSnapshot(
            _tables_lock, key_base=key_base(),
            deadline_hint=self.pending_deadline_hint,
        )
        self.pending_leader_transfer = PendingLeaderTransfer(
            _tables_lock, key_base=key_base(),
            deadline_hint=self.pending_deadline_hint,
        )
        self.pending_tables = (
            self.pending_proposal, self.pending_read_index,
            self.pending_config_change, self.pending_snapshot,
            self.pending_leader_transfer,
        )
        # ctx/quorum table for DEVICE-resident reads (ops/engine.py): the
        # kernel serves the protocol (gate + ctx heartbeats); the host
        # tracks which voters echoed each ctx.  Scalar-path reads use
        # peer.raft.read_index instead — the two never overlap.
        self.device_reads = _DeviceReadIndex()
        # cached hard-state lane slot in this node's LogDB (the ILogDB
        # optional slot protocol; -1 = unresolved).  Resolved once by
        # the device merge tail's first batched lane save; stable for
        # the node's life (the node<->logdb binding never changes).
        self.hs_lane_slot = -1

        self.tick_count = 0
        self.leader_id = 0
        # monotone count of user proposals accepted into the queue
        # (incremented under _qlock beside the enqueue — a bare += on
        # concurrent producer threads is a non-atomic read-modify-write
        # and loses increments); the balance collector diffs it across
        # collect rounds to derive per-shard proposal rates
        self.proposal_count = 0
        self.stopped = False
        # stopping = shutdown announced but SM not yet closed: the node
        # must stop PARTICIPATING (elections, device routing) immediately
        # even though apply workers may still be draining (NodeHost.close
        # sets it on every node before unregistering; a half-closed
        # cluster otherwise keeps electing rows whose hosts are gone)
        self.stopping = False
        self._snapshotting = False
        self._applied_since_snapshot = 0
        # superseded snapshot files are kept for one extra generation: an
        # InstallSnapshot message produced earlier in the SAME step() can
        # still reference the previous file at transport-send time (the
        # payload is read synchronously on this worker; see
        # Transport.send_snapshot)
        self._retired_snapshots: List[str] = []
        # serializes apply() against stop() so the user SM is never closed
        # mid-update
        self._apply_lock = threading.Lock()
        # held for the duration of a streamed snapshot save; stop() takes
        # it before closing the user SM so a save never races the close
        # (applies do NOT take it — saves must not stall the apply path)
        self._sm_close_lock = threading.Lock()
        # set by the engine at registration; wakes the owning step worker
        self.notify_work: Optional[Callable[[], None]] = None
        self.engine_apply_ready: Optional[Callable[[int], None]] = None
        # the apply workers' WorkReady itself (also set at registration):
        # the batched per-SM-worker commit handoff groups wakeups by
        # partition through it (engine._apply_lane_commits) instead of
        # taking the partition lock once per row
        self.apply_work_ready = None

        # --- storage views ----------------------------------------------
        bootstrap = logdb.get_bootstrap_info(config.shard_id, config.replica_id)
        new_node = bootstrap is None
        if new_node:
            # a JOIN may seed the current membership: the bootstrap
            # members were never log entries, so a fresh joiner whose
            # catch-up is snapshot-less (short, uncompacted leader log)
            # replays a log with no trace of them and would believe the
            # shard's voter set is just itself — a leadership transfer
            # to it then self-elects into a split brain (balance-plane
            # finding).  Seeding is safe against the replayed config
            # changes: membership validation no-op-accepts a
            # same-address re-add and rejects removes of absent
            # members, so replay on top of the seeded state converges
            # to the same final membership.  An empty-members join
            # (the reference's contract) still works and learns
            # membership from the leader's snapshot.
            members = dict(initial_members)
            logdb.save_bootstrap_info(
                config.shard_id,
                config.replica_id,
                Bootstrap(addresses=members, join=join),
            )
        else:
            members = dict(bootstrap.addresses)

        self.log_reader, saved_state = LogDBLogReader.from_existing(
            config.shard_id, config.replica_id, logdb
        )
        ss = logdb.get_snapshot(config.shard_id, config.replica_id)

        # --- RSM ---------------------------------------------------------
        managed = wrap_state_machine(sm_factory(config.shard_id, config.replica_id))
        self.sm = StateMachine(
            config.shard_id,
            config.replica_id,
            managed,
            ordered_config_change=config.ordered_config_change,
            is_witness=config.is_witness,
        )
        self._stop_event = threading.Event()
        self.sm.open(self._stop_event)

        membership: Optional[Membership] = None
        if not ss.is_empty():
            if not ss.dummy and not config.is_witness:
                self._recover_sm_from_storage(ss)
            else:
                self.sm.last_applied = max(self.sm.last_applied, ss.index)
            membership = ss.membership
        if membership is None:
            # initial_members are always voters; non-voting/witness replicas
            # enter via config change or join an existing shard
            self.sm.set_initial_membership(dict(members))
            membership = self.sm.get_membership()
        else:
            self.sm.members.restore(membership)
        self._sync_registry(membership)

        # --- raft peer ---------------------------------------------------
        self.peer = Peer.launch(
            config,
            self.log_reader,
            saved_state,
            dict(membership.addresses),
            non_votings=dict(membership.non_votings),
            witnesses=dict(membership.witnesses),
        )
        self.quiesce = QuiesceManager(
            enabled=config.quiesce, election_timeout=config.election_rtt
        )
        # quiesce tick-parking (see NodeHost._ticker_main): a parked
        # node's logical clock freezes; any producer calls wake() to
        # rejoin the active tick set and be granted the elapsed ticks
        self.wake: Optional[Callable[[], None]] = None
        self.parked_at_tick = 0

    # ------------------------------------------------------------------
    # public-API-side entry points (any thread)
    # ------------------------------------------------------------------
    def _wake(self) -> None:
        w = self.wake
        if w is not None:
            w()

    def grant_ticks(self, n: int) -> None:
        """Credit ticks that elapsed while parked (quiesce tick-parking):
        up to one election window becomes raft ticks; the REST IS
        DISCARDED — for this shard, parked time simply did not pass.
        Crediting it to the gc-only clock would jump tick_count past the
        deadline of the very request whose wake granted the ticks
        (review finding: a request to a long-parked shard timed out
        instantly); parking requires no outstanding futures, so no
        deadline needs the parked interval."""
        if n <= 0:
            return
        with self._qlock:
            room = self.config.election_rtt - self._pending_ticks
            self._pending_ticks += min(n, max(0, room))

    def is_parkable(self) -> bool:
        """True when the ticker may park this node: quiesced with no
        queued inputs, no undrained ticks, and NO outstanding request
        futures of any kind — a parked clock never GCs deadlines, so a
        future left pending would block its caller forever (review
        finding: the table must mirror has_work, not just the two hot
        tables).  Lock-free reads — a producer racing in also calls
        wake(), which unparks immediately."""
        # raftlint: ignore[guarded-by] lock-free probe; ticker re-checks under lock
        return (
            self.quiesce.enabled
            and self.quiesce.quiesced
            and not self._pending_ticks
            and self._ticks_in == self._ticks_taken
            and not self._received
            and not self._proposals
            and not self._read_indexes
            and not self._config_changes
            and not self._cc_to_apply
            and not self._snapshot_reqs
            and not self._leader_transfers
            and not self.pending_proposal._pending
            and not self.pending_read_index._pending
            and not self.pending_config_change._pending
            and not self.pending_snapshot._pending
            and not self.pending_leader_transfer._pending
        )

    def add_tick(self) -> None:
        # LOCK-FREE: the host ticker is this counter's only writer (a
        # read-modify-write by a single thread is safe under the GIL);
        # the election-window backlog cap and gc-overflow accounting
        # moved to drain_step_inputs, where the backlog is consumed — at
        # 50k rows the per-node _qlock acquisition here was the largest
        # single host cost of the r5 scale run
        self._ticks_in += 1

    def _trace_register(self, key: int, span) -> None:
        """Associate an in-flight entry key with its root span so the
        step/apply workers can annotate it.  The map is bounded: spans
        of entries that never reach apply (timeouts GC the FUTURE via
        the tick sweep, which ends the span, but nothing pops the key)
        are pruned once ended, with a soft cap behind them.

        Concurrency: producer threads insert here while step/apply
        workers ``pop`` — individual dict ops are GIL-atomic, but
        iterating the live dict is not (a concurrent pop raises
        "changed size during iteration"), so the prune walks a
        ``list(m.items())`` snapshot, which CPython builds without
        dropping the GIL."""
        m = self._trace_spans
        m[key] = span
        if len(m) > 4096:
            items = list(m.items())
            for k, s in items:
                if s.ended:
                    m.pop(k, None)
            # pathological: (almost) all still open — shed the oldest
            # (insertion order) down to 3/4 cap, so the next O(n) scan
            # is ~1k inserts away (amortized, not per-propose)
            overflow = len(m) - 3072
            if len(m) > 4096 and overflow > 0:
                for k, _ in items[:overflow]:
                    m.pop(k, None)

    def propose(
        self, session: Session, cmd: bytes, timeout_ticks: int, span=None
    ) -> RequestState:
        if self.peer.raft.rate_limited():
            # MaxInMemLogSize exceeded: refuse new load until the window
            # drains (reference: ErrSystemBusy on rate limit [U]).
            # Reading inmem.bytes from the API thread is a benign race —
            # it only shifts WHEN the busy signal flips.
            raise SystemBusy("in-memory log over MaxInMemLogSize")
        entry, rs = self.pending_proposal.propose(
            session, cmd, self.tick_count + timeout_ticks
        )
        if span is not None:
            rs.span = span
            span.annotate("request:queued")
            self._trace_register(entry.key, span)
        with self._qlock:
            self.proposal_count += 1
            self._proposals.append(entry)
        self._wake()
        # stop() sets `stopped` BEFORE its drop_all sweep, so a future
        # allocated after the sweep always observes the flag here; one
        # allocated before it was swept already (seal pops-once, so the
        # overlap is benign).  Without this re-check a propose racing
        # stop_shard leaks a table entry no step loop or tick GC will
        # ever complete.
        if self.stopped:
            self.pending_proposal.seal(rs)
        return rs

    def propose_session_op(self, session: Session, timeout_ticks: int) -> RequestState:
        entry, rs = self.pending_proposal.propose(
            session, b"", self.tick_count + timeout_ticks
        )
        with self._qlock:
            self._proposals.append(entry)
        self._wake()
        if self.stopped:
            self.pending_proposal.seal(rs)
        return rs

    def read_index(self, timeout_ticks: int, span=None) -> RequestState:
        ctx, rs = self.pending_read_index.read(self.tick_count + timeout_ticks)
        if span is not None:
            rs.span = span
            span.annotate("request:queued")
        with self._qlock:
            self._read_indexes.append(ctx)
        self._wake()
        if self.stopped:
            self.pending_read_index.seal(rs)
        return rs

    def request_config_change(
        self, cc: ConfigChange, timeout_ticks: int
    ) -> RequestState:
        key, rs = self.pending_config_change.request(
            cc, self.tick_count + timeout_ticks
        )
        with self._qlock:
            self._config_changes.append((key, cc))
        self._wake()
        if self.stopped:
            self.pending_config_change.seal(rs)
        return rs

    def request_snapshot(self, overhead: int, timeout_ticks: int) -> RequestState:
        rs = self.pending_snapshot.request(self.tick_count + timeout_ticks)
        with self._qlock:
            self._snapshot_reqs.append((rs.key, overhead))
        self._wake()
        if self.stopped:
            self.pending_snapshot.seal(rs)
        return rs

    def request_leader_transfer(self, target: int, timeout_ticks: int) -> RequestState:
        rs = self.pending_leader_transfer.request(
            target, self.tick_count + timeout_ticks
        )
        with self._qlock:
            self._leader_transfers.append(target)
        self._wake()
        if self.stopped:
            self.pending_leader_transfer.seal(rs)
        return rs

    def enqueue_received(self, m: Message) -> None:
        if self.stopped:
            return  # a stopped replica drains nothing; don't grow the queue
        with self._qlock:
            self._received.append(m)
        self._wake()

    def enqueue_config_change_result(self, cc, accepted: bool) -> None:
        """Called from the apply worker; consumed by step (single-writer
        raft rule)."""
        with self._qlock:
            self._cc_to_apply.append((cc, accepted))

    def defer_ticks(self, n: int) -> None:
        """Push drained-but-unprocessed ticks back (overload backpressure:
        a step engine whose per-step input capacity is full processes what
        fits and defers the rest; the logical clock lags wall clock
        briefly instead of the row thrashing off the device)."""
        with self._qlock:
            self._pending_ticks += n

    def queued_inputs(self) -> int:
        """Depth of the step input queues (lock-free snapshot; scrape-
        time observability — same benign races as has_work)."""
        # raftlint: ignore[guarded-by] lock-free scrape-time snapshot
        return (
            len(self._received)
            + len(self._proposals)
            + len(self._read_indexes)
            + len(self._config_changes)
            + len(self._cc_to_apply)
            + len(self._snapshot_reqs)
            + len(self._leader_transfers)
        )

    def tick_lag(self) -> int:
        """Ticks granted by the host but not yet consumed by step
        (the engine-backlog signal; lock-free)."""
        # raftlint: ignore[guarded-by] lock-free scrape-time snapshot
        return (self._ticks_in - self._ticks_taken) + self._pending_ticks

    def has_work(self) -> bool:
        # lock-free reads: each container's truthiness/len is atomic
        # under the GIL, and has_work is only ever a HINT (the drain
        # under _qlock is the linearization point) — the colocated
        # coalesce scan calls this once per resident node per launch
        # generation, and the lock acquisition alone was ~60% of a
        # 294 s coalesce bill at 50k rows (SCALE_r05)
        # raftlint: ignore[guarded-by] lock-free hint; drain under _qlock linearizes
        if (
            self._received
            or self._proposals
            or self._read_indexes
            or self._config_changes
            or self._cc_to_apply
            or self._snapshot_reqs
            or self._leader_transfers
            or self._pending_ticks
            or self._ticks_in != self._ticks_taken
        ):
            return True
        return self.peer.has_update()

    # ------------------------------------------------------------------
    # step path (owning step worker only)
    # ------------------------------------------------------------------
    def drain_step_inputs(self) -> "StepInputs":
        """Atomically drain every input queue (the first half of stepNode;
        split out so a vectorized step engine can route drained inputs to
        the device or replay them on the scalar peer — ops/engine.py)."""
        # consume the lock-free ticker lane first (this step worker is
        # _ticks_taken's only writer).  The raft-clock backlog is capped
        # at one election window: a node stalled past that (e.g. behind
        # a one-off XLA compile) must not replay several CheckQuorum/
        # election windows back-to-back with no wall time for responses
        # between them.  Dropped ticks slow only the RAFT clock
        # (liveness-safe); they still advance the logical clock via
        # gc_ticks so pending-future deadlines don't stretch.
        lane = self._ticks_in - self._ticks_taken
        self._ticks_taken += lane
        with self._qlock:
            # swap, don't copy: non-empty queue lists hand over
            # wholesale and fresh empties replace them; empty inputs
            # stay the shared () from StepInputs.__init__
            total = self._pending_ticks + lane
            cap = self.config.election_rtt
            si = StepInputs(
                ticks=min(total, cap),
                gc_ticks=max(0, total - cap),
            )
            if self._received:
                si.received = self._received
                self._received = []
            if self._proposals:
                si.proposals = self._proposals
                self._proposals = []
            if self._read_indexes:
                si.read_indexes = self._read_indexes
                self._read_indexes = []
            if self._config_changes:
                si.config_changes = self._config_changes
                self._config_changes = []
            if self._cc_to_apply:
                si.cc_results = self._cc_to_apply
                self._cc_to_apply = []
            if self._leader_transfers:
                si.transfers = self._leader_transfers
                self._leader_transfers = []
            if self._snapshot_reqs:
                si.snapshot_reqs = self._snapshot_reqs
                self._snapshot_reqs = []
            self._pending_ticks = 0
        return si

    def drain_ticks_only(self, step_cap: int):
        """Consume ONLY the tick inputs — the lock-free ticker lane plus
        the deferred backlog — applying the same two caps as the full
        path (``drain_step_inputs``'s election-window gulp cap, then the
        per-launch ``step_cap`` with defer): one definition so the
        colocated fast tick lane and the full drain can never diverge.

        LOCKING: caller must be the only step consumer (the colocated
        engine's core lock), which serializes it against the OTHER step-
        side ``_pending_ticks`` writers — but NOT against
        ``grant_ticks``, which runs on producer threads under ``_qlock``
        only (NodeHost._wake_node unparking a quiesced node).  Any
        ``_pending_ticks`` read-modify-write therefore takes ``_qlock``;
        without it a node woken concurrently with a fast-lane step could
        lose up to an election window of credited ticks.

        FAST PATH (lock-free): when the deferred backlog reads 0 and the
        drained lane needs no defer, ``_pending_ticks`` is never
        written, so there is no RMW to order against ``grant_ticks`` —
        a grant racing the read simply stays queued for the next drain
        (the exact guarantee the locked path gives a grant arriving one
        instruction later).  This is the common shape of every fast-lane
        step, and at 250k resident rows the per-row ``_qlock``
        acquisition here was the single largest fast-lane cost left
        after the r6 host-plane vectorization (same finding as
        ``add_tick``'s lock elision at r5 scale).  Returns
        ``(ticks, gc_ticks)``."""
        lane = self._ticks_in - self._ticks_taken
        self._ticks_taken += lane
        if step_cap < 1:
            step_cap = 1
        # raftlint: ignore[guarded-by] lock-free backlog probe; non-zero falls to the locked path
        if not self._pending_ticks:
            cap = self.config.election_rtt
            ticks = lane if lane < cap else cap
            gc = lane - ticks
            if ticks <= step_cap:
                return ticks, gc
            with self._qlock:
                self._pending_ticks += ticks - step_cap
            return step_cap, gc
        with self._qlock:
            total = self._pending_ticks + lane
            ticks = min(total, self.config.election_rtt)
            gc = total - ticks
            if ticks > step_cap:
                self._pending_ticks = ticks - step_cap
                ticks = step_cap
            else:
                self._pending_ticks = 0
        return ticks, gc

    def step(self) -> Optional[Update]:
        """Drain inputs into the raft peer and produce this shard's Update
        (reference: node.stepNode [U])."""
        if self.stopped:
            return None
        return self.step_with_inputs(self.drain_step_inputs())

    def step_with_inputs(self, si: "StepInputs") -> Optional[Update]:
        """Run the scalar step on pre-drained inputs."""
        received = si.received
        proposals = si.proposals
        read_indexes = si.read_indexes
        config_changes = si.config_changes
        cc_results = si.cc_results
        transfers = si.transfers
        snapshot_reqs = si.snapshot_reqs
        ticks = si.ticks
        # cap ticks per step at half an election window: the reference's
        # ticker delivers ticks ONE at a time interleaved with message
        # processing [U]; our batched drain would otherwise gulp several
        # CheckQuorum/election windows in one step with zero wall time
        # for responses to arrive — a healthy leader would step itself
        # down.  Excess ticks are deferred (has_work re-arms the worker).
        cap = max(1, self.peer.raft.election_timeout // 2)
        if ticks > cap:
            self.defer_ticks(ticks - cap)
            si.ticks = ticks = cap

        # config-change application results from the apply loop
        for cc, accepted in cc_results:
            if accepted and cc is not None:
                self.peer.apply_config_change(cc)
            else:
                self.peer.reject_config_change()

        # activity-based quiesce exit / peer enter-hints
        if self.quiesce.enabled:
            for m in received:
                if m.type == MessageType.QUIESCE:
                    # no-leader gate (QuiesceManager.tick block=): never
                    # join a peer's quiesce while leaderless — parking a
                    # shard mid-election freezes the churn that would
                    # produce the leader
                    if self.peer.raft.leader_id:
                        self.quiesce.quiesce_hint()
                elif self.quiesce.record_activity(m.type):
                    self._poke_peers_out_of_quiesce()
            if proposals or read_indexes or config_changes or transfers:
                if self.quiesce.record_activity(MessageType.PROPOSE):
                    self._poke_peers_out_of_quiesce()

        # received-snapshot files are saved by the chunk sink before raft
        # decides; any install this step that raft does NOT accept must be
        # deleted or its rx file leaks forever (code-review finding)
        rx_candidates = [
            m.snapshot.filepath
            for m in received
            if m.type == MessageType.INSTALL_SNAPSHOT and m.snapshot.filepath
        ]

        tracer = self.tracer
        if tracer is None:
            for m in received:
                self.peer.handle(m)
        else:
            for m in received:
                if m.trace_id:
                    # follower side of a traced replicate: parent the
                    # append span to the leader's proposal span carried
                    # in the message — the cross-host stitch
                    fs = tracer.start_span(
                        "follower:append", m.trace_id, m.span_id,
                        shard_id=self.shard_id,
                    )
                    fs.annotate(
                        f"recv:{m.type.name} from={m.from_} "
                        f"entries={len(m.entries)}"
                    )
                    self.peer.handle(m)
                    fs.end()
                else:
                    self.peer.handle(m)

        if proposals:
            ts = self._trace_spans
            if ts:
                for e in proposals:
                    s = ts.get(e.key)
                    if s is not None:
                        s.annotate(f"step:proposed batch={len(proposals)}")
            self.peer.propose_entries(proposals)
        for key, cc in config_changes:
            self.peer.propose_config_change(cc, key)
        for ctx in read_indexes:
            self.peer.read_index(ctx)
        for target in transfers:
            self.peer.request_leader_transfer(target)
        for key, overhead in snapshot_reqs:
            self._save_snapshot_request(key, overhead)

        for _ in range(ticks):
            self.tick_count += 1
            was_quiesced = self.quiesce.quiesced
            if self.quiesce.tick(
                busy=self.peer.raft.catching_up_peers(),
                block=self.peer.raft.leader_id == 0,
            ):
                if not was_quiesced:  # newly entered: drag peers along
                    self.broadcast_quiesce_enter()
                self.peer.quiesced_tick()
            else:
                self.peer.tick()
            # tick-driven GC of timed-out futures: hint-gated — one
            # int compare per tick, a five-table single-lock sweep
            # only when the clock reaches the earliest pending
            # deadline (request.gc_tables keeps the timeout-delivery
            # tick exactly what the old sweep-every-tick loop gave)
            gc_tables(
                self.pending_tables, self.pending_deadline_hint,
                self.tick_count,
            )
        if si.gc_ticks:
            # backlog-dropped ticks: clock + deadline GC only (deadlines
            # are monotone, so one pass at the final count is exact)
            self.tick_count += si.gc_ticks
            gc_tables(
                self.pending_tables, self.pending_deadline_hint,
                self.tick_count,
            )

        self._check_leader_change()

        if not self.peer.has_update():
            for path in rx_candidates:  # every install was rejected
                self.snapshot_storage.remove(path)
            return None
        u = self.peer.get_update(last_applied=self.sm.last_applied)
        accepted_path = u.snapshot.filepath if not u.snapshot.is_empty() else None
        for path in rx_candidates:
            if path != accepted_path:
                self.snapshot_storage.remove(path)
        self.dispatch_dropped(u)
        return u

    def _trace_update(self, u: Update) -> None:
        """Annotate traced proposals along the raft path of one Update
        (step worker only) and stamp outbound REPLICATEs with trace
        context so the follower-side append spans stitch in.  Runs
        BEFORE process_update's send/persist so the stamped messages
        are what the transport actually carries."""
        # lookups are gated on APPLICATION entries: config-change keys
        # come from an INDEPENDENT sequential counter (request.py
        # _PendingBase) and collide with proposal keys — an ungated
        # ts.get would annotate (and stamp) the wrong span
        ts = self._trace_spans
        app = EntryType.APPLICATION
        for e in u.entries_to_save:
            if e.type != app:
                continue
            s = ts.get(e.key)
            if s is not None:
                s.annotate(f"raft:append index={e.index} term={e.term}")
        msgs = u.messages
        for i, m in enumerate(msgs):
            if m.type != MessageType.REPLICATE or not m.entries:
                continue
            for e in m.entries:
                if e.type != app:
                    continue
                s = ts.get(e.key)
                if s is not None:
                    msgs[i] = dataclasses.replace(
                        m, trace_id=s.trace_id, span_id=s.span_id
                    )
                    s.annotate(
                        f"raft:replicate to={m.to} entries={len(m.entries)}"
                    )
                    break
        for e in u.committed_entries:
            if e.type != app:
                continue
            s = ts.get(e.key)
            if s is not None:
                s.annotate(f"raft:committed index={e.index}")

    def _trace_committed(self, entries) -> None:
        """The committed leg of ``_trace_update`` alone, for the device
        merge tail's LANE rows (ops/engine.py): their commit advances
        carry no ``Update`` object, so the per-entry span annotation
        must ride the lane handoff directly.  Called only when
        ``_trace_spans`` is non-empty."""
        ts = self._trace_spans
        app = EntryType.APPLICATION
        for e in entries:
            if e.type != app:
                continue
            s = ts.get(e.key)
            if s is not None:
                s.annotate(f"raft:committed index={e.index}")

    def dispatch_dropped(self, u: Update) -> None:
        """Fail dropped-request futures fast (both step engines call this)."""
        ts = self._trace_spans
        if ts:
            for e in u.dropped_entries:
                # APPLICATION only: a config-change key colliding with a
                # live proposal key must not evict the proposal's span
                if e.type == EntryType.APPLICATION:
                    ts.pop(e.key, None)  # notify(DROPPED) ends the span
        for e in u.dropped_entries:
            # route by entry kind: proposal and config-change futures live
            # in different tables with independent key spaces
            if e.type == EntryType.CONFIG_CHANGE:
                # transient (no leader), not a membership-validation reject:
                # clients should retry
                self.pending_config_change.dropped(e.key)
            else:
                self.pending_proposal.dropped(e.key)
        for ctx in u.dropped_read_indexes:
            self.pending_read_index.dropped(ctx)

    def _sync_registry(self, membership: Membership) -> None:
        """Every replica (not just the API caller) must be able to resolve
        every member's address."""
        if self.registry is None:
            return
        for group in (
            membership.addresses,
            membership.non_votings,
            membership.witnesses,
        ):
            for pid, addr in group.items():
                if addr:
                    self.registry.add(self.shard_id, pid, addr)

    def _poke_peers_out_of_quiesce(self) -> None:
        # only the leader needs to poke (resume heartbeats, which reset
        # follower election timers); a woken follower's real traffic
        # (forwarded proposal, vote, replicate) wakes peers by itself
        if self.peer.is_leader():
            self.peer.raft.handle(Message(type=MessageType.LEADER_HEARTBEAT))

    def broadcast_wake(self) -> None:
        """Host-path quiesce-exit poke to every peer.  LEADER_HEARTBEAT
        is 'activity' to the quiesce manager and a no-op to follower
        raft, and mere DELIVERY unparks the peer's host node
        (enqueue_received -> wake), so its election clock runs again —
        the transport leg is what matters, not the payload."""
        for pid in sorted(self.peer.raft.addresses):
            if pid == self.replica_id:
                continue
            self.transport.send(
                Message(
                    type=MessageType.LEADER_HEARTBEAT,
                    to=pid,
                    from_=self.replica_id,
                    shard_id=self.shard_id,
                )
            )

    def broadcast_quiesce_enter(self) -> None:
        """Announce entering quiesce so peers join promptly (reference:
        pb.Quiesce [U]) — staggered entry would leave the leader
        heartbeating at already-quiesced followers."""
        for pid in sorted(self.peer.raft.addresses):
            if pid == self.replica_id:
                continue
            self.transport.send(
                Message(
                    type=MessageType.QUIESCE,
                    to=pid,
                    from_=self.replica_id,
                    shard_id=self.shard_id,
                )
            )

    def _check_leader_change(self) -> None:
        lid = self.peer.leader_id()
        if lid != self.leader_id:
            self.leader_id = lid
            if lid != 0:
                self.pending_leader_transfer.notify_leader(lid)
            elif self.quiesce.enabled and (
                self.quiesce.quiesced or self.quiesce.exit_grace > 0
            ):
                # the shard went LEADERLESS while (or right after)
                # being quiesced — the dead-leader-of-an-idle-shard
                # case.  Peer replicas may still be tick-PARKED on
                # their hosts with a stale leader view: parked clocks
                # never fire election timeouts, and device-routed
                # pre-votes alone do not unpark them, so without a
                # host-path poke the shard stays leaderless forever
                # (churn-audit finding: a quiesced 500-shard cluster
                # never re-elected after a leader kill).
                self.broadcast_wake()
            if self.on_leader_updated is not None:
                self.on_leader_updated(
                    self.shard_id, self.replica_id, self.peer.term(), lid
                )

    # ------------------------------------------------------------------
    # post-save processing (owning step worker; logdb write already done)
    # ------------------------------------------------------------------
    def process_update(self, u: Update) -> bool:
        """reference: node.processRaftUpdate + commitRaftUpdate [U].
        Returns True if apply work was scheduled."""
        if self._trace_spans:
            self._trace_update(u)
        scheduled = False
        if not u.snapshot.is_empty():
            self._install_snapshot(u.snapshot)
            # the queued SNAPSHOT_RECOVER task needs the apply worker
            # NOW: an install with no trailing committed entries (a
            # fully-compacted leader log and a quiet shard — the normal
            # big-state catch-up shape) otherwise sits unrecovered until
            # unrelated traffic schedules an apply, and a quiet follower
            # stays at applied=0 forever while the leader believes it
            # caught up (found by the bigstate TCP verify drive)
            scheduled = True
        if u.entries_to_save:
            ents = u.entries_to_save
            check(
                all(
                    ents[i].index + 1 == ents[i + 1].index
                    for i in range(len(ents) - 1)
                ),
                "entries_to_save not contiguous: %s",
                [e.index for e in ents[:8]],
            )
            check(
                u.state.is_empty() or u.state.commit <= ents[-1].index
                or u.state.commit <= self.log_reader.last_index()
                or not u.snapshot.is_empty(),
                "hard-state commit %d beyond save window",
                u.state.commit,
            )
            self.log_reader.append(u.entries_to_save)
        for m in u.messages:
            self.transport.send(m)
        if u.ready_to_reads:
            for rtr in u.ready_to_reads:
                self.pending_read_index.confirmed(rtr.system_ctx, rtr.index)
            # the read index may already be applied (idle shard): complete now
            self.pending_read_index.applied(self.sm.last_applied)
        if u.committed_entries:
            self.sm.task_queue.add(
                Task(type=TaskType.ENTRIES, entries=u.committed_entries)
            )
            scheduled = True
        self.peer.commit(u)
        return scheduled

    def _install_snapshot(self, ss: Snapshot) -> None:
        """A received snapshot reached the log (InstallSnapshot accepted)."""
        self.log_reader.apply_snapshot(ss)
        self.sm.task_queue.add(Task(type=TaskType.SNAPSHOT_RECOVER, snapshot=ss))

    # ------------------------------------------------------------------
    # apply path (owning apply worker only)
    # ------------------------------------------------------------------
    def apply(self) -> None:
        """Drain the task queue through the RSM (reference:
        engine applyWorkerMain -> rsm Handle [U])."""
        with self._apply_lock:
            if self.stopped:
                return
            self._apply_locked()

    def _apply_locked(self) -> None:
        for task in self.sm.task_queue.get_all():
            if task.type == TaskType.ENTRIES:
                results = self.sm.handle(task)
                self._complete_applied(results)
                self._applied_since_snapshot += len(task.entries)
            elif task.type == TaskType.SNAPSHOT_RECOVER:
                self._recover_from_snapshot(task.snapshot)
        self.pending_read_index.applied(self.sm.last_applied)
        self.peer.notify_raft_last_applied(self.sm.last_applied)
        if (
            self.config.snapshot_entries > 0
            and self._applied_since_snapshot >= self.config.snapshot_entries
        ):
            self._applied_since_snapshot = 0
            with self._qlock:
                self._snapshot_reqs.append((0, self.config.compaction_overhead))

    def _complete_applied(self, results: List[ApplyResult]) -> None:
        for r in results:
            e = r.entry
            if r.config_change is not None or (
                e.type == EntryType.CONFIG_CHANGE
            ):
                self.enqueue_config_change_result(r.config_change, not r.rejected)
                if not r.rejected and r.config_change is not None:
                    cc = r.config_change
                    if self.registry is not None:
                        if cc.type == ConfigChangeType.REMOVE_REPLICA:
                            self.registry.remove(self.shard_id, cc.replica_id)
                        elif cc.address:
                            self.registry.add(
                                self.shard_id, cc.replica_id, cc.address
                            )
                if self.notify_work is not None:
                    self.notify_work()
                self.pending_config_change.applied(e.key, r.rejected)
                if self.events is not None and not r.rejected:
                    self.events.membership_changed(
                        NodeInfoEvent(self.shard_id, self.replica_id)
                    )
            elif e.key:
                ts = self._trace_spans
                if ts:
                    # NOT popped at apply: a REPLICATE re-sent to a
                    # lagging/healed follower AFTER the leader applied
                    # must still find the span so it carries real trace
                    # context and the follower's append leg stitches
                    # into the merged timeline (the ROADMAP obs gap —
                    # safe since PR 5's randomized per-table key bases
                    # shrank cross-replica key collisions to ~2^-47).
                    # Ended entries are evicted by the _trace_register
                    # prune amortizer, which bounds the map.
                    s = ts.get(e.key)
                    if s is not None:
                        s.annotate(
                            f"rsm:applied index={e.index}"
                            f"{' rejected' if r.rejected else ''}"
                        )
                self.pending_proposal.applied(e.key, r.result, r.rejected)

    # ------------------------------------------------------------------
    # device-resident reads (the engine's ReadIndex hot path)
    # ------------------------------------------------------------------
    def handle_device_read_resp(self, m: Message) -> None:
        """Synthetic READ_INDEX_RESP-to-self emitted by the device kernel
        (ops/kernel._handle_read_index): reject -> drop; log_index==0 ->
        request recorded at index=m.commit; log_index==K -> voter K
        confirmed the ctx.  Quorum tracking is host-side because the SoA
        state has no per-ctx table; correctness only needs the count of
        DISTINCT voters that echoed the ctx, which is what device_reads
        accumulates (reference: internal/raft/readindex.go [U])."""
        ctx = SystemCtx(low=m.hint, high=m.hint_high)
        if m.reject:
            self.device_reads.drop(ctx)
            self.pending_read_index.dropped(ctx)
            return
        if m.log_index == 0:
            if self.peer.raft.quorum() <= 1:
                self.pending_read_index.confirmed(ctx, m.commit)
                self.pending_read_index.applied(self.sm.last_applied)
            else:
                self.device_reads.add_request(m.commit, ctx, 0)
            return
        done = self.device_reads.confirm(
            ctx, m.log_index, self.peer.raft.quorum()
        )
        if done:
            for s in done:
                self.pending_read_index.confirmed(s.ctx, s.index)
            self.pending_read_index.applied(self.sm.last_applied)

    def drop_device_reads(self) -> None:
        """Leadership lost / row left the device: fail pending device
        reads so clients retry (mirrors Raft.drop_pending_read_indexes)."""
        for low, high in list(self.device_reads.queue):
            self.pending_read_index.dropped(SystemCtx(low=low, high=high))
        self.device_reads.clear()

    def _recover_sm_from_storage(self, ss: Snapshot) -> None:
        """Open the v2 container and restore the SM + sessions +
        membership through it, resolving external files to absolute
        paths in the snapshot dir (reference: rsm recover +
        ISnapshotFileCollection restore [U])."""
        f = self.snapshot_storage.open_read(ss.filepath)
        try:
            reader = SnapshotReader(f)
            files = [
                dataclasses.replace(
                    sf,
                    filepath=self.snapshot_storage.external_path(
                        ss.filepath, sf.filepath
                    ),
                )
                for sf in reader.external_files
            ]
            for sf in files:
                if not os.path.exists(sf.filepath):
                    raise IOError(
                        f"snapshot external file missing: {sf.filepath}"
                    )
            self.sm.recover_from_snapshot_stream(reader, files)
        finally:
            f.close()

    def _recover_from_snapshot(self, ss: Snapshot) -> None:
        if ss.dummy or self.config.is_witness:
            self.sm.last_applied = max(self.sm.last_applied, ss.index)
            self.sm.members.restore(ss.membership)
            return
        try:
            self._recover_sm_from_storage(ss)
        except Exception as e:  # noqa: BLE001 — any load/decode failure
            # the raft log was already reset to ss.index; applying anything
            # past it without this state would silently diverge — halt the
            # replica loudly instead (reference: dragonboat panics on
            # snapshot recovery failure [U])
            _log.critical(
                "[%d:%d] FATAL: snapshot %d unrecoverable (%s); halting replica",
                self.shard_id,
                self.replica_id,
                ss.index,
                e,
            )
            self.stopped = True
            raise
        self._sync_registry(ss.membership)
        if self.events is not None:
            self.events.snapshot_recovered(
                SnapshotInfo(self.shard_id, self.replica_id, ss.replica_id, ss.index)
            )

    # ------------------------------------------------------------------
    # snapshotting (step-worker context for now; dedicated workers later)
    # ------------------------------------------------------------------
    def _snapshot_compression(self):
        """The per-block codec recorded in the container AND in the
        Snapshot meta (reference: SnapshotCompression config [U]).
        Compression now lives INSIDE the v2 container (per block, self-
        describing), so cross-host recovery never depends on out-of-band
        metadata surviving the chunk lane."""
        want = CompressionType(self.config.snapshot_compression)
        if want == CompressionType.SNAPPY and _try_snappy() is None:
            return CompressionType.ZLIB  # meta records what is actually used
        return want

    def _save_snapshot_request(self, key: int, overhead: int) -> None:
        """Save a snapshot of the current applied state and compact the log
        (reference: rsm.SaveSnapshot + snapshotter [U])."""
        if self._snapshotting:
            if key:
                self.pending_snapshot.done(key, 0, failed=True)
            return
        self._snapshotting = True
        try:
            with self._apply_lock:
                if self.stopped:
                    if key:
                        self.pending_snapshot.done(key, 0, failed=True)
                    return
                index = self.sm.last_applied
                prev = self.logdb.get_snapshot(self.shard_id, self.replica_id)
                if index == 0 or prev.index >= index:
                    if key:
                        self.pending_snapshot.done(key, 0, failed=True)
                    return
                compression = self._snapshot_compression()

            def build(fileobj, copy_fn):
                coll = SnapshotFileCollection(copy_fn)
                # the SM streams through the v2 block writer with
                # bounded memory (storage/snapshotio.py); external
                # files are staged beside the container by copy_fn
                return self.sm.save_snapshot_stream(
                    fileobj,
                    coll,
                    compression=int(compression),
                )

            # the streamed save runs OUTSIDE _apply_lock so a long
            # disk write never stalls the apply pipeline: regular SMs
            # serialize under rsm._mu anyway, concurrent/on-disk SMs
            # prepare under it and stream concurrently (reference: rsm
            # concurrent snapshot [U]).  _sm_close_lock only excludes
            # stop() closing the user SM mid-save.  The container's
            # index is captured under rsm._mu inside build; the dir is
            # named from that result, so name and content agree even
            # when applies advance past the pre-check index.
            with self._sm_close_lock:
                if self.stopped:
                    if key:
                        self.pending_snapshot.done(key, 0, failed=True)
                    return
                filepath, (index, term, _files) = (
                    self.snapshot_storage.save_stream(
                        self.shard_id,
                        self.replica_id,
                        index,
                        build,
                        index_from_result=lambda res: res[0],
                    )
                )
            ss = Snapshot(
                filepath=filepath,
                file_size=self.snapshot_storage.file_size(filepath),
                index=index,
                term=term,
                membership=self.sm.get_membership(),
                shard_id=self.shard_id,
                replica_id=self.replica_id,
                compression=compression,
            )
            u = Update(
                shard_id=self.shard_id, replica_id=self.replica_id, snapshot=ss
            )
            self.logdb.save_snapshots([u])
            # the reader must know the snapshot so the leader can stream it
            # to followers that fall behind the compaction point
            self.log_reader.create_snapshot(ss)
            compact_to = max(0, index - max(overhead, 0))
            if compact_to > 0:
                # compact the reader first: it snapshots the boundary term
                # while the entry is still readable in the logdb
                self.log_reader.compact(compact_to)
                self.logdb.remove_entries_to(
                    self.shard_id, self.replica_id, compact_to
                )
            if not prev.is_empty():
                self._retired_snapshots.append(prev.filepath)
                self._gc_retired_snapshots()
            if key:
                self.pending_snapshot.done(key, index)
            if self.events is not None:
                self.events.snapshot_created(
                    SnapshotInfo(self.shard_id, self.replica_id, 0, index)
                )
                if compact_to > 0:
                    self.events.log_compacted(
                        EntryInfo(self.shard_id, self.replica_id, compact_to)
                    )
        finally:
            self._snapshotting = False

    def _gc_retired_snapshots(self) -> None:
        """Delete superseded snapshot files, keeping the newest retiree one
        generation longer (see the field comment)."""
        for p in self._retired_snapshots[:-1]:
            self.snapshot_storage.remove(p)
        del self._retired_snapshots[:-1]

    # ------------------------------------------------------------------
    # leader-lease reads (gateway/ front plane; docs/GATEWAY.md)
    # ------------------------------------------------------------------
    def lease_remaining_ticks(self) -> int:
        """Ticks of CheckQuorum leader lease left, or 0 when no lease.

        The lease argument (docs/GATEWAY.md "Lease-read safety"): with
        ``check_quorum`` on, every follower refuses to grant votes while
        it heard from a live leader within its own election window
        (``Raft._in_lease``), so no challenger can be elected until one
        full election window after a majority last heard from us; the
        leader renews the lease on every quorum of replicate/heartbeat
        responses (``Raft.lease_remaining_ticks`` over the remotes'
        ``last_resp_tick``), so a healthy leader holds it continuously
        instead of saw-toothing with the check-quorum boundary.
        Serving a local read additionally requires (same as ReadIndex
        serving):

        * a committed entry in the CURRENT term (a fresh leader's
          commit index is not yet proven current);
        * ``last_applied`` caught up to the local commit index, so the
          lookup observes every entry this leader committed.

        Callers keep a safety margin (ticks are per-host logical
        clocks; the hosts' tickers drift) — see
        ``NodeHost.try_lease_read``.  Lock-free probe off producer
        threads: every field read is one GIL-atomic load, and a lease
        lost immediately after a True answer is exactly the race the
        margin exists for."""
        if self.stopped or self.stopping:
            return 0
        r = self.peer.raft
        if not r.check_quorum or not self.peer.is_leader():
            return 0
        try:
            if not r.committed_entry_in_current_term():
                return 0
            if self.sm.last_applied < r.log.committed:
                return 0
            # inside the guard too: it copies the membership dicts,
            # which a concurrently-applying config change mutates
            # (review finding — "dictionary changed size" would crash
            # a metrics scrape)
            return r.lease_remaining_ticks()
        except Exception:  # noqa: BLE001 — racing a concurrent step's
            # log/membership mutation (compaction/append/config
            # change): no lease this probe
            return 0

    def lease_held(self, margin_ticks: int = 2) -> bool:
        """True when the CheckQuorum lease has more than ``margin_ticks``
        left — the gateway's fast-read gate."""
        return self.lease_remaining_ticks() > margin_ticks

    def bounded_read_probe(self, bound_ticks: int) -> tuple:
        """BOUNDED_STALENESS serving gate (readplane/,
        docs/READPLANE.md): returns ``(ok, applied_index,
        staleness_ticks)``.  ``ok`` means this replica may serve a
        local read stamped ``staleness_ticks`` stale without exceeding
        ``bound_ticks``:

        * a leader serves at staleness 0 (its state is current);
        * a follower serves iff it has a leader, heard from it within
          ``bound_ticks`` (``election_tick`` resets on leader traffic),
          AND has applied everything up to the leader's last-known
          UNCAPPED commit (``Raft.leader_commit_hint``) — fresh
          heartbeats alone must not let a still-recovering replica
          serve arbitrarily old state as "bounded".

        Lock-free probe off producer threads, same contract as
        ``lease_remaining_ticks``: every read is one GIL-atomic load
        and a state change right after a True answer is absorbed by the
        bound itself (the stamp is conservative — staleness can only
        have been SMALLER when the fields were loaded)."""
        if self.stopped or self.stopping:
            return False, 0, 0
        r = self.peer.raft
        applied = self.sm.last_applied
        try:
            if self.peer.is_leader():
                return True, applied, 0
            if r.leader_id == 0:
                return False, applied, bound_ticks + 1
            staleness = r.election_tick
            if staleness > bound_ticks:
                return False, applied, staleness
            if applied < r.leader_commit_hint:
                return False, applied, staleness
            return True, applied, staleness
        except Exception:  # noqa: BLE001 — racing a concurrent step's
            # mutation (same guard as lease_remaining_ticks): shed this
            # probe rather than serve on torn state
            return False, applied, bound_ticks + 1

    # ------------------------------------------------------------------
    def get_membership(self) -> Membership:
        return self.sm.get_membership()

    def lookup(self, query):
        return self.sm.lookup(query)

    def stale_read(self, query):
        return self.sm.lookup(query)

    def stop(self) -> None:
        self.stopping = True
        self.stopped = True
        self._stop_event.set()
        self.pending_proposal.drop_all()
        self.pending_read_index.drop_all()
        self.pending_config_change.drop_all()
        self.pending_snapshot.drop_all()
        self.pending_leader_transfer.drop_all()
        # retired files can't be referenced once this replica is down
        # (receivers own their streamed copies); reclaim them so restarts
        # don't orphan files
        for p in self._retired_snapshots:
            self.snapshot_storage.remove(p)
        self._retired_snapshots = []
        # wait for any in-flight apply before closing the user SM
        with self._apply_lock, self._sm_close_lock:
            self.sm.managed.close()
