"""Pluggable storage + transport contracts and listener event types.

reference: raftio/ (logdb.go, transport.go, rpc.go events) [U].
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .pb import Chunk, Entry, MessageBatch, Snapshot, State, Update


# ---------------------------------------------------------------------------
# LogDB (reference: raftio/logdb.go ILogDB [U])
# ---------------------------------------------------------------------------
@dataclass
class RaftState:
    """What ReadRaftState returns at restart."""

    state: State = field(default_factory=State)
    first_index: int = 0
    entry_count: int = 0


@dataclass
class NodeInfo:
    shard_id: int = 0
    replica_id: int = 0


class ILogDB(abc.ABC):
    """Persistent log storage contract.  ``save_raft_state`` is atomic for
    the whole batch of updates (entries + HardState + snapshot refs) and is
    the single fsync point of the write path."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def list_node_info(self) -> List[NodeInfo]: ...

    @abc.abstractmethod
    def save_bootstrap_info(
        self, shard_id: int, replica_id: int, bootstrap
    ) -> None: ...

    @abc.abstractmethod
    def get_bootstrap_info(self, shard_id: int, replica_id: int): ...

    @abc.abstractmethod
    def save_raft_state(self, updates: List[Update], worker_id: int) -> None: ...

    def save_state_lanes(
        self,
        shard_ids: List[int],
        replica_ids: List[int],
        terms: List[int],
        votes: List[int],
        commits: List[int],
        worker_id: int,
    ) -> None:
        """Batched hard-state-only save for the device merge tail's
        LANE rows (ops/hostplane.UpdateLanes): one call persists the
        (term, vote, commit) triple of many replicas with no per-row
        ``pb.Update`` carrier — the per-affected-row object walk was
        the residual host-plane wall at 50k-250k rows (ISSUE 13).

        Default implementation delegates through ``save_raft_state``
        with minimal state-only Updates, so every ILogDB — and any
        fault plane wrapped around its save path — behaves exactly as
        if the merge tail had emitted classic per-row updates.
        Implementations with a cheap hard-state slot (InMemLogDB)
        override with a direct batched write.  Atomicity/fsync
        contract is save_raft_state's.

        Optional slot protocol: a store may additionally expose
        ``state_lane_slot(shard_id, replica_id) -> int`` and
        ``save_state_slots(slots, terms, votes, commits, worker_id)``
        (vectorized scatter by pre-registered slot).  The engine
        detects the pair via ``getattr`` and caches slots per node
        (``Node.hs_lane_slot``); stores without it — including fault
        planes wrapped around the save path — get the list form
        above, so injected save faults still fire."""
        self.save_raft_state(
            [
                Update(
                    shard_id=s,
                    replica_id=r,
                    state=State(term=t, vote=v, commit=c),
                    has_update=True,
                )
                for s, r, t, v, c in zip(
                    shard_ids, replica_ids, terms, votes, commits
                )
            ],
            worker_id,
        )

    @abc.abstractmethod
    def read_raft_state(
        self, shard_id: int, replica_id: int, last_index: int
    ) -> Optional[RaftState]: ...

    @abc.abstractmethod
    def iterate_entries(
        self,
        shard_id: int,
        replica_id: int,
        low: int,
        high: int,
        max_size: int,
    ) -> List[Entry]: ...

    @abc.abstractmethod
    def term(self, shard_id: int, replica_id: int, index: int) -> Optional[int]: ...

    @abc.abstractmethod
    def remove_entries_to(
        self, shard_id: int, replica_id: int, index: int
    ) -> None: ...

    @abc.abstractmethod
    def compact_entries_to(
        self, shard_id: int, replica_id: int, index: int
    ) -> None: ...

    @abc.abstractmethod
    def save_snapshots(self, updates: List[Update]) -> None: ...

    @abc.abstractmethod
    def get_snapshot(self, shard_id: int, replica_id: int) -> Snapshot: ...

    @abc.abstractmethod
    def remove_node_data(self, shard_id: int, replica_id: int) -> None: ...

    @abc.abstractmethod
    def import_snapshot(self, snapshot: Snapshot, replica_id: int) -> None: ...


# ---------------------------------------------------------------------------
# Transport (reference: raftio/transport.go ITransport [U])
# ---------------------------------------------------------------------------
class IConnection(abc.ABC):
    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def send_message_batch(self, batch: MessageBatch) -> None: ...


class ISnapshotConnection(abc.ABC):
    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def send_chunk(self, chunk: Chunk) -> None: ...

    def query_resume(self, probe: Chunk) -> int:
        """Ask the receiver for its receive cursor on the stream whose
        identity ``probe`` carries (transport.chunk.resume_probe): the
        next chunk offset it needs, 0 for restart-from-scratch.
        Transports without a resume channel keep the default — a
        reconnected sender then restarts at chunk 0 and the receiver's
        idempotent re-delivery path discards what it already wrote."""
        return 0


MessageHandler = Callable[[MessageBatch], None]
ChunkHandler = Callable[[Chunk], bool]


class ITransport(abc.ABC):
    """reference: raftio.ITransport (v3 IRaftRPC) [U].

    Implementations SHOULD pass every outbound payload through
    ``self.fault_injector.on_wire(source, target, payload)`` when the
    attribute is non-None — that is the contract that lets the unified
    nemesis (faults.FaultController) inject partitions, loss, delay,
    duplication, reordering and chunk corruption on any transport
    (see docs/FAULTS.md).
    """

    # the unified fault plane; None in production.  fault_source is the
    # identity to report as `source` to on_wire — the Transport wrapper
    # sets it to the RAFT address (what fault plans target), which may
    # differ from a bind/listen address
    fault_injector = None
    fault_source = None

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def start(self) -> None: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def get_connection(self, target: str) -> IConnection: ...

    @abc.abstractmethod
    def get_snapshot_connection(self, target: str) -> ISnapshotConnection: ...


# ---------------------------------------------------------------------------
# Event listener payloads (reference: raftio/events.go [U])
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LeaderInfo:
    shard_id: int
    replica_id: int
    term: int
    leader_id: int


@dataclass(frozen=True)
class NodeInfoEvent:
    shard_id: int
    replica_id: int


@dataclass(frozen=True)
class SnapshotInfo:
    shard_id: int
    replica_id: int
    from_: int
    index: int


@dataclass(frozen=True)
class EntryInfo:
    shard_id: int
    replica_id: int
    index: int


@dataclass(frozen=True)
class ConnectionInfo:
    address: str
    snapshot_connection: bool


@dataclass(frozen=True)
class BalanceMoveInfo:
    """One rebalancing move transition (balance/ control plane).

    ``step`` is the move state the transition refers to: ``plan``,
    ``add``, ``catchup``, ``catchup_progress``, ``transfer``,
    ``remove``, ``rollback``.  ``src``/``dst`` are host keys (raft
    addresses); for pure leadership transfers ``replica_id`` is the
    transfer target.  ``detail`` carries step-specific context — for
    ``catchup_progress`` the live ``snapshot_stream_*`` numbers
    (bytes moved, resume count, ETA) so operators watching move events
    see TRANSFER progress instead of a blind applied-index poll.
    """

    shard_id: int
    kind: str
    src: str
    dst: str
    replica_id: int
    step: str = ""
    detail: str = ""


class IRaftEventListener(abc.ABC):
    @abc.abstractmethod
    def leader_updated(self, info: LeaderInfo) -> None: ...


class ISystemEventListener:
    """Optional callbacks; default implementations are no-ops so users
    override only what they need (reference: ISystemEventListener [U])."""

    def node_host_shutting_down(self) -> None: ...

    def node_ready(self, info: NodeInfoEvent) -> None: ...

    def node_unloaded(self, info: NodeInfoEvent) -> None: ...

    def membership_changed(self, info: NodeInfoEvent) -> None: ...

    def connection_established(self, info: ConnectionInfo) -> None: ...

    def connection_failed(self, info: ConnectionInfo) -> None: ...

    def send_snapshot_started(self, info: SnapshotInfo) -> None: ...

    def send_snapshot_completed(self, info: SnapshotInfo) -> None: ...

    def send_snapshot_aborted(self, info: SnapshotInfo) -> None: ...

    def snapshot_received(self, info: SnapshotInfo) -> None: ...

    def snapshot_recovered(self, info: SnapshotInfo) -> None: ...

    def snapshot_created(self, info: SnapshotInfo) -> None: ...

    def snapshot_compacted(self, info: SnapshotInfo) -> None: ...

    def log_compacted(self, info: EntryInfo) -> None: ...

    def log_db_compacted(self, info: EntryInfo) -> None: ...

    # -- balance/ control-plane transitions (no reference equivalent:
    # upstream stops at mechanism and leaves placement to the user) --
    def balance_move_started(self, info: BalanceMoveInfo) -> None: ...

    def balance_move_step(self, info: BalanceMoveInfo) -> None: ...

    def balance_move_completed(self, info: BalanceMoveInfo) -> None: ...

    def balance_move_failed(self, info: BalanceMoveInfo) -> None: ...

    def balance_move_rolled_back(self, info: BalanceMoveInfo) -> None: ...
