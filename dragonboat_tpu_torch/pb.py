"""Wire and state types for the TPU-native multi-group Raft framework.

This is the Python analogue of the reference's ``raftpb`` package
(reference: raftpb/raft.proto -> raft.pb.go [U] — see SURVEY.md provenance:
the reference mount was empty, citations are path-level reconstructions).

Design notes (TPU-first):
  * Every protocol scalar is an integer so that the hot subset of these
    types has a direct struct-of-arrays tensor encoding (see
    ``dragonboat_tpu.ops.state``).  ``MessageType`` values are stable and
    are used verbatim as the integer type-tags in the device message batch.
  * Dataclasses here are the host-side "scalar" view; the device-side view
    is the SoA pytree in ``ops/state.py``.  ``Update`` is the single I/O
    contract between the pure step function and the host runtime, exactly
    mirroring the reference's ``pb.Update`` (raftpb [U]).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# 64-bit width policy (docs/PARITY.md): every protocol integer is a
# uint64, as in the reference's raftpb.  Host structures carry Python's
# unbounded ints, so every serialization boundary masks with MASK64 —
# encode wraps like the reference's uint64 arithmetic instead of raising
# struct.error mid-persist.  raftlint's `width-64` rule pins the policy
# at the codec pack sites.
MASK64 = 0xFFFFFFFFFFFFFFFF


class MessageType(enum.IntEnum):
    """Raft message types (reference: raftpb MessageType enum [U]).

    The numeric values double as device-side type tags; the "hot set"
    (TICK..READ_INDEX_RESP) is handled by the vectorized kernel, the rest
    escalate to the host scalar path.
    """

    NO_OP = 0
    # --- hot set: handled by the TPU step kernel -------------------------
    LOCAL_TICK = 1
    ELECTION = 2              # local: campaign request (tick timeout fired)
    PROPOSE = 3               # local: client proposal (leader append)
    REPLICATE = 4             # MsgApp: leader -> follower entries
    REPLICATE_RESP = 5        # MsgAppResp
    REQUEST_VOTE = 6
    REQUEST_VOTE_RESP = 7
    REQUEST_PREVOTE = 8
    REQUEST_PREVOTE_RESP = 9
    HEARTBEAT = 10
    HEARTBEAT_RESP = 11
    READ_INDEX = 12           # local: client read hint
    READ_INDEX_RESP = 13
    # --- cold set: host scalar path --------------------------------------
    INSTALL_SNAPSHOT = 14
    SNAPSHOT_STATUS = 15      # local report: streaming result to leader
    SNAPSHOT_RECEIVED = 16
    UNREACHABLE = 17          # local report: transport failure
    LEADER_TRANSFER = 18      # local: admin request
    TIMEOUT_NOW = 19
    QUIESCE = 20
    CHECK_QUORUM = 21
    CONFIG_CHANGE_EVENT = 22  # local: apply/reject config change
    RATE_LIMIT = 23
    LEADER_HEARTBEAT = 24     # quiesce-exit poke
    BATCHED_READ_INDEX = 25


class EntryType(enum.IntEnum):
    """reference: raftpb EntryType [U]."""

    APPLICATION = 0
    CONFIG_CHANGE = 1
    ENCODED = 2      # client-compressed payload
    METADATA = 3     # empty entry appended on leader election


class ConfigChangeType(enum.IntEnum):
    """reference: raftpb ConfigChangeType [U] (v4 names)."""

    ADD_REPLICA = 0
    REMOVE_REPLICA = 1
    ADD_NON_VOTING = 2
    ADD_WITNESS = 3


class CompressionType(enum.IntEnum):
    NO_COMPRESSION = 0
    SNAPPY = 1
    ZLIB = 2  # the built-in codec (snappy needs the optional module)


NO_LEADER = 0
NO_NODE = 0


@dataclass(frozen=True)
class State:
    """Raft HardState — must be durable before messages are sent.

    reference: raftpb.State{Term, Vote, Commit} [U].
    """

    term: int = 0
    vote: int = 0
    commit: int = 0

    def is_empty(self) -> bool:
        return self.term == 0 and self.vote == 0 and self.commit == 0


EMPTY_STATE = State()


@dataclass(frozen=True)
class Entry:
    """A raft log entry (reference: raftpb.Entry [U]).

    ``key`` correlates a proposal with its pending future; ``client_id`` /
    ``series_id`` / ``responded_to`` implement exactly-once client sessions
    (reference: client/session.go [U]).
    """

    term: int = 0
    index: int = 0
    type: EntryType = EntryType.APPLICATION
    key: int = 0
    client_id: int = 0
    series_id: int = 0
    responded_to: int = 0
    cmd: bytes = b""

    def is_noop(self) -> bool:
        return (
            self.type == EntryType.APPLICATION
            and not self.cmd
            and self.client_id == 0
        )

    def is_config_change(self) -> bool:
        return self.type == EntryType.CONFIG_CHANGE

    def is_session_managed(self) -> bool:
        from .client import NOOP_SERIES_ID

        return self.client_id != 0 and self.series_id != NOOP_SERIES_ID

    def is_new_session_request(self) -> bool:
        from .client import SERIES_ID_REGISTER

        return (
            self.type == EntryType.APPLICATION
            and self.client_id != 0
            and self.series_id == SERIES_ID_REGISTER
        )

    def is_end_session_request(self) -> bool:
        from .client import SERIES_ID_UNREGISTER

        return (
            self.type == EntryType.APPLICATION
            and self.client_id != 0
            and self.series_id == SERIES_ID_UNREGISTER
        )

    def size_bytes(self) -> int:
        return len(self.cmd) + 64


@dataclass(frozen=True)
class Membership:
    """Group membership (reference: raftpb.Membership [U]).

    ``addresses`` maps voter replica-id -> target address; non_votings and
    witnesses likewise. ``removed`` is the tombstone set.
    """

    config_change_id: int = 0
    addresses: dict = field(default_factory=dict)       # replica_id -> addr
    non_votings: dict = field(default_factory=dict)
    witnesses: dict = field(default_factory=dict)
    removed: dict = field(default_factory=dict)         # replica_id -> True

    def copy(self) -> "Membership":
        return Membership(
            config_change_id=self.config_change_id,
            addresses=dict(self.addresses),
            non_votings=dict(self.non_votings),
            witnesses=dict(self.witnesses),
            removed=dict(self.removed),
        )


@dataclass(frozen=True)
class ConfigChange:
    """reference: raftpb.ConfigChange [U]."""

    config_change_id: int = 0
    type: ConfigChangeType = ConfigChangeType.ADD_REPLICA
    replica_id: int = 0
    address: str = ""
    initialize: bool = False


@dataclass(frozen=True)
class SnapshotFile:
    """External file attached to a snapshot (reference: raftpb.SnapshotFile [U])."""

    file_id: int = 0
    filepath: str = ""
    file_size: int = 0
    metadata: bytes = b""


@dataclass(frozen=True)
class Snapshot:
    """Snapshot metadata (reference: raftpb.Snapshot [U]).

    ``filepath`` points at the finalized snapshot dir/file on the host;
    ``dummy`` marks witness snapshots that carry no data.
    """

    filepath: str = ""
    file_size: int = 0
    index: int = 0
    term: int = 0
    membership: Membership = field(default_factory=Membership)
    files: Tuple[SnapshotFile, ...] = ()
    checksum: bytes = b""
    dummy: bool = False
    shard_id: int = 0
    replica_id: int = 0
    on_disk_index: int = 0       # on-disk SM: applied index at Open()
    witness: bool = False
    imported: bool = False
    type: int = 0
    compression: CompressionType = CompressionType.NO_COMPRESSION

    def is_empty(self) -> bool:
        return self.index == 0


EMPTY_SNAPSHOT = Snapshot()


@dataclass(frozen=True)
class ManifestFile:
    """One file of a portable snapshot archive (bigstate/dr.py): name
    relative to the archive dir, size, whole-file sha256 (hex) and the
    crc32 of each ``chunk_size`` slice — the import side verifies
    slices with bounded memory and localizes corruption to a chunk."""

    name: str = ""
    size: int = 0
    sha256: str = ""
    chunk_crcs: Tuple[int, ...] = ()


@dataclass(frozen=True)
class SnapshotManifest:
    """Self-describing metadata of a portable snapshot archive — the
    disaster-recovery interchange format (NodeHost.export_snapshot /
    import_snapshot; docs/BIGSTATE.md).  Serialized as MANIFEST.json by
    bigstate/dr.py so an archive is inspectable with nothing but a JSON
    reader; ``format_version`` gates future layout changes."""

    format_version: int = 1
    shard_id: int = 0
    replica_id: int = 0
    index: int = 0
    term: int = 0
    on_disk: bool = False
    chunk_size: int = 0
    compression: CompressionType = CompressionType.NO_COMPRESSION
    membership: Membership = field(default_factory=Membership)
    files: Tuple[ManifestFile, ...] = ()


@dataclass(frozen=True)
class Message:
    """A raft protocol message (reference: raftpb.Message [U]).

    ``log_term``/``log_index`` carry prevLogTerm/prevLogIndex for REPLICATE
    and the candidate's last log position for votes. ``hint``/``hint_high``
    carry the ReadIndex SystemCtx and the log-matching reject hint.

    ``trace_id``/``span_id`` are OBSERVABILITY context, not protocol
    state: a leader replicating a traced proposal stamps the proposal
    span's context onto the REPLICATE so the follower's append span
    stitches into the same cross-host trace (dragonboat_tpu.obs).  0
    means untraced; the raft core ignores both fields.
    """

    type: MessageType = MessageType.NO_OP
    to: int = 0
    from_: int = 0
    shard_id: int = 0
    term: int = 0
    log_term: int = 0
    log_index: int = 0
    commit: int = 0
    reject: bool = False
    hint: int = 0
    hint_high: int = 0
    entries: Tuple[Entry, ...] = ()
    snapshot: Snapshot = EMPTY_SNAPSHOT
    trace_id: int = 0
    span_id: int = 0

    def is_local(self) -> bool:
        return self.type in _LOCAL_TYPES

    def is_leader_message(self) -> bool:
        return self.type in (
            MessageType.REPLICATE,
            MessageType.INSTALL_SNAPSHOT,
            MessageType.HEARTBEAT,
            MessageType.TIMEOUT_NOW,
            MessageType.READ_INDEX_RESP,
        )


# Note: PROPOSE, READ_INDEX and LEADER_TRANSFER are NOT local — followers
# forward them to the leader over the wire (reference: isLocalMessageType [U]
# excludes forwardable types for the same reason).
_LOCAL_TYPES = frozenset(
    {
        MessageType.LOCAL_TICK,
        MessageType.ELECTION,
        MessageType.UNREACHABLE,
        MessageType.SNAPSHOT_STATUS,
        MessageType.SNAPSHOT_RECEIVED,
        MessageType.CHECK_QUORUM,
        MessageType.CONFIG_CHANGE_EVENT,
        MessageType.RATE_LIMIT,
        MessageType.QUIESCE,
        MessageType.BATCHED_READ_INDEX,
    }
)


@dataclass(frozen=True)
class SystemCtx:
    """ReadIndex correlation hint (reference: raftpb.SystemCtx [U])."""

    low: int = 0
    high: int = 0


@dataclass(frozen=True)
class ReadyToRead:
    """ReadIndex confirmation (reference: raftpb.ReadyToRead [U])."""

    index: int = 0
    system_ctx: SystemCtx = field(default_factory=SystemCtx)


@dataclass(frozen=True)
class UpdateCommit:
    """Cursor advances applied by ``peer.commit`` after the host has
    consumed an Update (reference: raftpb.UpdateCommit [U])."""

    processed: int = 0           # committed entries handed to apply
    last_applied: int = 0
    stable_log_index: int = 0    # in-memory log persisted up to here
    stable_log_term: int = 0
    stable_snapshot_index: int = 0
    ready_to_read: int = 0


@dataclass
class Update:
    """The entire I/O contract between the pure raft core and the host
    runtime (reference: raftpb.Update [U]; peer.GetUpdate).

    Host obligations, in order (matches the reference engine):
      1. persist ``state`` + ``entries_to_save`` + ``snapshot`` (fsync)
      2. send ``messages``
      3. hand ``committed_entries`` to the apply loop
      4. surface ``ready_to_reads``
      5. call ``peer.commit(update)`` to advance cursors
    """

    shard_id: int = 0
    replica_id: int = 0
    state: State = EMPTY_STATE
    entries_to_save: List[Entry] = field(default_factory=list)
    committed_entries: List[Entry] = field(default_factory=list)
    messages: List[Message] = field(default_factory=list)
    last_applied: int = 0
    snapshot: Snapshot = EMPTY_SNAPSHOT
    ready_to_reads: List[ReadyToRead] = field(default_factory=list)
    dropped_entries: List[Entry] = field(default_factory=list)
    dropped_read_indexes: List[SystemCtx] = field(default_factory=list)
    update_commit: UpdateCommit = field(default_factory=UpdateCommit)
    fast_apply: bool = False
    has_update: bool = False

    def has_work(self) -> bool:
        return (
            self.has_update
            or bool(self.entries_to_save)
            or bool(self.committed_entries)
            or bool(self.messages)
            or bool(self.ready_to_reads)
            or not self.snapshot.is_empty()
        )


# message-batch wire format version (reference: raftio TransportBinVersion
# [U]).  v1: every Message carries a trace-context flag byte (+ ids when
# traced) after the snapshot field.  decode_batch still reads v0 (no
# flag byte — rolling upgrades keep talking) and rejects unknown FUTURE
# versions loudly instead of shifting every subsequent field into
# garbage; the encoder always emits the current version.
MESSAGE_BATCH_BIN_VER = 1


@dataclass(frozen=True)
class MessageBatch:
    """Coalesced wire unit between hosts (reference: raftpb.MessageBatch [U])."""

    messages: Tuple[Message, ...] = ()
    source_address: str = ""
    deployment_id: int = 0
    bin_ver: int = MESSAGE_BATCH_BIN_VER


@dataclass(frozen=True)
class Chunk:
    """One snapshot chunk on the wire (reference: raftpb.Chunk [U])."""

    shard_id: int = 0
    replica_id: int = 0
    from_: int = 0
    chunk_id: int = 0
    chunk_size: int = 0
    chunk_count: int = 0
    index: int = 0
    term: int = 0
    # the carrying InstallSnapshot message's term (the raft term gate on the
    # receiver needs it; chunk.term above is the snapshot's log term)
    message_term: int = 0
    data: bytes = b""
    membership: Membership = field(default_factory=Membership)
    filepath: str = ""
    file_size: int = 0
    file_chunk_id: int = 0
    file_chunk_count: int = 0
    has_file_info: bool = False
    file_info: SnapshotFile = field(default_factory=SnapshotFile)
    bin_ver: int = 0
    deployment_id: int = 0
    witness: bool = False
    dummy: bool = False
    on_disk_index: int = 0


@dataclass(frozen=True)
class Bootstrap:
    """First-boot record (reference: raftpb.Bootstrap [U])."""

    addresses: dict = field(default_factory=dict)
    join: bool = False
    smtype: int = 0


@dataclass(frozen=True)
class RaftDataStatus:
    """LogDB format self-description (reference: raftio BinaryFormat [U])."""

    address: str = ""
    bin_ver: int = 0
    hard_hash: int = 0
    logdb_type: str = ""
    hostname: str = ""
    deployment_id: int = 0
