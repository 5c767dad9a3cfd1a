"""The ordered apply loop: rsm.StateMachine + TaskQueue.

reference: internal/rsm/statemachine.go [U].  Apply workers drain a
``TaskQueue`` of committed-entry batches (plus snapshot save/recover
tasks), route each entry by kind (application / config-change / session
ops / noop), dedupe through client sessions, and surface
``ApplyResult``s so the node can complete pending futures.
"""
from __future__ import annotations

import enum
import io
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..client import (
    NOOP_SERIES_ID,
    SERIES_ID_REGISTER,
    SERIES_ID_UNREGISTER,
)
from ..logger import get_logger
from ..pb import ConfigChange, Entry, EntryType, Membership, Snapshot
from ..statemachine import Result, SMEntry
from ..transport.wire import WireError, decode_config_change
from .managed import ManagedStateMachine
from .membership import MembershipManager
from .session import SessionManager

_log = get_logger("rsm")


class SnapshotFileCollection:
    """Concrete ISnapshotFileCollection: stages each added file via the
    storage-provided ``copy_fn`` (into the snapshot dir) at add time —
    the user contract is that the file exists until save returns
    (reference: statemachine.ISnapshotFileCollection [U])."""

    def __init__(self, copy_fn=None):
        self._copy = copy_fn
        self.files = []  # List[SnapshotFile]

    def add_file(self, file_id: int, path: str, metadata: bytes = b"") -> None:
        import os

        from ..pb import SnapshotFile

        if self._copy is not None:
            self.files.append(self._copy(file_id, path, metadata))
        else:
            self.files.append(
                SnapshotFile(
                    file_id=file_id,
                    filepath=path,
                    file_size=os.path.getsize(path),
                    metadata=metadata,
                )
            )


class TaskType(enum.IntEnum):
    ENTRIES = 0
    SNAPSHOT_SAVE = 1
    SNAPSHOT_RECOVER = 2
    SNAPSHOT_STREAM = 3
    SYNC = 4
    STOP = 5


@dataclass
class Task:
    type: TaskType = TaskType.ENTRIES
    entries: List[Entry] = field(default_factory=list)
    snapshot: Snapshot = None  # type: ignore[assignment]
    ctx: object = None  # snapshot request context (export path, sink, ...)


class TaskQueue:
    """MPSC committed-task queue (reference: rsm.TaskQueue [U]).

    A plain list with swap-drain: producers only append, the single
    consumer takes the whole list (an idle queue is one empty list, not
    a ~750 B deque — this object exists once per replica row)."""

    __slots__ = ("_q", "_lock")

    def __init__(self):
        self._q: List[Task] = []
        self._lock = threading.Lock()

    def add(self, t: Task) -> None:
        with self._lock:
            self._q.append(t)

    def get_all(self) -> List[Task]:
        if not self._q:
            return []
        with self._lock:
            out = self._q
            self._q = []
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


@dataclass
class ApplyResult:
    entry: Entry
    result: Result
    rejected: bool = False  # config change rejected / session op failed
    config_change: Optional[ConfigChange] = None


class StateMachine:
    """Per-replica managed SM + sessions + membership (reference:
    rsm.StateMachine [U])."""

    __slots__ = (
        "shard_id", "replica_id", "managed", "sessions", "members",
        "task_queue", "last_applied", "applied_term",
        "on_disk_init_index", "is_witness", "_mu",
    )

    def __init__(
        self,
        shard_id: int,
        replica_id: int,
        managed: ManagedStateMachine,
        ordered_config_change: bool = False,
        is_witness: bool = False,
    ):
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.managed = managed
        self.sessions = SessionManager()
        self.members = MembershipManager(shard_id, ordered_config_change)
        self.task_queue = TaskQueue()
        self.last_applied = 0
        self.applied_term = 0
        self.on_disk_init_index = 0
        self.is_witness = is_witness
        self._mu = threading.RLock()

    # -- lifecycle --------------------------------------------------------
    def open(self, stopc) -> int:
        """On-disk SMs recover themselves and report their applied index."""
        idx = self.managed.open(stopc)
        self.on_disk_init_index = idx
        if idx > self.last_applied:
            self.last_applied = idx
        return idx

    def set_initial_membership(self, addresses, non_votings=None, witnesses=None):
        self.members.set_initial(addresses, non_votings, witnesses)

    def get_membership(self) -> Membership:
        with self._mu:
            return self.members.membership.copy()

    # -- apply ------------------------------------------------------------
    def handle(self, task: Task) -> List[ApplyResult]:
        """Apply one committed batch in order (reference: rsm.Handle [U])."""
        if task.type != TaskType.ENTRIES:
            raise ValueError("handle() only processes entry tasks")
        results: List[ApplyResult] = []
        batch: List[Tuple[Entry, SMEntry]] = []
        # session keys already queued in `batch` but not yet recorded in the
        # session store: a retried proposal can commit twice in one batch,
        # and dedupe must catch the second copy even before flush()
        batch_keys: set = set()

        def flush():
            if not batch:
                return
            sm_entries = [se for _, se in batch]
            self.managed.batched_update(sm_entries)
            for (entry, se) in batch:
                self._record_session_result(entry, se.result)
                results.append(ApplyResult(entry=entry, result=se.result))
            batch.clear()
            batch_keys.clear()

        with self._mu:
            for e in task.entries:
                # ONE dispatch ladder for live apply AND the on-disk
                # replay window (entries at or below the index an
                # IOnDiskStateMachine reported durably applied —
                # reference: statemachine.go's onDiskInitIndex
                # discipline [U]).  Membership and session state live
                # in rsm MEMORY, so config-change / register /
                # unregister entries run UNCONDITIONALLY and rebuild it
                # during replay (their `_advance` is a no-op below the
                # window); skipping them wholesale lost every
                # witness/non-voting added below the on-disk index on
                # the next restart without a snapshot — the restarted
                # replica, and any leader it became, forgot those
                # members existed and never replicated to them again
                # (found by the production-day soak's rolling-restart
                # phase, docs/SCENARIO.md).  Only USER code is gated on
                # the window, in the application branch below.
                if e.type == EntryType.CONFIG_CHANGE:
                    flush()
                    results.append(self._handle_config_change(e))
                elif e.type == EntryType.METADATA or e.is_noop():
                    flush()
                    self._advance(e)
                elif e.is_new_session_request():
                    flush()
                    results.append(self._handle_register(e))
                elif e.is_end_session_request():
                    flush()
                    results.append(self._handle_unregister(e))
                elif e.index <= self.last_applied:
                    # replay window, application entry: the effect is
                    # already inside the on-disk state — never re-run
                    # user code, but mark a session-managed series
                    # responded so a cross-restart retry dedupes
                    # instead of being rejected as an expired session.
                    # A series can appear TWICE below the window (a
                    # retry that committed both copies — the case
                    # _check_duplicate dedupes on the live path), so
                    # only the first replayed copy records; a second
                    # add_response would raise and wedge replay in a
                    # deterministic restart crash loop (review finding)
                    if e.is_session_managed():
                        s = self.sessions.get(e.client_id)
                        if s is not None:
                            s.clear_to(e.responded_to)
                            _, hit = s.get_response(e.series_id)
                            if not s.has_responded(e.series_id) and not hit:
                                s.add_response(e.series_id, Result())
                else:
                    if (
                        e.is_session_managed()
                        and (e.client_id, e.series_id) in batch_keys
                    ):
                        # duplicate of an entry queued in this same batch:
                        # apply the queued copy first so the session store
                        # has its result, then dedupe normally
                        flush()
                    dup = self._check_duplicate(e)
                    if dup is not None:
                        results.append(dup)
                    elif self.is_witness:
                        self._advance(e)  # witnesses never run user code
                    else:
                        batch.append((e, SMEntry(index=e.index, cmd=e.cmd)))
                        if e.is_session_managed():
                            batch_keys.add((e.client_id, e.series_id))
                        self._advance(e)
            flush()
        return results

    def _advance(self, e: Entry) -> None:
        from ..invariants import check

        check(
            e.index <= self.last_applied + 1,
            "apply gap: entry %d after applied %d",
            e.index,
            self.last_applied,
        )
        if e.index > self.last_applied:
            self.last_applied = e.index
            self.applied_term = e.term

    def _check_duplicate(self, e: Entry) -> Optional[ApplyResult]:
        if not e.is_session_managed():
            return None
        s = self.sessions.get(e.client_id)
        if s is None:
            # session expired from LRU (or never registered)
            self._advance(e)
            return ApplyResult(entry=e, result=Result(), rejected=True)
        s.clear_to(e.responded_to)
        if s.has_responded(e.series_id):
            self.sessions.responded_rejects += 1
            self._advance(e)
            return ApplyResult(entry=e, result=Result(), rejected=True)
        cached, hit = s.get_response(e.series_id)
        if hit:
            self.sessions.dedupe_hits += 1
            self._advance(e)
            return ApplyResult(entry=e, result=cached)
        return None

    def _record_session_result(self, e: Entry, result: Result) -> None:
        if not e.is_session_managed():
            return
        s = self.sessions.get(e.client_id)
        if s is not None:
            s.add_response(e.series_id, result)

    def _handle_config_change(self, e: Entry) -> ApplyResult:
        try:
            cc: ConfigChange = decode_config_change(e.cmd)
        except (WireError, ValueError):
            self._advance(e)
            return ApplyResult(entry=e, result=Result(), rejected=True)
        accepted = self.members.handle(cc, e.index)
        self._advance(e)
        return ApplyResult(
            entry=e,
            result=Result(value=1 if accepted else 0),
            rejected=not accepted,
            config_change=cc if accepted else None,
        )

    def _handle_register(self, e: Entry) -> ApplyResult:
        r = self.sessions.register(e.client_id)
        self._advance(e)
        return ApplyResult(entry=e, result=r, rejected=r.value == 0)

    def _handle_unregister(self, e: Entry) -> ApplyResult:
        r = self.sessions.unregister(e.client_id)
        self._advance(e)
        return ApplyResult(entry=e, result=r, rejected=r.value == 0)

    # -- reads ------------------------------------------------------------
    def lookup(self, query):
        return self.managed.lookup(query)

    def sync(self) -> None:
        self.managed.sync()

    # -- snapshot ---------------------------------------------------------
    def save_snapshot_stream(
        self,
        fileobj,
        collection=None,
        done=None,
        *,
        compression: int = 0,
        block_size: Optional[int] = None,
    ) -> Tuple[int, int, list]:
        """Stream a v2 container (storage/snapshotio.py) into ``fileobj``.

        The SM's data flows through the block writer with bounded
        memory — a 10GB on-disk SM never materializes its payload
        (reference: rsm streamed save for IOnDiskStateMachine [U]).
        Returns (index, term, external_files).
        """
        from ..storage.snapshotio import DEFAULT_BLOCK_SIZE, SnapshotWriter

        done = done or threading.Event()
        with self._mu:
            index, term = self.last_applied, self.applied_term
            membership = self.members.membership.copy()
            sessions_blob = self.sessions.serialize()
            # on-disk SMs: make everything applied so far durable in the
            # SM's OWN storage before the snapshot point is fixed
            # (reference: IOnDiskStateMachine.Sync before snapshotting
            # [U]) — the log may be compacted past `index` right after,
            # and the SM must never depend on replaying below it
            self.managed.sync()
            ctx = self.managed.prepare_snapshot()
            w = SnapshotWriter(
                fileobj,
                index=index,
                term=term,
                membership=membership,
                sessions=sessions_blob,
                on_disk=self.managed.on_disk,
                compression=compression,
                block_size=block_size or DEFAULT_BLOCK_SIZE,
            )
            if not self.managed.concurrent_snapshot:
                # regular SM: serialize inside the apply-exclusive section so
                # the payload cannot contain entries newer than `index`
                self.managed.save_snapshot(ctx, w, collection, done)
        if self.managed.concurrent_snapshot:
            # concurrent/on-disk SMs captured a consistent view in
            # prepare_snapshot; the slow serialization runs outside the lock
            self.managed.save_snapshot(ctx, w, collection, done)
        if collection is not None:
            for sf in collection.files:
                w.add_external_file(sf)
        w.close()
        return index, term, (collection.files if collection else [])

    def recover_from_snapshot_stream(self, reader, files, done=None) -> int:
        """Restore from a SnapshotReader; ``files`` are the resolved
        external SnapshotFile records (absolute paths)."""
        with self._mu:
            self.managed.recover_from_snapshot(
                reader.sm_stream(), files, done or threading.Event()
            )
            self.sessions = SessionManager.deserialize(reader.sessions)
            self.members.restore(reader.membership)
            self.last_applied = reader.index
            self.applied_term = reader.term
        return reader.index

    # bytes-level convenience (tests, in-mem flows) over the same container
    def save_snapshot_data(self, files=None, done=None) -> Tuple[bytes, int, int]:
        buf = io.BytesIO()
        index, term, _ = self.save_snapshot_stream(buf, files, done)
        return buf.getvalue(), index, term

    def recover_from_snapshot_data(self, payload: bytes, done=None) -> int:
        from ..storage.snapshotio import SnapshotReader

        return self.recover_from_snapshot_stream(
            SnapshotReader(io.BytesIO(payload)), [], done
        )
