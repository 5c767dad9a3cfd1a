"""tan: the durable segmented append-only LogDB.

reference: internal/tan/ — a log-structured LogDB (segmented append-only
log files + an in-memory index of live records), the v4 default,
designed to avoid general-KV write-amp for raft-log workloads [U].

Shape here: every ``save_raft_state`` batch appends crc-framed records
to the active segment and issues ONE fsync (the reference's
single-fsync-per-iteration contract); an ``InMemLogDB`` mirror holds
the live view for all reads.  At open, segments replay in order into
the mirror; a torn record at the tail of the LAST segment is the
crash point and replay stops there cleanly (any other corruption is an
error).  When enough closed segments accumulate, a checkpoint segment
is written that re-serializes only the live mirror state, and older
segments are deleted — crash-safe because replaying old segments then
the checkpoint converges to the same state as the checkpoint alone.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from io import BytesIO
from typing import List, Optional

from ..logger import get_logger
from ..pb import MASK64, Bootstrap, Entry, Snapshot, State, Update
from ..raftio import ILogDB, NodeInfo
from ..transport.wire import (
    MAX_PAYLOAD,
    WireError,
    _R,
    _r_entry,
    _r_snapshot,
    _w_entry,
    _w_snapshot,
    bounded_decompress,
    maybe_compress,
)
from .journal import CorruptJournalError, scan_segment
from .logdb import InMemLogDB
from .vfs import DEFAULT as OS_VFS, IVFS, OSVFS

_log = get_logger("logdb")

_REC_HEADER = struct.Struct("<BII")  # kind, length, crc

K_STATE_ENTRIES = 1
K_SNAPSHOT = 2
K_BOOTSTRAP = 3
K_REMOVE_TO = 4
K_REMOVE_NODE = 5

# kind-byte flag: the record body is zlib-compressed (entry compression
# at the WAL level — reference: EntryCompression [U]; ours is adaptive:
# bodies over a threshold that actually shrink get the flag)
K_COMPRESSED = 0x80
COMPRESS_THRESHOLD = 512

_u64 = struct.Struct("<Q")

SEGMENT_PREFIX = "SEGMENT-"
DEFAULT_MAX_SEGMENT_BYTES = 64 * 1024 * 1024
DEFAULT_GC_SEGMENTS = 4


class CorruptLogError(CorruptJournalError):
    """Mid-log corruption (not a clean torn tail)."""


def _wu64(b: BytesIO, v: int) -> None:
    # mask, don't raise: uint64 wraparound parity (pb.MASK64 policy)
    b.write(_u64.pack(v & MASK64))


def _wb(b: BytesIO, v: bytes) -> None:
    b.write(struct.pack("<I", len(v)))
    b.write(v)


def _ws(b: BytesIO, v: str) -> None:
    _wb(b, v.encode("utf-8"))


def _encode_state_entries(u: Update) -> bytes:
    b = BytesIO()
    _wu64(b, u.shard_id)
    _wu64(b, u.replica_id)
    _wu64(b, u.state.term)
    _wu64(b, u.state.vote)
    _wu64(b, u.state.commit)
    b.write(struct.pack("<I", len(u.entries_to_save)))
    for e in u.entries_to_save:
        _w_entry(b, e)
    has_ss = not u.snapshot.is_empty()
    b.write(struct.pack("<B", int(has_ss)))
    if has_ss:
        _w_snapshot(b, u.snapshot)
    return b.getvalue()


def _encode_snapshot(shard_id: int, replica_id: int, ss: Snapshot) -> bytes:
    b = BytesIO()
    _wu64(b, shard_id)
    _wu64(b, replica_id)
    _w_snapshot(b, ss)
    return b.getvalue()


def _encode_bootstrap(shard_id: int, replica_id: int, bs: Bootstrap) -> bytes:
    b = BytesIO()
    _wu64(b, shard_id)
    _wu64(b, replica_id)
    b.write(struct.pack("<I", len(bs.addresses)))
    for rid in sorted(bs.addresses):
        _wu64(b, rid)
        _ws(b, bs.addresses[rid])
    b.write(struct.pack("<B", int(bs.join)))
    return b.getvalue()


def _encode_pair_index(shard_id: int, replica_id: int, index: int) -> bytes:
    b = BytesIO()
    _wu64(b, shard_id)
    _wu64(b, replica_id)
    _wu64(b, index)
    return b.getvalue()


def _encode_pair(shard_id: int, replica_id: int) -> bytes:
    b = BytesIO()
    _wu64(b, shard_id)
    _wu64(b, replica_id)
    return b.getvalue()


class TanLogDB(ILogDB):
    """Durable ILogDB: WAL segments + in-memory mirror."""

    def __init__(
        self,
        directory: str,
        *,
        max_segment_bytes: int = DEFAULT_MAX_SEGMENT_BYTES,
        gc_segments: int = DEFAULT_GC_SEGMENTS,
        use_native: Optional[bool] = None,
        compression: bool = True,
        fs: Optional[IVFS] = None,
    ):
        self.dir = directory
        self.max_segment_bytes = max_segment_bytes
        self.gc_segments = gc_segments
        self.compression = compression
        self.fs = fs if fs is not None else OS_VFS
        self._mirror = InMemLogDB()
        self._lock = threading.Lock()
        self._fh = None
        self._writer = None  # native group-commit writer (when available)
        if not isinstance(self.fs, OSVFS):
            # the native group-commit writer writes real files; a virtual
            # fs (crash simulation) must stay on the python writer
            if use_native:
                raise OSError("native walwriter needs the OS filesystem")
            use_native = False
        if use_native is None or use_native:
            from ..native import load_walwriter

            native_ok = load_walwriter() is not None
            if use_native and not native_ok:
                raise OSError("native walwriter requested but unavailable")
            self._use_native = native_ok
        else:
            self._use_native = False
        self._active_seq = 0
        self._active_bytes = 0
        self._inflight = 0  # native appends running outside the lock
        self._idle = threading.Condition(self._lock)  # inflight == 0
        self._rotate_pending = False  # gate: new appends wait, inflight drains
        # test-only fault injection (reference: vfs error-injection hooks
        # [U]): called with the framed bytes before every write+fsync on
        # BOTH writer paths (python and native group-commit); raising
        # simulates an I/O failure at that point
        self.fault_hook = None
        # the unified fault plane (faults.FaultController via a bound
        # adapter); consulted at the same write+fsync boundary
        self.fault_injector = None
        self.fs.makedirs(directory)
        self._replay()
        self._open_active()

    # -- segment plumbing -------------------------------------------------
    def _segments(self) -> List[int]:
        out = []
        for name in self.fs.listdir(self.dir):
            if name.startswith(SEGMENT_PREFIX) and name.endswith(".log"):
                try:
                    out.append(int(name[len(SEGMENT_PREFIX) : -4]))
                except ValueError:
                    pass
        return sorted(out)

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{SEGMENT_PREFIX}{seq:08d}.log")

    def _open_active(self) -> None:
        segs = self._segments()
        self._active_seq = (segs[-1] + 1) if segs else 1
        path = self._segment_path(self._active_seq)
        if self._use_native:
            from ..native import NativeWalWriter

            self._writer = NativeWalWriter(path)
            self._active_bytes = self._writer.size()
        else:
            self._fh = self.fs.open_append(path)
            self._active_bytes = self._fh.tell()
        self._sync_dir()

    def _close_active(self) -> None:
        if self._writer is not None:
            # clear the reference FIRST: if close() raises (I/O error),
            # a later append must see "no writer", not a dead handle
            w, self._writer = self._writer, None
            w.close()
        if self._fh is not None:
            fh, self._fh = self._fh, None
            fh.close()

    def _sync_dir(self) -> None:
        self.fs.sync_dir(self.dir)

    # -- replay -----------------------------------------------------------
    def _replay(self) -> None:
        segs = self._segments()
        for i, seq in enumerate(segs):
            last = i == len(segs) - 1
            self._replay_segment(self._segment_path(seq), torn_ok=last)

    def _replay_segment(self, path: str, torn_ok: bool) -> None:
        def apply(kind: int, body: bytes) -> None:
            if kind & K_COMPRESSED:
                kind &= ~K_COMPRESSED
                body = bounded_decompress(body, MAX_PAYLOAD)
            self._apply_record(kind, body)

        # shared scanner (storage/journal.py): torn-tail truncation +
        # crc/structure rules identical across the durable backends
        scan_segment(self.fs, path, self.dir, torn_ok, apply, CorruptLogError)

    def _apply_record(self, kind: int, body: bytes) -> None:
        r = _R(body)
        if kind == K_STATE_ENTRIES:
            shard_id, replica_id = r.u64(), r.u64()
            state = State(term=r.u64(), vote=r.u64(), commit=r.u64())
            entries = tuple(_r_entry(r) for _ in range(r.count()))
            ss = _r_snapshot(r) if r.u8() else Snapshot()
            u = Update(shard_id=shard_id, replica_id=replica_id)
            u.state = state
            u.entries_to_save = list(entries)
            u.snapshot = ss
            self._mirror.save_raft_state([u], 0)
        elif kind == K_SNAPSHOT:
            shard_id, replica_id = r.u64(), r.u64()
            ss = _r_snapshot(r)
            u = Update(shard_id=shard_id, replica_id=replica_id)
            u.snapshot = ss
            self._mirror.save_snapshots([u])
        elif kind == K_BOOTSTRAP:
            shard_id, replica_id = r.u64(), r.u64()
            addresses = {}
            for _ in range(r.count()):
                rid = r.u64()
                addresses[rid] = r.s()
            join = bool(r.u8())
            self._mirror.save_bootstrap_info(
                shard_id, replica_id, Bootstrap(addresses=addresses, join=join)
            )
        elif kind == K_REMOVE_TO:
            shard_id, replica_id, index = r.u64(), r.u64(), r.u64()
            self._mirror.remove_entries_to(shard_id, replica_id, index)
        elif kind == K_REMOVE_NODE:
            shard_id, replica_id = r.u64(), r.u64()
            self._mirror.remove_node_data(shard_id, replica_id)
        else:
            raise WireError(f"unknown record kind {kind}")

    # -- writes -----------------------------------------------------------
    def _frame(self, recs: List[tuple]) -> bytes:
        buf = BytesIO()
        for kind, body in recs:
            if self.compression:
                # max_out = the replay-side decompress bound: a compressed
                # oversize record would write fine and then make the WAL
                # permanently unopenable; stored raw it replays fine
                kind, body = maybe_compress(
                    kind, body, K_COMPRESSED, COMPRESS_THRESHOLD,
                    max_out=MAX_PAYLOAD,
                )
            buf.write(_REC_HEADER.pack(kind, len(body), zlib.crc32(body)))
            buf.write(body)
        return buf.getvalue()

    def _quiesce_appends_locked(self) -> None:
        """Wait (holding the lock) until no native append runs outside it.

        Every locked mutator that appends records must call this first:
        it restores the file-order == mirror-order invariant against the
        unlocked native save path, and makes writer swaps (rotate/close)
        safe."""
        while self._inflight:
            self._idle.wait()

    def _append_records(self, recs: List[tuple], sync: bool = True) -> None:
        """recs = [(kind, body)]; one write + one fsync for the batch.

        NEVER rotates: rotation may checkpoint-GC, which re-serializes
        the MIRROR — callers must publish the batch to the mirror first
        and then call ``_maybe_rotate``.  (Rotating in here once lost an
        acked batch: the checkpoint lacked it and GC deleted the segment
        holding its only durable copy — caught by the power-loss fuzz.)
        """
        raw = self._frame(recs)
        if self.fault_hook is not None:
            self.fault_hook(raw)
        if self.fault_injector is not None:
            self.fault_injector.on_fs_op("wal_append", self.dir)
        if self._writer is not None:
            # native path: write+fsync on the group-commit thread, GIL
            # released; concurrent workers' batches share one fsync
            self._writer.append(raw, sync=sync)
        else:
            self._fh.write(raw)
            if sync:
                self._fh.sync()
        self._active_bytes += len(raw)

    def _maybe_rotate(self) -> None:
        """Rotate once the active segment is full.  Only call with the
        mirror already reflecting every appended record (checkpoint GC
        serializes the mirror), and never under an in-flight append."""
        if (
            self._inflight == 0  # never swap the writer under an append
            and self._active_bytes >= self.max_segment_bytes
        ):
            self._rotate()

    def _rotate(self) -> None:
        self._close_active()
        self._open_active()
        closed = len(self._segments()) - 1
        if closed > self.gc_segments:
            self._checkpoint_gc()

    def _checkpoint_gc(self) -> None:
        """Re-serialize the live mirror into the new active segment and
        delete every older segment."""
        old = [s for s in self._segments() if s != self._active_seq]
        recs: List[tuple] = []
        with self._mirror._lock:
            for (shard_id, replica_id), ns in self._mirror._nodes.items():
                if ns.bootstrap is not None:
                    recs.append(
                        (
                            K_BOOTSTRAP,
                            _encode_bootstrap(shard_id, replica_id, ns.bootstrap),
                        )
                    )
                u = Update(shard_id=shard_id, replica_id=replica_id)
                u.state = ns.state
                u.entries_to_save = [
                    ns.entries[i] for i in sorted(ns.entries)
                ]
                u.snapshot = ns.snapshot
                recs.append((K_STATE_ENTRIES, _encode_state_entries(u)))
                if ns.min_index > 1:
                    recs.append(
                        (
                            K_REMOVE_TO,
                            _encode_pair_index(
                                shard_id, replica_id, ns.min_index - 1
                            ),
                        )
                    )
        # a checkpoint may itself exceed the segment cap; _append_records
        # never rotates, so it cannot recurse into another checkpoint
        self._append_records(recs, sync=True)
        self._sync_dir()
        for seq in old:
            try:
                self.fs.unlink(self._segment_path(seq))
            except OSError:
                pass
        self._sync_dir()

    # -- ILogDB -----------------------------------------------------------
    def name(self) -> str:
        return "tan"

    def close(self) -> None:
        with self._lock:
            self._quiesce_appends_locked()
            self._close_active()

    def list_node_info(self) -> List[NodeInfo]:
        return self._mirror.list_node_info()

    def save_bootstrap_info(self, shard_id, replica_id, bootstrap) -> None:
        with self._lock:
            self._quiesce_appends_locked()
            self._append_records(
                [(K_BOOTSTRAP, _encode_bootstrap(shard_id, replica_id, bootstrap))]
            )
            self._mirror.save_bootstrap_info(shard_id, replica_id, bootstrap)
            self._maybe_rotate()

    def get_bootstrap_info(self, shard_id, replica_id):
        return self._mirror.get_bootstrap_info(shard_id, replica_id)

    def save_raft_state(self, updates: List[Update], worker_id: int) -> None:
        recs = [
            (K_STATE_ENTRIES, _encode_state_entries(u)) for u in updates
        ]
        if self._writer is None:
            with self._lock:
                self._append_records(recs)  # ONE fsync for the whole batch
                self._mirror.save_raft_state(updates, worker_id)
                self._maybe_rotate()  # AFTER the mirror has the batch
            return
        # native path: the blocking (durable) append runs OUTSIDE the
        # lock so concurrent workers' batches group-commit into shared
        # fsyncs.  Per-shard record order is preserved (each shard is
        # stepped by exactly one worker); locked mutators for the same
        # shard quiesce in-flight appends first.
        raw = self._frame(recs)
        if self.fault_hook is not None:
            self.fault_hook(raw)
        if self.fault_injector is not None:
            self.fault_injector.on_fs_op("wal_append", self.dir)
        with self._lock:
            # a pending rotation blocks NEW appends so inflight can drain
            # — otherwise sustained load starves rotation (and GC) forever
            while self._rotate_pending:
                self._idle.wait()
            w = self._writer
            if w is None:
                raise OSError("logdb is closed")
            self._inflight += 1
        ok = False
        try:
            w.append(raw, sync=True)
            ok = True
        finally:
            with self._lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.notify_all()
                if ok:
                    # publish to readers only AFTER the bytes are durable
                    self._active_bytes += len(raw)
                    self._mirror.save_raft_state(updates, worker_id)
                    if (
                        self._active_bytes >= self.max_segment_bytes
                        and not self._rotate_pending
                    ):
                        self._rotate_pending = True
                        try:
                            self._quiesce_appends_locked()
                            self._rotate()
                        finally:
                            self._rotate_pending = False
                            self._idle.notify_all()

    def read_raft_state(self, shard_id, replica_id, last_index):
        return self._mirror.read_raft_state(shard_id, replica_id, last_index)

    def iterate_entries(self, shard_id, replica_id, low, high, max_size):
        return self._mirror.iterate_entries(
            shard_id, replica_id, low, high, max_size
        )

    def term(self, shard_id, replica_id, index):
        return self._mirror.term(shard_id, replica_id, index)

    def remove_entries_to(self, shard_id, replica_id, index) -> None:
        with self._lock:
            self._quiesce_appends_locked()
            self._append_records(
                [(K_REMOVE_TO, _encode_pair_index(shard_id, replica_id, index))],
                sync=False,  # compaction is advisory; replay just keeps more
            )
            self._mirror.remove_entries_to(shard_id, replica_id, index)
            self._maybe_rotate()

    def compact_entries_to(self, shard_id, replica_id, index) -> None:
        self.remove_entries_to(shard_id, replica_id, index)

    def save_snapshots(self, updates: List[Update]) -> None:
        recs = [
            (K_SNAPSHOT, _encode_snapshot(u.shard_id, u.replica_id, u.snapshot))
            for u in updates
            if not u.snapshot.is_empty()
        ]
        if not recs:
            return
        with self._lock:
            self._quiesce_appends_locked()
            self._append_records(recs)
            self._mirror.save_snapshots(updates)
            self._maybe_rotate()

    def get_snapshot(self, shard_id, replica_id) -> Snapshot:
        return self._mirror.get_snapshot(shard_id, replica_id)

    def remove_node_data(self, shard_id, replica_id) -> None:
        with self._lock:
            self._quiesce_appends_locked()
            self._append_records(
                [(K_REMOVE_NODE, _encode_pair(shard_id, replica_id))]
            )
            self._mirror.remove_node_data(shard_id, replica_id)
            self._maybe_rotate()

    def import_snapshot(self, snapshot: Snapshot, replica_id: int) -> None:
        with self._lock:
            self._quiesce_appends_locked()
            self._mirror.import_snapshot(snapshot, replica_id)
            ns = self._mirror._get(snapshot.shard_id, replica_id)
            u = Update(shard_id=snapshot.shard_id, replica_id=replica_id)
            u.state = ns.state
            u.snapshot = snapshot
            self._append_records(
                [
                    (K_STATE_ENTRIES, _encode_state_entries(u)),
                    (
                        K_REMOVE_TO,
                        _encode_pair_index(
                            snapshot.shard_id, replica_id, snapshot.index
                        ),
                    ),
                ]
            )
            self._maybe_rotate()


def tan_logdb_factory(config) -> TanLogDB:
    """NodeHostConfig.expert.logdb_factory hook."""
    base = config.wal_dir or config.nodehost_dir
    return TanLogDB(os.path.join(base, "tan"))
