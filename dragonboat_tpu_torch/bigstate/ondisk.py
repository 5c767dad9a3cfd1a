"""OnDiskKV — the reference ``IOnDiskStateMachine`` over ``storage/vfs``.

reference: statemachine/ondisk.go contract + the ondisk example's
pebble-backed KV [U].  The contract this implementation demonstrates
end to end (docs/BIGSTATE.md "On-disk state machines"):

* the SM owns its own durable storage (a checkpoint + WAL pair under
  one directory, written through ``storage/vfs`` so the strict-crash
  MemFS tests apply);
* ``open()`` recovers local state and reports the APPLIED INDEX it
  recovered to — raft then replays only the log suffix past it (the
  ``e.index <= last_applied`` skip in rsm/statemachine.py);
* ``update()`` appends to the WAL as it applies (in-core dict is the
  working set; the WAL tail is pending until ``sync``), and folds the
  WAL into a fresh checkpoint once it outgrows ``compact_wal_bytes`` —
  amortized on the apply path, LSM-style;
* ``sync()`` makes everything applied so far durable (one fsync,
  deliberately O(1): the rsm calls it in its apply-exclusive section
  before every snapshot point);
* ``save_snapshot``/``recover_from_snapshot`` stream record-by-record
  with bounded memory — a GB-scale state never materializes beyond the
  working set, and recovery leaves DURABLE state (fresh checkpoint,
  empty WAL) before raft resets the log.

Crash consistency: the checkpoint is written to ``base.kv.tmp``,
fsynced, renamed over ``base.kv`` and the directory fsynced — the
rename is the commit point.  WAL frames are CRC-framed; replay stops at
the first torn/corrupt frame and truncates it away (a torn final write
is exactly what ``StrictMemFS.crash()`` produces).  Replay SKIPS frames
at or below the checkpoint's applied index — the "replay only the WAL
suffix past the persisted index" discipline, pinned by
tests/test_bigstate.py.

Command codec (struct-framed, not pickle — commands travel the wire and
the library-wide no-pickle guard applies): ``put_cmd``/``del_cmd``.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from ..pb import MASK64
from ..statemachine import IOnDiskStateMachine, Result, SnapshotStopped
from ..storage import vfs as vfs_mod

BASE_FILENAME = "base.kv"
WAL_FILENAME = "wal.log"

_MAGIC = 0x4B444B56  # "VKDK"
_BASE_VERSION = 1
_u32 = struct.Struct("<I")
_u64 = struct.Struct("<Q")
_frame_hdr = struct.Struct("<II")  # payload len, crc32

OP_PUT = 1
OP_DEL = 2

# default WAL size past which sync() folds it into a fresh checkpoint
DEFAULT_COMPACT_WAL_BYTES = 32 * 1024 * 1024
_READ_SLICE = 1 << 20  # bounded read unit for replay/recovery


def put_cmd(key: bytes, value: bytes) -> bytes:
    """The OnDiskKV write command (op, klen, key, value)."""
    return b"".join(
        (bytes([OP_PUT]), _u32.pack(len(key)), key, value)
    )


def del_cmd(key: bytes) -> bytes:
    return b"".join((bytes([OP_DEL]), _u32.pack(len(key)), key))


def decode_cmd(cmd: bytes) -> Tuple[int, bytes, bytes]:
    """(op, key, value); raises ValueError on a malformed command."""
    if len(cmd) < 5:
        raise ValueError("OnDiskKV: short command")
    op = cmd[0]
    (klen,) = _u32.unpack_from(cmd, 1)
    if op not in (OP_PUT, OP_DEL) or len(cmd) < 5 + klen:
        raise ValueError(f"OnDiskKV: malformed command (op={op})")
    key = cmd[1 + 4: 5 + klen]
    return op, key, cmd[5 + klen:]


class _BoundedReader:
    """Incremental reads over a seekable vfs handle with its own
    buffer — WAL/checkpoint replay touches one slice at a time."""

    def __init__(self, f):
        self._f = f
        self._buf = b""
        self._off = 0  # consumed bytes (absolute)

    def exactly(self, n: int) -> Optional[bytes]:
        """n bytes, or None at a clean EOF boundary; short tail data
        (a torn frame) also returns None — callers treat both as end."""
        while len(self._buf) < n:
            piece = self._f.read(_READ_SLICE)
            if not piece:
                return None
            self._buf += piece
        out, self._buf = self._buf[:n], self._buf[n:]
        self._off += n
        return out

    @property
    def consumed(self) -> int:
        return self._off


class OnDiskKV(IOnDiskStateMachine):
    """Durable KV state machine (see module docstring).

    ``base_dir`` is this replica's private directory; ``fs`` any
    :class:`storage.vfs.IVFS` (StrictMemFS in crash tests).  The
    in-core dict is the working set — lookups never touch disk.
    """

    def __init__(
        self,
        shard_id: int,
        replica_id: int,
        base_dir: Optional[str] = None,
        fs: Optional[vfs_mod.IVFS] = None,
        compact_wal_bytes: int = DEFAULT_COMPACT_WAL_BYTES,
    ):
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.fs = fs or vfs_mod.DEFAULT
        self.dir = base_dir or os.path.join(
            "/tmp", "tpu-raft-ondiskkv", f"{shard_id}-{replica_id}"
        )
        self.compact_wal_bytes = compact_wal_bytes
        self._data: Dict[bytes, bytes] = {}
        self.applied = 0  # highest index applied to the in-core state
        self._wal = None  # open append handle
        self._wal_bytes = 0  # bytes in the current WAL (incl. unsynced)
        self._bytes = 0  # sum of key+value bytes (the "state size" probe)
        # serializes checkpoint rewrites against close(); update/sync
        # run on the one apply worker and need no lock among themselves
        self._io_lock = threading.Lock()
        # observability for tests/bench
        self.stats = {
            "opens": 0, "replayed": 0, "skipped": 0, "torn": 0,
            "checkpoints": 0, "syncs": 0,
        }

    # -- paths ----------------------------------------------------------
    @property
    def _base_path(self) -> str:
        return os.path.join(self.dir, BASE_FILENAME)

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.dir, WAL_FILENAME)

    # -- lifecycle ------------------------------------------------------
    def open(self, stopc) -> int:
        """Recover checkpoint + WAL suffix; report the applied index."""
        self.stats["opens"] += 1
        self.fs.makedirs(self.dir)
        parent = os.path.dirname(self.dir.rstrip("/"))
        if parent:
            try:
                self.fs.sync_dir(parent)  # make our own dir's creation durable
            except (OSError, FileNotFoundError):  # relative/odd roots:
                pass  # best-effort — makedirs itself is the contract
        self._data = {}
        self._bytes = 0
        self.applied = 0
        if self.fs.exists(self._base_path):
            self._load_checkpoint()
        self._replay_wal()
        self._wal = self.fs.open_append(self._wal_path)
        self._wal_bytes = self.fs.stat_size(self._wal_path)
        return self.applied

    def _load_checkpoint(self) -> None:
        f = self.fs.open_read(self._base_path)
        try:
            r = _BoundedReader(f)
            hdr = r.exactly(4 + 1 + _u64.size + _u64.size)
            if hdr is None or _u32.unpack_from(hdr, 0)[0] != _MAGIC:
                raise IOError(f"{self._base_path}: bad checkpoint header")
            if hdr[4] != _BASE_VERSION:
                raise IOError(
                    f"{self._base_path}: unsupported version {hdr[4]}"
                )
            (applied,) = _u64.unpack_from(hdr, 5)
            (count,) = _u64.unpack_from(hdr, 13)
            for _ in range(count):
                rec = self._read_record(r)
                if rec is None:
                    raise IOError(
                        f"{self._base_path}: truncated checkpoint "
                        f"(expected {count} records)"
                    )
                k, v = rec
                self._data[k] = v
                self._bytes += len(k) + len(v)
            self.applied = applied
        finally:
            f.close()

    @staticmethod
    def _read_record(r: _BoundedReader) -> Optional[Tuple[bytes, bytes]]:
        hdr = r.exactly(_frame_hdr.size)
        if hdr is None:
            return None
        ln, crc = _frame_hdr.unpack(hdr)
        body = r.exactly(ln)
        if body is None or zlib.crc32(body) != crc:
            raise IOError("checkpoint record corrupt")
        (klen,) = _u32.unpack_from(body, 0)
        return body[4: 4 + klen], body[4 + klen:]

    def _replay_wal(self) -> None:
        """Apply the WAL suffix past the checkpoint's applied index;
        truncate away a torn tail (crash mid-append)."""
        if not self.fs.exists(self._wal_path):
            return
        f = self.fs.open_read(self._wal_path)
        try:
            r = _BoundedReader(f)
            good = 0  # offset past the last intact frame
            while True:
                hdr = r.exactly(_frame_hdr.size)
                if hdr is None:
                    break
                ln, crc = _frame_hdr.unpack(hdr)
                body = r.exactly(ln)
                if body is None or zlib.crc32(body) != crc:
                    self.stats["torn"] += 1
                    break
                good = r.consumed
                (index,) = _u64.unpack_from(body, 0)
                if index <= self.applied:
                    # at/below the persisted index: the checkpoint (or a
                    # replayed predecessor) already holds this write —
                    # the replay-only-the-suffix discipline
                    self.stats["skipped"] += 1
                    continue
                self._apply_cmd(body[8:])
                self.applied = index
                self.stats["replayed"] += 1
        finally:
            f.close()
        if good < self.fs.stat_size(self._wal_path):
            # drop the torn/corrupt tail so the reopened append handle
            # never interleaves fresh frames with garbage
            self.fs.truncate(self._wal_path, good)

    def _apply_cmd(self, cmd: bytes) -> Result:
        try:
            op, k, v = decode_cmd(cmd)
        except ValueError:
            return Result(value=0)
        if op == OP_PUT:
            old = self._data.get(k)
            if old is not None:
                self._bytes -= len(k) + len(old)
            self._data[k] = v
            self._bytes += len(k) + len(v)
            return Result(value=1)
        old = self._data.pop(k, None)
        if old is not None:
            self._bytes -= len(k) + len(old)
        return Result(value=1 if old is not None else 0)

    # -- apply path (one apply worker) ----------------------------------
    def update(self, entries: List) -> List:
        if self._wal is None:
            raise RuntimeError("OnDiskKV.update before open()")
        for e in entries:
            body = _u64.pack(e.index & MASK64) + e.cmd
            frame = _frame_hdr.pack(len(body), zlib.crc32(body)) + body
            self._wal.write(frame)
            self._wal_bytes += len(frame)
            e.result = self._apply_cmd(e.cmd)
            self.applied = e.index
        if self._wal_bytes >= self.compact_wal_bytes:
            # fold the WAL into a fresh checkpoint HERE, on the apply
            # path that generated the bytes (amortized, LSM-style), NOT
            # in sync(): the rsm calls sync() inside its apply-exclusive
            # section right before every snapshot, and an O(state)
            # rewrite there would stall all applies for the duration
            # (review finding).  The checkpoint is durable on its own
            # (tmp -> fsync -> rename -> dir fsync), so folding
            # not-yet-synced frames is safe — it only ever makes MORE
            # applied state durable.
            with self._io_lock:
                self._write_checkpoint(self.applied, self._data.items())
                self._reset_wal()
        return entries

    def lookup(self, query):
        # tuple OR list: RPC queries ride the JSON value lane, which
        # turns ("get", k) into ["get", k] (transport/wire.py contract)
        if (
            isinstance(query, (tuple, list))
            and len(query) == 2
            and query[0] == "get"
        ):
            query = query[1]
        if query == ("stats",) or query == ["stats"]:
            return {
                "applied": self.applied,
                "keys": len(self._data),
                "bytes": self._bytes,
                **self.stats,
            }
        return self._data.get(query)

    def sync(self) -> None:
        """One fsync makes every applied entry durable.  Deliberately
        O(1): the rsm calls this inside its apply-exclusive section
        before fixing every snapshot point, so the WAL->checkpoint fold
        lives on the update() path instead (amortized per
        ``compact_wal_bytes`` of writes)."""
        self.stats["syncs"] += 1
        self._wal.sync()

    def _write_checkpoint(self, applied: int, items) -> None:
        """Atomic checkpoint rewrite: tmp -> fsync -> rename -> dir
        fsync (the commit point)."""
        seq = items if hasattr(items, "__len__") else list(items)
        count = len(seq)

        def all_chunks() -> Iterator[bytes]:
            yield _u32.pack(_MAGIC) + bytes([_BASE_VERSION])
            yield _u64.pack(applied & MASK64)
            yield _u64.pack(count & MASK64)
            for k, v in seq:
                body = _u32.pack(len(k)) + k + v
                yield _frame_hdr.pack(len(body), zlib.crc32(body))
                yield body

        tmp = self._base_path + ".tmp"
        self.fs.write_file_chunks(tmp, all_chunks())
        self.fs.rename(tmp, self._base_path)
        self.fs.sync_dir(self.dir)
        self.stats["checkpoints"] += 1

    def _reset_wal(self) -> None:
        """Empty the WAL after its contents landed in the checkpoint.
        Order matters: the checkpoint rename is already durable, so a
        crash between it and this truncate only leaves frames the next
        replay SKIPS (index <= checkpoint applied)."""
        if self._wal is not None:
            self._wal.close()
        self.fs.truncate(self._wal_path, 0)
        self._wal = self.fs.open_append(self._wal_path)
        self._wal_bytes = 0

    # -- snapshots ------------------------------------------------------
    def prepare_snapshot(self):
        """Point-in-time view: (applied, shallow dict copy).  Values are
        immutable bytes, so the copy is O(keys) pointers — cheap even at
        GB-scale values — and save_snapshot streams OUTSIDE the apply
        lock from this view (rsm concurrent-snapshot discipline)."""
        return self.applied, dict(self._data)

    def save_snapshot(self, ctx, w, done) -> None:
        """Stream the prepared view record-by-record (bounded memory)."""
        applied, data = ctx
        w.write(_u32.pack(_MAGIC) + bytes([_BASE_VERSION]))
        w.write(_u64.pack(applied & MASK64))
        w.write(_u64.pack(len(data)))
        i = 0
        for k, v in data.items():
            body = _u32.pack(len(k)) + k + v
            w.write(_frame_hdr.pack(len(body), zlib.crc32(body)))
            w.write(body)
            i += 1
            if (i & 0x3FF) == 0 and done.is_set():
                raise SnapshotStopped()

    def recover_from_snapshot(self, r, done) -> None:
        """Rebuild from a streamed snapshot and make it DURABLE (fresh
        checkpoint + empty WAL) before returning — raft resets the log
        to the snapshot point right after, so un-persisted recovered
        state would be unrecoverable after a crash."""
        br = _BoundedReader(r)
        hdr = br.exactly(4 + 1 + _u64.size + _u64.size)
        if hdr is None or _u32.unpack_from(hdr, 0)[0] != _MAGIC:
            raise IOError("OnDiskKV snapshot: bad header")
        if hdr[4] != _BASE_VERSION:
            raise IOError(f"OnDiskKV snapshot: unsupported version {hdr[4]}")
        (applied,) = _u64.unpack_from(hdr, 5)
        (count,) = _u64.unpack_from(hdr, 13)
        data: Dict[bytes, bytes] = {}
        nbytes = 0
        for i in range(count):
            rec = self._read_record(br)
            if rec is None:
                raise IOError(
                    f"OnDiskKV snapshot: truncated at record {i}/{count}"
                )
            k, v = rec
            data[k] = v
            nbytes += len(k) + len(v)
            if (i & 0x3FF) == 0 and done.is_set():
                raise SnapshotStopped()
        self._data = data
        self._bytes = nbytes
        self.applied = applied
        with self._io_lock:
            self.fs.makedirs(self.dir)
            self._write_checkpoint(applied, self._data.items())
            if self._wal is None:
                # recover before open() (imported snapshot boot path)
                self.fs.write_file_chunks(self._wal_path, ())
            self._reset_wal()

    def close(self) -> None:
        with self._io_lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None


def ondisk_kv_factory(
    root: str,
    fs: Optional[vfs_mod.IVFS] = None,
    compact_wal_bytes: int = DEFAULT_COMPACT_WAL_BYTES,
):
    """``sm_factory`` for NodeHost.start_replica: each replica gets its
    own subdirectory of ``root`` (replicas NEVER share state dirs)."""

    def factory(shard_id: int, replica_id: int) -> OnDiskKV:
        return OnDiskKV(
            shard_id,
            replica_id,
            base_dir=os.path.join(root, f"{shard_id}-{replica_id}"),
            fs=fs,
            compact_wal_bytes=compact_wal_bytes,
        )

    return factory
