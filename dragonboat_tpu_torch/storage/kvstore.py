"""A minimal embedded ordered KV store with durable atomic batches.

reference: internal/logdb/kv/kv.go -> IKVStore + the pebble binding
[U].  The reference's classic LogDB stores key-encoded raft records in
a general-purpose LSM KV; this is the same contract in miniature:

  * ordered byte-string keys, range iteration, range deletion
  * atomic durable write batches (ONE fsync per commit)
  * crash safety over the vfs layer (journal replay, torn-tail
    truncation, checkpoint-compaction GC — the discipline the tan WAL
    established, reused here and fuzzable on StrictMemFS)

Design: an in-memory ordered map (sorted key list + dict) backed by a
crc-framed journal.  When the journal outgrows a threshold, a CHECKPOINT
file is written with the full live state and older journal segments are
deleted; replay = newest checkpoint + journal tail.  This favors raft's
write-mostly access pattern without the weight of a full LSM tree.
"""
from __future__ import annotations

import bisect
import struct
import threading
from io import BytesIO
from typing import Dict, List, Optional, Tuple

from .journal import CorruptJournalError, frame_record, scan_segment
from .vfs import DEFAULT as OS_VFS, IVFS

OP_PUT = 1
OP_DELETE = 2
OP_DELETE_RANGE = 3
OP_CHECKPOINT_START = 4
OP_CHECKPOINT_END = 5
OP_BATCH = 6  # a whole WriteBatch in ONE crc-framed record (atomicity)

JOURNAL_PREFIX = "KV-"
DEFAULT_MAX_JOURNAL_BYTES = 32 * 1024 * 1024
DEFAULT_GC_SEGMENTS = 3


class CorruptKVError(CorruptJournalError):
    """Mid-journal corruption (not a clean torn tail)."""


_frame = frame_record


def _enc_kv(key: bytes, val: bytes) -> bytes:
    b = BytesIO()
    b.write(struct.pack("<I", len(key)))
    b.write(key)
    b.write(struct.pack("<I", len(val)))
    b.write(val)
    return b.getvalue()


def _dec_kv(body: bytes) -> Tuple[bytes, bytes]:
    (klen,) = struct.unpack_from("<I", body, 0)
    key = body[4 : 4 + klen]
    (vlen,) = struct.unpack_from("<I", body, 4 + klen)
    val = body[8 + klen : 8 + klen + vlen]
    if 8 + klen + vlen != len(body):
        raise CorruptKVError("kv record length mismatch")
    return key, val


class WriteBatch:
    """Atomic mutation set; applied + fsynced as one journal append."""

    __slots__ = ("ops",)

    def __init__(self):
        self.ops: List[Tuple[int, bytes, bytes]] = []

    def put(self, key: bytes, val: bytes) -> None:
        self.ops.append((OP_PUT, key, val))

    def delete(self, key: bytes) -> None:
        self.ops.append((OP_DELETE, key, b""))

    def delete_range(self, lo: bytes, hi: bytes) -> None:
        """Delete keys in [lo, hi)."""
        self.ops.append((OP_DELETE_RANGE, lo, hi))


class KVStore:
    """One journaled ordered map (a 'shard' of the sharded LogDB)."""

    def __init__(
        self,
        directory: str,
        *,
        fs: Optional[IVFS] = None,
        max_journal_bytes: int = DEFAULT_MAX_JOURNAL_BYTES,
        gc_segments: int = DEFAULT_GC_SEGMENTS,
    ):
        self.dir = directory
        self.fs = fs if fs is not None else OS_VFS
        self.max_journal_bytes = max_journal_bytes
        self.gc_segments = gc_segments
        self._lock = threading.Lock()
        self._map: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []  # sorted
        self._fh = None
        self._active_seq = 0
        self._active_bytes = 0
        self.fs.makedirs(directory)
        self._replay()
        self._open_active()

    # -- segments --------------------------------------------------------
    def _segments(self) -> List[int]:
        out = []
        for name in self.fs.listdir(self.dir):
            if name.startswith(JOURNAL_PREFIX) and name.endswith(".log"):
                try:
                    out.append(int(name[len(JOURNAL_PREFIX) : -4]))
                except ValueError:
                    pass
        return sorted(out)

    def _path(self, seq: int) -> str:
        return f"{self.dir}/{JOURNAL_PREFIX}{seq:08d}.log"

    def _open_active(self) -> None:
        segs = self._segments()
        self._active_seq = (segs[-1] + 1) if segs else 1
        self._fh = self.fs.open_append(self._path(self._active_seq))
        self._active_bytes = self._fh.tell()
        self.fs.sync_dir(self.dir)

    def _close_active(self) -> None:
        if self._fh is not None:
            fh, self._fh = self._fh, None
            fh.close()

    # -- replay ----------------------------------------------------------
    def _replay(self) -> None:
        self._ckpt_pending: Optional[Dict[bytes, bytes]] = None
        segs = self._segments()
        for i, seq in enumerate(segs):
            self._replay_segment(self._path(seq), torn_ok=i == len(segs) - 1)
            # a torn checkpoint (START without END) is discarded
            # wholesale: the pre-checkpoint state is intact because old
            # segments are only deleted AFTER the END record is durable.
            # Discard per SEGMENT — a checkpoint never spans segments,
            # so pending state at a segment boundary is always a tear.
            self._ckpt_pending = None

    def _replay_segment(self, path: str, torn_ok: bool) -> None:
        scan_segment(
            self.fs, path, self.dir, torn_ok, self._apply, CorruptKVError
        )

    def _apply(self, op: int, body: bytes) -> None:
        if op == OP_CHECKPOINT_START:
            # buffer the checkpoint: it only replaces the live map when
            # the END marker proves it was written completely
            self._ckpt_pending = {}
            return
        if op == OP_CHECKPOINT_END:
            if self._ckpt_pending is not None:
                self._map = dict(self._ckpt_pending)
                self._keys = sorted(self._map)
                self._ckpt_pending = None
            return
        if self._ckpt_pending is not None:
            if op == OP_PUT:
                key, val = _dec_kv(body)
                self._ckpt_pending[key] = val
                return
            raise CorruptKVError(f"op {op} inside a checkpoint")
        if op == OP_PUT:
            key, val = _dec_kv(body)
            self._put_mem(key, val)
        elif op == OP_DELETE:
            key, _ = _dec_kv(body)
            self._del_mem(key)
        elif op == OP_DELETE_RANGE:
            lo, hi = _dec_kv(body)
            self._del_range_mem(lo, hi)
        elif op == OP_BATCH:
            # the record boundary IS the atomicity boundary: a torn tail
            # drops the whole batch, never a prefix of it (reference:
            # pebble WriteBatch atomicity [U])
            pos, n = 0, len(body)
            while pos < n:
                sub = body[pos]
                (ln,) = struct.unpack_from("<I", body, pos + 1)
                self._apply(sub, body[pos + 5 : pos + 5 + ln])
                pos += 5 + ln
            if pos != n:
                raise CorruptKVError("batch record length mismatch")
        else:
            raise CorruptKVError(f"unknown op {op}")

    # -- in-memory ordered map ------------------------------------------
    def _put_mem(self, key: bytes, val: bytes) -> None:
        if key not in self._map:
            bisect.insort(self._keys, key)
        self._map[key] = val

    def _del_mem(self, key: bytes) -> None:
        if key in self._map:
            del self._map[key]
            i = bisect.bisect_left(self._keys, key)
            if i < len(self._keys) and self._keys[i] == key:
                del self._keys[i]

    def _del_range_mem(self, lo: bytes, hi: bytes) -> None:
        i = bisect.bisect_left(self._keys, lo)
        j = bisect.bisect_left(self._keys, hi)
        for k in self._keys[i:j]:
            del self._map[k]
        del self._keys[i:j]

    # -- public API ------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._map.get(key)

    def iterate(
        self, lo: bytes, hi: bytes
    ) -> List[Tuple[bytes, bytes]]:
        """Ordered (key, value) pairs with lo <= key < hi."""
        with self._lock:
            i = bisect.bisect_left(self._keys, lo)
            j = bisect.bisect_left(self._keys, hi)
            return [(k, self._map[k]) for k in self._keys[i:j]]

    def commit(self, batch: WriteBatch, sync: bool = True) -> None:
        """Apply + durably journal a batch: ONE crc-framed record and
        ONE fsync, so the batch is all-or-nothing across crashes
        (reference: a single fsynced pebble WriteBatch per
        SaveRaftState [U])."""
        body = BytesIO()
        for op, a, b in batch.ops:
            kv = _enc_kv(a, b)
            body.write(struct.pack("<BI", op, len(kv)))
            body.write(kv)
        raw = _frame(OP_BATCH, body.getvalue())
        with self._lock:
            self._fh.write(raw)
            if sync:
                self._fh.sync()
            for op, a, b in batch.ops:
                if op == OP_PUT:
                    self._put_mem(a, b)
                elif op == OP_DELETE:
                    self._del_mem(a)
                else:
                    self._del_range_mem(a, b)
            self._active_bytes += len(raw)
            # rotation AFTER the in-memory map reflects the batch: the
            # checkpoint serializes the map (same publish-then-rotate
            # rule the power-loss fuzz enforced on the tan WAL)
            if self._active_bytes >= self.max_journal_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._close_active()
        self._open_active()
        if len(self._segments()) - 1 > self.gc_segments:
            self._checkpoint_gc()

    def _checkpoint_gc(self) -> None:
        old = [s for s in self._segments() if s != self._active_seq]
        buf = BytesIO()
        buf.write(_frame(OP_CHECKPOINT_START, _enc_kv(b"", b"")))
        for k in self._keys:
            buf.write(_frame(OP_PUT, _enc_kv(k, self._map[k])))
        buf.write(_frame(OP_CHECKPOINT_END, _enc_kv(b"", b"")))
        raw = buf.getvalue()
        self._fh.write(raw)
        self._fh.sync()  # END is durable before any old segment dies
        self._active_bytes += len(raw)
        self.fs.sync_dir(self.dir)
        for seq in old:
            try:
                self.fs.unlink(self._path(seq))
            except OSError:
                pass
        self.fs.sync_dir(self.dir)

    def close(self) -> None:
        with self._lock:
            self._close_active()
