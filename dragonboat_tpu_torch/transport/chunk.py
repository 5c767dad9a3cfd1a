"""Snapshot chunking: split on the sender, reassemble on the receiver.

reference: internal/transport/chunk.go (splitSnapshotMessage, Chunk.Add)
[U].  A snapshot never travels as one message: the sender's stream job
reads the container INCREMENTALLY (one chunk in memory at a time, under
a storage GC lease) and streams fixed-size chunks over the snapshot
lane; the receiver writes each chunk to its OWN local snapshot storage
as it lands (bounded memory on both sides) and only then injects the
InstallSnapshot message into the raft path.  External files
(ISnapshotFileCollection) travel as additional chunk sequences tagged
with ``has_file_info``, exactly like the reference's file chunks.
Replicas never share snapshot files by path — each host owns its copy.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .. import settings
from ..logger import get_logger
from ..pb import Chunk, Message, MessageType, Snapshot, SnapshotFile

_log = get_logger("transport")


def _stream_geometry(m: Message, source, size: int):
    """(total_chunks, main_size, files) for one stream — shared by the
    chunk iterator and the sender's resume probe so both agree on the
    stream identity fields byte-for-byte."""
    ss = m.snapshot
    if ss.dummy:
        return 1, 0, []

    def n_chunks(nbytes: int) -> int:
        return max(1, -(-nbytes // size))

    files: List[Tuple[SnapshotFile, str]] = source.externals
    main_size = source.main_size
    total = n_chunks(main_size) + sum(
        n_chunks(sf.file_size) for sf, _ in files
    )
    return total, main_size, files


def resume_probe(m: Message, source, chunk_size: Optional[int] = None) -> Chunk:
    """A data-less chunk carrying one stream's identity, for
    ``ISnapshotConnection.query_resume``: the receiver matches it
    against its in-flight record's ``_chunk_ident`` and answers with
    its receive cursor (the next chunk offset it needs).  The cursor is
    keyed by snapshot index + chunk geometry, so a resumed sender can
    only continue the SAME immutable payload it was sending."""
    ss = m.snapshot
    size = chunk_size or settings.Soft.snapshot_chunk_size
    total, main_size, _files = _stream_geometry(m, source, size)
    return Chunk(
        shard_id=m.shard_id,
        replica_id=m.to,
        from_=m.from_,
        chunk_count=total,
        index=ss.index,
        term=ss.term,
        message_term=m.term,
        membership=ss.membership,
        filepath=ss.filepath,
        file_size=main_size,
        witness=ss.witness,
        dummy=ss.dummy,
        on_disk_index=ss.on_disk_index,
    )


def iter_snapshot_chunks(
    m: Message, source, chunk_size: Optional[int] = None,
    start_chunk: int = 0,
) -> Iterator[Chunk]:
    """Lazily yield the wire chunks for an InstallSnapshot message.

    ``source`` is a ``SnapshotSource`` (storage/snapshotter.py): main
    container + external files, read incrementally so only one chunk is
    ever materialized (reference: splitSnapshotMessage + job.go
    incremental reads [U]).  ``source`` must stay open for the duration.

    ``start_chunk`` resumes a partially-delivered stream: chunks below
    it are neither read nor sent (the main container is seeked past;
    fully-delivered external files are never opened).  Chunk ``k`` of a
    given (index, term, geometry) is a fixed byte range of immutable
    snapshot files, so a resumed iteration yields byte-identical chunks.
    """
    ss = m.snapshot
    size = chunk_size or settings.Soft.snapshot_chunk_size

    def n_chunks(nbytes: int) -> int:
        return max(1, -(-nbytes // size))

    total, main_size, files = _stream_geometry(m, source, size)

    def base(i: int, piece: bytes, **kw) -> Chunk:
        return Chunk(
            shard_id=m.shard_id,
            replica_id=m.to,
            from_=m.from_,
            chunk_id=i,
            chunk_size=len(piece),
            chunk_count=total,
            index=ss.index,
            term=ss.term,
            message_term=m.term,
            data=piece,
            membership=ss.membership,
            filepath=ss.filepath,
            file_size=main_size,
            witness=ss.witness,
            dummy=ss.dummy,
            on_disk_index=ss.on_disk_index,
            **kw,
        )

    if ss.dummy:
        if start_chunk == 0:
            yield base(0, b"")
        return

    mcount = n_chunks(main_size)
    cid = 0
    if start_chunk < mcount:
        with source.open_main() as f:
            sent = 0
            if start_chunk:
                f.seek(start_chunk * size)
                cid = start_chunk
                sent = start_chunk * size
            while True:
                piece = f.read(size)
                if not piece and sent > 0:
                    break
                yield base(cid, piece)
                cid += 1
                sent += len(piece)
                if not piece:
                    break
    else:
        cid = mcount
    for sf, path in files:
        fcount = n_chunks(sf.file_size)
        if start_chunk >= cid + fcount:
            cid += fcount  # file fully delivered before the resume point
            continue
        with source.open_external(path) as f:
            fcid = 0
            if start_chunk > cid:
                fcid = start_chunk - cid
                f.seek(fcid * size)
                cid = start_chunk
            while True:
                piece = f.read(size)
                if not piece and fcid > 0:
                    break
                yield base(
                    cid,
                    piece,
                    has_file_info=True,
                    file_info=sf,
                    file_chunk_id=fcid,
                    file_chunk_count=fcount,
                )
                cid += 1
                fcid += 1
                if not piece:
                    break


def split_snapshot_message(
    m: Message, payload: bytes, chunk_size: Optional[int] = None
) -> List[Chunk]:
    """Split an in-memory payload into wire chunks (tests and the
    in-proc fast path; the production sender uses iter_snapshot_chunks)."""

    class _BytesSource:
        main_size = len(payload)
        externals: List[Tuple[SnapshotFile, str]] = []

        def open_main(self):
            import io

            return io.BytesIO(payload)

        def open_external(self, path):  # pragma: no cover - no externals
            raise FileNotFoundError(path)

    return list(iter_snapshot_chunks(m, _BytesSource(), chunk_size))


class _InFlight:
    __slots__ = (
        "sink", "next_chunk", "count", "ident", "cur_file", "pending_open",
    )

    def __init__(self, count: int, ident: tuple, sink):
        self.sink = sink  # None for dummy snapshots
        self.pending_open = False
        self.next_chunk = 0
        self.count = count
        self.cur_file = None  # file_id currently being written
        # stream identity: every chunk of one stream must agree on these,
        # otherwise two interleaved streams from the same sender could
        # splice into one corrupted payload (reference: Chunk.Add validates
        # non-leading chunks against the in-flight record [U])
        self.ident = ident


def _chunk_ident(c: Chunk) -> tuple:
    return (c.index, c.term, c.message_term, c.chunk_count, c.file_size, c.filepath)


class ChunkSink:
    """Receiver-side reassembly, one in-flight snapshot per (shard, sender)
    (reference: transport.Chunk tracking in-flight state per key [U]).

    ``begin_fn(shard_id, replica_id, index) -> sink`` opens an
    incremental receive sink in local snapshot storage (``write``,
    ``begin_external``, ``finalize() -> filepath``, ``abort``);
    ``deliver_fn(message)`` hands the reconstituted InstallSnapshot to
    the raft path; ``confirm_fn(shard_id, from_replica, to_replica)``
    sends SnapshotReceived back to the sender.
    """

    def __init__(
        self,
        begin_fn: Callable[[int, int, int], object],
        deliver_fn: Callable[[Message], None],
        confirm_fn: Optional[Callable[[int, int, int], None]] = None,
        reject_fn: Optional[Callable[[int, int, int], None]] = None,
    ):
        self.begin_fn = begin_fn
        self.deliver_fn = deliver_fn
        self.confirm_fn = confirm_fn
        # a completed stream whose container fails validation (corrupt
        # payload survived the wire): tell the sender so its raft peer
        # clears the pending snapshot and retries
        self.reject_fn = reject_fn
        self._lock = threading.Lock()
        self._inflight: Dict[Tuple[int, int], _InFlight] = {}

    def resume_cursor(self, probe: Chunk) -> int:
        """The receive cursor for a stream matching ``probe``'s identity
        (``transport.chunk.resume_probe``): the next chunk offset this
        receiver needs, or 0 when no matching in-flight stream exists
        (restart from scratch).  Chunks below the cursor are already on
        local disk; a reconnected sender skips them entirely — the
        resume half of the resumable-stream protocol (docs/BIGSTATE.md).
        """
        with self._lock:
            fl = self._inflight.get((probe.shard_id, probe.from_))
            if fl is not None and fl.ident == _chunk_ident(probe):
                return fl.next_chunk
        return 0

    def add(self, c: Chunk) -> bool:
        """Accept one chunk; returns False to make the sender abort the
        stream (out-of-order / mismatched chunk).

        The lock only guards the in-flight MAP: all disk I/O (sink open,
        writes, the per-file fsync at external boundaries) runs outside
        it, so concurrent inbound streams from different senders never
        queue behind each other's fsyncs.  Per-stream fields of one
        ``_InFlight`` are touched only by its delivering connection
        thread; a superseding chunk 0 swaps the map entry under the lock
        and aborts the old sink outside it.
        """
        key = (c.shard_id, c.from_)
        stale = None
        with self._lock:
            fl = self._inflight.get(key)
            if (
                fl is not None
                and _chunk_ident(c) == fl.ident
                and c.chunk_id < fl.next_chunk
            ):
                # idempotent re-delivery of an already-written offset: a
                # reconnected sender restarting below the receive cursor
                # (no resume support, or an overlapping resume) re-sends
                # bytes that are already on local disk — chunk k of one
                # identity is a fixed range of an immutable snapshot, so
                # accept-and-discard is safe, and rejecting would burn
                # the whole transfer back to zero (the pre-fix behavior)
                return True
            if c.chunk_id == 0:
                stale = fl
                fl = _InFlight(c.chunk_count, _chunk_ident(c), None)
                fl.pending_open = not c.dummy
                self._inflight[key] = fl
            elif (
                fl is None
                or c.chunk_id != fl.next_chunk
                or _chunk_ident(c) != fl.ident
            ):
                stale = self._inflight.pop(key, None)
                fl = None
        if stale is not None and stale.sink is not None:
            stale.sink.abort()
        if fl is None:
            _log.warning(
                "out-of-order/mismatched chunk %d for shard %d from %d",
                c.chunk_id,
                c.shard_id,
                c.from_,
            )
            return False
        try:
            if fl.pending_open:
                fl.pending_open = False
                fl.sink = self.begin_fn(c.shard_id, c.replica_id, c.index)
            if fl.sink is not None:
                if c.has_file_info and fl.cur_file != c.file_info.file_id:
                    fl.cur_file = c.file_info.file_id
                    fl.sink.begin_external(c.file_info.filepath)
                fl.sink.write(c.data)
        except Exception as e:  # noqa: BLE001 - disk trouble
            _log.warning("receive sink failed: %s", e)
            if fl.sink is not None:
                fl.sink.abort()
            with self._lock:
                if self._inflight.get(key) is fl:
                    del self._inflight[key]
            # tell the SENDER over the wire, like the validation-failure
            # path in _complete: on transports where the send is
            # buffered (TCP) the returned False never reaches the
            # sending stream job, and without the reject the leader's
            # raft remote would wedge in SNAPSHOT state forever
            if self.reject_fn is not None:
                self.reject_fn(c.shard_id, c.from_, c.replica_id)
            return False
        fl.next_chunk = c.chunk_id + 1
        done = fl.next_chunk == fl.count
        if done:
            with self._lock:
                if self._inflight.get(key) is fl:
                    del self._inflight[key]
            # a corrupt/unfinalizable stream returns False for the LAST
            # chunk: the sending stream job sees a failed send and runs
            # its retry/report path instead of assuming delivery
            return self._complete(c, fl)
        return True

    def _complete(self, last: Chunk, fl: _InFlight) -> bool:
        if fl.sink is None:
            filepath = ""
        else:
            validate = getattr(fl.sink, "validate", None)
            if validate is not None:
                try:
                    validate()
                except Exception as e:  # noqa: BLE001 - corrupt container
                    _log.warning(
                        "received snapshot for shard %d from %d failed "
                        "validation, discarding: %s",
                        last.shard_id, last.from_, e,
                    )
                    fl.sink.abort()
                    if self.reject_fn is not None:
                        self.reject_fn(last.shard_id, last.from_, last.replica_id)
                    return False
            try:
                filepath = fl.sink.finalize()
            except Exception as e:  # noqa: BLE001 - disk trouble
                _log.warning("receive sink finalize failed: %s", e)
                fl.sink.abort()
                if self.reject_fn is not None:
                    self.reject_fn(last.shard_id, last.from_, last.replica_id)
                return False
        ss = Snapshot(
            filepath=filepath,
            file_size=last.file_size,
            index=last.index,
            term=last.term,
            membership=last.membership,
            dummy=last.dummy,
            witness=last.witness,
            shard_id=last.shard_id,
            replica_id=last.replica_id,
            on_disk_index=last.on_disk_index,
        )
        self.deliver_fn(
            Message(
                type=MessageType.INSTALL_SNAPSHOT,
                shard_id=last.shard_id,
                from_=last.from_,
                to=last.replica_id,
                term=last.message_term,
                snapshot=ss,
            )
        )
        if self.confirm_fn is not None:
            self.confirm_fn(last.shard_id, last.from_, last.replica_id)
        return True
