"""Snapshot payload storage + the node<->rsm<->logdb snapshot bridge.

reference: snapshotter.go + internal/fileutil atomic dir finalize [U].

Two backends:
  * ``InMemSnapshotStorage`` — per-NodeHost in-memory store (tests); NOT
    shared between hosts — snapshots cross hosts only via the chunk lane.
  * ``FileSnapshotStorage`` — atomic temp-dir + fsync + rename layout,
    the NodeHost default (reference: fileutil.CreateFlagFile / SyncDir [U]).

Payload bytes are an opaque v2 container (storage/snapshotio.py) with
its own per-section checksums; the storage layer stores them VERBATIM.
External files (ISnapshotFileCollection) are staged as siblings of
``snapshot.bin`` in the snapshot dir and referenced by relative name
from the container's file table.

Streaming surfaces:
  * ``save_stream(shard, replica, index, build, suffix)`` — ``build``
    writes the container into an open file handle with bounded memory
    and may stage external files via the passed ``copy_fn``.
  * ``open_read(filepath)`` — seekable handle for incremental reads
    (chunked sends, SnapshotReader).
  * ``lease(filepath)`` — context manager pinning the snapshot dir
    against GC while a stream job reads it.
"""
from __future__ import annotations

import contextlib
import io
import os
import shutil
import threading
from typing import Callable, Dict, List, Optional, Set

from ..pb import SnapshotFile


def _external_name(file_id: int, src: str) -> str:
    return f"external-{file_id}-{os.path.basename(src)}"


def _make_copy_fn(dst_dir: str) -> Callable:
    """The ISnapshotFileCollection staging callback: copy the SM's file
    beside the container and record it by relative name."""

    def copy_fn(file_id: int, src: str, metadata: bytes) -> SnapshotFile:
        name = _external_name(file_id, src)
        dst = os.path.join(dst_dir, name)
        shutil.copyfile(src, dst)
        return SnapshotFile(
            file_id=file_id,
            filepath=name,
            file_size=os.path.getsize(dst),
            metadata=metadata,
        )

    return copy_fn


class _LeaseMixin:
    """GC-lease bookkeeping shared by the storage backends.

    ``lease(filepath)`` pins the snapshot against ``remove`` while a
    stream job reads it; a remove during a lease is deferred to the last
    release.  Subclasses provide ``_lease_key`` (filepath -> unit of
    deletion) and ``_delete(key)``.
    """

    def _init_leases(self) -> None:
        self._lock = threading.Lock()
        self._leases: Dict[str, int] = {}
        self._pending_delete: Set[str] = set()

    @contextlib.contextmanager
    def lease(self, filepath: str):
        key = self._lease_key(filepath)
        with self._lock:
            self._leases[key] = self._leases.get(key, 0) + 1
        try:
            yield
        finally:
            delete = False
            with self._lock:
                n = self._leases[key] - 1
                if n:
                    self._leases[key] = n
                else:
                    del self._leases[key]
                    delete = key in self._pending_delete
                    self._pending_delete.discard(key)
            if delete:
                self._delete(key)

    def remove(self, filepath: str) -> None:
        key = self._lease_key(filepath)
        with self._lock:
            if self._leases.get(key, 0) > 0:
                # a stream job is reading it: defer to last lease release
                self._pending_delete.add(key)
                return
        self._delete(key)


class InMemSnapshotStorage(_LeaseMixin):
    """Per-NodeHost in-memory store; keys are synthetic 'paths' so
    pb.Snapshot.filepath stays meaningful.  Deliberately NOT shared between
    hosts: snapshots cross hosts only via the transport chunk lane, exactly
    as in the reference.  External files are materialized into a private
    real directory (user SMs read them by path)."""

    def __init__(self):
        self._init_leases()
        self._store: Dict[str, bytes] = {}
        self._ext_root: Optional[str] = None

    def _key(self, shard_id, replica_id, index, suffix="") -> str:
        path = f"mem://snapshot-{shard_id}-{replica_id}-{index:020d}"
        if suffix:
            path += f"-{suffix}"
        return path

    def _ext_dir(self, key: str) -> str:
        import tempfile

        if self._ext_root is None:
            self._ext_root = tempfile.mkdtemp(prefix="tpu-raft-memss-")
        d = os.path.join(self._ext_root, key.replace("/", "_"))
        os.makedirs(d, exist_ok=True)
        return d

    def save(self, shard_id, replica_id, index, payload, suffix="") -> str:
        path = self._key(shard_id, replica_id, index, suffix)
        with self._lock:
            self._store[path] = payload
        return path

    def save_stream(
        self,
        shard_id: int,
        replica_id: int,
        index: int,
        build: Callable,
        suffix: str = "",
        index_from_result: Optional[Callable] = None,
    ):
        path = self._key(shard_id, replica_id, index, suffix)
        ext_dir = self._ext_dir(path)
        buf = io.BytesIO()
        result = build(buf, _make_copy_fn(ext_dir))
        if index_from_result is not None:
            # name from the index the container actually captured (it can
            # advance past the caller's pre-check for concurrent SMs)
            final = self._key(
                shard_id, replica_id, index_from_result(result), suffix
            )
            if final != path:
                new_ext = os.path.join(
                    self._ext_root, final.replace("/", "_")
                )
                shutil.rmtree(new_ext, ignore_errors=True)
                os.rename(ext_dir, new_ext)
                path = final
        with self._lock:
            self._store[path] = buf.getvalue()
        return path, result

    def load(self, filepath: str) -> bytes:
        with self._lock:
            data = self._store.get(filepath)
        if data is None:
            raise FileNotFoundError(filepath)
        return data

    def open_read(self, filepath: str):
        return io.BytesIO(self.load(filepath))

    def external_path(self, filepath: str, name: str) -> str:
        return os.path.join(self._ext_dir(filepath), name)

    def file_size(self, filepath: str) -> int:
        return len(self.load(filepath))

    # -- _LeaseMixin hooks ----------------------------------------------
    def _lease_key(self, filepath: str) -> str:
        return filepath

    def _delete(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)
        if self._ext_root is not None:
            shutil.rmtree(
                os.path.join(self._ext_root, key.replace("/", "_")),
                ignore_errors=True,
            )


class FileSnapshotStorage(_LeaseMixin):
    """Durable snapshot dirs with atomic finalize.

    Layout: <root>/snapshot-<shard>-<replica>-<index>/snapshot.bin
    (+ external-<id>-<name> siblings), written to a .generating temp dir,
    fsynced, then renamed — the rename is the commit point (reference:
    internal/fileutil [U]).
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._init_leases()

    def _dir(
        self, shard_id: int, replica_id: int, index: int, suffix: str = ""
    ) -> str:
        name = f"snapshot-{shard_id}-{replica_id}-{index:020d}"
        if suffix:
            name += f"-{suffix}"
        return os.path.join(self.root, name)

    def _finalize(self, tmp: str, final: str) -> None:
        if os.path.exists(final):
            # leftover from an earlier incarnation of this replica id (the
            # rename below cannot clobber a non-empty dir)
            shutil.rmtree(final)
        os.rename(tmp, final)
        dfd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dfd)  # make the rename itself durable
        finally:
            os.close(dfd)

    def _fresh_tmp(self, final: str) -> str:
        tmp = final + ".generating"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def save(self, shard_id, replica_id, index, payload, suffix="") -> str:
        final = self._dir(shard_id, replica_id, index, suffix)
        tmp = self._fresh_tmp(final)
        fpath = os.path.join(tmp, "snapshot.bin")
        with open(fpath, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        self._finalize(tmp, final)
        return os.path.join(final, "snapshot.bin")

    def save_stream(
        self,
        shard_id: int,
        replica_id: int,
        index: int,
        build: Callable,
        suffix: str = "",
        index_from_result: Optional[Callable] = None,
    ):
        """``build(fileobj, copy_fn) -> result`` writes the container;
        ``copy_fn(file_id, src_path, metadata) -> SnapshotFile`` stages
        an external file beside it.  Atomic finalize after build; the
        final dir is named from ``index_from_result(result)`` when given
        (the container's captured index can advance past the caller's
        pre-check for concurrent SMs)."""
        final = self._dir(shard_id, replica_id, index, suffix)
        tmp = self._fresh_tmp(final)
        fpath = os.path.join(tmp, "snapshot.bin")
        with open(fpath, "wb") as f:
            result = build(f, _make_copy_fn(tmp))
            f.flush()
            os.fsync(f.fileno())
        if index_from_result is not None:
            final = self._dir(
                shard_id, replica_id, index_from_result(result), suffix
            )
        self._finalize(tmp, final)
        return os.path.join(final, "snapshot.bin"), result

    def load(self, filepath: str) -> bytes:
        """Whole-blob convenience load (tests, small in-mem flows);
        streaming consumers use ``open_read`` + bounded reads."""
        with open(filepath, "rb") as f:
            # raftlint: ignore[stream-read] bytes-level convenience API
            return f.read()

    def open_read(self, filepath: str):
        return open(filepath, "rb")

    def external_path(self, filepath: str, name: str) -> str:
        return os.path.join(os.path.dirname(filepath), name)

    def file_size(self, filepath: str) -> int:
        return os.path.getsize(filepath)

    # -- _LeaseMixin hooks ----------------------------------------------
    def _lease_key(self, filepath: str) -> str:
        return os.path.dirname(filepath)

    def _delete(self, key: str) -> None:
        if os.path.isdir(key):
            shutil.rmtree(key, ignore_errors=True)


# ---------------------------------------------------------------------------
# streaming source (sender) and receive sinks (receiver)
# ---------------------------------------------------------------------------
class SnapshotSource:
    """Sender-side handle for one outbound snapshot stream.

    Owns a GC lease on the snapshot dir for its lifetime, so the stream
    job can read incrementally long after the step worker moved on
    (reference: transport/job.go reading the snapshot inside the job,
    with snapshotter GC deferred [U]).
    """

    def __init__(self, storage, snapshot):
        from .snapshotio import SnapshotReader

        self._storage = storage
        self._lease = storage.lease(snapshot.filepath)
        self._lease.__enter__()
        self._closed = False
        try:
            self.main_path = snapshot.filepath
            self.main_size = storage.file_size(snapshot.filepath)
            with contextlib.closing(storage.open_read(snapshot.filepath)) as f:
                reader = SnapshotReader(f)  # validates meta + table
            self.externals = [
                (sf, storage.external_path(snapshot.filepath, sf.filepath))
                for sf in reader.external_files
            ]
        except BaseException:
            self.close()
            raise

    def open_main(self):
        return self._storage.open_read(self.main_path)

    def open_external(self, path: str):
        return open(path, "rb")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lease.__exit__(None, None, None)


class _FileReceiveSink:
    """Incremental receiver: chunks land on disk as they arrive; the
    rename at finalize is the commit point."""

    def __init__(self, storage: "FileSnapshotStorage", final: str):
        self._storage = storage
        self._final = final
        self._tmp = storage._fresh_tmp(final)
        self._f = open(os.path.join(self._tmp, "snapshot.bin"), "wb")

    def write(self, data: bytes) -> None:
        self._f.write(data)

    def begin_external(self, name: str) -> None:
        base = os.path.basename(name)  # never trust wire paths
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = open(os.path.join(self._tmp, base), "wb")

    def validate(self) -> None:
        """Checksum-walk the received main container BEFORE finalize:
        a corrupted chunk that survived the wire must fail the receive
        (the sender retries) — finalizing it would fail-stop the
        replica at recover time instead.

        External files are stored VERBATIM with no per-file checksum
        (format parity with the reference), so only their SIZES can be
        cross-checked against the container's file table — truncated or
        padded external streams are rejected here, but a same-length
        bit flip in an external file is not detectable in this format.
        """
        from .snapshotio import SnapshotReader

        self._f.flush()
        with open(os.path.join(self._tmp, "snapshot.bin"), "rb") as f:
            reader = SnapshotReader(f)
            reader.validate()
        for sf in reader.external_files:
            p = os.path.join(self._tmp, os.path.basename(sf.filepath))
            got = os.path.getsize(p) if os.path.exists(p) else -1
            if got != sf.file_size:
                raise IOError(
                    f"external file {sf.filepath!r}: received {got} "
                    f"bytes, table says {sf.file_size}"
                )

    def finalize(self) -> str:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._storage._finalize(self._tmp, self._final)
        return os.path.join(self._final, "snapshot.bin")

    def abort(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass
        shutil.rmtree(self._tmp, ignore_errors=True)


class _MemReceiveSink:
    def __init__(self, storage: "InMemSnapshotStorage", key: str):
        self._storage = storage
        self._key = key
        self._main = io.BytesIO()
        self._cur = self._main
        self._ext_name: Optional[str] = None

    def write(self, data: bytes) -> None:
        self._cur.write(data)

    def begin_external(self, name: str) -> None:
        self._flush_ext()
        self._ext_name = os.path.basename(name)
        self._cur = io.BytesIO()

    def _flush_ext(self) -> None:
        if self._ext_name is not None:
            path = os.path.join(
                self._storage._ext_dir(self._key), self._ext_name
            )
            with open(path, "wb") as f:
                f.write(self._cur.getvalue())
            self._ext_name = None

    def validate(self) -> None:
        """Checksum-walk the received buffer when it IS a v2 container
        (trailer magic present) — same corrupt-chunk rejection as the
        file sink.  Transport-level tests stream raw non-container
        payloads through this sink; those skip validation."""
        import struct as _struct

        from .snapshotio import MAGIC, SnapshotReader

        buf = self._main.getvalue()
        # the format carries MAGIC in both header and trailer; either
        # one marks a container (a corrupt flip can kill at most one)
        is_container = len(buf) >= 8 and (
            _struct.unpack("<I", buf[:4])[0] == MAGIC
            or _struct.unpack("<I", buf[-4:])[0] == MAGIC
        )
        if not is_container:
            return  # raw payload (transport tests): nothing to checksum
        f = io.BytesIO(buf)
        SnapshotReader(f).validate()

    def finalize(self) -> str:
        self._flush_ext()
        with self._storage._lock:
            self._storage._store[self._key] = self._main.getvalue()
        return self._key

    def abort(self) -> None:
        pass


def _file_begin_receive(self, shard_id, replica_id, index, suffix=""):
    return _FileReceiveSink(self, self._dir(shard_id, replica_id, index, suffix))


def _mem_begin_receive(self, shard_id, replica_id, index, suffix=""):
    return _MemReceiveSink(self, self._key(shard_id, replica_id, index, suffix))


FileSnapshotStorage.begin_receive = _file_begin_receive
InMemSnapshotStorage.begin_receive = _mem_begin_receive
