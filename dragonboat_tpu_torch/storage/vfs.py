"""Filesystem abstraction with a power-loss-faithful in-memory impl.

reference: internal/vfs (pebble vfs wrapper) [U] — the reference runs
its storage tests against ``MemFS`` in *strict* mode, where nothing
survives a simulated crash unless it was explicitly fsynced (file data)
or the parent directory was fsynced (namespace operations: create,
rename, unlink).  That discipline is where WAL bugs hide; this module
reproduces it for the tan WAL and the snapshotter.

Two implementations:

* ``OSVFS`` — thin wrappers over ``os`` (production).
* ``StrictMemFS`` — in-memory with ``crash()``: every file reverts to
  its last-synced content **plus a random prefix of its unsynced tail**
  (a torn write), and every namespace change since the last
  ``sync_dir`` is rolled back.  An optional ``fault_hook`` fires before
  each data-touching operation so tests can inject I/O errors at exact
  fsync boundaries.
"""
from __future__ import annotations

import os
import random
import threading
from typing import Callable, Dict, List, Optional, Tuple


class IVFSFile:
    """Append-oriented file handle."""

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def tell(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class IVFS:
    """The minimal FS surface the storage layer needs."""

    def open_append(self, path: str) -> IVFSFile:
        raise NotImplementedError

    def read_file(self, path: str) -> bytes:
        raise NotImplementedError

    def open_read(self, path: str):
        """Seekable read handle for INCREMENTAL consumption (the
        big-state plane reads checkpoints/WALs in bounded slices;
        ``read_file`` stays for small whole-blob reads)."""
        raise NotImplementedError

    def write_file_chunks(self, path: str, chunks) -> None:
        """Create/overwrite ``path`` from an iterable of byte chunks,
        fsync the file (NOT the directory — callers own namespace
        durability via sync_dir/rename)."""
        raise NotImplementedError

    def truncate(self, path: str, size: int) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def unlink(self, path: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        raise NotImplementedError

    def sync_dir(self, path: str) -> None:
        raise NotImplementedError

    def stat_size(self, path: str) -> int:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# OS implementation
# ---------------------------------------------------------------------------
class _OSFile(IVFSFile):
    __slots__ = ("_f",)

    def __init__(self, f):
        self._f = f

    def write(self, data: bytes) -> None:
        self._f.write(data)

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()


class OSVFS(IVFS):
    def open_append(self, path: str) -> IVFSFile:
        return _OSFile(open(path, "ab"))

    def read_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def open_read(self, path: str):
        return open(path, "rb")

    def write_file_chunks(self, path: str, chunks) -> None:
        with open(path, "wb") as f:
            for c in chunks:
                f.write(c)
            f.flush()
            os.fsync(f.fileno())

    def truncate(self, path: str, size: int) -> None:
        with open(path, "r+b") as f:
            f.truncate(size)
            f.flush()
            os.fsync(f.fileno())

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        return os.listdir(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def unlink(self, path: str) -> None:
        os.unlink(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def sync_dir(self, path: str) -> None:
        dfd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def stat_size(self, path: str) -> int:
        return os.stat(path).st_size


DEFAULT = OSVFS()


# ---------------------------------------------------------------------------
# strict in-memory implementation
# ---------------------------------------------------------------------------
class _MemNode:
    """One file: synced prefix + unsynced pending tail."""

    __slots__ = ("synced", "pending")

    def __init__(self, synced: bytes = b"", pending: bytes = b""):
        self.synced = synced
        self.pending = pending

    @property
    def data(self) -> bytes:
        return self.synced + self.pending


class _MemFile(IVFSFile):
    def __init__(self, fs: "StrictMemFS", path: str):
        self._fs = fs
        self._path = path
        self._closed = False

    def write(self, data: bytes) -> None:
        try:
            self._fs._hook("write", self._path)
        except Exception as e:
            # nemesis torn write: persist the prefix the fault allows,
            # then fail — replay code must cope with the partial tail
            keep = getattr(e, "keep", None)
            if keep is not None and data:
                with self._fs._lock:
                    self._fs._node(self._path).pending += data[
                        : int(len(data) * float(keep))
                    ]
            raise
        with self._fs._lock:
            self._fs._node(self._path).pending += data

    def sync(self) -> None:
        self._fs._hook("sync", self._path)
        with self._fs._lock:
            n = self._fs._node(self._path)
            n.synced, n.pending = n.synced + n.pending, b""

    def tell(self) -> int:
        with self._fs._lock:
            return len(self._fs._node(self._path).data)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.sync()


class StrictMemFS(IVFS):
    """Strict-durability in-memory FS for crash tests.

    Namespace model: each directory tracks its *synced* entry map and
    its *current* entry map.  create/rename/unlink mutate the current
    map only; ``sync_dir`` commits it.  ``crash(rng)`` rolls every
    directory back to its synced map and every file back to its synced
    bytes plus a RANDOM PREFIX of the pending tail (torn final write).
    """

    def __init__(self):
        self._lock = threading.RLock()
        # path -> _MemNode for every file that exists in the CURRENT view
        self._files: Dict[str, _MemNode] = {}
        # dir -> {name: node} synced snapshot of the namespace
        self._synced_dirs: Dict[str, Dict[str, _MemNode]] = {}
        self._dirs: set = set()
        self.fault_hook: Optional[Callable[[str, str], None]] = None
        # the unified fault plane (faults.FaultController via a bound
        # adapter); fault_hook stays for bespoke test callbacks
        self.fault_injector = None
        self.crashes = 0

    # -- internals -------------------------------------------------------
    def _hook(self, op: str, path: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(op, path)
        if self.fault_injector is not None:
            self.fault_injector.on_fs_op(op, path)

    def _node(self, path: str) -> _MemNode:
        n = self._files.get(path)
        if n is None:
            raise FileNotFoundError(path)
        return n

    def _dir_of(self, path: str) -> str:
        return os.path.dirname(path)

    def _check_dir(self, d: str) -> None:
        if d not in self._dirs:
            raise FileNotFoundError(f"no such directory: {d}")

    # -- IVFS ------------------------------------------------------------
    def open_append(self, path: str) -> IVFSFile:
        with self._lock:
            self._check_dir(self._dir_of(path))
            if path not in self._files:
                self._hook("create", path)
                self._files[path] = _MemNode()
            return _MemFile(self, path)

    def read_file(self, path: str) -> bytes:
        with self._lock:
            return self._node(path).data

    def open_read(self, path: str):
        import io

        with self._lock:
            return io.BytesIO(self._node(path).data)

    def write_file_chunks(self, path: str, chunks) -> None:
        with self._lock:
            self._check_dir(self._dir_of(path))
            self._hook("create", path)
            node = _MemNode()
            self._files[path] = node
        for c in chunks:
            self._hook("write", path)
            with self._lock:
                node.pending += bytes(c)
        self._hook("sync", path)
        with self._lock:
            node.synced, node.pending = node.synced + node.pending, b""

    def truncate(self, path: str, size: int) -> None:
        self._hook("truncate", path)
        with self._lock:
            n = self._node(path)
            # a synced truncate is durable (used for torn-tail repair)
            n.synced, n.pending = n.data[:size], b""

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._files or path in self._dirs

    def listdir(self, path: str) -> List[str]:
        with self._lock:
            self._check_dir(path)
            pre = path.rstrip("/") + "/"
            names = set()
            for p in self._files:
                if p.startswith(pre) and "/" not in p[len(pre):]:
                    names.add(p[len(pre):])
            for d in self._dirs:
                if d.startswith(pre) and "/" not in d[len(pre):]:
                    names.add(d[len(pre):])
            return sorted(names)

    def makedirs(self, path: str) -> None:
        with self._lock:
            p = path.rstrip("/")
            parts = p.split("/")
            for i in range(1, len(parts) + 1):
                d = "/".join(parts[:i])
                if d and d not in self._dirs:
                    self._dirs.add(d)
                    self._synced_dirs.setdefault(d, {})
            # creating directories is treated as durable (mkdir+parent
            # sync happens once at startup; not the interesting case)

    def unlink(self, path: str) -> None:
        self._hook("unlink", path)
        with self._lock:
            self._node(path)
            del self._files[path]

    def rename(self, src: str, dst: str) -> None:
        self._hook("rename", src)
        with self._lock:
            n = self._node(src)
            del self._files[src]
            self._files[dst] = n

    def sync_dir(self, path: str) -> None:
        self._hook("sync_dir", path)
        with self._lock:
            self._check_dir(path)
            pre = path.rstrip("/") + "/"
            snap = {}
            for p, n in self._files.items():
                if p.startswith(pre) and "/" not in p[len(pre):]:
                    snap[p[len(pre):]] = n
            self._synced_dirs[path.rstrip("/")] = snap

    def stat_size(self, path: str) -> int:
        with self._lock:
            return len(self._node(path).data)

    # -- crash simulation ------------------------------------------------
    def crash(self, rng: Optional[random.Random] = None) -> None:
        """Simulated power loss: unsynced data and namespace ops vanish.

        Every file keeps its synced bytes plus a random prefix of its
        pending tail (the torn write the WAL replay must cope with).
        Every directory reverts to its last-synced entry map, EXCEPT
        that a file created since the dir sync MAY survive (metadata
        journaling on real filesystems makes both outcomes possible) —
        rng decides.
        """
        rng = rng or random.Random()
        with self._lock:
            self.crashes += 1
            # tear file tails
            for n in set(self._files.values()) | {
                x for d in self._synced_dirs.values() for x in d.values()
            }:
                if n.pending:
                    keep = rng.randrange(0, len(n.pending) + 1)
                    n.synced += n.pending[:keep]
                n.pending = b""
            # roll namespaces back
            new_files: Dict[str, _MemNode] = {}
            claimed = set()
            for d, snap in self._synced_dirs.items():
                for name, node in snap.items():
                    new_files[f"{d}/{name}"] = node
                    claimed.add(id(node))
            # unsynced creates: each may survive (journaled metadata)
            for p, n in self._files.items():
                if p not in new_files and id(n) not in claimed:
                    if rng.random() < 0.5:
                        new_files[p] = n
            self._files = new_files
            # the post-crash view is what's durable now
            for d in self._synced_dirs:
                self.sync_dir(d)
