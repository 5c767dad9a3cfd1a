"""Native runtime components (C++, loaded via ctypes).

The only native piece this architecture needs (SURVEY.md §2: the
reference is pure Go, so there is no component list to mirror — native
code exists where OUR runtime benefits): ``walwriter`` — a group-commit
WAL appender whose write+fsync runs on a dedicated native thread with
the GIL released, coalescing concurrent workers' batches into single
fsyncs.

The shared library is compiled on first use with g++ (cached next to
the source); every consumer must handle ``load_walwriter()`` returning
None and fall back to the pure-Python path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

from ..logger import get_logger

_log = get_logger("native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "walwriter.cpp")
_LIB = os.path.join(_HERE, "libwalwriter.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    # compile to a per-process temp path and rename: concurrent builders
    # (two processes constructing TanLogDB) must never load a
    # half-written .so
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        _log.warning("native walwriter build failed to run: %s", e)
        return False
    if proc.returncode != 0:
        _log.warning("native walwriter build failed:\n%s", proc.stderr)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    os.replace(tmp, _LIB)
    return True


def load_walwriter() -> Optional[ctypes.CDLL]:
    """The walwriter library, building it on first use; None on failure."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _build():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            _log.warning("native walwriter load failed: %s", e)
            _load_failed = True
            return None
        lib.wal_open.argtypes = [ctypes.c_char_p]
        lib.wal_open.restype = ctypes.c_void_p
        lib.wal_append.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.wal_append.restype = ctypes.c_int64
        lib.wal_size.argtypes = [ctypes.c_void_p]
        lib.wal_size.restype = ctypes.c_int64
        lib.wal_sync.argtypes = [ctypes.c_void_p]
        lib.wal_sync.restype = ctypes.c_int32
        lib.wal_close.argtypes = [ctypes.c_void_p]
        lib.wal_close.restype = ctypes.c_int32
        _lib = lib
        return _lib


class NativeWalWriter:
    """ctypes handle over one WAL segment file (append-only).

    ``append(data, sync=True)`` returns the total appended bytes once
    the data is durable (group-committed with concurrent appenders).
    """

    def __init__(self, path: str):
        lib = load_walwriter()
        if lib is None:
            raise OSError("native walwriter unavailable")
        self._lib = lib
        self._h = lib.wal_open(path.encode("utf-8"))
        if not self._h:
            raise OSError(f"wal_open failed: {path}")

    def append(self, data: bytes, sync: bool = True) -> int:
        if not self._h:
            raise OSError("walwriter is closed")
        if not data:  # zero-length appends must not consume a ticket
            return self.size()
        n = self._lib.wal_append(self._h, data, len(data), int(sync))
        if n < 0:
            raise OSError("wal_append I/O error")
        return n

    def size(self) -> int:
        if not self._h:
            raise OSError("walwriter is closed")
        return self._lib.wal_size(self._h)

    def sync(self) -> None:
        if not self._h:
            raise OSError("walwriter is closed")
        if self._lib.wal_sync(self._h) != 0:
            raise OSError("wal_sync I/O error")

    def close(self) -> None:
        if self._h:
            rc = self._lib.wal_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError("wal_close I/O error")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
