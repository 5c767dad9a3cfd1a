"""Shared crc-framed journal segment scanner.

Both durable backends (the tan WAL and the KV store's journal) append
``<kind u8 | length u32 | crc u32 | body>`` records to numbered segment
files and replay them at open with the SAME crash rules:

  * a torn header/body at the tail of the LAST segment is the crash
    point — truncate it off durably and stop (leaving it would make the
    next open treat this segment as non-last and refuse);
  * a bad crc is accepted as a tear only when it is the FINAL record of
    the last segment; anywhere else it is corruption;
  * any structural error inside a record body is corruption.

This is subtle crash-recovery logic; keeping one copy means a fix
reaches every backend (extracted after the power-loss fuzz shook out
backend-specific copies).
"""
from __future__ import annotations

import struct
import zlib
from typing import Callable

REC_HEADER = struct.Struct("<BII")  # kind, length, crc


class CorruptJournalError(Exception):
    """Mid-journal corruption (not a clean torn tail)."""


def frame_record(kind: int, body: bytes) -> bytes:
    return REC_HEADER.pack(kind, len(body), zlib.crc32(body)) + body


def scan_segment(
    fs,
    path: str,
    directory: str,
    torn_ok: bool,
    apply: Callable[[int, bytes], None],
    error_cls=CorruptJournalError,
) -> None:
    """Replay one segment through ``apply(kind, body)``; repairs a torn
    tail (truncate + dir sync) when ``torn_ok``."""
    data = fs.read_file(path)
    pos, n = 0, len(data)
    while pos < n:
        if pos + REC_HEADER.size > n:
            if torn_ok:
                return _truncate_tail(fs, path, directory, pos)
            raise error_cls(f"{path}: torn header at {pos}")
        kind, length, crc = REC_HEADER.unpack_from(data, pos)
        body_at = pos + REC_HEADER.size
        if body_at + length > n:
            if torn_ok:
                return _truncate_tail(fs, path, directory, pos)
            raise error_cls(f"{path}: torn body at {pos}")
        body = data[body_at : body_at + length]
        if zlib.crc32(body) != crc:
            if torn_ok and body_at + length == n:
                return _truncate_tail(fs, path, directory, pos)
            raise error_cls(f"{path}: bad crc at {pos}")
        try:
            apply(kind, body)
        except error_cls:
            raise
        except Exception as e:  # noqa: BLE001 - any decode failure
            raise error_cls(f"{path}: bad record at {pos}: {e}")
        pos = body_at + length


def _truncate_tail(fs, path: str, directory: str, pos: int) -> None:
    """Cut torn bytes off a crash tail, durably."""
    fs.truncate(path, pos)
    fs.sync_dir(directory)
