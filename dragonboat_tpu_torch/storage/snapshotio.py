"""Versioned, block-checksummed snapshot container (format v2).

reference: internal/rsm/snapshotio.go — SnapshotWriter/Reader with a
versioned header and the v2 block-CRC payload format [U].

Layout (little-endian):

    magic        u32  0x44425353 ("DBSS")
    version      u8   2
    compression  u8   CompressionType for sm-data blocks
    reserved     u16
    block_size   u32
    meta blob    [len u32 | crc u32 | bytes]   encode_rsm_snapshot(sm_data=None)
    sm blocks    repeated [stored_len u32 | crc u32 | flags u8 | bytes]
    sentinel     stored_len u32 == 0
    table blob   [len u32 | crc u32 | bytes]   external-file table
    trailer      sm_size u64 | table_off u64 | trailer_crc u32 | magic u32

Every section carries its own CRC, so corruption is DETECTED AND
LOCALIZED (bad meta vs bad block #k vs bad table), and the sm payload
streams through bounded memory in both directions: the writer buffers
one block, the reader verifies and yields one block at a time.
Compression is per block (flags bit0 = zlib, bit1 = snappy), so a
streamed save never materializes the whole payload either way.
"""
from __future__ import annotations

import struct
import zlib
from io import BytesIO
from typing import BinaryIO, List, Optional

from ..pb import MASK64, CompressionType, Membership, SnapshotFile
from ..transport.wire import (
    WireError,
    _R,
    _wb,
    _ws,
    _wu32,
    _wu64,
    _wu8,
    encode_rsm_snapshot,
    decode_rsm_snapshot,
)

MAGIC = 0x44425353
VERSION = 2
DEFAULT_BLOCK_SIZE = 1024 * 1024
MAX_BLOCK_SIZE = 64 * 1024 * 1024

BF_ZLIB = 1
BF_SNAPPY = 2

_u32 = struct.Struct("<I")
_trailer = struct.Struct("<QQII")  # sm_size, table_off, crc, magic


class SnapshotCorruptError(Exception):
    """Checksum/format failure, localized to a section."""


def _try_snappy():
    try:
        import snappy  # type: ignore

        return snappy
    except Exception:  # pragma: no cover - optional dependency
        return None


class SnapshotWriter:
    """Streaming container writer; file-like for the user SM's data.

    The SM writes through ``write`` (bounded buffering: one block);
    external files are registered with ``add_external_file``; ``close``
    finalizes sentinel + table + trailer.  The caller owns fsync.
    """

    def __init__(
        self,
        f: BinaryIO,
        *,
        index: int,
        term: int,
        membership: Membership,
        sessions: bytes,
        on_disk: bool,
        compression: int = int(CompressionType.NO_COMPRESSION),
        block_size: int = DEFAULT_BLOCK_SIZE,
    ):
        if not (0 < block_size <= MAX_BLOCK_SIZE):
            raise ValueError(f"bad block_size {block_size}")
        self._f = f
        self._block_size = block_size
        self._compression = int(compression)
        self._snappy = None
        if self._compression == int(CompressionType.SNAPPY):
            self._snappy = _try_snappy()
            if self._snappy is None:  # graceful degrade, like the wire path
                self._compression = int(CompressionType.ZLIB)
        self._buf = bytearray()
        self._sm_size = 0  # uncompressed sm-data bytes written
        self._files: List[SnapshotFile] = []
        self._closed = False
        f.write(struct.pack("<IBBH", MAGIC, VERSION, self._compression, 0))
        f.write(_u32.pack(block_size))
        meta = encode_rsm_snapshot(
            index=index,
            term=term,
            membership=membership,
            sessions=sessions,
            sm_data=None,
            on_disk=on_disk,
        )
        if len(meta) > MAX_BLOCK_SIZE:
            # the reader rejects oversized sections as corrupt; writing
            # one would produce an acked snapshot that can never be read
            # back (same bug class as the WAL compression bound)
            raise ValueError(
                f"snapshot meta section too large: {len(meta)} bytes "
                f"(sessions table?) > {MAX_BLOCK_SIZE}"
            )
        f.write(_u32.pack(len(meta)))
        f.write(_u32.pack(zlib.crc32(meta)))
        f.write(meta)
        self._pos = f.tell()

    # -- BinaryIO surface for the SM -----------------------------------
    def write(self, data) -> int:
        if self._closed:
            raise ValueError("writer is closed")
        self._buf += data
        while len(self._buf) >= self._block_size:
            self._emit_block(bytes(self._buf[: self._block_size]))
            del self._buf[: self._block_size]
        return len(data)

    def flush(self) -> None:  # SMs may call it; blocks flush on close
        pass

    def add_external_file(self, sf: SnapshotFile) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        self._files.append(sf)

    @property
    def external_files(self) -> List[SnapshotFile]:
        return list(self._files)

    def _emit_block(self, raw: bytes) -> None:
        self._sm_size += len(raw)
        flags = 0
        body = raw
        if self._compression == int(CompressionType.ZLIB):
            z = zlib.compress(raw, 3)
            if len(z) < len(raw):
                flags, body = BF_ZLIB, z
        elif self._compression == int(CompressionType.SNAPPY):
            z = self._snappy.compress(raw)
            if len(z) < len(raw):
                flags, body = BF_SNAPPY, z
        self._f.write(_u32.pack(len(body)))
        self._f.write(_u32.pack(zlib.crc32(body)))
        self._f.write(struct.pack("<B", flags))
        self._f.write(body)

    def close(self) -> int:
        """Finalize; returns total container size in bytes."""
        if self._closed:
            raise ValueError("writer already closed")
        if self._buf:
            self._emit_block(bytes(self._buf))
            self._buf = bytearray()
        self._closed = True
        f = self._f
        f.write(_u32.pack(0))  # sentinel
        table_off = f.tell()
        b = BytesIO()
        _wu32(b, len(self._files))
        for sf in self._files:
            _wu64(b, sf.file_id)
            _ws(b, sf.filepath)
            _wu64(b, sf.file_size)
            _wb(b, sf.metadata)
        table = b.getvalue()
        if len(table) > MAX_BLOCK_SIZE:
            raise ValueError(
                f"external-file table too large: {len(table)} bytes"
            )
        f.write(_u32.pack(len(table)))
        f.write(_u32.pack(zlib.crc32(table)))
        f.write(table)
        head = struct.pack("<QQ", self._sm_size & MASK64, table_off & MASK64)
        f.write(head)
        f.write(_u32.pack(zlib.crc32(head)))
        f.write(_u32.pack(MAGIC))
        return f.tell()


class _SMStream:
    """Verified file-like view of the sm-data blocks."""

    def __init__(self, f: BinaryIO, start: int, snappy):
        self._f = f
        self._snappy = snappy
        self._pending = b""
        self._done = False
        self._block = 0
        f.seek(start)

    def read(self, n: int = -1) -> bytes:
        want = None if n is None or n < 0 else n
        chunks = [self._pending]
        have = len(self._pending)
        self._pending = b""
        while not self._done and (want is None or have < want):
            blk = self._next_block()
            if blk is None:
                self._done = True
                break
            chunks.append(blk)
            have += len(blk)
        data = b"".join(chunks)
        if want is not None and len(data) > want:
            data, self._pending = data[:want], data[want:]
        return data

    def _next_block(self) -> Optional[bytes]:
        hdr = self._f.read(4)
        if len(hdr) != 4:
            raise SnapshotCorruptError(
                f"truncated block header after block {self._block}"
            )
        (ln,) = _u32.unpack(hdr)
        if ln == 0:
            return None  # sentinel
        if ln > MAX_BLOCK_SIZE:
            raise SnapshotCorruptError(
                f"block {self._block}: absurd length {ln}"
            )
        rest = self._f.read(5 + ln)
        if len(rest) != 5 + ln:
            raise SnapshotCorruptError(f"block {self._block}: truncated body")
        (crc,) = _u32.unpack(rest[:4])
        flags = rest[4]
        body = rest[5:]
        if zlib.crc32(body) != crc:
            raise SnapshotCorruptError(
                f"block {self._block}: checksum mismatch"
            )
        if flags & BF_ZLIB:
            # bounded: a forged block must not expand past what a
            # legitimate writer could ever have produced (zip bomb)
            d = zlib.decompressobj()
            try:
                body = d.decompress(body, MAX_BLOCK_SIZE + 1)
            except zlib.error as e:
                raise SnapshotCorruptError(
                    f"block {self._block}: bad zlib stream: {e}"
                )
            if d.unconsumed_tail or len(body) > MAX_BLOCK_SIZE:
                raise SnapshotCorruptError(
                    f"block {self._block}: decompressed block exceeds "
                    f"{MAX_BLOCK_SIZE} bytes"
                )
        elif flags & BF_SNAPPY:
            if self._snappy is None:
                raise SnapshotCorruptError(
                    f"block {self._block}: snappy-compressed but snappy "
                    "is unavailable"
                )
            try:
                body = self._snappy.decompress(body)
            except Exception as e:
                raise SnapshotCorruptError(
                    f"block {self._block}: bad snappy stream: {e!r}"
                )
            if len(body) > MAX_BLOCK_SIZE:
                raise SnapshotCorruptError(
                    f"block {self._block}: decompressed block exceeds "
                    f"{MAX_BLOCK_SIZE} bytes"
                )
        self._block += 1
        return body


class SnapshotReader:
    """Container reader over a seekable binary file."""

    def __init__(self, f: BinaryIO):
        self._f = f
        hdr = f.read(12)
        if len(hdr) != 12:
            raise SnapshotCorruptError("truncated header")
        magic, version, compression, _ = struct.unpack("<IBBH", hdr[:8])
        (block_size,) = _u32.unpack(hdr[8:12])
        if magic != MAGIC:
            raise SnapshotCorruptError(f"bad magic {magic:#x}")
        if version != VERSION:
            raise SnapshotCorruptError(f"unsupported version {version}")
        self.compression = compression
        self.block_size = block_size
        mh = f.read(8)
        if len(mh) != 8:
            raise SnapshotCorruptError("truncated meta header")
        mlen, mcrc = struct.unpack("<II", mh)
        if mlen > MAX_BLOCK_SIZE:
            raise SnapshotCorruptError(f"absurd meta length {mlen}")
        meta = f.read(mlen)
        if len(meta) != mlen or zlib.crc32(meta) != mcrc:
            raise SnapshotCorruptError("meta section corrupt")
        try:
            d = decode_rsm_snapshot(meta)
        except (WireError, ValueError) as e:
            raise SnapshotCorruptError(f"meta decode: {e}")
        self.index = d["index"]
        self.term = d["term"]
        self.membership: Membership = d["membership"]
        self.sessions: bytes = d["sessions"]
        self.on_disk: bool = d["on_disk"]
        self._sm_start = f.tell()
        # trailer
        f.seek(0, 2)
        end = f.tell()
        if end < self._sm_start + 4 + _trailer.size:
            raise SnapshotCorruptError("truncated trailer")
        f.seek(end - _trailer.size)
        sm_size, table_off, tcrc, tmagic = _trailer.unpack(
            f.read(_trailer.size)
        )
        head = struct.pack("<QQ", sm_size & MASK64, table_off & MASK64)
        if tmagic != MAGIC or zlib.crc32(head) != tcrc:
            raise SnapshotCorruptError("trailer corrupt")
        self.sm_size = sm_size
        # external-file table
        f.seek(table_off)
        th = f.read(8)
        if len(th) != 8:
            raise SnapshotCorruptError("truncated table header")
        tlen, tbcrc = struct.unpack("<II", th)
        if tlen > MAX_BLOCK_SIZE:
            raise SnapshotCorruptError(f"absurd table length {tlen}")
        table = f.read(tlen)
        if len(table) != tlen or zlib.crc32(table) != tbcrc:
            raise SnapshotCorruptError("external-file table corrupt")
        r = _R(table)
        try:
            self.external_files: List[SnapshotFile] = [
                SnapshotFile(
                    file_id=r.u64(),
                    filepath=r.s(),
                    file_size=r.u64(),
                    metadata=r.blob(),
                )
                for _ in range(r.count())
            ]
        except (WireError, ValueError) as e:
            raise SnapshotCorruptError(f"table decode: {e}")
        self._snappy = _try_snappy()

    def sm_stream(self) -> _SMStream:
        return _SMStream(self._f, self._sm_start, self._snappy)

    def validate(self) -> int:
        """Walk every sm block, verifying checksums; returns sm byte
        size.  Localizes corruption to a block via the raised error."""
        s = self.sm_stream()
        total = 0
        while True:
            chunk = s.read(1 << 20)
            if not chunk:
                break
            total += len(chunk)
        if total != self.sm_size:
            raise SnapshotCorruptError(
                f"sm size mismatch: trailer says {self.sm_size}, "
                f"blocks held {total}"
            )
        return total
