"""Default cross-host transport: framed TCP.

reference: internal/transport/tcp.go [U] — framed protocol with magic +
kind + size + crc checks, separate lanes for message batches and
snapshot chunks, optional mutual TLS.

Each `get_connection` opens a dedicated socket (the Transport wrapper
above this keeps one connection per target per lane and owns queues,
batching and circuit breaking, exactly like the reference splits
transport.go from tcp.go).  Inbound: one accept loop, one reader thread
per peer socket; a malformed frame (bad magic / crc / overlong payload)
closes the connection — the peer's breaker and resend logic recover.
"""
from __future__ import annotations

import socket
import ssl
import struct
import threading
import zlib
from typing import Optional

from ..logger import get_logger
from ..pb import MASK64, Chunk, MessageBatch
from ..raftio import (
    ChunkHandler,
    IConnection,
    ISnapshotConnection,
    ITransport,
    MessageHandler,
)
from . import wire as wire_mod
from .wire import (
    KIND_BATCH,
    KIND_CHUNK,
    KIND_COMPRESSED,
    KIND_RESUME_QUERY,
    KIND_RESUME_RESP,
    MAGIC,
    MAX_PAYLOAD,
    WIRE_COMPRESS_THRESHOLD,
    WireError,
    decode_batch,
    decode_chunk,
    encode_batch,
    encode_chunk,
)

_log = get_logger("transport")

_header = struct.Struct("<IBII")  # magic, kind, length, crc


def parse_address(addr: str) -> tuple:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _write_frame(sock, kind: int, payload: bytes) -> None:
    if len(payload) > MAX_PAYLOAD:
        # fail locally: the receiver would reject the frame (raw) or the
        # decompressed payload (compressed) and tear the connection down,
        # and the raft layer would retry the same batch forever
        raise WireError(f"payload too large to send: {len(payload)}")
    kind, payload = wire_mod.maybe_compress(
        kind, payload, KIND_COMPRESSED, WIRE_COMPRESS_THRESHOLD
    )
    hdr = _header.pack(MAGIC, kind, len(payload), zlib.crc32(payload))
    sock.sendall(hdr + payload)


def _read_exactly(sock, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf.extend(part)
    return bytes(buf)


def _read_frame(sock) -> Optional[tuple]:
    hdr = _read_exactly(sock, _header.size)
    if hdr is None:
        return None
    magic, kind, length, crc = _header.unpack(hdr)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic:#x}")
    if length > MAX_PAYLOAD:
        raise WireError(f"frame too large: {length}")
    payload = _read_exactly(sock, length)
    if payload is None:
        return None
    if zlib.crc32(payload) != crc:
        raise WireError("crc mismatch")
    if kind & KIND_COMPRESSED:
        kind &= ~KIND_COMPRESSED
        payload = wire_mod.bounded_decompress(payload, MAX_PAYLOAD)
    return kind, payload


class _TCPConnection(IConnection):
    def __init__(self, sock, owner: "TCPTransport", target: str):
        self._sock = sock
        self._owner = owner
        self._target = target
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def send_message_batch(self, batch: MessageBatch) -> None:
        inj = self._owner.fault_injector
        if inj is None:
            batches = (batch,)
        else:
            # fault identity is the RAFT address (what plans target),
            # not the bind address — they differ under ListenAddress
            # overrides and port-0 binds
            src = self._owner.fault_source or self._owner.listen_address
            batches = inj.on_wire(src, self._target, batch)
        with self._lock:
            for b in batches:
                _write_frame(self._sock, KIND_BATCH, encode_batch(b))


class _TCPSnapshotConnection(ISnapshotConnection):
    def __init__(self, sock, owner: "TCPTransport", target: str):
        self._sock = sock
        self._owner = owner
        self._target = target
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def query_resume(self, probe: Chunk) -> int:
        """Resume-cursor exchange on the (otherwise write-only) snapshot
        socket: one KIND_RESUME_QUERY frame out, one KIND_RESUME_RESP
        frame back.  Any failure (old receiver closing on the unknown
        kind, timeout, torn connection) degrades to 0 — the sender
        restarts from chunk 0 and the receiver's idempotent re-delivery
        discards what it already holds."""
        try:
            with self._lock:
                _write_frame(
                    self._sock, KIND_RESUME_QUERY, encode_chunk(probe)
                )
                frame = _read_frame(self._sock)
            if frame is None:
                return 0
            kind, payload = frame
            if kind != KIND_RESUME_RESP or len(payload) != 8:
                return 0
            return struct.unpack("<Q", payload)[0]
        except (OSError, WireError, ValueError):
            return 0

    def send_chunk(self, chunk: Chunk) -> None:
        inj = self._owner.fault_injector
        if inj is None:
            chunks = (chunk,)
        else:
            src = self._owner.fault_source or self._owner.listen_address
            chunks = inj.on_wire(src, self._target, chunk)
        with self._lock:
            for c in chunks:
                _write_frame(self._sock, KIND_CHUNK, encode_chunk(c))
        if not chunks:
            # see the inproc chunk lane: a swallowed chunk must fail the
            # send, or the sender's raft peer wedges in SNAPSHOT state
            raise ConnectionError("nemesis: snapshot chunk lost")


class TCPTransport(ITransport):
    """reference: NewTCPTransport [U]."""

    def __init__(
        self,
        listen_address: str,
        message_handler: MessageHandler,
        chunk_handler: Optional[ChunkHandler] = None,
        *,
        ssl_server_ctx: Optional[ssl.SSLContext] = None,
        ssl_client_ctx: Optional[ssl.SSLContext] = None,
        connect_timeout: float = 5.0,
    ):
        self.listen_address = listen_address
        self.message_handler = message_handler
        self.chunk_handler = chunk_handler
        self._ssl_server_ctx = ssl_server_ctx
        self._ssl_client_ctx = ssl_client_ctx
        self._connect_timeout = connect_timeout
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads = []
        self._conn_lock = threading.Lock()
        self._inbound = set()
        # the unified fault plane, same contract as the in-proc
        # transport (faults.FaultController.on_wire)
        self.fault_injector = None
        # resume-cursor query target (ChunkSink.resume_cursor); set by
        # the NodeHost beside chunk_handler
        self.resume_handler = None

    def name(self) -> str:
        return "tcp"

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        host, port = parse_address(self.listen_address)
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host, port))
        ls.listen(128)
        ls.settimeout(0.2)
        self._listener = ls
        # the OS may have assigned an ephemeral port (tests use port 0)
        self.listen_address = f"{host}:{ls.getsockname()[1]}"
        t = threading.Thread(
            target=self._accept_main, daemon=True, name="tpu-raft-tcp-accept"
        )
        t.start()
        self._threads.append(t)

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conn_lock:
            for s in list(self._inbound):
                try:
                    s.close()
                except OSError:
                    pass
            self._inbound.clear()
        for t in self._threads:
            t.join(timeout=1.0)

    # -- outbound --------------------------------------------------------
    def _connect(self, target: str):
        host, port = parse_address(target)
        sock = socket.create_connection(
            (host, port), timeout=self._connect_timeout
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(30.0)
        if self._ssl_client_ctx is not None:
            sock = self._ssl_client_ctx.wrap_socket(sock, server_hostname=host)
        return sock

    def get_connection(self, target: str) -> IConnection:
        return _TCPConnection(self._connect(target), self, target)

    def get_snapshot_connection(self, target: str) -> ISnapshotConnection:
        return _TCPSnapshotConnection(self._connect(target), self, target)

    # -- inbound ---------------------------------------------------------
    def _accept_main(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._ssl_server_ctx is not None:
                try:
                    sock = self._ssl_server_ctx.wrap_socket(
                        sock, server_side=True
                    )
                except (ssl.SSLError, OSError) as e:
                    _log.warning("tls handshake failed: %s", e)
                    try:
                        sock.close()  # else each failed handshake leaks a fd
                    except OSError:
                        pass
                    continue
            with self._conn_lock:
                self._inbound.add(sock)
            t = threading.Thread(
                target=self._reader_main,
                args=(sock,),
                daemon=True,
                name="tpu-raft-tcp-reader",
            )
            t.start()

    def _reader_main(self, sock) -> None:
        try:
            while not self._stop.is_set():
                frame = _read_frame(sock)
                if frame is None:
                    return
                kind, payload = frame
                if kind == KIND_BATCH:
                    self.message_handler(decode_batch(payload))
                elif kind == KIND_CHUNK:
                    if self.chunk_handler is not None and not self.chunk_handler(
                        decode_chunk(payload)
                    ):
                        # rejected chunk (out-of-order / failed receive):
                        # tear the connection down so the sending stream
                        # job fails fast and retries/reports, instead of
                        # pumping the rest of a doomed stream
                        raise WireError("chunk rejected by receiver")
                elif kind == KIND_RESUME_QUERY:
                    cursor = 0
                    if self.resume_handler is not None:
                        cursor = self.resume_handler(decode_chunk(payload))
                    _write_frame(
                        sock, KIND_RESUME_RESP,
                        struct.pack("<Q", cursor & MASK64),
                    )
                else:
                    raise WireError(f"unknown frame kind {kind}")
        except (WireError, ValueError) as e:
            _log.warning("closing connection on bad frame: %s", e)
        except OSError:
            pass
        finally:
            with self._conn_lock:
                self._inbound.discard(sock)
            try:
                sock.close()
            except OSError:
                pass


def tcp_transport_factory(config, message_handler, chunk_handler):
    """NodeHostConfig.expert.transport_factory hook.

    `config.raft_address` must be "host:port"; `listen_address`
    overrides the bind address (reference: NodeHostConfig
    ListenAddress [U]).  With `mutual_tls`, `ca_file`/`cert_file`/
    `key_file` configure both peers' contexts.
    """
    server_ctx = client_ctx = None
    if getattr(config, "mutual_tls", False):
        server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        server_ctx.verify_mode = ssl.CERT_REQUIRED
        server_ctx.load_cert_chain(config.cert_file, config.key_file)
        server_ctx.load_verify_locations(config.ca_file)
        client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        client_ctx.load_cert_chain(config.cert_file, config.key_file)
        client_ctx.load_verify_locations(config.ca_file)
        client_ctx.check_hostname = False
    return TCPTransport(
        config.get_listen_address(),
        message_handler,
        chunk_handler,
        ssl_server_ctx=server_ctx,
        ssl_client_ctx=client_ctx,
    )
