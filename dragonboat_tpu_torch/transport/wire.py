"""Binary wire codec for the TCP transport.

reference: the reference serializes raftpb protobufs onto a framed TCP
stream (internal/transport/tcp.go [U]).  This codec is a hand-rolled
positional binary format (length-prefixed, little-endian, crc-framed by
the transport) rather than pickle: wire input is untrusted and must
never be able to execute code or allocate unboundedly on decode.

Frame layout (transport level, see tcp.py):
    magic  u32  = 0x54524654 ("TRFT")
    kind   u8   (1 = MessageBatch, 2 = Chunk; the 0x80 bit flags a
                 zlib-compressed payload — crc/length cover the bytes
                 as sent, i.e. the compressed form)
    length u32  payload byte length
    crc    u32  zlib.crc32 of payload
    payload
"""
from __future__ import annotations

import struct
import zlib
from io import BytesIO
from typing import Tuple

from ..pb import (
    Chunk,
    CompressionType,
    ConfigChange,
    ConfigChangeType,
    Entry,
    EntryType,
    MASK64,
    MESSAGE_BATCH_BIN_VER,
    Membership,
    Message,
    MessageBatch,
    MessageType,
    Snapshot,
    SnapshotFile,
)

MAGIC = 0x54524654
KIND_BATCH = 1
KIND_CHUNK = 2
# resumable snapshot streams (docs/BIGSTATE.md): a reconnecting sender
# asks the receiver for its receive cursor before re-streaming.  The
# query payload is an encoded data-less Chunk carrying the stream
# identity; the response is one little-endian u64 (the next chunk
# offset the receiver needs, 0 = restart).  Unknown kinds close the
# connection on OLD receivers, which the sender treats as cursor 0 —
# rolling upgrades degrade to restart-from-zero, never to corruption.
KIND_RESUME_QUERY = 3
KIND_RESUME_RESP = 4
# gateway RPC ingress (gateway/rpc.py, docs/GATEWAY.md "Networked
# ingress"): one request frame out, one response frame back, multiplexed
# by request id over a long-lived client connection.  Same CRC framing
# and the same versioned-payload discipline as KIND_BATCH (RPC_BIN_VER
# below); unknown kinds still close the connection on OLD receivers, so
# a client probing a pre-RPC node degrades to a torn connection its
# breaker absorbs — never to misparsed frames.
KIND_RPC_REQ = 5
KIND_RPC_RESP = 6
# frame-kind flag: payload is zlib-compressed (wire entry compression —
# reference: EntryCompression on replicated batches [U]; ours is adaptive)
KIND_COMPRESSED = 0x80
WIRE_COMPRESS_THRESHOLD = 1024

# decode-side sanity bounds (wire input is untrusted)
MAX_PAYLOAD = 256 * 1024 * 1024
MAX_ITEMS = 1 << 20

# all protocol integers are uint64, like the reference's raftpb (session
# series ids use the top of the range, e.g. SERIES_ID_REGISTER)
_u64 = struct.Struct("<Q")
_u32 = struct.Struct("<I")
_u8 = struct.Struct("<B")


class WireError(Exception):
    """Malformed or out-of-bounds wire data."""


def maybe_compress(
    kind: int,
    payload: bytes,
    flag: int,
    threshold: int,
    max_out: int = MAX_PAYLOAD,
):
    """Adaptive compression shared by the TCP framing and the tan WAL:
    payloads over ``threshold`` that actually shrink get ``flag`` OR'd
    into the kind byte (reference: EntryCompression [U]).

    Never compresses past ``max_out``, the decode side's
    bounded_decompress limit — a compressed payload that inflates beyond
    it would encode fine and then fail on every decode."""
    if threshold <= len(payload) <= max_out:
        z = zlib.compress(payload, 1)  # speed level: hot paths
        if len(z) < len(payload):
            return kind | flag, z
    return kind, payload


def bounded_decompress(payload: bytes, max_out: int) -> bytes:
    """Strict inverse of maybe_compress's compressed arm: bounded
    allocation (zlib-bomb safe) and no trailing bytes tolerated."""
    try:
        d = zlib.decompressobj()
        out = d.decompress(payload, max_out + 1)
    except zlib.error as e:
        raise WireError(f"bad compressed payload: {e}")
    if len(out) > max_out or not d.eof:
        raise WireError("decompressed payload too large")
    if d.unused_data:
        raise WireError("trailing bytes after compressed payload")
    return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def _wu64(b: BytesIO, v: int) -> None:
    # mask, don't raise: uint64 wraparound parity (pb.MASK64 policy)
    b.write(_u64.pack(v & MASK64))


def _wu32(b: BytesIO, v: int) -> None:
    b.write(_u32.pack(v))


def _wu8(b: BytesIO, v: int) -> None:
    b.write(_u8.pack(v))


def _wb(b: BytesIO, v: bytes) -> None:
    _wu32(b, len(v))
    b.write(v)


def _ws(b: BytesIO, v: str) -> None:
    _wb(b, v.encode("utf-8"))


class _R:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise WireError(f"short read: want {n} at {self.pos}")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u64(self) -> int:
        return _u64.unpack(self.take(8))[0]

    def u32(self) -> int:
        return _u32.unpack(self.take(4))[0]

    def u8(self) -> int:
        return _u8.unpack(self.take(1))[0]

    def blob(self) -> bytes:
        n = self.u32()
        if n > MAX_PAYLOAD:
            raise WireError(f"blob too large: {n}")
        return self.take(n)

    def s(self) -> str:
        try:
            return self.blob().decode("utf-8")
        except UnicodeDecodeError as e:
            # UnicodeDecodeError is a ValueError; the frame-error
            # contract (wirecheck fuzz) wants the narrow type so the
            # transport loop never has to catch anything broader
            raise WireError(f"invalid utf-8 string field: {e}")

    def count(self) -> int:
        n = self.u32()
        if n > MAX_ITEMS:
            raise WireError(f"count too large: {n}")
        return n


def _enum(cls, v: int):
    """Enum conversion under the frame-error contract: an unknown
    discriminant byte is malformed wire data (WireError), not a
    ValueError leaking enum internals to the transport loop."""
    try:
        return cls(v)
    except ValueError:
        raise WireError(f"unknown {cls.__name__} value {v}")


# ---------------------------------------------------------------------------
# entries / membership / snapshots
# ---------------------------------------------------------------------------
def _w_entry(b: BytesIO, e: Entry) -> None:
    _wu64(b, e.term)
    _wu64(b, e.index)
    _wu8(b, int(e.type))
    _wu64(b, e.key)
    _wu64(b, e.client_id)
    _wu64(b, e.series_id)
    _wu64(b, e.responded_to)
    _wb(b, e.cmd)


def _r_entry(r: _R) -> Entry:
    term = r.u64()
    index = r.u64()
    etype = _enum(EntryType, r.u8())
    key = r.u64()
    client_id = r.u64()
    series_id = r.u64()
    responded_to = r.u64()
    cmd = r.blob()
    return Entry(
        term=term,
        index=index,
        type=etype,
        key=key,
        client_id=client_id,
        series_id=series_id,
        responded_to=responded_to,
        cmd=cmd,
    )


def _w_addr_map(b: BytesIO, m: dict) -> None:
    _wu32(b, len(m))
    for rid in sorted(m):
        _wu64(b, rid)
        _ws(b, m[rid])


def _r_addr_map(r: _R) -> dict:
    return {r.u64(): r.s() for _ in range(r.count())}


def _w_membership(b: BytesIO, m: Membership) -> None:
    _wu64(b, m.config_change_id)
    _w_addr_map(b, m.addresses)
    _w_addr_map(b, m.non_votings)
    _w_addr_map(b, m.witnesses)
    _wu32(b, len(m.removed))
    for rid in sorted(m.removed):
        _wu64(b, rid)


def _r_membership(r: _R) -> Membership:
    ccid = r.u64()
    addresses = _r_addr_map(r)
    non_votings = _r_addr_map(r)
    witnesses = _r_addr_map(r)
    removed = {r.u64(): True for _ in range(r.count())}
    return Membership(
        config_change_id=ccid,
        addresses=addresses,
        non_votings=non_votings,
        witnesses=witnesses,
        removed=removed,
    )


def _w_snapshot(b: BytesIO, s: Snapshot) -> None:
    _ws(b, s.filepath)
    _wu64(b, s.file_size)
    _wu64(b, s.index)
    _wu64(b, s.term)
    _w_membership(b, s.membership)
    _wu32(b, len(s.files))
    for f in s.files:
        _wu64(b, f.file_id)
        _ws(b, f.filepath)
        _wu64(b, f.file_size)
        _wb(b, f.metadata)
    _wb(b, s.checksum)
    _wu8(b, int(s.dummy))
    _wu64(b, s.shard_id)
    _wu64(b, s.replica_id)
    _wu64(b, s.on_disk_index)
    _wu8(b, int(s.witness))
    _wu8(b, int(s.imported))
    _wu8(b, s.type)
    _wu8(b, int(s.compression))


def _r_snapshot(r: _R) -> Snapshot:
    filepath = r.s()
    file_size = r.u64()
    index = r.u64()
    term = r.u64()
    membership = _r_membership(r)
    files = tuple(
        SnapshotFile(
            file_id=r.u64(),
            filepath=r.s(),
            file_size=r.u64(),
            metadata=r.blob(),
        )
        for _ in range(r.count())
    )
    checksum = r.blob()
    dummy = bool(r.u8())
    shard_id = r.u64()
    replica_id = r.u64()
    on_disk_index = r.u64()
    witness = bool(r.u8())
    imported = bool(r.u8())
    stype = r.u8()
    compression = _enum(CompressionType, r.u8())
    return Snapshot(
        filepath=filepath,
        file_size=file_size,
        index=index,
        term=term,
        membership=membership,
        files=files,
        checksum=checksum,
        dummy=dummy,
        shard_id=shard_id,
        replica_id=replica_id,
        on_disk_index=on_disk_index,
        witness=witness,
        imported=imported,
        type=stype,
        compression=compression,
    )


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------
def _w_message(b: BytesIO, m: Message) -> None:
    _wu8(b, int(m.type))
    _wu8(b, int(m.reject))
    for v in (
        m.to,
        m.from_,
        m.shard_id,
        m.term,
        m.log_term,
        m.log_index,
        m.commit,
        m.hint,
        m.hint_high,
    ):
        _wu64(b, v)
    _wu32(b, len(m.entries))
    for e in m.entries:
        _w_entry(b, e)
    has_ss = not m.snapshot.is_empty()
    _wu8(b, int(has_ss))
    if has_ss:
        _w_snapshot(b, m.snapshot)
    # trace context (obs/): one flag byte when untraced, so the
    # tracing-off wire cost is a single zero byte per message
    has_trace = m.trace_id != 0
    _wu8(b, int(has_trace))
    if has_trace:
        _wu64(b, m.trace_id)
        _wu64(b, m.span_id)


def _r_message(r: _R, bin_ver: int = MESSAGE_BATCH_BIN_VER) -> Message:
    mtype = _enum(MessageType, r.u8())
    reject = bool(r.u8())
    to, from_, shard_id, term, log_term, log_index, commit, hint, hint_high = (
        r.u64() for _ in range(9)
    )
    entries = tuple(_r_entry(r) for _ in range(r.count()))
    snapshot = _r_snapshot(r) if r.u8() else Snapshot()
    trace_id = span_id = 0
    # v0 predates the trace-context flag byte: nothing more to read
    if bin_ver >= 1 and r.u8():
        trace_id = r.u64()
        span_id = r.u64()
    return Message(
        type=mtype,
        to=to,
        from_=from_,
        shard_id=shard_id,
        term=term,
        log_term=log_term,
        log_index=log_index,
        commit=commit,
        reject=reject,
        hint=hint,
        hint_high=hint_high,
        entries=entries,
        snapshot=snapshot,
        trace_id=trace_id,
        span_id=span_id,
    )


# ---------------------------------------------------------------------------
# top-level payloads
# ---------------------------------------------------------------------------
def encode_batch(batch: MessageBatch) -> bytes:
    b = BytesIO()
    _ws(b, batch.source_address)
    _wu64(b, batch.deployment_id)
    # the encoder only emits the CURRENT per-message layout, so the
    # header always says so — batch.bin_ver is what the decoder READ,
    # not a request to re-encode an old format
    _wu32(b, MESSAGE_BATCH_BIN_VER)
    _wu32(b, len(batch.messages))
    for m in batch.messages:
        _w_message(b, m)
    return b.getvalue()


def decode_batch(data: bytes) -> MessageBatch:
    r = _R(data)
    source_address = r.s()
    deployment_id = r.u64()
    bin_ver = r.u32()
    if bin_ver > MESSAGE_BATCH_BIN_VER:
        # the per-message layout is versioned by this field; parsing an
        # unknown FUTURE version would silently shift every subsequent
        # field.  Known past versions still decode (v0 lacks the
        # trace-context flag byte) so a rolling upgrade keeps talking.
        raise WireError(
            f"message batch bin_ver {bin_ver} is newer than supported "
            f"{MESSAGE_BATCH_BIN_VER}"
        )
    messages = tuple(_r_message(r, bin_ver) for _ in range(r.count()))
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return MessageBatch(
        messages=messages,
        source_address=source_address,
        deployment_id=deployment_id,
        bin_ver=bin_ver,
    )


def encode_snapshot_meta(s: Snapshot) -> bytes:
    """Standalone Snapshot metadata record (snapshot export dirs)."""
    b = BytesIO()
    _w_snapshot(b, s)
    return b.getvalue()


def decode_snapshot_meta(data: bytes) -> Snapshot:
    r = _R(data)
    s = _r_snapshot(r)
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return s


_CF_WITNESS = 1
_CF_DUMMY = 2
_CF_FILE_INFO = 4


# per-chunk payload bound, enforced BOTH ways (the OBS-reply
# discipline): legit chunks are Soft.snapshot_chunk_size (2MB default),
# so a length field anywhere near this is a forged frame, not data
_CHUNK_MAX_DATA = 16 * 1024 * 1024


def encode_chunk(c: Chunk) -> bytes:
    if len(c.data) > _CHUNK_MAX_DATA:
        raise WireError(
            f"chunk data {len(c.data)}B exceeds {_CHUNK_MAX_DATA}B"
        )
    b = BytesIO()
    for v in (
        c.shard_id,
        c.replica_id,
        c.from_,
        c.chunk_id,
        c.chunk_size,
        c.chunk_count,
        c.index,
        c.term,
        c.message_term,
        c.file_size,
        c.on_disk_index,
    ):
        _wu64(b, v)
    flags = (
        (_CF_WITNESS if c.witness else 0)
        | (_CF_DUMMY if c.dummy else 0)
        | (_CF_FILE_INFO if c.has_file_info else 0)
    )
    _wu8(b, flags)
    _ws(b, c.filepath)
    _wb(b, c.data)
    _w_membership(b, c.membership)
    if c.has_file_info:
        _wu64(b, c.file_info.file_id)
        _ws(b, c.file_info.filepath)
        _wu64(b, c.file_info.file_size)
        _wb(b, c.file_info.metadata)
        _wu64(b, c.file_chunk_id)
        _wu64(b, c.file_chunk_count)
    return b.getvalue()


def decode_chunk(data: bytes) -> Chunk:
    r = _R(data)
    (
        shard_id,
        replica_id,
        from_,
        chunk_id,
        chunk_size,
        chunk_count,
        index,
        term,
        message_term,
        file_size,
        on_disk_index,
    ) = (r.u64() for _ in range(11))
    flags = r.u8()
    filepath = r.s()
    payload = r.blob()
    if len(payload) > _CHUNK_MAX_DATA:
        raise WireError(
            f"chunk data {len(payload)}B exceeds {_CHUNK_MAX_DATA}B"
        )
    membership = _r_membership(r)
    file_info = SnapshotFile()
    file_chunk_id = file_chunk_count = 0
    if flags & _CF_FILE_INFO:
        file_info = SnapshotFile(
            file_id=r.u64(),
            filepath=r.s(),
            file_size=r.u64(),
            metadata=r.blob(),
        )
        file_chunk_id = r.u64()
        file_chunk_count = r.u64()
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return Chunk(
        shard_id=shard_id,
        replica_id=replica_id,
        from_=from_,
        chunk_id=chunk_id,
        chunk_size=chunk_size,
        chunk_count=chunk_count,
        index=index,
        term=term,
        message_term=message_term,
        file_size=file_size,
        on_disk_index=on_disk_index,
        witness=bool(flags & _CF_WITNESS),
        dummy=bool(flags & _CF_DUMMY),
        has_file_info=bool(flags & _CF_FILE_INFO),
        filepath=filepath,
        data=payload,
        membership=membership,
        file_info=file_info,
        file_chunk_id=file_chunk_id,
        file_chunk_count=file_chunk_count,
    )


# ---------------------------------------------------------------------------
# rsm payload codecs
# ---------------------------------------------------------------------------
# These payloads ride INSIDE entries and snapshot chunks, so they arrive
# from the network exactly like frames do: config-change cmds replicate
# to every peer, session tables and rsm snapshot payloads ship through
# the chunk lane.  The reference encodes them as protobufs
# (raftpb/raft.proto -> ConfigChange, session state [U]); here they use
# the same positional binary discipline as the rest of this module —
# never pickle, which would be remote code execution on decode.

def encode_config_change(cc: "ConfigChange") -> bytes:
    b = BytesIO()
    _wu64(b, cc.config_change_id)
    _wu8(b, int(cc.type))
    _wu64(b, cc.replica_id)
    _ws(b, cc.address)
    _wu8(b, int(cc.initialize))
    return b.getvalue()


def decode_config_change(data: bytes) -> "ConfigChange":
    r = _R(data)
    ccid = r.u64()
    cctype = _enum(ConfigChangeType, r.u8())
    replica_id = r.u64()
    address = r.s()
    initialize = bool(r.u8())
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return ConfigChange(
        config_change_id=ccid,
        type=cctype,
        replica_id=replica_id,
        address=address,
        initialize=initialize,
    )


# per-result payload bound, both ways: cached session results are
# proposal-sized, never snapshot-sized
_SESSION_MAX_RESULT = 8 * 1024 * 1024


def encode_session_table(sessions) -> bytes:
    """``sessions``: iterable of (client_id, responded_to,
    {series_id: Result}) in LRU order (order is preserved)."""
    b = BytesIO()
    rows = list(sessions)
    _wu32(b, len(rows))
    for client_id, responded_to, history in rows:
        _wu64(b, client_id)
        _wu64(b, responded_to)
        _wu32(b, len(history))
        for sid in sorted(history):
            res = history[sid]
            if len(res.data) > _SESSION_MAX_RESULT:
                raise WireError(
                    f"session result {len(res.data)}B exceeds "
                    f"{_SESSION_MAX_RESULT}B"
                )
            _wu64(b, sid)
            _wu64(b, res.value)
            _wb(b, res.data)
    return b.getvalue()


def decode_session_table(data: bytes):
    from ..statemachine import Result

    r = _R(data)
    out = []
    for _ in range(r.count()):
        client_id = r.u64()
        responded_to = r.u64()
        history = {}
        for _ in range(r.count()):
            sid = r.u64()
            value = r.u64()
            rdata = r.blob()
            if len(rdata) > _SESSION_MAX_RESULT:
                raise WireError(
                    f"session result {len(rdata)}B exceeds "
                    f"{_SESSION_MAX_RESULT}B"
                )
            history[sid] = Result(value=value, data=rdata)
        out.append((client_id, responded_to, history))
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return out


RSM_SNAPSHOT_VERSION = 2

# session-table section bound, both ways.  sm_data stays at the global
# MAX_PAYLOAD (a full state-machine image is legitimately huge); the
# session table is LRU-capped and can never approach this honestly.
_RSM_MAX_SESSIONS = 64 * 1024 * 1024


def encode_rsm_snapshot(
    *,
    index: int,
    term: int,
    membership: Membership,
    sessions: bytes,
    sm_data,
    on_disk: bool,
) -> bytes:
    if len(sessions) > _RSM_MAX_SESSIONS:
        raise WireError(
            f"session table {len(sessions)}B exceeds {_RSM_MAX_SESSIONS}B"
        )
    b = BytesIO()
    _wu8(b, RSM_SNAPSHOT_VERSION)
    _wu8(b, int(on_disk))
    _wu8(b, 0 if sm_data is None else 1)
    _wu64(b, index)
    _wu64(b, term)
    _w_membership(b, membership)
    _wb(b, sessions)
    _wb(b, sm_data if sm_data is not None else b"")
    return b.getvalue()


def decode_rsm_snapshot(data: bytes) -> dict:
    r = _R(data)
    version = r.u8()
    if version != RSM_SNAPSHOT_VERSION:
        raise WireError(f"unsupported rsm snapshot version {version}")
    on_disk = bool(r.u8())
    has_sm_data = bool(r.u8())
    index = r.u64()
    term = r.u64()
    membership = _r_membership(r)
    sessions = r.blob()
    if len(sessions) > _RSM_MAX_SESSIONS:
        raise WireError(
            f"session table {len(sessions)}B exceeds {_RSM_MAX_SESSIONS}B"
        )
    sm_data = r.blob()
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return {
        "version": version,
        "index": index,
        "term": term,
        "membership": membership,
        "sessions": sessions,
        "sm_data": sm_data if has_sm_data else None,
        "on_disk": on_disk,
    }


# ---------------------------------------------------------------------------
# gateway RPC payloads (gateway/rpc.py)
# ---------------------------------------------------------------------------
# The networked NodeHost front door's request/response pair.  Both are
# versioned like MessageBatch: the encoder always writes the CURRENT
# layout, the decoder accepts known past versions and refuses FUTURE
# ones (silently shifting every later field is the failure mode this
# guards).  All fields positional binary — RPC input arrives from
# untrusted client connections and must never execute code or allocate
# unboundedly on decode.

# v0: the original layout.  v1 appends a trace-context section (flag
# byte + trace_id/span_id, the pb.Message discipline) — but the encoder
# only stamps v1 when trace context is actually present, so an untraced
# request stays BYTE-IDENTICAL to v0 and an old (v0-only) server keeps
# working as long as nobody traces at it.  A traced frame against an
# old server tears the connection (future-version refusal); the client
# handle latches tracing off for that address and retries untraced
# (gateway/rpc.py, docs/OBSERVABILITY.md "Degrade matrix").
RPC_BIN_VER = 1

# request ops
RPC_OP_PROPOSE = 1
RPC_OP_READ = 2
RPC_OP_SESSION_OPEN = 3
RPC_OP_SESSION_CLOSE = 4
RPC_OP_STATS = 5
RPC_OP_FAULT = 6
RPC_OP_OBS = 7  # fleet-scope telemetry (obs/fleetscope.py); old
                # servers answer RPC_ERR "unknown op 7" and the
                # collector marks the process "no-obs"

# READ flags (RpcRequest.flags)
RPC_READ_LEASE = 0   # lease fast path ONLY; ERR_NO_LEASE when not held
RPC_READ_INDEX = 1   # full ReadIndex quorum read
RPC_READ_STALE = 2   # local stale read (no linearizability)
# readplane consistency byte (docs/READPLANE.md).  Old servers answer
# unknown flags with code=RPC_ERR "unknown read mode N" — the client's
# readplane router treats that as ReadUnsupported and degrades to a
# leader read, so mixed-version fleets stay correct.
RPC_READ_FOLLOWER = 3  # follower-linearizable: ReadIndex round via the
                       # leader, served from the LOCAL state machine
RPC_READ_BOUNDED = 4   # bounded staleness: local read stamped with the
                       # applied index; arg = bound in ticks, shed past it

# STATS request flag: append the read-path serve counts as a trailing
# payload section.  Flag-gated because OLD decoders reject trailing
# bytes — a new server must never send the section unsolicited.
RPC_STATS_READ_PATHS = 1

# OBS sub-kinds (RpcRequest.flags for RPC_OP_OBS)
RPC_OBS_METRICS = 1   # structured MetricsRegistry.snapshot() + identity
RPC_OBS_RECORDER = 2  # flight-recorder ring slice past a cursor
RPC_OBS_SPANS = 3     # finished-span ring slice past a cursor

# response codes: 0..6 are RequestResultCode values verbatim; the 0x60
# block is transport/ingress-level outcomes that have no node-side code
RPC_ERR_BUSY = 0x60       # shed (server admission / node SystemBusy)
RPC_ERR_NOT_FOUND = 0x61  # shard not on this host / host closed
RPC_ERR_NO_LEASE = 0x62   # lease-only read: lease not held, fall back
RPC_ERR = 0x63            # anything else (error string carries detail)
RPC_ERR_DENIED = 0x64     # op not allowed (fault ops on a prod server)
RPC_ERR_STALE_BOUND = 0x65  # BOUNDED read shed: staleness past the bound

_RPC_MAX_CMD = 8 * 1024 * 1024  # per-request payload bound (ingress)


class RpcRequest:
    """One client request (see gateway/rpc.py for op semantics).

    ``client_id``/``series_id``/``responded_to`` carry the exactly-once
    session triple for PROPOSE/SESSION_CLOSE (the session STATE lives
    client-side; the server reconstructs an ephemeral Session per
    request).  ``timeout_ms`` is the per-request deadline the server
    bounds its own wait by; ``arg`` is op-specific (lease margin ticks
    for READ/LEASE).  ``trace_id``/``span_id`` carry the client root
    span's context (0 = untraced) so a gateway propose stitches into
    the server-side request→raft→apply spans — same contract as
    ``pb.Message.trace_id``."""

    __slots__ = ("req_id", "op", "flags", "shard_id", "client_id",
                 "series_id", "responded_to", "timeout_ms", "arg",
                 "payload", "trace_id", "span_id")

    def __init__(self, req_id=0, op=0, flags=0, shard_id=0, client_id=0,
                 series_id=0, responded_to=0, timeout_ms=1000, arg=0,
                 payload=b"", trace_id=0, span_id=0):
        self.req_id = req_id
        self.op = op
        self.flags = flags
        self.shard_id = shard_id
        self.client_id = client_id
        self.series_id = series_id
        self.responded_to = responded_to
        self.timeout_ms = timeout_ms
        self.arg = arg
        self.payload = payload
        self.trace_id = trace_id
        self.span_id = span_id


class RpcResponse:
    """One server response.  ``code`` is a RequestResultCode value or an
    RPC_ERR_* constant; ``value``/``data`` mirror statemachine.Result;
    ``error`` is human-readable detail for the error block."""

    __slots__ = ("req_id", "code", "value", "data", "error")

    def __init__(self, req_id=0, code=0, value=0, data=b"", error=""):
        self.req_id = req_id
        self.code = code
        self.value = value
        self.data = data
        self.error = error


def encode_rpc_request(q: RpcRequest) -> bytes:
    if len(q.payload) > _RPC_MAX_CMD:
        raise WireError(f"rpc payload too large: {len(q.payload)}")
    # v1 is stamped ONLY when trace context rides the frame: untraced
    # requests stay byte-identical to v0, so mixed-version fleets only
    # pay the degrade path when someone actually traces at an old
    # server (and the client latch then falls back to v0 frames)
    traced = bool(q.trace_id)
    b = BytesIO()
    _wu32(b, RPC_BIN_VER if traced else 0)
    _wu64(b, q.req_id)
    _wu8(b, q.op)
    _wu8(b, q.flags)
    _wu64(b, q.shard_id)
    _wu64(b, q.client_id)
    _wu64(b, q.series_id)
    _wu64(b, q.responded_to)
    _wu32(b, q.timeout_ms)
    _wu32(b, q.arg)
    _wb(b, q.payload)
    if traced:
        _wu8(b, 1)
        _wu64(b, q.trace_id)
        _wu64(b, q.span_id)
    return b.getvalue()


def decode_rpc_request(data: bytes) -> RpcRequest:
    r = _R(data)
    bin_ver = r.u32()
    if bin_ver > RPC_BIN_VER:
        raise WireError(
            f"rpc request bin_ver {bin_ver} is newer than supported "
            f"{RPC_BIN_VER}"
        )
    q = RpcRequest(
        req_id=r.u64(), op=r.u8(), flags=r.u8(), shard_id=r.u64(),
        client_id=r.u64(), series_id=r.u64(), responded_to=r.u64(),
        timeout_ms=r.u32(), arg=r.u32(), payload=r.blob(),
    )
    if bin_ver >= 1:
        # trace-context section: flag byte + ids (pb.Message discipline)
        if r.u8():
            q.trace_id = r.u64()
            q.span_id = r.u64()
    if len(q.payload) > _RPC_MAX_CMD:
        raise WireError(f"rpc payload too large: {len(q.payload)}")
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return q


def encode_rpc_response(p: RpcResponse) -> bytes:
    b = BytesIO()
    _wu32(b, RPC_BIN_VER)
    _wu64(b, p.req_id)
    _wu8(b, p.code)
    _wu64(b, p.value)
    _wb(b, p.data)
    _ws(b, p.error)
    return b.getvalue()


def decode_rpc_response(data: bytes) -> RpcResponse:
    r = _R(data)
    bin_ver = r.u32()
    if bin_ver > RPC_BIN_VER:
        raise WireError(
            f"rpc response bin_ver {bin_ver} is newer than supported "
            f"{RPC_BIN_VER}"
        )
    p = RpcResponse(
        req_id=r.u64(), code=r.u8(), value=r.u64(), data=r.blob(),
        error=r.s(),
    )
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return p


# read queries and read results are small tagged values, not arbitrary
# objects: the state machines' lookup() contracts in this repo take
# str/bytes keys and return str/bytes/int/None (plus JSON-able
# composites like AuditKV's ("get", k) tuples and list values).  A
# tagged union keeps the wire pickle-free and the type round trip exact
# (a bytes key must not come back str).
RPC_VAL_NONE = 0
RPC_VAL_BYTES = 1
RPC_VAL_STR = 2
RPC_VAL_INT = 3
RPC_VAL_JSON = 4


def encode_rpc_value(v) -> bytes:
    import json as _json

    b = BytesIO()
    if v is None:
        _wu8(b, RPC_VAL_NONE)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        _wu8(b, RPC_VAL_BYTES)
        _wb(b, bytes(v))
    elif isinstance(v, str):
        _wu8(b, RPC_VAL_STR)
        _ws(b, v)
    elif isinstance(v, bool):
        # bool is an int subclass; JSON keeps the type distinct
        _wu8(b, RPC_VAL_JSON)
        _ws(b, _json.dumps(v))
    elif isinstance(v, int) and 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        _wu8(b, RPC_VAL_INT)
        _wu64(b, v)
    elif isinstance(v, int):
        # negative / oversized ints ride the JSON lane (u64 would wrap)
        _wu8(b, RPC_VAL_JSON)
        _ws(b, _json.dumps(v))
    else:
        try:
            s = _json.dumps(v)
        except (TypeError, ValueError) as e:
            raise WireError(f"rpc value not encodable: {type(v).__name__}") from e
        _wu8(b, RPC_VAL_JSON)
        _ws(b, s)
    return b.getvalue()


def decode_rpc_value(data: bytes):
    import json as _json

    r = _R(data)
    tag = r.u8()
    if tag == RPC_VAL_NONE:
        v = None
    elif tag == RPC_VAL_BYTES:
        v = r.blob()
    elif tag == RPC_VAL_STR:
        v = r.s()
    elif tag == RPC_VAL_INT:
        v = r.u64()
    elif tag == RPC_VAL_JSON:
        try:
            v = _json.loads(r.s())
        except ValueError as e:
            raise WireError(f"bad rpc json value: {e}")
        # JSON turns tuples into lists; lookup() contracts in this repo
        # accept both, so no re-tupling is attempted here
    else:
        raise WireError(f"unknown rpc value tag {tag}")
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return v


# stats bounds, both ways: a host serves thousands of shards at most,
# and the read-path label set is a small fixed vocabulary
_STATS_MAX_ROWS = 1 << 16
_STATS_MAX_READ_PATHS = 1 << 12


def encode_rpc_stats(nodehost_id: str, raft_address: str, rows,
                     read_paths=None) -> bytes:
    """STATS response payload: the host identity plus its
    ``balance_shard_stats()`` rows (membership included), so the
    balance Collector — and through it the gossip-routed gateway's
    RoutingCache — works over RemoteHostHandles with zero shared
    memory.

    ``read_paths`` (path label -> serve count, NodeHost.
    read_path_counts) is a TRAILING section appended only when the
    CLIENT asked for it (RPC_STATS_READ_PATHS in the request flags):
    old decoders reject trailing bytes, so the server must never send
    it unsolicited — flag-gating keeps both skew directions green."""
    b = BytesIO()
    _ws(b, nodehost_id)
    _ws(b, raft_address)
    rows = list(rows)
    if len(rows) > _STATS_MAX_ROWS:
        raise WireError(
            f"stats rows {len(rows)} exceeds {_STATS_MAX_ROWS}"
        )
    if read_paths is not None and len(read_paths) > _STATS_MAX_READ_PATHS:
        raise WireError(
            f"read-path rows {len(read_paths)} exceeds "
            f"{_STATS_MAX_READ_PATHS}"
        )
    _wu32(b, len(rows))
    for row in rows:
        for k in ("shard_id", "replica_id", "leader_id", "term",
                  "applied", "proposals"):
            _wu64(b, row[k])
        # device is -1 (host path / no mesh) or a chip ordinal; +1 keeps
        # it in u64 without a sign convention on the wire
        _wu64(b, int(row.get("device", -1)) + 1)
        _w_membership(b, row["membership"])
    if read_paths is not None:
        _wu32(b, len(read_paths))
        for k in sorted(read_paths):
            _ws(b, k)
            _wu64(b, read_paths[k])
    return b.getvalue()


def decode_rpc_stats(data: bytes):
    r = _R(data)
    nodehost_id = r.s()
    raft_address = r.s()
    rows = []
    n_rows = r.count()
    if n_rows > _STATS_MAX_ROWS:
        raise WireError(f"stats rows {n_rows} exceeds {_STATS_MAX_ROWS}")
    for _ in range(n_rows):
        shard_id = r.u64()
        replica_id = r.u64()
        leader_id = r.u64()
        term = r.u64()
        applied = r.u64()
        proposals = r.u64()
        device = r.u64() - 1
        membership = _r_membership(r)
        rows.append({
            "shard_id": shard_id,
            "replica_id": replica_id,
            "leader_id": leader_id,
            "term": term,
            "applied": applied,
            "proposals": proposals,
            "device": device,
            "membership": membership,
        })
    # optional read-path section (present iff the request asked for it
    # AND the server knows how to send it — an old server just ends
    # here and the caller sees empty counts)
    read_paths = {}
    if r.pos != len(data):
        n_paths = r.count()
        if n_paths > _STATS_MAX_READ_PATHS:
            raise WireError(
                f"read-path rows {n_paths} exceeds {_STATS_MAX_READ_PATHS}"
            )
        for _ in range(n_paths):
            k = r.s()
            read_paths[k] = r.u64()
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return nodehost_id, raft_address, rows, read_paths


# ---------------------------------------------------------------------------
# fleet-scope obs payloads (obs/fleetscope.py, RPC_OP_OBS)
# ---------------------------------------------------------------------------
# The query is positional binary (cursor/epoch don't fit RpcRequest.arg:
# sequence numbers and epochs are u64).  The reply is versioned JSON —
# same lane as RPC_OP_FAULT's spec payload: the content is a nested
# metrics/events/spans dump whose shape evolves faster than a positional
# layout should, and it only ever flows server -> trusted collector.
# Replies are still BOUNDED: every ring is sliced with an explicit
# limit server-side (raftlint's obs-bound rule) and the decoder refuses
# oversized blobs outright.

OBS_BIN_VER = 1

_OBS_MAX_REPLY = 4 * 1024 * 1024  # decoded-reply bound (collector side)


def encode_obs_query(cursor: int = 0, epoch: int = 0,
                     limit: int = 256) -> bytes:
    b = BytesIO()
    _wu32(b, OBS_BIN_VER)
    _wu64(b, cursor)
    _wu64(b, epoch)
    _wu32(b, limit)
    return b.getvalue()


def decode_obs_query(data: bytes):
    """(cursor, epoch, limit); an empty payload decodes as defaults so
    a hand-rolled probe without a query section still answers."""
    if not data:
        return 0, 0, 256
    r = _R(data)
    bin_ver = r.u32()
    if bin_ver > OBS_BIN_VER:
        raise WireError(
            f"obs query bin_ver {bin_ver} is newer than supported "
            f"{OBS_BIN_VER}"
        )
    cursor = r.u64()
    epoch = r.u64()
    limit = r.u32()
    if r.pos != len(data):
        raise WireError(f"trailing bytes: {len(data) - r.pos}")
    return cursor, epoch, limit


def encode_obs_reply(obj: dict) -> bytes:
    import json as _json

    body = {"v": OBS_BIN_VER}
    body.update(obj)
    data = _json.dumps(body, separators=(",", ":")).encode("utf-8")
    if len(data) > _OBS_MAX_REPLY:
        raise WireError(f"obs reply too large: {len(data)}")
    return data


def decode_obs_reply(data: bytes) -> dict:
    import json as _json

    if len(data) > _OBS_MAX_REPLY:
        raise WireError(f"obs reply too large: {len(data)}")
    try:
        obj = _json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"bad obs reply: {e}")
    v = obj.get("v") if isinstance(obj, dict) else None
    if not isinstance(v, int) or v > OBS_BIN_VER or v < 1:
        raise WireError(f"obs reply version {v!r} not supported")
    return obj
