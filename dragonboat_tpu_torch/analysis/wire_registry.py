"""The wire-plane codec registry (wirecheck's ground truth).

Every versioned encode/decode pair in the repo — the TCP frame payloads
(`transport/wire.py`), the gossip packet, the tan WAL records, the
kvlogdb value codecs, the snapshot container (`storage/snapshotio`),
the on-disk SM command codec (`bigstate/ondisk.py`) and the DR manifest
(`bigstate/dr.py`) — is registered here with:

* canonical sample builders per supported layout (``samples``): pure
  functions of constants, so the bytes are reproducible and pin the
  golden corpus under ``tests/wire_goldens/``;
* the decoder and its NARROW error contract (``errors`` — the only
  exception types allowed to escape on hostile bytes; gossip's contract
  is a ``None`` return instead, ``none_on_error``);
* a future-layout builder (``future``) the decoder must REJECT with
  that same narrow type (rolling-upgrade discipline: never a silent
  field shift);
* extra skew invariants (``checks``) for flag-gated extensions — the
  untraced RPC frame staying byte-identical to v0, the stats read-path
  trailer staying absent unless requested, the empty obs query
  defaulting;
* the ``encode_*``/``decode_*`` names and ``KIND_*``/``K_*``/
  ``*_BIN_VER``/``*_VERSION`` constants each entry covers (``claims``)
  so wirecheck's rot guard can flag codec surface that grows WITHOUT a
  registry entry (the jaxcheck ``unregistered-jit`` discipline);
* the decoder functions whose source the ``decode-bound`` rule audits
  (``bound_fns``) and an allocation allowance for the fuzz harness
  (``alloc_slack`` — 0 means "proportional to input only").

Samples intentionally reuse the repo's PRIVATE writer helpers
(``wire._ws`` et al.) to hand-build OLD layouts (e.g. MessageBatch v0 =
the current per-message bytes minus the trailing trace-flag byte) —
the same technique the version-skew tests used before this registry
consolidated them.
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from io import BytesIO
from typing import Callable, Dict, Mapping, Optional, Tuple

from ..pb import (
    Bootstrap,
    Chunk,
    ConfigChange,
    ConfigChangeType,
    Entry,
    EntryType,
    ManifestFile,
    Membership,
    Message,
    MessageBatch,
    MessageType,
    Snapshot,
    SnapshotFile,
    SnapshotManifest,
    State,
    Update,
)
from ..transport import wire
from ..transport.wire import WireError

# repo-relative module paths the rot guard scans.  A module may appear
# here with no claims at all (tcp/chunk/journal only CONSUME the wire
# constants); listing it still guards against a future codec landing
# there unregistered.
SCAN_MODULES = (
    "dragonboat_tpu_torch/pb.py",
    "dragonboat_tpu_torch/transport/wire.py",
    "dragonboat_tpu_torch/transport/tcp.py",
    "dragonboat_tpu_torch/transport/chunk.py",
    "dragonboat_tpu_torch/transport/gossip.py",
    "dragonboat_tpu_torch/storage/tan.py",
    "dragonboat_tpu_torch/storage/kvlogdb.py",
    "dragonboat_tpu_torch/storage/journal.py",
    "dragonboat_tpu_torch/storage/snapshotio.py",
    "dragonboat_tpu_torch/bigstate/ondisk.py",
    "dragonboat_tpu_torch/bigstate/dr.py",
    "dragonboat_tpu_torch/gateway/rpc.py",
    "dragonboat_tpu_torch/obs/fleetscope.py",
    "dragonboat_tpu_torch/readplane/consistency.py",
    "dragonboat_tpu_torch/readplane/router.py",
)

# claims that belong to a module rather than any one codec entry
# (framing flags, the pb-side version constant)
EXTRA_CLAIMS: Mapping[str, Tuple[str, ...]] = {
    "dragonboat_tpu_torch/pb.py": ("MESSAGE_BATCH_BIN_VER",),
    # KIND_RESUME_RESP lives in wire.py but its codec entry is scoped to
    # tcp.py (the only encoder/decoder of the resume frame body)
    "dragonboat_tpu_torch/transport/wire.py": ("KIND_COMPRESSED",
                                         "KIND_RESUME_RESP"),
    "dragonboat_tpu_torch/storage/tan.py": ("K_COMPRESSED",),
}


@dataclass(frozen=True)
class CodecEntry:
    """One registered encode/decode pair (see module docstring)."""

    name: str
    module: str
    samples: Mapping[str, Callable[[], bytes]]
    decode: Callable[[bytes], object]
    errors: Tuple[type, ...]
    encode: Optional[Callable[[], bytes]] = None  # current-layout encoder
    none_on_error: bool = False
    future: Optional[Callable[[], bytes]] = None
    checks: Tuple[Callable[[], Optional[str]], ...] = ()
    claims: Tuple[str, ...] = ()
    bound_fns: Tuple[str, ...] = ()  # qualnames in `module` for decode-bound
    alloc_slack: int = 0  # extra decode-side allocation allowance (bytes)


# ---------------------------------------------------------------------------
# canonical sample values (constants only — golden bytes must be
# reproducible from a clean checkout)
# ---------------------------------------------------------------------------
def _membership() -> Membership:
    return Membership(
        config_change_id=3,
        addresses={1: "n1:7100", 2: "n2:7100"},
        non_votings={3: "n3:7100"},
        witnesses={4: "n4:7100"},
        removed={9: True},
    )


def _entries() -> Tuple[Entry, ...]:
    return (
        Entry(term=2, index=10, type=EntryType.APPLICATION, key=11,
              client_id=7, series_id=1, responded_to=0, cmd=b"put k v"),
        Entry(term=2, index=11, cmd=b""),
    )


def _snapshot() -> Snapshot:
    return Snapshot(
        filepath="snapshot-0000000000000064.dbss",
        file_size=4096,
        index=100,
        term=2,
        membership=_membership(),
        files=(SnapshotFile(file_id=1, filepath="ext/sst-1", file_size=512,
                            metadata=b"meta"),),
        checksum=b"\x01\x02\x03\x04",
        shard_id=1,
        replica_id=2,
        on_disk_index=90,
        type=1,
    )


def _message(traced: bool = False) -> Message:
    return Message(
        type=MessageType.REPLICATE,
        to=2,
        from_=1,
        shard_id=1,
        term=2,
        log_term=2,
        log_index=9,
        commit=8,
        entries=_entries(),
        snapshot=_snapshot(),
        trace_id=0xABCDEF if traced else 0,
        span_id=0x123456 if traced else 0,
    )


def _batch_bytes(bin_ver: int, traced: bool, strip_flag: bool) -> bytes:
    """Hand-built MessageBatch frame: v0 is the current per-message
    layout minus the trailing trace-flag byte (the layout that predates
    the trace extension)."""
    b = BytesIO()
    wire._ws(b, "n1:7100")
    wire._wu64(b, 7)  # deployment_id
    wire._wu32(b, bin_ver)
    wire._wu32(b, 1)
    mb = BytesIO()
    wire._w_message(mb, _message(traced))
    raw = mb.getvalue()
    b.write(raw[:-1] if strip_flag else raw)
    return b.getvalue()


def _chunk(file_info: bool) -> Chunk:
    return Chunk(
        shard_id=1, replica_id=2, from_=3, chunk_id=4, chunk_size=1024,
        chunk_count=8, index=100, term=2, message_term=2, file_size=8192,
        on_disk_index=90, witness=False, dummy=False,
        has_file_info=file_info, filepath="snapshot.dbss",
        data=b"chunk-data" * 8, membership=_membership(),
        file_info=SnapshotFile(file_id=1, filepath="ext/sst-1",
                               file_size=512, metadata=b"meta")
        if file_info else SnapshotFile(),
        file_chunk_id=2 if file_info else 0,
        file_chunk_count=4 if file_info else 0,
    )


def _rpc_request(traced: bool) -> "wire.RpcRequest":
    return wire.RpcRequest(
        req_id=42, op=wire.RPC_OP_PROPOSE, flags=0, shard_id=1,
        client_id=7, series_id=3, responded_to=2, timeout_ms=1000,
        arg=0, payload=b"put k v",
        trace_id=0xABCDEF if traced else 0,
        span_id=0x123456 if traced else 0,
    )


def _stats_rows():
    return [{
        "shard_id": 1, "replica_id": 2, "leader_id": 1, "term": 2,
        "applied": 100, "proposals": 5, "device": -1,
        "membership": _membership(),
    }]


def _u32_patched(data: bytes, offset: int, value: int) -> bytes:
    out = bytearray(data)
    struct.pack_into("<I", out, offset, value)
    return bytes(out)


def _rsm_snapshot_bytes() -> bytes:
    return wire.encode_rsm_snapshot(
        index=100, term=2, membership=_membership(),
        sessions=b"sess", sm_data=b"smdata", on_disk=False,
    )


# -- gossip -----------------------------------------------------------------
def _gossip_packet() -> bytes:
    from ..transport import gossip

    table = {
        "nhid-aaaa": ("n1:7100", 3),
        "nhid-bbbb": ("n2:7100", 5),
    }
    return gossip._encode_packets(table, "n1:7946", "nhid-aaaa")[0]


def _gossip_decode(data: bytes):
    from ..transport import gossip

    return gossip._decode_table(data)


# -- tan WAL records --------------------------------------------------------
# golden layout: kind byte + record body (the framing CRC/length live in
# storage/journal.py and are covered by its own crash tests)
def _tan_update() -> Update:
    u = Update(shard_id=1, replica_id=2)
    u.state = State(term=2, vote=1, commit=8)
    u.entries_to_save = list(_entries())
    u.snapshot = _snapshot()
    return u


def _tan_decode(data: bytes):
    """Replays one record through the REAL decoder
    (``TanLogDB._apply_record``) against a scratch in-memory mirror —
    no filesystem, no segment framing."""
    from ..storage import tan
    from ..storage.logdb import InMemLogDB

    if not data:
        raise WireError("empty tan record")
    db = tan.TanLogDB.__new__(tan.TanLogDB)
    db._mirror = InMemLogDB()
    db._apply_record(data[0], bytes(data[1:]))
    return db._mirror


def _tan_record(kind_name: str, body_builder: Callable[[], bytes]):
    def build() -> bytes:
        from ..storage import tan

        return bytes([getattr(tan, kind_name)]) + body_builder()

    return build


def _tan_body(fn_name: str, *args_builders):
    def build() -> bytes:
        from ..storage import tan

        return getattr(tan, fn_name)(*[a() for a in args_builders])

    return build


# -- kvlogdb value codecs ---------------------------------------------------
def _kv(fn_name: str, *args):
    def build() -> bytes:
        from ..storage import kvlogdb

        return getattr(kvlogdb, fn_name)(*args)

    return build


def _kv_decode(fn_name: str):
    def decode(data: bytes):
        from ..storage import kvlogdb

        return getattr(kvlogdb, fn_name)(data)

    return decode


# -- snapshot container -----------------------------------------------------
def _snapio_container() -> bytes:
    from ..pb import CompressionType
    from ..storage import snapshotio

    buf = BytesIO()
    w = snapshotio.SnapshotWriter(
        buf, index=100, term=2, membership=_membership(),
        sessions=b"sess", on_disk=False,
        compression=int(CompressionType.ZLIB), block_size=256,
    )
    w.write(b"the-sm-payload " * 64)  # > 1 block, compressible
    w.add_external_file(SnapshotFile(file_id=1, filepath="ext/sst-1",
                                     file_size=512, metadata=b"meta"))
    w.close()
    return buf.getvalue()


def _snapio_decode(data: bytes):
    from ..storage import snapshotio

    r = snapshotio.SnapshotReader(BytesIO(data))
    r.validate()
    return r


def _snapio_future() -> bytes:
    out = bytearray(_snapio_container())
    out[4] = 3  # container version byte
    return bytes(out)


def _snapio_errors() -> Tuple[type, ...]:
    from ..storage import snapshotio

    return (snapshotio.SnapshotCorruptError,)


# -- ondisk SM commands -----------------------------------------------------
def _ondisk_cmd(op: str) -> Callable[[], bytes]:
    def build() -> bytes:
        from ..bigstate import ondisk

        if op == "put":
            return ondisk.put_cmd(b"key-1", b"value-1")
        return ondisk.del_cmd(b"key-1")

    return build


def _ondisk_decode(data: bytes):
    from ..bigstate import ondisk

    return ondisk.decode_cmd(data)


def _ondisk_future() -> bytes:
    from ..bigstate import ondisk

    out = bytearray(ondisk.put_cmd(b"key-1", b"value-1"))
    out[0] = 9  # unknown op
    return bytes(out)


# -- DR manifest ------------------------------------------------------------
def _manifest(format_version: int = 1) -> bytes:
    from ..bigstate import dr
    from ..pb import CompressionType

    m = SnapshotManifest(
        format_version=1,
        shard_id=1,
        replica_id=2,
        index=100,
        term=2,
        on_disk=True,
        chunk_size=1 << 20,
        compression=CompressionType.NO_COMPRESSION,
        membership=_membership(),
        files=(ManifestFile(name="snapshot.dbss", size=4096,
                            sha256="ab" * 32, chunk_crcs=(1, 2, 3)),),
    )
    text = dr.manifest_to_json(m)
    if format_version != 1:
        obj = json.loads(text)
        obj["format_version"] = format_version
        text = json.dumps(obj, indent=2, sort_keys=True)
    return text.encode("utf-8")


def _manifest_decode(data: bytes):
    from ..bigstate import dr

    # the archive reader opens the manifest as text; undecodable bytes
    # reach manifest_from_json as replacement chars and fail its
    # structural checks — the shim mirrors that path
    return dr.manifest_from_json(data.decode("utf-8", "replace"))


def _manifest_errors() -> Tuple[type, ...]:
    from ..bigstate import dr

    return (dr.ArchiveError,)


# -- resume-response frame (transport/tcp.py) -------------------------------
def _resume_resp_decode(data: bytes) -> int:
    """The KIND_RESUME_RESP payload: exactly one little-endian u64 (the
    receiver's next-chunk cursor).  tcp.query_resume degrades any
    malformed response to cursor 0; the shim raises the narrow type so
    the fuzz harness can tell 'rejected' from 'misparsed'."""
    if len(data) != 8:
        raise WireError(f"resume response must be 8 bytes, got {len(data)}")
    return struct.unpack("<Q", data)[0]


# ---------------------------------------------------------------------------
# skew invariants for flag-gated extensions
# ---------------------------------------------------------------------------
def _check_untraced_rpc_is_v0() -> Optional[str]:
    v0 = wire.encode_rpc_request(_rpc_request(traced=False))
    if struct.unpack_from("<I", v0, 0)[0] != 0:
        return "untraced rpc request stamped a non-zero bin_ver"
    v1 = wire.encode_rpc_request(_rpc_request(traced=True))
    if struct.unpack_from("<I", v1, 0)[0] != wire.RPC_BIN_VER:
        return "traced rpc request did not stamp RPC_BIN_VER"
    if v1[:len(v0)] == v0:
        return "traced frame must differ from v0 before the trailer"
    return None


def _check_batch_v0_decodes_unstamped() -> Optional[str]:
    d = wire.decode_batch(_batch_bytes(0, traced=False, strip_flag=True))
    if d.bin_ver != 0:
        return f"v0 batch decoded with bin_ver {d.bin_ver}"
    if d.messages[0].trace_id != 0:
        return "v0 batch grew a trace id from nowhere"
    # re-encode always stamps the CURRENT layout
    from ..pb import MESSAGE_BATCH_BIN_VER

    re = wire.encode_batch(d)
    if wire.decode_batch(re).bin_ver != MESSAGE_BATCH_BIN_VER:
        return "re-encode of a v0 batch did not stamp the current bin_ver"
    return None


def _check_stats_trailer_flag_gated() -> Optional[str]:
    plain = wire.encode_rpc_stats("nhid-aaaa", "n1:7100", _stats_rows())
    _, _, _, read_paths = wire.decode_rpc_stats(plain)
    if read_paths != {}:
        return "stats decode invented a read-path trailer"
    with_rp = wire.encode_rpc_stats(
        "nhid-aaaa", "n1:7100", _stats_rows(),
        read_paths={"follower": 3, "lease": 9},
    )
    _, _, _, read_paths = wire.decode_rpc_stats(with_rp)
    if read_paths != {"follower": 3, "lease": 9}:
        return "stats read-path trailer did not round-trip"
    return None


def _check_obs_query_empty_defaults() -> Optional[str]:
    if wire.decode_obs_query(b"") != (0, 0, 256):
        return "empty obs query did not decode as the v0 defaults"
    return None


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
_WIRE = "dragonboat_tpu_torch/transport/wire.py"
_TCP = "dragonboat_tpu_torch/transport/tcp.py"
_GOSSIP = "dragonboat_tpu_torch/transport/gossip.py"
_TAN = "dragonboat_tpu_torch/storage/tan.py"
_KVLOG = "dragonboat_tpu_torch/storage/kvlogdb.py"
_SNAPIO = "dragonboat_tpu_torch/storage/snapshotio.py"
_ONDISK = "dragonboat_tpu_torch/bigstate/ondisk.py"
_DR = "dragonboat_tpu_torch/bigstate/dr.py"

REGISTRY: Tuple[CodecEntry, ...] = (
    CodecEntry(
        name="batch",
        module=_WIRE,
        samples={
            "v0": lambda: _batch_bytes(0, traced=False, strip_flag=True),
            "v1": lambda: _batch_bytes(1, traced=True, strip_flag=False),
        },
        encode=lambda: wire.encode_batch(MessageBatch(
            messages=(_message(traced=True),), source_address="n1:7100",
            deployment_id=7)),
        decode=wire.decode_batch,
        errors=(WireError,),
        future=lambda: _batch_bytes(2, traced=True, strip_flag=False),
        checks=(_check_batch_v0_decodes_unstamped,),
        claims=("encode_batch", "decode_batch", "KIND_BATCH"),
        bound_fns=("decode_batch",),
    ),
    CodecEntry(
        name="snapshot_meta",
        module=_WIRE,
        samples={"plain": lambda: wire.encode_snapshot_meta(_snapshot())},
        encode=lambda: wire.encode_snapshot_meta(_snapshot()),
        decode=wire.decode_snapshot_meta,
        errors=(WireError,),
        claims=("encode_snapshot_meta", "decode_snapshot_meta"),
        bound_fns=("decode_snapshot_meta",),
    ),
    CodecEntry(
        name="chunk",
        module=_WIRE,
        samples={
            "plain": lambda: wire.encode_chunk(_chunk(file_info=False)),
            "file_info": lambda: wire.encode_chunk(_chunk(file_info=True)),
        },
        encode=lambda: wire.encode_chunk(_chunk(file_info=True)),
        decode=wire.decode_chunk,
        errors=(WireError,),
        claims=("encode_chunk", "decode_chunk", "KIND_CHUNK",
                "KIND_RESUME_QUERY"),
        bound_fns=("decode_chunk",),
    ),
    CodecEntry(
        name="resume_resp",
        module=_TCP,
        samples={"v0": lambda: struct.pack("<Q", 5)},
        encode=lambda: struct.pack("<Q", 5),
        decode=_resume_resp_decode,
        errors=(WireError,),
        claims=("KIND_RESUME_RESP",),
    ),
    CodecEntry(
        name="config_change",
        module=_WIRE,
        samples={"v0": lambda: wire.encode_config_change(ConfigChange(
            config_change_id=7, type=ConfigChangeType.ADD_NON_VOTING,
            replica_id=42, address="n9:7100", initialize=True))},
        encode=lambda: wire.encode_config_change(ConfigChange(
            config_change_id=7, type=ConfigChangeType.ADD_NON_VOTING,
            replica_id=42, address="n9:7100", initialize=True)),
        decode=wire.decode_config_change,
        errors=(WireError,),
        claims=("encode_config_change", "decode_config_change"),
        bound_fns=("decode_config_change",),
    ),
    CodecEntry(
        name="session_table",
        module=_WIRE,
        samples={"v0": lambda: wire.encode_session_table(
            _session_rows())},
        encode=lambda: wire.encode_session_table(_session_rows()),
        decode=wire.decode_session_table,
        errors=(WireError,),
        claims=("encode_session_table", "decode_session_table"),
        bound_fns=("decode_session_table",),
    ),
    CodecEntry(
        name="rsm_snapshot",
        module=_WIRE,
        samples={"v2": _rsm_snapshot_bytes},
        encode=_rsm_snapshot_bytes,
        decode=wire.decode_rsm_snapshot,
        errors=(WireError,),
        future=lambda: bytes([3]) + _rsm_snapshot_bytes()[1:],
        claims=("encode_rsm_snapshot", "decode_rsm_snapshot",
                "RSM_SNAPSHOT_VERSION"),
        bound_fns=("decode_rsm_snapshot",),
    ),
    CodecEntry(
        name="rpc_request",
        module=_WIRE,
        samples={
            "v0": lambda: wire.encode_rpc_request(_rpc_request(False)),
            "v1": lambda: wire.encode_rpc_request(_rpc_request(True)),
        },
        encode=lambda: wire.encode_rpc_request(_rpc_request(True)),
        decode=wire.decode_rpc_request,
        errors=(WireError,),
        future=lambda: _u32_patched(
            wire.encode_rpc_request(_rpc_request(True)), 0,
            wire.RPC_BIN_VER + 1),
        checks=(_check_untraced_rpc_is_v0,),
        claims=("encode_rpc_request", "decode_rpc_request",
                "KIND_RPC_REQ", "RPC_BIN_VER"),
        bound_fns=("decode_rpc_request",),
    ),
    CodecEntry(
        name="rpc_response",
        module=_WIRE,
        samples={"v1": lambda: wire.encode_rpc_response(wire.RpcResponse(
            req_id=42, code=0, value=1, data=b"result", error=""))},
        encode=lambda: wire.encode_rpc_response(wire.RpcResponse(
            req_id=42, code=0, value=1, data=b"result", error="")),
        decode=wire.decode_rpc_response,
        errors=(WireError,),
        future=lambda: _u32_patched(
            wire.encode_rpc_response(wire.RpcResponse(req_id=42)), 0,
            wire.RPC_BIN_VER + 1),
        claims=("encode_rpc_response", "decode_rpc_response",
                "KIND_RPC_RESP"),
        bound_fns=("decode_rpc_response",),
    ),
    CodecEntry(
        name="rpc_value",
        module=_WIRE,
        samples={
            "none": lambda: wire.encode_rpc_value(None),
            "bytes": lambda: wire.encode_rpc_value(b"\x00\x01value"),
            "str": lambda: wire.encode_rpc_value("value"),
            "int": lambda: wire.encode_rpc_value(12345),
            "json": lambda: wire.encode_rpc_value(
                {"applied": 100, "keys": [1, 2, 3]}),
        },
        encode=lambda: wire.encode_rpc_value({"applied": 100}),
        decode=wire.decode_rpc_value,
        errors=(WireError,),
        # tag bytes above RPC_VAL_JSON are the future lane
        future=lambda: bytes([9]) + wire.encode_rpc_value(None)[1:],
        claims=("encode_rpc_value", "decode_rpc_value"),
        bound_fns=("decode_rpc_value",),
    ),
    CodecEntry(
        name="rpc_stats",
        module=_WIRE,
        samples={
            "v0": lambda: wire.encode_rpc_stats(
                "nhid-aaaa", "n1:7100", _stats_rows()),
            "readpaths": lambda: wire.encode_rpc_stats(
                "nhid-aaaa", "n1:7100", _stats_rows(),
                read_paths={"follower": 3, "lease": 9}),
        },
        encode=lambda: wire.encode_rpc_stats(
            "nhid-aaaa", "n1:7100", _stats_rows()),
        decode=wire.decode_rpc_stats,
        errors=(WireError,),
        checks=(_check_stats_trailer_flag_gated,),
        claims=("encode_rpc_stats", "decode_rpc_stats"),
        bound_fns=("decode_rpc_stats",),
    ),
    CodecEntry(
        name="obs_query",
        module=_WIRE,
        samples={
            "v1": lambda: wire.encode_obs_query(cursor=17, epoch=2,
                                                limit=128),
            "empty": lambda: b"",
        },
        encode=lambda: wire.encode_obs_query(cursor=17, epoch=2, limit=128),
        decode=wire.decode_obs_query,
        errors=(WireError,),
        future=lambda: _u32_patched(
            wire.encode_obs_query(), 0, wire.OBS_BIN_VER + 1),
        checks=(_check_obs_query_empty_defaults,),
        claims=("encode_obs_query", "decode_obs_query", "OBS_BIN_VER"),
        bound_fns=("decode_obs_query",),
    ),
    CodecEntry(
        name="obs_reply",
        module=_WIRE,
        samples={"v1": lambda: wire.encode_obs_reply(
            {"metrics": {"counters": {"proposals": 5}}, "epoch": 2})},
        encode=lambda: wire.encode_obs_reply({"epoch": 2}),
        decode=wire.decode_obs_reply,
        errors=(WireError,),
        future=lambda: json.dumps(
            {"v": wire.OBS_BIN_VER + 1, "epoch": 2},
            separators=(",", ":")).encode("utf-8"),
        claims=("encode_obs_reply", "decode_obs_reply"),
        bound_fns=("decode_obs_reply",),
    ),
    CodecEntry(
        name="gossip_packet",
        module=_GOSSIP,
        samples={"v0": _gossip_packet},
        encode=_gossip_packet,
        decode=_gossip_decode,
        errors=(),
        none_on_error=True,
        # no version field: an unknown-magic packet must read as None
        future=lambda: b"\xff\xff\xff\xff" + _gossip_packet()[4:],
        bound_fns=("_decode_table",),
    ),
    CodecEntry(
        name="tan_state_entries",
        module=_TAN,
        samples={"v0": _tan_record(
            "K_STATE_ENTRIES",
            _tan_body("_encode_state_entries", _tan_update))},
        decode=_tan_decode,
        errors=(WireError,),
        # an unknown kind byte is tan's future lane: refused, then the
        # journal-level replay surfaces it as mid-log corruption
        future=lambda: bytes([0x3F]) + b"\x00" * 16,
        claims=("K_STATE_ENTRIES",),
        bound_fns=("TanLogDB._apply_record",),
    ),
    CodecEntry(
        name="tan_snapshot",
        module=_TAN,
        samples={"v0": _tan_record(
            "K_SNAPSHOT",
            _tan_body("_encode_snapshot", lambda: 1, lambda: 2, _snapshot))},
        decode=_tan_decode,
        errors=(WireError,),
        claims=("K_SNAPSHOT",),
    ),
    CodecEntry(
        name="tan_bootstrap",
        module=_TAN,
        samples={"v0": _tan_record(
            "K_BOOTSTRAP",
            _tan_body("_encode_bootstrap", lambda: 1, lambda: 2,
                      lambda: Bootstrap(addresses={1: "n1:7100",
                                                   2: "n2:7100"},
                                        join=False)))},
        decode=_tan_decode,
        errors=(WireError,),
        claims=("K_BOOTSTRAP",),
    ),
    CodecEntry(
        name="tan_remove_to",
        module=_TAN,
        samples={"v0": _tan_record(
            "K_REMOVE_TO",
            _tan_body("_encode_pair_index", lambda: 1, lambda: 2,
                      lambda: 50))},
        decode=_tan_decode,
        errors=(WireError,),
        claims=("K_REMOVE_TO",),
    ),
    CodecEntry(
        name="tan_remove_node",
        module=_TAN,
        samples={"v0": _tan_record(
            "K_REMOVE_NODE",
            _tan_body("_encode_pair", lambda: 1, lambda: 2))},
        decode=_tan_decode,
        errors=(WireError,),
        claims=("K_REMOVE_NODE",),
    ),
    CodecEntry(
        name="kv_entries",
        module=_KVLOG,
        samples={"v0": _kv("_enc_entries", list(_entries()))},
        decode=_kv_decode("_dec_entries"),
        errors=(WireError,),
        claims=("K_ENTRY",),
        bound_fns=("_dec_entries",),
    ),
    CodecEntry(
        name="kv_state",
        module=_KVLOG,
        samples={"v0": _kv("_enc_state", State(term=2, vote=1, commit=8))},
        decode=_kv_decode("_dec_state"),
        errors=(WireError,),
        claims=("K_STATE",),
        bound_fns=("_dec_state",),
    ),
    CodecEntry(
        name="kv_bootstrap",
        module=_KVLOG,
        samples={"v0": _kv("_enc_bootstrap", Bootstrap(
            addresses={1: "n1:7100", 2: "n2:7100"}, join=True))},
        decode=_kv_decode("_dec_bootstrap"),
        errors=(WireError,),
        claims=("K_BOOTSTRAP", "K_SNAPSHOT", "K_MININDEX"),
        bound_fns=("_dec_bootstrap",),
    ),
    CodecEntry(
        name="snapshotio_container",
        module=_SNAPIO,
        samples={"v2": _snapio_container},
        decode=_snapio_decode,
        errors=_snapio_errors(),
        future=_snapio_future,
        claims=("VERSION",),
        bound_fns=("_SMStream._next_block", "SnapshotReader.__init__"),
        # a corrupt-but-valid-CRC compressed block may legally inflate
        # up to the container's block bound before the size check fires
        alloc_slack=64 * 1024 * 1024,
    ),
    CodecEntry(
        name="ondisk_cmd",
        module=_ONDISK,
        samples={"put": _ondisk_cmd("put"), "del": _ondisk_cmd("del")},
        decode=_ondisk_decode,
        errors=(ValueError,),
        future=_ondisk_future,
        claims=("decode_cmd", "_BASE_VERSION"),
        bound_fns=("decode_cmd",),
    ),
    CodecEntry(
        name="dr_manifest",
        module=_DR,
        samples={"v1": _manifest},
        decode=_manifest_decode,
        errors=_manifest_errors(),
        future=lambda: _manifest(format_version=2),
        bound_fns=("manifest_from_json",),
    ),
)


def _session_rows():
    from ..statemachine import Result

    return [
        (11, 3, {1: Result(value=9, data=b"x"), 2: Result(value=8)}),
        (5, 0, {}),
        (99, 7, {7: Result(data=b"\x00" * 64)}),
    ]


def entry(name: str) -> CodecEntry:
    for e in REGISTRY:
        if e.name == name:
            return e
    raise KeyError(name)


def claimed_names(module: str) -> frozenset:
    """Every codec name/constant the registry claims for `module`."""
    names = set(EXTRA_CLAIMS.get(module, ()))
    for e in REGISTRY:
        if e.module == module:
            names.update(e.claims)
    return frozenset(names)
