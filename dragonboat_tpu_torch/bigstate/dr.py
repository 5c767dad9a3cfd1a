"""Portable snapshot archives — the disaster-recovery interchange.

reference: tools/import.go (ImportSnapshot) and the exported-snapshot
flow of SyncRequestSnapshot [U].  The scenario: a shard has lost its
quorum permanently.  An archive exported from a surviving replica is
imported on fresh hosts with a REWRITTEN membership, and the shard
restarts from the snapshot with the new member set.

Archive layout (one directory):

    MANIFEST.json    self-describing metadata (pb.SnapshotManifest):
                     shard/replica/index/term/membership, the v2
                     container's compression, and per-file size +
                     sha256 + per-chunk crc32 list
    META             wire-encoded pb.Snapshot (legacy compat: archives
                     written here import on pre-manifest trees and
                     vice versa)
    snapshot.bin     the v2 snapshot container, verbatim
    external-*       ISnapshotFileCollection files, verbatim

Everything streams: export reads the container in ``chunk_size`` slices
(checksumming as it copies), import verifies the same slices before the
logdb is touched — a GB-scale archive never materializes in memory on
either side, and corruption is localized to a chunk index.
"""
from __future__ import annotations

import hashlib
import json
import os
import zlib
from typing import Dict, Optional, Tuple

from .. import settings
from ..pb import ManifestFile, Membership, Snapshot, SnapshotManifest
from ..pb import CompressionType

MANIFEST_FILENAME = "MANIFEST.json"
META_FILENAME = "META"
PAYLOAD_FILENAME = "snapshot.bin"


class ArchiveError(IOError, ValueError):
    """Malformed / corrupt / mismatched snapshot archive.

    Subclasses BOTH IOError and ValueError: the pre-manifest tools.py
    raised IOError for corruption and ValueError for shard mismatch,
    and existing callers catch either — the unified error must stay
    catchable through both legacy styles."""


# ---------------------------------------------------------------------------
# manifest (de)serialization
# ---------------------------------------------------------------------------
def _membership_to_json(m: Membership) -> dict:
    return {
        "config_change_id": m.config_change_id,
        "addresses": {str(k): v for k, v in m.addresses.items()},
        "non_votings": {str(k): v for k, v in m.non_votings.items()},
        "witnesses": {str(k): v for k, v in m.witnesses.items()},
        "removed": sorted(int(k) for k in m.removed),
    }


def _membership_from_json(d: dict) -> Membership:
    return Membership(
        config_change_id=int(d.get("config_change_id", 0)),
        addresses={int(k): v for k, v in d.get("addresses", {}).items()},
        non_votings={int(k): v for k, v in d.get("non_votings", {}).items()},
        witnesses={int(k): v for k, v in d.get("witnesses", {}).items()},
        removed={int(k): True for k in d.get("removed", ())},
    )


def manifest_to_json(m: SnapshotManifest) -> str:
    return json.dumps(
        {
            "format_version": m.format_version,
            "shard_id": m.shard_id,
            "replica_id": m.replica_id,
            "index": m.index,
            "term": m.term,
            "on_disk": m.on_disk,
            "chunk_size": m.chunk_size,
            "compression": int(m.compression),
            "membership": _membership_to_json(m.membership),
            "files": [
                {
                    "name": f.name,
                    "size": f.size,
                    "sha256": f.sha256,
                    "chunk_crcs": list(f.chunk_crcs),
                }
                for f in m.files
            ],
        },
        indent=2,
        sort_keys=True,
    )


def manifest_from_json(text: str) -> SnapshotManifest:
    try:
        d = json.loads(text)
    except ValueError as e:
        raise ArchiveError(f"manifest is not valid JSON: {e}")
    try:
        ver = int(d.get("format_version", 0))
        if ver != 1:
            raise ArchiveError(f"unsupported manifest format_version {ver}")
        return SnapshotManifest(
            format_version=ver,
            shard_id=int(d["shard_id"]),
            replica_id=int(d["replica_id"]),
            index=int(d["index"]),
            term=int(d["term"]),
            on_disk=bool(d.get("on_disk", False)),
            chunk_size=int(d["chunk_size"]),
            compression=CompressionType(int(d.get("compression", 0))),
            membership=_membership_from_json(d.get("membership", {})),
            files=tuple(
                ManifestFile(
                    name=f["name"],
                    size=int(f["size"]),
                    sha256=f["sha256"],
                    chunk_crcs=tuple(int(c) for c in f["chunk_crcs"]),
                )
                for f in d.get("files", ())
            ),
        )
    except ArchiveError:
        raise
    except (KeyError, TypeError, AttributeError, ValueError) as e:
        # a structurally malformed manifest (missing key, wrong shape —
        # a version-skewed or hand-edited archive) must surface through
        # the module's error contract, not a raw KeyError out of the
        # disaster-recovery import path
        raise ArchiveError(f"malformed manifest: {e!r}")


# ---------------------------------------------------------------------------
# streamed copy + checksum plumbing
# ---------------------------------------------------------------------------
def _copy_checksummed(
    src, dst_path: Optional[str], chunk_size: int
) -> Tuple[int, str, Tuple[int, ...]]:
    """Stream ``src`` (a readable file object) to ``dst_path`` (or just
    walk it when None), returning (size, sha256_hex, per-chunk crc32s).
    Bounded memory: one ``chunk_size`` slice in flight."""
    sha = hashlib.sha256()
    crcs = []
    size = 0
    out = open(dst_path, "wb") if dst_path is not None else None
    try:
        while True:
            piece = src.read(chunk_size)
            if not piece:
                break
            sha.update(piece)
            crcs.append(zlib.crc32(piece))
            size += len(piece)
            if out is not None:
                out.write(piece)
        if out is not None:
            out.flush()
            os.fsync(out.fileno())
    finally:
        if out is not None:
            out.close()
    return size, sha.hexdigest(), tuple(crcs)


def _verify_file(path: str, mf: ManifestFile, chunk_size: int) -> None:
    """Walk one archive file against its manifest record; bounded
    memory, corruption localized to a chunk index."""
    if not os.path.exists(path):
        raise ArchiveError(f"archive is missing {mf.name!r}")
    sha = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        for i, want in enumerate(mf.chunk_crcs):
            piece = f.read(chunk_size)
            if zlib.crc32(piece) != want:
                raise ArchiveError(
                    f"{mf.name!r}: chunk {i} checksum mismatch "
                    f"(archive corrupt at byte ~{i * chunk_size})"
                )
            sha.update(piece)
            size += len(piece)
        if f.read(1):
            raise ArchiveError(f"{mf.name!r}: trailing bytes past manifest")
    if size != mf.size:
        raise ArchiveError(
            f"{mf.name!r}: size {size} != manifest {mf.size}"
        )
    if sha.hexdigest() != mf.sha256:
        raise ArchiveError(f"{mf.name!r}: sha256 mismatch")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
def write_archive(
    storage, ss: Snapshot, export_dir: str, chunk_size: int = 0
) -> SnapshotManifest:
    """Stream the snapshot ``ss`` out of ``storage`` into a portable
    archive at ``export_dir``; returns the manifest.  Holds a storage
    GC lease for the duration so compaction cannot delete the snapshot
    dir mid-copy."""
    from ..storage.snapshotio import SnapshotReader
    from ..transport.wire import encode_snapshot_meta

    size = chunk_size or settings.Soft.snapshot_chunk_size
    os.makedirs(export_dir, exist_ok=True)
    files = []
    with storage.lease(ss.filepath):
        with storage.open_read(ss.filepath) as f:
            reader = SnapshotReader(f)  # validates meta + table sections
            externals = reader.external_files
            f.seek(0)
            n, sha, crcs = _copy_checksummed(
                f, os.path.join(export_dir, PAYLOAD_FILENAME), size
            )
        files.append(
            ManifestFile(
                name=PAYLOAD_FILENAME, size=n, sha256=sha, chunk_crcs=crcs
            )
        )
        for sf in externals:
            src = storage.external_path(ss.filepath, sf.filepath)
            with open(src, "rb") as ef:
                n, sha, crcs = _copy_checksummed(
                    ef, os.path.join(export_dir, sf.filepath), size
                )
            files.append(
                ManifestFile(
                    name=sf.filepath, size=n, sha256=sha, chunk_crcs=crcs
                )
            )
    manifest = SnapshotManifest(
        shard_id=ss.shard_id,
        replica_id=ss.replica_id,
        index=ss.index,
        term=ss.term,
        on_disk=reader.on_disk,
        chunk_size=size,
        compression=ss.compression,
        membership=ss.membership.copy(),
        files=tuple(files),
    )
    with open(os.path.join(export_dir, MANIFEST_FILENAME), "w") as f:
        f.write(manifest_to_json(manifest))
        f.flush()
        os.fsync(f.fileno())
    # legacy compat: pre-manifest import code reads META
    with open(os.path.join(export_dir, META_FILENAME), "wb") as f:
        f.write(encode_snapshot_meta(ss))
        f.flush()
        os.fsync(f.fileno())
    return manifest


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------
def read_manifest(export_dir: str) -> Optional[SnapshotManifest]:
    path = os.path.join(export_dir, MANIFEST_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path, "r") as f:
        # raftlint: ignore[stream-read] bounded metadata blob (~12 B/chunk)
        return manifest_from_json(f.read())


def verify_archive(export_dir: str) -> SnapshotManifest:
    """Checksum-walk every archive file against the manifest (bounded
    memory); raises ArchiveError with the corrupt chunk localized."""
    manifest = read_manifest(export_dir)
    if manifest is None:
        raise ArchiveError(f"no {MANIFEST_FILENAME} in {export_dir}")
    for mf in manifest.files:
        _verify_file(
            os.path.join(export_dir, os.path.basename(mf.name)),
            mf,
            manifest.chunk_size,
        )
    return manifest


def import_archive(
    nodehost,
    export_dir: str,
    shard_id: int,
    replica_id: int,
    members: Dict[int, str],
) -> Snapshot:
    """Seed ``nodehost`` with the archive under a rewritten membership,
    BEFORE start_replica for the shard (NodeHost.import_snapshot).

    Verification layers, all streamed: (1) manifest per-chunk crc32 +
    sha256 of every file (when a manifest is present — legacy META-only
    exports skip to (2)); (2) the v2 container's own per-section/block
    CRC walk; (3) external files present and sized per the container's
    table.  Only then is the payload copied into local snapshot storage
    and the logdb seeded."""
    from ..storage.snapshotio import SnapshotCorruptError, SnapshotReader
    from ..transport.wire import decode_snapshot_meta

    if replica_id not in members:
        raise ValueError(f"replica {replica_id} not in new membership")

    manifest = read_manifest(export_dir)
    if manifest is not None:
        if manifest.shard_id != shard_id:
            raise ArchiveError(
                f"archive is for shard {manifest.shard_id}, not {shard_id}"
            )
        for mf in manifest.files:
            _verify_file(
                os.path.join(export_dir, os.path.basename(mf.name)),
                mf,
                manifest.chunk_size,
            )
        index, term = manifest.index, manifest.term
        old_ccid = manifest.membership.config_change_id
        compression = manifest.compression
    else:
        # legacy export (META only): identity from the wire-encoded meta
        meta_path = os.path.join(export_dir, META_FILENAME)
        if not os.path.exists(meta_path):
            raise ArchiveError(
                f"{export_dir} has neither {MANIFEST_FILENAME} nor "
                f"{META_FILENAME}"
            )
        with open(meta_path, "rb") as f:
            # raftlint: ignore[stream-read] bounded metadata blob
            meta = decode_snapshot_meta(f.read())
        if meta.shard_id != shard_id:
            raise ArchiveError(
                f"archive is for shard {meta.shard_id}, not {shard_id}"
            )
        index, term = meta.index, meta.term
        old_ccid = meta.membership.config_change_id
        compression = meta.compression

    payload_path = os.path.join(export_dir, PAYLOAD_FILENAME)
    try:
        with open(payload_path, "rb") as f:
            reader = SnapshotReader(f)
            reader.validate()  # walks every sm block (bounded memory)
            externals = reader.external_files
    except FileNotFoundError:
        raise ArchiveError(f"{export_dir} is missing {PAYLOAD_FILENAME}")
    except SnapshotCorruptError as e:
        raise ArchiveError(f"corrupt snapshot container in {export_dir}: {e}")
    for sf in externals:
        if not os.path.exists(os.path.join(export_dir, sf.filepath)):
            raise ArchiveError(
                f"archive is missing external file {sf.filepath!r}"
            )

    storage = nodehost.snapshot_storage
    csize = (
        manifest.chunk_size if manifest is not None
        else settings.Soft.snapshot_chunk_size
    )

    def build(out, _copy_fn):
        with open(payload_path, "rb") as f:
            while True:
                piece = f.read(csize)
                if not piece:
                    break
                out.write(piece)

    path, _ = storage.save_stream(
        shard_id, replica_id, index, build, suffix="imported"
    )
    for sf in externals:
        with open(os.path.join(export_dir, sf.filepath), "rb") as src:
            _copy_checksummed(
                src, storage.external_path(path, sf.filepath), csize
            )

    new_membership = Membership(
        config_change_id=old_ccid + 1,
        addresses=dict(members),
    )
    ss = Snapshot(
        filepath=path,
        file_size=storage.file_size(path),
        index=index,
        term=term,
        membership=new_membership,
        shard_id=shard_id,
        replica_id=replica_id,
        imported=True,
        compression=compression,
    )
    nodehost.logdb.import_snapshot(ss, replica_id)
    return ss
