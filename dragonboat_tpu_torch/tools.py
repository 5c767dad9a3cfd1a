"""Disaster-recovery tools: snapshot export and import.

reference: tools/import.go (ImportSnapshot) and the exported-snapshot
flow of SyncRequestSnapshot [U].  The scenario: a shard has lost its
quorum permanently.  An exported snapshot from a surviving replica is
imported on fresh hosts with a REWRITTEN membership, and the shard
restarts from the snapshot with the new member set.

These are thin compatibility wrappers over :mod:`.bigstate.dr`, which
owns the archive format (MANIFEST.json with per-chunk checksums + the
legacy META, everything streamed with bounded memory — the old
whole-blob ``storage.load``/``f.read()`` path could not export a state
machine larger than RAM).  New code should prefer the NodeHost methods
``export_snapshot``/``import_snapshot``.

Export dir layout: see bigstate/dr.py (MANIFEST.json, META,
snapshot.bin, external-* siblings).
"""
from __future__ import annotations

from typing import Dict

from .bigstate.dr import (  # noqa: F401 — re-exported for callers
    MANIFEST_FILENAME,
    META_FILENAME,
    PAYLOAD_FILENAME,
    ArchiveError,
    import_archive,
    write_archive,
)
from .pb import Snapshot


def export_snapshot(nodehost, shard_id: int, export_dir: str) -> Snapshot:
    """Write the shard's most recent snapshot to ``export_dir``.

    Call ``nodehost.sync_request_snapshot(shard_id)`` first if the shard
    has never snapshotted (or use ``NodeHost.export_snapshot``, which
    snapshots the CURRENT applied state for you).
    """
    replica_id = nodehost._get_node(shard_id).replica_id
    ss = nodehost.logdb.get_snapshot(shard_id, replica_id)
    if ss.is_empty():
        raise ValueError(f"shard {shard_id} has no snapshot to export")
    write_archive(nodehost.snapshot_storage, ss, export_dir)
    return ss


def import_snapshot(
    nodehost,
    export_dir: str,
    shard_id: int,
    replica_id: int,
    members: Dict[int, str],
) -> Snapshot:
    """Seed ``nodehost`` with an exported snapshot under a rewritten
    membership, BEFORE start_replica for the shard.

    ``members`` is the complete new voter set (replica_id -> address)
    and MUST include ``replica_id`` itself; every listed replica must
    import the same snapshot with the same membership (reference:
    tools.ImportSnapshot preconditions [U]).
    """
    return import_archive(nodehost, export_dir, shard_id, replica_id, members)
