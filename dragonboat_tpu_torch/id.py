"""NodeHostID: a stable per-nodehost identity for the gossip registry.

reference: internal/id (uuid-based NodeHostID) [U].  Persisted in the
nodehost dir so a host keeps its identity across restarts even when its
raft address changes — that is the entire point of
``address_by_nodehost_id`` mode.
"""
from __future__ import annotations

import os
import uuid

_FILENAME = "NODEHOST.ID"
_PREFIX = "nhid-"


def new_nodehost_id() -> str:
    return _PREFIX + uuid.uuid4().hex


def is_nodehost_id(v: str) -> bool:
    return v.startswith(_PREFIX)


def get_nodehost_id(nodehost_dir: str) -> str:
    """Load-or-create the persistent NodeHostID for a nodehost dir."""
    os.makedirs(nodehost_dir, exist_ok=True)
    path = os.path.join(nodehost_dir, _FILENAME)
    try:
        with open(path, "r", encoding="utf-8") as f:
            v = f.read().strip()
        if is_nodehost_id(v):
            return v
    except FileNotFoundError:
        pass
    v = new_nodehost_id()
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(v)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return v
