"""Replica address resolution.

reference: internal/registry/registry.go (static Registry) [U].  Maps
(shard_id, replica_id) -> target address.  The gossip-based registry
(AddressByNodeHostID mode) plugs in behind the same resolve() interface.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..id import is_nodehost_id


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._addr: Dict[Tuple[int, int], str] = {}

    def add(self, shard_id: int, replica_id: int, address: str) -> None:
        with self._lock:
            self._addr[(shard_id, replica_id)] = address

    def learn(self, shard_id: int, replica_id: int, address: str) -> None:
        """Learn a sender's return address from observed traffic.  Unlike
        ``add`` this never replaces a NodeHostID mapping with a literal
        raft address — doing so would pin the peer to its current host
        and defeat the gossip indirection until the next membership sync."""
        with self._lock:
            cur = self._addr.get((shard_id, replica_id))
            if cur is not None and is_nodehost_id(cur):
                return
            self._addr[(shard_id, replica_id)] = address

    def remove(self, shard_id: int, replica_id: int) -> None:
        with self._lock:
            self._addr.pop((shard_id, replica_id), None)

    def remove_shard(self, shard_id: int) -> None:
        with self._lock:
            for k in [k for k in self._addr if k[0] == shard_id]:
                del self._addr[k]

    def resolve(self, shard_id: int, replica_id: int) -> Optional[str]:
        with self._lock:
            return self._addr.get((shard_id, replica_id))
