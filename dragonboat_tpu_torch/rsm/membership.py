"""Deterministic membership tracking applied through the raft log.

reference: internal/rsm/membership.go [U].  Every replica applies the same
config-change entries in the same order; validation must therefore be a
pure function of (membership, change) so accept/reject is identical
everywhere.  ``config_change_id`` is the index of the last applied config
change (used by ordered_config_change mode).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..pb import ConfigChange, ConfigChangeType, Membership
from ..logger import get_logger

_log = get_logger("rsm")


class MembershipManager:
    def __init__(self, shard_id: int, ordered: bool = False):
        self.shard_id = shard_id
        self.ordered = ordered
        self.membership = Membership()

    def set_initial(self, addresses, non_votings=None, witnesses=None) -> None:
        self.membership = Membership(
            config_change_id=0,
            addresses=dict(addresses or {}),
            non_votings=dict(non_votings or {}),
            witnesses=dict(witnesses or {}),
        )

    def restore(self, membership: Membership) -> None:
        self.membership = membership.copy()

    def is_empty(self) -> bool:
        return not self.membership.addresses and not self.membership.witnesses

    def _validate(self, cc: ConfigChange) -> bool:
        m = self.membership
        pid = cc.replica_id
        if pid == 0:
            return False
        if self.ordered and cc.config_change_id != m.config_change_id:
            _log.info(
                "shard %d: rejected config change, ccid %d != %d",
                self.shard_id,
                cc.config_change_id,
                m.config_change_id,
            )
            return False
        if cc.type == ConfigChangeType.ADD_REPLICA:
            if pid in m.removed or pid in m.witnesses:
                return False
            if pid in m.addresses:
                # re-adding with same address is a no-op accept; different
                # address is rejected (the reference rejects addr reuse)
                return m.addresses[pid] == cc.address
            if cc.address in m.addresses.values():
                return False
        elif cc.type == ConfigChangeType.ADD_NON_VOTING:
            if pid in m.removed or pid in m.addresses or pid in m.witnesses:
                return False
        elif cc.type == ConfigChangeType.ADD_WITNESS:
            if pid in m.removed or pid in m.addresses or pid in m.non_votings:
                return False
        elif cc.type == ConfigChangeType.REMOVE_REPLICA:
            if pid in m.removed:
                return False
            if (
                pid not in m.addresses
                and pid not in m.non_votings
                and pid not in m.witnesses
            ):
                return False
        return True

    def handle(self, cc: ConfigChange, entry_index: int) -> bool:
        """Apply one committed config change; returns accepted."""
        if not self._validate(cc):
            return False
        m = self.membership
        addresses = dict(m.addresses)
        non_votings = dict(m.non_votings)
        witnesses = dict(m.witnesses)
        removed = dict(m.removed)
        pid = cc.replica_id
        if cc.type == ConfigChangeType.ADD_REPLICA:
            non_votings.pop(pid, None)  # promotion
            addresses[pid] = cc.address
        elif cc.type == ConfigChangeType.ADD_NON_VOTING:
            non_votings[pid] = cc.address
        elif cc.type == ConfigChangeType.ADD_WITNESS:
            witnesses[pid] = cc.address
        elif cc.type == ConfigChangeType.REMOVE_REPLICA:
            addresses.pop(pid, None)
            non_votings.pop(pid, None)
            witnesses.pop(pid, None)
            removed[pid] = True
        self.membership = Membership(
            config_change_id=entry_index,
            addresses=addresses,
            non_votings=non_votings,
            witnesses=witnesses,
            removed=removed,
        )
        return True
