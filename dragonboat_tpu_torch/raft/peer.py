"""Peer: the synchronous driver wrapper around ``Raft`` (RawNode-equivalent).

reference: internal/raft/peer.go [U].  ``get_update() -> pb.Update`` is the
entire I/O contract between the pure core and the host runtime; the TPU
step kernel reproduces exactly this function over batched state.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..pb import (
    ConfigChange,
    Entry,
    EntryType,
    Message,
    MessageType,
    Snapshot,
    State,
    EMPTY_STATE,
    SystemCtx,
    Update,
    UpdateCommit,
)
from .log import ILogReader
from .raft import Raft


class PeerInfo:
    def __init__(self, replica_id: int, address: str):
        self.replica_id = replica_id
        self.address = address


class Peer:
    __slots__ = ("raft", "prev_state")
    def __init__(self, raft: Raft):
        self.raft = raft
        self.prev_state: State = raft.raft_state()

    @classmethod
    def launch(
        cls,
        config,
        log_reader: ILogReader,
        state: Optional[State],
        addresses: Dict[int, str],
        non_votings: Optional[Dict[int, str]] = None,
        witnesses: Optional[Dict[int, str]] = None,
        initial: bool = True,
        new_node: bool = True,
    ) -> "Peer":
        """reference: peer.Launch [U]."""
        r = Raft(
            shard_id=config.shard_id,
            replica_id=config.replica_id,
            peers=dict(addresses),
            non_votings=dict(non_votings or {}),
            witnesses=dict(witnesses or {}),
            election_timeout=config.election_rtt,
            heartbeat_timeout=config.heartbeat_rtt,
            check_quorum=config.check_quorum,
            pre_vote=config.pre_vote,
            log_reader=log_reader,
            state=state,
            is_non_voting=config.is_non_voting,
            is_witness=config.is_witness,
            max_in_mem_log_size=config.max_in_mem_log_size,
        )
        return cls(r)

    # -- inputs ----------------------------------------------------------
    def tick(self) -> None:
        self.raft.handle(Message(type=MessageType.LOCAL_TICK))

    def quiesced_tick(self) -> None:
        # advances logical time without election side effects
        self.raft.tick_count += 1

    def handle(self, m: Message) -> None:
        self.raft.handle(m)

    def propose_entries(self, entries: List[Entry]) -> None:
        self.raft.handle(
            Message(type=MessageType.PROPOSE, entries=tuple(entries))
        )

    def propose_config_change(self, cc: ConfigChange, key: int) -> None:
        # positional binary, never pickle: this cmd replicates to every
        # peer and is decoded from the wire (transport/wire.py)
        from ..transport.wire import encode_config_change

        payload = encode_config_change(cc)
        self.raft.handle(
            Message(
                type=MessageType.PROPOSE,
                entries=(
                    Entry(type=EntryType.CONFIG_CHANGE, key=key, cmd=payload),
                ),
            )
        )

    def apply_config_change(self, cc: ConfigChange) -> None:
        self.raft.apply_config_change(cc)

    def reject_config_change(self) -> None:
        self.raft.reject_config_change()

    def read_index(self, ctx: SystemCtx) -> None:
        self.raft.handle(
            Message(type=MessageType.READ_INDEX, hint=ctx.low, hint_high=ctx.high)
        )

    def request_leader_transfer(self, target: int) -> None:
        self.raft.handle(Message(type=MessageType.LEADER_TRANSFER, hint=target))

    def report_unreachable_node(self, replica_id: int) -> None:
        self.raft.handle(
            Message(type=MessageType.UNREACHABLE, from_=replica_id)
        )

    def report_snapshot_status(self, replica_id: int, rejected: bool) -> None:
        self.raft.handle(
            Message(
                type=MessageType.SNAPSHOT_STATUS, from_=replica_id, reject=rejected
            )
        )

    def notify_raft_last_applied(self, applied: int) -> None:
        self.raft.applied = applied

    # -- outputs ---------------------------------------------------------
    def has_update(self, more_to_apply: bool = True) -> bool:
        r = self.raft
        if not r.raft_state().is_empty() and r.raft_state() != self.prev_state:
            return True
        if not r.log.inmem.snapshot.is_empty():
            return True
        return bool(
            r.log.entries_to_save()
            or r.msgs
            or (more_to_apply and r.log.has_entries_to_apply())
            or r.ready_to_reads
            or r.dropped_entries
            or r.dropped_read_indexes
        )

    def get_update(self, more_to_apply: bool = True, last_applied: int = 0) -> Update:
        """reference: peer.GetUpdate -> pb.Update [U]."""
        r = self.raft
        u = Update(shard_id=r.shard_id, replica_id=r.replica_id)
        u.state = r.raft_state()
        u.entries_to_save = r.log.entries_to_save()
        if more_to_apply:
            u.committed_entries = r.log.entries_to_apply()
        u.messages = r.drain_messages()
        u.ready_to_reads = r.drain_ready_to_reads()
        de, dr = r.drain_dropped()
        u.dropped_entries = de
        u.dropped_read_indexes = dr
        u.last_applied = last_applied
        if not r.log.inmem.snapshot.is_empty():
            u.snapshot = r.log.inmem.snapshot
        u.has_update = True
        u.update_commit = self._get_update_commit(u)
        return u

    def _get_update_commit(self, u: Update) -> UpdateCommit:
        uc = UpdateCommit(last_applied=u.last_applied)
        if u.committed_entries:
            uc = UpdateCommit(
                processed=u.committed_entries[-1].index,
                last_applied=u.last_applied,
            )
        if u.entries_to_save:
            uc = UpdateCommit(
                processed=uc.processed,
                last_applied=uc.last_applied,
                stable_log_index=u.entries_to_save[-1].index,
                stable_log_term=u.entries_to_save[-1].term,
            )
        if not u.snapshot.is_empty():
            uc = UpdateCommit(
                processed=max(uc.processed, u.snapshot.index),
                last_applied=uc.last_applied,
                stable_log_index=uc.stable_log_index,
                stable_log_term=uc.stable_log_term,
                stable_snapshot_index=u.snapshot.index,
            )
        return uc

    def commit(self, u: Update) -> None:
        """Advance cursors after the host has persisted/dispatched ``u``
        (reference: peer.Commit [U])."""
        self.prev_state = u.state
        self.raft.log.commit_update(u.update_commit)

    # -- introspection ----------------------------------------------------
    def leader_id(self) -> int:
        return self.raft.leader_id

    def is_leader(self) -> bool:
        return self.raft.is_leader()

    def term(self) -> int:
        return self.raft.term

    def committed(self) -> int:
        return self.raft.log.committed

    def has_entries_to_apply(self) -> bool:
        return self.raft.log.has_entries_to_apply()
