"""The raft protocol state machine — pure, deterministic, no I/O.

reference: internal/raft/raft.go [U] (which itself descends from etcd-raft;
the etcd-style protocol test suite in tests/test_raft_*.py is the parity
oracle for the vectorized TPU kernel in dragonboat_tpu/ops).

Determinism: election-timeout randomization uses a counter-based splitmix64
hash of (shard_id, replica_id, term, reset_seq) — no global RNG — so a
trace replayed against the device kernel produces bit-identical behavior
(SURVEY.md §7 "Bit-exact parity").
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Tuple

from .. import settings
from ..logger import get_logger
from ..pb import (
    ConfigChange,
    ConfigChangeType,
    Entry,
    EntryType,
    Membership,
    Message,
    MessageType,
    NO_LEADER,
    NO_NODE,
    ReadyToRead,
    Snapshot,
    State,
    SystemCtx,
)
from .log import EntryLog, ILogReader, LogCompactedError, LogUnavailableError
from .read_index import ReadIndex
from .remote import Remote, RemoteState

_log = get_logger("raft")


class RaftRole(enum.IntEnum):
    """Role encoding — values are part of the device SoA layout."""

    FOLLOWER = 0
    PRE_CANDIDATE = 1
    CANDIDATE = 2
    LEADER = 3
    NON_VOTING = 4
    WITNESS = 5


def splitmix32(x: int) -> int:
    """Counter-based deterministic 32-bit hash (murmur3 finalizer over a
    Weyl-incremented counter); identical formula on device
    (ops/kernel.py) — this is what makes election jitter replayable.
    32-bit on purpose: TPUs have no native int64 and the device kernel
    runs entirely in int32/uint32 lanes."""
    x = (x + 0x9E3779B9) & 0xFFFFFFFF
    z = x
    z ^= z >> 16
    z = (z * 0x85EBCA6B) & 0xFFFFFFFF
    z ^= z >> 13
    z = (z * 0xC2B2AE35) & 0xFFFFFFFF
    z ^= z >> 16
    return z


def election_jitter(shard_id: int, replica_id: int, seq: int, span: int) -> int:
    """Deterministic jitter in [0, span)."""
    h = splitmix32(((shard_id << 24) ^ (replica_id << 8) ^ seq) & 0xFFFFFFFF)
    return h % span


class Raft:
    """One raft replica's protocol state (reference: raft struct [U])."""

    # __slots__: tens of thousands of replicas per host — the instance
    # dict is pure overhead at that scale.  The last two slots are the
    # vector engine's residency-boundary markers (ops/engine.py sets
    # them with setattr; declared here so slots allow it).
    __slots__ = (
        "shard_id", "replica_id", "election_timeout", "heartbeat_timeout",
        "check_quorum", "pre_vote", "max_entries_per_replicate",
        "max_replicate_bytes", "max_in_mem_log_size", "term", "vote",
        "leader_id", "log", "remotes", "non_votings", "witnesses",
        "addresses", "role", "votes", "msgs", "ready_to_reads",
        "dropped_entries", "dropped_read_indexes", "read_index",
        "forwarded_reads", "leader_commit_hint",
        "election_tick", "heartbeat_tick", "randomized_election_timeout",
        "_timeout_seq", "leader_transfer_target", "pending_config_change",
        "is_leader_transfer_target", "snapshotting", "tick_count",
        "applied", "launched_non_voting", "launched_witness",
        "_cq_grace_at", "_term_lim_warned", "_campaign_sent_tick",
        "_boot_lease_grace",
    )

    def __init__(
        self,
        shard_id: int,
        replica_id: int,
        peers: Dict[int, str],
        non_votings: Optional[Dict[int, str]] = None,
        witnesses: Optional[Dict[int, str]] = None,
        election_timeout: int = 10,
        heartbeat_timeout: int = 1,
        check_quorum: bool = False,
        pre_vote: bool = False,
        log_reader: Optional[ILogReader] = None,
        state: Optional[State] = None,
        is_non_voting: bool = False,
        is_witness: bool = False,
        max_entries_per_replicate: Optional[int] = None,
        max_in_mem_log_size: int = 0,
    ):
        from .log import InMemLogReader

        self.shard_id = shard_id
        self.replica_id = replica_id
        self.election_timeout = election_timeout
        self.heartbeat_timeout = heartbeat_timeout
        self.check_quorum = check_quorum
        self.pre_vote = pre_vote
        self.max_entries_per_replicate = (
            max_entries_per_replicate
            if max_entries_per_replicate is not None
            else settings.Soft.max_entries_per_replicate
        )
        self.max_replicate_bytes = settings.Soft.max_replicate_bytes
        self.max_in_mem_log_size = max_in_mem_log_size

        self.term = 0
        self.vote = NO_NODE
        self.leader_id = NO_LEADER
        self.log = EntryLog(log_reader if log_reader is not None else InMemLogReader())

        self.remotes: Dict[int, Remote] = {}
        self.non_votings: Dict[int, Remote] = {}
        self.witnesses: Dict[int, Remote] = {}
        self.addresses: Dict[int, str] = {}

        self.role = RaftRole.FOLLOWER
        self.votes: Dict[int, bool] = {}
        self.msgs: List[Message] = []
        self.ready_to_reads: List[ReadyToRead] = []
        self.dropped_entries: List[Entry] = []
        self.dropped_read_indexes: List[SystemCtx] = []
        self.read_index = ReadIndex()
        # follower-side ReadIndex forwarding ledger: ctx key -> the
        # leader the confirmation round was sent to.  The readplane's
        # follower-linearizable path depends on a LEADERSHIP-CHANGE
        # ABORT: a confirmation obtained from a deposed leader must
        # never serve a read after a new leader may have committed past
        # it, so any leader change (new leader observed, leaderless
        # window, own candidacy) fails these ctxs fast via
        # dropped_read_indexes instead of leaving them to deadline GC
        # (docs/READPLANE.md "Follower-read safety").
        self.forwarded_reads: Dict[Tuple[int, int], int] = {}
        # the leader's commit index as LAST HEARD, uncapped — the
        # follower's own log.committed is min'd with its last index, so
        # a catching-up replica's local commit understates how far
        # behind its state is.  BOUNDED_STALENESS serving requires
        # applied >= this hint: fresh heartbeats alone must not let a
        # recovering follower serve months-old state as "bounded"
        # (docs/READPLANE.md).  Monotone per leadership; _reset floors
        # it back to the local commit.
        self.leader_commit_hint = 0

        self.election_tick = 0
        self.heartbeat_tick = 0
        self.randomized_election_timeout = election_timeout
        self._timeout_seq = 0

        self.leader_transfer_target = NO_NODE
        self.pending_config_change = False
        self.is_leader_transfer_target = False
        self.snapshotting = False
        self.tick_count = 0
        # applied index as reported by the RSM; used to gate config change
        self.applied = 0

        for pid, addr in (peers or {}).items():
            self.remotes[pid] = Remote(next=1)
            self.addresses[pid] = addr
        for pid, addr in (non_votings or {}).items():
            self.non_votings[pid] = Remote(next=1)
            self.addresses[pid] = addr
        for pid, addr in (witnesses or {}).items():
            self.witnesses[pid] = Remote(next=1)
            self.addresses[pid] = addr

        self.launched_non_voting = is_non_voting
        self.launched_witness = is_witness
        if is_non_voting:
            self.role = RaftRole.NON_VOTING
        elif is_witness:
            self.role = RaftRole.WITNESS

        if state is not None and not state.is_empty():
            self.term = state.term
            self.vote = state.vote
            self.log.committed = state.commit

        # tick at which the current (real) campaign's vote requests were
        # sent: the become_leader lease seed — granters reset their
        # election clocks no earlier than this (-1 = never campaigned)
        self._campaign_sent_tick = -1
        # restart hole in the vote-refusal lease (review finding):
        # leader_id is volatile, so a crash-restarted voter would grant
        # votes IMMEDIATELY even though, pre-crash, it refused them
        # inside a live leader's lease window — a challenger elected
        # through such votes breaks the leader's lease-read safety
        # argument.  A restored voter therefore refuses non-transfer
        # votes for its first election window (it cannot know how
        # recently it heard from a leader; one window over-covers).
        self._boot_lease_grace = (
            self.election_timeout
            if check_quorum and state is not None and not state.is_empty()
            else 0
        )

        self._reset_randomized_timeout()

    # ------------------------------------------------------------------
    # basic predicates
    # ------------------------------------------------------------------
    def is_leader(self) -> bool:
        return self.role == RaftRole.LEADER

    def is_follower(self) -> bool:
        return self.role == RaftRole.FOLLOWER

    def is_candidate(self) -> bool:
        return self.role == RaftRole.CANDIDATE

    def is_pre_candidate(self) -> bool:
        return self.role == RaftRole.PRE_CANDIDATE

    def is_non_voting(self) -> bool:
        return self.role == RaftRole.NON_VOTING

    def is_witness(self) -> bool:
        return self.role == RaftRole.WITNESS

    def is_self_removed(self) -> bool:
        return (
            self.replica_id not in self.remotes
            and self.replica_id not in self.non_votings
            and self.replica_id not in self.witnesses
        )

    def voting_members(self) -> Dict[int, Remote]:
        out = dict(self.remotes)
        out.update(self.witnesses)
        return out

    def quorum(self) -> int:
        return len(self.voting_members()) // 2 + 1

    def is_single_voter(self) -> bool:
        vm = self.voting_members()
        return len(vm) == 1 and self.replica_id in vm

    def all_remotes(self) -> Dict[int, Remote]:
        out = dict(self.remotes)
        out.update(self.non_votings)
        out.update(self.witnesses)
        return out

    def catching_up_peers(self) -> bool:
        """Leader-side: any peer whose match is still behind our log —
        used to BLOCK quiesce entry (entering quiesce mid-catch-up
        strands the follower: nobody generates the activity that would
        exit it).  reference: quiesce is activity-based in quiesce.go
        [U]; an active catch-up generates that activity there, but a
        stalled one must not idle the shard out here either."""
        if self.role != RaftRole.LEADER:
            return False
        last = self.log.last_index()
        for group in (self.remotes, self.non_votings, self.witnesses):
            for pid, rm in group.items():
                if pid != self.replica_id and rm.match < last:
                    return True
        return False

    def get_remote(self, replica_id: int) -> Optional[Remote]:
        r = self.remotes.get(replica_id)
        if r is None:
            r = self.non_votings.get(replica_id)
        if r is None:
            r = self.witnesses.get(replica_id)
        return r

    def rate_limited(self) -> bool:
        """In-mem log window above MaxInMemLogSize: new proposals should
        be refused with SystemBusy until apply/persist drains the window
        (reference: rate limiter + ErrSystemBusy [U])."""
        return (
            self.max_in_mem_log_size > 0
            and self.log.inmem.bytes > self.max_in_mem_log_size
        )

    def raft_state(self) -> State:
        return State(term=self.term, vote=self.vote, commit=self.log.committed)

    def committed_entry_in_current_term(self) -> bool:
        try:
            return self.log.term(self.log.committed) == self.term
        except (LogCompactedError, LogUnavailableError):
            return False

    # ------------------------------------------------------------------
    # time
    # ------------------------------------------------------------------
    def _reset_randomized_timeout(self) -> None:
        self._timeout_seq += 1
        self.randomized_election_timeout = self.election_timeout + election_jitter(
            self.shard_id, self.replica_id, self._timeout_seq, self.election_timeout
        )

    def time_for_election(self) -> bool:
        return self.election_tick >= self.randomized_election_timeout

    def tick(self) -> None:
        self.tick_count += 1
        if self.role == RaftRole.LEADER:
            self._leader_tick()
        else:
            self._nonleader_tick()

    def _leader_tick(self) -> None:
        self.election_tick += 1
        self.heartbeat_tick += 1
        if self.election_tick >= self.election_timeout:
            self.election_tick = 0
            if self.check_quorum:
                self.handle(Message(type=MessageType.CHECK_QUORUM))
                if self.role != RaftRole.LEADER:
                    # check-quorum stepped us down: no heartbeats at this term
                    return
            if self.leader_transfer_target != NO_NODE:
                # transfer did not complete within one election timeout
                self._abort_leader_transfer()
        if self.heartbeat_tick >= self.heartbeat_timeout:
            self.heartbeat_tick = 0
            self.broadcast_heartbeat()

    def _nonleader_tick(self) -> None:
        self.election_tick += 1
        if self.role in (RaftRole.NON_VOTING, RaftRole.WITNESS):
            if self.check_quorum and self.time_for_election():
                # probe whether the leader is still around
                self.election_tick = 0
                self._reset_randomized_timeout()
            return
        if self.time_for_election():
            self.election_tick = 0
            self.handle(Message(type=MessageType.ELECTION))

    # ------------------------------------------------------------------
    # role transitions
    # ------------------------------------------------------------------
    def _reset(self, term: int, keep_vote_on_same_term: bool = True) -> None:
        if self.term != term:
            self.term = term
            self.vote = NO_NODE
        self.leader_id = NO_LEADER
        self.election_tick = 0
        self.heartbeat_tick = 0
        self._reset_randomized_timeout()
        self.votes = {}
        self.leader_transfer_target = NO_NODE
        self.is_leader_transfer_target = False
        self.pending_config_change = False
        self.read_index.clear()
        self.drop_pending_read_indexes()
        self.leader_commit_hint = self.log.committed
        last = self.log.last_index()
        for pid, rm in self.all_remotes().items():
            rm.reset(last + 1)
            if pid == self.replica_id:
                rm.match = last

    def become_follower(self, term: int, leader_id: int) -> None:
        # a replica that joined with empty membership must keep its
        # configured tier until the config-change entry applies — a
        # "follower" window would let a witness campaign
        in_any = (
            self.replica_id in self.remotes
            or self.replica_id in self.non_votings
            or self.replica_id in self.witnesses
        )
        restore_role = (
            RaftRole.NON_VOTING
            if self.replica_id in self.non_votings
            or (not in_any and self.launched_non_voting)
            else RaftRole.WITNESS
            if self.replica_id in self.witnesses
            or (not in_any and self.launched_witness)
            else RaftRole.FOLLOWER
        )
        self.role = restore_role
        self._reset(term)
        self.leader_id = leader_id

    def become_pre_candidate(self) -> None:
        if self.role in (RaftRole.LEADER, RaftRole.NON_VOTING, RaftRole.WITNESS):
            raise RuntimeError(f"invalid pre-candidate transition from {self.role}")
        # prevote does not change term or vote
        role_term = self.term
        self.role = RaftRole.PRE_CANDIDATE
        self.votes = {}
        self.leader_id = NO_LEADER
        # prevote skips _reset, so the forwarded-read abort must fire
        # here: the election timeout that made us a pre-candidate is
        # exactly the "leader may be gone" signal the readplane's
        # follower-linearizable path must not read through
        self.drop_pending_read_indexes()
        self.election_tick = 0
        self._reset_randomized_timeout()
        assert self.term == role_term

    def become_candidate(self) -> None:
        if self.role in (RaftRole.LEADER, RaftRole.NON_VOTING, RaftRole.WITNESS):
            raise RuntimeError(f"invalid candidate transition from {self.role}")
        self.role = RaftRole.CANDIDATE
        self._reset(self.term + 1)
        self.vote = self.replica_id
        self.votes = {self.replica_id: True}

    def become_leader(self) -> None:
        if self.role not in (RaftRole.CANDIDATE, RaftRole.PRE_CANDIDATE, RaftRole.LEADER):
            raise RuntimeError(f"invalid leader transition from {self.role}")
        self.role = RaftRole.LEADER
        self._reset(self.term)
        self.leader_id = self.replica_id
        # a fresh leader starts with a FULL activity window (reference:
        # etcd-raft sets RecentActive=true at becomeLeader): the first
        # CheckQuorum otherwise races the first ack round-trip — under
        # the fused-tick engine a whole election window can elapse in
        # two launches, exactly one ack round-trip, and a hair-trigger
        # first check deposed every new leader forever
        # lease seed: anchor at the CAMPAIGN SEND tick, not the current
        # tick — the vote grants that elected us reset the granters'
        # election clocks at grant time, which is no earlier than the
        # vote-request send (anchoring at become_leader time would
        # overclaim by the whole vote round trip; review finding)
        seed = (
            self._campaign_sent_tick
            if self._campaign_sent_tick >= 0
            else self.tick_count if self.is_single_voter() else -1
        )
        for rm in self.all_remotes().values():
            rm.set_active()
            rm.last_resp_tick = max(rm.last_resp_tick, seed)
            rm.probe_queue.clear()  # fresh leadership, fresh probes
        self._compute_pending_config_change()
        # commit barrier: append an empty entry at the new term
        self._append_entries([Entry(type=EntryType.APPLICATION, cmd=b"")])
        _log.info(
            "[%d:%d] became leader term %d", self.shard_id, self.replica_id, self.term
        )

    def _compute_pending_config_change(self) -> None:
        """Scan uncommitted tail for in-flight config changes
        (reference: raft.getPendingConfigChangeCount [U])."""
        self.pending_config_change = False
        lo = self.log.committed + 1
        hi = self.log.last_index() + 1
        if lo >= hi:
            return
        try:
            for e in self.log._get_entries(lo, hi, 2**63):
                if e.type == EntryType.CONFIG_CHANGE:
                    self.pending_config_change = True
                    return
        except (LogCompactedError, LogUnavailableError):
            pass

    # ------------------------------------------------------------------
    # log append / commit
    # ------------------------------------------------------------------
    def _append_entries(self, entries: List[Entry]) -> None:
        last = self.log.last_index()
        stamped = []
        for i, e in enumerate(entries):
            stamped.append(
                Entry(
                    term=self.term,
                    index=last + 1 + i,
                    type=e.type,
                    key=e.key,
                    client_id=e.client_id,
                    series_id=e.series_id,
                    responded_to=e.responded_to,
                    cmd=e.cmd,
                )
            )
        self.log.append(stamped)
        me = self.get_remote(self.replica_id)
        if me is not None:
            me.try_update(self.log.last_index())
        if self.is_single_voter():
            self.try_commit()

    def try_commit(self) -> bool:
        """Quorum commit: sorted matchIndex reduction; commit only entries
        of the current term (reference: raft.tryCommit [U])."""
        matched = sorted(r.match for r in self.voting_members().values())
        qidx = matched[len(matched) - self.quorum()]
        if qidx <= self.log.committed:
            return False
        if not self.log.match_term(qidx, self.term):
            return False  # current-term-only commit rule
        self.log.commit_to(qidx)
        return True

    # ------------------------------------------------------------------
    # message send helpers
    # ------------------------------------------------------------------
    def _send(self, m: Message) -> None:
        m = Message(
            type=m.type,
            to=m.to,
            from_=self.replica_id,
            shard_id=self.shard_id,
            term=m.term if m.term else self.term,
            log_term=m.log_term,
            log_index=m.log_index,
            commit=m.commit,
            reject=m.reject,
            hint=m.hint,
            hint_high=m.hint_high,
            entries=m.entries,
            snapshot=m.snapshot,
        )
        self.msgs.append(m)

    # probe_queue bound: past this many unanswered probes, arms are
    # skipped (pops then anchor even older — the safe direction)
    _LEASE_PROBE_QUEUE_CAP = 128

    def _arm_lease_probe(self, rm) -> None:
        """A heartbeat/replicate to this peer is a lease probe: queue
        its send tick (FIFO; see Remote.last_resp_tick for the full
        anchoring contract and why the queue is never cleared)."""
        if len(rm.probe_queue) < self._LEASE_PROBE_QUEUE_CAP:
            rm.probe_queue.append(self.tick_count)

    def _anchor_lease_resp(self, rm) -> None:
        """A response proves contact no later than the answered probe's
        send (the follower's election clock reset at its receipt, which
        is >= that send under bounded skew).  Pop the FIFO head: the
        answered probe's send tick, or older when earlier probes or
        responses were lost — conservative either way.  Empty queue =>
        no anchor update — NEVER anchor at response receipt (review
        findings: receipt can lag the probe by unbounded queueing, and
        a cleared-then-re-armed slot mis-anchored a delayed response at
        a probe sent after it)."""
        if not rm.probe_queue:
            return
        probe = rm.probe_queue.pop(0)
        if probe > rm.last_resp_tick:
            rm.last_resp_tick = probe

    def broadcast_heartbeat(self, ctx: Optional[SystemCtx] = None) -> None:
        if ctx is None:
            ctx = self.read_index.peek_ctx()
        for pid, rm in sorted(self.all_remotes().items()):
            if pid == self.replica_id:
                continue
            self._arm_lease_probe(rm)
            self._send(
                Message(
                    type=MessageType.HEARTBEAT,
                    to=pid,
                    commit=min(rm.match, self.log.committed),
                    # log_index is unused by HEARTBEAT handling proper:
                    # it carries the UNCAPPED commit as an advisory for
                    # the follower's leader_commit_hint (the capped
                    # commit above understates for a behind follower,
                    # which would let its bounded reads serve stale
                    # state as fresh).  Never fed to commit_to.
                    log_index=self.log.committed,
                    hint=ctx.low if ctx else 0,
                    hint_high=ctx.high if ctx else 0,
                )
            )

    def broadcast_replicate(self) -> None:
        for pid in sorted(self.all_remotes().keys()):
            if pid == self.replica_id:
                continue
            self.send_replicate(pid)

    def send_replicate(self, to: int) -> None:
        rm = self.get_remote(to)
        if rm is None or rm.is_paused():
            return
        is_witness_target = to in self.witnesses
        next_i = rm.next
        try:
            prev_term = self.log.term(next_i - 1)
            entries = self.log.entries(next_i, self.max_replicate_bytes)
            if len(entries) > self.max_entries_per_replicate:
                entries = entries[: self.max_entries_per_replicate]
            if is_witness_target:
                entries = [self._to_witness_entry(e) for e in entries]
        except (LogCompactedError, LogUnavailableError):
            self._send_snapshot(to, rm)
            return
        self._arm_lease_probe(rm)
        self._send(
            Message(
                type=MessageType.REPLICATE,
                to=to,
                log_index=next_i - 1,
                log_term=prev_term,
                entries=tuple(entries),
                commit=self.log.committed,
            )
        )
        if entries:
            rm.progress(entries[-1].index)

    @staticmethod
    def _to_witness_entry(e: Entry) -> Entry:
        """Witnesses replicate metadata only (reference: witness handling in
        raft.go makeMetadataEntry [U])."""
        if e.type == EntryType.CONFIG_CHANGE:
            return e  # config changes are needed for membership tracking
        return Entry(term=e.term, index=e.index, type=EntryType.METADATA)

    def _send_snapshot(self, to: int, rm: Remote) -> None:
        ss = self.log.logdb.snapshot()
        if ss.is_empty():
            # nothing to send yet (snapshot still being produced); retry
            # later.  NO lease probe armed on this branch: nothing was
            # sent, so nothing will respond, and a phantom probe_queue
            # entry would shift every later anchor one probe older for
            # the rest of the leadership (review finding — the lease
            # would decay spuriously on shards with lagging followers)
            rm.become_wait()
            return
        if to in self.witnesses:
            ss = Snapshot(
                index=ss.index,
                term=ss.term,
                membership=ss.membership,
                dummy=True,
                witness=True,
                shard_id=self.shard_id,
            )
        # a snapshot send is a lease probe too: the follower answers it
        # with REPLICATE_RESP, and an un-armed send would let that
        # response pop a LATER probe's tick off the FIFO — shifting
        # subsequent anchors one probe too NEW (review finding)
        self._arm_lease_probe(rm)
        self._send(Message(type=MessageType.INSTALL_SNAPSHOT, to=to, snapshot=ss))
        rm.become_snapshot(ss.index)

    # ------------------------------------------------------------------
    # elections
    # ------------------------------------------------------------------
    def campaign(self, pre: bool, transfer: bool = False) -> None:
        if pre:
            self.become_pre_candidate()
            term = self.term + 1
            self.votes = {self.replica_id: True}
            if self._vote_quorum():
                # single-voter: skip straight to the real campaign
                self.campaign(pre=False, transfer=transfer)
                return
            mt = MessageType.REQUEST_PREVOTE
        else:
            # lease seed anchor: vote requests go out at THIS tick, so
            # any granter's election clock resets no earlier than it
            self._campaign_sent_tick = self.tick_count
            self.become_candidate()
            term = self.term
            if self._vote_quorum():
                self.become_leader()
                return
            mt = MessageType.REQUEST_VOTE
        for pid in sorted(self.voting_members().keys()):
            if pid == self.replica_id:
                continue
            self._send(
                Message(
                    type=mt,
                    to=pid,
                    term=term,
                    log_index=self.log.last_index(),
                    log_term=self.log.last_term(),
                    hint=self.replica_id if transfer else 0,
                )
            )

    def _vote_quorum(self) -> bool:
        granted = sum(1 for v in self.votes.values() if v)
        return granted >= self.quorum()

    def _vote_rejected(self) -> bool:
        rejected = sum(1 for v in self.votes.values() if not v)
        return rejected >= self.quorum()

    def _can_grant_vote(self, m: Message) -> bool:
        return (
            self.vote == NO_NODE
            or self.vote == m.from_
            or (m.type == MessageType.REQUEST_PREVOTE and m.term > self.term)
        )

    def _in_lease(self) -> bool:
        """CheckQuorum leader lease: reject votes while a live leader is
        known and the election timeout has not elapsed — and for the
        first election window after a restart from persisted state
        (``_boot_lease_grace``): leader_id does not survive restarts,
        so a rebooted voter must assume it was inside some leader's
        lease when it crashed."""
        if not self.check_quorum:
            return False
        if self.tick_count < self._boot_lease_grace:
            return True
        return (
            self.leader_id != NO_LEADER
            and self.election_tick < self.election_timeout
        )

    def anchor_quorum_evidence(self, tick: int) -> None:
        """Device-plane lease evidence (ROADMAP 4b): the engine proved
        a quorum of voter lanes active since ``tick`` (the device
        CheckQuorum window start — ops/hostplane.LeaseLanes), so raise
        every voting remote's ``last_resp_tick`` floor to it.  Raising
        ALL voters is exact for the lease: ``quorum_responded_tick``
        takes the quorum-th freshest, which becomes >= ``tick`` — the
        literal claim the device evidence makes — and monotone max
        keeps any fresher scalar-path probe anchors intact."""
        if self.role != RaftRole.LEADER:
            return
        for pid, rm in self.voting_members().items():
            if pid == self.replica_id:
                continue
            if tick > rm.last_resp_tick:
                rm.last_resp_tick = tick

    def quorum_responded_tick(self) -> int:
        """LEADER side of the lease (gateway lease reads): the most
        recent tick by which a QUORUM of voters (self included) had
        responded — the quorum-th freshest ``last_resp_tick``.  Every
        responder's own election clock was reset by the leader traffic
        it was responding to, so no challenger can win its vote for one
        election window past (roughly) that tick; the margin callers
        keep absorbs the cross-host tick skew (docs/GATEWAY.md
        "Lease-read safety").  -1 = no quorum evidence yet."""
        if self.role != RaftRole.LEADER:
            return -1
        vm = self.voting_members()
        if self.replica_id not in vm:
            # removed from the voter set but not yet stepped down: self
            # no longer counts toward the quorum, and the REMAINING
            # voters form a full quorum that can elect a challenger at
            # any time — no lease (review finding)
            return -1
        need = self.quorum() - 1  # self responds implicitly
        if need <= 0:
            return self.tick_count  # single-voter shard
        ticks = sorted(
            (
                rm.last_resp_tick
                for pid, rm in vm.items()
                if pid != self.replica_id
            ),
            reverse=True,
        )
        if len(ticks) < need:
            return -1
        return ticks[need - 1]

    def lease_remaining_ticks(self) -> int:
        """Ticks of leader lease left (0 when not leader / no
        CheckQuorum / no quorum evidence): one election window past the
        last quorum-responded tick.  A leader TRANSFER in flight also
        zeroes the lease: transfer votes (hint != 0) bypass the vote-
        refusal lease by design, so the target can be elected well
        inside the claimed window (review finding)."""
        if not self.check_quorum or self.role != RaftRole.LEADER:
            return 0
        if self.leader_transfer_target != NO_NODE:
            return 0
        base = self.quorum_responded_tick()
        if base < 0:
            return 0
        return max(0, base + self.election_timeout - self.tick_count)

    # ------------------------------------------------------------------
    # Step: the single entry point
    # ------------------------------------------------------------------
    def handle(self, m: Message) -> None:
        """Process one message (reference: raft.Handle/Step [U])."""
        if m.type == MessageType.LOCAL_TICK:
            self.tick()
            return
        if not self._on_message_term(m):
            return
        self._step(m)

    def _on_message_term(self, m: Message) -> bool:
        """Term comparison gate (reference: raft.onMessageTermNotMatched /
        etcd Step() term logic [U]).  Returns False if m is dropped."""
        if m.term == 0:
            return True  # local message
        if m.term > self.term:
            if m.type in (MessageType.REQUEST_VOTE, MessageType.REQUEST_PREVOTE):
                if self._in_lease() and m.hint == 0:
                    _log.info(
                        "[%d:%d] lease active, ignoring %s from %d at term %d",
                        self.shard_id,
                        self.replica_id,
                        m.type.name,
                        m.from_,
                        m.term,
                    )
                    return False
            if m.type == MessageType.REQUEST_PREVOTE:
                pass  # never change term on a prevote request
            elif m.type == MessageType.REQUEST_PREVOTE_RESP and not m.reject:
                pass  # winning a prevote at a future term; campaign handles it
            else:
                leader = m.from_ if m.is_leader_message() else NO_LEADER
                self.become_follower(m.term, leader)
            return True
        if m.term < self.term:
            if m.type in (
                MessageType.REPLICATE,
                MessageType.HEARTBEAT,
                MessageType.INSTALL_SNAPSHOT,
            ) and (self.check_quorum or self.pre_vote):
                # un-stick a deposed leader partitioned away: our higher term
                # in this response forces it to step down
                self._send(Message(type=MessageType.REPLICATE_RESP, to=m.from_))
            elif m.type == MessageType.REQUEST_PREVOTE:
                self._send(
                    Message(
                        type=MessageType.REQUEST_PREVOTE_RESP,
                        to=m.from_,
                        reject=True,
                        term=self.term,
                    )
                )
            return False
        return True

    def _step(self, m: Message) -> None:
        # local messages valid in any role
        if m.type == MessageType.ELECTION:
            self._handle_election(m)
            return
        if m.type == MessageType.REQUEST_VOTE:
            self._handle_request_vote(m)
            return
        if m.type == MessageType.REQUEST_PREVOTE:
            self._handle_request_prevote(m)
            return
        if self.role == RaftRole.LEADER:
            self._step_leader(m)
        elif self.role in (RaftRole.CANDIDATE, RaftRole.PRE_CANDIDATE):
            self._step_candidate(m)
        else:
            self._step_follower(m)

    # -- elections / votes ----------------------------------------------
    def _handle_election(self, m: Message) -> None:
        if self.role == RaftRole.LEADER:
            return
        if self.role in (RaftRole.NON_VOTING, RaftRole.WITNESS):
            return
        if self.replica_id not in self.remotes:
            return  # removed from membership
        transfer = m.hint == self.replica_id
        if not transfer and not self._has_config_applied():
            # avoid campaigning before the initial membership is applied
            pass
        if self.pre_vote and not transfer:
            self.campaign(pre=True, transfer=False)
        else:
            self.campaign(pre=False, transfer=transfer)

    def _has_config_applied(self) -> bool:
        return True

    def _handle_request_vote(self, m: Message) -> None:
        # witness may vote; non-voting may not
        if self.role == RaftRole.NON_VOTING:
            return
        up_to_date = self.log.up_to_date(m.log_index, m.log_term)
        grant = self._can_grant_vote(m) and up_to_date
        if grant:
            self.election_tick = 0
            self.vote = m.from_
        self._send(
            Message(
                type=MessageType.REQUEST_VOTE_RESP,
                to=m.from_,
                reject=not grant,
            )
        )

    def _handle_request_prevote(self, m: Message) -> None:
        if self.role == RaftRole.NON_VOTING:
            return
        up_to_date = self.log.up_to_date(m.log_index, m.log_term)
        grant = up_to_date and (m.term > self.term or self._can_grant_vote(m))
        # grant carries the candidate's future term; rejection our own term
        # (a higher rejection term forces the candidate back to follower)
        self._send(
            Message(
                type=MessageType.REQUEST_PREVOTE_RESP,
                to=m.from_,
                term=m.term if grant else self.term,
                reject=not grant,
            )
        )

    # -- leader ----------------------------------------------------------
    def _step_leader(self, m: Message) -> None:
        t = m.type
        if t == MessageType.PROPOSE:
            self._handle_propose(m)
        elif t == MessageType.CHECK_QUORUM:
            self._handle_check_quorum()
        elif t == MessageType.READ_INDEX:
            # from_ != self marks a request forwarded by a follower
            origin = m.from_ if m.from_ not in (0, self.replica_id) else self.replica_id
            self._handle_leader_read_index(m, from_=origin)
        elif t == MessageType.REPLICATE_RESP:
            self._handle_replicate_resp(m)
        elif t == MessageType.HEARTBEAT_RESP:
            self._handle_heartbeat_resp(m)
        elif t == MessageType.UNREACHABLE:
            self._handle_unreachable(m)
        elif t == MessageType.SNAPSHOT_STATUS:
            self._handle_snapshot_status(m)
        elif t == MessageType.SNAPSHOT_RECEIVED:
            self._handle_snapshot_received(m)
        elif t == MessageType.LEADER_TRANSFER:
            self._handle_leader_transfer(m)
        elif t == MessageType.LEADER_HEARTBEAT:
            self.broadcast_heartbeat()
        elif t == MessageType.REQUEST_VOTE_RESP:
            pass
        elif t == MessageType.REQUEST_PREVOTE_RESP:
            pass
        elif t == MessageType.TIMEOUT_NOW:
            pass
        elif t == MessageType.READ_INDEX_RESP:
            pass
        elif t == MessageType.REPLICATE:
            pass  # stale leader message at our own term is impossible
        elif t == MessageType.HEARTBEAT:
            pass
        elif t == MessageType.INSTALL_SNAPSHOT:
            pass
        else:
            _log.debug("leader dropping %s", t.name)

    def _handle_propose(self, m: Message) -> None:
        if self.leader_transfer_target != NO_NODE:
            self.dropped_entries.extend(m.entries)
            return
        entries = []
        for e in m.entries:
            if e.type == EntryType.CONFIG_CHANGE:
                if self.pending_config_change:
                    self.dropped_entries.append(e)
                    continue
                self.pending_config_change = True
            entries.append(e)
        if entries:
            self._append_entries(list(entries))
            self.broadcast_replicate()

    def _handle_check_quorum(self) -> None:
        active = 1  # self
        for pid, rm in self.voting_members().items():
            if pid == self.replica_id:
                rm.clear_active()
                continue
            if rm.is_active():
                active += 1
            rm.clear_active()
        if active < self.quorum():
            _log.warning(
                "[%d:%d] check-quorum failed, stepping down",
                self.shard_id,
                self.replica_id,
            )
            self.become_follower(self.term, NO_LEADER)

    def _handle_leader_read_index(self, m: Message, from_: int) -> None:
        ctx = SystemCtx(low=m.hint, high=m.hint_high)
        if self.is_witness():
            return
        if not self.committed_entry_in_current_term():
            # leader has not committed in its own term yet: unsafe to serve
            self.dropped_read_indexes.append(ctx)
            return
        if self.is_single_voter():
            if from_ == self.replica_id or from_ == 0:
                self.ready_to_reads.append(
                    ReadyToRead(index=self.log.committed, system_ctx=ctx)
                )
            else:
                self._send(
                    Message(
                        type=MessageType.READ_INDEX_RESP,
                        to=from_,
                        log_index=self.log.committed,
                        hint=ctx.low,
                        hint_high=ctx.high,
                    )
                )
            return
        self.read_index.add_request(self.log.committed, ctx, from_)
        self.broadcast_heartbeat(ctx)

    def _handle_replicate_resp(self, m: Message) -> None:
        rm = self.get_remote(m.from_)
        if rm is None:
            return
        rm.set_active()
        self._anchor_lease_resp(rm)
        if m.reject:
            # m.log_index = rejected prev index, m.hint = follower last index
            if rm.decrease(m.log_index, m.hint):
                self.send_replicate(m.from_)
            return
        paused = rm.is_paused()
        if rm.try_update(m.log_index):
            if (
                rm.state == RemoteState.SNAPSHOT
                and rm.match >= rm.snapshot_index
            ):
                rm.become_retry()
            if rm.state == RemoteState.RETRY:
                rm.become_replicate()
            if self.try_commit():
                self.broadcast_replicate()
            elif paused:
                self.send_replicate(m.from_)
            if (
                self.leader_transfer_target == m.from_
                and self.log.last_index() == rm.match
            ):
                self._send(Message(type=MessageType.TIMEOUT_NOW, to=m.from_))
        elif rm.state == RemoteState.SNAPSHOT and rm.match >= rm.snapshot_index:
            rm.become_retry()

    def _handle_heartbeat_resp(self, m: Message) -> None:
        rm = self.get_remote(m.from_)
        if rm is None:
            return
        rm.set_active()
        self._anchor_lease_resp(rm)
        rm.respond_to()
        if rm.match < self.log.last_index():
            self.send_replicate(m.from_)
        if (m.hint or m.hint_high) and (
            m.from_ in self.remotes or m.from_ in self.witnesses
        ):
            # only VOTING members count toward the read quorum: a
            # non-voting replica echoes heartbeat ctx hints too, and
            # counting it would confirm linearizable reads without a
            # real quorum (reference: etcd readOnly acks are tracked on
            # the voter progress set [U])
            self._read_index_confirm(SystemCtx(low=m.hint, high=m.hint_high), m.from_)

    def _read_index_confirm(self, ctx: SystemCtx, from_: int) -> None:
        done = self.read_index.confirm(ctx, from_, self.quorum())
        if not done:
            return
        for status in done:
            if status.from_ == NO_NODE or status.from_ == self.replica_id:
                self.ready_to_reads.append(
                    ReadyToRead(index=status.index, system_ctx=status.ctx)
                )
            else:
                self._send(
                    Message(
                        type=MessageType.READ_INDEX_RESP,
                        to=status.from_,
                        log_index=status.index,
                        hint=status.ctx.low,
                        hint_high=status.ctx.high,
                    )
                )

    def _handle_unreachable(self, m: Message) -> None:
        rm = self.get_remote(m.from_)
        if rm is None:
            return
        if rm.state == RemoteState.REPLICATE:
            rm.become_retry()

    def _handle_snapshot_status(self, m: Message) -> None:
        rm = self.get_remote(m.from_)
        if rm is None or rm.state != RemoteState.SNAPSHOT:
            return
        if m.reject:
            rm.clear_pending_snapshot()
        rm.become_wait()

    def _handle_snapshot_received(self, m: Message) -> None:
        rm = self.get_remote(m.from_)
        if rm is None or rm.state != RemoteState.SNAPSHOT:
            return
        rm.become_wait()

    def _handle_leader_transfer(self, m: Message) -> None:
        target = m.hint
        if target == self.replica_id:
            return
        rm = self.remotes.get(target)
        if rm is None:
            return  # target must be a voter (not witness/non-voting)
        if self.leader_transfer_target != NO_NODE:
            return
        self.leader_transfer_target = target
        self.election_tick = 0
        if rm.match == self.log.last_index():
            self._send(Message(type=MessageType.TIMEOUT_NOW, to=target))
        else:
            self.send_replicate(target)

    def _abort_leader_transfer(self) -> None:
        self.leader_transfer_target = NO_NODE

    # -- candidate --------------------------------------------------------
    def _step_candidate(self, m: Message) -> None:
        t = m.type
        if t == MessageType.PROPOSE:
            self.dropped_entries.extend(m.entries)
        elif t == MessageType.REPLICATE:
            self.become_follower(self.term, m.from_)
            self._handle_replicate(m)
        elif t == MessageType.HEARTBEAT:
            self.become_follower(self.term, m.from_)
            self._handle_heartbeat(m)
        elif t == MessageType.INSTALL_SNAPSHOT:
            self.become_follower(self.term, m.from_)
            self._handle_install_snapshot(m)
        elif t == MessageType.REQUEST_VOTE_RESP:
            if self.role != RaftRole.CANDIDATE:
                return
            self.votes[m.from_] = not m.reject
            if self._vote_quorum():
                self.become_leader()
                self.broadcast_replicate()
            elif self._vote_rejected():
                self.become_follower(self.term, NO_LEADER)
        elif t == MessageType.REQUEST_PREVOTE_RESP:
            if self.role != RaftRole.PRE_CANDIDATE:
                return
            if m.reject and m.term > self.term:
                self.become_follower(m.term, NO_LEADER)
                return
            self.votes[m.from_] = not m.reject
            if self._vote_quorum():
                self.campaign(pre=False)
            elif self._vote_rejected():
                self.become_follower(self.term, NO_LEADER)
        elif t == MessageType.READ_INDEX:
            self.dropped_read_indexes.append(SystemCtx(low=m.hint, high=m.hint_high))
        elif t == MessageType.TIMEOUT_NOW:
            pass
        else:
            _log.debug("candidate dropping %s", t.name)

    # -- follower ---------------------------------------------------------
    def _observe_leader(self, lid: int) -> None:
        """Follower saw leader traffic from ``lid``.  A SWITCH from a
        different known leader (possible without a local term bump when
        this replica missed the election entirely) aborts every
        confirmation round forwarded to the old leader — its answer may
        predate the new leader's commits (readplane leadership-change
        abort; the term-bump path is covered by _reset)."""
        if self.leader_id != lid and self.leader_id != NO_LEADER:
            self.drop_pending_read_indexes()
            self.leader_commit_hint = self.log.committed
        self.leader_id = lid

    def _step_follower(self, m: Message) -> None:
        t = m.type
        if t == MessageType.PROPOSE:
            if self.leader_id == NO_LEADER:
                self.dropped_entries.extend(m.entries)
                return
            # forward to leader
            self._send(
                Message(type=MessageType.PROPOSE, to=self.leader_id, entries=m.entries)
            )
        elif t == MessageType.REPLICATE:
            self.election_tick = 0
            self._observe_leader(m.from_)
            if m.commit > self.leader_commit_hint:
                self.leader_commit_hint = m.commit
            self._handle_replicate(m)
        elif t == MessageType.HEARTBEAT:
            self.election_tick = 0
            self._observe_leader(m.from_)
            # m.log_index = the leader's uncapped commit advisory (see
            # broadcast_heartbeat); m.commit is capped at our match
            hint = m.log_index if m.log_index > m.commit else m.commit
            if hint > self.leader_commit_hint:
                self.leader_commit_hint = hint
            self._handle_heartbeat(m)
        elif t == MessageType.INSTALL_SNAPSHOT:
            self.election_tick = 0
            self._observe_leader(m.from_)
            self._handle_install_snapshot(m)
        elif t == MessageType.READ_INDEX:
            if self.role in (RaftRole.NON_VOTING,):
                # non-voting replicas may serve linearizable reads through
                # the leader as well
                pass
            if self.is_witness():
                return
            if self.leader_id == NO_LEADER:
                self.dropped_read_indexes.append(
                    SystemCtx(low=m.hint, high=m.hint_high)
                )
                return
            self._send(
                Message(
                    type=MessageType.READ_INDEX,
                    to=self.leader_id,
                    hint=m.hint,
                    hint_high=m.hint_high,
                )
            )
            # ledger the in-flight confirmation round so a leadership
            # change aborts it (drop_pending_read_indexes).  Bounded: a
            # lost READ_INDEX_RESP leaves an entry behind until the
            # next leader change, so shed the oldest past a soft cap —
            # dropping early is safe (the future fails fast, client
            # retries) while a silent leak is not.
            fr = self.forwarded_reads
            fr[(m.hint, m.hint_high)] = self.leader_id
            if len(fr) > 4096:
                for key in list(fr)[:1024]:
                    del fr[key]
                    self.dropped_read_indexes.append(
                        SystemCtx(low=key[0], high=key[1])
                    )
        elif t == MessageType.READ_INDEX_RESP:
            self.forwarded_reads.pop((m.hint, m.hint_high), None)
            self.ready_to_reads.append(
                ReadyToRead(
                    index=m.log_index,
                    system_ctx=SystemCtx(low=m.hint, high=m.hint_high),
                )
            )
        elif t == MessageType.TIMEOUT_NOW:
            if self.role == RaftRole.FOLLOWER and self.replica_id in self.remotes:
                self.is_leader_transfer_target = True
                self.campaign(pre=False, transfer=True)
                self.is_leader_transfer_target = False
        elif t == MessageType.LEADER_TRANSFER:
            if self.leader_id != NO_LEADER:
                self._send(
                    Message(
                        type=MessageType.LEADER_TRANSFER,
                        to=self.leader_id,
                        hint=m.hint,
                    )
                )
        elif t == MessageType.REQUEST_VOTE_RESP:
            pass
        elif t == MessageType.REQUEST_PREVOTE_RESP:
            pass
        else:
            _log.debug("follower dropping %s", t.name)

    def _handle_replicate(self, m: Message) -> None:
        if m.log_index < self.log.committed:
            # stale: already committed past prev; reply with committed
            self._send(
                Message(
                    type=MessageType.REPLICATE_RESP,
                    to=m.from_,
                    log_index=self.log.committed,
                )
            )
            return
        ok, last_new = self.log.try_append(m.log_index, m.log_term, list(m.entries))
        if ok:
            self.log.commit_to(min(m.commit, last_new))
            self._send(
                Message(
                    type=MessageType.REPLICATE_RESP, to=m.from_, log_index=last_new
                )
            )
        else:
            _log.debug(
                "[%d:%d] rejected replicate prev(%d,t%d) from %d",
                self.shard_id,
                self.replica_id,
                m.log_index,
                m.log_term,
                m.from_,
            )
            self._send(
                Message(
                    type=MessageType.REPLICATE_RESP,
                    to=m.from_,
                    reject=True,
                    log_index=m.log_index,
                    hint=self.log.last_index(),
                )
            )

    def _handle_heartbeat(self, m: Message) -> None:
        self.log.commit_to(min(m.commit, self.log.last_index()))
        self._send(
            Message(
                type=MessageType.HEARTBEAT_RESP,
                to=m.from_,
                hint=m.hint,
                hint_high=m.hint_high,
            )
        )

    def _handle_install_snapshot(self, m: Message) -> None:
        ss = m.snapshot
        if self._restore(ss):
            self._send(
                Message(
                    type=MessageType.REPLICATE_RESP,
                    to=m.from_,
                    log_index=self.log.last_index(),
                )
            )
        else:
            self._send(
                Message(
                    type=MessageType.REPLICATE_RESP,
                    to=m.from_,
                    log_index=self.log.committed,
                )
            )

    def _restore(self, ss: Snapshot) -> bool:
        if ss.index <= self.log.committed:
            return False
        if self.log.match_term(ss.index, ss.term):
            # log already contains the snapshot point: just fast-forward
            self.log.commit_to(ss.index)
            return False
        self.log.restore(ss)
        self._restore_membership(ss.membership)
        return True

    def _restore_membership(self, membership: Membership) -> None:
        last = self.log.last_index()
        self.remotes = {}
        self.non_votings = {}
        self.witnesses = {}
        for pid, addr in membership.addresses.items():
            self.remotes[pid] = Remote(next=last + 1)
            self.addresses[pid] = addr
        for pid, addr in membership.non_votings.items():
            self.non_votings[pid] = Remote(next=last + 1)
            self.addresses[pid] = addr
        for pid, addr in membership.witnesses.items():
            self.witnesses[pid] = Remote(next=last + 1)
            self.addresses[pid] = addr
        if self.replica_id in self.non_votings:
            self.role = RaftRole.NON_VOTING
        elif self.replica_id in self.witnesses:
            self.role = RaftRole.WITNESS

    # ------------------------------------------------------------------
    # membership change (applied post-commit by the host)
    # ------------------------------------------------------------------
    def apply_config_change(self, cc: ConfigChange) -> None:
        """reference: raft.applyConfigChange [U] — called by the node after
        the config-change entry is committed and applied."""
        self.pending_config_change = False
        pid = cc.replica_id
        if cc.type == ConfigChangeType.ADD_REPLICA:
            self._add_replica(pid, cc.address)
        elif cc.type == ConfigChangeType.ADD_NON_VOTING:
            self._add_non_voting(pid, cc.address)
        elif cc.type == ConfigChangeType.ADD_WITNESS:
            self._add_witness(pid, cc.address)
        elif cc.type == ConfigChangeType.REMOVE_REPLICA:
            self._remove_replica(pid)

    def reject_config_change(self) -> None:
        self.pending_config_change = False

    def _add_replica(self, pid: int, address: str) -> None:
        self.addresses[pid] = address
        if pid in self.witnesses:
            raise RuntimeError("cannot promote a witness to voter")
        if pid in self.non_votings:
            # promotion keeps replication progress
            rm = self.non_votings.pop(pid)
            self.remotes[pid] = rm
            if pid == self.replica_id:
                self.role = RaftRole.FOLLOWER
            return
        if pid in self.remotes:
            return
        self.remotes[pid] = Remote(next=self.log.last_index() + 1)

    def _add_non_voting(self, pid: int, address: str) -> None:
        self.addresses[pid] = address
        if pid in self.remotes or pid in self.witnesses:
            raise RuntimeError("replica already a voter/witness")
        if pid in self.non_votings:
            return
        self.non_votings[pid] = Remote(next=self.log.last_index() + 1)

    def _add_witness(self, pid: int, address: str) -> None:
        self.addresses[pid] = address
        if pid in self.remotes or pid in self.non_votings:
            raise RuntimeError("replica already a voter/non-voting")
        if pid in self.witnesses:
            return
        self.witnesses[pid] = Remote(next=self.log.last_index() + 1)

    def _remove_replica(self, pid: int) -> None:
        self.remotes.pop(pid, None)
        self.non_votings.pop(pid, None)
        self.witnesses.pop(pid, None)
        self.addresses.pop(pid, None)
        if pid == self.replica_id:
            return
        if self.is_leader() and self.voting_members():
            if self.try_commit():
                self.broadcast_replicate()
            if self.leader_transfer_target == pid:
                self._abort_leader_transfer()

    # ------------------------------------------------------------------
    # output draining (used by Peer.get_update)
    # ------------------------------------------------------------------
    def drop_pending_read_indexes(self) -> None:
        """Fail every ReadIndex confirmation round this replica has
        forwarded to a leader (follower side of the readplane's
        leadership-change abort; the leader side's own pending table is
        ``read_index.clear()``).  Dropping is always safe — the caller's
        future fails fast and the client re-confirms against the current
        leader instead of trusting a deposed one's answer."""
        if self.forwarded_reads:
            for low, high in self.forwarded_reads:
                self.dropped_read_indexes.append(SystemCtx(low=low, high=high))
            self.forwarded_reads.clear()

    def drain_messages(self) -> List[Message]:
        out = self.msgs
        self.msgs = []
        return out

    def drain_ready_to_reads(self) -> List[ReadyToRead]:
        out = self.ready_to_reads
        self.ready_to_reads = []
        return out

    def drain_dropped(self):
        de, dr = self.dropped_entries, self.dropped_read_indexes
        self.dropped_entries, self.dropped_read_indexes = [], []
        return de, dr

    def get_membership(self) -> Membership:
        return Membership(
            addresses={
                pid: self.addresses.get(pid, "") for pid in self.remotes
            },
            non_votings={
                pid: self.addresses.get(pid, "") for pid in self.non_votings
            },
            witnesses={
                pid: self.addresses.get(pid, "") for pid in self.witnesses
            },
        )
