"""In-memory LogDB + the LogDB-backed log reader for the raft core.

reference: internal/logdb/ (ShardedDB) + internal/logdb/logreader.go [U].

``InMemLogDB`` implements the full ILogDB contract against process memory;
it is the storage backend for tests and for BASELINE config 1/2 (the
durable tan-style WAL lives in storage/tan.py).  A single instance may be
shared across NodeHost restarts to model "the disk" (as the reference's
tests do with MemFS).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..pb import Bootstrap, Entry, Snapshot, State, EMPTY_SNAPSHOT, Update
from ..raft.log import LogCompactedError, LogUnavailableError
from ..raftio import ILogDB, NodeInfo, RaftState


class _NodeStore:
    """Per-(shard,replica) record set."""

    def __init__(self):
        self.state = State()
        self.entries: Dict[int, Entry] = {}
        self.max_index = 0
        self.min_index = 1  # entries below were removed/compacted
        self.snapshot: Snapshot = EMPTY_SNAPSHOT
        self.bootstrap: Optional[Bootstrap] = None


def in_mem_logdb_factory(config) -> "InMemLogDB":
    """NodeHostConfig.expert.logdb_factory hook for the volatile backend.

    The default backend is the durable tan WAL; opting into process-memory
    storage must be explicit because a crash loses every acked write."""
    return InMemLogDB()


class InMemLogDB(ILogDB):
    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: Dict[Tuple[int, int], _NodeStore] = {}
        self.sync_count = 0  # batched-write counter (1 per save_raft_state)
        # columnar hard-state lanes (ISSUE 13): replicas the device
        # merge tail saves every generation register a SLOT once
        # (state_lane_slot) and from then on save_state_slots persists
        # their (term, vote, commit) triples as THREE numpy scatters —
        # zero per-row Python on the hot save.  ``_hs_dirty[s]`` marks
        # lane words newer than ``ns.state``; readers and the classic
        # save path reconcile through _hs_sync (lane words materialize
        # into a State lazily, exactly-once).  All guarded by _lock.
        self._hs_slots: Dict[Tuple[int, int], int] = {}
        self._hs_next = 0  # monotone slot counter (slots of removed
        # replicas are orphaned, never reused — see remove_node_data)
        self._hs = np.zeros((3, 0), np.int64)
        self._hs_dirty = np.zeros((0,), bool)

    def _hs_sync(self, key, ns) -> None:  # guarded-by: _lock
        """Materialize pending lane words into ``ns.state`` (reader's
        half of the columnar protocol)."""
        s = self._hs_slots.get(key)
        if s is not None and self._hs_dirty[s]:
            self._hs_dirty[s] = False
            ns.state = State(
                term=int(self._hs[0, s]),
                vote=int(self._hs[1, s]),
                commit=int(self._hs[2, s]),
            )

    def state_lane_slot(self, shard_id: int, replica_id: int) -> int:
        """Register (or look up) the replica's hard-state lane slot.
        Callers cache the returned slot (engine: ``node.hs_lane_slot``)
        so the steady-state save path never touches the key dict."""
        with self._lock:
            key = (shard_id, replica_id)
            s = self._hs_slots.get(key)
            if s is None:
                s = self._hs_next
                self._hs_next = s + 1
                self._hs_slots[key] = s
                if s >= self._hs.shape[1]:
                    grow = max(64, 2 * self._hs.shape[1])
                    nb = np.zeros((3, grow), np.int64)
                    nb[:, : self._hs.shape[1]] = self._hs
                    self._hs = nb
                    nd = np.zeros((grow,), bool)
                    nd[: self._hs_dirty.shape[0]] = self._hs_dirty
                    self._hs_dirty = nd
            return s

    def save_state_slots(
        self, slots, terms, votes, commits, worker_id: int
    ) -> None:
        """Batched hard-state save by pre-registered slot: three numpy
        scatters + a dirty mark, one lock hold — the vectorized half of
        ILogDB.save_state_lanes for stores with a cheap hard-state
        column (atomicity contract is save_raft_state's)."""
        with self._lock:
            self._hs[0, slots] = terms
            self._hs[1, slots] = votes
            self._hs[2, slots] = commits
            self._hs_dirty[slots] = True
            self.sync_count += 1

    def _get(self, shard_id: int, replica_id: int) -> _NodeStore:
        key = (shard_id, replica_id)
        with self._lock:
            if key not in self._nodes:
                self._nodes[key] = _NodeStore()
            return self._nodes[key]

    # -- ILogDB ----------------------------------------------------------
    def name(self) -> str:
        return "inmem"

    def close(self) -> None:
        pass

    def list_node_info(self) -> List[NodeInfo]:
        with self._lock:
            return [
                NodeInfo(shard_id=s, replica_id=r) for (s, r) in self._nodes
            ]

    def save_bootstrap_info(self, shard_id, replica_id, bootstrap) -> None:
        with self._lock:
            self._get(shard_id, replica_id).bootstrap = bootstrap

    def get_bootstrap_info(self, shard_id, replica_id):
        with self._lock:
            return self._get(shard_id, replica_id).bootstrap

    def save_raft_state(self, updates: List[Update], worker_id: int) -> None:
        """One atomic batched write for all shards in ``updates`` —
        the reference's single-fsync-per-iteration trick
        (engine.go step worker -> logdb.SaveRaftState [U])."""
        with self._lock:
            for u in updates:
                ns = self._get(u.shard_id, u.replica_id)
                if not u.state.is_empty():
                    ns.state = u.state
                    if self._hs_slots:
                        # a classic save overrides pending lane words
                        s = self._hs_slots.get((u.shard_id, u.replica_id))
                        if s is not None:
                            self._hs_dirty[s] = False
                for e in u.entries_to_save:
                    ns.entries[e.index] = e
                    if e.index > ns.max_index:
                        ns.max_index = e.index
                if u.entries_to_save:
                    # overwrite truncates any conflicting suffix
                    last = u.entries_to_save[-1].index
                    for i in list(ns.entries):
                        if i > last:
                            del ns.entries[i]
                    ns.max_index = last
                if not u.snapshot.is_empty():
                    ns.snapshot = u.snapshot
                    if ns.max_index < u.snapshot.index:
                        ns.max_index = u.snapshot.index
            self.sync_count += 1

    def save_state_lanes(
        self, shard_ids, replica_ids, terms, votes, commits, worker_id
    ) -> None:
        """Batched hard-state-only save (see ILogDB.save_state_lanes):
        one lock hold, one State write per lane row, no per-row Update
        carrier — the in-memory store's half of the ISSUE-13 merge-tail
        vectorization."""
        with self._lock:
            get = self._get
            slots = self._hs_slots
            for s_id, r_id, t, v, c in zip(
                shard_ids, replica_ids, terms, votes, commits
            ):
                get(s_id, r_id).state = State(t, v, c)
                if slots:
                    s = slots.get((s_id, r_id))
                    if s is not None:
                        self._hs_dirty[s] = False
            self.sync_count += 1

    def read_raft_state(self, shard_id, replica_id, last_index) -> Optional[RaftState]:
        with self._lock:
            key = (shard_id, replica_id)
            if key not in self._nodes:
                # a replica saved ONLY through the columnar lane path
                # has no node store yet — pending lane words are still
                # durable state and must materialize through this
                # reader, not read back as None
                s = self._hs_slots.get(key)
                if s is None or not self._hs_dirty[s]:
                    return None
            ns = self._get(shard_id, replica_id)
            if self._hs_slots:
                self._hs_sync(key, ns)
            first = max(ns.min_index, ns.snapshot.index + 1)
            count = 0
            i = first
            while i in ns.entries:
                count += 1
                i += 1
            return RaftState(
                state=ns.state, first_index=first, entry_count=count
            )

    def iterate_entries(self, shard_id, replica_id, low, high, max_size) -> List[Entry]:
        with self._lock:
            ns = self._get(shard_id, replica_id)
            out: List[Entry] = []
            size = 0
            for i in range(low, high):
                e = ns.entries.get(i)
                if e is None:
                    break
                size += e.size_bytes()
                if out and size > max_size:
                    break
                out.append(e)
            return out

    def term(self, shard_id, replica_id, index) -> Optional[int]:
        with self._lock:
            ns = self._get(shard_id, replica_id)
            e = ns.entries.get(index)
            if e is not None:
                return e.term
            if ns.snapshot.index == index and index > 0:
                return ns.snapshot.term
            return None

    def remove_entries_to(self, shard_id, replica_id, index) -> None:
        with self._lock:
            ns = self._get(shard_id, replica_id)
            for i in list(ns.entries):
                if i <= index:
                    del ns.entries[i]
            ns.min_index = max(ns.min_index, index + 1)

    def compact_entries_to(self, shard_id, replica_id, index) -> None:
        self.remove_entries_to(shard_id, replica_id, index)

    def save_snapshots(self, updates: List[Update]) -> None:
        with self._lock:
            for u in updates:
                if not u.snapshot.is_empty():
                    ns = self._get(u.shard_id, u.replica_id)
                    if u.snapshot.index > ns.snapshot.index:
                        ns.snapshot = u.snapshot

    def get_snapshot(self, shard_id, replica_id) -> Snapshot:
        with self._lock:
            return self._get(shard_id, replica_id).snapshot

    def remove_node_data(self, shard_id, replica_id) -> None:
        with self._lock:
            self._nodes.pop((shard_id, replica_id), None)
            # orphan the hard-state lane slot: a re-added replica gets
            # a fresh slot (and a fresh _NodeStore); writes through a
            # stale cached slot land on the orphaned array column,
            # which no reader can reach once the key is popped
            self._hs_slots.pop((shard_id, replica_id), None)

    def import_snapshot(self, snapshot: Snapshot, replica_id: int) -> None:
        with self._lock:
            ns = self._get(snapshot.shard_id, replica_id)
            ns.snapshot = snapshot
            ns.state = State(
                term=snapshot.term, vote=0, commit=snapshot.index
            )
            s = self._hs_slots.get((snapshot.shard_id, replica_id))
            if s is not None:
                self._hs_dirty[s] = False
            ns.entries.clear()
            ns.max_index = snapshot.index
            ns.min_index = snapshot.index + 1


class LogDBLogReader:
    """ILogReader over an ILogDB for one (shard, replica) — keeps the
    log range in memory, reads entries/terms through the DB.

    reference: internal/logdb/logreader.go [U].  The node must call
    ``append``/``apply_snapshot``/``compact`` as it persists so the range
    stays accurate (terms/entries themselves always come from the DB).
    """

    def __init__(self, shard_id: int, replica_id: int, logdb: ILogDB):
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.logdb = logdb
        self._snapshot: Snapshot = EMPTY_SNAPSHOT
        self._marker = 1
        self._length = 0
        # term of the entry at marker-1 (the compaction boundary), kept so
        # prev-log-term checks right at the boundary still resolve — the
        # etcd-storage "dummy entry" trick (reference: logreader [U])
        self._marker_term: Optional[int] = None

    @classmethod
    def from_existing(
        cls, shard_id: int, replica_id: int, logdb: ILogDB
    ) -> Tuple["LogDBLogReader", Optional[State]]:
        """Open at restart: recover range + HardState (reference:
        nodehost loadState path [U])."""
        lr = cls(shard_id, replica_id, logdb)
        ss = logdb.get_snapshot(shard_id, replica_id)
        if not ss.is_empty():
            lr._snapshot = ss
            lr._marker = ss.index + 1
        rs = logdb.read_raft_state(shard_id, replica_id, 0)
        if rs is None:
            return lr, None
        if rs.entry_count > 0:
            lr._marker = rs.first_index
            lr._length = rs.entry_count
        elif not ss.is_empty():
            lr._marker = ss.index + 1
            lr._length = 0
        return lr, rs.state

    # -- ILogReader ------------------------------------------------------
    def log_range(self) -> Tuple[int, int]:
        if self._length > 0:
            # a locally created snapshot never hides live entries
            return self._marker, self._marker + self._length - 1
        first = max(self._marker, self._snapshot.index + 1)
        return first, first - 1

    def term(self, index: int) -> int:
        if index == self._snapshot.index and index > 0:
            return self._snapshot.term
        first, last = self.log_range()
        if index < first - 1:
            raise LogCompactedError(f"index {index} < first {first}")
        if index > last:
            raise LogUnavailableError(f"index {index} > last {last}")
        if index == 0:
            return 0
        t = self.logdb.term(self.shard_id, self.replica_id, index)
        if t is None:
            if index == self._marker - 1 and self._marker_term is not None:
                return self._marker_term
            raise LogUnavailableError(f"term missing at {index}")
        return t

    def entries(self, low: int, high: int, max_size: int) -> List[Entry]:
        first, last = self.log_range()
        if low < first:
            raise LogCompactedError(f"low {low} < first {first}")
        if high > last + 1:
            raise LogUnavailableError(f"high {high} > last+1 {last+1}")
        return self.logdb.iterate_entries(
            self.shard_id, self.replica_id, low, high, max_size
        )

    def snapshot(self) -> Snapshot:
        return self._snapshot

    # -- mutating half ----------------------------------------------------
    def append(self, entries: List[Entry]) -> None:
        if not entries:
            return
        first_new = entries[0].index
        last_cur = self._marker + self._length - 1
        if first_new > last_cur + 1:
            raise ValueError(f"log gap: {first_new} after {last_cur}")
        if first_new < self._marker:
            self._marker = first_new
            self._length = len(entries)
        else:
            self._length = first_new - self._marker + len(entries)

    def apply_snapshot(self, ss: Snapshot) -> None:
        """Restore: the log is reset to the snapshot point."""
        self._snapshot = ss
        self._marker = ss.index + 1
        self._length = 0
        self._marker_term = ss.term

    def create_snapshot(self, ss: Snapshot) -> None:
        """Record a locally created snapshot WITHOUT resetting the range —
        the log still holds entries past the snapshot (reference:
        logReader.CreateSnapshot vs ApplySnapshot [U])."""
        if ss.index > self._snapshot.index:
            self._snapshot = ss

    def compact(self, to_index: int) -> None:
        first, last = self.log_range()
        if to_index < self._marker:
            return
        keep_from = min(to_index + 1, last + 1)
        try:
            self._marker_term = self.term(keep_from - 1)
        except (LogCompactedError, LogUnavailableError):
            pass
        self._length -= keep_from - self._marker
        self._marker = keep_from
