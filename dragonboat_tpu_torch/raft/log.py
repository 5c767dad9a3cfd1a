"""Raft log: in-memory tail + persisted prefix.

reference: internal/raft/logentry.go (entryLog), inmemory.go (inMemory) [U].

``InMemory`` holds the not-yet-persisted / not-yet-applied window;
``EntryLog`` is the unified view over ``InMemory`` and a persisted
``ILogReader`` (backed by the LogDB on the host, or a plain list in tests).
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, Tuple

from ..pb import Entry, Snapshot, EMPTY_SNAPSHOT


class LogCompactedError(Exception):
    """Requested index has been compacted away."""


class LogUnavailableError(Exception):
    """Requested index is beyond the last known entry."""


class ILogReader(Protocol):
    """Read-only view of the persisted log (reference: the ILogDB-backed
    logReader, internal/logdb/logreader.go [U])."""

    def log_range(self) -> Tuple[int, int]:
        """(first_index, last_index) of available persisted entries; for an
        empty log returns (snapshot_index + 1, snapshot_index)."""
        ...

    def term(self, index: int) -> int: ...

    def entries(self, low: int, high: int, max_size: int) -> List[Entry]: ...

    def snapshot(self) -> Snapshot: ...


class InMemLogReader:
    """An ILogReader over plain Python lists.

    Used by protocol unit tests and as the log view of the in-memory LogDB.
    Also supports the mutating half used by the host runtime (append /
    apply_snapshot / compact), mirroring internal/logdb/logreader.go [U].
    """

    def __init__(self, entries: Optional[Sequence[Entry]] = None):
        self._snapshot: Snapshot = EMPTY_SNAPSHOT
        # marker = index of _entries[0]; starts at 1 for a fresh log.
        self._marker = 1
        self._entries: List[Entry] = list(entries or [])
        if self._entries:
            self._marker = self._entries[0].index

    # -- ILogReader ------------------------------------------------------
    def log_range(self) -> Tuple[int, int]:
        first = max(self._marker, self._snapshot.index + 1)
        last = self._marker + len(self._entries) - 1
        if self._snapshot.index > last:
            last = self._snapshot.index
        return first, last

    def first_index(self) -> int:
        return self.log_range()[0]

    def last_index(self) -> int:
        return self.log_range()[1]

    def term(self, index: int) -> int:
        if index == self._snapshot.index and index > 0:
            return self._snapshot.term
        first, last = self.log_range()
        if index < first - 1:
            raise LogCompactedError(f"index {index} < first {first}")
        if index == first - 1:
            # the boundary: term known only via snapshot (handled above) or
            # a marker entry retained at compaction time
            if self._entries and index >= self._marker:
                return self._entries[index - self._marker].term
            if index == 0:
                return 0
            raise LogCompactedError(f"boundary index {index}")
        if index > last:
            raise LogUnavailableError(f"index {index} > last {last}")
        return self._entries[index - self._marker].term

    def entries(self, low: int, high: int, max_size: int) -> List[Entry]:
        first, last = self.log_range()
        if low < first:
            raise LogCompactedError(f"low {low} < first {first}")
        if high > last + 1:
            raise LogUnavailableError(f"high {high} > last+1 {last + 1}")
        out: List[Entry] = []
        size = 0
        for i in range(low, high):
            e = self._entries[i - self._marker]
            size += e.size_bytes()
            if out and size > max_size:
                break
            out.append(e)
        return out

    def snapshot(self) -> Snapshot:
        return self._snapshot

    # -- mutating half (host runtime) ------------------------------------
    def append(self, entries: Sequence[Entry]) -> None:
        if not entries:
            return
        first_new = entries[0].index
        last_cur = self._marker + len(self._entries) - 1
        if first_new > last_cur + 1:
            raise ValueError(f"log gap: appending {first_new} after {last_cur}")
        if not self._entries:
            self._marker = first_new
            self._entries = list(entries)
            return
        if first_new <= self._marker:
            self._marker = first_new
            self._entries = list(entries)
        else:
            self._entries = self._entries[: first_new - self._marker] + list(entries)

    def apply_snapshot(self, ss: Snapshot) -> None:
        self._snapshot = ss
        self._marker = ss.index + 1
        self._entries = []

    def compact(self, to_index: int) -> None:
        """Drop entries <= to_index (term(to_index) stays resolvable only
        through the snapshot)."""
        first, last = self.log_range()
        if to_index < self._marker:
            return
        keep_from = min(to_index + 1, last + 1)
        self._entries = self._entries[keep_from - self._marker :]
        self._marker = keep_from


class InMemory:
    __slots__ = ("entries", "marker", "saved_to", "snapshot", "bytes")
    """The unpersisted/unapplied in-memory window of the log.

    reference: internal/raft/inmemory.go [U].  ``marker`` is the raft index
    of ``entries[0]``; ``saved_to`` the highest index known persisted.
    """

    def __init__(self, last_saved_index: int):
        self.marker = last_saved_index + 1
        self.entries: List[Entry] = []
        self.saved_to = last_saved_index
        self.snapshot: Snapshot = EMPTY_SNAPSHOT  # pending restore
        # byte size of the window — the MaxInMemLogSize rate-limit input
        # (reference: internal/server/rate.go InMemRateLimiter [U])
        self.bytes = 0

    def get_snapshot_index(self) -> Optional[int]:
        return None if self.snapshot.is_empty() else self.snapshot.index

    def get_entries(self, low: int, high: int) -> List[Entry]:
        if low > high or low < self.marker:
            raise LogCompactedError(f"inmem range [{low},{high}) marker {self.marker}")
        upper = self.marker + len(self.entries)
        if high > upper:
            raise LogUnavailableError(f"inmem high {high} > {upper}")
        return self.entries[low - self.marker : high - self.marker]

    def get_last_index(self) -> Optional[int]:
        if self.entries:
            return self.entries[-1].index
        return self.get_snapshot_index()

    def get_term(self, index: int) -> Optional[int]:
        if index >= self.marker and index < self.marker + len(self.entries):
            return self.entries[index - self.marker].term
        si = self.get_snapshot_index()
        if si is not None and index == si:
            return self.snapshot.term
        return None

    def merge(self, entries: Sequence[Entry]) -> None:
        if not entries:
            return
        added = sum(e.size_bytes() for e in entries)
        first_new = entries[0].index
        last_cur = self.marker + len(self.entries) - 1
        if first_new == last_cur + 1:
            self.entries = self.entries + list(entries)
            self.bytes += added
        elif first_new <= self.marker:
            self.marker = first_new
            self.entries = list(entries)
            self.bytes = added
            self.saved_to = min(self.saved_to, first_new - 1)
        else:
            keep = first_new - self.marker
            self.bytes -= sum(e.size_bytes() for e in self.entries[keep:])
            self.entries = self.entries[:keep] + list(entries)
            self.bytes += added
            self.saved_to = min(self.saved_to, first_new - 1)

    def restore(self, ss: Snapshot) -> None:
        self.snapshot = ss
        self.marker = ss.index + 1
        self.entries = []
        self.bytes = 0
        self.saved_to = ss.index

    def entries_to_save(self) -> List[Entry]:
        if self.saved_to + 1 < self.marker:
            return []
        return self.entries[self.saved_to + 1 - self.marker :]

    def saved_log_to(self, index: int, term: int) -> None:
        t = self.get_term(index)
        if t is not None and t == term and index > self.saved_to:
            self.saved_to = index

    def saved_snapshot_to(self, index: int) -> None:
        si = self.get_snapshot_index()
        if si is not None and si == index:
            self.snapshot = EMPTY_SNAPSHOT

    def applied_log_to(self, index: int) -> None:
        """GC entries that are both persisted and applied."""
        keep_from = min(index, self.saved_to) + 1
        if keep_from <= self.marker:
            return
        last = self.marker + len(self.entries) - 1
        keep_from = min(keep_from, last + 1)
        dropped = self.entries[: keep_from - self.marker]
        self.bytes -= sum(e.size_bytes() for e in dropped)
        self.entries = self.entries[keep_from - self.marker :]
        self.marker = keep_from


class EntryLog:
    __slots__ = ("logdb", "inmem", "committed", "processed")
    """Unified log view with committed/processed cursors.

    reference: internal/raft/logentry.go (entryLog) [U].
    """

    def __init__(self, reader: ILogReader, committed: int = 0):
        self.logdb = reader
        first, last = reader.log_range()
        self.inmem = InMemory(last)
        self.committed = committed
        # everything below first-1 was snapshotted/applied before restart
        self.processed = first - 1

    # -- index bounds ----------------------------------------------------
    def first_index(self) -> int:
        si = self.inmem.get_snapshot_index()
        if si is not None:
            return si + 1
        return self.logdb.log_range()[0]

    def last_index(self) -> int:
        li = self.inmem.get_last_index()
        if li is not None:
            return li
        return self.logdb.log_range()[1]

    def term(self, index: int) -> int:
        t = self.inmem.get_term(index)
        if t is not None:
            return t
        first = self.first_index()
        if index == first - 1:
            ss = self.logdb.snapshot()
            if ss.index == index and index > 0:
                return ss.term
            if index == 0:
                return 0
        return self.logdb.term(index)

    def last_term(self) -> int:
        return self.term(self.last_index())

    def match_term(self, index: int, term: int) -> bool:
        if index == 0:
            return True
        try:
            return self.term(index) == term
        except (LogCompactedError, LogUnavailableError):
            return False

    def up_to_date(self, index: int, term: int) -> bool:
        lt = self.last_term()
        return term > lt or (term == lt and index >= self.last_index())

    # -- reads -----------------------------------------------------------
    def entries(self, low: int, max_size: int) -> List[Entry]:
        high = self.last_index() + 1
        if low >= high:
            return []
        return self._get_entries(low, high, max_size)

    def _get_entries(self, low: int, high: int, max_size: int) -> List[Entry]:
        if low < self.first_index():
            raise LogCompactedError(f"low {low} < first {self.first_index()}")
        if high > self.last_index() + 1:
            raise LogUnavailableError(f"high {high}")
        out: List[Entry] = []
        if low < self.inmem.marker:
            out = self.logdb.entries(low, min(high, self.inmem.marker), max_size)
            got = len(out)
            if got < min(high, self.inmem.marker) - low:
                return out  # max_size hit
        if high > self.inmem.marker and (not out or out[-1].index + 1 >= self.inmem.marker):
            start = max(low, self.inmem.marker)
            tail = self.inmem.get_entries(start, high)
            size = sum(e.size_bytes() for e in out)
            for e in tail:
                size += e.size_bytes()
                if out and size > max_size:
                    break
                out.append(e)
        return out

    # -- writes ----------------------------------------------------------
    def append(self, entries: Sequence[Entry]) -> None:
        if not entries:
            return
        if entries[0].index <= self.committed:
            raise RuntimeError(
                f"appending {entries[0].index} <= committed {self.committed}"
            )
        self.inmem.merge(entries)

    def try_append(
        self, prev_index: int, prev_term: int, entries: Sequence[Entry]
    ) -> Tuple[bool, int]:
        """Follower-side append with log-matching check.

        Returns (ok, last_new_index).
        """
        if not self.match_term(prev_index, prev_term):
            return False, 0
        last_new = prev_index + len(entries)
        conflict = self._find_conflict_index(entries)
        if conflict is not None:
            if conflict <= self.committed:
                raise RuntimeError(
                    f"conflict at {conflict} <= committed {self.committed}"
                )
            offset = conflict - (prev_index + 1)
            self.append(list(entries[offset:]))
        return True, last_new

    def _find_conflict_index(self, entries: Sequence[Entry]) -> Optional[int]:
        for e in entries:
            if not self.match_term(e.index, e.term):
                return e.index
        return None

    def commit_to(self, index: int) -> None:
        if index <= self.committed:
            return
        if index > self.last_index():
            raise RuntimeError(
                f"commit_to {index} > last_index {self.last_index()}"
            )
        self.committed = index

    def restore(self, ss: Snapshot) -> None:
        self.inmem.restore(ss)
        self.committed = ss.index
        self.processed = ss.index

    # -- update plumbing --------------------------------------------------
    def entries_to_save(self) -> List[Entry]:
        return self.inmem.entries_to_save()

    def has_entries_to_apply(self) -> bool:
        return self.committed > self.processed

    def entries_to_apply(self, limit: int = 2**63) -> List[Entry]:
        if not self.has_entries_to_apply():
            return []
        return self._get_entries(self.processed + 1, self.committed + 1, limit)

    def commit_update(self, uc) -> None:
        """Advance cursors after the host consumed an Update
        (reference: entryLog.commitUpdate [U])."""
        if uc.processed > 0:
            if uc.processed < self.processed or uc.processed > self.committed:
                raise RuntimeError(
                    f"invalid processed {uc.processed} "
                    f"(processed={self.processed} committed={self.committed})"
                )
            self.processed = uc.processed
            self.inmem.applied_log_to(uc.processed)
        if uc.stable_log_index > 0:
            self.inmem.saved_log_to(uc.stable_log_index, uc.stable_log_term)
        if uc.stable_snapshot_index > 0:
            self.inmem.saved_snapshot_to(uc.stable_snapshot_index)
            self.processed = max(self.processed, uc.stable_snapshot_index)
