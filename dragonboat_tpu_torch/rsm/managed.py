"""Uniform internal wrapper over the three public SM types.

reference: internal/rsm/managed.go / nativesm.go [U].  Normalizes
everything to the batched interface and supplies the right locking:
regular SMs get an RW mutex (snapshot blocks writes), concurrent/on-disk
SMs run lock-free with PrepareSnapshot.
"""
from __future__ import annotations

import enum
import threading
from typing import BinaryIO, List, Optional

from ..statemachine import (
    IConcurrentStateMachine,
    IOnDiskStateMachine,
    IStateMachine,
    ISnapshotFileCollection,
    Result,
    SMEntry,
)


class SMType(enum.IntEnum):
    REGULAR = 0
    CONCURRENT = 1
    ON_DISK = 2


def wrap_state_machine(sm) -> "ManagedStateMachine":
    if isinstance(sm, IOnDiskStateMachine):
        return ManagedStateMachine(sm, SMType.ON_DISK)
    if isinstance(sm, IConcurrentStateMachine):
        return ManagedStateMachine(sm, SMType.CONCURRENT)
    if isinstance(sm, IStateMachine):
        return ManagedStateMachine(sm, SMType.REGULAR)
    raise TypeError(f"not a state machine: {type(sm)}")


class ManagedStateMachine:
    def __init__(self, sm, sm_type: SMType):
        self.sm = sm
        self.type = sm_type
        self._mu = threading.RLock()  # regular SM: excludes update vs snapshot

    @property
    def on_disk(self) -> bool:
        return self.type == SMType.ON_DISK

    @property
    def concurrent_snapshot(self) -> bool:
        return self.type in (SMType.CONCURRENT, SMType.ON_DISK)

    def open(self, stopc) -> int:
        if self.type != SMType.ON_DISK:
            return 0
        return self.sm.open(stopc)

    def batched_update(self, entries: List[SMEntry]) -> List[SMEntry]:
        if self.type == SMType.REGULAR:
            with self._mu:
                for e in entries:
                    e.result = self.sm.update(e)
                return entries
        return self.sm.update(entries)

    def lookup(self, query):
        if self.type == SMType.REGULAR:
            with self._mu:
                return self.sm.lookup(query)
        return self.sm.lookup(query)

    def sync(self) -> None:
        if self.type == SMType.ON_DISK:
            self.sm.sync()

    def prepare_snapshot(self):
        if self.type == SMType.REGULAR:
            return None
        return self.sm.prepare_snapshot()

    def save_snapshot(
        self,
        ctx,
        w: BinaryIO,
        files: Optional[ISnapshotFileCollection],
        done,
    ) -> None:
        if self.type == SMType.REGULAR:
            with self._mu:
                self.sm.save_snapshot(w, files, done)
        elif self.type == SMType.CONCURRENT:
            self.sm.save_snapshot(ctx, w, files, done)
        else:
            self.sm.save_snapshot(ctx, w, done)

    def recover_from_snapshot(self, r: BinaryIO, files, done) -> None:
        if self.type == SMType.ON_DISK:
            self.sm.recover_from_snapshot(r, done)
        else:
            self.sm.recover_from_snapshot(r, files, done)

    def close(self) -> None:
        self.sm.close()
