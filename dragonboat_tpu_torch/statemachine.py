"""Public state-machine contracts — what users implement.

reference: statemachine/ (statemachine.go, concurrent.go, ondisk.go) [U].
Three tiers, exactly as the reference:

  * ``IStateMachine``           — simple in-memory SM, serialized access.
  * ``IConcurrentStateMachine`` — batched updates + concurrent snapshots.
  * ``IOnDiskStateMachine``     — SM owns its own durable storage; reports
                                  its applied index at ``open`` and only
                                  the log tail is replayed.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional, Tuple


@dataclass
class Result:
    """reference: statemachine.Result [U]."""

    value: int = 0
    data: bytes = b""


@dataclass
class SMEntry:
    """The entry view passed to user Update() (reference:
    statemachine.Entry [U])."""

    index: int = 0
    cmd: bytes = b""
    result: Result = field(default_factory=Result)


@dataclass
class SnapshotFile:
    file_id: int = 0
    filepath: str = ""
    metadata: bytes = b""


class ISnapshotFileCollection(abc.ABC):
    @abc.abstractmethod
    def add_file(self, file_id: int, path: str, metadata: bytes) -> None: ...


class IStateMachine(abc.ABC):
    """Simple in-memory SM (reference: statemachine.IStateMachine [U])."""

    @abc.abstractmethod
    def update(self, entry: SMEntry) -> Result: ...

    @abc.abstractmethod
    def lookup(self, query) -> object: ...

    @abc.abstractmethod
    def save_snapshot(
        self, w: BinaryIO, files: ISnapshotFileCollection, done
    ) -> None: ...

    @abc.abstractmethod
    def recover_from_snapshot(
        self, r: BinaryIO, files: List[SnapshotFile], done
    ) -> None: ...

    def close(self) -> None:
        pass


class IConcurrentStateMachine(abc.ABC):
    """Batched SM with concurrent snapshotting (reference:
    statemachine.IConcurrentStateMachine [U])."""

    @abc.abstractmethod
    def update(self, entries: List[SMEntry]) -> List[SMEntry]: ...

    @abc.abstractmethod
    def lookup(self, query) -> object: ...

    @abc.abstractmethod
    def prepare_snapshot(self) -> object: ...

    @abc.abstractmethod
    def save_snapshot(
        self, ctx, w: BinaryIO, files: ISnapshotFileCollection, done
    ) -> None: ...

    @abc.abstractmethod
    def recover_from_snapshot(
        self, r: BinaryIO, files: List[SnapshotFile], done
    ) -> None: ...

    def close(self) -> None:
        pass


class IOnDiskStateMachine(abc.ABC):
    """SM that manages its own durable state (reference:
    statemachine.IOnDiskStateMachine [U])."""

    @abc.abstractmethod
    def open(self, stopc) -> int:
        """Open/recover local state; return last applied raft index."""

    @abc.abstractmethod
    def update(self, entries: List[SMEntry]) -> List[SMEntry]: ...

    @abc.abstractmethod
    def lookup(self, query) -> object: ...

    @abc.abstractmethod
    def sync(self) -> None: ...

    @abc.abstractmethod
    def prepare_snapshot(self) -> object: ...

    @abc.abstractmethod
    def save_snapshot(self, ctx, w: BinaryIO, done) -> None: ...

    @abc.abstractmethod
    def recover_from_snapshot(self, r: BinaryIO, done) -> None: ...

    def close(self) -> None:
        pass


class SnapshotStopped(Exception):
    """Raise from save/recover when ``done`` is set (reference:
    statemachine.ErrSnapshotStopped [U])."""
