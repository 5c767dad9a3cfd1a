"""Server-side client sessions: the exactly-once dedupe registry.

reference: internal/rsm/session.go + sessionmanager.go [U].  An LRU of
``client_id -> Session{responded_to, history: series_id -> Result}``;
session create/close are raft entries themselves so the registry is
identical on every replica, and it is serialized into every snapshot.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .. import settings
from ..statemachine import Result


@dataclass
class Session:
    client_id: int
    responded_to: int = 0
    history: Dict[int, Result] = field(default_factory=dict)

    def add_response(self, series_id: int, result: Result) -> None:
        if series_id in self.history:
            raise RuntimeError(f"series {series_id} already responded")
        self.history[series_id] = result

    def get_response(self, series_id: int) -> Tuple[Optional[Result], bool]:
        if series_id in self.history:
            return self.history[series_id], True
        return None, False

    def has_responded(self, series_id: int) -> bool:
        return series_id <= self.responded_to

    def clear_to(self, responded_to: int) -> None:
        if responded_to <= self.responded_to:
            return
        self.responded_to = responded_to
        for sid in [s for s in self.history if s <= responded_to]:
            del self.history[sid]


class SessionManager:
    def __init__(self, max_sessions: Optional[int] = None):
        self._lru: "OrderedDict[int, Session]" = OrderedDict()
        self._max = max_sessions or settings.Hard.lru_max_session_count
        # diagnostic counters (NOT serialized into snapshots — they are
        # per-replica evidence for the audit harness, not state):
        # dedupe_hits   = retried proposals answered from the cache
        #                 instead of re-applying (exactly-once at work)
        # responded_rejects = copies of an already-responded series
        #                 rejected without applying
        self.dedupe_hits = 0
        self.responded_rejects = 0

    def register(self, client_id: int) -> Result:
        if client_id in self._lru:
            self._lru.move_to_end(client_id)
        else:
            self._lru[client_id] = Session(client_id=client_id)
            while len(self._lru) > self._max:
                self._lru.popitem(last=False)
        return Result(value=client_id)

    def unregister(self, client_id: int) -> Result:
        if client_id in self._lru:
            del self._lru[client_id]
            return Result(value=client_id)
        return Result(value=0)

    def get(self, client_id: int) -> Optional[Session]:
        s = self._lru.get(client_id)
        if s is not None:
            self._lru.move_to_end(client_id)
        return s

    def count(self) -> int:
        return len(self._lru)

    # -- snapshot (de)serialization --------------------------------------
    # session tables ship inside snapshot payloads over the chunk lane,
    # i.e. they are decoded from untrusted network bytes — positional
    # binary via the wire codec, never pickle
    def serialize(self) -> bytes:
        from ..transport.wire import encode_session_table

        return encode_session_table(
            (s.client_id, s.responded_to, s.history)
            for s in self._lru.values()
        )

    @classmethod
    def deserialize(cls, data: bytes, max_sessions: Optional[int] = None):
        from ..transport.wire import decode_session_table

        sm = cls(max_sessions)
        for client_id, responded_to, history in decode_session_table(data):
            sm._lru[client_id] = Session(
                client_id=client_id,
                responded_to=responded_to,
                history=dict(history),
            )
        return sm
