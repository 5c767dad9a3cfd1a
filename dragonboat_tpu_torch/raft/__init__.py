"""Pure raft protocol core (reference: internal/raft/ [U]).

No I/O anywhere in this package: the state machine is a pure function of
(state, message) -> (state', outputs), driven via ``Peer`` and observed via
``pb.Update``.  This is the semantic spec that the vectorized TPU step
kernel (``dragonboat_tpu.ops``) must reproduce bit-exactly on its hot path.
"""
from .raft import Raft, RaftRole
from .peer import Peer, PeerInfo
from .log import EntryLog, InMemory, InMemLogReader, LogCompactedError, LogUnavailableError

__all__ = [
    "Raft",
    "RaftRole",
    "Peer",
    "PeerInfo",
    "EntryLog",
    "InMemory",
    "InMemLogReader",
    "LogCompactedError",
    "LogUnavailableError",
]
