"""ReadIndex protocol bookkeeping on the leader.

reference: internal/raft/readindex.go [U].  Pending requests form an
ordered queue keyed by the client-supplied ``SystemCtx``; a quorum of
heartbeat-resp acks carrying the ctx confirms every request at or before
that ctx in queue order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..pb import SystemCtx


@dataclass
class ReadStatus:
    index: int
    from_: int
    ctx: SystemCtx
    confirmed: Set[int] = field(default_factory=set)


class ReadIndex:
    __slots__ = ("pending", "queue")
    def __init__(self):
        self.pending: Dict[Tuple[int, int], ReadStatus] = {}
        self.queue: List[Tuple[int, int]] = []

    def clear(self) -> None:
        self.pending.clear()
        self.queue.clear()

    def add_request(self, index: int, ctx: SystemCtx, from_: int) -> None:
        key = (ctx.low, ctx.high)
        if key in self.pending:
            return
        self.pending[key] = ReadStatus(index=index, from_=from_, ctx=ctx)
        self.queue.append(key)

    def confirm(
        self, ctx: SystemCtx, from_: int, quorum: int
    ) -> Optional[List[ReadStatus]]:
        """Ack from ``from_`` for ``ctx``; on quorum, pop and return every
        request at or before ctx in queue order."""
        key = (ctx.low, ctx.high)
        status = self.pending.get(key)
        if status is None:
            return None
        status.confirmed.add(from_)
        # +1: the leader itself implicitly acks
        if len(status.confirmed) + 1 < quorum:
            return None
        done = 0
        out: List[ReadStatus] = []
        for k in self.queue:
            done += 1
            s = self.pending.pop(k)
            out.append(s)
            if k == key:
                break
        self.queue = self.queue[done:]
        return out

    def drop(self, ctx: SystemCtx) -> Optional[ReadStatus]:
        """Remove one pending request (e.g. the leader refused it)."""
        key = (ctx.low, ctx.high)
        s = self.pending.pop(key, None)
        if s is not None:
            self.queue.remove(key)
        return s

    def has_pending(self) -> bool:
        return bool(self.queue)

    def peek_ctx(self) -> Optional[SystemCtx]:
        if not self.queue:
            return None
        low, high = self.queue[-1]
        return SystemCtx(low=low, high=high)
