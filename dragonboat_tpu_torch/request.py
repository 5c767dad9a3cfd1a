"""Pending-operation futures connecting the public API to the step loop.

reference: request.go (RequestState, pendingProposal, pendingReadIndex,
pendingConfigChange, pendingSnapshot, pendingLeaderTransfer) [U].

Timeouts are logical: deadlines are in ticks, swept by the node's tick
path, so behavior is reproducible and cheap at high request rates.
"""
from __future__ import annotations

import enum
import random
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .client import Session
from .pb import Entry, EntryType, SystemCtx
from .statemachine import Result

# Pending-table keys ride Entry.key across every boundary as a uint64
# (transport/wire._w_entry, the tan WAL, kvlogdb — docs/PARITY.md 64-bit
# policy), and read-index keys additionally split into two sub-2^31
# SystemCtx halves for the device inbox's int32 hint lanes
# (PendingReadIndex.read).  Bases are therefore 61-bit: keys stay below
# 2^62 with >= 2^61 increments of headroom, the low/high ctx split stays
# injective, and the wire codecs never see an out-of-range value.
KEY_BASE_BITS = 61
_SYSRAND = random.SystemRandom()


def random_key_base() -> int:
    """Random per-table key base (reference: every node seeds its
    keyGenerator randomly at start [U]).  Sequential-from-zero keys were
    the ROADMAP latent: every table of every replica counted 1, 2, 3 …,
    so a follower's brief in-flight local proposal could share a key
    with a leader-origin committed entry and ``applied(e.key, …)`` would
    complete the WRONG future — a false ack.  With per-table random
    bases a cross-table/cross-replica/cross-incarnation collision needs
    the counters' live windows to overlap within ~2^61."""
    return _SYSRAND.getrandbits(KEY_BASE_BITS)


class RequestError(Exception):
    pass


class ShardNotFound(RequestError):
    pass


class ShardNotReady(RequestError):
    pass


class InvalidTarget(RequestError):
    pass


class SystemBusy(RequestError):
    pass


class RequestResultCode(enum.IntEnum):
    TIMEOUT = 0
    COMPLETED = 1
    TERMINATED = 2
    REJECTED = 3
    DROPPED = 4
    ABORTED = 5
    COMMITTED = 6  # notify-commit mode: committed but not yet applied


class RequestState:
    """A single pending operation's future (reference: RequestState [U]).

    ``span`` is the request's root trace span (obs/; None when tracing
    is off or the request unsampled): every completion path funnels
    through ``notify``, so ending it here covers applied, dropped,
    timed-out, terminated and sealed futures alike."""

    __slots__ = ("key", "deadline", "_event", "code", "result", "_committed",
                 "span")

    def __init__(self, key: int, deadline: int):
        self.key = key
        self.deadline = deadline
        self._event = threading.Event()
        self.code: Optional[RequestResultCode] = None
        self.result: Result = Result()
        self._committed = False
        self.span = None

    # -- completion (engine side) ---------------------------------------
    def notify(self, code: RequestResultCode, result: Optional[Result] = None):
        self.code = code
        if result is not None:
            self.result = result
        s = self.span
        if s is not None:
            s.end(status=code.name if code is not None else "unknown")
        self._event.set()

    def notify_committed(self):
        self._committed = True

    # -- waiting (client side) -------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> RequestResultCode:
        if not self._event.wait(timeout):
            return RequestResultCode.TIMEOUT
        return self.code  # type: ignore[return-value]

    def completed(self) -> bool:
        return self.code == RequestResultCode.COMPLETED


# deadline-hint sentinel: "no pending deadline".  An int (not inf) so
# the lock-free `tick >= hint[0]` probe stays int-vs-int.  Far above
# any reachable tick count (ticks are ~100 ms; 2^62 ticks is ~1.4e10
# years) yet small enough to never overflow arithmetic around it.
NO_DEADLINE = 1 << 62


class _PendingBase:
    __slots__ = ("_lock", "_next_key", "_pending", "_hint")

    def __init__(
        self,
        lock: Optional[threading.Lock] = None,
        key_base: Optional[int] = None,
        deadline_hint: Optional[list] = None,
    ):
        # a node's five tables share one lock (pass it in): contention
        # is per-replica and tiny, while 4 saved locks x 50k rows is
        # real host footprint
        self._lock = lock if lock is not None else threading.Lock()
        self._pending: Dict[int, RequestState] = {}  # guarded-by: _lock
        # randomized unless the owner supplies one (Node salts with the
        # replica id); see random_key_base for why 0 was a correctness bug
        self._next_key = (  # guarded-by: _lock
            random_key_base() if key_base is None else key_base
        )
        # earliest-pending-deadline hint, shared across a node's five
        # tables (a 1-element list cell, like the lock): _alloc lowers
        # it under _lock; gc_tables re-arms it after a sweep.  The tick
        # path probes it LOCK-FREE (`tick >= hint[0]`) — a stale-high
        # read (probe raced a concurrent _alloc's lowering) only delays
        # that future's timeout to the next tick sweep, the same benign
        # race the lock-free `_pending` probe in gc() already accepts;
        # a stale-low read (pop/seal/drop_all never raise it) costs one
        # no-op sweep that re-arms it.
        self._hint = deadline_hint if deadline_hint is not None else [
            NO_DEADLINE
        ]

    def _alloc(self, deadline: int) -> RequestState:
        with self._lock:
            self._next_key += 1
            rs = RequestState(self._next_key, deadline)
            self._pending[self._next_key] = rs
            if deadline < self._hint[0]:
                self._hint[0] = deadline  # guarded-by: _lock
            return rs

    def pop(self, key: int) -> Optional[RequestState]:
        with self._lock:
            return self._pending.pop(key, None)

    def dropped(self, key: int) -> None:
        rs = self.pop(key)
        if rs is not None:
            rs.notify(RequestResultCode.DROPPED)

    def gc(self, now_tick: int) -> None:
        # raftlint: ignore[guarded-by] lock-free empty probe (benign race, see below)
        if not self._pending:
            # lock-free empty check: the sweep runs five-tables deep per
            # tick per replica row — at 50k rows that is millions of
            # no-op lock acquisitions per second.  The race is benign: a
            # request registered concurrently is swept next tick.
            return
        with self._lock:
            self._gc_locked(now_tick)

    def _gc_locked(self, now_tick: int) -> int:  # guarded-by: _lock
        """Sweep under a held ``self._lock`` and return the surviving
        minimum deadline (``NO_DEADLINE`` when empty) so batched
        callers (:func:`gc_tables`) can re-arm the shared hint."""
        expired = [
            k for k, rs in self._pending.items() if rs.deadline <= now_tick
        ]
        for k in expired:
            self._pending.pop(k).notify(RequestResultCode.TIMEOUT)
        if expired:
            self._gc_extra(set(expired))
        nd = NO_DEADLINE
        for rs in self._pending.values():
            if rs.deadline < nd:
                nd = rs.deadline
        return nd

    def _gc_extra(self, expired_keys) -> None:  # guarded-by: _lock
        """Subclass hook, called under self._lock, to drop side-table state
        for expired keys."""

    def drop_all(self, code: RequestResultCode = RequestResultCode.TERMINATED):
        with self._lock:
            keys = set(self._pending)
            for rs in self._pending.values():
                rs.notify(code)
            self._pending.clear()
            if keys:
                self._gc_extra(keys)

    def seal(self, rs: RequestState) -> None:
        """Terminate a just-allocated future whose node stopped
        concurrently.  ``Node.stop()`` runs ``drop_all`` right after
        setting ``stopped``; a producer that allocated AFTER the sweep
        would otherwise leave a future that no step loop will ever
        complete and no tick will ever GC — a hung caller and a leaked
        table entry (the history recorder counts on Terminated being
        delivered).  Pop-once keeps the double-notify race with
        drop_all benign.  ``_gc_extra`` runs UNCONDITIONALLY: a
        read-index allocates its future and inserts its ctx-map entry
        under two separate lock holds, so drop_all can sweep between
        them — the swept key's late ctx insert must still be cleaned
        here even though the future itself is already notified."""
        with self._lock:
            notified = self._pending.pop(rs.key, None) is not None
            self._gc_extra({rs.key})
        if notified:
            rs.notify(RequestResultCode.TERMINATED)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)


def gc_tables(tables, hint, now_tick: int) -> None:
    """One hint-gated sweep over a node's pending tables — the batched
    replacement for five per-table ``gc()`` calls per tick/generation.

    ``tables`` must share ONE lock and ONE deadline-hint cell (the
    ``Node`` construction; asserted under ``__debug__``): the whole
    sweep then runs under a single lock acquisition, and the hint
    re-arm cannot race a concurrent ``_alloc``'s lowering (both are
    serialized by the same lock).

    Exactness (the monotone-deadline argument, kept honest): deadlines
    are fixed at allocation and ``now_tick`` is monotone, so a future
    times out at exactly the first sweep whose ``now_tick`` reaches its
    deadline.  The hint is the min pending deadline, therefore the
    first tick at which ANY future could expire is precisely the first
    tick at which this function sweeps — every timeout is delivered at
    the same tick value the old sweep-every-tick loop delivered it at,
    while ticks below the hint (the overwhelming majority) cost one
    int compare instead of five lock-acquiring sweeps.
    """
    if now_tick < hint[0]:
        return
    lock = tables[0]._lock
    assert all(t._lock is lock and t._hint is hint for t in tables), (
        "gc_tables requires tables sharing one lock + hint cell"
    )
    with lock:
        nd = NO_DEADLINE
        for t in tables:
            d = t._gc_locked(now_tick)
            if d < nd:
                nd = d
        hint[0] = nd  # guarded-by: the shared tables lock


class PendingProposal(_PendingBase):
    __slots__ = ()
    """reference: pendingProposal (sharded by key in the reference; a
    single dict suffices under the GIL) [U]."""

    def propose(
        self, session: Session, cmd: bytes, deadline: int
    ) -> Tuple[Entry, RequestState]:
        rs = self._alloc(deadline)
        entry = Entry(
            type=EntryType.APPLICATION,
            key=rs.key,
            client_id=session.client_id,
            series_id=session.series_id,
            responded_to=session.responded_to,
            cmd=cmd,
        )
        return entry, rs

    def applied(self, key: int, result: Result, rejected: bool) -> None:
        rs = self.pop(key)
        if rs is None:
            return
        code = (
            RequestResultCode.REJECTED if rejected else RequestResultCode.COMPLETED
        )
        rs.notify(code, result)

    def committed(self, key: int) -> None:
        with self._lock:
            rs = self._pending.get(key)
        if rs is not None:
            rs.notify_committed()


class PendingReadIndex(_PendingBase):
    __slots__ = ("_ctx_map", "_waiting")
    """reference: pendingReadIndex [U].  Two stages: (1) ctx confirmed by
    quorum -> learn the read index; (2) applied index reaches it ->
    complete."""

    def __init__(
        self,
        lock: Optional[threading.Lock] = None,
        key_base: Optional[int] = None,
        deadline_hint: Optional[list] = None,
    ):
        super().__init__(lock, key_base, deadline_hint)
        self._ctx_map: Dict[Tuple[int, int], int] = {}  # ctx->key; guarded-by: _lock
        self._waiting: List[Tuple[int, int]] = []  # (read_index, key); guarded-by: _lock

    def _gc_extra(self, expired_keys) -> None:  # guarded-by: _lock
        self._ctx_map = {
            c: k for c, k in self._ctx_map.items() if k not in expired_keys
        }
        self._waiting = [
            (i, k) for i, k in self._waiting if k not in expired_keys
        ]

    def read(self, deadline: int) -> Tuple[SystemCtx, RequestState]:
        rs = self._alloc(deadline)
        # each half stays < 2^31 so the ctx can ride the device inbox's
        # int32 hint fields (ops/engine.py device ReadIndex) and every
        # wire codec without sign trouble; keys are sequential from a
        # 61-bit randomized base, so the split stays injective
        ctx = SystemCtx(
            low=rs.key & 0x7FFFFFFF, high=(rs.key >> 31) & 0x7FFFFFFF
        )
        with self._lock:
            self._ctx_map[(ctx.low, ctx.high)] = rs.key
        return ctx, rs

    def confirmed(self, ctx: SystemCtx, index: int) -> None:
        with self._lock:
            key = self._ctx_map.pop((ctx.low, ctx.high), None)
            if key is None or key not in self._pending:
                return
            self._waiting.append((index, key))

    def dropped(self, ctx: SystemCtx) -> None:
        with self._lock:
            key = self._ctx_map.pop((ctx.low, ctx.high), None)
        if key is None:
            return
        rs = self.pop(key)
        if rs is not None:
            rs.notify(RequestResultCode.DROPPED)

    def applied(self, applied_index: int) -> None:
        """Called as the apply loop advances; completes reads whose index
        has been reached."""
        ready: List[int] = []
        with self._lock:
            still = []
            for index, key in self._waiting:
                if index <= applied_index:
                    ready.append(key)
                else:
                    still.append((index, key))
            self._waiting = still
        for key in ready:
            rs = self.pop(key)
            if rs is not None:
                rs.notify(RequestResultCode.COMPLETED)


class PendingConfigChange(_PendingBase):
    __slots__ = ()
    def request(self, cc, deadline: int) -> Tuple[int, RequestState]:
        rs = self._alloc(deadline)
        return rs.key, rs

    def applied(self, key: int, rejected: bool) -> None:
        rs = self.pop(key)
        if rs is None:
            return
        rs.notify(
            RequestResultCode.REJECTED if rejected else RequestResultCode.COMPLETED
        )


class PendingSnapshot(_PendingBase):
    __slots__ = ()
    def request(self, deadline: int) -> RequestState:
        return self._alloc(deadline)

    def done(self, key: int, index: int, failed: bool = False) -> None:
        rs = self.pop(key)
        if rs is None:
            return
        if failed:
            rs.notify(RequestResultCode.REJECTED)
        else:
            rs.notify(RequestResultCode.COMPLETED, Result(value=index))


class PendingLeaderTransfer(_PendingBase):
    __slots__ = ()
    def request(self, target: int, deadline: int) -> RequestState:
        return self._alloc(deadline)

    def notify_leader(self, leader_id: int) -> None:
        with self._lock:
            keys = list(self._pending)
            for k in keys:
                self._pending.pop(k).notify(
                    RequestResultCode.COMPLETED, Result(value=leader_id)
                )
