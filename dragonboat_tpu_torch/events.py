"""Non-blocking fan-out of raft/system events to user listeners.

reference: event.go [U].  Listener callbacks run on a dedicated thread so
a slow listener can never stall the step loop; the queue is bounded and
drops under pressure, as the reference does — every drop increments
``event_fanout_dropped_total`` (the registry is passed in by NodeHost)
and the warning names the callback that lost its event.

``tap`` is the flight recorder's synchronous hook (obs/recorder.py): it
sees every SYSTEM event at post time, including ones the bounded queue
would drop — a recorder that misses state transitions under pressure
would be useless exactly when it matters.  ``add_tap``/``remove_tap``
attach further synchronous taps at runtime (the gateway's routing-cache
invalidation rides one); unlike the recorder tap these ALSO see
``leader_updated``, because leader identity is exactly what a routing
cache keys on.

Thread-safety is by construction, not by lock: ``_q``/``_stop`` are
inherently thread-safe, the listener/tap fields are written once in
``__init__`` and only read afterwards, and ``_taps`` is a copy-on-write
tuple (readers grab the whole tuple in one attribute load; writers swap
a fresh tuple under ``_taps_lock``) — so there is nothing here for a
``# guarded-by:`` annotation to guard on the read side.  The discipline
that DOES bind
this module is raftlint's ``block-under-lock`` rule: the PR 4 close()
deadlock (a blocking ``put`` wedged against a full queue) is its seeded
true-positive fixture (tests/test_analysis.py), and the non-blocking
``put_nowait``/timed-``get`` shape below is the sanctioned pattern.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from .logger import get_logger
from .raftio import IRaftEventListener, ISystemEventListener, LeaderInfo

_log = get_logger("nodehost")


class EventFanout:
    # NOT a subclass of ISystemEventListener: its concrete no-op
    # methods would shadow the __getattr__ forwarding below (normal
    # attribute lookup finds the inherited no-op, __getattr__ never
    # fires), silently dropping every system event — which is exactly
    # what happened until the balance control plane's event drive
    # caught it.  Duck typing is the contract; nothing isinstance-checks
    # the fanout.
    def __init__(
        self,
        raft_listener: Optional[IRaftEventListener] = None,
        system_listener: Optional[ISystemEventListener] = None,
        maxsize: int = 4096,
        metrics=None,
        tap: Optional[Callable] = None,
    ):
        self.raft_listener = raft_listener
        self.system_listener = system_listener
        self.tap = tap
        # runtime-attached synchronous taps (copy-on-write tuple; see
        # module docstring): called as fn(name, args) for every system
        # event AND leader_updated
        self._taps: tuple = ()
        self._taps_lock = threading.Lock()
        self._dropped = (
            metrics.counter("event_fanout_dropped_total")
            if metrics is not None
            else None
        )
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._main, daemon=True, name="tpu-raft-events"
        )
        self._thread.start()

    def add_tap(self, fn: Callable) -> None:
        """Attach a synchronous tap ``fn(name, args)``.  Taps run on the
        POSTING thread (the step worker for most events), so they must
        be cheap and non-blocking — a dict swap, a counter, never a
        lock that request paths contend on."""
        with self._taps_lock:
            self._taps = (*self._taps, fn)

    def remove_tap(self, fn: Callable) -> None:
        with self._taps_lock:
            self._taps = tuple(t for t in self._taps if t is not fn)

    def _run_taps(self, name: str, args) -> None:
        for t in self._taps:  # one attribute load; tuple is immutable
            try:
                t(name, args)
            except Exception:  # noqa: BLE001 — observability/routing
                # taps must never break the event path
                _log.exception("event tap raised")

    def close(self) -> None:
        self._stop.set()
        try:
            # non-blocking: a full queue means the drain thread has
            # items to chew through and will see _stop within one get
            # timeout; a blocking put here deadlocks when the thread
            # exits via the _stop check with the queue still full
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=1.0)

    def _main(self) -> None:
        # the get must be timed: when close()'s sentinel is dropped by
        # a full queue, an untimed get would block forever once the
        # backlog drains and the thread would leak past join()
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — listener bugs must not kill us
                _log.exception("event listener raised")

    def _post(self, fn, *args) -> None:
        try:
            self._q.put_nowait((fn, args))
        except queue.Full:
            if self._dropped is not None:
                self._dropped.add()
            _log.warning(
                "event queue full, dropping event for %s",
                getattr(fn, "__qualname__", None)
                or getattr(fn, "__name__", repr(fn)),
            )

    # -- raft events ------------------------------------------------------
    def leader_updated(self, info: LeaderInfo) -> None:
        if self._taps:
            self._run_taps("leader_updated", (info,))
        if self.raft_listener is not None:
            self._post(self.raft_listener.leader_updated, info)

    # -- system events ----------------------------------------------------
    def __getattr__(self, name):
        # forward any ISystemEventListener callback asynchronously
        if name.startswith("_"):
            raise AttributeError(name)
        base = getattr(ISystemEventListener, name, None)
        if base is None:
            raise AttributeError(name)

        def forward(*args):
            tap = self.tap
            if tap is not None:
                try:
                    tap(name, args)
                except Exception:  # noqa: BLE001 — observability must
                    # never break the event path
                    _log.exception("event tap raised")
            if self._taps:
                self._run_taps(name, args)
            if self.system_listener is not None:
                target = getattr(self.system_listener, name, None)
                if target is not None:
                    self._post(target, *args)

        return forward
