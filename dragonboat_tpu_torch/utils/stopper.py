"""Stopper: owned-thread lifecycle management.

reference: internal/utils/syncutil -> Stopper [U] — every goroutine the
reference spawns registers with a Stopper; Close() signals ShouldStop
and joins them all, so shutdown is deterministic and leak-checkable.
The same contract here for Python threads: components create a Stopper,
spawn workers through ``run_worker``, poll ``should_stop`` (or wait on
it) in their loops, and ``stop()`` joins everything with a deadline.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional


class Stopper:
    def __init__(self, name: str = "stopper"):
        self.name = name
        self._should_stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()

    @property
    def should_stop(self) -> threading.Event:
        return self._should_stop

    def stopping(self) -> bool:
        return self._should_stop.is_set()

    def run_worker(
        self, fn: Callable[[], None], name: Optional[str] = None
    ) -> threading.Thread:
        """Spawn a managed worker.  ``fn`` must return promptly once
        ``should_stop`` is set."""
        if self._should_stop.is_set():
            raise RuntimeError(f"{self.name}: already stopped")
        t = threading.Thread(
            target=fn, name=name or f"{self.name}-worker", daemon=True
        )
        with self._lock:
            self._threads.append(t)
        t.start()
        return t

    def stop(self, timeout: float = 5.0) -> List[str]:
        """Signal + join all workers; returns the names of any that did
        not exit within the deadline (callers may assert it is empty —
        the leaktest contract)."""
        self._should_stop.set()
        with self._lock:
            threads = list(self._threads)
            self._threads.clear()
        leaked = []
        for t in threads:
            t.join(timeout=timeout)
            if t.is_alive():
                leaked.append(t.name)
        return leaked
