"""Env-gated runtime lock-order witness (the dynamic half of analysis/).

reference: upstream dragonboat runs its whole CI under the Go race
detector [U]; CPython has no race detector, but the deadlocks that
actually bit this port (EventFanout close, apply-vs-stop ordering) are
LOCK-ORDER bugs, which a cheap runtime witness can catch:

* ``install()`` wraps ``threading.Lock``/``threading.RLock`` so locks
  **created from project code** (caller file under ``dragonboat_tpu/``)
  are tracked; stdlib/jax internals keep real locks at zero overhead.
* Each tracked acquire records edges ``held-lock -> acquired-lock`` in
  a global lock-order graph, capturing the acquiring stack once per
  edge.  Any cycle — a potential deadlock, even if this run got lucky
  with timing — is reported with the witness stacks of every edge on
  the cycle.
* Waits longer than ``slow_wait_s`` while another lock is held are
  flagged (the "blocked inside a critical section" smell that raftlint
  can only approximate lexically).

The switch is ``DRAGONBOAT_TPU_LOCKCHECK`` (same pattern as
``invariants.py``): the test suite turns it on for the chaos/fault
modules in conftest.py, production defaults off and pays nothing — an
uninstalled witness leaves ``threading`` untouched.

Usage:
    from dragonboat_tpu.analysis import lockcheck
    w = lockcheck.install()
    try:
        ...  # run the workload
    finally:
        lockcheck.uninstall()
    w.assert_clean()          # raises LockOrderViolation on any cycle
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

ENABLED = os.environ.get("DRAGONBOAT_TPU_LOCKCHECK", "0") not in ("", "0")

# the REAL constructors, captured at import so uninstall always restores
# the genuine articles no matter how many installs happened
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_STACK_LIMIT = 16  # frames kept per witness stack


class LockOrderViolation(AssertionError):
    """A lock-order cycle (potential deadlock) was witnessed."""


def enable(on: bool = True) -> None:
    """Programmatic switch (tests)."""
    global ENABLED
    ENABLED = on


def _own_stack() -> List[str]:
    """Formatted acquiring stack, trimmed of lockcheck's own frames."""
    frames = traceback.extract_stack(limit=_STACK_LIMIT + 4)
    keep = [f for f in frames if os.path.basename(f.filename) != "lockcheck.py"]
    return traceback.format_list(keep[-_STACK_LIMIT:])


class _TrackedLock:
    """Wrapper around a real Lock/RLock feeding the witness graph.

    When the witness is inactive (uninstalled), every call is one
    attribute load + bool test away from the real lock."""

    __slots__ = ("_lk", "_w", "oid", "site", "reentrant")

    def __init__(self, real, witness: "Witness", site: str, reentrant: bool):
        self._lk = real
        self._w = witness
        self.site = site
        self.reentrant = reentrant
        self.oid = witness._register(self)

    # -- lock protocol ---------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        w = self._w
        if not w.active:
            return self._lk.acquire(blocking, timeout)
        return w._acquire(self, blocking, timeout)

    def release(self) -> None:
        w = self._w
        if w.active:
            w._note_release(self)
        self._lk.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __repr__(self) -> str:
        return f"<tracked {'RLock' if self.reentrant else 'Lock'} {self.site}>"

    # -- Condition integration -------------------------------------------
    # Condition binds these off the lock it is given; the underlying
    # real RLock provides them, a plain Lock does not — fall back to
    # CPython Condition's own plain-lock defaults in that case.
    def _is_owned(self):
        fn = getattr(self._lk, "_is_owned", None)
        if fn is not None:
            return fn()
        if self._lk.acquire(False):
            self._lk.release()
            return False
        return True

    def _release_save(self):
        # Condition.wait: the lock is FULLY released regardless of
        # recursion depth — drop every held-stack entry for it
        w = self._w
        if w.active:
            w._note_release(self, all_depths=True)
        fn = getattr(self._lk, "_release_save", None)
        if fn is not None:
            return fn()
        self._lk.release()
        return None

    def _acquire_restore(self, state) -> None:
        fn = getattr(self._lk, "_acquire_restore", None)
        if fn is not None:
            fn(state)
        else:
            self._lk.acquire()
        w = self._w
        if w.active:
            w._note_reacquired(self)

    def _at_fork_reinit(self) -> None:
        fn = getattr(self._lk, "_at_fork_reinit", None)
        if fn is not None:
            fn()


class Witness:
    """The global lock-order graph + per-thread held stacks."""

    def __init__(self, root: str, slow_wait_s: float):
        self.root = root
        self.slow_wait_s = slow_wait_s
        self.active = False
        self._glock = _REAL_LOCK()  # guards the graph (always a REAL lock)
        self._next_oid = 0
        self.sites: Dict[int, str] = {}  # oid -> creation site
        # edge (a, b): thread held a while acquiring b; stack captured once
        self.edges: Dict[Tuple[int, int], List[str]] = {}
        self.adj: Dict[int, Set[int]] = {}
        self.cycles: List[dict] = []
        self.slow_waits: List[dict] = []
        self.acquires = 0  # tracked-acquire count (overhead accounting)
        self._tls = threading.local()

    # -- bookkeeping -----------------------------------------------------
    def _register(self, tl: _TrackedLock) -> int:
        with self._glock:
            self._next_oid += 1
            oid = self._next_oid
            self.sites[oid] = tl.site
            return oid

    def _stack(self) -> List[_TrackedLock]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _acquire(self, tl: _TrackedLock, blocking: bool, timeout: float):
        held = self._stack()
        already = any(h is tl for h in held)
        got = tl._lk.acquire(False)
        waited = 0.0
        if not got:
            if not blocking:
                return False
            t0 = time.monotonic()
            got = tl._lk.acquire(True, timeout)
            waited = time.monotonic() - t0
        if not got:
            return False
        self.acquires += 1
        if held and not already:
            seen: Set[int] = set()
            for h in held:
                if h.oid != tl.oid and h.oid not in seen:
                    seen.add(h.oid)
                    self._edge(h, tl)
        if waited > self.slow_wait_s and any(h is not tl for h in held):
            with self._glock:
                self.slow_waits.append(
                    {
                        "lock": tl.site,
                        "held": [h.site for h in held if h is not tl],
                        "waited_s": round(waited, 4),
                        "thread": threading.current_thread().name,
                        "stack": _own_stack(),
                    }
                )
        held.append(tl)
        return True

    def _note_release(self, tl: _TrackedLock, all_depths: bool = False) -> None:
        held = self._stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is tl:
                del held[i]
                if not all_depths:
                    return

    def _note_reacquired(self, tl: _TrackedLock) -> None:
        # Condition.wait re-acquire: no edge recording — the wait's
        # whole point is that the lock was NOT held in between
        self._stack().append(tl)

    # -- the graph --------------------------------------------------------
    def _edge(self, a: _TrackedLock, b: _TrackedLock) -> None:
        key = (a.oid, b.oid)
        with self._glock:
            if key in self.edges:
                return
            self.edges[key] = _own_stack()
            self.adj.setdefault(a.oid, set()).add(b.oid)
            path = self._find_path(b.oid, a.oid)
        if path:
            # cycle: a -> b (new) plus path b -> ... -> a (existing)
            edge_list = [key] + list(zip(path, path[1:]))
            with self._glock:
                self.cycles.append(
                    {
                        "locks": [self.sites[o] for o in [a.oid, b.oid]]
                        + [self.sites[o] for o in path[1:]],
                        "edges": [
                            {
                                "from": self.sites[x],
                                "to": self.sites[y],
                                "stack": self.edges.get((x, y), []),
                            }
                            for x, y in edge_list
                        ],
                        "thread": threading.current_thread().name,
                    }
                )

    def _find_path(self, src: int, dst: int) -> Optional[List[int]]:
        """DFS path src -> dst in the order graph (called under _glock)."""
        stack = [(src, [src])]
        visited = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.adj.get(node, ()):
                if nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- reporting --------------------------------------------------------
    def make_lock(self, site: str = "explicit", reentrant: bool = False):
        """Explicitly-tracked lock (tests; code outside the root filter)."""
        real = _REAL_RLOCK() if reentrant else _REAL_LOCK()
        return _TrackedLock(real, self, site, reentrant)

    def report(self) -> dict:
        with self._glock:
            return {
                "tracked_locks": self._next_oid,
                "acquires": self.acquires,
                "edges": len(self.edges),
                "cycles": list(self.cycles),
                "slow_waits": list(self.slow_waits),
            }

    def format_cycles(self) -> str:
        out = []
        for c in self.cycles:
            out.append(
                "lock-order cycle (potential deadlock) witnessed by "
                f"thread {c['thread']}:\n  " + " -> ".join(c["locks"])
            )
            for e in c["edges"]:
                out.append(f"  edge {e['from']} -> {e['to']} acquired at:")
                out.extend("    " + ln.rstrip() for ln in e["stack"])
        return "\n".join(out)

    def assert_clean(self) -> None:
        if self.cycles:
            raise LockOrderViolation(self.format_cycles())


_witness: Optional[Witness] = None
_DEFAULT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def install(
    slow_wait_s: Optional[float] = None, root: Optional[str] = None
) -> Witness:
    """Patch threading.Lock/RLock so project-created locks are tracked.
    Returns the active Witness (idempotent while installed)."""
    global _witness
    if _witness is not None and _witness.active:
        return _witness
    if slow_wait_s is None:
        slow_wait_s = float(
            os.environ.get("DRAGONBOAT_TPU_LOCKCHECK_SLOW", "0.25")
        )
    w = Witness(root or _DEFAULT_ROOT, slow_wait_s)
    w.active = True

    def _site(depth: int = 2) -> Optional[str]:
        f = sys._getframe(depth)
        fn = f.f_code.co_filename
        if fn.startswith(w.root):
            return f"{os.path.relpath(fn, os.path.dirname(w.root))}:{f.f_lineno}"
        return None

    def lock_factory():
        site = _site()
        if w.active and site is not None:
            return _TrackedLock(_REAL_LOCK(), w, site, reentrant=False)
        return _REAL_LOCK()

    def rlock_factory():
        site = _site()
        if w.active and site is not None:
            return _TrackedLock(_REAL_RLOCK(), w, site, reentrant=True)
        return _REAL_RLOCK()

    threading.Lock = lock_factory
    threading.RLock = rlock_factory
    _witness = w
    return w


def uninstall() -> Optional[Witness]:
    """Restore the real constructors; returns the (now inactive) witness
    so callers can inspect/assert its report."""
    global _witness
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    w = _witness
    if w is not None:
        w.active = False
    _witness = None
    return w


def current() -> Optional[Witness]:
    return _witness
