"""Env-gated post-warm-up stall sentry (the port's counterpart of the
reference's recompile sentry, ``dragonboat_tpu/analysis/jitcheck.py``).

The reference watches JAX trace caches: a program traced after the
engines' warm-up is a mid-run compile, which stalls the launch pipeline
for seconds.  The port traces nothing — its kernels are built ahead of
time and keyed on no shape — but three other things stall a launch that
the warm-up should have paid for:

* a device allocation the caching allocator holds no free block for
  (``cudaMalloc``); when that fails, the allocator frees every cached
  block and retries, which synchronizes the whole device;
* a pinned host allocation of a size the pinned pool has not held yet
  (``cudaHostAlloc``, the readback buffers of ``ops/colocated.py``);
* the kernel extension's build or load (``ops/_native.py``).

PyTorch counts the first two; ``_native.BUILDS`` counts the third.  The
sentry watches these counters in place of trace-cache sizes:

* every engine ``_warm()`` calls :func:`mark_warm` (gated on
  ``ENABLED`` — one attribute load when off), snapshotting each counter;
* :func:`retraces` reports every counter that GREW since the snapshot —
  something paid, after warm-up, a cost the warm-up was meant to pay.

The default entries (:func:`default_entries`) read 0 on a process that
has not initialised CUDA, as the reference's cache size reads 0 for a
function that is not jitted; reading them never initialises CUDA.

The switch is ``DRAGONBOAT_TPU_JITCHECK`` (the reference's): off by
default, free when off.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

ENABLED = os.environ.get("DRAGONBOAT_TPU_JITCHECK", "0") not in ("", "0")

Counter = Callable[[], int]


def enable(on: bool = True) -> None:
    """Programmatic switch (tests)."""
    global ENABLED
    ENABLED = on


def _device_stat(key: str) -> int:
    """``torch.cuda.memory_stats()[key]`` summed over the visible
    devices (a device this process never used reads 0); 0 before the
    process initialises CUDA, which the read never does."""
    if not torch.cuda.is_initialized():
        return 0
    return sum(int(torch.cuda.memory_stats(d).get(key, 0))
               for d in range(torch.cuda.device_count()))


def _host_allocs() -> int:
    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.host_memory_stats().get("num_host_alloc", 0))


def _native_builds() -> int:
    from ..ops import _native  # lazy: ops imports this module

    return _native.BUILDS


def default_entries() -> List[Tuple[str, Counter]]:
    """The (name, counter) pairs the default sentry watches."""
    return [
        ("cuda.device_alloc", lambda: _device_stat("num_device_alloc")),
        ("cuda.alloc_retries", lambda: _device_stat("num_alloc_retries")),
        ("cuda.sync_all_streams",
         lambda: _device_stat("num_sync_all_streams")),
        ("cuda.host_alloc", _host_allocs),
        ("native.builds", _native_builds),
    ]


class Sentry:
    """Counter watcher over a (name, counter) list, ``counter()`` giving
    a monotone int.

    The default instance watches :func:`default_entries`; tests
    construct their own over fixture counters."""

    def __init__(self, entries: Optional[Sequence[Tuple[str, Counter]]]
                 = None):
        self._entries = entries
        self._snap: Optional[Dict[str, int]] = None

    def entries(self) -> Sequence[Tuple[str, Counter]]:
        if self._entries is not None:
            return self._entries
        return default_entries()

    def snapshot(self) -> Dict[str, int]:
        return {name: int(fn()) for name, fn in self.entries()}

    def mark(self) -> None:
        """Declare 'warmup is complete as of now'."""
        self._snap = self.snapshot()

    def retraces(self) -> List[Tuple[str, int, int]]:
        """(name, at_mark, now) for entries whose counter grew since the
        last mark; empty when never marked (nothing to compare)."""
        if self._snap is None:
            return []
        now = self.snapshot()
        return [
            (name, before, now[name])
            for name, before in self._snap.items()
            if now.get(name, before) > before
        ]


_DEFAULT = Sentry()


def mark_warm() -> None:
    """Called by the engines at the end of ``_warm()`` (and by a drive
    once its warm-up traffic has run) — resets the post-warmup
    baseline."""
    _DEFAULT.mark()


def retraces() -> List[Tuple[str, int, int]]:
    return _DEFAULT.retraces()


def format_retraces(rows) -> str:
    return "\n".join(
        f"  {name}: {before} -> {now} (post-warmup stall)"
        for name, before, now in rows
    )
