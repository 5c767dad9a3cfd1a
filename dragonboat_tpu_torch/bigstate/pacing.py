"""Snapshot-stream pacing: a shared token bucket + a cap feedback loop.

reference: dragonboat's MaxSnapshotSendBytesPerSecond [U], upgraded for
the big-state plane: the cap is ONE bucket shared by every concurrent
stream job of a host (the old per-stream deficit pacing let N parallel
catch-ups each take the full rate — N laggards multiplied the cap), and
the rate is runtime-adjustable so a feedback loop can trade catch-up
speed against commit-path latency (``CapFeedback``, the LatencyBudget
discipline applied to background bandwidth).

Deliberately stdlib-only: the transport layer imports this at module
load and must not drag the storage/rsm stack with it.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class TokenBucket:
    """Byte-rate limiter shared by concurrent snapshot stream jobs.

    Tokens accrue at ``rate`` bytes/second up to ``burst_seconds`` of
    headroom (idle time banks at most one burst — a stream that paused
    must not slam the wire to "catch up" on banked credit).  Debt is
    never forgiven: a chunk larger than one burst drives the balance
    negative and the next ``throttle`` sleeps it off, so the long-run
    average respects the cap exactly.

    ``throttle(n)`` is the one call sites use: charge ``n`` bytes, sleep
    until the balance clears, return the seconds slept (the
    ``snapshot_stream_throttle_seconds_total`` metric).  Sleeps are
    sliced so ``should_abort`` (transport close) interrupts promptly.
    ``set_rate`` retunes a LIVE bucket — the cap feedback loop adjusts
    mid-stream without tearing transfers down.
    """

    def __init__(self, rate: float, burst_seconds: float = 0.1):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self._lock = threading.Lock()
        self._rate = float(rate)  # guarded-by: _lock
        self._burst_s = float(burst_seconds)
        self._tokens = 0.0  # byte balance; negative = debt; guarded-by: _lock
        self._last = time.monotonic()  # guarded-by: _lock
        self.throttled_seconds = 0.0  # cumulative sleep (metrics scrape)

    @property
    def rate(self) -> float:
        # raftlint: ignore[guarded-by] scrape-time float read (GIL-atomic)
        return self._rate

    def set_rate(self, rate: float) -> None:
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        with self._lock:
            # re-clock at the old rate first so the accrued credit/debt
            # reflects time actually spent at that rate
            self._accrue_locked()
            self._rate = float(rate)

    def _accrue_locked(self) -> None:  # guarded-by: _lock
        now = time.monotonic()
        self._tokens = min(
            self._tokens + (now - self._last) * self._rate,
            self._burst_s * self._rate,
        )
        self._last = now

    def _charge(self, nbytes: int) -> float:
        """Charge and return the seconds until the balance clears."""
        with self._lock:
            self._accrue_locked()
            self._tokens -= nbytes
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self._rate

    def throttle(
        self, nbytes: int, should_abort: Optional[Callable[[], bool]] = None
    ) -> float:
        slept = 0.0
        wait = self._charge(nbytes)
        while wait > 0:
            if should_abort is not None and should_abort():
                break
            step = min(wait, 0.05)
            time.sleep(step)
            slept += step
            with self._lock:
                self._accrue_locked()
                wait = (
                    -self._tokens / self._rate if self._tokens < 0 else 0.0
                )
        if slept:
            with self._lock:
                self.throttled_seconds += slept
        return slept


class CapFeedback:
    """Shrink the stream cap when the commit path degrades; recover when
    it is healthy — the ``LatencyBudget`` discipline applied to
    background bandwidth (docs/BIGSTATE.md "cap feedback").

    The loop owner (bench harness, an operator thread, a future engine
    hook) feeds commit latencies via ``observe`` — typically by sharing
    the same ``client.LatencyBudget`` the proposers already feed — and
    calls ``tick()`` periodically:

    * observed p99 above ``target_p99``  -> multiplicative decrease
      (``shrink``x, floored at ``floor_rate``): catch-up yields to the
      commit path immediately;
    * p99 at/below target               -> multiplicative recovery
      (``grow``x, capped at ``base_rate``): the cap creeps back so a
      transient stall doesn't strand the laggard at the floor.

    AIMD keeps it stable: decrease is fast, recovery is geometric but
    capped, and the floor guarantees catch-up always progresses.
    """

    def __init__(
        self,
        bucket: TokenBucket,
        *,
        base_rate: float,
        target_p99: float,
        floor_rate: Optional[float] = None,
        shrink: float = 0.5,
        grow: float = 1.25,
        budget=None,
        window: int = 128,
    ):
        if not (0 < shrink < 1 < grow):
            raise ValueError(f"need 0 < shrink < 1 < grow, got {shrink}/{grow}")
        self.bucket = bucket
        self.base_rate = float(base_rate)
        self.floor_rate = float(floor_rate or base_rate / 16.0)
        self.target_p99 = float(target_p99)
        self.shrink = shrink
        self.grow = grow
        # either a shared client.LatencyBudget (duck-typed: .p99()) or
        # the internal window fed through observe()
        self._budget = budget
        self._lock = threading.Lock()
        self._lat: list = []  # guarded-by: _lock
        self._window = window
        self.adjustments = 0  # rate changes applied (observability)

    def observe(self, secs: float) -> None:
        with self._lock:
            self._lat.append(secs)
            if len(self._lat) > self._window:
                del self._lat[: -self._window]

    def _p99(self) -> Optional[float]:
        if self._budget is not None:
            try:
                return self._budget.p99()
            except Exception:  # noqa: BLE001 — budget without samples
                return None
        with self._lock:
            lat = list(self._lat)
        if not lat:
            return None
        lat.sort()
        return lat[min(len(lat) - 1, int(len(lat) * 0.99))]

    def tick(self) -> float:
        """One control step; returns the (possibly adjusted) rate."""
        p99 = self._p99()
        rate = self.bucket.rate
        if p99 is None:
            return rate
        if p99 > self.target_p99:
            new = max(self.floor_rate, rate * self.shrink)
        else:
            new = min(self.base_rate, rate * self.grow)
        if new != rate:
            self.bucket.set_rate(new)
            self.adjustments += 1
        return new
