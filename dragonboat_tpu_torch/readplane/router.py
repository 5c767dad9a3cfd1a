"""Replica-aware read routing: power-of-two-choices on observed p99.

The gateway learns each shard's full replica set from the gossip-fed
collector view (gateway/routing.py); this router decides WHICH replica
serves a follower/bounded read.  Uniform random spreads load but keeps
hammering a slow replica at full weight; least-loaded needs global
state.  Power-of-two-choices is the classic middle: sample two
replicas, send to the one with the lower OBSERVED p99 — load-dependent
enough to starve a degraded replica, stateless enough to stay one dict
probe per read (Mitzenmacher's "two choices" result; the paper's
read fan-out motivation).

Thread model: ``pick``/``observe`` run on gateway worker threads.  All
shared state is per-host ``_Lat`` cells in a dict — inserts use
``setdefault`` (GIL-atomic), observations are single-writer-ish ring
writes where a lost sample is harmless, and ``pick`` only reads.  No
locks on the read path (gateway-hot rule, gateway/routing.py).
"""
from __future__ import annotations

import random
from typing import Dict, Iterable, Optional, Sequence


class _Lat:
    """Per-replica latency reservoir -> amortized p99 estimate.

    A 128-sample ring; the p99 is recomputed every 32 observations
    (sorting 128 floats per READ would be pure overhead, per-32 keeps
    the estimate at most a blink stale).  Unobserved replicas report
    p99 = 0.0 so new/idle replicas get explored rather than shunned.
    """

    CAP = 128
    RECOMPUTE_EVERY = 32

    __slots__ = ("ring", "n", "idx", "p99", "_since")

    def __init__(self):
        self.ring = [0.0] * self.CAP
        self.n = 0
        self.idx = 0
        self.p99 = 0.0
        self._since = 0

    def observe(self, seconds: float) -> None:
        self.ring[self.idx] = seconds
        self.idx = (self.idx + 1) % self.CAP
        if self.n < self.CAP:
            self.n += 1
        self._since += 1
        if self._since >= self.RECOMPUTE_EVERY:
            self._since = 0
            live = sorted(self.ring[: self.n])
            self.p99 = live[min(self.n - 1, int(0.99 * self.n))]


class ReadRouter:
    """Pick a serving replica host for follower/bounded reads.

    ``pick(hosts)`` is power-of-two-choices on per-host observed p99;
    ``observe(host, seconds)`` feeds each read's measured latency back.
    ``penalize(host)`` records a failure as a worst-case observation so
    a dark replica loses the next few coin flips without any explicit
    liveness plumbing (the breaker in gateway/rpc.py handles true
    darkness; this only biases selection away meanwhile)."""

    PENALTY_S = 5.0  # one failed read weighs like a 5s response

    __slots__ = ("_lat", "_rng")

    def __init__(self, seed: int = 0xD0B0A7):
        self._lat: Dict[str, _Lat] = {}
        # own Random instance: the router must not perturb (or be
        # perturbed by) global random state, and a fixed default seed
        # keeps single-threaded tests deterministic
        self._rng = random.Random(seed)

    # -- feedback ----------------------------------------------------
    def observe(self, host: str, seconds: float) -> None:
        cell = self._lat.get(host)
        if cell is None:
            cell = self._lat.setdefault(host, _Lat())
        cell.observe(seconds)

    def penalize(self, host: str) -> None:
        self.observe(host, self.PENALTY_S)

    def p99(self, host: str) -> float:
        cell = self._lat.get(host)
        return cell.p99 if cell is not None else 0.0

    # -- selection ----------------------------------------------------
    def pick(
        self,
        hosts: Sequence[str],
        exclude: Optional[Iterable[str]] = None,
    ) -> Optional[str]:
        """Two-choice pick over ``hosts`` (minus ``exclude``); None when
        no candidate remains.  One candidate short-circuits; two or
        more sample two DISTINCT indices and keep the lower p99."""
        if exclude:
            ex = set(exclude)
            hosts = [h for h in hosts if h not in ex]
        n = len(hosts)
        if n == 0:
            return None
        if n == 1:
            return hosts[0]
        rng = self._rng
        i = rng.randrange(n)
        j = rng.randrange(n - 1)
        if j >= i:
            j += 1
        a, b = hosts[i], hosts[j]
        return a if self.p99(a) <= self.p99(b) else b

    def snapshot(self) -> Dict[str, float]:
        """{host: observed p99 seconds} for stats/ledger surfaces."""
        return {h: c.p99 for h, c in self._lat.items()}
