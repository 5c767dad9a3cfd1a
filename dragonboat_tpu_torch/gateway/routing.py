"""Leader-routing cache: shard -> leader host, without per-call discovery.

The table is a plain dict REPLACED WHOLESALE on every write
(copy-on-write under ``_lock``); the read path grabs the current dict
in one attribute load and never takes a lock — the same snapshot-read
discipline as ``metrics.export_text`` (raftlint's ``gateway-hot`` rule
pins it: a ``# gateway-hot`` function must not acquire anything).
Correctness does not depend on freshness: a stale entry routes a
proposal to a follower, which FORWARDS it to the leader
(raft._step_follower), and a lease read on a non-leader simply fails
the ``lease_held`` gate and falls back to ReadIndex — the cache is a
latency optimization, invalidation keeps it from staying slow.

Fed two ways (docs/GATEWAY.md "Routing"):

* events: each registered host's ``EventFanout`` tap pushes
  ``leader_updated`` (the leader's own self-observation learns the
  route; a leaderless observation invalidates) and ``balance_move_*``
  (a move in flight means membership/leadership is about to change —
  drop the entry and rediscover);
* bulk: ``refresh_from_view`` consumes the balance plane's
  ``ClusterView.leader_map()`` snapshot.

On a miss, ``resolve`` falls back to one O(hosts) discovery sweep.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..logger import get_logger

_log = get_logger("gateway")


class RoutingCache:
    """shard_id -> leader-host-key cache (see module docstring)."""

    def __init__(self, hosts: Callable[[], Dict[str, object]], metrics=None):
        # hosts: zero-arg callable returning the live key -> NodeHost
        # map (the gateway owns membership; re-read per discovery so
        # host churn is observed)
        self._hosts = hosts
        self._lock = threading.Lock()
        # the snapshot table: NEVER mutated in place — writers build a
        # fresh dict under _lock and swap the reference; readers load
        # self._table once and use it lock-free
        self._table: Dict[int, str] = {}
        # shard_id -> tuple of host keys carrying a replica (the read
        # plane's fan-out set, docs/READPLANE.md).  Same copy-on-write
        # discipline as _table.  Staleness is safe the same way the
        # leader table's is: a host that no longer carries the shard
        # fails the read (ShardNotFound), the router penalizes it and
        # the next refresh drops it — never a wrong VALUE, only a
        # wasted attempt.
        self._replicas: Dict[int, tuple] = {}
        nop = _Nop()
        self.hits = metrics.counter("gateway_route_hits_total") if metrics else nop
        self.misses = metrics.counter("gateway_route_misses_total") if metrics else nop
        self.invalidations = (
            metrics.counter("gateway_route_invalidations_total") if metrics else nop
        )

    # -- read path (hot) --------------------------------------------------
    def lookup(self, shard_id: int) -> Optional[str]:  # gateway-hot
        """Current route, or None.  NO locking: one dict load, one get."""
        host = self._table.get(shard_id)
        if host is not None:
            self.hits.add()
        return host

    def replicas(self, shard_id: int) -> tuple:  # gateway-hot
        """Known replica-host set, or ().  NO locking (see lookup)."""
        return self._replicas.get(shard_id, ())

    # -- write paths (cold: event-driven, not per-request) ---------------
    def learn(self, shard_id: int, host: str) -> None:
        with self._lock:
            t = dict(self._table)
            t[shard_id] = host
            self._table = t

    def learn_replicas(self, shard_id: int, hosts) -> None:
        with self._lock:
            r = dict(self._replicas)
            r[shard_id] = tuple(hosts)
            self._replicas = r

    def invalidate(self, shard_id: int) -> None:
        # leader route only: the replica set stays — followers still
        # serve reads through a leadership change (that's the point)
        with self._lock:
            if shard_id not in self._table:
                return
            t = dict(self._table)
            del t[shard_id]
            self._table = t
        self.invalidations.add()

    def invalidate_replicas(self, shard_id: int) -> None:
        with self._lock:
            if shard_id not in self._replicas:
                return
            r = dict(self._replicas)
            del r[shard_id]
            self._replicas = r

    def invalidate_all(self) -> None:
        with self._lock:
            n = len(self._table)
            self._table = {}
            self._replicas = {}
        if n:
            self.invalidations.add(n)

    def refresh_from_view(self, view) -> None:
        """Bulk refresh from a balance ``ClusterView``: leader_map for
        the proposal route, per-shard member hosts (intersected with
        the view's ALIVE hosts) for the read plane's replica sets.
        View entries WIN over cached ones — the collector's snapshot is
        newer than any event we might have missed; a shard's replica
        set is REPLACED wholesale so removed members drop out."""
        lm = view.leader_map()
        live = set(view.hosts)
        reps = {
            s.shard_id: tuple(h for h in s.member_hosts() if h in live)
            for s in view.shards
        }
        with self._lock:
            t = dict(self._table)
            t.update(lm)
            self._table = t
            r = dict(self._replicas)
            for sid, hs in reps.items():
                if hs:
                    r[sid] = hs
                else:
                    r.pop(sid, None)
            self._replicas = r

    # -- event tap (one closure per registered host) ----------------------
    def host_tap(self, host_key: str) -> Callable:
        """The ``EventFanout`` tap invalidating/learning routes from one
        host's events.  Runs synchronously on that host's posting
        thread: dict swaps only, nothing blocking."""

        def tap(name: str, args) -> None:
            if name == "leader_updated":
                info = args[0]
                if info.leader_id == 0:
                    # shard went leaderless as seen from this host —
                    # drop the route; proposals re-discover or forward
                    self.invalidate(info.shard_id)
                elif info.leader_id == info.replica_id:
                    # this host's own replica became leader: the one
                    # observation that maps leader REPLICA to host
                    self.learn(info.shard_id, host_key)
                # a follower learning some other leader is ignored: it
                # cannot map replica->host, and the leader's own event
                # carries the authoritative route
            elif name.startswith("balance_move_"):
                info = args[0] if args else None
                sid = getattr(info, "shard_id", None)
                if sid is not None:
                    self.invalidate(sid)
                    # membership is about to change: rediscover the
                    # replica set rather than read from a leaver
                    self.invalidate_replicas(sid)

        return tap

    # -- discovery fallback ------------------------------------------------
    def resolve(self, shard_id: int) -> Optional[str]:
        """Route with one discovery sweep on miss: ask every live host
        for its leader view of the shard; the host whose OWN replica id
        equals the leader id is the leader host.  Learned routes stick
        until invalidated."""
        host = self.lookup(shard_id)
        if host is not None:
            return host
        self.misses.add()
        hosts = self._hosts()
        for key, nh in sorted(hosts.items()):
            if getattr(nh, "_closed", False):
                continue
            try:
                if nh.is_leader_of(shard_id):
                    self.learn(shard_id, key)
                    return key
            except Exception:  # noqa: BLE001 — host closing mid-sweep
                continue
        return None

    def resolve_replicas(self, shard_id: int) -> tuple:
        """Replica-host set with one discovery sweep on miss: every
        live host that carries the shard (``_get_node`` answers) is a
        serving replica.  Works for in-proc hosts and remote handles
        alike (the remote probes its cached STATS rows).  Learned sets
        stick until a balance move or a view refresh replaces them."""
        reps = self.replicas(shard_id)
        if reps:
            return reps
        self.misses.add()
        found = []
        for key, nh in sorted(self._hosts().items()):
            if getattr(nh, "_closed", False):
                continue
            try:
                nh._get_node(shard_id)
                found.append(key)
            except Exception:  # noqa: BLE001 — shard not on this host
                continue
        if found:
            self.learn_replicas(shard_id, found)
        return tuple(found)

    def table(self) -> Dict[int, str]:
        """Snapshot for observability/tests."""
        return dict(self._table)

    def replica_table(self) -> Dict[int, tuple]:
        """Snapshot for observability/tests."""
        return dict(self._replicas)


class _Nop:
    __slots__ = ()

    def add(self, n: int = 1) -> None: ...
