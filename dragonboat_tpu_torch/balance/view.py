"""Cluster view: the balance control plane's input snapshot.

The collector aggregates per-shard stats from every registered NodeHost
(``NodeHost.balance_shard_stats``: leader identity, applied index,
cumulative proposal count, membership) plus host liveness (host handle
present and not closed; cross-process deployments layer the gossip
registry's direct-contact signal, ``GossipManager.alive_peers``, on
top) into one immutable :class:`ClusterView`.  The planner is a pure
function of a view, so ``describe()`` gives the canonical byte-form
used by the determinism tests — two views are the same input iff their
describe() strings are equal (the same contract as
``faults.FaultPlan.describe``).

No reference equivalent: dragonboat deliberately stops at mechanism
(``RequestAddReplica``, leadership transfer) and leaves placement
policy to the user [U]; this subsystem is the missing policy layer.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from ..logger import get_logger

_log = get_logger("balance")


@dataclass(frozen=True)
class ReplicaView:
    """One live replica as observed on its host."""

    replica_id: int
    host: str          # host key (raft address)
    applied: int = 0
    is_leader: bool = False
    # chip coordinate of the replica's engine row on its host (-1:
    # host path / single device) — docs/MULTICHIP.md "Placement"
    device: int = -1


@dataclass(frozen=True)
class ShardView:
    """One shard's aggregated state.

    ``members`` is the authoritative replica_id -> host map from the
    most-applied live replica's membership; ``replicas`` are the live
    observations (a member on a dead host has no ReplicaView).
    ``next_replica_id`` is safe to assign to a NEW replica: above every
    current member AND every removed id (removed ids can never be
    re-added — rsm/membership rejects them).
    """

    shard_id: int
    members: Tuple[Tuple[int, str], ...]      # sorted (replica_id, host)
    replicas: Tuple[ReplicaView, ...]          # sorted by replica_id
    leader_replica_id: int = 0
    leader_host: str = ""
    next_replica_id: int = 1
    proposal_rate: int = 0    # proposals since the previous collect

    def member_hosts(self) -> Tuple[str, ...]:
        return tuple(h for _, h in self.members)

    def host_of(self, replica_id: int) -> Optional[str]:
        for rid, h in self.members:
            if rid == replica_id:
                return h
        return None

    def replica_on(self, host: str) -> Optional[int]:
        for rid, h in self.members:
            if h == host:
                return rid
        return None

    def describe(self) -> str:
        reps = ",".join(
            f"{r.replica_id}@{r.host}:{r.applied}{'*' if r.is_leader else ''}"
            for r in self.replicas
        )
        mem = ",".join(f"{rid}@{h}" for rid, h in self.members)
        return (
            f"shard({self.shard_id},members=[{mem}],live=[{reps}],"
            f"leader={self.leader_replica_id}@{self.leader_host},"
            f"next={self.next_replica_id},rate={self.proposal_rate})"
        )


@dataclass(frozen=True)
class ShardLoad:
    """One shard's serving-plane load evidence over the last collect
    window (docs/BALANCE.md "Load-reactive rebalancing").  ``p99_ms``
    is the gateway's observed commit p99 rounded to whole milliseconds
    (integers keep describe() byte-stable); ``submitted``/``shed`` are
    WINDOW DELTAS — the Collector differences the gateway's cumulative
    counters with the same first-sight baseline it uses for
    proposal_rate."""

    shard_id: int
    p99_ms: int = 0
    samples: int = 0
    submitted: int = 0
    shed: int = 0

    def describe(self) -> str:
        return (
            f"load({self.shard_id},p99={self.p99_ms}ms,"
            f"n={self.samples},sub={self.submitted},shed={self.shed})"
        )


@dataclass(frozen=True)
class ClusterView:
    """One collector pass over the whole cluster."""

    hosts: Tuple[str, ...]             # alive hosts, sorted
    draining: Tuple[str, ...]          # sorted subset being drained
    shards: Tuple[ShardView, ...]      # sorted by shard_id
    # per-host chip count (sorted (host, chips) pairs; hosts absent
    # here count as 1 chip) — the planner's capacity weights for the
    # multi-chip placement dimension (docs/MULTICHIP.md "Placement").
    # Default empty keeps single-chip fleets byte-identical.
    chips: Tuple[Tuple[str, int], ...] = ()
    # per-shard serving-plane load evidence (sorted by shard_id; empty
    # when no load source is attached — the default keeps existing
    # describe() baselines byte-identical, same opt-in as chips)
    load: Tuple[ShardLoad, ...] = ()

    def load_of(self, shard_id: int) -> Optional[ShardLoad]:
        for l in self.load:
            if l.shard_id == shard_id:
                return l
        return None

    def chips_of(self, host: str) -> int:
        for h, n in self.chips:
            if h == host:
                return max(1, n)
        return 1

    def target_hosts(self) -> Tuple[str, ...]:
        """Hosts moves may land on: alive and not draining."""
        d = set(self.draining)
        return tuple(h for h in self.hosts if h not in d)

    def shard(self, shard_id: int) -> Optional[ShardView]:
        for s in self.shards:
            if s.shard_id == shard_id:
                return s
        return None

    def replica_counts(self) -> Dict[str, int]:
        """Member-replica count per alive host (dead hosts excluded)."""
        counts = {h: 0 for h in self.hosts}
        for s in self.shards:
            for _, h in s.members:
                if h in counts:
                    counts[h] += 1
        return counts

    def leader_counts(self) -> Dict[str, int]:
        counts = {h: 0 for h in self.hosts}
        for s in self.shards:
            if s.leader_host in counts:
                counts[s.leader_host] += 1
        return counts

    def replicas_on(self, host: str) -> int:
        return sum(1 for s in self.shards for _, h in s.members if h == host)

    def leader_map(self) -> Dict[int, str]:
        """shard_id -> leader host, for shards with a known leader — the
        gateway routing cache's bulk-refresh input
        (gateway.RoutingCache.refresh_from_view)."""
        return {
            s.shard_id: s.leader_host
            for s in self.shards
            if s.leader_host
        }

    def describe(self) -> str:
        # chips appear in the canonical byte-form only when some host
        # is genuinely multi-chip: single-chip fleets keep the exact
        # pre-mesh describe() bytes (determinism baselines)
        chips = ""
        if any(n > 1 for _, n in self.chips):
            chips = f" chips={sorted(self.chips)!r}"
        body = (
            f"hosts={list(self.hosts)!r} draining={list(self.draining)!r}"
            f"{chips}\n"
            + "\n".join(s.describe() for s in self.shards)
        )
        # load rows follow the chips opt-in: only emitted when a load
        # source is attached, so pre-elastic baselines stay byte-exact
        if self.load:
            body += "\n" + ",".join(l.describe() for l in self.load)
        return body


class Collector:
    """Aggregates NodeHost stats into a ClusterView.

    Stateful only for proposal-rate derivation (previous cumulative
    counts); everything else is a pure snapshot.  ``alive`` overrides
    the liveness predicate — the default treats a registered,
    non-closed host as alive, which is exact for in-process fleets;
    cross-process deployments pass a gossip-backed predicate
    (``lambda key: nhid(key) in gm.alive_peers()``).
    """

    def __init__(
        self,
        alive: Optional[Callable[[str, object], bool]] = None,
        load_source: Optional[Callable[[], Dict[int, dict]]] = None,
    ):
        self._alive = alive
        # serving-plane evidence hook (``Gateway.shard_load``): absent
        # by default so membership-only deployments build byte-identical
        # views; failures degrade to "no load rows" (placement must
        # never depend on the gateway being up)
        self.load_source = load_source
        self._prev_load: Dict[int, Tuple[int, int]] = {}
        self._prev_proposals: Dict[int, int] = {}
        # hosts that reported last round: a host dropping out (liveness
        # flap, mid-collect failure) makes the round incomplete for the
        # rate baseline (see below)
        self._prev_reporters: set = set()
        # collect() advances the rate baseline, so concurrent callers
        # (the run loop's per-move collects + a monitoring thread's
        # view()) must serialize or proposal_rate becomes 'proposals
        # since whichever caller collected last'
        self._collect_lock = threading.Lock()

    def host_alive(self, key: str, nh) -> bool:
        if self._alive is not None:
            return self._alive(key, nh)
        return nh is not None and not getattr(nh, "_closed", False)

    def collect(self, hosts: Dict[str, object], draining=()) -> ClusterView:
        with self._collect_lock:
            return self._collect_locked(hosts, draining)

    def _collect_locked(self, hosts, draining) -> ClusterView:
        alive = sorted(k for k, nh in hosts.items() if self.host_alive(k, nh))
        # shard_id -> accumulated rows
        stats: Dict[int, list] = {}
        reporters = set()
        for key in alive:
            try:
                rows = hosts[key].balance_shard_stats()
            except Exception:  # noqa: BLE001 — host died mid-collect
                _log.warning("collect: host %s failed to report", key)
                continue
            reporters.add(key)
            for row in rows:
                stats.setdefault(row["shard_id"], []).append((key, row))
        # a round is COMPLETE for the rate baseline only if every host
        # that reported last round reported again: a host dropping out
        # (collect failure OR a liveness-predicate flap) shrinks the
        # cumulative sums, and advancing the baseline on that shrunken
        # total would fabricate a rate spike when the host returns
        complete = self._prev_reporters <= reporters
        self._prev_reporters = reporters
        shard_views = []
        for shard_id in sorted(stats):
            rows = stats[shard_id]
            # authoritative membership: the most-applied live replica's
            # (ties break on host key so the choice is deterministic)
            _, best = max(rows, key=lambda kr: (kr[1]["applied"], kr[0]))
            membership = best["membership"]
            members = tuple(sorted(
                (rid, addr) for rid, addr in membership.addresses.items()
            ))
            replicas = tuple(sorted(
                (
                    ReplicaView(
                        replica_id=row["replica_id"],
                        host=key,
                        applied=row["applied"],
                        is_leader=(row["leader_id"] == row["replica_id"]
                                   and row["leader_id"] != 0),
                        device=row.get("device", -1),
                    )
                    for key, row in rows
                ),
                key=lambda r: r.replica_id,
            ))
            # leader: a self-claim wins, and the HIGHEST-TERM self-claim
            # wins overall — during a handoff the old leader may not
            # have stepped down yet and still claims at a stale term
            # (otherwise: the majority view among live replicas)
            leader_id = 0
            claims = [
                (row["term"], row["replica_id"])
                for _, row in rows
                if row["leader_id"] and row["leader_id"] == row["replica_id"]
            ]
            if claims:
                leader_id = max(claims)[1]
            else:
                votes: Dict[int, int] = {}
                for _, row in rows:
                    if row["leader_id"]:
                        votes[row["leader_id"]] = votes.get(
                            row["leader_id"], 0) + 1
                if votes:
                    leader_id = max(sorted(votes), key=lambda k: votes[k])
            leader_host = ""
            for rid, h in members:
                if rid == leader_id:
                    leader_host = h
                    break
            ids = (
                [rid for rid, _ in members]
                + list(membership.non_votings)
                + list(membership.witnesses)
                + list(membership.removed)
                + [r.replica_id for r in replicas]
            )
            # rate baseline advances only on COMPLETE rounds: a host
            # failing to report mid-collect shrinks the cumulative sum,
            # and rewriting the baseline with that partial total would
            # fabricate a rate spike on the next full round
            total = sum(row["proposals"] for _, row in rows)
            prev = self._prev_proposals.get(shard_id, total)
            if complete:
                self._prev_proposals[shard_id] = total
            shard_views.append(
                ShardView(
                    shard_id=shard_id,
                    members=members,
                    replicas=replicas,
                    leader_replica_id=leader_id,
                    leader_host=leader_host,
                    next_replica_id=max(ids, default=0) + 1,
                    proposal_rate=max(0, total - prev),
                )
            )
        chips = []
        for key in alive:
            fn = getattr(hosts.get(key), "device_chip_count", None)
            if fn is None:
                continue
            try:
                n = int(fn())
            except Exception:  # noqa: BLE001 — host closing mid-collect
                n = 1
            if n > 1:
                chips.append((key, n))
        load_rows = []
        if self.load_source is not None:
            try:
                raw = self.load_source() or {}
            except Exception:  # noqa: BLE001 — gateway closing mid-collect
                raw = {}
            for sid in sorted(raw):
                row = raw[sid]
                sub = int(row.get("submitted", 0))
                shed = int(row.get("shed", 0))
                # first-sight baseline = current totals (delta 0), the
                # proposal_rate idiom; gateway counters are cumulative
                # and monotonic so the baseline always advances
                psub, pshed = self._prev_load.get(sid, (sub, shed))
                self._prev_load[sid] = (sub, shed)
                load_rows.append(ShardLoad(
                    shard_id=sid,
                    p99_ms=int(round(float(row.get("p99_s", 0.0)) * 1000)),
                    samples=int(row.get("samples", 0)),
                    submitted=max(0, sub - psub),
                    shed=max(0, shed - pshed),
                ))
        return ClusterView(
            hosts=tuple(alive),
            draining=tuple(sorted(set(draining))),
            shards=tuple(shard_views),
            chips=tuple(sorted(chips)),
            load=tuple(load_rows),
        )
