"""Deterministic placement planner: ClusterView -> ordered MovePlan.

Pure policy, no I/O.  Invariants, in priority order:

1. **drain** — zero member replicas on a draining host: every such
   replica gets a ``replace`` to the least-loaded target host not
   already holding the shard.
2. **repair** — replication factor restored after host loss: members on
   dead hosts are replaced; under-replicated shards (member count below
   the factor with nothing to replace) get an ``add``; surplus members
   (ghosts left by a killed move's failed rollback) get a ``remove``.
3. **spread** — member-replica counts across target hosts within ±1
   (what makes ``join(host)`` pull load onto a new host).
4. **leaders** — leader counts across target hosts within ±1, via pure
   leadership transfers (cheapest move, so it runs last, after the
   replica topology has settled).

Determinism contract (mirrors ``faults.FaultController``): the planner
is seeded, every iteration runs in sorted order, candidate selection
breaks ties by ``(count, host_key)``, and the seeded RNG is re-created
per ``plan()`` call — so the same seed and the same view (by
``describe()``) produce a byte-identical plan, across processes and
hash randomization.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from random import Random
from typing import Dict, List, Optional, Tuple

from .view import ClusterView, ShardView

MOVE_KINDS = ("replace", "add", "remove", "transfer")


@dataclass(frozen=True)
class Move:
    """One planned move.

    * ``replace``: add ``new_replica_id`` on ``dst_host``, wait for
      catch-up, transfer leadership off ``src_replica_id`` if it leads,
      remove ``src_replica_id`` (on ``src_host``; the host may be dead,
      the removal still goes through the survivors' quorum).
    * ``add``: the first half only (restore replication factor).
    * ``remove``: trim ``src_replica_id`` only — a surplus member (a
      ghost left by a killed move's failed rollback, or an
      over-replicated shard); nothing to roll back.
    * ``transfer``: leadership transfer to ``new_replica_id`` (an
      existing member), no membership change.
    """

    kind: str
    shard_id: int
    src_host: str = ""
    src_replica_id: int = 0
    dst_host: str = ""
    new_replica_id: int = 0

    def __post_init__(self):
        if self.kind not in MOVE_KINDS:
            raise ValueError(f"unknown move kind: {self.kind!r}")

    def describe(self) -> str:
        return (
            f"{self.kind}(shard={self.shard_id},"
            f"src={self.src_replica_id}@{self.src_host},"
            f"dst={self.new_replica_id}@{self.dst_host})"
        )


@dataclass
class MovePlan:
    """An ordered move schedule; ``describe()`` is the canonical
    byte-form used by the determinism tests."""

    moves: List[Move] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.moves)

    def __iter__(self):
        return iter(self.moves)

    def describe(self) -> str:
        return "\n".join(m.describe() for m in self.moves)


class Planner:
    def __init__(self, seed: int = 0, replication_factor: int = 3,
                 balance_replicas: bool = True):
        self.seed = seed
        self.replication_factor = replication_factor
        self.balance_replicas = balance_replicas

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _pick_least_loaded(
        counts: Dict[str, int], exclude, rng: Random,
        chips: Optional[Dict[str, int]] = None,
    ) -> Optional[str]:
        """Least-loaded candidate host; ties broken by sorted key, the
        rng only shuffles among EXACT ties to avoid always hammering
        the lexically-first host (deterministic: same seed, same draw
        sequence).

        ``chips`` weights load by per-host chip capacity (the
        multi-chip placement dimension, ROADMAP 3): an 8-chip host
        should carry ~8x a 1-chip host's replicas, so candidates rank
        by count/chips — compared exactly via cross-multiplication
        against the chip LCM-free integer key count*K/chips where K is
        the product-free common scale (count * prod(other chips) is
        overkill; count * SCALE // chips with SCALE = lcm-ish 10^6 is
        ample for integral determinism at any real fleet size)."""
        if chips:
            def key(h, c):
                return (c * 1_000_000) // max(1, chips.get(h, 1))
        else:
            def key(h, c):
                return c
        cands = sorted(
            (key(h, c), h) for h, c in counts.items() if h not in exclude
        )
        if not cands:
            return None
        best = [h for c, h in cands if c == cands[0][0]]
        return best[rng.randrange(len(best))] if len(best) > 1 else best[0]

    def plan(self, view: ClusterView, trim_live=frozenset()) -> MovePlan:
        """``trim_live``: shard ids whose surplus has PERSISTED across
        enough passes that trimming a live member is safe (the
        Balancer's streak counter supplies it).  A single view showing
        a live surplus may be transiently stale — a remove committed
        but not yet applied at the reporting replica — so live members
        are only trimmed on this explicit, stability-backed signal."""
        rng = Random(self.seed)
        trim_live = set(trim_live)
        targets = view.target_hosts()
        moves: List[Move] = []
        if not targets:
            return MovePlan(moves)
        # per-host chip capacities (all 1 on single-chip fleets, where
        # every decision below is byte-identical to the unweighted
        # planner); None disables the weighting entirely
        chips = {h: view.chips_of(h) for h in targets}
        if all(n <= 1 for n in chips.values()):
            chips = None
        draining = set(view.draining)
        alive = set(view.hosts)
        counts = {h: 0 for h in targets}
        leaders = {h: 0 for h in targets}
        # projected post-plan placement: shard -> {host: replica_id}
        placement: Dict[int, Dict[str, int]] = {}
        # projected leader host per shard (a replaced leader hands off
        # to its replacement; the executor realizes exactly that)
        leader_at: Dict[int, str] = {}
        next_id: Dict[int, int] = {}
        for s in view.shards:
            placement[s.shard_id] = {h: rid for rid, h in s.members}
            next_id[s.shard_id] = s.next_replica_id
            leader_at[s.shard_id] = s.leader_host
            for _, h in s.members:
                if h in counts:
                    counts[h] += 1
            if s.leader_host in leaders:
                leaders[s.leader_host] += 1

        def do_replace(shard_id: int, src_host: str, src_rid: int,
                       dst: str) -> None:
            new_rid = next_id[shard_id]
            next_id[shard_id] = new_rid + 1
            moves.append(Move(
                kind="replace", shard_id=shard_id,
                src_host=src_host, src_replica_id=src_rid,
                dst_host=dst, new_replica_id=new_rid,
            ))
            pl = placement[shard_id]
            pl.pop(src_host, None)
            pl[dst] = new_rid
            if src_host in counts:
                counts[src_host] -= 1
            counts[dst] += 1
            if leader_at[shard_id] == src_host:
                leader_at[shard_id] = dst
                if src_host in leaders:
                    leaders[src_host] -= 1
                leaders[dst] += 1

        # -- 1. drain + 2. repair (one sorted pass over shards) ----------
        for s in view.shards:
            pl = placement[s.shard_id]
            evict = sorted(
                (h, rid) for h, rid in pl.items()
                if h in draining or h not in alive
            )
            for src_host, src_rid in evict:
                pl = placement[s.shard_id]
                if len(pl) > self.replication_factor:
                    # surplus member on a draining/dead host (a replace
                    # whose final remove failed): a cheap remove-only
                    # finishes the job — no new replica needed
                    moves.append(Move(
                        kind="remove", shard_id=s.shard_id,
                        src_host=src_host, src_replica_id=src_rid,
                    ))
                    pl.pop(src_host, None)
                    if src_host in counts:
                        counts[src_host] -= 1
                    if leader_at[s.shard_id] == src_host:
                        leader_at[s.shard_id] = ""  # raft re-elects
                    continue
                dst = self._pick_least_loaded(counts, set(pl), rng, chips)
                if dst is None:
                    # every target already holds the shard (fewer
                    # survivors than the factor): the drain invariant
                    # outranks the factor — shrink by removing the
                    # draining/dead member, mirroring the repair path's
                    # min(factor, len(targets)) cap.  Without this a
                    # 3-host/rf-3 drain can never converge.
                    moves.append(Move(
                        kind="remove", shard_id=s.shard_id,
                        src_host=src_host, src_replica_id=src_rid,
                    ))
                    pl.pop(src_host, None)
                    if src_host in counts:
                        counts[src_host] -= 1
                    if leader_at[s.shard_id] == src_host:
                        leader_at[s.shard_id] = ""  # raft re-elects
                    continue
                do_replace(s.shard_id, src_host, src_rid, dst)
            # under-replicated with nothing left to evict: pure adds
            while len(placement[s.shard_id]) < min(
                self.replication_factor, len(targets)
            ):
                pl = placement[s.shard_id]
                dst = self._pick_least_loaded(counts, set(pl), rng, chips)
                if dst is None:
                    break
                new_rid = next_id[s.shard_id]
                next_id[s.shard_id] = new_rid + 1
                moves.append(Move(
                    kind="add", shard_id=s.shard_id,
                    dst_host=dst, new_replica_id=new_rid,
                ))
                pl[dst] = new_rid
                counts[dst] += 1
            # surplus members (ghosts left by a killed move's failed
            # rollback): trim back to the factor — GHOSTS ONLY (members
            # with no live replica).  A healthy member must never be
            # auto-trimmed: the collector's membership can transiently
            # show a surplus (a remove committed but not yet applied at
            # the most-applied replica), and trimming a live member on
            # that stale view would shrink a healthy shard.  A ghost
            # remove is idempotently safe — if the membership already
            # dropped it, the executor's goal poll succeeds instantly.
            pl = placement[s.shard_id]
            surplus = len(pl) - self.replication_factor
            if surplus > 0:
                live_hosts = {r.host for r in s.replicas}
                ghosts = sorted(
                    (h, rid) for h, rid in pl.items() if h not in live_hosts
                )
                cands = ghosts
                if s.shard_id in trim_live and len(ghosts) < surplus:
                    # stability-backed: an interrupted spread/leader
                    # replace rolled forward, leaving a live extra voter
                    # on a healthy host that no other invariant touches;
                    # trim non-leaders first, newest replica id first
                    cands = ghosts + sorted(
                        ((h, rid) for h, rid in pl.items()
                         if h in live_hosts),
                        key=lambda hv: (hv[0] == leader_at[s.shard_id],
                                        -hv[1], hv[0]),
                    )
                for host, rid in cands[:surplus]:
                    moves.append(Move(
                        kind="remove", shard_id=s.shard_id,
                        src_host=host, src_replica_id=rid,
                    ))
                    pl.pop(host, None)
                    if host in counts:
                        counts[host] -= 1

        # -- 3. spread: member counts within ±1 across targets ----------
        if self.balance_replicas and len(counts) > 1:
            # per-chip load when chip capacities differ: hi/lo rank by
            # count/chips (exact integer key), and a move happens only
            # while it cannot overshoot — the donor's per-chip load
            # AFTER the move stays >= the recipient's (exact
            # cross-multiplication).  With all chips equal (any value,
            # not just 1) this is bit-for-bit the old count diff <= 1
            ch = chips or {}

            def _load(h):
                return (counts[h] * 1_000_000) // max(1, ch.get(h, 1))

            for _ in range(len(view.shards) * len(targets)):
                hi = max(sorted(counts), key=_load)
                lo = min(sorted(counts), key=_load)
                c_hi, c_lo = max(1, ch.get(hi, 1)), max(1, ch.get(lo, 1))
                if (counts[hi] - 1) * c_lo < (counts[lo] + 1) * c_hi:
                    break
                # move a shard from hi to lo; prefer non-leader replicas
                # (cheaper move: no transfer leg)
                cand = None
                for s in view.shards:
                    pl = placement[s.shard_id]
                    if hi not in pl or lo in pl:
                        continue
                    if leader_at[s.shard_id] != hi:
                        cand = s
                        break
                    cand = cand or s
                if cand is None:
                    break
                do_replace(cand.shard_id, hi, placement[cand.shard_id][hi], lo)

        # -- 4. leaders: counts within ±1 via pure transfers -------------
        if len(leaders) > 1:
            for _ in range(len(view.shards)):
                hi = max(sorted(leaders), key=lambda h: leaders[h])
                lo = min(sorted(leaders), key=lambda h: leaders[h])
                if leaders[hi] - leaders[lo] <= 1:
                    break
                moved = False
                for s in view.shards:
                    pl = placement[s.shard_id]
                    if leader_at[s.shard_id] != hi or lo not in pl:
                        continue
                    # skip shards already touched by a membership move:
                    # their leadership settles as part of that move
                    if any(m.shard_id == s.shard_id and m.kind != "transfer"
                           for m in moves):
                        continue
                    moves.append(Move(
                        kind="transfer", shard_id=s.shard_id,
                        src_host=hi, src_replica_id=pl.get(hi, 0),
                        dst_host=lo, new_replica_id=pl[lo],
                    ))
                    leader_at[s.shard_id] = lo
                    leaders[hi] -= 1
                    leaders[lo] += 1
                    moved = True
                    break
                if not moved:
                    break
        return MovePlan(moves)

    # -- load-reactive pass (docs/BALANCE.md "Load-reactive rebalancing")
    def plan_spread_hot(
        self, view: ClusterView, hot_shards, *, max_moves: int = 1
    ) -> MovePlan:
        """Seeded, pure spread-hot pass: for each HOT shard (the
        Balancer's hysteresis-vetted set), move its leader off the
        current leader host onto the coldest target host — by pure
        ``transfer`` when the shard already has a member there (the
        cheap move), else by ``replace`` of the leader replica (the
        executor's replace realizes the leadership handoff).  Ranking
        is combined leader+member pressure (leaders weigh 1000x: the
        serving plane's commit path runs through leaders), ties break
        through ``_pick_least_loaded``'s seeded shuffle, and projected
        counts advance per move so multiple hot shards cannot dogpile
        one cold host.  ``max_moves`` clamps the whole pass — the
        thrash guard's last line."""
        rng = Random(self.seed)
        targets = view.target_hosts()
        moves: List[Move] = []
        if not targets or max_moves < 1:
            return MovePlan(moves)
        chips = {h: view.chips_of(h) for h in targets}
        if all(n <= 1 for n in chips.values()):
            chips = None
        counts = {h: 0 for h in targets}
        leaders = {h: 0 for h in targets}
        next_id: Dict[int, int] = {}
        placement: Dict[int, Dict[str, int]] = {}
        for s in view.shards:
            placement[s.shard_id] = {h: rid for rid, h in s.members}
            next_id[s.shard_id] = s.next_replica_id
            for _, h in s.members:
                if h in counts:
                    counts[h] += 1
            if s.leader_host in leaders:
                leaders[s.leader_host] += 1

        def pressure():
            return {h: leaders[h] * 1_000 + counts[h] for h in targets}

        for shard_id in sorted(set(hot_shards)):
            if len(moves) >= max_moves:
                break
            s = view.shard(shard_id)
            if s is None or not s.leader_host or s.leader_host not in counts:
                continue
            pl = placement[shard_id]
            cold = self._pick_least_loaded(
                pressure(), {s.leader_host}, rng, chips
            )
            if cold is None:
                continue
            # already the coldest placement: moving gains nothing (and
            # a transfer to an equally-hot host would just thrash)
            if (leaders[cold] * 1_000 + counts[cold]
                    >= leaders[s.leader_host] * 1_000 + counts[s.leader_host]):
                continue
            if cold in pl:
                moves.append(Move(
                    kind="transfer", shard_id=shard_id,
                    src_host=s.leader_host,
                    src_replica_id=pl.get(s.leader_host, 0),
                    dst_host=cold, new_replica_id=pl[cold],
                ))
            else:
                new_rid = next_id[shard_id]
                next_id[shard_id] = new_rid + 1
                moves.append(Move(
                    kind="replace", shard_id=shard_id,
                    src_host=s.leader_host,
                    src_replica_id=pl.get(s.leader_host, 0),
                    dst_host=cold, new_replica_id=new_rid,
                ))
                pl.pop(s.leader_host, None)
                pl[cold] = new_rid
                if s.leader_host in counts:
                    counts[s.leader_host] -= 1
                counts[cold] += 1
            leaders[s.leader_host] -= 1
            leaders[cold] += 1
        return MovePlan(moves)
