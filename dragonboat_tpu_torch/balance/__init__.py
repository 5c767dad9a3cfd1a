"""Shard placement & rebalancing control plane.

The missing policy layer above the NodeHost mechanisms: a collector
aggregating per-shard stats into a :class:`ClusterView`, a
deterministic seeded :class:`Planner` computing moves toward the
placement invariants (zero shards on draining hosts, replication
factor restored after host loss, replica and leader counts within ±1),
and a :class:`MoveExecutor` realizing each move as the safe
add -> catchup -> transfer -> remove sequence with rollback.
:class:`Balancer` is the public handle.  See docs/BALANCE.md.
"""
from .balancer import Balancer, DrainTimeout, HotTracker, LoadPolicy
from .executor import BalanceAborted, MoveExecutor, MoveFailed
from .planner import Move, MovePlan, Planner
from .view import ClusterView, Collector, ReplicaView, ShardLoad, ShardView

__all__ = [
    "Balancer",
    "DrainTimeout",
    "HotTracker",
    "LoadPolicy",
    "BalanceAborted",
    "MoveExecutor",
    "MoveFailed",
    "Move",
    "MovePlan",
    "Planner",
    "ClusterView",
    "Collector",
    "ReplicaView",
    "ShardLoad",
    "ShardView",
]
