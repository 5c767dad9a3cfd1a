"""Read plane: replica read fan-out with explicit consistency levels.

The write plane funnels every proposal through the leader row; a
read-heavy "millions of users" profile must NOT funnel every query the
same way (ROADMAP item 2, read half).  This package names the three
read contracts the stack serves and routes them to the right replica:

* ``LINEARIZABLE`` — leader only: the CheckQuorum lease fast path with
  the ReadIndex quorum round as fallback (docs/GATEWAY.md).
* ``FOLLOWER_LINEARIZABLE`` — any voting replica: the follower issues
  the ReadIndex confirmation round to the leader (the raft layer
  forwards via the ``from_ != self`` path), waits ``applied >= index``
  and serves from its LOCAL state machine.  Linearizable, leader does
  one message round but zero state-machine work.
* ``BOUNDED_STALENESS`` — any replica, immediately: served from the
  local state machine, stamped with the replica's applied index and
  its staleness in ticks since last leader contact; SHED when the
  stamp would exceed the caller's bound.

Safety arguments and the consistency-level contract: docs/READPLANE.md.
Routing (replica sets + power-of-two-choices on observed per-replica
p99) lives in :mod:`.router`; the gateway wires it to the gossip-fed
collector view.
"""
from .consistency import (
    BOUND_TICKS_DEFAULT,
    Consistency,
    PATH_BOUNDED,
    PATH_FOLLOWER,
    PATH_LEASE,
    PATH_READ_INDEX,
    READ_PATHS,
    ReadResult,
    ReadUnsupported,
    STALENESS_TICK_BOUNDS,
    StaleBoundExceeded,
)
from .router import ReadRouter

__all__ = [
    "BOUND_TICKS_DEFAULT",
    "Consistency",
    "PATH_BOUNDED",
    "PATH_FOLLOWER",
    "PATH_LEASE",
    "PATH_READ_INDEX",
    "READ_PATHS",
    "ReadResult",
    "ReadRouter",
    "ReadUnsupported",
    "STALENESS_TICK_BOUNDS",
    "StaleBoundExceeded",
]
