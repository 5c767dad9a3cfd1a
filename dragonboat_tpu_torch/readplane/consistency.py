"""Consistency levels and read-result stamps for the read plane.

The level names follow the dragonboat/etcd read taxonomy (ReadIndex /
lease read) extended with the two replica-served contracts
(docs/READPLANE.md).  Everything here is plain data — the protocol
work lives in raft/node/nodehost; the routing in .router and gateway/.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from ..request import RequestError


class Consistency(enum.IntEnum):
    """What the caller is promised about the value read.

    The int values double as the RPC consistency byte's LEVEL space —
    but note the wire flags (transport.wire.RPC_READ_*) are a separate
    enumeration that also carries the legacy lease/index/stale split;
    gateway/rpc.py maps between the two."""

    LINEARIZABLE = 0
    FOLLOWER_LINEARIZABLE = 1
    BOUNDED_STALENESS = 2


# canonical read-path labels (metrics `gateway_read_total{path=...}`,
# NodeHost.read_path_counts, scenario ledger columns)
PATH_LEASE = "lease"
PATH_READ_INDEX = "read_index"
PATH_FOLLOWER = "follower"
PATH_BOUNDED = "bounded"
READ_PATHS = (PATH_LEASE, PATH_READ_INDEX, PATH_FOLLOWER, PATH_BOUNDED)

# default staleness bound for BOUNDED_STALENESS, in ticks of the
# serving replica's logical clock.  50 ticks = 5 election windows at
# the test-default election_rtt=10: generous enough that a healthy
# follower (heartbeat every tick or two) never sheds, tight enough
# that a partitioned one sheds within one reroute interval.
BOUND_TICKS_DEFAULT = 50

# `readplane_staleness_ticks` histogram bucket bounds (ticks are
# integers; the metrics.Histogram default bounds are sub-second floats
# and would bucket every observation into +Inf)
STALENESS_TICK_BOUNDS = (0, 1, 2, 5, 10, 20, 50, 100, 200, 500)


class StaleBoundExceeded(RequestError):
    """BOUNDED_STALENESS shed: the serving replica cannot stamp the
    read within the caller's bound (leaderless, out of leader contact
    past the bound, or applied behind the leader's last-known commit).
    Retry elsewhere or escalate the consistency level."""


class ReadUnsupported(RequestError):
    """The remote server predates the readplane consistency byte (it
    answered ``unknown read mode``): degrade to a leader read."""


@dataclass
class ReadResult:
    """A read value plus its provenance stamp.

    ``path`` is one of READ_PATHS.  ``applied_index`` is the serving
    replica's applied index at lookup time (0 when the path does not
    stamp it).  ``staleness_ticks`` is the serving replica's ticks
    since last leader contact for BOUNDED_STALENESS (0 on the
    linearizable paths — they are, by contract, not stale).  ``host``
    is the serving host's raft address when routed by the gateway
    ("" for local NodeHost calls)."""

    value: object
    path: str
    applied_index: int = 0
    staleness_ticks: int = 0
    host: str = ""
