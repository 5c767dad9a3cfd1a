"""Serving front plane: session gateway, leader routing, overload
shedding, lease reads (docs/GATEWAY.md; ROADMAP item 4).

The ingress layer between "a NodeHost per process" and "millions of
clients": :class:`Gateway` multiplexes many cheap :class:`ClientHandle`
sessions onto batched per-shard proposal submissions, routes via a
lock-free-read :class:`RoutingCache` invalidated by
``leader_updated``/``balance_move_*`` events, sheds at the door under
overload (:class:`AdmissionController`, ``gateway_shed_total``), and
serves read-heavy traffic from the CheckQuorum leader lease
(``NodeHost.try_lease_read``) with a ReadIndex fallback.
"""
from .admission import AdmissionController
from .gateway import (
    ClientHandle,
    Gateway,
    GatewayBusy,
    GatewayClosed,
    GatewayConfig,
    GatewayFuture,
)
from .routing import RoutingCache
from .rpc import RemoteHostHandle, RouteFeeder, RpcServer

__all__ = [
    "AdmissionController",
    "ClientHandle",
    "Gateway",
    "GatewayBusy",
    "GatewayClosed",
    "GatewayConfig",
    "GatewayFuture",
    "RemoteHostHandle",
    "RouteFeeder",
    "RoutingCache",
    "RpcServer",
]
