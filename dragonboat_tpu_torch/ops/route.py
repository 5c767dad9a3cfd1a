"""Device-side message routing: outbox -> co-located peer inboxes.

Port of the single-device part of ``dragonboat_tpu/ops/route.py``
(everything up to ``fused_rounds``; the mesh tables and the cross-device
lane wait for the multi-device slice).  Messages whose destination
replica is resident on the same device are scattered straight into the
next step's ``Inbox``; the rest stay with the host transport.

The inbox is direct-mapped, not sorted:

    [0, base)                      host/injected slots (ticks, proposals)
    [base + r*budget, +budget)     messages from the sender holding slot
                                   r in the DESTINATION row's peer table

On CUDA tensors ``route`` launches the hand-written kernel
``csrc/route.cu``, which writes the whole next inbox: the routed regions
and the ``[0, base)`` prefix, copied from ``base_inbox`` or generated as
``make_prefill``'s tick / propose_leaders / propose_n slots.
``merge_and_route``, ``routed_round`` and ``fused_rounds`` are then
compositions of kernels only — ``raft_step``, the escalation merge
(``place_rows``) and ``route`` — with no plain-torch compute between
them.  On CPU tensors every function runs its plain version
(``route_ref.py``).  Any other device raises.

Static tables (host-precomputed, see ``build_route_tables``):
  dest_row[g, p]      device row hosting (shard_id[g], peer_id[g, p]),
                      -1 when that replica is not on this device/shard
  rank_in_dest[g, p]  the slot index row g's replica occupies in THAT
                      row's peer table (the region selector above)
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _native
from . import kernel as K
from . import plumbing
from . import route_ref
from .route_ref import make_prefill
from .types import I32, N_FIELDS, DeviceOut, DeviceState, Inbox

__all__ = [
    "RouteStats", "build_route_tables", "route", "make_prefill",
    "merge_and_route", "routed_round", "fused_rounds",
]

# the state fields the route kernel reads, in csrc/route.cu's order
_ROUTE_STATE = ("peer_id", "replica_id", "first_index", "last_index",
                "role", "ring_term", "ring_cc")
# route.cu's stats vector: the six RouteStats, then the suppressed rows
_N_KSTATS = 7


class RouteStats(NamedTuple):
    """Per-call routing outcome counters (all int32 scalars)."""

    delivered: torch.Tensor
    dropped_off_device: torch.Tensor  # destination replica not resident
    dropped_budget: torch.Tensor      # per-sender region full
    dropped_ring: torch.Tensor        # REPLICATE entries aged out of ring
    suppressed: torch.Tensor          # messages of escalated source rows
    host_carried: torch.Tensor        # deliberately left to the host path
    #                                   (forwarded PROPOSE, dest row dirty)

    def __add__(self, other: "RouteStats") -> "RouteStats":
        return RouteStats(*(a + b for a, b in zip(self, other)))


def build_route_tables(
    shard_ids: np.ndarray,
    replica_ids: np.ndarray,
    peer_ids: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side precompute of (dest_row, rank_in_dest) for a row layout.

    Rows are identified by (shard, replica); a peer slot whose replica is
    not hosted in this layout routes to -1 (off-device -> transport).
    """
    G, P = peer_ids.shape
    row_of: Dict[Tuple[int, int], int] = {
        (int(s), int(r)): g
        for g, (s, r) in enumerate(zip(shard_ids, replica_ids))
    }
    # per-row {pid: slot} so rank lookup is O(1), not a nonzero scan
    slot_of = [
        {int(pid): p for p, pid in enumerate(row) if pid}
        for row in peer_ids
    ]
    dest_row = np.full((G, P), -1, np.int32)
    rank_in_dest = np.zeros((G, P), np.int32)
    for g in range(G):
        shard = int(shard_ids[g])
        me = int(replica_ids[g])
        for p in range(P):
            pid = int(peer_ids[g, p])
            if pid == 0:
                continue
            d = row_of.get((shard, pid))
            if d is None:
                continue
            mine = slot_of[d].get(me)
            if mine is None:
                # destination doesn't know us (mid-membership-change):
                # no slot region is ours, and borrowing rank 0 would
                # silently collide with the real rank-0 sender — leave
                # it off-device so the drop is counted (or the host
                # transport carries it)
                continue
            dest_row[g, p] = d
            rank_in_dest[g, p] = mine
    return dest_row, rank_in_dest


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"route: unsupported device {t.device}")
    return t.device.type


def _int32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A [G] mask as the kernel's int32 word (bool masks of callers)."""
    if t is None or t.dtype == I32:
        return t
    return t.to(I32)


def route_cuda(
    state: DeviceState,
    out: DeviceOut,
    dest_row: torch.Tensor,
    rank_in_dest: torch.Tensor,
    *,
    M: int,
    E: int,
    budget: int,
    base: int,
    base_inbox: Optional[Inbox] = None,
    suppress: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    alive_stride: int = 1,
    prefill: Tuple[bool, bool, int] = (False, False, 1),
    stats: Optional[torch.Tensor] = None,
    packed: Optional[torch.Tensor] = None,
    undeliv: Optional[torch.Tensor] = None,
    delivered: Optional[torch.Tensor] = None,
) -> Tuple[Inbox, torch.Tensor]:
    """Launch ``csrc/route.cu``.  Returns ``(inbox, stats)`` with
    ``stats`` the kernel's [7] vector (RouteStats, then the suppressed
    row count), written into ``stats`` when given.  ``suppress`` is a
    [G] int32 word (nonzero = suppressed row); ``alive`` is read at
    ``alive[g * alive_stride]`` (the colocated combo's alive lane);
    ``prefill`` = (tick, propose_leaders, propose_n) generates the
    ``[0, base)`` prefix when there is no ``base_inbox``.  ``packed``,
    ``undeliv`` and ``delivered`` are optional outputs the kernel fills:
    the [G, ceil(O/32)] delivered bits, the [G] undelivered-row word and
    the [G, O] bool delivered mask."""
    G, O, nf = out.buf.shape
    P = state.peer_id.shape[1]
    W = state.ring_term.shape[1]
    B = budget
    route_ref.check_layout(M, P, B, base)
    if nf != N_FIELDS:
        raise ValueError("route: out.buf must be [G, O, N_FIELDS]")
    if not 1 <= P <= K.PMAX:
        raise ValueError(f"route: P={P} outside [1, {K.PMAX}]")
    if W < 1 or W & (W - 1):
        raise ValueError(f"route: W={W} must be a power of two")
    for t in (dest_row, rank_in_dest):
        if tuple(t.shape) != (G, P):
            raise ValueError("route: the tables must be [G, P]")
    if base_inbox is not None and (
        base_inbox.mtype.shape[0] != G or base_inbox.mtype.shape[1] < base
        or base_inbox.ent_term.shape[2] != E
    ):
        raise ValueError("route: base_inbox does not cover the prefix")
    dev = out.buf.device

    def e(*shape):
        return torch.empty(shape, dtype=I32, device=dev)

    inbox = Inbox(*(e(G, M) for _ in range(10)), e(G, M, E), e(G, M, E))
    if stats is None:
        stats = e(_N_KSTATS)
    scratch = e(G * P * B * (N_FIELDS + 2 * E))
    tick, propose_leaders, propose_n = prefill
    _native.launch(
        "route", [getattr(state, f) for f in _ROUTE_STATE], out.buf,
        out.count, dest_row, rank_in_dest, _int32(suppress), _int32(alive),
        alive_stride, list(base_inbox) if base_inbox is not None else [],
        list(inbox), stats, packed, undeliv, delivered, scratch, B, base,
        int(tick), int(propose_leaders), int(propose_n),
    )
    return inbox, stats


def route(
    state: DeviceState,
    out: DeviceOut,
    dest_row: torch.Tensor,
    rank_in_dest: torch.Tensor,
    *,
    M: int,
    E: int,
    budget: int,
    base: int,
    base_inbox: Optional[Inbox] = None,
    suppress: Optional[torch.Tensor] = None,
    dest_alive: Optional[torch.Tensor] = None,
) -> Tuple[Inbox, RouteStats, torch.Tensor]:
    """Scatter ``out``'s messages into a fresh (or prefilled) Inbox.

    ``state`` must be the POST-step state of the sending rows (REPLICATE
    payloads come from the sender's log-term ring).  ``suppress`` masks
    source rows whose device effects were discarded (escalations);
    ``dest_alive`` ([G]) masks destination rows that must not be fed.
    Returns ``(inbox, stats, delivered)`` with ``delivered`` the [G, O]
    bool mask of messages scattered into a peer row."""
    if _device(out.buf) == "cpu":
        inbox, stats, delivered = route_ref.route(
            state, out, dest_row, rank_in_dest, M=M, E=E, budget=budget,
            base=base, base_inbox=base_inbox, suppress=suppress,
            dest_alive=dest_alive,
        )
        return inbox, RouteStats(*stats), delivered
    G, O = out.buf.shape[:2]
    delivered = torch.empty((G, O), dtype=torch.bool, device=out.buf.device)
    inbox, stats = route_cuda(
        state, out, dest_row, rank_in_dest, M=M, E=E, budget=budget,
        base=base, base_inbox=base_inbox, suppress=suppress,
        alive=dest_alive, delivered=delivered,
    )
    return inbox, RouteStats(*stats[:6]), delivered


def merge_and_route(
    old_state: DeviceState,
    new_state: DeviceState,
    out: DeviceOut,
    dest_row: torch.Tensor,
    rank_in_dest: torch.Tensor,
    *,
    M: int,
    E: int,
    budget: int,
    base: int,
    propose_leaders: bool = False,
    propose_n: int = 1,
    stats_out: Optional[torch.Tensor] = None,
) -> Tuple[DeviceState, Inbox, RouteStats, torch.Tensor]:
    """The post-step tail of a consensus round: undo escalated rows
    (their device effects are discarded — raft-safe message loss), then
    route the outboxes into the next round's inbox on top of a fresh
    tick/proposal prefill.  Returns (state', inbox', stats,
    escalated_row_count).  On CUDA: ``place_rows`` (escalation select)
    then ``route``; ``stats_out`` is the [7] vector the kernel fills."""
    if _device(out.buf) == "cpu":
        state, inbox, stats, n_esc = route_ref.merge_and_route(
            old_state, new_state, out, dest_row, rank_in_dest, M=M, E=E,
            budget=budget, base=base, propose_leaders=propose_leaders,
            propose_n=propose_n,
        )
        return state, inbox, RouteStats(*stats), n_esc
    state = DeviceState(*plumbing.select_escalated(
        out.escalate, list(old_state), list(new_state)
    ))
    inbox, stats = route_cuda(
        state, out, dest_row, rank_in_dest, M=M, E=E, budget=budget,
        base=base, suppress=out.escalate,
        prefill=(True, propose_leaders, propose_n), stats=stats_out,
    )
    return state, inbox, RouteStats(*stats[:6]), stats[6]


def routed_round(
    state: DeviceState,
    inbox: Inbox,
    dest_row: torch.Tensor,
    rank_in_dest: torch.Tensor,
    *,
    out_capacity: int,
    budget: int,
    base: int,
    propose_leaders: bool = False,
    propose_n: int = 1,
    stats_out: Optional[torch.Tensor] = None,
) -> Tuple[DeviceState, Inbox, RouteStats, torch.Tensor]:
    """One full consensus round: step every row through ``inbox``, then
    ``merge_and_route`` the outboxes into the next round's inbox."""
    M, E = inbox.mtype.shape[1], inbox.ent_term.shape[2]
    new_state, out = K.step(state, inbox, out_capacity=out_capacity)
    return merge_and_route(
        state, new_state, out, dest_row, rank_in_dest,
        M=M, E=E, budget=budget, base=base,
        propose_leaders=propose_leaders, propose_n=propose_n,
        stats_out=stats_out,
    )


def fused_rounds(
    state: DeviceState,
    inbox: Inbox,
    dest_row: torch.Tensor,
    rank_in_dest: torch.Tensor,
    *,
    rounds: int,
    out_capacity: int,
    budget: int,
    base: int,
    propose_leaders: bool = False,
    propose_n: int = 1,
) -> Tuple[DeviceState, Inbox, torch.Tensor, torch.Tensor]:
    """``rounds`` consecutive consensus rounds with no host sync between
    them — the fused commit wave.  Bit-exactness contract:
    ``fused_rounds(..., rounds=K)`` equals K sequential
    ``routed_round`` calls, state and inbox.

    Returns ``(state', inbox', stats [rounds, 6], n_esc [rounds])``.  On
    CUDA each round's kernels write their stats row straight into one
    [rounds, 7] buffer, so the wave runs kernels only."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if _device(state.term) == "cpu":
        return route_ref.fused_rounds(
            state, inbox, dest_row, rank_in_dest, rounds=rounds,
            out_capacity=out_capacity, budget=budget, base=base,
            propose_leaders=propose_leaders, propose_n=propose_n,
        )
    stats_all = torch.empty((rounds, _N_KSTATS), dtype=I32,
                            device=state.term.device)
    for k in range(rounds):
        state, inbox, _stats, _n_esc = routed_round(
            state, inbox, dest_row, rank_in_dest,
            out_capacity=out_capacity, budget=budget, base=base,
            propose_leaders=propose_leaders, propose_n=propose_n,
            stats_out=stats_all[k],
        )
    return state, inbox, stats_all[:, :6], stats_all[:, 6]
