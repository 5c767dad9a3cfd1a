"""Device-side message routing: outbox -> co-located peer inboxes.

Port of ``dragonboat_tpu/ops/route.py``: the single-device router (up to
``fused_rounds``) and the multi-device plane (``MeshTables``,
``CrossStats``, ``build_route_tables_mesh``, ``xbudget_for``,
``cross_exchange``, ``make_sharded_round``, below).  Messages whose
destination replica is resident on the same device are scattered
straight into the next step's ``Inbox``; the rest stay with the host
transport, or ride the cross-device lane on a groups mesh.

The inbox is direct-mapped, not sorted:

    [0, base)                      host/injected slots (ticks, proposals)
    [base + r*budget, +budget)     messages from the sender holding slot
                                   r in the DESTINATION row's peer table

On CUDA tensors ``route`` launches the hand-written kernel
``csrc/route.cu``, which writes the whole next inbox: the routed regions
and the ``[0, base)`` prefix, copied from ``base_inbox`` or generated as
``make_prefill``'s tick / propose_leaders / propose_n slots.
``merge_and_route``, ``routed_round`` and ``fused_rounds`` are then
compositions of kernels only — ``raft_step``, the in-place escalation
merge (``merge_escalated``, csrc/place_rows.cu) and ``route`` — with no
plain-torch compute between them.  The router and the lane pack
(``csrc/xlane.cu``) walk a row's outbox with a sub-warp of 8 lanes, one
a message (``csrc/walk.cuh``);
the pack counts in blocks of ``lane_rows_per_block`` rows.  On CPU tensors
every function runs its plain version (``route_ref.py``).  Any other
device raises.

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

from .. import profiling
from . import _native
from . import kernel as K
from . import plumbing
from . import route_ref
from .placement import GroupsMesh, Sharded
from .route_ref import (
    N_LANE_STATS, N_LANE_STATS_X, X_KF, XI_B, XI_FOUND, XI_FROM, XI_LOC,
    XI_RANK, make_prefill,
)
from .types import I32, N_FIELDS, DeviceOut, DeviceState, Inbox

__all__ = [
    "RouteStats", "build_route_tables", "route", "make_prefill",
    "merge_and_route", "routed_round", "fused_rounds", "MeshTables",
    "CrossStats", "build_route_tables_mesh", "split_route_tables",
    "xbudget_for",
    "xlane_pack", "xlane_scatter", "cross_exchange", "make_sharded_round",
    # the packed lane row's layout (route_ref.py, csrc/xlane.cu)
    "XI_FROM", "XI_LOC", "XI_RANK", "XI_B", "XI_FOUND", "X_KF",
]

# the state fields the route kernel reads, in csrc/route.cu's order
_ROUTE_STATE = ("peer_id", "replica_id", "first_index", "last_index",
                "role", "ring_term", "ring_cc")
# route.cu's stats vector: the six RouteStats, then the suppressed rows
_N_KSTATS = 7

# rows a block of xlane.cu's count and write passes may walk
LANE_ROWS = (32, 64, 128)
# most mesh devices the pack kernel counts per row (xlane.cu XDMAX)
_XLANE_DMAX = 16


def lane_rows_per_block(G: int, D: int) -> int:
    """Rows a block of ``xlane_pack``'s count and write passes walks: the
    largest of ``LANE_ROWS`` that still gives every SM a block, else the
    smallest (fewer blocks make the one-block scan of their totals
    shorter; ``scripts/route_ab.py --sweep`` times each on the H100).
    Raises ``ValueError`` outside 1 to ``_XLANE_DMAX`` devices (the
    kernel's per-row counters)."""
    if not 1 <= D <= _XLANE_DMAX:
        raise ValueError(f"xlane_pack: n_dev={D}: at most {_XLANE_DMAX} "
                         "devices")
    for R in reversed(LANE_ROWS):
        if -(-G // R) >= K.N_SM:
            return R
    return LANE_ROWS[0]


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


def build_route_tables(  # raftlint: ignore[host-sync] host-side numpy precompute of static tables
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
    delivered: bool = False,
) -> Tuple[Inbox, torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``csrc/route.cu``.  Returns ``(inbox, stats, delivered)``
    with ``stats`` the kernel's [7] vector (RouteStats, then the
    suppressed row count), written into ``stats`` when given.
    ``suppress`` is a [G] int32 word (nonzero = suppressed row);
    ``alive`` is read at ``alive[g * alive_stride]`` (the colocated
    combo's alive lane); ``prefill`` = (tick, propose_leaders,
    propose_n) generates the ``[0, base)`` prefix when there is no
    ``base_inbox``.  ``packed`` and ``undeliv`` are optional outputs the
    kernel fills: the [G, ceil(O/32)] delivered bits and the [G]
    undelivered-row word; with ``delivered`` it also fills the [G, O]
    bool delivered mask it returns (else None).  Recorder spans:
    ``route.check``, ``route.alloc``, then ``launch.route``."""
    t0 = profiling.begin()
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
    profiling.end("route.check", t0)
    t0 = profiling.begin()
    inbox, scratch, cnt, own_stats, deliv = _route_buffers(
        G, P, O, M, E, B, out.buf.device, stats is None, delivered)
    profiling.end("route.alloc", t0)
    if stats is None:
        stats = own_stats
    tick, propose_leaders, propose_n = prefill
    _native.launch(
        "route", [getattr(state, f) for f in _ROUTE_STATE], out.buf,
        out.count, dest_row, rank_in_dest, _int32(suppress), _int32(alive),
        alive_stride, list(base_inbox) if base_inbox is not None else [],
        list(inbox), stats, packed, undeliv, deliv, scratch, cnt, B,
        # raftlint: ignore[host-sync] the prefill's host scalars, not device values
        base, int(tick), int(propose_leaders), int(propose_n),
    )
    return inbox, stats, deliv


def _route_buffers(G: int, P: int, O: int, M: int, E: int, B: int, dev,
                   with_stats: bool, with_delivered: bool):
    """``route_cuda``'s allocations: the 12 inbox fields as views of one
    buffer, and the walk's workspace (the scratch words [G, P, B], cnt
    [G, P], the [7] stats when the caller gives none and the [G, O] bool
    delivered mask when asked) as views of another, each view 16-byte
    aligned.  Returns (inbox, scratch, cnt, stats or None, delivered or
    None)."""
    inbox = Inbox(*K._views(((G, M),) * 10 + ((G, M, E),) * 2, dev))
    shapes = [(G * P * B,), (G * P,)]
    if with_stats:
        shapes.append((_N_KSTATS,))
    if with_delivered:
        shapes.append((-(-G * O // 4),))  # G * O bytes in int32 words
    work = K._views(tuple(shapes), dev)
    stats = work[2] if with_stats else None
    delivered = None
    if with_delivered:
        delivered = work[-1].view(torch.uint8)[:G * O].view(
            torch.bool).view(G, O)
    return inbox, work[0], work[1], stats, delivered


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
    inbox, stats, delivered = route_cuda(
        state, out, dest_row, rank_in_dest, M=M, E=E, budget=budget,
        base=base, base_inbox=base_inbox, suppress=suppress,
        alive=dest_alive, delivered=True,
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
    escalated_row_count).  Consumes ``new_state``: the escalated rows
    are merged into it in place and state' is that tree, so a caller
    that still reads ``new_state`` afterwards passes a copy.  On CUDA:
    ``merge_escalated`` (the in-place escalation merge) then ``route``;
    ``stats_out`` is the [7] vector the kernel fills."""
    if _device(out.buf) == "cpu":
        state, inbox, stats, n_esc = route_ref.merge_and_route(
            old_state, new_state, out, dest_row, rank_in_dest, M=M, E=E,
            budget=budget, base=base, propose_leaders=propose_leaders,
            propose_n=propose_n,
        )
        return state, inbox, RouteStats(*stats), n_esc
    state = DeviceState(*plumbing.merge_escalated(
        out.escalate, list(old_state), list(new_state)
    ))
    inbox, stats, _ = route_cuda(
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
    [rounds, 7] buffer, so the wave runs kernels only; the whole call is
    the recorder span ``fused_rounds``."""
    t0 = profiling.begin()
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
    res = state, inbox, stats_all[:, :6], stats_all[:, 6]
    profiling.end("fused_rounds", t0)
    return res


# ---------------------------------------------------------------------------
# multi-device plane: sharded tables + the cross-device lane
# ---------------------------------------------------------------------------
class MeshTables(NamedTuple):
    """Static route tables for a groups mesh (row-block placement:
    device ``d`` owns global rows ``[d*Gl, (d+1)*Gl)``).  All three are
    ``[G, P]``, describing the peer in each slot of each row:

      dest_dev[g, p]      device hosting that replica (-1: not placed)
      dest_local[g, p]    its LOCAL row index on that device
      rank_in_dest[g, p]  the slot row g's replica occupies in THAT row's
                          peer table (the single-device table)
    """

    dest_local: np.ndarray
    dest_dev: np.ndarray
    rank_in_dest: np.ndarray


class CrossStats(NamedTuple):
    """Cross-device lane counters, one int32 per shard."""

    sent: torch.Tensor            # messages packed onto the lane
    delivered: torch.Tensor       # received messages (found) scattered
    dropped_budget: torch.Tensor  # per-sender region rank >= budget
    dropped_xlane: torch.Tensor   # per-edge lane slots exhausted (>= XB)
    dropped_ring: torch.Tensor    # REPLICATE no longer ring-resident


def build_route_tables_mesh(
    shard_ids: np.ndarray,
    replica_ids: np.ndarray,
    peer_ids: np.ndarray,
    n_devices: int,
) -> MeshTables:
    """The global ``build_route_tables`` output split by the row-block
    placement into (device, local row) coordinates.  A peer on the same
    device routes through ``route``; a peer on another device rides the
    lane (``cross_exchange``)."""
    dest, rank = build_route_tables(shard_ids, replica_ids, peer_ids)
    return split_route_tables(dest, rank, n_devices)


def split_route_tables(dest: np.ndarray, rank: np.ndarray,
                       n_devices: int) -> MeshTables:
    """Global ``(dest_row, rank_in_dest)`` tables — after any edit of
    ``dest`` such as the colocated engine's partition cut — in the
    row-block placement's (device, local row) coordinates."""
    G = dest.shape[0]
    if n_devices <= 0 or G % n_devices:
        raise ValueError(f"G={G} must divide over {n_devices} devices")
    gl = G // n_devices
    placed = dest >= 0
    dest_dev = np.where(placed, dest // gl, -1).astype(np.int32)
    dest_local = np.where(placed, dest % gl, -1).astype(np.int32)
    return MeshTables(dest_local, dest_dev, rank)


# raftlint: ignore[host-sync] host-side numpy sizing of a static lane budget
def xbudget_for(tables: MeshTables, budget: int, n_devices: int) -> int:
    """Worst-case per-edge lane volume of ``tables``: every local row may
    send up to ``budget`` messages toward each of its peer slots on an
    edge.  Sized so, ``dropped_xlane`` is structurally zero (the
    precondition of bit-exact parity with the single-device round)."""
    G = tables.dest_dev.shape[0]
    gl = G // n_devices
    worst = 1
    blocks = tables.dest_dev.reshape(n_devices, gl, -1)
    for s in range(n_devices):
        for d in range(n_devices):
            if d == s:
                continue
            worst = max(worst, int((blocks[s] == d).sum()) * budget)
    return worst


# the state fields the lane pack reads, in csrc/xlane.cu's order
_LANE_STATE = ("peer_id", "replica_id", "first_index", "last_index",
               "ring_term", "ring_cc")


def xlane_pack(
    state: DeviceState,
    out: DeviceOut,
    dest_local: torch.Tensor,
    dest_dev: torch.Tensor,
    rank_in_dest: torch.Tensor,
    *,
    me: int,
    n_dev: int,
    E: int,
    budget: int,
    xbudget: int,
    suppress: Optional[torch.Tensor] = None,
    stats: Optional[torch.Tensor] = None,
    dest_alive: Optional[torch.Tensor] = None,
    alive_stride: int = 1,
    packed: Optional[torch.Tensor] = None,
    undeliv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard ``me``'s lane buffer ``xbuf [n_dev, xbudget, 14 + 2E]`` and
    its stats row (``route_ref.lane_pack``), written into ``stats`` when
    given.  The colocated operands (``route_ref.lane_pack``): the
    receivers' alive words ``dest_alive``, read at ``x * alive_stride``
    for global row x (the colocated combo, stride 4), and the route's
    delivered bits ``packed`` and undelivered words ``undeliv``, updated
    in place; with them the stats row has ``N_LANE_STATS_X`` words.
    CUDA: ``csrc/xlane.cu``'s pack; CPU: the plain version."""
    if (packed is None) != (undeliv is None):
        raise ValueError("xlane_pack: packed and undeliv come together")
    if _device(out.buf) == "cpu":
        xbuf, st = route_ref.lane_pack(
            state, out, dest_local, dest_dev, rank_in_dest, me=me,
            n_dev=n_dev, E=E, budget=budget, xbudget=xbudget,
            suppress=suppress, dest_alive=dest_alive,
            alive_stride=alive_stride, packed=packed, undeliv=undeliv,
        )
        if stats is not None:
            stats.copy_(st)
            st = stats
        return xbuf, st
    G, O, nf = out.buf.shape
    P = state.peer_id.shape[1]
    if nf != N_FIELDS or not 1 <= P <= K.PMAX:
        raise ValueError("xlane_pack: bad outbox or peer width")
    R = lane_rows_per_block(G, n_dev)
    if not 0 <= me < n_dev:
        raise ValueError(f"xlane_pack: me={me} of n_dev={n_dev}")
    for t in (dest_local, dest_dev, rank_in_dest):
        if tuple(t.shape) != (G, P):
            raise ValueError("xlane_pack: the tables must be [G, P]")
    dev = out.buf.device
    xbuf = torch.empty((n_dev, xbudget, X_KF + 2 * E), dtype=I32,
                       device=dev)
    if stats is None:
        n = N_LANE_STATS if packed is None else N_LANE_STATS_X
        stats = torch.empty((n,), dtype=I32, device=dev)
    _native.launch(
        "xlane_pack", [getattr(state, f) for f in _LANE_STATE], out.buf,
        out.count, _int32(suppress), dest_local, dest_dev, rank_in_dest,
        xbuf, *_lane_work(G, n_dev, R, dev), stats, me, n_dev, budget, R,
        _int32(dest_alive), alive_stride, packed, undeliv,
    )
    return xbuf, stats


def _lane_work(G: int, D: int, R: int, dev) -> list:
    """``xlane_pack``'s workspace as views of one allocation, each 16-byte
    aligned: the rows' in-block offsets [G, D], the blocks' totals and
    offsets [nblk, D], their partial stats [nblk, 5] and the device
    totals [D], for blocks of R rows."""
    nblk = -(-G // R)
    return K._views(((G, D), (nblk, D), (nblk, D), (nblk, 5), (D,)), dev)



def xlane_scatter(
    inbox: Inbox,
    recv: torch.Tensor,
    *,
    budget: int,
    base: int,
    stats: Optional[torch.Tensor] = None,
) -> Tuple[Inbox, torch.Tensor]:
    """Add the received lane rows ``recv [R, 14 + 2E]`` into ``inbox`` in
    place (``route_ref.lane_scatter``); returns ``(inbox, delivered)``,
    with ``delivered`` written into ``stats[1]`` when given.  CUDA:
    ``csrc/xlane.cu``'s scatter; CPU: the plain version."""
    if _device(recv) == "cpu":
        inbox, n = route_ref.lane_scatter(inbox, recv, budget=budget,
                                          base=base)
        if stats is not None:
            stats[1] = n
        return inbox, n
    E = inbox.ent_term.shape[2]
    if recv.dim() != 2 or recv.shape[1] != X_KF + 2 * E:
        raise ValueError("xlane_scatter: recv must be [R, 14 + 2E]")
    if stats is None:
        stats = torch.zeros((N_LANE_STATS,), dtype=I32, device=recv.device)
    _native.launch("xlane_scatter", list(inbox), recv, stats, budget, base)
    return inbox, stats[1]


def ring_shift(mesh: GroupsMesh, xbufs) -> list:
    """The lane's transport: D-1 ring shifts.  Shift ``s`` hands device
    ``(i+s) % D`` the block ``xbufs[i][(i+s) % D]`` that device ``i``
    packed for it; device ``d`` receives ``[(D-1)*XB, KT]`` rows, shift
    by shift.  Each hop is a device-to-device copy: within one card on
    its stream, between cards a peer copy that PyTorch orders after the
    source stream's work (the pack) and before the destination stream's
    next work (the scatter) with stream events — the host does not
    synchronize."""
    D = mesh.size
    XB, KT = xbufs[0].shape[1:]
    recv = [torch.empty(((D - 1) * XB, KT), dtype=I32, device=dv)
            for dv in mesh.devices]
    for shift in range(1, D):
        for i in range(D):
            dst = (i + shift) % D
            recv[dst][(shift - 1) * XB:shift * XB].copy_(xbufs[i][dst])
    return recv


def _lane(  # mesh-hot
    mesh, states, outs, inboxes, tables, sups, *, E, budget, xbudget, base,
    stats_rows,
):
    """The cross-device lane over per-device blocks: pack on every
    device, ring shifts, scatter on every device.  ``tables[d]`` =
    (dest_local, dest_dev, rank) of device d; ``stats_rows[d]`` its [7]
    row.  With one device only the pack runs (its stats row: zeros, the
    suppressed and live rows)."""
    D = mesh.size
    xbufs = [
        xlane_pack(states[d], outs[d], *tables[d], me=d, n_dev=D, E=E,
                   budget=budget, xbudget=xbudget, suppress=sups[d],
                   stats=stats_rows[d])[0]
        for d in range(D)
    ]
    if D <= 1:
        return inboxes
    recv = ring_shift(mesh, xbufs)
    return [
        xlane_scatter(inboxes[d], recv[d], budget=budget, base=base,
                      stats=stats_rows[d])[0]
        for d in range(D)
    ]


def _tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t
    return torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32))


def _shard_tables(mesh, dest_local, dest_dev, rank_in_dest):
    """Per device: (dest_local, dest_dev, rank) blocks."""
    parts = [mesh.shard(t if isinstance(t, Sharded) else _tensor(t)).parts
             for t in (dest_local, dest_dev, rank_in_dest)]
    return [tuple(p[d] for p in parts) for d in range(mesh.size)]


def cross_exchange(
    mesh: GroupsMesh,
    state,
    out,
    inbox,
    dest_local,
    dest_dev,
    rank_in_dest,
    *,
    budget: int,
    xbudget: int,
    base: int,
    suppress=None,
) -> Tuple[Sharded, CrossStats]:
    """The device-to-device lane (route.py:652) over ``mesh``: messages
    whose destination replica lives on another device are packed into a
    fixed per-edge buffer ``[D, xbudget, 14 + 2E]`` per device
    (``xlane_pack``), moved by D-1 ring shifts (``ring_shift``), and
    added into the SAME inbox region slots the single-device router
    would have used, ``base + rank*budget + b`` (``xlane_scatter``).
    A region has one sender on one device, so it is local-fed XOR
    lane-fed and the result is bit-identical to the single-device
    router's.  Overflow is dropped and counted.

    Operands are global trees or :class:`Sharded` ones (``suppress`` a
    [G] mask, optional).  Returns ``(inbox', stats)``: the inbox as
    :class:`Sharded` blocks, ``stats`` a :class:`CrossStats` of [D]
    int32 tensors on the mesh's first device.  With one device it
    returns the inbox and zero stats."""
    st, ob, ib = mesh.shard(state), mesh.shard(out), mesh.shard(inbox)
    D = mesh.size
    dev0 = mesh.devices[0]
    if D <= 1:
        zero = torch.zeros((D,), dtype=I32, device=dev0)
        return ib, CrossStats(zero, zero, zero, zero, zero)
    sups = ([None] * D if suppress is None
            else list(mesh.shard(suppress).parts))
    rows = [torch.empty((N_LANE_STATS,), dtype=I32, device=dv)
            for dv in mesh.devices]
    E = ib.parts[0].ent_term.shape[2]
    inboxes = _lane(
        mesh, list(st.parts), list(ob.parts),
        [Inbox(*(t.clone() for t in p)) for p in ib.parts],
        _shard_tables(mesh, dest_local, dest_dev, rank_in_dest), sups,
        E=E, budget=budget, xbudget=xbudget, base=base, stats_rows=rows,
    )
    lane = torch.stack([r.to(dev0) for r in rows])
    return Sharded(tuple(inboxes)), CrossStats(*lane[:, :5].t())


def make_sharded_round(  # mesh-hot
    mesh: GroupsMesh,
    *,
    M: int,
    E: int,
    out_capacity: int,
    budget: int,
    xbudget: int,
    base: int,
    propose_leaders: bool = False,
    propose_n: int = 1,
    rounds: int = 1,
):
    """The consensus round over a groups mesh (route.py:850).  Returns
    ``round_fn(state, inbox, dest_local, dest_dev, rank) -> (state',
    inbox', route_stats [D*rounds, 6], lane_stats [D*rounds, 7])``.

    Per device and per round: ``step`` on the device's row block, the
    escalation select, ``route`` over the local view of the tables
    (``where(dest_dev == me, dest_local, -1)``, on a fresh tick /
    proposal prefill, escalated rows suppressed), then the lane
    (``cross_exchange``'s pack, shifts and scatter).  With ``rounds > 1``
    the lane fires BETWEEN fused rounds, so cross-device traffic sent in
    round k is in round k+1's inbox.  On CUDA every step of that is a
    kernel (``raft_step``, ``merge_escalated``, ``route``, ``xlane_pack``,
    ``xlane_scatter``) or a device copy, with no plain torch between
    them; on a CPU mesh every step is its plain version.

    Operands are global trees (cut into blocks on entry) or
    :class:`Sharded` ones; state' and inbox' come back :class:`Sharded`.
    The stats are device-major (row ``d*rounds + k``: device d, round
    k): RouteStats, then [sent, delivered, dropped_budget,
    dropped_xlane, dropped_ring, escalated, rows_live], on the mesh's
    first device."""
    if len(mesh.axis_names) != 1:
        raise ValueError("groups mesh must be one-dimensional")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    D = mesh.size
    dev0 = mesh.devices[0]

    def round_fn(state, inbox, dest_local, dest_dev, rank):
        states = list(mesh.shard(state).parts)
        inboxes = list(mesh.shard(inbox).parts)
        tabs = _shard_tables(mesh, dest_local, dest_dev, rank)
        # each device's local view of the tables, before the first kernel
        local = [torch.where(dd == d, dl, -1).to(I32)
                 for d, (dl, dd, _rk) in enumerate(tabs)]
        rstats = [torch.empty((rounds, 7), dtype=I32, device=dv)
                  for dv in mesh.devices]
        lstats = [torch.empty((rounds, N_LANE_STATS), dtype=I32, device=dv)
                  for dv in mesh.devices]
        for k in range(rounds):
            outs = []
            for d in range(D):
                new, out = K.step(states[d], inboxes[d],
                                  out_capacity=out_capacity)
                st2, ib2, rs, n_esc = merge_and_route(
                    states[d], new, out, local[d], tabs[d][2], M=M, E=E,
                    budget=budget, base=base,
                    propose_leaders=propose_leaders, propose_n=propose_n,
                    stats_out=rstats[d][k],
                )
                if mesh.device_type == "cpu":
                    rstats[d][k, :6] = torch.stack(list(rs))
                    rstats[d][k, 6] = n_esc
                states[d], inboxes[d] = st2, ib2
                outs.append(out)
            inboxes = _lane(
                mesh, states, outs, inboxes, tabs,
                [o.escalate for o in outs], E=E, budget=budget,
                xbudget=xbudget, base=base,
                stats_rows=[lstats[d][k] for d in range(D)],
            )
        route_stats = torch.cat([r[:, :6].to(dev0) for r in rstats])
        lane_stats = torch.cat([r.to(dev0) for r in lstats])
        return (Sharded(tuple(states)), Sharded(tuple(inboxes)),
                route_stats, lane_stats)

    return round_fn
