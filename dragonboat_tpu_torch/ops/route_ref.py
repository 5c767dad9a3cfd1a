"""Plain PyTorch versions of the device router (``ops/route.py``).

References for the CUDA kernel ``csrc/route.cu``: ``ops/route.py`` runs
these for CPU tensors, and the parity checks run them on the card beside
the kernel.  Each is the function ``dragonboat_tpu/ops/route.py``
computes (``route`` :131, ``make_prefill`` :395, ``merge_and_route``
:431, ``routed_round`` :475, ``fused_rounds`` :500), written in eager
torch with the reference's arithmetic kept as it is: one-hot selects
over the peer and ring axes, ``any`` and ``sum`` over every matching
peer slot, int32 sums.

``lane_pack`` / ``lane_scatter`` are the two halves of the reference's
cross-device lane (``cross_exchange``, route.py:652) around its ring
shifts, for the CUDA kernels of ``csrc/xlane.cu``.  They keep the
reference's per-message arithmetic but not its one-hot matmuls over
``[D*XB, G*O]`` and ``[R, G, M]`` (``route.py:775``, :796): the lane
slot is a ``cumsum`` and the scatter an ``index_put_`` with
accumulation, which give the same integers at any size.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import engine_ref
from . import kernel_ref
from .types import (
    F_COMMIT,
    F_HINT,
    F_HINT_HIGH,
    F_LOG_INDEX,
    F_LOG_TERM,
    F_MTYPE,
    F_N_ENTRIES,
    F_REJECT,
    F_TERM,
    F_TO,
    I32,
    MT_PROPOSE,
    MT_REPLICATE,
    MT_REQUEST_PREVOTE,
    MT_REQUEST_PREVOTE_RESP,
    MT_REQUEST_VOTE,
    MT_REQUEST_VOTE_RESP,
    MT_TICK,
    ROLE_LEADER,
    DeviceOut,
    DeviceState,
    Inbox,
)

# the wire fields a routed message carries, in packed-row order
WIRE_COLS = (
    F_MTYPE, F_TERM, F_LOG_TERM, F_LOG_INDEX, F_COMMIT,
    F_REJECT, F_HINT, F_HINT_HIGH, F_N_ENTRIES,
)
# the Inbox fields of the [0, base) prefix, in Inbox order
PREFIX_FIELDS = (
    "mtype", "from_id", "term", "log_term", "log_index", "commit",
    "reject", "hint", "hint_high", "n_entries",
)


def check_layout(M: int, P: int, budget: int, base: int) -> None:
    if base + P * budget != M:
        raise ValueError(
            f"inbox layout mismatch: base={base} + P={P} * budget={budget} "
            f"must equal M={M} (the inbox IS the region layout)"
        )


def census_counts(out, valid: torch.Tensor) -> torch.Tensor:
    """The election census of one route call (``csrc/route.cu``
    ``route_lane_census``): of the messages the route takes from the
    outboxes (``valid``: below the row's count, row not suppressed),
    delivered or dropped alike, the pre-vote requests, the vote requests,
    the pre-vote responses that grant (reject 0) and the vote responses
    that grant, as a [4] int64 vector (``profiling.CENSUS``'s order)."""
    mtype = out.buf[:, :, F_MTYPE]
    granted = valid & (out.buf[:, :, F_REJECT] == 0)
    return torch.stack([
        (valid & (mtype == MT_REQUEST_PREVOTE)).sum(),
        (valid & (mtype == MT_REQUEST_VOTE)).sum(),
        (granted & (mtype == MT_REQUEST_PREVOTE_RESP)).sum(),
        (granted & (mtype == MT_REQUEST_VOTE_RESP)).sum(),
    ]).to(torch.int64)


def _gather_rows_clamped(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with the reference's gather rule: a negative index
    counts from the end, then the index clamps into range."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return x[idx]


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
    census: Optional[torch.Tensor] = None,
) -> Tuple[Inbox, torch.Tensor, torch.Tensor]:
    """Scatter ``out``'s messages into a fresh (or prefilled) Inbox.

    Returns ``(inbox, stats, delivered)``: ``stats`` is the [6] int32
    vector in RouteStats order (delivered, dropped_off_device,
    dropped_budget, dropped_ring, suppressed, host_carried),
    ``delivered`` the [G, O] bool mask.  ``census`` (a [4] int64
    vector) is added the call's ``census_counts``."""
    G, O, _ = out.buf.shape
    P = state.peer_id.shape[1]
    W = state.ring_term.shape[1]
    B = budget
    check_layout(M, P, B, base)
    dev = out.buf.device

    buf = out.buf
    mtype = buf[:, :, F_MTYPE]
    to = buf[:, :, F_TO]
    n_ent = buf[:, :, F_N_ENTRIES]
    log_index = buf[:, :, F_LOG_INDEX]
    log_term = buf[:, :, F_LOG_TERM]

    valid = torch.arange(O, device=dev)[None, :] < out.count[:, None]
    n_suppressed = torch.zeros((), dtype=I32, device=dev)
    if suppress is not None:
        sup = suppress.bool()
        n_suppressed = (valid & sup[:, None]).sum(dtype=I32)
        valid = valid & ~sup[:, None]
    if census is not None:
        census += census_counts(out, valid)

    hits = (
        (state.peer_id[:, None, :] == to[:, :, None])
        & (to[:, :, None] != 0)
        & (state.peer_id[:, None, :] != 0)
    )  # [G, O, P]
    found = hits.any(dim=2)
    routable = valid & found

    dest_ge0 = dest_row >= 0
    dest_not_self = dest_row != torch.arange(G, device=dev)[:, None]
    if dest_alive is not None:
        alive_tab = dest_alive.bool()[dest_row.clamp(0, G - 1).long()] & dest_ge0
    else:
        alive_tab = dest_ge0

    def at_pstar(tab):
        return (hits & tab[:, None, :]).any(dim=2)

    on_device = routable & at_pstar(dest_ge0)

    is_repl = mtype == MT_REPLICATE
    carries = is_repl & (n_ent > 0)
    win_lo = torch.maximum(state.first_index, state.last_index - (W - 1))
    marker = is_repl & (log_index > 0) & (log_term == 0)
    ring_ok = ~carries | (
        (log_index + 1 >= win_lo[:, None])
        & (log_index + n_ent <= state.last_index[:, None])
        & ~marker
    )

    not_propose = mtype != MT_PROPOSE
    msg_ok = not_propose & at_pstar(dest_not_self) & at_pstar(alive_tab)

    deliverable = valid & ring_ok & msg_ok
    oh = (hits & deliverable[:, :, None]).to(I32)
    k_excl = torch.cumsum(oh, dim=1, dtype=I32) - oh
    k = torch.where(hits, k_excl, 0).sum(dim=2, dtype=I32)

    sendable = hits & deliverable[:, :, None]
    send_sel = torch.stack(
        [sendable & (k_excl == b) for b in range(B)], dim=3
    )  # [G, O, P, B]
    pick_found = send_sel.any(dim=1)  # [G, P, B]

    def pick(col):
        return torch.where(
            send_sel, buf[:, :, col][:, :, None, None], 0
        ).sum(dim=1, dtype=I32)

    picked = {c: pick(c) for c in WIRE_COLS}

    li_pb = picked[F_LOG_INDEX]
    n_pb = picked[F_N_ENTRIES]
    repl_pb = pick_found & (picked[F_MTYPE] == MT_REPLICATE)
    wm = W - 1
    ar_w = torch.arange(W, device=dev)
    ent_t, ent_c = [], []
    for e in range(E):
        pos = (li_pb + 1 + e).clamp(min=0) & wm  # [G, P, B]
        selw = pos[:, :, :, None] == ar_w[None, None, None, :]
        has_e = repl_pb & (e < n_pb)
        et = torch.where(selw, state.ring_term[:, None, None, :], 0).sum(
            dim=3, dtype=I32
        )
        ec = torch.where(selw, state.ring_cc[:, None, None, :], 0).sum(
            dim=3, dtype=I32
        )
        ent_t.append(torch.where(has_e, et, 0))
        ent_c.append(torch.where(has_e, ec, 0))
    ent_term_s = torch.stack(ent_t, dim=3)  # [G, P, B, E]
    ent_cc_s = torch.stack(ent_c, dim=3)

    from_pb = state.replica_id[:, None, None].expand(G, P, B)
    pack = torch.stack(
        [picked[c] for c in WIRE_COLS] + [pick_found.to(I32), from_pb],
        dim=3,
    )  # [G, P, B, 11]
    IDX_FOUND = len(WIRE_COLS)
    IDX_FROM = len(WIRE_COLS) + 1
    KF = len(WIRE_COLS) + 2
    pack = torch.cat([pack, ent_term_s, ent_cc_s], dim=3)
    KT = KF + 2 * E
    packr = pack.reshape(G * P, B * KT)

    src = dest_row
    src_ok = src >= 0
    src_c = src.clamp(0, G - 1)
    flat = (src_c * P + rank_in_dest).reshape(-1)
    region = _gather_rows_clamped(packr, flat).reshape(G, P, B, KT)
    not_self_d = src_c != torch.arange(G, device=dev)[:, None]
    sel_found = (
        (region[:, :, :, IDX_FOUND] != 0)
        & src_ok[:, :, None]
        & not_self_d[:, :, None]
    )  # [G, P, B]

    def field(i):
        return torch.where(sel_found, region[:, :, :, i], 0).reshape(G, P * B)

    if base_inbox is None:
        base_inbox = make_prefill(state, M, E, tick=False)
    pre = {f: getattr(base_inbox, f)[:, :base] for f in PREFIX_FIELDS}
    col_at = {c: i for i, c in enumerate(WIRE_COLS)}

    def asm(name, col):
        return torch.cat([pre[name], field(col_at[col])], dim=1)

    ent_term = torch.where(
        sel_found[:, :, :, None], region[:, :, :, KF:KF + E], 0
    ).reshape(G, P * B, E)
    ent_cc = torch.where(
        sel_found[:, :, :, None], region[:, :, :, KF + E:KT], 0
    ).reshape(G, P * B, E)

    inbox = Inbox(
        mtype=asm("mtype", F_MTYPE),
        from_id=torch.cat([pre["from_id"], field(IDX_FROM)], dim=1),
        term=asm("term", F_TERM),
        log_term=asm("log_term", F_LOG_TERM),
        log_index=asm("log_index", F_LOG_INDEX),
        commit=asm("commit", F_COMMIT),
        reject=asm("reject", F_REJECT),
        hint=asm("hint", F_HINT),
        hint_high=asm("hint_high", F_HINT_HIGH),
        n_entries=asm("n_entries", F_N_ENTRIES),
        ent_term=torch.cat([base_inbox.ent_term[:, :base], ent_term], dim=1),
        ent_cc=torch.cat([base_inbox.ent_cc[:, :base], ent_cc], dim=1),
    )
    in_budget = k < B
    delivered = valid & found & ring_ok & msg_ok & in_budget
    stats = torch.stack([
        sel_found.sum(dtype=I32),
        (routable & ~at_pstar(dest_ge0)).sum(dtype=I32),
        (on_device & msg_ok & ring_ok & ~in_budget).sum(dtype=I32),
        (on_device & msg_ok & ~ring_ok).sum(dtype=I32),
        n_suppressed,
        (on_device & ~msg_ok).sum(dtype=I32),
    ])
    return inbox, stats, delivered


def make_prefill(
    state: DeviceState,
    M: int,
    E: int,
    *,
    tick: bool = True,
    propose_leaders: bool = False,
    propose_n: int = 1,
) -> Inbox:
    """Injected inbox prefix: slot 0 = LOCAL_TICK for every row, slot 1 =
    a ``propose_n``-entry PROPOSE on rows currently leading."""
    G = state.term.shape[0]
    dev = state.term.device

    def zm():
        return torch.zeros((G, M), dtype=I32, device=dev)

    mtype = zm()
    n_entries = zm()
    if tick:
        mtype[:, 0] = MT_TICK
    if propose_leaders and M > 1:
        lead = state.role == ROLE_LEADER
        mtype[:, 1] = torch.where(lead, MT_PROPOSE, 0)
        n_entries[:, 1] = torch.where(lead, propose_n, 0)
    return Inbox(
        mtype=mtype, from_id=zm(), term=zm(), log_term=zm(),
        log_index=zm(), commit=zm(), reject=zm(), hint=zm(),
        hint_high=zm(), n_entries=n_entries,
        ent_term=torch.zeros((G, M, E), dtype=I32, device=dev),
        ent_cc=torch.zeros((G, M, E), dtype=I32, device=dev),
    )


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
    census: Optional[torch.Tensor] = None,
) -> Tuple[DeviceState, Inbox, torch.Tensor, torch.Tensor]:
    """Undo escalated rows, then route the outboxes into the next
    round's inbox on top of a fresh tick/proposal prefill.  Returns
    (state', inbox', stats [6], escalated_row_count).  Consumes
    ``new_state``: the escalated rows are merged into it in place, and
    state' is that tree.  ``census``: ``route``'s."""
    esc = out.escalate != 0
    n_esc = esc.sum(dtype=I32)
    state = DeviceState(*engine_ref.merge_escalated(
        out.escalate, old_state, new_state))
    prefill = make_prefill(
        state, M, E, propose_leaders=propose_leaders, propose_n=propose_n,
    )
    inbox, stats, _delivered = route(
        state, out, dest_row, rank_in_dest,
        M=M, E=E, budget=budget, base=base,
        base_inbox=prefill, suppress=esc, census=census,
    )
    return state, inbox, stats, n_esc


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
    census: Optional[torch.Tensor] = None,
):
    """One consensus round: step every row, then ``merge_and_route``."""
    M, E = inbox.mtype.shape[1], inbox.ent_term.shape[2]
    new_state, out = kernel_ref.step(state, inbox, out_capacity)
    return merge_and_route(
        state, new_state, out, dest_row, rank_in_dest,
        M=M, E=E, budget=budget, base=base,
        propose_leaders=propose_leaders, propose_n=propose_n, census=census,
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
    census: Optional[torch.Tensor] = None,
):
    """``rounds`` consecutive ``routed_round`` calls.  Returns
    ``(state', inbox', stats [rounds, 6], n_esc [rounds])``; each round
    adds its ``census_counts`` to ``census`` when given."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    stats_l, esc_l = [], []
    for _ in range(rounds):
        state, inbox, stats, n_esc = routed_round(
            state, inbox, dest_row, rank_in_dest,
            out_capacity=out_capacity, budget=budget, base=base,
            propose_leaders=propose_leaders, propose_n=propose_n,
            census=census,
        )
        stats_l.append(stats)
        esc_l.append(n_esc)
    return state, inbox, torch.stack(stats_l), torch.stack(esc_l)


# ---------------------------------------------------------------------------
# the cross-device lane (route.py:652 cross_exchange, per shard)
# ---------------------------------------------------------------------------
# packed lane row (route.py:638-649): the 9 wire columns, then sender
# replica id, destination local row, destination region rank, region
# slot b, found flag, then E entry terms and E entry cc bits
XI_FROM = len(WIRE_COLS)
XI_LOC = XI_FROM + 1
XI_RANK = XI_FROM + 2
XI_B = XI_FROM + 3
XI_FOUND = XI_FROM + 4
X_KF = XI_FROM + 5  # ent_term starts here; row width = X_KF + 2 * E
# lane stats row: CrossStats, then escalated rows and live rows; the
# colocated pack's row adds the refused (host-carried) messages
N_LANE_STATS = 7
N_LANE_STATS_X = 8


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """[G, O] bool -> [G, ceil(O/32)] int32 words of uint32 bits."""
    G, O = mask.shape
    shift = torch.arange(O, device=mask.device) % 32
    word = torch.arange(O, device=mask.device) // 32
    bits = torch.where(mask, torch.ones_like(shift) << shift, 0)
    cols = []
    for w in range((O + 31) // 32):
        s = torch.where(word[None, :] == w, bits, 0).sum(dim=1)  # int64
        cols.append(torch.where(s >= 2**31, s - 2**32, s))
    return torch.stack(cols, dim=1).to(I32)


def unpack_bits(packed: torch.Tensor, O: int) -> torch.Tensor:
    """The inverse of ``pack_bits``: [G, nw] int32 words -> [G, O] bool."""
    o = torch.arange(O, device=packed.device)
    w = packed.long()[:, o // 32]
    return ((w >> (o % 32)) & 1) != 0


def lane_pack(
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
    dest_alive: Optional[torch.Tensor] = None,
    alive_stride: int = 1,
    packed: Optional[torch.Tensor] = None,
    undeliv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard ``me``'s half of the lane before the ring shifts: every
    message whose destination replica lives on another device, packed
    into ``xbuf [n_dev, xbudget, X_KF + 2E]`` (row ``q`` of block ``d``
    is the ``q``-th sendable message toward device ``d`` in flat
    ``(g, o)`` order; zeros where no message sits).

    The colocated engine's operands make the lane decide as the
    single-device route with ``dest_alive`` does (route.py:143): a
    message whose receiver (global row ``dest_dev * G + dest_local``,
    its word at ``dest_alive.reshape(-1)[row * alive_stride]``) is not
    alive is refused like a forwarded PROPOSE; ``packed`` (the route's
    [G, ceil(O/32)] delivered bits) gains the bit of every message the
    lane carried, and ``undeliv`` ([G]) is rewritten, for every row not
    suppressed, to whether a valid message of the row has no bit.

    Returns ``(xbuf, stats)``, stats [7]: sent, 0 (delivered: the
    scatter's), dropped_budget, dropped_xlane, dropped_ring, then the
    number of suppressed rows and of the other (live) rows; with
    ``packed``, [8]: the refused (host-carried) messages last."""
    if (packed is None) != (undeliv is None):
        raise ValueError("lane_pack: packed and undeliv come together")
    G, O, _ = out.buf.shape
    W = state.ring_term.shape[1]
    B, D, XB = budget, n_dev, xbudget
    dev = out.buf.device
    buf = out.buf
    mtype = buf[:, :, F_MTYPE]
    to = buf[:, :, F_TO]
    n_ent = buf[:, :, F_N_ENTRIES]
    log_index = buf[:, :, F_LOG_INDEX]
    log_term = buf[:, :, F_LOG_TERM]
    valid = torch.arange(O, device=dev)[None, :] < out.count[:, None]
    n_sup = torch.zeros((), dtype=I32, device=dev)
    if suppress is not None:
        sup = suppress.bool()
        n_sup = sup.sum(dtype=I32)
        valid = valid & ~sup[:, None]
    hits = (
        (state.peer_id[:, None, :] == to[:, :, None])
        & (to[:, :, None] != 0)
        & (state.peer_id[:, None, :] != 0)
    )  # [G, O, P]
    found = hits.any(dim=2)

    def at_pstar(tab):  # the sum over every matching peer slot
        return torch.where(hits, tab[:, None, :], 0).sum(dim=2, dtype=I32)

    xdev = at_pstar(dest_dev)
    xloc = at_pstar(dest_local)
    xrank = at_pstar(rank_in_dest)
    alive = torch.ones((G, O), dtype=torch.bool, device=dev)
    if dest_alive is not None:
        col = dest_alive.reshape(-1)[::alive_stride] != 0
        at_row = (xdev.long() * G + xloc.long()).clamp(0, max(D * G - 1, 0))
        alive = col[at_row]
    is_repl = mtype == MT_REPLICATE
    carries = is_repl & (n_ent > 0)
    win_lo = torch.maximum(state.first_index, state.last_index - (W - 1))
    marker = is_repl & (log_index > 0) & (log_term == 0)
    ring_ok = ~carries | (
        (log_index + 1 >= win_lo[:, None])
        & (log_index + n_ent <= state.last_index[:, None])
        & ~marker
    )
    remote = found & (xdev >= 0) & (xdev != me)
    routable = valid & remote & (mtype != MT_PROPOSE) & alive
    refused = valid & remote & ~routable
    deliverable = routable & ring_ok
    oh = (hits & deliverable[:, :, None]).to(I32)
    k_excl = torch.cumsum(oh, dim=1, dtype=I32) - oh
    b_of = torch.where(hits, k_excl, 0).sum(dim=2, dtype=I32)
    in_b = b_of < B
    sendable = deliverable & in_b
    # lane slot q: exclusive count of the earlier sendable messages toward
    # the same device, in flat (g, o) order
    fdev = xdev.reshape(-1).long()
    edge = sendable.reshape(-1) & (fdev >= 0) & (fdev < D)
    dcol = fdev.clamp(0, max(D - 1, 0))
    ohd = torch.zeros((G * O, max(D, 1)), dtype=I32, device=dev)
    ohd[edge, dcol[edge]] = 1
    q = (torch.cumsum(ohd, dim=0, dtype=I32) - ohd).gather(
        1, dcol[:, None])[:, 0]
    in_q = edge & (q < XB)
    # the packed rows
    wm = W - 1
    ents_t, ents_c = [], []
    for e in range(E):
        pos = ((log_index + 1 + e).clamp(min=0) & wm).long()
        has_e = carries & (e < n_ent)
        ents_t.append(torch.where(has_e, state.ring_term.gather(1, pos), 0))
        ents_c.append(torch.where(has_e, state.ring_cc.gather(1, pos), 0))
    from_g = state.replica_id[:, None].expand(G, O)
    fields = torch.stack(
        [buf[:, :, c] for c in WIRE_COLS]
        + [from_g, xloc, xrank, b_of, sendable.to(I32)]
        + ents_t + ents_c,
        dim=2,
    ).reshape(G * O, -1)
    KT = fields.shape[1]
    xbuf = torch.zeros((D * XB, KT), dtype=I32, device=dev)
    at = fdev[in_q] * XB + q[in_q].long()
    xbuf[at] = fields[in_q]
    sent = in_q.sum(dtype=I32)
    words = [
        sent,
        torch.zeros((), dtype=I32, device=dev),
        (deliverable & ~in_b).sum(dtype=I32),
        sendable.sum(dtype=I32) - sent,
        (routable & ~ring_ok).sum(dtype=I32),
        n_sup,
        G - n_sup,
    ]
    if packed is not None:
        words.append(refused.sum(dtype=I32))
        delivered = unpack_bits(packed, O) | in_q.reshape(G, O)
        all_valid = torch.arange(O, device=dev)[None, :] < out.count[:, None]
        und = (all_valid & ~delivered).any(dim=1).to(I32)
        if suppress is not None:
            und = torch.where(suppress.bool(), undeliv, und)
        packed.copy_(pack_bits(delivered))
        undeliv.copy_(und)
    return xbuf.reshape(D, XB, KT), torch.stack(words)


def lane_scatter(
    inbox: Inbox, recv: torch.Tensor, *, budget: int, base: int
) -> Tuple[Inbox, torch.Tensor]:
    """Shard's half of the lane after the ring shifts: ADD every received
    row with ``found != 0`` into inbox slot ``base + rank*budget + b`` of
    its destination row, in place (the reference's one-hot sum).  A row
    or slot outside ``[0, G)`` / ``[0, M)`` writes nothing but is still
    counted.  Returns ``(inbox, delivered)``."""
    G, M = inbox.mtype.shape
    E = inbox.ent_term.shape[2]
    ok = recv[:, XI_FOUND] != 0
    row = recv[:, XI_LOC]
    slot = base + recv[:, XI_RANK] * budget + recv[:, XI_B]
    put = ok & (row >= 0) & (row < G) & (slot >= 0) & (slot < M)
    at = (row[put].long() * M + slot[put].long(),)
    vals = recv[put]
    # recv column of each Inbox field, in Inbox order
    cols = (0, XI_FROM) + tuple(range(1, len(WIRE_COLS)))
    for t, c in zip(inbox[:10], cols):
        t.view(-1).index_put_(at, vals[:, c], accumulate=True)
    inbox.ent_term.view(G * M, E).index_put_(
        at, vals[:, X_KF:X_KF + E], accumulate=True)
    inbox.ent_cc.view(G * M, E).index_put_(
        at, vals[:, X_KF + E:X_KF + 2 * E], accumulate=True)
    return inbox, ok.sum(dtype=I32)
