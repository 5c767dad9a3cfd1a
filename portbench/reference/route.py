"""The frozen reference router and consensus round: plain PyTorch.

A frozen copy of the system's plain router: one-hot selects over the
peer and ring axes, ``any`` and ``sum`` over every matching peer slot,
int32 sums.  The inbox is direct-mapped: ``[0, base)`` holds the
injected tick and proposal slots, ``[base + r*budget, +budget)`` the
messages from the sender in slot ``r`` of the destination row's peer
table.  ``fused_rounds`` is K consecutive rounds of step, escalation
merge and route, as the system's fused wave runs them; with ``record``
it also keeps each round's operands for the byte counts of
``portbench/roofline``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import step
from .layout import (
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
    MT_TICK,
    ROLE_LEADER,
    DeviceOut,
    DeviceState,
    Inbox,
    merge_escalated,
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
) -> Tuple[Inbox, torch.Tensor, torch.Tensor]:
    """Scatter ``out``'s messages into a fresh (or prefilled) Inbox.

    Returns ``(inbox, stats, delivered)``: ``stats`` is the [6] int32
    vector in RouteStats order (delivered, dropped_off_device,
    dropped_budget, dropped_ring, suppressed, host_carried),
    ``delivered`` the [G, O] bool mask."""
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
    record: Optional[dict] = None,
) -> Tuple[DeviceState, Inbox, torch.Tensor, torch.Tensor]:
    """Undo escalated rows, then route the outboxes into the next
    round's inbox on top of a fresh tick/proposal prefill.  Returns
    (state', inbox', stats [6], escalated_row_count).  Consumes
    ``new_state``: the escalated rows are merged into it in place, and
    state' is that tree.  ``record`` gets the route's ``delivered``
    mask."""
    esc = out.escalate != 0
    n_esc = esc.sum(dtype=I32)
    state = DeviceState(*merge_escalated(
        out.escalate, old_state, new_state))
    prefill = make_prefill(
        state, M, E, propose_leaders=propose_leaders, propose_n=propose_n,
    )
    inbox, stats, delivered = route(
        state, out, dest_row, rank_in_dest,
        M=M, E=E, budget=budget, base=base,
        base_inbox=prefill, suppress=esc,
    )
    if record is not None:
        record["delivered"] = delivered
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
    record: Optional[dict] = None,
):
    """One consensus round: step every row, then ``merge_and_route``.
    ``record`` gets the round's operands: ``state_in``, ``inbox_in``,
    ``out`` (the step's outbox), ``state_out`` (after the merge),
    ``delivered`` and ``inbox_out``."""
    M, E = inbox.mtype.shape[1], inbox.ent_term.shape[2]
    new_state, out = step.step(state, inbox, out_capacity)
    res = merge_and_route(
        state, new_state, out, dest_row, rank_in_dest,
        M=M, E=E, budget=budget, base=base,
        propose_leaders=propose_leaders, propose_n=propose_n,
        record=record,
    )
    if record is not None:
        record.update(state_in=state, inbox_in=inbox, out=out,
                      state_out=res[0], inbox_out=res[1])
    return res


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
    record: Optional[List[dict]] = None,
):
    """``rounds`` consecutive ``routed_round`` calls.  Returns
    ``(state', inbox', stats [rounds, 6], n_esc [rounds])``; with
    ``record`` a list, each round appends its operands to it."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    stats_l, esc_l = [], []
    for _ in range(rounds):
        rec = None if record is None else {}
        state, inbox, stats, n_esc = routed_round(
            state, inbox, dest_row, rank_in_dest,
            out_capacity=out_capacity, budget=budget, base=base,
            propose_leaders=propose_leaders, propose_n=propose_n,
            record=rec,
        )
        if rec is not None:
            record.append(rec)
        stats_l.append(stats)
        esc_l.append(n_esc)
    return state, inbox, torch.stack(stats_l), torch.stack(esc_l)
