"""Plain PyTorch version of the raft step (the reference for ``raft_step``).

A transliteration of ``dragonboat_tpu/ops/kernel.py`` ``_step_impl`` /
``_process_slot`` and every handler into eager torch: masked whole-batch
passes over the INTERNAL (G-last) layout, slot by slot, exactly as the
JAX program computes them.  ``ops/kernel.py`` ``step`` runs this for
tensors on the CPU (the tests hold it bit-exact against the JAX step);
on the card the hand-written CUDA kernel ``csrc/raft_step.cu`` replaces
it, and ``chip_smoke.py`` holds the two bit-exact there.

Everything is int32 and wraps like the JAX program.  The uint32 election
jitter is computed in int64 masked to 32 bits (torch has no uint32
arithmetic on the CPU).

Handler invariant (the same as the reference's): every handler is a pure
no-op under an all-false mask, so a handler block may be skipped when no
row of the batch carries its message type (``_gate``).  ``_FORCE_GATES``
forces every gate open — the test lever that pins that invariant.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import convert
from .types import (
    APPEND_LO_NONE,
    DeviceOut,
    DeviceState,
    ESC_COLD,
    ESC_INVARIANT,
    ESC_OVERFLOW,
    ESC_WINDOW,
    F_SRC_SLOT,
    HOT_TYPES,
    I32,
    Inbox,
    KIND_NON_VOTING,
    KIND_VOTER,
    KIND_WITNESS,
    MT_CHECK_QUORUM,
    MT_ELECTION,
    MT_HEARTBEAT,
    MT_HEARTBEAT_RESP,
    MT_INSTALL_SNAPSHOT,
    MT_PROPOSE,
    MT_READ_INDEX,
    MT_READ_INDEX_RESP,
    MT_REPLICATE,
    MT_REPLICATE_RESP,
    MT_REQUEST_PREVOTE,
    MT_REQUEST_PREVOTE_RESP,
    MT_REQUEST_VOTE,
    MT_REQUEST_VOTE_RESP,
    MT_SNAPSHOT_RECEIVED,
    MT_SNAPSHOT_STATUS,
    MT_TICK,
    MT_TIMEOUT_NOW,
    MT_UNREACHABLE,
    N_FIELDS,
    ROLE_CANDIDATE,
    ROLE_FOLLOWER,
    ROLE_LEADER,
    ROLE_NON_VOTING,
    ROLE_PRE_CANDIDATE,
    ROLE_WITNESS,
    RS_REPLICATE,
    RS_RETRY,
    RS_SNAPSHOT,
    RS_WAIT,
    SLOT_DROPPED,
    SLOT_FORWARDED,
    SLOT_UNUSED,
)

# test hook (tests/test_torch_kernel.py): True forces every handler gate
# in _process_slot open, so each handler also runs under an all-false
# mask.  Never set this in production code.
_FORCE_GATES = False

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# small int32 helpers (torch.where of two python ints is int64)
# ---------------------------------------------------------------------------
def _w(mask, new, old):
    """Masked update; mask is [G], fields are [G] or [..., G]."""
    if not isinstance(new, torch.Tensor):
        new = int(new)
    return torch.where(mask, new, old)


def _bc(v, G: int, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(I32) if v.dtype != I32 else v
    return torch.full((G,), int(v), dtype=I32, device=device)


def _max(a, b):
    if not isinstance(b, torch.Tensor):
        return torch.clamp(a, min=int(b))
    if not isinstance(a, torch.Tensor):
        return torch.clamp(b, min=int(a))
    return torch.maximum(a, b)


def _sum0(b: torch.Tensor) -> torch.Tensor:
    return b.sum(dim=0, dtype=I32)


def _arange_col(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)[:, None]


# ---------------------------------------------------------------------------
# internal (G-last) layout plumbing
# ---------------------------------------------------------------------------
def _make_out_internal(G, P, M, E, O, device) -> DeviceOut:
    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=device)

    return DeviceOut(
        buf=full((O, N_FIELDS, G), 0),
        count=full((G,), 0),
        escalate=full((G,), 0),
        need_snapshot=full((P, G), 0),
        slot_base=full((M, G), SLOT_UNUSED),
        slot_term=full((M, G), 0),
        ent_drop=full((M, E, G), 0),
        append_lo=full((G,), APPEND_LO_NONE),
        barrier_idx=full((G,), -1),
        barrier_term=full((G,), 0),
    )


def _P(st: DeviceState) -> int:
    return st.peer_id.shape[0]


def _W(st: DeviceState) -> int:
    return st.ring_term.shape[0]


def _G(st: DeviceState) -> int:
    return st.term.shape[0]


# ---------------------------------------------------------------------------
# deterministic election jitter (uint32 math in masked int64)
# ---------------------------------------------------------------------------
def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2**32 for 0 <= z < 2**32 without int64 overflow."""
    lo = z & 0xFFFF
    hi = z >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _splitmix32(x: torch.Tensor) -> torch.Tensor:
    z = ((x.to(torch.int64) & _M32) + 0x9E3779B9) & _M32
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    z = z ^ (z >> 16)
    return z


def _jitter(shard_id, replica_id, seq, span):
    def u(x):
        return x.to(torch.int64) & _M32

    h = _splitmix32(
        ((u(shard_id) << 24) & _M32) ^ ((u(replica_id) << 8) & _M32) ^ u(seq)
    )
    sp = u(span)
    # a zero span never occurs on a live row; keep the dividend there
    # instead of dividing by zero
    r = torch.where(sp == 0, h, h % torch.where(sp == 0, 1, sp))
    # uint32 -> int32 bit reinterpretation
    return torch.where(r >= 2**31, r - 2**32, r).to(I32)


def reset_timeout(st: DeviceState, mask) -> DeviceState:
    """oracle: Raft._reset_randomized_timeout ([G] fields only)."""
    if not bool(mask.any()):
        return st
    seq = st.timeout_seq + 1
    rt = st.election_timeout + _jitter(
        st.shard_id, st.replica_id, seq, st.election_timeout
    )
    return st._replace(
        timeout_seq=_w(mask, seq, st.timeout_seq),
        rand_timeout=_w(mask, rt, st.rand_timeout),
    )


# ---------------------------------------------------------------------------
# peer-slot helpers (peer arrays are [P, G])
# ---------------------------------------------------------------------------
def _valid(st):
    return st.peer_id != 0


def _voters(st):
    """Voting members = voters + witnesses (oracle: voting_members)."""
    return _valid(st) & (
        (st.peer_kind == KIND_VOTER) | (st.peer_kind == KIND_WITNESS)
    )


def _num_voters(st):
    return _sum0(_voters(st))


def _quorum(st):
    return _num_voters(st) // 2 + 1


def _col(arr, slot):
    """arr[slot[g], g] for [P, G] arr; a slot outside [0, P) reads 0."""
    n = arr.shape[0]
    ok = (slot >= 0) & (slot < n)
    got = arr.gather(0, slot.clamp(0, n - 1).long()[None, :])[0]
    return torch.where(ok, got, torch.zeros_like(got))


def _set_col(arr, slot, mask, val):
    """arr[slot[g], g] = val where mask; a slot outside [0, P) writes
    nothing."""
    onehot = _arange_col(arr.shape[0], arr.device) == slot[None, :]
    val = _bc(val, slot.shape[0], arr.device)
    return torch.where(onehot & mask, val[None, :], arr)


def _self_kind(st):
    return _col(st.peer_kind, st.self_slot)


def _self_is_voter(st):
    return (_col(st.peer_id, st.self_slot) == st.replica_id) & (
        _self_kind(st) == KIND_VOTER
    )


def _slot_of(st, pid):
    """Peer slot holding replica ``pid`` [G] -> (slot [G], found [G]);
    slot 0 when nothing matches (argmax of all-false)."""
    hit = (st.peer_id == pid[None, :]) & _valid(st) & (pid != 0)[None, :]
    found = hit.any(dim=0)
    slot = hit.to(torch.uint8).argmax(dim=0).to(I32)
    return slot, found


# ---------------------------------------------------------------------------
# log-term ring (ring arrays are [W, G])
# ---------------------------------------------------------------------------
def _win_lo(st):
    return torch.maximum(st.first_index, st.last_index - (_W(st) - 1))


def _ring_at(st, idx):
    safe = idx.clamp(min=0) & (_W(st) - 1)
    return _col(st.ring_term, safe), _col(st.ring_cc, safe)


def _log_term(st, idx):
    """term(idx) -> (term, known, needs_escalation) — oracle: EntryLog.term."""
    rt, _ = _ring_at(st, idx)
    zero = idx == 0
    boundary = idx == st.first_index - 1
    in_win = (idx >= _win_lo(st)) & (idx <= st.last_index)
    beyond = idx > st.last_index
    term = torch.where(zero, 0, torch.where(boundary, st.base_term, rt))
    known = zero | boundary | in_win
    esc = ~known & ~beyond
    return term, known, esc


def _match_term(st, idx, term):
    t, known, esc = _log_term(st, idx)
    return known & (t == term), esc


def _last_term(st):
    t, _, esc = _log_term(st, st.last_index)
    return t, esc


def _ring_append_one(st, mask, idx, term, cc):
    """Write (term, cc) at log position idx where mask."""
    G = _G(st)
    pos = idx.clamp(min=0) & (_W(st) - 1)
    sel = (_arange_col(_W(st), idx.device) == pos[None, :]) & mask
    term = _bc(term, G, idx.device)
    cc = _bc(cc, G, idx.device)
    return st._replace(
        ring_term=torch.where(sel, term[None, :], st.ring_term),
        ring_cc=torch.where(sel, cc[None, :], st.ring_cc),
    )


def _pending_cc_scan(st, mask):
    """Any config-change bit in (committed, last_index]?  Escalates if
    the uncommitted tail extends below the ring window."""
    W = _W(st)
    idxs = _arange_col(W, st.term.device)
    lo = _win_lo(st)[None, :]
    last = st.last_index[None, :]
    cand = lo + ((idxs - lo) & (W - 1))
    in_tail = (cand > st.committed[None, :]) & (cand <= last)
    any_cc = (in_tail & (st.ring_cc == 1)).any(dim=0)
    esc = (
        mask
        & (st.committed + 1 < _win_lo(st))
        & (st.committed < st.last_index)
    )
    return any_cc, esc


# ---------------------------------------------------------------------------
# outbox emission (buf is [O, N_FIELDS, G])
# ---------------------------------------------------------------------------
def _emit(
    out: DeviceOut,
    mask,
    *,
    mtype,
    to,
    term,
    log_term=0,
    log_index=0,
    commit=0,
    reject=0,
    hint=0,
    hint_high=0,
    n_entries=0,
    src_slot=-1,
) -> DeviceOut:
    """Append one message per masked row (oracle: Raft._send)."""
    if not bool(mask.any()):
        return out  # exact no-op under an all-false mask
    O, G = out.buf.shape[0], out.buf.shape[2]
    dev = out.buf.device
    row = torch.stack(
        [
            _bc(v, G, dev)
            for v in (
                mtype, to, term, log_term, log_index, commit, reject, hint,
                hint_high, n_entries, src_slot,
            )
        ],
        dim=0,
    )  # [N_FIELDS, G]
    idx = out.count
    can = mask & (idx < O)
    overflow = mask & (idx >= O)
    buf = out.buf
    if bool(can.any()):
        gs = can.nonzero()[:, 0]
        buf = buf.clone()
        buf[idx[gs].long(), :, gs] = row[:, gs].t()
    return out._replace(
        buf=buf,
        count=out.count + can.to(I32),
        escalate=out.escalate | torch.where(overflow, ESC_OVERFLOW, 0).to(I32),
    )


def _esc(out, cond, bit):
    return out._replace(
        escalate=out.escalate | torch.where(cond, bit, 0).to(I32)
    )


# ---------------------------------------------------------------------------
# role transitions (oracle: Raft._reset / become_*)
# ---------------------------------------------------------------------------
def _reset(st: DeviceState, mask, new_term) -> DeviceState:
    term_changed = mask & (st.term != new_term)
    st = st._replace(
        term=_w(mask, new_term, st.term),
        vote=_w(term_changed, 0, st.vote),
        leader_id=_w(mask, 0, st.leader_id),
        election_tick=_w(mask, 0, st.election_tick),
        heartbeat_tick=_w(mask, 0, st.heartbeat_tick),
        granted=_w(mask, 0, st.granted),
        transfer_target=_w(mask, 0, st.transfer_target),
        pending_cc=_w(mask, 0, st.pending_cc),
    )
    st = reset_timeout(st, mask)
    # remotes: rm.reset(last+1); self slot keeps match=last
    mgp = mask & _valid(st)
    is_self = (
        _arange_col(_P(st), mask.device) == st.self_slot[None, :]
    ) & mgp
    last = st.last_index[None, :]
    return st._replace(
        match=torch.where(mgp, torch.where(is_self, last, 0), st.match),
        next_idx=torch.where(mgp, last + 1, st.next_idx),
        rstate=_w(mgp, RS_RETRY, st.rstate),
        snap_index=_w(mgp, 0, st.snap_index),
    )


def _become_follower(st, mask, new_term, leader) -> DeviceState:
    if not bool(mask.any()):
        return st
    sk = _self_kind(st)
    role = torch.where(
        sk == KIND_NON_VOTING,
        ROLE_NON_VOTING,
        torch.where(sk == KIND_WITNESS, ROLE_WITNESS, ROLE_FOLLOWER),
    ).to(I32)
    st = st._replace(role=_w(mask, role, st.role))
    st = _reset(st, mask, _bc(new_term, _G(st), mask.device))
    return st._replace(leader_id=_w(mask, leader, st.leader_id))


def _become_pre_candidate(st, mask) -> DeviceState:
    st = st._replace(
        role=_w(mask, ROLE_PRE_CANDIDATE, st.role),
        granted=_w(mask, 0, st.granted),
        leader_id=_w(mask, 0, st.leader_id),
        election_tick=_w(mask, 0, st.election_tick),
    )
    return reset_timeout(st, mask)


def _grant_self(st, mask):
    sel = (
        _arange_col(st.granted.shape[0], mask.device) == st.self_slot[None, :]
    ) & mask
    return _w(sel, 1, st.granted)


def _become_candidate(st, mask) -> DeviceState:
    st = st._replace(role=_w(mask, ROLE_CANDIDATE, st.role))
    st = _reset(st, mask, st.term + 1)
    st = st._replace(vote=_w(mask, st.replica_id, st.vote))
    return st._replace(granted=_grant_self(st, mask))


def _vote_quorum(st):
    return _sum0(_voters(st) & (st.granted == 1)) >= _quorum(st)


def _vote_rejected(st):
    return _sum0(_voters(st) & (st.granted == 2)) >= _quorum(st)


def _append_one(st, out, mask, cc) -> Tuple[DeviceState, DeviceOut]:
    """Leader-side append of one entry at the current term."""
    new_last = st.last_index + 1
    out = out._replace(
        append_lo=torch.where(
            mask, torch.minimum(out.append_lo, new_last), out.append_lo
        )
    )
    st = _ring_append_one(st, mask, new_last, st.term, cc)
    st = st._replace(last_index=_w(mask, new_last, st.last_index))
    self_match = _col(st.match, st.self_slot)
    self_next = _col(st.next_idx, st.self_slot)
    st = st._replace(
        match=_set_col(
            st.match, st.self_slot, mask, torch.maximum(self_match, new_last)
        ),
        next_idx=_set_col(
            st.next_idx,
            st.self_slot,
            mask,
            torch.maximum(self_next, new_last + 1),
        ),
    )
    return st, out


def _try_commit(st, out, mask):
    """oracle: try_commit — sorted-match quorum + current-term-only gate."""
    eff = torch.where(_voters(st), st.match, -1)
    s = torch.sort(eff, dim=0).values  # ascending; non-voters sink
    q = _quorum(st)
    qidx = _col(s, _P(st) - q)
    higher = mask & (qidx > st.committed)
    ok, esc = _match_term(st, qidx, st.term)
    out = _esc(out, higher & esc, ESC_WINDOW)
    adv = higher & ok
    st = st._replace(committed=_w(adv, qidx, st.committed))
    return st, out, adv


# ---------------------------------------------------------------------------
# sending replicate / heartbeats
# ---------------------------------------------------------------------------
def _send_replicate(st, out, mask, slot, E):
    """oracle: send_replicate(to) with the device entry cap E."""
    if not bool(mask.any()):
        return st, out
    rs = _col(st.rstate, slot)
    nxt = _col(st.next_idx, slot)
    to = _col(st.peer_id, slot)
    paused = (rs == RS_WAIT) | (rs == RS_SNAPSHOT)
    m = mask & ~paused & (to != 0)
    prev = nxt - 1
    # compacted below the resolvable boundary -> snapshot path
    need_ss = m & (prev < st.first_index - 1)
    sel = (
        _arange_col(out.need_snapshot.shape[0], mask.device) == slot[None, :]
    ) & need_ss
    out = out._replace(need_snapshot=_w(sel, 1, out.need_snapshot))
    st = st._replace(rstate=_set_col(st.rstate, slot, need_ss, RS_WAIT))
    prev_term, known, _esc_unused = _log_term(st, prev)
    m2 = m & ~need_ss
    # below-ring prev: log_term=0 is the host-fixup marker
    n = (st.last_index - prev).clamp(0, E)
    out = _emit(
        out,
        m2,
        mtype=MT_REPLICATE,
        to=to,
        term=st.term,
        log_index=prev,
        log_term=torch.where(known, prev_term, 0),
        commit=st.committed,
        n_entries=n,
    )
    prog = m2 & (n > 0)
    last_sent = prev + n
    st = st._replace(
        next_idx=_set_col(
            st.next_idx, slot, prog & (rs == RS_REPLICATE), last_sent + 1
        ),
        rstate=_set_col(st.rstate, slot, prog & (rs == RS_RETRY), RS_WAIT),
    )
    return st, out


def _broadcast_replicate(st, out, mask, E):
    if not bool(mask.any()):
        return st, out
    G = _G(st)
    for p in range(_P(st)):
        slot = torch.full((G,), p, dtype=I32, device=mask.device)
        pm = mask & _valid(st)[p] & (st.self_slot != p)
        st, out = _send_replicate(st, out, pm, slot, E)
    return st, out


def _broadcast_heartbeat(st, out, mask, hint=0, hint_high=0):
    """oracle: broadcast_heartbeat (with the read-index ctx in the hint
    fields)."""
    if not bool(mask.any()):
        return out
    for p in range(_P(st)):
        pm = mask & _valid(st)[p] & (st.self_slot != p)
        out = _emit(
            out,
            pm,
            mtype=MT_HEARTBEAT,
            to=st.peer_id[p],
            term=st.term,
            commit=torch.minimum(st.match[p], st.committed),
            log_index=st.committed,
            hint=hint,
            hint_high=hint_high,
        )
    return out


def _become_leader(st, out, mask, E):
    """oracle: become_leader (+ the single-voter fast commit)."""
    if not bool(mask.any()):
        return st, out
    st = st._replace(role=_w(mask, ROLE_LEADER, st.role))
    st = _reset(st, mask, st.term)
    st = st._replace(leader_id=_w(mask, st.replica_id, st.leader_id))
    st = st._replace(active=_w(mask & _valid(st), 1, st.active))
    any_cc, esc = _pending_cc_scan(st, mask)
    out = _esc(out, esc, ESC_WINDOW)
    st = st._replace(pending_cc=_w(mask, any_cc.to(I32), st.pending_cc))
    # commit barrier: empty entry at the new term
    st, out = _append_one(st, out, mask, 0)
    out = out._replace(
        barrier_idx=torch.where(mask, st.last_index, out.barrier_idx),
        barrier_term=torch.where(mask, st.term, out.barrier_term),
    )
    single = _num_voters(st) == 1
    st, out, _ = _try_commit(st, out, mask & single & _self_is_voter(st))
    return st, out


# ---------------------------------------------------------------------------
# campaign (oracle: campaign / _handle_election)
# ---------------------------------------------------------------------------
def _campaign(st, out, mask, pre, transfer, E):
    if not bool(mask.any()):
        return st, out
    pre_m = mask & pre
    real_m = mask & ~pre
    # --- prevote leg ---------------------------------------------------
    st = _become_pre_candidate(st, pre_m)
    st = st._replace(granted=_grant_self(st, pre_m))
    promote = pre_m & _vote_quorum(st)  # single-voter shortcut
    bcast_pre = pre_m & ~promote
    lt, lt_esc = _last_term(st)
    out = _esc(out, bcast_pre & lt_esc, ESC_WINDOW)
    for p in range(_P(st)):
        pm = bcast_pre & _voters(st)[p] & (st.self_slot != p)
        out = _emit(
            out,
            pm,
            mtype=MT_REQUEST_PREVOTE,
            to=st.peer_id[p],
            term=st.term + 1,
            log_index=st.last_index,
            log_term=lt,
        )
    real_m = real_m | promote
    # --- real leg ------------------------------------------------------
    st = _become_candidate(st, real_m)
    lead = real_m & _vote_quorum(st)  # single voter
    st, out = _become_leader(st, out, lead, E)
    bcast = real_m & ~lead
    lt2, lt2_esc = _last_term(st)
    out = _esc(out, bcast & lt2_esc, ESC_WINDOW)
    hint = torch.where(transfer, st.replica_id, 0)
    for p in range(_P(st)):
        pm = bcast & _voters(st)[p] & (st.self_slot != p)
        out = _emit(
            out,
            pm,
            mtype=MT_REQUEST_VOTE,
            to=st.peer_id[p],
            term=st.term,
            log_index=st.last_index,
            log_term=lt2,
            hint=hint,
        )
    return st, out


def _handle_election(st, out, mask, hint, E):
    if not bool(mask.any()):
        return st, out
    m = (
        mask
        & (st.role != ROLE_LEADER)
        & (st.role != ROLE_NON_VOTING)
        & (st.role != ROLE_WITNESS)
        & _self_is_voter(st)
    )
    transfer = hint == st.replica_id
    pre = (st.pre_vote == 1) & ~transfer
    return _campaign(st, out, m, pre, transfer, E)


# ---------------------------------------------------------------------------
# check quorum / tick
# ---------------------------------------------------------------------------
def _check_quorum(st, mask):
    if not bool(mask.any()):
        return st
    voters = _voters(st)
    is_self = _arange_col(_P(st), mask.device) == st.self_slot[None, :]
    cnt = 1 + _sum0(voters & ~is_self & (st.active == 1))
    st = st._replace(active=_w(mask & voters, 0, st.active))
    down = mask & (cnt < _quorum(st))
    return _become_follower(st, down, st.term, 0)


def _tick(st, out, mask, E, hint, hint_high, n):
    """Advance the tick timers by ``n`` logical ticks in one slot
    (multi-tick fusion; ``n=1`` is the reference's per-tick step)."""
    lead = mask & (st.role == ROLE_LEADER)
    non = mask & (st.role != ROLE_LEADER)
    # each half touches only its own rows
    st, out = _gate(
        lead.any(),
        lambda s, o: _tick_leader(s, o, lead, hint, hint_high, n),
        st, out,
    )
    return _gate(
        non.any(), lambda s, o: _tick_other(s, o, non, E, n), st, out
    )


def _tick_leader(st, out, lead, hint, hint_high, n):
    el = st.election_tick + n
    hb = st.heartbeat_tick + n
    fired = el >= st.election_timeout
    st = st._replace(
        election_tick=_w(lead, torch.where(fired, 0, el), st.election_tick),
        heartbeat_tick=_w(lead, hb, st.heartbeat_tick),
    )
    cq = lead & fired & (st.check_quorum == 1)
    st = _check_quorum(st, cq)
    still = lead & (st.role == ROLE_LEADER)
    st = st._replace(
        transfer_target=_w(still & fired, 0, st.transfer_target)
    )
    hb_fire = still & (st.heartbeat_tick >= st.heartbeat_timeout)
    st = st._replace(heartbeat_tick=_w(hb_fire, 0, st.heartbeat_tick))
    out = _broadcast_heartbeat(st, out, hb_fire, hint, hint_high)
    return st, out


def _tick_other(st, out, non, E, n):
    G = _G(st)
    el2 = st.election_tick + n
    time_up = el2 >= st.rand_timeout
    nvw = (st.role == ROLE_NON_VOTING) | (st.role == ROLE_WITNESS)
    probe = non & nvw & (st.check_quorum == 1) & time_up
    st = st._replace(election_tick=_w(non, el2, st.election_tick))
    st = st._replace(election_tick=_w(probe, 0, st.election_tick))
    st = reset_timeout(st, probe)
    elect = non & ~nvw & time_up
    st = st._replace(election_tick=_w(elect, 0, st.election_tick))
    zero = torch.zeros((G,), dtype=I32, device=non.device)
    return _handle_election(st, out, elect, zero, E)


# ---------------------------------------------------------------------------
# message-term gate (oracle: _on_message_term)
# ---------------------------------------------------------------------------
def _on_message_term(st, out, msg, mask):
    mt = msg["mtype"]
    mterm = msg["term"]
    local = mterm == 0
    if not _FORCE_GATES and not bool(
            (mask & ~local & (mterm != st.term)).any()):
        return st, out, mask  # every masked row is local or at our term
    higher = mask & ~local & (mterm > st.term)
    lower = mask & ~local & (mterm < st.term)
    vote_like = (mt == MT_REQUEST_VOTE) | (mt == MT_REQUEST_PREVOTE)
    in_lease = (
        (st.check_quorum == 1)
        & (st.leader_id != 0)
        & (st.election_tick < st.election_timeout)
    )
    drop_lease = higher & vote_like & in_lease & (msg["hint"] == 0)
    leader_msg = (
        (mt == MT_REPLICATE)
        | (mt == MT_INSTALL_SNAPSHOT)
        | (mt == MT_HEARTBEAT)
        | (mt == MT_TIMEOUT_NOW)
        | (mt == MT_READ_INDEX_RESP)
    )
    keep_term = (mt == MT_REQUEST_PREVOTE) | (
        (mt == MT_REQUEST_PREVOTE_RESP) & (msg["reject"] == 0)
    )
    become = higher & ~drop_lease & ~keep_term
    st = _become_follower(
        st, become, mterm, torch.where(leader_msg, msg["from_id"], 0)
    )
    # deposed-leader poke: a lower-term leader must step down
    poke = (
        lower
        & (
            (mt == MT_REPLICATE)
            | (mt == MT_HEARTBEAT)
            | (mt == MT_INSTALL_SNAPSHOT)
        )
        & ((st.check_quorum == 1) | (st.pre_vote == 1))
    )
    out = _emit(
        out, poke, mtype=MT_REPLICATE_RESP, to=msg["from_id"], term=st.term
    )
    pv_rej = lower & (mt == MT_REQUEST_PREVOTE)
    out = _emit(
        out,
        pv_rej,
        mtype=MT_REQUEST_PREVOTE_RESP,
        to=msg["from_id"],
        term=st.term,
        reject=1,
    )
    passed = mask & (local | (mterm == st.term) | (higher & ~drop_lease))
    return st, out, passed


# ---------------------------------------------------------------------------
# vote handling
# ---------------------------------------------------------------------------
def _can_grant_vote(st, msg, prevote: bool):
    ok = (st.vote == 0) | (st.vote == msg["from_id"])
    if prevote:
        ok = ok | (msg["term"] > st.term)
    return ok


def _up_to_date(st, out, mask, msg):
    lt, esc = _last_term(st)
    out = _esc(out, mask & esc, ESC_WINDOW)
    utd = (msg["log_term"] > lt) | (
        (msg["log_term"] == lt) & (msg["log_index"] >= st.last_index)
    )
    return out, utd


def _handle_request_vote(st, out, msg, mask):
    m = mask & (st.role != ROLE_NON_VOTING)
    if not bool(m.any()):
        return st, out
    out, utd = _up_to_date(st, out, m, msg)
    grant = m & _can_grant_vote(st, msg, False) & utd
    st = st._replace(
        election_tick=_w(grant, 0, st.election_tick),
        vote=_w(grant, msg["from_id"], st.vote),
    )
    out = _emit(
        out,
        m,
        mtype=MT_REQUEST_VOTE_RESP,
        to=msg["from_id"],
        term=st.term,
        reject=torch.where(grant, 0, 1),
    )
    return st, out


def _handle_request_prevote(st, out, msg, mask):
    m = mask & (st.role != ROLE_NON_VOTING)
    if not bool(m.any()):
        return st, out
    out, utd = _up_to_date(st, out, m, msg)
    grant = m & utd & (
        (msg["term"] > st.term) | _can_grant_vote(st, msg, True)
    )
    out = _emit(
        out,
        m,
        mtype=MT_REQUEST_PREVOTE_RESP,
        to=msg["from_id"],
        term=torch.where(grant, msg["term"], st.term),
        reject=torch.where(grant, 0, 1),
    )
    return st, out


# ---------------------------------------------------------------------------
# replicate / heartbeat handling (follower side)
# ---------------------------------------------------------------------------
def _handle_replicate(st, out, msg, mask):
    """oracle: _handle_replicate (follower log append + log matching)."""
    if not bool(mask.any()):
        return st, out
    G = _G(st)
    E = int(msg["ent_term"].shape[0])
    stale = mask & (msg["log_index"] < st.committed)
    out = _emit(
        out,
        stale,
        mtype=MT_REPLICATE_RESP,
        to=msg["from_id"],
        term=st.term,
        log_index=st.committed,
    )
    m = mask & ~stale
    prev_ok, esc = _match_term(st, msg["log_index"], msg["log_term"])
    out = _esc(out, m & esc, ESC_WINDOW)
    ok = m & prev_ok
    n = msg["n_entries"]
    last_new = msg["log_index"] + n
    # conflict scan: first carried entry whose (index, term) mismatches
    conflict_off = torch.full((G,), E + 1, dtype=I32, device=mask.device)
    conflict_esc = torch.zeros((G,), dtype=torch.bool, device=mask.device)
    for i in reversed(range(E)):
        idx = msg["log_index"] + 1 + i
        mt_ok, e_esc = _match_term(st, idx, msg["ent_term"][i])
        has = ok & (i < n)
        conflict_off = _w(has & ~mt_ok, i, conflict_off)
        conflict_esc = torch.where(has & ~mt_ok, e_esc, conflict_esc)
    # a conflict beyond last_index is an append, not an escalation
    idx_at_conf = msg["log_index"] + 1 + conflict_off
    conflict_esc = conflict_esc & (idx_at_conf <= st.last_index)
    out = _esc(out, ok & conflict_esc, ESC_WINDOW)
    has_conflict = ok & (conflict_off <= E)
    # invariant: conflict must be above commit (oracle raises otherwise)
    out = _esc(out, has_conflict & (idx_at_conf <= st.committed), ESC_INVARIANT)
    first_written = msg["log_index"] + 1 + conflict_off
    out = out._replace(
        append_lo=torch.where(
            has_conflict,
            torch.minimum(out.append_lo, first_written),
            out.append_lo,
        )
    )
    for i in range(E):
        idx = msg["log_index"] + 1 + i
        wmask = has_conflict & (i >= conflict_off) & (i < n)
        st = _ring_append_one(
            st, wmask, idx, msg["ent_term"][i], msg["ent_cc"][i]
        )
    st = st._replace(last_index=_w(has_conflict, last_new, st.last_index))
    new_commit = torch.minimum(msg["commit"], last_new)
    st = st._replace(
        committed=_w(ok, torch.maximum(st.committed, new_commit), st.committed)
    )
    out = _emit(
        out,
        ok,
        mtype=MT_REPLICATE_RESP,
        to=msg["from_id"],
        term=st.term,
        log_index=last_new,
    )
    rej = m & ~prev_ok
    out = _emit(
        out,
        rej,
        mtype=MT_REPLICATE_RESP,
        to=msg["from_id"],
        term=st.term,
        reject=1,
        log_index=msg["log_index"],
        hint=st.last_index,
    )
    return st, out


def _handle_heartbeat(st, out, msg, mask):
    if not bool(mask.any()):
        return st, out
    new_commit = torch.minimum(msg["commit"], st.last_index)
    st = st._replace(
        committed=_w(
            mask, torch.maximum(st.committed, new_commit), st.committed
        )
    )
    out = _emit(
        out,
        mask,
        mtype=MT_HEARTBEAT_RESP,
        to=msg["from_id"],
        term=st.term,
        hint=msg["hint"],
        hint_high=msg["hint_high"],
    )
    return st, out


# ---------------------------------------------------------------------------
# leader-side response handling
# ---------------------------------------------------------------------------
def _handle_replicate_resp(st, out, msg, mask, E):
    if not bool(mask.any()):
        return st, out
    slot, found = _slot_of(st, msg["from_id"])
    m = mask & found
    st = st._replace(active=_set_col(st.active, slot, m, 1))
    rs = _col(st.rstate, slot)
    match = _col(st.match, slot)
    nxt = _col(st.next_idx, slot)
    snap = _col(st.snap_index, slot)
    li = msg["log_index"]
    rej = m & (msg["reject"] == 1)
    # -- decrease (oracle: remote.decrease) -----------------------------
    repl = rs == RS_REPLICATE
    do_r = rej & repl & (li > match)
    st = st._replace(
        next_idx=_set_col(st.next_idx, slot, do_r, match + 1),
        snap_index=_set_col(st.snap_index, slot, do_r, 0),
        rstate=_set_col(st.rstate, slot, do_r, RS_RETRY),
    )
    do_nr = rej & ~repl & (nxt - 1 == li)
    dec_next = _max(
        torch.maximum(torch.minimum(li, msg["hint"] + 1), match + 1), 1
    )
    st = st._replace(
        next_idx=_set_col(st.next_idx, slot, do_nr, dec_next),
        rstate=_set_col(st.rstate, slot, do_nr & (rs == RS_WAIT), RS_RETRY),
    )
    st, out = _send_replicate(st, out, do_r | do_nr, slot, E)
    # -- ack (oracle: _handle_replicate_resp accept path) ---------------
    ack = m & (msg["reject"] == 0)
    paused = (rs == RS_WAIT) | (rs == RS_SNAPSHOT)
    advanced = ack & (match < li)
    new_match = torch.maximum(match, li)
    new_next = torch.maximum(nxt, li + 1)
    st = st._replace(
        match=_set_col(st.match, slot, advanced, new_match),
        next_idx=_set_col(st.next_idx, slot, ack, new_next),
        rstate=_set_col(st.rstate, slot, advanced & (rs == RS_WAIT), RS_RETRY),
    )
    # snapshot -> retry -> replicate promotions
    rs2 = _col(st.rstate, slot)
    promote_ss = advanced & (rs2 == RS_SNAPSHOT) & (new_match >= snap)
    st = st._replace(
        next_idx=_set_col(
            st.next_idx,
            slot,
            promote_ss,
            torch.maximum(new_match + 1, snap + 1),
        ),
        snap_index=_set_col(st.snap_index, slot, promote_ss, 0),
        rstate=_set_col(st.rstate, slot, promote_ss, RS_RETRY),
    )
    rs3 = _col(st.rstate, slot)
    promote_r = advanced & (rs3 == RS_RETRY)
    st = st._replace(
        next_idx=_set_col(st.next_idx, slot, promote_r, new_match + 1),
        snap_index=_set_col(st.snap_index, slot, promote_r, 0),
        rstate=_set_col(st.rstate, slot, promote_r, RS_REPLICATE),
    )
    st, out, committed_adv = _try_commit(st, out, advanced)
    st, out = _broadcast_replicate(st, out, committed_adv, E)
    st, out = _send_replicate(
        st, out, advanced & ~committed_adv & paused, slot, E
    )
    # leader transfer: target caught up -> TIMEOUT_NOW
    ready = (
        advanced
        & (st.transfer_target == msg["from_id"])
        & (st.last_index == new_match)
    )
    out = _emit(
        out, ready, mtype=MT_TIMEOUT_NOW, to=msg["from_id"], term=st.term
    )
    # stale ack while streaming a snapshot that has completed
    rs4 = _col(st.rstate, slot)
    m4 = _col(st.match, slot)
    s4 = _col(st.snap_index, slot)
    stale_ss = ack & ~advanced & (rs4 == RS_SNAPSHOT) & (m4 >= s4)
    st = st._replace(
        next_idx=_set_col(
            st.next_idx, slot, stale_ss, torch.maximum(m4 + 1, s4 + 1)
        ),
        snap_index=_set_col(st.snap_index, slot, stale_ss, 0),
        rstate=_set_col(st.rstate, slot, stale_ss, RS_RETRY),
    )
    return st, out


def _handle_heartbeat_resp(st, out, msg, mask, E):
    if not bool(mask.any()):
        return st, out
    slot, found = _slot_of(st, msg["from_id"])
    m = mask & found
    st = st._replace(active=_set_col(st.active, slot, m, 1))
    rs = _col(st.rstate, slot)
    st = st._replace(
        rstate=_set_col(st.rstate, slot, m & (rs == RS_WAIT), RS_RETRY)
    )
    lag = m & (_col(st.match, slot) < st.last_index)
    st, out = _send_replicate(st, out, lag, slot, E)
    # read-index ctx echo to the host (voting members only)
    kind = _col(st.peer_kind, slot)
    voter = (kind == KIND_VOTER) | (kind == KIND_WITNESS)
    has_ctx = m & voter & ((msg["hint"] != 0) | (msg["hint_high"] != 0))
    out = _emit(
        out,
        has_ctx,
        mtype=MT_READ_INDEX_RESP,
        to=st.replica_id,
        term=st.term,
        log_index=msg["from_id"],
        hint=msg["hint"],
        hint_high=msg["hint_high"],
    )
    return st, out


def _handle_read_index(st, out, msg, mask):
    """Device ReadIndex hot path (oracle: _handle_leader_read_index)."""
    if not bool(mask.any()):
        return out
    lead = mask & (st.role == ROLE_LEADER) & (_self_kind(st) != KIND_WITNESS)
    non_lead = mask & ~lead
    out = _emit(
        out,
        non_lead,
        mtype=MT_READ_INDEX_RESP,
        to=st.replica_id,
        term=st.term,
        reject=1,
        hint=msg["hint"],
        hint_high=msg["hint_high"],
    )
    ok, esc = _match_term(st, st.committed, st.term)
    out = _esc(out, lead & esc, ESC_WINDOW)
    gate_fail = lead & ~ok & ~esc
    out = _emit(
        out,
        gate_fail,
        mtype=MT_READ_INDEX_RESP,
        to=st.replica_id,
        term=st.term,
        reject=1,
        hint=msg["hint"],
        hint_high=msg["hint_high"],
    )
    serve = lead & ok
    out = _emit(
        out,
        serve,
        mtype=MT_READ_INDEX_RESP,
        to=st.replica_id,
        term=st.term,
        commit=st.committed,
        hint=msg["hint"],
        hint_high=msg["hint_high"],
    )
    multi = serve & (_num_voters(st) > 1)
    return _broadcast_heartbeat(st, out, multi, msg["hint"], msg["hint_high"])


def _handle_unreachable(st, msg, mask):
    if not bool(mask.any()):
        return st
    slot, found = _slot_of(st, msg["from_id"])
    m = mask & found & (_col(st.rstate, slot) == RS_REPLICATE)
    match = _col(st.match, slot)
    return st._replace(
        next_idx=_set_col(st.next_idx, slot, m, match + 1),
        snap_index=_set_col(st.snap_index, slot, m, 0),
        rstate=_set_col(st.rstate, slot, m, RS_RETRY),
    )


def _handle_snapshot_status(st, msg, mask):
    """The remote leaves SNAPSHOT into WAIT (become_wait)."""
    if not bool(mask.any()):
        return st
    slot, found = _slot_of(st, msg["from_id"])
    m = mask & found & (_col(st.rstate, slot) == RS_SNAPSHOT)
    snap = _col(st.snap_index, slot)
    snap = _w(m & (msg["reject"] == 1), 0, snap)
    match = _col(st.match, slot)
    new_next = torch.maximum(match + 1, snap + 1)
    return st._replace(
        next_idx=_set_col(st.next_idx, slot, m, new_next),
        snap_index=_set_col(st.snap_index, slot, m, 0),
        rstate=_set_col(st.rstate, slot, m, RS_WAIT),
    )


# ---------------------------------------------------------------------------
# propose (oracle: _handle_propose)
# ---------------------------------------------------------------------------
def _handle_propose(st, out, msg, mask, slot_i, E):
    if not bool(mask.any()):
        return st, out
    G = _G(st)
    dev = mask.device
    lead = mask & (st.role == ROLE_LEADER)
    n = msg["n_entries"]
    transferring = st.transfer_target != 0
    drop_all = lead & transferring
    accept = lead & ~transferring
    base = st.last_index
    # per-entry config-change gate, sequential within the message
    appended_any = torch.zeros((G,), dtype=torch.bool, device=dev)
    ent_drop = out.ent_drop.clone()
    for i in range(E):
        has = accept & (i < n)
        is_cc = msg["ent_cc"][i] == 1
        dropped = has & is_cc & (st.pending_cc == 1)
        ent_drop[slot_i, i] = _w(dropped, 1, ent_drop[slot_i, i])
        put = has & ~dropped
        st = st._replace(pending_cc=_w(put & is_cc, 1, st.pending_cc))
        st, out = _append_one(st, out, put, is_cc.to(I32))
        appended_any = appended_any | put
    out = out._replace(ent_drop=ent_drop)
    single = (_num_voters(st) == 1) & _self_is_voter(st)
    st, out, _ = _try_commit(st, out, appended_any & single)
    st, out = _broadcast_replicate(st, out, appended_any, E)
    # host bookkeeping: where did this slot's entries land?
    sb = torch.where(
        accept,
        base,
        _w(drop_all, SLOT_DROPPED, out.slot_base[slot_i]),
    )
    stm = torch.where(accept, st.term, out.slot_term[slot_i])
    # follower: forward to the leader; candidate/no-leader: drop
    foll = mask & (
        (st.role == ROLE_FOLLOWER)
        | (st.role == ROLE_NON_VOTING)
        | (st.role == ROLE_WITNESS)
    )
    fwd = foll & (st.leader_id != 0)
    out = _emit(
        out,
        fwd,
        mtype=MT_PROPOSE,
        to=st.leader_id,
        term=st.term,
        n_entries=n,
        src_slot=slot_i,
    )
    sb = _w(fwd, SLOT_FORWARDED, sb)
    dropped_f = (foll & (st.leader_id == 0)) | (
        mask & ((st.role == ROLE_CANDIDATE) | (st.role == ROLE_PRE_CANDIDATE))
    )
    sb = _w(dropped_f, SLOT_DROPPED, sb)
    slot_base = out.slot_base.clone()
    slot_term = out.slot_term.clone()
    slot_base[slot_i] = sb
    slot_term[slot_i] = stm
    return st, out._replace(slot_base=slot_base, slot_term=slot_term)


# ---------------------------------------------------------------------------
# the per-slot dispatcher (oracle: Raft.handle + _step)
# ---------------------------------------------------------------------------
def _is_hot(mt):
    return torch.isin(mt, torch.tensor(HOT_TYPES, dtype=mt.dtype,
                                       device=mt.device))


def _gate(pred, fn, st, out):
    """Run a handler block only when some row needs it (or always under
    the _FORCE_GATES test hook)."""
    if _FORCE_GATES or bool(pred):
        return fn(st, out)
    return st, out


def _process_slot(st, out, msg, slot_i, E):
    """One inbox slot for every row (internal layout; msg fields [G],
    ``ent_term``/``ent_cc`` [E, G])."""
    G = _G(st)
    mask = (msg["mtype"] != 0) & (out.escalate == 0)
    mt = msg["mtype"]
    hot = _is_hot(mt)
    out = _esc(out, mask & ~hot, ESC_COLD)
    mask = mask & hot

    # the types some masked row carries: one readback for every gate
    present = set(mt[mask].tolist())

    def _has(*types):
        return not present.isdisjoint(types)

    st, out = _gate(
        _has(MT_TICK),
        lambda s, o: _tick(
            s, o, mask & (mt == MT_TICK), E, msg["hint"], msg["hint_high"],
            n=torch.clamp(msg["log_index"], min=1),
        ),
        st, out,
    )
    rest = mask & (mt != MT_TICK)

    def _non_tick(st, out):
        st, out, passed = _on_message_term(st, out, msg, rest)

        def _votes(st, out):
            st, out = _gate(
                _has(MT_ELECTION),
                lambda s, o: _handle_election(
                    s, o, passed & (mt == MT_ELECTION), msg["hint"], E
                ),
                st, out,
            )
            st, out = _gate(
                _has(MT_REQUEST_VOTE),
                lambda s, o: _handle_request_vote(
                    s, o, msg, passed & (mt == MT_REQUEST_VOTE)
                ),
                st, out,
            )
            st, out = _gate(
                _has(MT_REQUEST_PREVOTE),
                lambda s, o: _handle_request_prevote(
                    s, o, msg, passed & (mt == MT_REQUEST_PREVOTE)
                ),
                st, out,
            )
            return st, out

        st, out = _gate(
            _has(MT_ELECTION, MT_REQUEST_VOTE, MT_REQUEST_PREVOTE),
            _votes, st, out,
        )
        role_routed = passed & ~(
            (mt == MT_ELECTION)
            | (mt == MT_REQUEST_VOTE)
            | (mt == MT_REQUEST_PREVOTE)
        )

        def _prop_read(st, out):
            st, out = _gate(
                _has(MT_PROPOSE),
                lambda s, o: _handle_propose(
                    s, o, msg, role_routed & (mt == MT_PROPOSE), slot_i, E
                ),
                st, out,
            )
            st, out = _gate(
                _has(MT_READ_INDEX),
                lambda s, o: (s, _handle_read_index(
                    s, o, msg, role_routed & (mt == MT_READ_INDEX)
                )),
                st, out,
            )
            return st, out

        st, out = _gate(_has(MT_PROPOSE, MT_READ_INDEX), _prop_read, st, out)

        def _rare(st, out):
            lead = role_routed & (st.role == ROLE_LEADER)
            st = _check_quorum(st, lead & (mt == MT_CHECK_QUORUM))
            st = _handle_unreachable(st, msg, lead & (mt == MT_UNREACHABLE))
            st = _handle_snapshot_status(
                st,
                msg,
                lead
                & ((mt == MT_SNAPSHOT_STATUS) | (mt == MT_SNAPSHOT_RECEIVED)),
            )
            return st, out

        st, out = _gate(
            _has(MT_CHECK_QUORUM, MT_UNREACHABLE, MT_SNAPSHOT_STATUS,
                 MT_SNAPSHOT_RECEIVED),
            _rare, st, out,
        )

        def _lead_resps(st, out):
            lead = role_routed & (st.role == ROLE_LEADER)
            st, out = _gate(
                _has(MT_REPLICATE_RESP),
                lambda s, o: _handle_replicate_resp(
                    s, o, msg, lead & (mt == MT_REPLICATE_RESP), E
                ),
                st, out,
            )
            st, out = _gate(
                _has(MT_HEARTBEAT_RESP),
                lambda s, o: _handle_heartbeat_resp(
                    s, o, msg, lead & (mt == MT_HEARTBEAT_RESP), E
                ),
                st, out,
            )
            return st, out

        st, out = _gate(
            _has(MT_REPLICATE_RESP, MT_HEARTBEAT_RESP), _lead_resps, st, out
        )

        def _cand(st, out):
            cand = role_routed & (
                (st.role == ROLE_CANDIDATE) | (st.role == ROLE_PRE_CANDIDATE)
            )
            # every mask below is a subset of cand
            return _gate(cand.any(), lambda s, o: _cand_rows(s, o, cand),
                         st, out)

        def _cand_rows(st, out, cand):
            # REPLICATE / HEARTBEAT at our term from a legitimate leader
            from_leader = cand & ((mt == MT_REPLICATE) | (mt == MT_HEARTBEAT))
            st = _become_follower(st, from_leader, st.term, msg["from_id"])
            # vote responses
            vr = cand & (mt == MT_REQUEST_VOTE_RESP) & (
                st.role == ROLE_CANDIDATE
            )
            vote_val = torch.where(msg["reject"] == 1, 2, 1).to(I32)
            slot, found = _slot_of(st, msg["from_id"])
            st = st._replace(
                granted=_set_col(st.granted, slot, vr & found, vote_val)
            )
            win = vr & _vote_quorum(st)
            st, out = _become_leader(st, out, win, E)
            st, out = _broadcast_replicate(st, out, win, E)
            lose = vr & ~win & _vote_rejected(st)
            st = _become_follower(st, lose, st.term, 0)
            pv = cand & (mt == MT_REQUEST_PREVOTE_RESP) & (
                st.role == ROLE_PRE_CANDIDATE
            )
            slot2, found2 = _slot_of(st, msg["from_id"])
            st = st._replace(
                granted=_set_col(st.granted, slot2, pv & found2, vote_val)
            )
            pv_win = pv & _vote_quorum(st)
            no = torch.zeros((G,), dtype=torch.bool, device=mask.device)
            st, out = _campaign(st, out, pv_win, no, no, E)
            pv_lose = pv & ~pv_win & _vote_rejected(st)
            st = _become_follower(st, pv_lose, st.term, 0)
            return st, out

        st, out = _gate(
            _has(MT_REQUEST_VOTE_RESP, MT_REQUEST_PREVOTE_RESP,
                 MT_REPLICATE, MT_HEARTBEAT),
            _cand, st, out,
        )

        def _foll(st, out):
            # follower-ish roles (+ the just-demoted candidates)
            foll = role_routed & (
                (st.role == ROLE_FOLLOWER)
                | (st.role == ROLE_NON_VOTING)
                | (st.role == ROLE_WITNESS)
            )
            lmsg = foll & ((mt == MT_REPLICATE) | (mt == MT_HEARTBEAT))
            st = st._replace(
                election_tick=_w(lmsg, 0, st.election_tick),
                leader_id=_w(lmsg, msg["from_id"], st.leader_id),
            )
            st, out = _gate(
                _has(MT_REPLICATE),
                lambda s, o: _handle_replicate(
                    s, o, msg, lmsg & (mt == MT_REPLICATE)
                ),
                st, out,
            )
            st, out = _gate(
                _has(MT_HEARTBEAT),
                lambda s, o: _handle_heartbeat(
                    s, o, msg, lmsg & (mt == MT_HEARTBEAT)
                ),
                st, out,
            )

            def _timeout_now(st, out):
                tn = (
                    foll
                    & (mt == MT_TIMEOUT_NOW)
                    & (st.role == ROLE_FOLLOWER)
                    & _self_is_voter(st)
                )
                no = torch.zeros((G,), dtype=torch.bool, device=mask.device)
                return _campaign(st, out, tn, no, ~no, E)

            return _gate(_has(MT_TIMEOUT_NOW), _timeout_now, st, out)

        st, out = _gate(
            _has(MT_REPLICATE, MT_HEARTBEAT, MT_TIMEOUT_NOW), _foll, st, out
        )
        return st, out

    return _gate(rest.any(), _non_tick, st, out)


def _permute0(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """a[order[j, g], ..., g] — per-row permutation along axis 0; ``a``
    is [M, G] or [M, E, G], ``order`` [M, G]."""
    if a.dim() == 2:
        return a.gather(0, order)
    return a.gather(0, order[:, None, :].expand(-1, a.shape[1], -1))


def step_internal(
    state: DeviceState, cin: Inbox, out_capacity: int
) -> Tuple[DeviceState, DeviceOut]:
    """The step over INTERNAL-layout operands (oracle of ``_step_impl``):
    occupied inbox slots are stably compacted to the front of each row,
    only as many slot passes run as the busiest row needs, and the
    per-slot outputs map back to caller coordinates afterwards."""
    G = _G(state)
    P = _P(state)
    M = cin.mtype.shape[0]
    E = cin.ent_term.shape[1]
    dev = state.term.device
    out = _make_out_internal(G, P, M, E, out_capacity, dev)
    occ = cin.mtype != 0  # [M, G]
    # where the occupied slots already lead every row the stable sort is
    # the identity, and so are both permutations and the translation
    packed = not bool((occ[1:] & ~occ[:-1]).any())
    if not packed:
        order = torch.argsort(
            (~occ).to(torch.int8), dim=0, stable=True
        )  # int64 [M, G]
        cin = Inbox(*(_permute0(getattr(cin, f), order)
                      for f in Inbox._fields))
    n_occ = int(occ.sum(dim=0).max()) if G else 0
    for i in range(n_occ):
        msg = {f: getattr(cin, f)[i] for f in Inbox._fields}
        state, out = _process_slot(state, out, msg, i, E)
    if packed:
        return state, out
    inv = torch.argsort(order, dim=0, stable=True)
    # src_slot values index COMPACTED slots; translate through order
    src = out.buf[:, F_SRC_SLOT, :]  # [O, G]
    srcc = src.clamp(0, M - 1).long()
    src_orig = order.gather(0, srcc).to(I32)
    buf = out.buf.clone()
    buf[:, F_SRC_SLOT, :] = torch.where(src >= 0, src_orig, src)
    out = out._replace(
        buf=buf,
        slot_base=_permute0(out.slot_base, inv),
        slot_term=_permute0(out.slot_term, inv),
        ent_drop=_permute0(out.ent_drop, inv),
    )
    return state, out


def step(
    state: DeviceState, inbox: Inbox, out_capacity: int = 32
) -> Tuple[DeviceState, DeviceOut]:
    """Advance every row through its inbox: external ``[G, ...]`` layout
    in and out, the G-last internal layout inside."""
    st = convert.state_to_internal(state)
    cin = convert.inbox_to_internal(inbox)
    st, out = step_internal(st, cin, out_capacity)
    return convert.state_from_internal(st), convert.out_from_internal(out)
