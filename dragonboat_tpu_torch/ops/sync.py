"""Oracle <-> device-row conversion and message staging (PyTorch port).

Port of ``dragonboat_tpu/ops/sync.py``: the same numpy staging, producing
torch tensors (on the CPU; the engine moves them to its device) where
the reference produced ``jnp`` arrays.

Three jobs:

  1. ``state_from_rafts`` — pack scalar ``Raft`` oracles into a
     ``DeviceState`` (parity tests, engine bootstrap, escalation return).
  2. ``raft_to_row`` / ``assert_row_matches`` — read a row back out for
     differential comparison or host-side replay.
  3. ``encode_inbox`` / ``decode_out`` — Message lists <-> tensor batches.

The slot layout contract: peer slots hold the union of voters,
non-votings and witnesses sorted by replica id; empty slots are 0.  The
same ordering governs the oracle's sorted broadcast loops, so device and
host iterate peers identically.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..pb import Message, MessageType
from ..raft.raft import Raft, RaftRole
from .types import (
    DeviceOut,
    DeviceState,
    F_COMMIT,
    F_HINT,
    F_HINT_HIGH,
    F_LOG_INDEX,
    F_LOG_TERM,
    F_MTYPE,
    F_N_ENTRIES,
    F_REJECT,
    F_SRC_SLOT,
    F_TERM,
    F_TO,
    KIND_NON_VOTING,
    KIND_VOTER,
    KIND_WITNESS,
    Inbox,
    make_state_np,
)

import torch


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def peer_layout(raft: Raft) -> List[Tuple[int, int]]:
    """[(replica_id, kind)] sorted by id — the canonical slot order."""
    out = []
    for pid in raft.remotes:
        out.append((pid, KIND_VOTER))
    for pid in raft.non_votings:
        out.append((pid, KIND_NON_VOTING))
    for pid in raft.witnesses:
        out.append((pid, KIND_WITNESS))
    return sorted(out)


def state_from_rafts(
    rafts: Sequence[Raft], P: int, W: int,
    bases: Optional[Sequence[int]] = None,
    pad_to: int = 0,
) -> DeviceState:
    """Pack oracles into a DeviceState, copying the full volatile state
    (not just a fresh boot) so escalated rows can return to the device.

    ``bases``: optional per-row int64 index base subtracted from every
    log-index field (committed/last/first/match/next/snap) so rows whose
    absolute indexes exceed int32 stay device-steppable — the engine's
    64-bit story (the host WAL is 64-bit throughout; the device works in
    a rebased window).  Each base MUST be a multiple of W so the ring
    slot of an index is invariant under the shift ((abs-base) % W ==
    abs % W), and must not exceed any live index quantity of its row.

    ``pad_to``: pad the row axis to this length by repeating the last
    row, in numpy, so the upload is one host->device copy per field.
    """
    G = len(rafts)
    # pure-NUMPY staging end to end: make_state_np never touches the
    # device, so packing costs no device->host readbacks
    base_cols = make_state_np(
        G,
        P,
        W,
        shard_ids=[r.shard_id for r in rafts],
        replica_ids=[r.replica_id for r in rafts],
        peer_ids=_peer_ids(rafts, P),
        peer_kinds=_peer_kinds(rafts, P),
    )
    # int64 staging: absolute indexes may exceed int32 before the shift
    cols: Dict[str, np.ndarray] = {
        k: v.astype(np.int64) for k, v in base_cols.items()
    }
    for g, r in enumerate(rafts):
        _fill_row(cols, g, r, P, W)
        if bases is not None and bases[g]:
            b = int(bases[g])
            assert b % W == 0, f"row {g}: base {b} not a multiple of W"
            for k in ("committed", "last_index", "first_index"):
                cols[k][g] -= b
            for k in ("match", "next_idx", "snap_index"):
                row = cols[k][g]
                row[row > 0] -= b
                # stale lanes below the base (a non-leader's boot-time
                # next=1 etc.) clamp to the 0 sentinel: they are dead
                # state that the next election resets anyway, and
                # negative lanes would wrap int32
                row[row < 0] = 0
    out: Dict[str, np.ndarray] = {}
    for k, v in cols.items():
        if (v > 2**31 - 1).any() or (v < -(2**31)).any():
            raise OverflowError(
                f"state field {k} exceeds int32 after rebase"
            )
        v = v.astype(np.int32)
        if pad_to > v.shape[0]:
            v = np.concatenate(
                [v, np.repeat(v[-1:], pad_to - v.shape[0], axis=0)]
            )
        out[k] = v
    return DeviceState(**{k: _t(v) for k, v in out.items()})


def _peer_ids(rafts, P):
    G = len(rafts)
    out = np.zeros((G, P), np.int32)
    for g, r in enumerate(rafts):
        lay = peer_layout(r)
        if len(lay) > P:
            raise ValueError(f"row {g}: {len(lay)} peers > P={P}")
        for s, (pid, _) in enumerate(lay):
            out[g, s] = pid
    return out


def _peer_kinds(rafts, P):
    G = len(rafts)
    out = np.zeros((G, P), np.int32)
    for g, r in enumerate(rafts):
        for s, (_, kind) in enumerate(peer_layout(r)):
            out[g, s] = kind
    return out


def _fill_row(cols, g, r: Raft, P, W):
    cols["election_timeout"][g] = r.election_timeout
    cols["heartbeat_timeout"][g] = r.heartbeat_timeout
    cols["check_quorum"][g] = int(r.check_quorum)
    cols["pre_vote"][g] = int(r.pre_vote)
    cols["term"][g] = r.term
    cols["vote"][g] = r.vote
    cols["leader_id"][g] = r.leader_id
    cols["role"][g] = int(r.role)
    cols["committed"][g] = r.log.committed
    last = r.log.last_index()
    first = r.log.first_index()
    cols["last_index"][g] = last
    cols["first_index"][g] = first
    try:
        cols["base_term"][g] = r.log.term(first - 1) if first > 1 else 0
    except Exception:
        cols["base_term"][g] = 0
    cols["election_tick"][g] = r.election_tick
    cols["heartbeat_tick"][g] = r.heartbeat_tick
    cols["rand_timeout"][g] = r.randomized_election_timeout
    cols["timeout_seq"][g] = r._timeout_seq
    cols["pending_cc"][g] = int(r.pending_config_change)
    cols["transfer_target"][g] = r.leader_transfer_target
    for s, (pid, _) in enumerate(peer_layout(r)):
        rm = r.get_remote(pid)
        cols["match"][g, s] = rm.match
        cols["next_idx"][g, s] = rm.next
        cols["rstate"][g, s] = int(rm.state)
        cols["snap_index"][g, s] = rm.snapshot_index
        cols["active"][g, s] = int(rm.active)
        if pid in r.votes:
            cols["granted"][g, s] = 1 if r.votes[pid] else 2
    win_lo = max(first, last - W + 1)
    for idx in range(win_lo, last + 1):
        t = r.log.term(idx)
        cols["ring_term"][g, idx % W] = t
        ents = r.log._get_entries(idx, idx + 1, 2**62)
        cols["ring_cc"][g, idx % W] = int(bool(ents and ents[0].is_config_change()))


ROW_SCALARS = (
    "term",
    "vote",
    "leader_id",
    "role",
    "committed",
    "last_index",
    "election_tick",
    "heartbeat_tick",
    "rand_timeout",
    "timeout_seq",
    "pending_cc",
    "transfer_target",
)
ROW_PEER = ("match", "next_idx", "rstate", "snap_index", "active", "granted")


def raft_to_row(r: Raft, P: int, W: int) -> dict:
    """The oracle's state in row form (for comparisons)."""
    cols = {
        k: np.zeros((1,), np.int32)
        for k in ROW_SCALARS
        + ("election_timeout", "heartbeat_timeout", "check_quorum", "pre_vote",
           "base_term", "first_index")
    }
    for k in ROW_PEER:
        cols[k] = np.zeros((1, P), np.int32)
    cols["ring_term"] = np.zeros((1, W), np.int32)
    cols["ring_cc"] = np.zeros((1, W), np.int32)
    _fill_row(cols, 0, r, P, W)
    return {k: v[0] for k, v in cols.items()}


def row_diff(state: DeviceState, g: int, r: Raft) -> List[str]:
    """Human-readable field mismatches between device row g and oracle."""
    want = raft_to_row(r, state.P, state.W)
    errs = []
    for k in ROW_SCALARS:
        got = int(_np(getattr(state, k))[g])
        if got != int(want[k]):
            errs.append(f"{k}: device={got} oracle={int(want[k])}")
    for k in ROW_PEER:
        got = _np(getattr(state, k))[g]
        if not np.array_equal(got, want[k]):
            errs.append(f"{k}: device={got.tolist()} oracle={want[k].tolist()}")
    # ring: compare only the in-window slice
    last = r.log.last_index()
    first = r.log.first_index()
    win_lo = max(first, last - state.W + 1)
    ring_d = _np(state.ring_term)[g]
    ring_cc_d = _np(state.ring_cc)[g]
    for idx in range(win_lo, last + 1):
        if ring_d[idx % state.W] != r.log.term(idx):
            errs.append(
                f"ring_term[{idx}]: device={ring_d[idx % state.W]} "
                f"oracle={r.log.term(idx)}"
            )
        if ring_cc_d[idx % state.W] != want["ring_cc"][idx % state.W]:
            errs.append(f"ring_cc[{idx}] mismatch")
    return errs


# ---------------------------------------------------------------------------
# inbox / outbox staging
# ---------------------------------------------------------------------------
INBOX_FIELDS = (
    "mtype",
    "from_id",
    "term",
    "log_term",
    "log_index",
    "commit",
    "reject",
    "hint",
    "hint_high",
    "n_entries",
)


def encode_inbox(
    batches: Sequence[Sequence[Message]], M: int, E: int
) -> Tuple[Inbox, List[int]]:
    """Pack per-row ordered Message lists into an Inbox.

    Returns (inbox, overflow_rows): rows whose batch exceeds M slots or
    whose REPLICATE carries more than E entries must be host-stepped.
    """
    G = len(batches)
    cols = {k: np.zeros((G, M), np.int32) for k in INBOX_FIELDS}
    ent_term = np.zeros((G, M, E), np.int32)
    ent_cc = np.zeros((G, M, E), np.int32)
    overflow: List[int] = []
    for g, msgs in enumerate(batches):
        if len(msgs) > M:
            overflow.append(g)
            continue
        for i, m in enumerate(msgs):
            if len(m.entries) > E:
                overflow.append(g)
                break
            cols["mtype"][g, i] = int(m.type)
            cols["from_id"][g, i] = m.from_
            cols["term"][g, i] = m.term
            cols["log_term"][g, i] = m.log_term
            cols["log_index"][g, i] = m.log_index
            cols["commit"][g, i] = m.commit
            cols["reject"][g, i] = int(m.reject)
            cols["hint"][g, i] = m.hint
            cols["hint_high"][g, i] = m.hint_high
            cols["n_entries"][g, i] = len(m.entries)
            for j, e in enumerate(m.entries):
                ent_term[g, i, j] = e.term
                ent_cc[g, i, j] = int(e.is_config_change())
    return (
        Inbox(
            **{k: _t(v) for k, v in cols.items()},
            ent_term=_t(ent_term),
            ent_cc=_t(ent_cc),
        ),
        overflow,
    )


def decode_out_row(
    out_np: dict, g: int, shard_id: int, replica_id: int
) -> List[Tuple[Message, int, int]]:
    """Outbox row -> [(message, n_entries, src_slot)].

    Entry payloads are attached by the host from its payload log
    (REPLICATE: indexes [log_index+1, log_index+n]; forwarded PROPOSE:
    the staged entries of inbox slot ``src_slot``)."""
    n = int(out_np["count"][g])
    buf = out_np["buf"][g]
    msgs = []
    for k in range(n):
        rec = buf[k]
        msgs.append(
            (
                Message(
                    type=MessageType(int(rec[F_MTYPE])),
                    to=int(rec[F_TO]),
                    from_=replica_id,
                    shard_id=shard_id,
                    term=int(rec[F_TERM]),
                    log_term=int(rec[F_LOG_TERM]),
                    log_index=int(rec[F_LOG_INDEX]),
                    commit=int(rec[F_COMMIT]),
                    reject=bool(rec[F_REJECT]),
                    hint=int(rec[F_HINT]),
                    hint_high=int(rec[F_HINT_HIGH]),
                ),
                int(rec[F_N_ENTRIES]),
                int(rec[F_SRC_SLOT]),
            )
        )
    return msgs


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def out_to_numpy(out: DeviceOut) -> dict:
    return {k: _np(getattr(out, k)) for k in out._fields}
