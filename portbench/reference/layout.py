"""Row layouts and protocol constants of the frozen reference.

The field lists and the integer codes are those of the system under test
(its step kernel's state, inbox and outbox as struct-of-arrays int32
tensors, one row per (shard, replica)), written out here as plain values
so that the reference depends on nothing it checks.  ``Inbox`` slot order
is processing order; ``DeviceOut.buf`` is ``[G, O, N_FIELDS]``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

I32 = torch.int32

ROLE_FOLLOWER = 0
ROLE_PRE_CANDIDATE = 1
ROLE_CANDIDATE = 2
ROLE_LEADER = 3
ROLE_NON_VOTING = 4
ROLE_WITNESS = 5

RS_RETRY = 0
RS_WAIT = 1
RS_REPLICATE = 2
RS_SNAPSHOT = 3

KIND_VOTER = 0
KIND_NON_VOTING = 1
KIND_WITNESS = 2

MT_NOOP = 0
MT_TICK = 1
MT_ELECTION = 2
MT_PROPOSE = 3
MT_REPLICATE = 4
MT_REPLICATE_RESP = 5
MT_REQUEST_VOTE = 6
MT_REQUEST_VOTE_RESP = 7
MT_REQUEST_PREVOTE = 8
MT_REQUEST_PREVOTE_RESP = 9
MT_HEARTBEAT = 10
MT_HEARTBEAT_RESP = 11
MT_READ_INDEX = 12
MT_READ_INDEX_RESP = 13
MT_INSTALL_SNAPSHOT = 14
MT_SNAPSHOT_STATUS = 15
MT_SNAPSHOT_RECEIVED = 16
MT_UNREACHABLE = 17
MT_LEADER_TRANSFER = 18
MT_TIMEOUT_NOW = 19
MT_CHECK_QUORUM = 21

ESC_WINDOW = 1
ESC_OVERFLOW = 2
ESC_COLD = 4
ESC_INVARIANT = 8

SLOT_UNUSED = -3
SLOT_FORWARDED = -2
SLOT_DROPPED = -1

F_MTYPE = 0
F_TO = 1
F_TERM = 2
F_LOG_TERM = 3
F_LOG_INDEX = 4
F_COMMIT = 5
F_REJECT = 6
F_HINT = 7
F_HINT_HIGH = 8
F_N_ENTRIES = 9
F_SRC_SLOT = 10

APPEND_LO_NONE = 2147483647

N_FIELDS = 11

# the step's hot set; any other type in an inbox escalates the row
HOT_TYPES = (MT_TICK, MT_ELECTION, MT_PROPOSE, MT_READ_INDEX, MT_REPLICATE, MT_REPLICATE_RESP, MT_REQUEST_VOTE, MT_REQUEST_VOTE_RESP, MT_REQUEST_PREVOTE, MT_REQUEST_PREVOTE_RESP, MT_HEARTBEAT, MT_HEARTBEAT_RESP, MT_TIMEOUT_NOW, MT_CHECK_QUORUM, MT_UNREACHABLE, MT_SNAPSHOT_STATUS, MT_SNAPSHOT_RECEIVED)


class DeviceState(NamedTuple):
    """SoA mirror of one scalar ``Raft`` per row.

    The host keeps the authoritative payload log (entries with commands);
    the device ring holds only (term, is-config-change) per in-window
    index — everything ``raft.Step`` needs for log matching, vote
    up-to-date checks and the current-term commit gate.
    """

    # -- static identity / config, [G] ---------------------------------
    shard_id: torch.Tensor
    replica_id: torch.Tensor
    self_slot: torch.Tensor          # index into peer axis for this replica
    election_timeout: torch.Tensor
    heartbeat_timeout: torch.Tensor
    check_quorum: torch.Tensor       # 0/1
    pre_vote: torch.Tensor           # 0/1
    # -- volatile protocol state, [G] -----------------------------------
    term: torch.Tensor
    vote: torch.Tensor
    leader_id: torch.Tensor
    role: torch.Tensor
    committed: torch.Tensor
    last_index: torch.Tensor
    first_index: torch.Tensor        # lowest index whose term is resolvable
    base_term: torch.Tensor          # term(first_index - 1)
    election_tick: torch.Tensor
    heartbeat_tick: torch.Tensor
    rand_timeout: torch.Tensor
    timeout_seq: torch.Tensor
    pending_cc: torch.Tensor         # 0/1: uncommitted config change in log
    transfer_target: torch.Tensor    # 0 = none
    # -- per-peer slots, [G, P] -----------------------------------------
    peer_id: torch.Tensor            # 0 = empty slot
    peer_kind: torch.Tensor          # KIND_*
    match: torch.Tensor
    next_idx: torch.Tensor
    rstate: torch.Tensor             # RS_*
    snap_index: torch.Tensor
    active: torch.Tensor             # 0/1, CheckQuorum liveness
    granted: torch.Tensor            # votes: 0 unknown / 1 granted / 2 rejected
    # -- in-window log ring, [G, W] -------------------------------------
    ring_term: torch.Tensor
    ring_cc: torch.Tensor            # 0/1 config-change bit per entry

    @property
    def G(self) -> int:
        return self.term.shape[0]

    @property
    def P(self) -> int:
        return self.peer_id.shape[1]

    @property
    def W(self) -> int:
        return self.ring_term.shape[1]


class Inbox(NamedTuple):
    """One step's ordered per-row message batch.

    Slot order is the processing order (the scalar oracle processes the
    same messages in the same order — that is the parity contract).
    ``ent_term``/``ent_cc`` carry per-entry metadata for REPLICATE
    (terms) and PROPOSE (config-change bits) slots.
    """

    mtype: torch.Tensor       # [G, M]
    from_id: torch.Tensor
    term: torch.Tensor
    log_term: torch.Tensor
    log_index: torch.Tensor
    commit: torch.Tensor
    reject: torch.Tensor      # 0/1
    hint: torch.Tensor
    hint_high: torch.Tensor
    n_entries: torch.Tensor
    ent_term: torch.Tensor    # [G, M, E]
    ent_cc: torch.Tensor      # [G, M, E]

    @property
    def M(self) -> int:
        return self.mtype.shape[1]

    @property
    def E(self) -> int:
        return self.ent_term.shape[2]


class DeviceOut(NamedTuple):
    """Step outputs: emitted messages + host-coordination side channels."""

    buf: torch.Tensor            # [G, O, N_FIELDS]
    count: torch.Tensor          # [G] messages emitted
    escalate: torch.Tensor       # [G] ESC_* bitmask; host replays the row
    need_snapshot: torch.Tensor  # [G, P] 0/1: peer slot needs InstallSnapshot
    slot_base: torch.Tensor      # [G, M] PROPOSE: pre-append last_index or SLOT_*
    slot_term: torch.Tensor      # [G, M] PROPOSE: term entries were stamped with
    ent_drop: torch.Tensor       # [G, M, E] 0/1: proposal entry dropped (cc gate)
    append_lo: torch.Tensor      # [G] lowest log index ring-written this step
                                # (APPEND_LO_NONE if nothing appended); with
                                # state'.last_index this bounds the host's
                                # entries_to_save reconstruction
    barrier_idx: torch.Tensor    # [G] index of the become-leader noop barrier
                                # self-appended THIS step (-1 if none): the
                                # only append with no staged/wire payload, so
                                # hosts reconstructing routed appends can
                                # stamp it empty even if the row stepped down
                                # later in the same step
    barrier_term: torch.Tensor   # [G] term that barrier was appended at

    @property
    def O(self) -> int:
        return self.buf.shape[1]


# ---------------------------------------------------------------------------
# internal (G-last) layout: peer and ring arrays [P, G] / [W, G], inbox
# [M, G] / [M, E, G], out.buf [O, N_FIELDS, G]
# ---------------------------------------------------------------------------
PEER_FIELDS = ("peer_id", "peer_kind", "match", "next_idx", "rstate",
               "snap_index", "active", "granted")
RING_FIELDS = ("ring_term", "ring_cc")


def state_to_internal(st: DeviceState) -> DeviceState:
    """[G, P] -> [P, G], [G, W] -> [W, G]; its own inverse."""
    return st._replace(**{f: getattr(st, f).t().contiguous()
                          for f in PEER_FIELDS + RING_FIELDS})


state_from_internal = state_to_internal


def inbox_to_internal(ib: Inbox) -> Inbox:
    return Inbox(*(t.permute(1, 2, 0).contiguous() if t.dim() == 3
                   else t.t().contiguous() for t in ib))


def out_from_internal(out: DeviceOut) -> DeviceOut:
    return out._replace(
        buf=out.buf.permute(2, 0, 1).contiguous(),
        need_snapshot=out.need_snapshot.t().contiguous(),
        slot_base=out.slot_base.t().contiguous(),
        slot_term=out.slot_term.t().contiguous(),
        ent_drop=out.ent_drop.permute(2, 0, 1).contiguous(),
    )


def merge_escalated(escalate: torch.Tensor, old: Sequence[torch.Tensor],
                    new: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """In place: per field, new[escalate != 0] = old[escalate != 0]."""
    esc = escalate != 0
    for a, b in zip(old, new):
        b[esc] = a[esc]
    return list(new)
