"""Device-side tensor layouts for the raft step kernel (PyTorch port).

Port of ``dragonboat_tpu/ops/types.py``: the same constants and the same
struct-of-arrays layouts, as ``NamedTuple``s of int32 ``torch`` tensors
on an explicit device instead of ``jnp`` arrays.

A **row** is one (shard, replica) pair — exactly what one scalar ``Raft``
object models.  All protocol scalars are ``int32``.

Shape legend:
  G — rows (replicas hosted on this device)
  P — peer slots (max membership size; ragged 3/5/7 memberships are
      masked)
  W — in-window log-term ring size (power of two)
  M — inbox message slots per row per step
  E — max entries carried per REPLICATE / PROPOSE on the device path
  O — outbox message capacity per row per step
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..pb import MessageType
from ..raft.raft import RaftRole
from ..raft.remote import RemoteState

I32 = torch.int32

# ---------------------------------------------------------------------------
# role / remote-state / message-type constants (device-side mirrors)
# ---------------------------------------------------------------------------
ROLE_FOLLOWER = int(RaftRole.FOLLOWER)
ROLE_PRE_CANDIDATE = int(RaftRole.PRE_CANDIDATE)
ROLE_CANDIDATE = int(RaftRole.CANDIDATE)
ROLE_LEADER = int(RaftRole.LEADER)
ROLE_NON_VOTING = int(RaftRole.NON_VOTING)
ROLE_WITNESS = int(RaftRole.WITNESS)

RS_RETRY = int(RemoteState.RETRY)
RS_WAIT = int(RemoteState.WAIT)
RS_REPLICATE = int(RemoteState.REPLICATE)
RS_SNAPSHOT = int(RemoteState.SNAPSHOT)

# peer slot kinds
KIND_VOTER = 0
KIND_NON_VOTING = 1
KIND_WITNESS = 2

MT_NOOP = int(MessageType.NO_OP)
MT_TICK = int(MessageType.LOCAL_TICK)
MT_ELECTION = int(MessageType.ELECTION)
MT_PROPOSE = int(MessageType.PROPOSE)
MT_REPLICATE = int(MessageType.REPLICATE)
MT_REPLICATE_RESP = int(MessageType.REPLICATE_RESP)
MT_REQUEST_VOTE = int(MessageType.REQUEST_VOTE)
MT_REQUEST_VOTE_RESP = int(MessageType.REQUEST_VOTE_RESP)
MT_REQUEST_PREVOTE = int(MessageType.REQUEST_PREVOTE)
MT_REQUEST_PREVOTE_RESP = int(MessageType.REQUEST_PREVOTE_RESP)
MT_HEARTBEAT = int(MessageType.HEARTBEAT)
MT_HEARTBEAT_RESP = int(MessageType.HEARTBEAT_RESP)
MT_READ_INDEX = int(MessageType.READ_INDEX)
MT_READ_INDEX_RESP = int(MessageType.READ_INDEX_RESP)
MT_INSTALL_SNAPSHOT = int(MessageType.INSTALL_SNAPSHOT)
MT_SNAPSHOT_STATUS = int(MessageType.SNAPSHOT_STATUS)
MT_SNAPSHOT_RECEIVED = int(MessageType.SNAPSHOT_RECEIVED)
MT_UNREACHABLE = int(MessageType.UNREACHABLE)
MT_LEADER_TRANSFER = int(MessageType.LEADER_TRANSFER)
MT_TIMEOUT_NOW = int(MessageType.TIMEOUT_NOW)
MT_CHECK_QUORUM = int(MessageType.CHECK_QUORUM)

# the kernel's hot set; anything else in an inbox escalates the row
HOT_TYPES = (
    MT_TICK,
    MT_ELECTION,
    MT_PROPOSE,
    MT_READ_INDEX,
    MT_REPLICATE,
    MT_REPLICATE_RESP,
    MT_REQUEST_VOTE,
    MT_REQUEST_VOTE_RESP,
    MT_REQUEST_PREVOTE,
    MT_REQUEST_PREVOTE_RESP,
    MT_HEARTBEAT,
    MT_HEARTBEAT_RESP,
    MT_TIMEOUT_NOW,
    MT_CHECK_QUORUM,
    MT_UNREACHABLE,
    MT_SNAPSHOT_STATUS,
    MT_SNAPSHOT_RECEIVED,
)

# escalation reason bits (DeviceOut.escalate)
ESC_WINDOW = 1        # needed a log term outside the W-entry ring
ESC_OVERFLOW = 2      # outbox capacity exhausted mid-step
ESC_COLD = 4          # a cold message type reached the device inbox
ESC_INVARIANT = 8     # conflict below commit / malformed input

# slot_base sentinel values (per inbox PROPOSE slot)
SLOT_UNUSED = -3      # slot was not a PROPOSE / row escalated
SLOT_FORWARDED = -2   # follower forwarded the proposal to the leader
SLOT_DROPPED = -1     # proposal dropped (no leader / transfer in flight)

# per-row flag bits of the post-step flags-word readback (the ONLY
# full-width [G] readback a launch performs — see engine._summarize_flags).
# Defined HERE (not in engine.py) because three layers consume them:
# the device-side summarize program, the host merge stage, and the
# array-at-once host-plane machinery in ops/hostplane.py — one
# definition keeps the device readback and the vectorized host decode
# from ever disagreeing on a bit.
F_CHANGED, F_COUNT, F_APPEND, F_NEED_SS, F_ESC = 1, 2, 4, 8, 16
# leader row with a peer lane still behind its log: quiesce entry is
# blocked while set (the scalar remotes of a resident row are stale)
F_PEERS_BEHIND = 32
# CheckQuorum leader row (self a voter) whose CURRENT activity window
# already holds a quorum of active voter lanes: the device-plane lease
# evidence bit (ROADMAP 4b) — the host anchors the scalar remotes'
# last_resp_tick at the window start so gateway lease reads stay on
# device-hosted shards (ops/hostplane.LeaseLanes; docs/GATEWAY.md).
# Deliberately NOT in F_ANY_LIVE: it must ride the flags word for free
# without promoting a quiet leader into the values-readback set.
F_QUORUM_ACTIVE = 64
F_ANY_LIVE = F_CHANGED | F_COUNT | F_APPEND | F_NEED_SS

# per-row VALUES block layout (engine._gather_vals order) — the columns
# of the post-step values readback.  Defined HERE (like the F_* bits)
# because three layers consume them: the device-side gather program,
# both engines' merge tails, and the array-at-once update lanes in
# ops/hostplane.py (UpdateLanes stores the first UL_N columns per row,
# absolute frame) — one definition keeps the device readback, the host
# decode and the lane store from ever disagreeing on a column.
R_TERM, R_VOTE, R_COMMIT, R_LEADER, R_ROLE, R_LAST = range(6)
R_COUNT, R_APPEND_LO = 6, 7
R_BARRIER_IDX, R_BARRIER_TERM = 8, 9
N_VALS = 10
UL_N = 6  # update-lane words = the first 6 values columns

# per-row update effect bits (hostplane.plan_update_sync): what a
# generation's merged values changed RELATIVE TO THE LAST SYNC for one
# row — the vectorized replacement for the per-row "did anything I
# must act on happen" probes of the old merge loop.  U_STATE means the
# hard-state triple (term/vote/commit) moved and must persist;
# U_COMMIT that commit advanced (committed entries to hand to apply);
# U_ROLE / U_LEADER that the role / leader word moved (role resync,
# leader-change notification); U_LOST_LEAD that the row held LEADER at
# the last sync and no longer does (pending device reads must drop).
U_STATE, U_COMMIT, U_ROLE, U_LEADER, U_LOST_LEAD = 1, 2, 4, 8, 16


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


# outbox buffer field order (DeviceOut.buf[..., F_*])
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
N_FIELDS = 11


APPEND_LO_NONE = 2**31 - 1  # DeviceOut.append_lo sentinel: no append


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
# constructors
# ---------------------------------------------------------------------------
def _splitmix32_np(x: np.ndarray) -> np.ndarray:
    """Numpy mirror of kernel._splitmix32 — bit-identical uint32 math."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint32) + np.uint32(0x9E3779B9)
        z = z ^ (z >> np.uint32(16))
        z = z * np.uint32(0x85EBCA6B)
        z = z ^ (z >> np.uint32(13))
        z = z * np.uint32(0xC2B2AE35)
        z = z ^ (z >> np.uint32(16))
    return z


def make_state_np(
    G: int,
    P: int,
    W: int,
    *,
    shard_ids=None,
    replica_ids=None,
    peer_ids=None,
    peer_kinds=None,
    election_timeout: int = 10,
    heartbeat_timeout: int = 1,
    check_quorum: bool = False,
    pre_vote: bool = False,
) -> dict:
    """``make_state`` as a pure-NUMPY field dict (same values bit for
    bit, including the constructor timeout jitter).

    This exists for the host staging path: ``state_from_rafts`` packs
    scalar oracles on the host and never round-trips through the device
    (one host->device copy per field per upload batch, no readbacks).
    """
    if W & (W - 1):
        raise ValueError(f"W must be a power of two, got {W}")
    zg = np.zeros((G,), np.int32)
    zgp = np.zeros((G, P), np.int32)
    shard_ids = np.asarray(
        shard_ids if shard_ids is not None else np.arange(G), np.int32
    )
    replica_ids = np.asarray(
        replica_ids if replica_ids is not None else np.ones(G), np.int32
    )
    if peer_ids is None:
        peer_ids = np.zeros((G, P), np.int32)
        peer_ids[:, 0] = replica_ids
    peer_ids = np.asarray(peer_ids, np.int32)
    peer_kinds = np.asarray(
        peer_kinds if peer_kinds is not None else zgp, np.int32
    )
    self_slot = np.argmax(peer_ids == replica_ids[:, None], axis=1).astype(
        np.int32
    )
    valid = peer_ids != 0
    et = np.full((G,), election_timeout, np.int32)
    # match Raft.__init__: the constructor resets the randomized timeout
    # once (kernel.reset_timeout with seq 0 -> 1), in numpy
    seq = np.ones((G,), np.int32)
    h = _splitmix32_np(
        (shard_ids.astype(np.uint32) << np.uint32(24))
        ^ (replica_ids.astype(np.uint32) << np.uint32(8))
        ^ seq.astype(np.uint32)
    )
    rand_timeout = (et + (h % et.astype(np.uint32)).astype(np.int32)).astype(
        np.int32
    )
    return dict(
        shard_id=shard_ids,
        replica_id=replica_ids,
        self_slot=self_slot,
        election_timeout=et,
        heartbeat_timeout=np.full((G,), heartbeat_timeout, np.int32),
        check_quorum=np.full((G,), int(check_quorum), np.int32),
        pre_vote=np.full((G,), int(pre_vote), np.int32),
        term=zg.copy(),
        vote=zg.copy(),
        leader_id=zg.copy(),
        role=_initial_roles(replica_ids, peer_ids, peer_kinds),
        committed=zg.copy(),
        last_index=zg.copy(),
        first_index=np.ones((G,), np.int32),
        base_term=zg.copy(),
        election_tick=zg.copy(),
        heartbeat_tick=zg.copy(),
        rand_timeout=rand_timeout,
        timeout_seq=seq,
        pending_cc=zg.copy(),
        transfer_target=zg.copy(),
        peer_id=peer_ids,
        peer_kind=np.where(valid, peer_kinds, 0).astype(np.int32),
        match=zgp.copy(),
        next_idx=np.where(valid, 1, 0).astype(np.int32),
        rstate=zgp.copy(),
        snap_index=zgp.copy(),
        active=zgp.copy(),
        granted=zgp.copy(),
        ring_term=np.zeros((G, W), np.int32),
        ring_cc=np.zeros((G, W), np.int32),
    )


def make_state(
    G: int,
    P: int,
    W: int,
    *,
    device,
    **kw,
) -> DeviceState:
    """Fresh state for G rows on ``device``.

    ``peer_ids`` is [G, P] with 0 marking empty slots; ``replica_ids`` must
    appear in their own row's slots.  Fresh rows start as followers at
    term 0 with an empty log, exactly like ``Raft.__init__``.
    """
    cols = make_state_np(G, P, W, **kw)
    return DeviceState(
        **{k: torch.from_numpy(v).to(device) for k, v in cols.items()}
    )


def _initial_roles(replica_ids, peer_ids, peer_kinds):
    G = replica_ids.shape[0]
    roles = np.full((G,), ROLE_FOLLOWER, np.int32)
    self_mask = peer_ids == replica_ids[:, None]
    kind = np.where(self_mask, peer_kinds, -1).max(axis=1)
    roles[kind == KIND_NON_VOTING] = ROLE_NON_VOTING
    roles[kind == KIND_WITNESS] = ROLE_WITNESS
    return roles


def make_inbox(G: int, M: int, E: int, *, device) -> Inbox:
    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=device)

    return Inbox(
        mtype=z(G, M),
        from_id=z(G, M),
        term=z(G, M),
        log_term=z(G, M),
        log_index=z(G, M),
        commit=z(G, M),
        reject=z(G, M),
        hint=z(G, M),
        hint_high=z(G, M),
        n_entries=z(G, M),
        ent_term=z(G, M, E),
        ent_cc=z(G, M, E),
    )


def make_out(G: int, P: int, M: int, E: int, O: int, *, device) -> DeviceOut:
    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=device)

    return DeviceOut(
        buf=full((G, O, N_FIELDS), 0),
        count=full((G,), 0),
        escalate=full((G,), 0),
        need_snapshot=full((G, P), 0),
        slot_base=full((G, M), SLOT_UNUSED),
        slot_term=full((G, M), 0),
        ent_drop=full((G, M, E), 0),
        append_lo=full((G,), APPEND_LO_NONE),
        barrier_idx=full((G,), -1),
        barrier_term=full((G,), 0),
    )
