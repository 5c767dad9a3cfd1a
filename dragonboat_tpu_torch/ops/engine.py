"""TorchStepEngine: the device-backed step engine of the PyTorch port.

Port of ``dragonboat_tpu/ops/engine.py`` ``VectorStepEngine``.  Every
``jax.jit`` program of the launch becomes its port: the raft step
(``ops/kernel.py``, CUDA ``raft_step``), the flag word (CUDA
``summarize_flags``), the readback packer (CUDA ``gather_pack``) and
the row movers (CUDA ``place_rows``), each with its plain PyTorch
version for CPU tensors (``ops/plumbing.py``).  Everything else — the
launch plan, the escalation replay, rebasing and the update lanes — is
the reference's host numpy and Python logic, carried over as it stands.

With ``mesh=`` (a ``placement.GroupsMesh``) the row state is cut into
the mesh's blocks and every program of a launch runs once a block
(``placement.RowBlocks``); readbacks are joined on the host in the
order the host asked for them.  A one-device mesh is the single-device
engine.

Replaces the per-shard scalar ``node.step()`` loop of ``HostStepEngine``
with ONE kernel launch over a `[G]`-row device-resident state tensor
(reference: engine.go stepWorkerMain becomes a vectorized kernel, per
BASELINE.json north_star).  The division of labor:

  * **device** — protocol state (term/vote/role/ticks/remotes/log-term
    ring) and the hot step function (`ops/kernel.py`).
  * **host (scalar ``Raft``)** — the authoritative payload log
    (``EntryLog`` over the LogDB reader), sessions, ReadIndex
    bookkeeping, snapshots, and every cold input.  For device-resident
    rows the scalar's protocol fields are stale EXCEPT term / vote /
    leader_id / role / log.committed, which are re-synced from the
    device after every step so the standard ``Peer.get_update()`` /
    ``node.process_update()`` plumbing keeps working unchanged.

Row routing per step (see `_plan_device`):

  * hot inputs (ticks, hot wire messages, application proposals) →
    encoded into the device inbox;
  * cold inputs (config change, read index, snapshot request, leader
    transfer, cold message types, oversized batches) → the row is
    **materialized** (device → scalar copy) and stepped by the scalar
    path; the row is re-uploaded when it goes hot again;
  * kernel escalation (ESC_* bits) → the row's device effects are
    discarded (pre-step state restored) and the drained inputs are
    replayed on the materialized scalar — the escalation contract from
    ops/kernel.py's module docstring.

Log reconstruction: the kernel reports ``append_lo`` (lowest ring-
written index).  The host stamps payload entries for
[append_lo, last_index] from its staging map (proposal entries by
slot_base; REPLICATE payloads by wire position), picking the last
slot-order candidate whose term matches the ring term; gaps are
become-leader noop barriers.  The merged entries flow out through
``Update.entries_to_save`` exactly as in the scalar engine.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import jitcheck
from ..engine.execengine import IStepEngine
from ..logger import get_logger
from ..pb import Entry, EntryType, Message, MessageType, Snapshot
from ..raft.raft import Raft, RaftRole
from ..raft.remote import RemoteState
from ..request import gc_tables
from ..rsm.statemachine import Task, TaskType
from . import engine_ref
from . import hostplane
from . import kernel as K
from . import kernel_ref
from . import placement
from . import plumbing
from . import sync as S
from .types import (
    ROLE_LEADER as ROLE_LEADER_I,
    N_FIELDS as N_FIELDS_BUF,
    F_LOG_INDEX,
    F_MTYPE,
    F_N_ENTRIES,
    F_SRC_SLOT,
    F_TO,
    HOT_TYPES,
    SLOT_DROPPED,
    DeviceOut,
    DeviceState,
    make_state,
)

_log = get_logger("engine")

_HOT_SET = frozenset(HOT_TYPES)

# On the CPU the device sections of every engine in a process take turns:
# the plain versions are thousands of small-tensor ops, each releasing and
# retaking the GIL, and several engines stepping them at once thrash the
# GIL many times over the cost of running them one after another.
_CPU_DEVICE_LOCK = threading.Lock()

# readback row indices of the per-row VALUES block (_gather_detail's
# idx_sum part); 0-5 double as the [6, G] host mirror's row indices
# AND the update-lane word layout (hostplane.UpdateLanes).  The values
# live in types.py (one definition across the device gather program,
# both merge tails and the lane store); the `_R_*` aliases keep this
# module's historical spelling.
from .types import (  # noqa: E402 — alias block, not a new dependency
    N_VALS,
    R_TERM as _R_TERM,
    R_VOTE as _R_VOTE,
    R_COMMIT as _R_COMMIT,
    R_LEADER as _R_LEADER,
    R_ROLE as _R_ROLE,
    R_LAST as _R_LAST,
    R_COUNT as _R_COUNT,
    R_APPEND_LO as _R_APPEND_LO,
    R_BARRIER_IDX as _R_BARRIER_IDX,
    R_BARRIER_TERM as _R_BARRIER_TERM,
    U_COMMIT,
    U_LEADER,
    U_LOST_LEAD,
    U_ROLE,
    U_STATE,
)

# int role -> RaftRole member: the merge tails' enum lookup.  The
# `RaftRole(role)` enum call costs ~0.5 µs per row (EnumMeta.__call__)
# — a real share of the per-affected-row residual at 250k rows.
_ROLE_OF = {int(x): x for x in RaftRole}

# per-row flag bits of the _summarize_flags readback — the ONLY
# full-width [G] readback a launch performs.  Everything row-valued
# (terms, counts, outboxes, rings) is gathered afterwards for flagged
# rows only: the flags word is 4 bytes per row and the steady-state
# gather is a few rows.  The bit values live in types.py
# (shared with the vectorized host-plane machinery in ops/hostplane.py);
# the `_F_*` aliases keep this module's historical spelling.
from .types import (  # noqa: E402 — alias block, not a new dependency
    F_COUNT as _F_COUNT,
    F_APPEND as _F_APPEND,
    F_NEED_SS as _F_NEED_SS,
    F_ESC as _F_ESC,
    F_PEERS_BEHIND as _F_PEERS_BEHIND,
    F_ANY_LIVE as _F_ANY_LIVE,
)


def _bucket(n: int) -> int:
    """Next power of two ≥ n (bounds jit recompiles for dynamic row sets)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def _pad_idx(idx: Sequence[int], pad: Optional[int] = None) -> np.ndarray:
    if pad is None:
        pad = _bucket(len(idx))
    out = np.empty((pad,), np.int32)
    out[: len(idx)] = idx
    out[len(idx):] = idx[-1]  # duplicate scatter/gather of one row is benign
    return out


# The row movers below launch CUDA ``place_rows`` through ``plumbing``;
# ``impl=engine_ref`` runs the same program through its plain version
# (the engine's parity self-check, ``TorchStepEngine._move_rows``).


def _scatter_rows(state: DeviceState, pos, sub: DeviceState,
                  impl=plumbing) -> DeviceState:
    """Place sub's rows into state at the rows marked by ``pos`` — a
    [G] int32 position map (pos[g] = row of ``sub`` to take, -1 = keep
    state's row)."""
    return DeviceState(*impl.place_rows(list(state), list(sub), pos))


def _pos_map(G: int, gs) -> np.ndarray:
    """Host-built [G] position map for _scatter_rows/_scatter_inbox_rows:
    pos[g] = index into the sub batch, -1 elsewhere.  ONE definition —
    delegates to hostplane.pos_of, the same map the merge tail's
    index-array machinery uses (two byte-equivalent copies would
    drift)."""
    return hostplane.pos_of(G, gs)


def _select_rows(keep_new, old: DeviceState, new: DeviceState,
                 impl=plumbing) -> DeviceState:
    """Per row: new's row where ``keep_new`` (a [G] bool array), else
    old's — ``place_rows`` with pos = g where the new row is kept."""
    keep = np.asarray(keep_new, bool)
    pos = np.where(keep, np.arange(keep.shape[0]), -1).astype(np.int32)
    pos_t = torch.from_numpy(pos).to(old.term.device)
    return DeviceState(*impl.place_rows(list(old), list(new), pos_t))


def _gather_rows(state: DeviceState, idx, impl=plumbing) -> DeviceState:
    """The rows ``idx`` of every field (``place_rows`` with no dst)."""
    return DeviceState(*impl.place_rows(None, list(state), idx))


def _summarize_flags(old: DeviceState, new: DeviceState, out) -> torch.Tensor:
    """Per-row flag word (see _F_*) — the one full-width readback.
    CUDA ``summarize_flags``."""
    return plumbing.summarize_flags(old, new, out)


def _gather_vals(state, out, idx):
    """Per-row VALUES block (_R_* order) for the rows ``idx``: [b, 10]."""
    return plumbing.gather_pack(state, out, None, idx).reshape(-1, N_VALS)


def _gather_detail(state, out, idx4):
    """All heavy post-step detail reads as ONE [b, K] array (CUDA
    ``gather_pack``, detail mode)."""
    b = idx4.shape[1]
    return plumbing.gather_pack(state, out, idx4, None).reshape(b, -1)


def _detail_width(O: int, M: int, E: int, P: int, W: int) -> int:
    """Per-row int32 width of _gather_detail's packing — the ONE
    definition shared by _split_detail, _fetch_detail_vals and the
    kernel wrapper (engine_ref.detail_width)."""
    return engine_ref.detail_width(O, M, E, P, W)


def _split_detail(flat: np.ndarray, O: int, M: int, E: int, P: int, W: int):
    """Host-side inverse of _gather_detail's packing."""
    b = flat.shape[0]
    sizes = (O * N_FIELDS_BUF, M, M, M * E, P, W, W)
    shapes = ((b, O, N_FIELDS_BUF), (b, M), (b, M), (b, M, E), (b, P), (b, W), (b, W))
    outs = []
    pos = 0
    for size, shape in zip(sizes, shapes):
        outs.append(flat[:, pos : pos + size].reshape(shape))
        pos += size
    return tuple(outs)


def _gather_detail_vals(state, out, idx4, idx_sum):
    """_gather_detail + _gather_vals in ONE launch and ONE flat 1-D
    readback (CUDA ``gather_pack``, both modes)."""
    return plumbing.gather_pack(state, out, idx4, idx_sum)


def _to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _build_idx4(buf_rows, slot_rows, need_rows, append_rows):
    """[4, b] padded index sets for _gather_detail, or None when all
    four are empty.  All sets pad to ONE bucket so the fused gather
    compiles per bucket size, not per size combination; the pad repeats
    the last real row (duplicate gathers of one row are benign)."""
    if not (buf_rows or append_rows or slot_rows or need_rows):
        return None
    b = _bucket(
        max(len(buf_rows), len(append_rows), len(slot_rows), len(need_rows))
    )
    idx4 = np.zeros((4, b), np.int32)
    for row_i, rows in enumerate(
        (buf_rows, slot_rows, need_rows, append_rows)
    ):
        if rows:
            idx4[row_i, : len(rows)] = rows
            idx4[row_i, len(rows):] = rows[-1]
    return idx4


def _fetch_detail_vals(state, out, idx4, sum_rows, put, O, M, E, P, W,
                       allow_fused: bool = True, pack=None):
    """Gather post-step detail and/or per-row values with the MINIMUM
    number of sync round trips: one fused dispatch+readback when both
    are needed, one when only one is.  Returns (detail_tuple_or_None,
    vals_np_or_None) where detail_tuple is _split_detail's output.

    The buckets are equalized whenever padding is cheap: sum rows up is
    always cheap (N_VALS ints/row); detail rows up only until ~1 MB of
    padded transfer.  A mismatched pair beyond that uses the two
    separate gathers.  ``allow_fused=False`` forces the separate
    gathers.

    ``pack`` replaces the readback packer (default: the ``gather_pack``
    kernel wrapper); the engine's parity self-check passes the plain
    version to read the same rows a second way.
    """
    if pack is None:
        pack = plumbing.gather_pack
    detail = vals_np = None
    if allow_fused and idx4 is not None and sum_rows:
        b = idx4.shape[1]
        bs = _bucket(len(sum_rows))
        K = _detail_width(O, M, E, P, W)
        if bs < b:
            bs = b  # pad sum rows up: N_VALS ints per padded row
        elif bs > b and (bs - b) * K * 4 <= 1_000_000:
            idx4 = np.concatenate(
                [idx4, np.repeat(idx4[:, -1:], bs - b, axis=1)], axis=1
            )
            b = bs
        if b == bs:
            flat = _to_np(
                pack(state, out, put(idx4), put(_pad_idx(sum_rows, bs)))
            )
            detail = _split_detail(
                flat[: b * K].reshape(b, K), O, M, E, P, W
            )
            vals_np = flat[b * K:].reshape(-1, N_VALS)
            return detail, vals_np
    if idx4 is not None:
        detail = _split_detail(
            _to_np(pack(state, out, put(idx4), None)).reshape(
                idx4.shape[1], -1
            ),
            O, M, E, P, W,
        )
    if sum_rows:
        vals_np = _to_np(
            pack(state, out, None, put(_pad_idx(sum_rows)))
        ).reshape(-1, N_VALS)
    return detail, vals_np


# the row set each detail field of _split_detail reads (_build_idx4's
# rows: buf, slot, need, append)
_DETAIL_SET = (0, 1, 1, 1, 2, 3, 3)


def _fetch_blocks(blocks, states, outs, sets, sum_rows, put, O, M, E, P,
                  W, allow_fused: bool = True, pack=None):
    """``_fetch_detail_vals`` over row blocks (``placement.RowBlocks``):
    ``sets`` = (buf, slot, need, append) row lists and ``sum_rows`` in
    global rows, in the order the host built them; ``states[d]`` /
    ``outs[d]`` block d's tensors, ``put(x, d)`` a host array on block
    d's device.  Each block gathers its own rows (block-local indexes),
    and each section is joined in the caller's order (split_rows'
    ``order``).  One block is the single-device fetch."""
    if blocks.D == 1:
        return _fetch_detail_vals(
            states[0], outs[0], _build_idx4(*sets), list(sum_rows),
            lambda x: put(x, 0), O, M, E, P, W, allow_fused, pack)
    lists = [list(x) for x in sets] + [list(sum_rows)]
    split = [{d: (local, order) for d, local, order in blocks.split_rows(x)}
             for x in lists]
    touched = sorted({d for sp in split for d in sp})
    detail = None
    if any(lists[:4]):
        detail = [None] * len(_DETAIL_SET)
    vals = (np.zeros((len(lists[4]), N_VALS), np.int32)
            if lists[4] else None)
    for d in touched:
        loc = [split[i].get(d, (np.zeros((0,), np.int32), None))[0]
               for i in range(5)]
        det_d, vals_d = _fetch_detail_vals(
            states[d], outs[d], _build_idx4(*(x.tolist() for x in loc[:4])),
            loc[4].tolist(), lambda x, d=d: put(x, d), O, M, E, P, W,
            allow_fused, pack)
        if det_d is not None:
            for f, (arr, i) in enumerate(zip(det_d, _DETAIL_SET)):
                if detail[f] is None:
                    detail[f] = np.zeros((len(lists[i]),) + arr.shape[1:],
                                         arr.dtype)
                if d in split[i]:
                    order = split[i][d][1]
                    detail[f][order] = arr[:len(order)]
        if vals_d is not None:
            order = split[4][d][1]
            vals[order] = vals_d[:len(order)]
    return (None if detail is None else tuple(detail)), vals


def _set_remote_snapshot(state: DeviceState, g_idx, p_idx, snap_idx,
                         impl=plumbing):
    """rstate = RS_SNAPSHOT and snap_index = snap_idx at each (g, p)
    (``place_rows``, snapshot mode)."""
    rs, sn = impl.set_remote_snapshot(
        state.rstate, state.snap_index, g_idx, p_idx, snap_idx
    )
    return state._replace(rstate=rs, snap_index=sn)


def _shift_msg_indexes(msg: Message, delta: int) -> Message:
    """Shift a wire message's INDEX fields by ``delta`` (the rebase
    boundary conversion): log_index and commit always; hint only when it
    is an index (a REPLICATE_RESP reject hint), never when it is a ctx
    key.  Used with -base entering the device and +base leaving it —
    one definition so encode and decode can never disagree.

    READ_INDEX_RESP is special-cased: the kernel's synthetic to-self
    resp overloads log_index as a VOTER REPLICA ID (or 0 = "request
    recorded"), not a log index — shifting it would turn the recorded
    marker into ``base`` and voter ids into garbage, stalling every
    device-path read once a row's base is nonzero.  Its ``commit`` IS a
    real index (the recorded read index) and still shifts.  Wire
    READ_INDEX_RESP (whose log_index is a real index) never crosses
    this boundary: the type is not in HOT_TYPES, so it cannot enter a
    device inbox, and the kernel only emits the self-addressed form."""
    if delta == 0:
        return msg
    if msg.type == MessageType.READ_INDEX_RESP:
        return dataclasses.replace(msg, commit=msg.commit + delta)
    h = (
        msg.hint + delta
        if msg.type == MessageType.REPLICATE_RESP and msg.reject
        else msg.hint
    )
    return dataclasses.replace(
        msg,
        log_index=msg.log_index + delta,
        commit=msg.commit + delta,
        hint=h,
    )


def _tick_bookkeeping(node, ticks: int) -> None:
    """Advance the node's logical clock and GC timed-out futures — the
    device path's mirror of the tick tail of ``Node.step_with_inputs``.

    The GC is ONE hint-gated sweep over the node's five pending tables
    per call (request.gc_tables) instead of the old five per-table
    ``gc()`` calls — at 250k rows the five probes (and, with any table
    non-empty, five lock acquisitions) per affected row per generation
    were a top-3 share of the merge tail's residual.  The
    monotone-deadline argument, kept honest: deadlines are fixed at
    allocation and the clock is monotone, so sweeping exactly when the
    clock first reaches the earliest pending deadline (the hint cell)
    delivers every timeout at the same tick value the old per-table
    sweep did — fused multi-tick counts land on the SAME final count
    either way, and ticks below the hint can expire nothing."""
    if not ticks:
        return
    tc = node.tick_count + ticks
    node.tick_count = tc
    # the SCALAR raft's logical clock advances too: device-resident
    # rows never call Raft.tick(), and a frozen r.tick_count poisons
    # every wall-clock comparison made while resident — the CheckQuorum
    # grace rate limit, the boot-lease grace, and (ROADMAP 4b) the
    # lease math, where a device-window anchor stamped on the live node
    # clock against a frozen raft clock OVERSTATES the lease by the
    # whole residency.  The scalar path keeps the two clocks in
    # lockstep (step_with_inputs ticks the raft, then advances the node
    # clock by the same count); this is the device path's mirror.
    node.peer.raft.tick_count += ticks
    if tc >= node.pending_deadline_hint[0]:
        gc_tables(node.pending_tables, node.pending_deadline_hint, tc)


def _plan_lane_words(  # hostplane-hot
    ulanes, bases, gs_live, sum_rows, vals, capacity, mirror=None,
):
    """Assemble one generation's array-side update words.

    Gathers the live rows' last-synced lanes, diffs the generation's
    merged values against them (``hostplane.plan_update_sync``) and
    writes the new words back for exactly those rows — the whole
    assembly is numpy gathers over ``[G]`` lanes; rows the caller's
    merge loop then skips (none on this engine: the batch is
    re-validated under the lock) would be re-seeded at their next
    upload, so the bulk write-back is always safe.  When ``mirror`` is
    given, the device-frame ``[6, G]`` host mirror is bulk-synced for
    every values-carrying row too (replacing the per-row
    ``mirror[:6, g] = vals[k, :6]`` writes of the old merge loop).
    Returns the ``UpdateSyncPlan`` whose ``ubits`` drive the
    LANE/heavy row split.
    """
    sum_k = hostplane.pos_of(
        capacity, np.asarray(sum_rows, np.int64)
    )[gs_live]
    old_w = ulanes.words[:, gs_live]
    uplan = hostplane.plan_update_sync(old_w, sum_k, vals, bases[gs_live])
    if hostplane.PARITY:
        hostplane.check_update_plan_parity(
            old_w, sum_k, vals, bases[gs_live], uplan
        )
    ulanes.words[:, gs_live] = uplan.words
    if mirror is not None:
        in_sum = sum_k >= 0
        if in_sum.any():
            mirror[:6, gs_live[in_sum]] = vals[sum_k[in_sum], :6].T
    return uplan


def _apply_lane_commit(node, ce, notify: bool = True) -> None:
    """The lane rows' post-save apply handoff — one definition for the
    slot-batched and list-fallback persist paths (both MUST run it
    only after the row's save landed: persist-before-apply,
    peer.commit's order).  Hands the committed entries to the apply
    queue, advances the processed cursor, and runs the AMORTIZED
    in-mem GC: ``applied_log_to`` slices the entry list (O(live
    entries)) every call, so sweep once per ~32 applied entries
    instead of per commit — bounded residency (<=32 applied entries
    linger), 32x fewer slices on the commit-wave path.

    ``notify=False`` defers the apply-worker wakeup to the caller —
    the batched per-SM-worker handoff (:func:`_apply_lane_commits`)."""
    if node._trace_spans:
        node._trace_committed(ce)
    node.sm.task_queue.add(Task(type=TaskType.ENTRIES, entries=ce))
    log = node.peer.raft.log
    log.processed = ce[-1].index
    im = log.inmem
    if log.processed - im.marker >= 32:
        im.applied_log_to(log.processed)
    if notify and node.engine_apply_ready is not None:
        node.engine_apply_ready(node.shard_id)


def _apply_lane_commits(handoffs) -> None:
    """BATCHED apply handoff per SM worker per generation (ROADMAP
    item 1's named next cut for the commit-wave split): enqueue every
    commit row's Task/cursor-advance, then wake each apply-worker
    partition ONCE via ``WorkReady.notify_all`` instead of per row.

    The per-row ``engine_apply_ready`` closure takes its partition's
    condition lock on every call — at a commit wave touching thousands
    of rows that is thousands of interleaved lock acquisitions against
    the very apply workers the wakeups target.  ``notify_all`` groups
    the shard ids by partition host-side and takes each partition's
    lock exactly once per generation.  Nodes registered before the
    batched hook existed (``apply_work_ready`` is None — bespoke
    engines, tests driving nodes directly) keep the per-row path.

    ``handoffs`` is ``[(node, committed-entries)]`` for rows whose
    batched save ALREADY landed — the persist-before-apply order is
    the caller's contract, unchanged."""
    by_wr: Dict[int, Tuple] = {}
    for node, ce in handoffs:
        _apply_lane_commit(node, ce, notify=False)
        # getattr: bespoke node doubles (bench twins, direct-drive
        # tests) predate the hook and keep the per-row path
        wr = getattr(node, "apply_work_ready", None)
        if wr is not None:
            by_wr.setdefault(id(wr), (wr, []))[1].append(node.shard_id)
        elif node.engine_apply_ready is not None:
            node.engine_apply_ready(node.shard_id)
    for wr, shard_ids in by_wr.values():
        wr.notify_all(shard_ids)


class _RowMeta:
    """Per-row metadata view.  The TRUTH lives in the engine's
    ``hostplane.RowLanes`` SoA arrays so the vectorized plan classifier
    and merge stage read whole lanes at once; these properties keep the
    scalar paths' field syntax (``meta.dirty = True`` etc.) working
    unchanged.  Field semantics:

    * dirty — the scalar Raft is authoritative and the device row is
      stale (fresh rows, cold-stepped rows, escalated rows).
    * plan_ok — the last FULL _plan_device pass for this row passed
      every static eligibility check; while it holds (and the cheap
      per-launch conditions — empty queues, clean row, no snapshot/
      read state — are re-verified inline), the colocated fast tick
      lane may skip the full classifier.  Invalidated by the events
      that can change a static check: merge-loop snapshot sends,
      int32-limit proximity, membership traffic (which arrives via
      the queues and forces the full path anyway).
    * esc_hold — steps to HOLD the row on the scalar path after an
      escalation (set via set_escalation_hold so both engines share
      the formula).  An escalation triggered by ROUTED-ONLY inputs
      discards those inputs (raft-safe for SAFETY, not for liveness):
      re-uploading immediately starves the scalar of the wire round
      trip it needs to act — observed as an infinite probe->reject->
      escalate loop when a resident leader's next_idx walked below its
      ring window (a healed follower never caught up; thousands of
      ESC_WINDOW escalations doing nothing).  A few held steps
      let real wire traffic reach the scalar, which then probes from
      the full authoritative log.
    """

    __slots__ = ("node", "_lanes", "_g")

    def __init__(self, node, lanes, g: int):
        self.node = node
        self._lanes = lanes
        self._g = g
        lanes.reset_row(g, attached=True)

    @property
    def dirty(self) -> bool:
        return bool(self._lanes.dirty[self._g])

    @dirty.setter
    def dirty(self, v: bool) -> None:
        self._lanes.dirty[self._g] = v

    @property
    def plan_ok(self) -> bool:
        return bool(self._lanes.plan_ok[self._g])

    @plan_ok.setter
    def plan_ok(self, v: bool) -> None:
        self._lanes.plan_ok[self._g] = v

    @property
    def esc_hold(self) -> int:
        return int(self._lanes.esc_hold[self._g])

    @esc_hold.setter
    def esc_hold(self, v: int) -> None:
        self._lanes.esc_hold[self._g] = v

    def set_escalation_hold(self, config) -> None:
        self.esc_hold = max(4, 2 * config.heartbeat_rtt + 2)


class TorchStepEngine(IStepEngine):
    """Device-backed IStepEngine (plug in via ExpertConfig
    .step_engine_factory = torch_step_engine_factory(...)).

    ``device``: where the row state lives and the step runs — a CUDA
    device (the default, ``placement.default_device()``) launches the
    hand-written kernels; ``"cpu"`` runs their plain PyTorch versions.
    Asking for CUDA without a card raises.

    ``mesh``: a ``placement.GroupsMesh`` (it wins over ``device``, as in
    the reference, engine.py:660-684).  The row state is a
    ``placement.Sharded``: block ``d`` on ``mesh.devices[d]`` holds rows
    ``[d*Gl, (d+1)*Gl)``; every program of a launch runs once per block
    on that block's tensors, and readbacks are joined on the host in
    global row order.  Free rows are striped across the blocks (the
    reference's order), and ``device_coordinate`` names a shard's block.
    A one-device mesh is the single-device engine.

    ``parity_every``: when > 0, every ``parity_every``-th launch is run
    a second time through the plain PyTorch versions (step, flag word,
    readback pack) on the same inputs, and so is every row movement
    (upload scatter, escalation select, materialize gather, snapshot
    store); each must match bit for bit.  A mismatch is counted in
    ``stats["parity_failures"]``, latched in ``parity_failure`` and
    raised.  The exec engine's step worker only logs what
    ``step_shards`` raises, so a run reads the counters: every check
    begun (``parity_step_attempts``, ``parity_row_attempts``) must have
    passed (``parity_checked_launches``, ``parity_checked_row_moves``).
    A self-check for smoke runs on the card, off by default.
    """

    def __init__(
        self,
        logdb,
        *,
        capacity: int = 1024,
        P: int = 5,
        W: int = 32,
        M: int = 8,
        E: int = 4,
        O: int = 32,
        device=None,
        mesh=None,
        parity_every: int = 0,
    ):
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.logdb = logdb
        self.capacity, self.P, self.W, self.M, self.E, self.O = (
            capacity,
            P,
            W,
            M,
            E,
            O,
        )
        if mesh is not None:
            if capacity % mesh.size:
                raise ValueError(
                    f"capacity {capacity} must divide over {mesh.size} devices"
                )
            if len(mesh.axis_names) != 1:
                raise ValueError("engine mesh must be one-dimensional")
            self._mesh = mesh
            self._device = None
        else:
            self._mesh = None
            self._device = placement.resolve_device(device)
        # the row blocks every program runs over: the mesh's, or one
        # block on the engine device
        self._blocks = placement.RowBlocks(
            mesh if mesh is not None
            else placement.GroupsMesh([self._device]), capacity)
        self._parity_every = int(parity_every)
        self.parity_failure: Optional[str] = None  # the first mismatch
        # inert rows: no peers, empty inbox -> the kernel never touches them
        self._state = self._inert_state()
        self._row_of: Dict[int, int] = {}  # shard_id -> g
        self._meta: Dict[int, _RowMeta] = {}  # g -> meta
        # SoA truth store behind every _RowMeta (ops/hostplane.py): the
        # vectorized plan classifier and merge stage read these lanes
        # array-at-once instead of probing per-row attributes
        self._lanes = hostplane.RowLanes(capacity)
        # device-plane lease evidence lanes (ROADMAP 4b): the host's
        # model of each resident leader's CheckQuorum activity window,
        # anchored from the F_QUORUM_ACTIVE flag bit — see
        # hostplane.LeaseLanes and _lease_row_step
        self._lease = hostplane.LeaseLanes(capacity)
        # array-side pb.Update lanes: the last SYNCED
        # absolute scalar words per row.  A generation's effects diff
        # against these in one vectorized pass (plan_update_sync), and
        # effect-free/commit-only rows skip the per-row get_update
        # object walk entirely — see hostplane.UpdateLanes.
        self._ulanes = hostplane.UpdateLanes(capacity)
        # lane rows classified by the last _device_step, drained by
        # step_shards AFTER the core lock releases (_persist_lane_rows)
        self._lane_pending: List[Tuple] = []
        # array-batched STATE-ONLY persists (no per-row tuples at all):
        # (db, slots, terms, votes, commits, live, js) per LogDB — see
        # _persist_lane_batches.  Rows map to their store through the
        # per-row slot/db-index lanes below, resolved at upload via the
        # ILogDB optional slot protocol (-1 = store has no slot path;
        # such rows ride the tuple form + save_state_lanes instead).
        self._lane_pending_arr: List[Tuple] = []
        self._lane_slot = np.full((capacity,), -1, np.int64)
        self._lane_dbi = np.full((capacity,), -1, np.int64)
        self._lane_dbs: List = []
        # STRIPED free order in mesh mode: consecutive attaches land on
        # distinct device blocks, so resident rows (and their group-tick
        # load) balance across the mesh; pops come from the END
        self._free: List[int] = self._blocks.striped_free()
        # per-row index base (the 64-bit story): the host log is 64-bit
        # throughout; device rows hold indexes REBASED by a per-row
        # multiple of W so the int32 lanes never overflow.  Recomputed at
        # every upload; all host<->device index conversions go through it.
        self._base = np.zeros((capacity,), np.int64)
        self._lock = threading.Lock()
        self._device_lock = (
            _CPU_DEVICE_LOCK if self._blocks.mesh.device_type == "cpu"
            else contextlib.nullcontext())
        self._warned_full = False
        # host mirrors of the summary scalars (term/vote/commit/...)
        self._mirror = np.zeros((6, capacity), np.int64)
        # updates whose batched WAL save failed: their nodes re-emit on a
        # later step (peer.commit never ran, so get_update regenerates
        # the same entries/commits) — but device rows only construct
        # updates when FLAGGED, so a failed save must force re-emission
        # explicitly or the batch is silently lost (WAL-fault injection
        # skipped apply batches and diverged a replica's SM)
        self._update_retry: "set" = set()
        self._retry_lock = threading.Lock()
        # nodes whose last save FAILED: their rows are held on the
        # scalar path (save-before-send) until a save succeeds — on the
        # colocated engine a resident row's acks are device-routed in
        # the same launch as the append, so letting it keep stepping on
        # the device while its WAL is faulty would repeatedly expose
        # acked-but-unpersisted entries
        self._save_quarantine: "set" = set()
        # device-synced "leader has a lagging peer" bit per row (the
        # scalar remotes of resident rows are stale) — quiesce gate
        self._behind = np.zeros((capacity,), bool)
        # the unified fault plane (faults.FaultController): an active
        # `escalate` fault forces rows through the kernel-escalation
        # recovery machinery.  The base engine consumes it post-launch
        # (discard device effects + scalar replay — the true escalation
        # contract); the colocated engine consumes it at plan time (its
        # routed regions suppress escalated rows ON device, so a
        # post-hoc flag flip there would desync merged state).
        self.fault_injector = None
        self._consume_engine_fault_at_plan = False
        self.stats = {
            "device_steps": 0,
            "device_rows_stepped": 0,
            "host_rows_stepped": 0,
            "escalations": 0,
            "divergence_halts": 0,
            "save_failures": 0,
            "device_reads": 0,
            "parity_step_attempts": 0,
            "parity_checked_launches": 0,
            "parity_row_attempts": 0,
            "parity_checked_row_moves": 0,
            "parity_failures": 0,
        }
        self._warm()

    def stats_snapshot(self) -> dict:
        """The counters at a moment when no launch, row move or parity
        check is in flight (they all run under the engine lock)."""
        with self._lock:
            return dict(self.stats)

    def _put(self, x, d: int = 0):
        """Move a numpy int array, a tensor, or a NamedTuple of tensors
        (indexes, gathered sub-states, inboxes) to block ``d``'s
        device."""
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(self._put(t, d) for t in x))
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
        return x.to(self._blocks.devices[d])

    def _put_rows(self, x) -> placement.Sharded:
        """A full-capacity row array (state, inbox, [G] maps) as the row
        blocks' tensors (``placement.Sharded``)."""
        return self._blocks.put(x)

    def _inert_state(self) -> placement.Sharded:
        """Fresh inert rows on every block (no peers: the kernel never
        touches them)."""
        return self._put_rows(make_state(
            self.capacity, self.P, self.W,
            replica_ids=np.zeros(self.capacity), device="cpu"))

    def _sync(self) -> None:
        for dev in set(self._blocks.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- row moves over the blocks --------------------------------------
    def _scatter_state(self, state, gs, sub) -> placement.Sharded:  # mesh-hot
        """``_scatter_rows`` of the host sub-state ``sub`` (row k for the
        global row ``gs[k]``) on every block it touches."""
        pos = _pos_map(self.capacity, gs)
        parts = list(state.parts)
        for d in range(self._blocks.D):
            lo, hi = self._blocks.span(d)
            if (pos[lo:hi] >= 0).any():
                parts[d] = self._move_rows(
                    _scatter_rows, parts[d], self._put(pos[lo:hi], d),
                    self._put(sub, d))
        return placement.Sharded(tuple(parts))

    def _select_state(self, keep_new, old, new) -> placement.Sharded:
        """``_select_rows`` block by block (``keep_new``: [G] bool)."""
        return placement.Sharded(tuple(
            self._move_rows(_select_rows, keep_new[slice(*self._blocks.span(
                d))], old.parts[d], new.parts[d])
            for d in range(self._blocks.D)))

    def _gather_blocks(self, parts, gs, gather) -> list:
        """The rows ``gs`` of a row tree's blocks ``parts`` as host
        arrays, field by field, in ``gs``'s order: ``gather(part, idx)``
        gathers a block's rows (padded block-local indexes)."""
        fields = None
        for d, local, order in self._blocks.split_rows(gs):
            sub = [_to_np(t) for t in gather(parts[d],
                                              self._put(_pad_idx(local), d))]
            if fields is None:
                fields = [np.zeros((len(gs),) + a.shape[1:], a.dtype)
                          for a in sub]
            for f, a in zip(fields, sub):
                f[order] = a[:len(order)]
        return fields

    def _gather_state(self, state, gs) -> DeviceState:
        """The rows ``gs`` of every state field as host arrays, in
        ``gs``'s order (each block gathers its own rows)."""
        return DeviceState(*self._gather_blocks(
            state.parts, gs,
            lambda part, idx: self._move_rows(_gather_rows, part, idx)))

    def _snapshot_state(self, state, lanes) -> placement.Sharded:
        """``_set_remote_snapshot`` at each (g, p, snap) of ``lanes`` on
        its row's block."""
        p_idx = np.asarray([t[1] for t in lanes], np.int64)
        s_idx = np.asarray([t[2] for t in lanes], np.int64)
        parts = list(state.parts)
        for d, local, order in self._blocks.split_rows(
                [t[0] for t in lanes]):
            parts[d] = self._move_rows(
                _set_remote_snapshot, parts[d],
                self._put(_pad_idx(local), d),
                self._put(_pad_idx(p_idx[order]), d),
                self._put(_pad_idx(s_idx[order]), d))
        return placement.Sharded(tuple(parts))

    def _fetch(self, states, outs, sets, sum_rows, M: int,
               allow_fused: bool = True, pack=None):
        """The post-step readback (``_fetch_blocks``) of the row sets
        ``sets`` = (buf, slot, need, append) and ``sum_rows``."""
        return _fetch_blocks(self._blocks, states, outs, sets, sum_rows,
                             self._put, self.O, M, self.E, self.P, self.W,
                             allow_fused=allow_fused, pack=pack)

    @staticmethod
    def _cq_grace(r) -> None:
        """CheckQuorum grace across a device<->host residency boundary:
        the peer-activity window is sheared by the transition (the other
        side may have just cleared the flags), and an immediate quorum
        check against an empty window steps a healthy leader down.

        The grace DELAYS the next check by restarting the activity
        window (election_tick = 0) instead of fabricating activity: the
        old mark-all-remotes-active form satisfied every check for a
        leader crossing the boundary about once per window — the same
        cadence as the check itself — so a minority-partitioned leader
        could evade stepdown indefinitely.  With the
        reset, passing the delayed check still requires GENUINE
        responses during the fresh window.

        Rate-limited to once per election window (tracked on the raft's
        logical clock) so an oscillating leader cannot push the check
        out forever; worst case a partitioned leader steps down within
        ~2-3 windows instead of the reference's ~1 (`raft.go
        checkQuorumActive [U]`)."""
        now = r.tick_count
        last = getattr(r, "_cq_grace_at", None)
        if last is not None and now - last < r.election_timeout:
            return
        r._cq_grace_at = now
        r.election_tick = 0

    def _warm(self) -> None:
        """Run every program of a launch once on the inert state, so the
        kernels are built and loaded before the first real step (torch
        runs eagerly; there is nothing to trace)."""
        from .types import make_inbox

        per = self._blocks.per
        for d, st in enumerate(self._state.parts):
            inbox = make_inbox(per, self.M, self.E,
                               device=self._blocks.devices[d])
            _, out = K.step(st, inbox, out_capacity=self.O)
            _summarize_flags(st, st, out)
            _select_rows(np.ones((per,), bool), st, st)
            idx = self._put(np.zeros((1,), np.int32), d)
            _scatter_rows(st, self._put(np.full((per,), -1, np.int32), d),
                          _gather_rows(st, idx))
            _gather_detail_vals(st, out,
                                self._put(np.zeros((4, 1), np.int32), d), idx)
            _set_remote_snapshot(st, idx, idx, idx)
        self._sync()
        if jitcheck.ENABLED:
            # the post-warm-up sentry's baseline (analysis/jitcheck):
            # from here on nothing should build, or allocate what the
            # warm-up allocated
            jitcheck.mark_warm()

    # ------------------------------------------------------------------
    # row lifecycle
    # ------------------------------------------------------------------
    def _row_key(self, node):
        """Row-table key.  One NodeHost hosts one replica per shard, so
        the base engine keys by shard id; the colocated engine (multiple
        NodeHosts sharing one device) overrides with (shard, replica)."""
        return node.shard_id

    def detach(self, shard_id: int) -> None:
        with self._lock:
            g = self._row_of.pop(shard_id, None)
            if g is not None:
                self._meta.pop(g, None)
                self._lanes.reset_row(g, attached=False)
                self._free.append(g)

    def _halt_replica(self, g: int) -> None:
        """Fail-stop a diverged replica (caller holds the engine lock).

        ``node.stop()`` drops every pending future and closes the SM —
        without it, enqueued traffic and registered futures would leak
        forever on a node nothing will ever step again.  The row slot is
        freed so other shards can use it.  Safe under the engine lock:
        apply workers never call back into the step engine."""
        node = self._meta[g].node
        self.stats["divergence_halts"] += 1
        self._row_of.pop(self._row_key(node), None)
        self._meta.pop(g, None)
        self._lanes.reset_row(g, attached=False)
        self._free.append(g)
        node.stop()

    def _compute_base(self, r) -> int:
        """Largest W-multiple not exceeding any live index quantity of
        the row — subtracting it keeps every device lane positive (0
        stays the sentinel for match/next/snap) and, being a multiple of
        W, leaves ring slot assignment invariant.  The colocated engine
        overrides this to 0: routed messages carry raw index lanes
        between rows, which is only sound under one shared base."""
        # committed bounds the base, NOT first_index: the device only
        # holds the [last-W+1, last] ring, so a shifted first_index lane
        # may legitimately go negative (uniform shift keeps every
        # comparison exact); an uncompacted log whose retained span
        # itself exceeds int32 is rejected by the planner's spread guard
        qs = [r.log.committed]
        if r.role == RaftRole.LEADER:
            # per-peer progress lanes are live state only on a leader;
            # followers carry stale values (e.g. next=1 from boot) that
            # get reset at the next election — including those would pin
            # the base at 0 forever.  Stale non-leader lanes clamp to the
            # 0 sentinel at upload instead (state_from_rafts).
            for group in (r.remotes, r.non_votings, r.witnesses):
                for rm in group.values():
                    if rm.match > 0:
                        qs.append(rm.match - 1)
                    if rm.next > 0:
                        qs.append(rm.next - 1)
                    if rm.snapshot_index > 0:
                        qs.append(rm.snapshot_index - 1)
        base = max(0, min(qs))
        return base - (base % self.W)

    def _static_host_only(self, node) -> bool:
        """Shards that can never (currently) be device-resident — checked
        BEFORE attaching a row or consuming quiesce state."""
        r = node.peer.raft
        if len(r.addresses) > self.P:
            return True
        if r.is_self_removed():
            # mid-join (empty membership) or removed: the kernel derives
            # the replica's tier from its own peer slot, which doesn't
            # exist yet/anymore — scalar path until membership settles
            return True
        return False

    def _attach(self, node) -> Optional[int]:
        g = self._row_of.get(self._row_key(node))
        if g is not None:
            return g
        if not self._free:
            if not self._warned_full:
                self._warned_full = True
                _log.warning(
                    "vector engine at capacity %d; overflow shards stay on "
                    "the host path",
                    self.capacity,
                )
            return None
        g = self._pick_row(node)
        self._row_of[self._row_key(node)] = g
        self._meta[g] = _RowMeta(node, self._lanes, g)
        return g

    def _pick_row(self, node) -> int:
        """Pop a free row slot.  The base policy is the free-list order
        (striped across device blocks in mesh mode); the colocated
        engine overrides with shard affinity — see its _pick_row."""
        return self._free.pop()

    def device_coordinate(self, shard_id: int):
        """Device block hosting this shard's row under the placement
        contract (ops/placement.py), or None when unknown / no mesh —
        the balance plane's chip-placement dimension."""
        if self._mesh is None:
            return None
        g = self._row_of.get(shard_id)
        if g is None:
            return None
        return g // (self.capacity // self._mesh.size)

    def device_chip_count(self) -> int:
        """Chips this engine spreads rows over (1 = single device)."""
        return self._mesh.size if self._mesh is not None else 1

    # ------------------------------------------------------------------
    # classification
    # ------------------------------------------------------------------
    def _plan_device(
        self, node, si, mirror_leader: bool, g: int
    ) -> Optional[List[Tuple]]:
        """Return the ordered inbox slot plan, or None for the host path.

        Slot order mirrors the scalar replay order in
        ``Node.step_with_inputs``: received messages, proposals,
        read-indexes, ticks.  Reads stay on the device only when the
        row's mirror says LEADER (the kernel's ReadIndex hot path); a
        stale mirror is safe — the kernel reject-resps and the client
        retries.

        Quiesce (reference: quiesceManager [U]) runs host-side even for
        device rows: quiesced ticks simply produce no TICK slots, so an
        idle shard's device row is never touched — the TPU equivalent of
        "millions of idle groups cost nothing".  Exiting quiesce needs
        the scalar poke path (LEADER_HEARTBEAT), so that step goes host.
        """
        if (
            si.config_changes
            or si.cc_results
            or si.snapshot_reqs
            or si.transfers
        ):
            return None
        inj = self.fault_injector
        if (
            inj is not None
            and self._consume_engine_fault_at_plan
            and getattr(inj, "has_active", lambda k: True)("escalate")
            and inj.on_engine_step(node.shard_id, node.replica_id)
        ):
            return None  # nemesis: forced scalar excursion for this row
        if si.read_indexes and not mirror_leader:
            return None
        if node in self._save_quarantine:
            return None  # WAL faulting: scalar path is save-before-send
        meta = self._meta.get(g)
        if meta is not None and meta.esc_hold > 0:
            meta.esc_hold -= 1
            return None  # post-escalation scalar hold (see _RowMeta)
        if node.quiesce.enabled:
            # QUIESCE enter-hints never touch raft state (node.py applies
            # them via quiesce_hint() only) — consume them HERE instead
            # of bouncing the row to the scalar path: at 10k shards the
            # post-election quiesce wave otherwise broadcasts a cold
            # wire type to every peer of every quiescing shard (~P x
            # shards host excursions + re-uploads).  Safe
            # against the host-fallback double-processing rule: hints
            # are removed from si.received, and the scalar step's only
            # handling of them is the same quiesce_hint() call.
            kept = []
            for m in si.received:
                if int(m.type) == int(MessageType.QUIESCE):
                    # no-leader gate (see QuiesceManager.tick block=):
                    # joining a peer's quiesce while this node knows no
                    # leader can park a shard mid-election
                    leader = (
                        node.peer.raft.leader_id
                        if self._meta[g].dirty
                        else int(self._mirror[_R_LEADER, g])
                    )
                    if leader:
                        node.quiesce.quiesce_hint()
                else:
                    kept.append(m)
            si.received = kept
        if node.quiesce.enabled and node.quiesce.is_quiesced() and (
            si.received or si.proposals
        ):
            # activity exits quiesce; peers must be poked — scalar path
            # (quiesce state deliberately untouched: step_with_inputs
            # re-processes these inputs and performs the exit + poke)
            return None
        r = node.peer.raft
        if r.read_index.pending or r.read_index.queue:
            return None
        if r.snapshotting:
            return None
        lim = 2**31 - 1
        # index lanes are REBASED per row (see _compute_base), so log
        # growth never ages a row off the device; the remaining int32
        # ceilings are terms (2^31 elections is out of scope — the row
        # falls back loudly below) and a pathological >2^31 spread
        # between a row's lowest live index quantity and its last index
        if self._meta[g].dirty:
            base = self._compute_base(r)
            self._base[g] = base
        else:
            base = int(self._base[g])
        if r.term >= lim:
            if not getattr(r, "_term_lim_warned", False):
                r._term_lim_warned = True
                _log.warning(
                    "[%d:%d] term %d exceeds the device int32 lane; "
                    "scalar path permanently",
                    r.shard_id, r.replica_id, r.term,
                )
            return None
        if r.log.last_index() - base + self.M * self.E >= lim:
            return None
        if base - r.log.first_index() >= lim:
            return None  # >2^31 retained-but-uncompacted span
        for group in (r.remotes, r.non_votings, r.witnesses):
            for rm in group.values():
                if (
                    rm.state == RemoteState.SNAPSHOT
                    and 0 < rm.snapshot_index <= base
                ):
                    # a below-base snapshot install is in flight: the
                    # device lane can't represent it (see
                    # _send_snapshots), so the row stays scalar until
                    # SnapshotStatus/Received resolves the transfer —
                    # otherwise re-uploads would re-fire need_snapshot
                    # and stream duplicate full snapshots every cycle
                    return None
        slots: List[Tuple] = []
        for m in si.received:
            if int(m.type) not in _HOT_SET:
                return None
            if int(m.type) == int(MessageType.READ_INDEX):
                # a follower-FORWARDED read: the kernel's hot path only
                # answers to self, so the wire response to the origin
                # must come from the scalar leader (host path) — device
                # handling would silently swallow the follower's read
                return None
            if len(m.entries) > self.E:
                return None
            # index fields enter the device rebased; ctx keys (hint on
            # heartbeat/read slots) are 64-bit-split and checked raw, but
            # a reject hint IS an index and shifts with the base
            if int(m.type) == int(MessageType.REPLICATE_RESP) and m.reject:
                h = m.hint - base
                if base and h <= 0:
                    # the follower's last index sits BELOW this row's
                    # base: the kernel's decrease floor (max(..., 1) in
                    # rebased space) cannot walk next under the base, so
                    # the scalar path must handle this rejection — it
                    # decreases in absolute space and the next upload
                    # recomputes a base low enough for the lagging peer
                    return None
            else:
                h = m.hint
            if (
                m.term > lim
                or m.log_term > lim
                or not -lim < m.log_index - base < lim
                or not -lim < m.commit - base < lim
                or not -lim < h < lim
                or m.hint_high > lim
            ):
                return None
            slots.append(("msg", m))
        E = self.E
        props = si.proposals
        for i in range(0, len(props), E):
            slots.append(("prop", props[i : i + E]))
        for ctx in si.read_indexes:
            slots.append(("read", ctx))
        # conservative capacity check BEFORE consuming quiesce state so a
        # host fallback never double-processes ticks/activity
        if len(slots) > self.M:
            return None
        # multi-tick fusion: ALL of a row's drained ticks ride one
        # count-carrying LOCAL_TICK slot (kernel._tick advances timers
        # by n).  The count cap mirrors the scalar step's half-election-
        # window gulp limit — at most one timer threshold crossing per
        # launch, so a stalled row can't replay several CheckQuorum/
        # election windows back-to-back with no wall time for responses.
        # Overflow ticks are DEFERRED (the logical clock briefly lags;
        # reference: dragonboat coalesces LocalTick bursts [U]).
        cap = max(1, r.election_timeout // 2)
        if si.ticks > cap:
            node.defer_ticks(si.ticks - cap)
            si.ticks = cap
        if si.ticks and len(slots) >= self.M:
            # every slot taken by messages/proposals: defer the ticks
            # rather than bouncing the row off the device
            node.defer_ticks(si.ticks)
            si.ticks = 0
        ticks = si.ticks
        if node.quiesce.enabled:
            # committed to the device path now: record (non-exiting)
            # activity and swallow quiesced ticks — a quiesced row gets
            # no TICK slots, so its device state is never touched.
            # (QUIESCE enter-hints are a cold type and never reach here.)
            for m in si.received:
                node.quiesce.record_activity(m.type)
            if si.proposals:
                node.quiesce.record_activity(MessageType.PROPOSE)
            ticks = 0
            if self._meta[g].dirty:
                busy = node.peer.raft.catching_up_peers()
                no_leader = node.peer.raft.leader_id == 0
            else:
                busy = bool(self._behind[g])
                no_leader = int(self._mirror[_R_LEADER, g]) == 0
            was_quiesced = node.quiesce.quiesced
            ticks += node.quiesce.tick_n(
                si.ticks, busy=busy, block=no_leader
            )
            if node.quiesce.quiesced and not was_quiesced:
                node.broadcast_quiesce_enter()
        if ticks:
            slots.append(("tick", ticks))
        return slots

    # ------------------------------------------------------------------
    # device <-> scalar state movement
    # ------------------------------------------------------------------
    def _upload_rows(self, rows: List[Tuple[int, "Raft"]]) -> None:
        """Scalar -> device for dirty rows (batched scatter)."""
        if not rows:
            return
        import time as _time

        _t0 = _time.perf_counter()
        for _, r in rows:
            if r.role == RaftRole.LEADER and r.check_quorum:
                self._cq_grace(r)
        bases = [int(self._base[g]) for g, _ in rows]
        # padding happens in numpy INSIDE state_from_rafts: one upload
        # copy per field
        sub = S.state_from_rafts(
            [r for _, r in rows], self.P, self.W, bases=bases,
            pad_to=_bucket(len(rows)),
        )
        self.stats["uploaded_rows"] = (
            self.stats.get("uploaded_rows", 0) + len(rows)
        )
        # float ms: mass start streams thousands of sub-ms batches and
        # int truncation would hide exactly the cost this counter exists
        # to expose
        self.stats["t_up_pack_ms"] = self.stats.get(
            "t_up_pack_ms", 0
        ) + (_time.perf_counter() - _t0) * 1000.0
        _t0 = _time.perf_counter()
        self._state = self._scatter_state(
            self._state, [g for g, _ in rows], sub)
        self.stats["t_up_scatter_ms"] = self.stats.get(
            "t_up_scatter_ms", 0
        ) + (_time.perf_counter() - _t0) * 1000.0
        for k, (g, r) in enumerate(rows):
            # the mirror holds what the DEVICE holds: index rows shifted
            self._mirror[_R_TERM, g] = r.term
            self._mirror[_R_VOTE, g] = r.vote
            self._mirror[_R_COMMIT, g] = r.log.committed - self._base[g]
            self._mirror[_R_LEADER, g] = r.leader_id
            self._mirror[_R_ROLE, g] = int(r.role)
            self._mirror[_R_LAST, g] = r.log.last_index() - self._base[g]
            # update lanes hold the ABSOLUTE frame (rebases never
            # perturb them); the scalar raft is authoritative at upload
            self._ulanes.seed_row(
                g, r.term, r.vote, r.log.committed, r.leader_id,
                int(r.role), r.log.last_index(),
            )
            # lane-diff leader notifications (U_LEADER) assume the node
            # view is in sync with the raft at seed time; the scalar
            # path's own _check_leader_change keeps it so, but a join/
            # restore can upload before the first scalar step ran
            node = self._meta[g].node
            if node.leader_id != r.leader_id:
                node._check_leader_change()
            # hard-state lane slot + db index (the ILogDB optional slot
            # protocol): resolved once per upload so the merge tail's
            # state-only persist is a pure array scatter per LogDB
            db = node.logdb
            get_slot = getattr(db, "state_lane_slot", None)
            if get_slot is not None:
                s = node.hs_lane_slot
                if s < 0:
                    s = get_slot(node.shard_id, node.replica_id)
                    node.hs_lane_slot = s
                self._lane_slot[g] = s
                for di, d in enumerate(self._lane_dbs):
                    if d is db:
                        break
                else:
                    self._lane_dbs.append(db)
                    di = len(self._lane_dbs) - 1
                self._lane_dbi[g] = di
            else:
                self._lane_slot[g] = -1
                self._lane_dbi[g] = -1
            # lease evidence lanes follow device residency (ROADMAP 4b)
            if r.role == RaftRole.LEADER and r.check_quorum:
                self._lease.arm(g, r.election_timeout, r.election_tick)
            else:
                self._lease.disarm(g)
            self._meta[g].dirty = False
            # the scalar excursion may have changed the static plan
            # facts (term, log span, remotes); require a fresh full
            # plan before the fast tick lane re-engages
            self._meta[g].plan_ok = False

    def _materialize_rows(
        self, gs: List[int], state: Optional[DeviceState] = None
    ) -> None:
        """Device -> scalar for rows leaving the device (batched gather).

        Copies the protocol fields the device owns; scalar-only state
        (ReadIndex table, sessions, is_leader_transfer_target) was never
        touched by the device path and stays as-is.
        """
        if not gs:
            return
        st = state if state is not None else self._state
        sub = self._gather_state(st, gs)
        for k, g in enumerate(gs):
            self._lease.disarm(g)  # scalar path re-arms at next upload
            node = self._meta[g].node
            base = int(self._base[g])
            if node.device_reads.has_pending():
                # the scalar path takes over: device-read confirmations
                # ride device steps and would never arrive — fail fast
                # so clients retry on the host path
                node.drop_device_reads()
            r = node.peer.raft
            r.term = int(sub.term[k])
            r.vote = int(sub.vote[k])
            r.leader_id = int(sub.leader_id[k])
            r.role = RaftRole(int(sub.role[k]))
            r.log.committed = int(sub.committed[k]) + base
            r.election_tick = int(sub.election_tick[k])
            r.heartbeat_tick = int(sub.heartbeat_tick[k])
            r.randomized_election_timeout = int(sub.rand_timeout[k])
            r._timeout_seq = int(sub.timeout_seq[k])
            r.pending_config_change = bool(sub.pending_cc[k])
            r.leader_transfer_target = int(sub.transfer_target[k])
            votes = {}
            for p in range(self.P):
                pid = int(sub.peer_id[k, p])
                if pid == 0:
                    continue
                rm = r.get_remote(pid)
                if rm is None:
                    continue
                m_ = int(sub.match[k, p])
                n_ = int(sub.next_idx[k, p])
                s_ = int(sub.snap_index[k, p])
                rm.match = m_ + base if m_ > 0 else m_
                rm.next = n_ + base if n_ > 0 else n_
                rm.state = RemoteState(int(sub.rstate[k, p]))
                rm.snapshot_index = s_ + base if s_ > 0 else s_
                rm.active = bool(sub.active[k, p])
                granted = int(sub.granted[k, p])
                if granted:
                    votes[pid] = granted == 1
            r.votes = votes
            if r.role == RaftRole.LEADER and r.check_quorum:
                self._cq_grace(r)  # sheared window — see _cq_grace
            dev_last = int(sub.last_index[k]) + base
            host_last = r.log.last_index()
            if dev_last != host_last:
                # the reconstruction invariant broke: the host log no
                # longer mirrors the rows the device stepped, so any
                # further ack could be for an entry the WAL never saw.
                # Halt the replica loudly, like the snapshot-recovery
                # failure path in node.py (reference: dragonboat panics
                # on unrecoverable state [U]).
                _log.critical(
                    "[%d:%d] FATAL: device/host log divergence: device "
                    "last=%d host last=%d; halting replica",
                    r.shard_id,
                    r.replica_id,
                    dev_last,
                    host_last,
                )
                self._halt_replica(g)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def step_shards(self, nodes, worker_id: int) -> None:
        """Per-node structures are safe without the engine lock — the
        ExecEngine partitions shards over workers, so each node is only
        ever stepped by its owning worker.  The lock guards the shared
        device state (self._state, row tables, mirrors); host-path scalar
        stepping and save/process run outside it so a slow cold shard
        cannot stall the other workers' partitions."""
        updates: List[Tuple] = []  # (node, Update)
        host_rows: List[Tuple] = []  # (node, si)
        batch: List[Tuple] = []  # (node, g, si, plan)
        with self._lock:
            for node in nodes:
                if node.stopped:
                    continue
                si = node.drain_step_inputs()
                # row attachment must precede planning: _plan_device
                # consumes quiesce ticks once committed to the device
                # path, and a post-plan capacity fallback would make the
                # host path re-process them
                if self._static_host_only(node):
                    host_rows.append((node, si))
                    continue
                g = self._attach(node)
                if g is None:
                    host_rows.append((node, si))
                    continue
                mirror_leader = (
                    not self._meta[g].dirty
                    and self._mirror[_R_ROLE, g] == int(RaftRole.LEADER)
                )
                plan = self._plan_device(node, si, mirror_leader, g)
                if plan is None:
                    host_rows.append((node, si))
                    continue
                if not plan and not self._meta[g].dirty:
                    # nothing for the device, but the logical clock still
                    # advanced: a quiesced row's swallowed ticks must GC
                    # pending futures exactly like the scalar loop does
                    _tick_bookkeeping(node, si.ticks + si.gc_ticks)
                    continue
                batch.append((node, g, si, plan))

            # cold rows leave the device before their scalar step
            to_mat = []
            for node, si in host_rows:
                g = self._row_of.get(self._row_key(node))
                if g is not None and not self._meta[g].dirty:
                    to_mat.append(g)
                    self._meta[g].dirty = True
            self._materialize_rows(to_mat)  # one batched gather for all

        # ---- host path (cold rows; engine lock released) -------------
        for node, si in host_rows:
            if node.stopped:  # e.g. halted by a divergence fail-stop
                continue
            u = node.step_with_inputs(si)
            self.stats["host_rows_stepped"] += 1
            if u is not None:
                updates.append((node, u))

        # ---- device path ---------------------------------------------
        lane_rows: List[Tuple] = []
        lane_batches: List[Tuple] = []
        if batch:
            with self._lock, self._device_lock:
                # re-validate: a concurrent detach() (stop_replica) may
                # have freed — or freed and re-assigned — a row between
                # the lock sections
                batch = [
                    (node, g, si, plan)
                    for node, g, si, plan in batch
                    if self._row_of.get(self._row_key(node)) == g
                    and self._meta.get(g) is not None
                    and self._meta[g].node is node
                    and not node.stopped
                ]
                self._upload_rows(
                    [
                        (g, node.peer.raft)
                        for node, g, si, plan in batch
                        if self._meta[g].dirty
                    ]
                )
                if batch:
                    updates.extend(self._device_step(batch))
                    # this worker's lane rows, swapped out under the
                    # same lock hold (each worker persists only its own)
                    lane_rows, self._lane_pending = (
                        self._lane_pending, []
                    )
                    lane_batches, self._lane_pending_arr = (
                        self._lane_pending_arr, []
                    )

        # lane persist FIRST: it advances the processed cursors, so a
        # retrying node's get_update below re-emits only the remainder
        self._persist_lane_batches(lane_batches, worker_id)
        self._persist_lane_rows(lane_rows, worker_id)
        self._drain_update_retries(updates, owned={id(n) for n in nodes})
        if updates:
            self._persist_and_process(updates, worker_id)

    def _drain_update_retries(self, updates, owned=None) -> None:
        """Re-emit updates for nodes whose last batched save failed.
        ``owned`` restricts the drain to nodes this worker may touch
        (the ExecEngine partitions shards over workers); unrestricted
        callers (the colocated engine, which owns everything under its
        core lock) pass None."""
        with self._retry_lock:
            # prune stopped nodes from both sets: a killed member's dead
            # Node object must not be leaked (or consulted) forever
            self._save_quarantine = {
                n for n in self._save_quarantine if not n.stopped
            }
            self._update_retry = {
                n for n in self._update_retry if not n.stopped
            }
            if not self._update_retry:
                return
            if owned is None:
                retry, self._update_retry = self._update_retry, set()
            else:
                retry = {n for n in self._update_retry if id(n) in owned}
                self._update_retry -= retry
        have = {id(n) for n, _ in updates}
        for node in retry:
            if node.stopped or id(node) in have:
                continue
            u = node.peer.get_update(last_applied=node.sm.last_applied)
            if u is not None:
                node.dispatch_dropped(u)
                updates.append((node, u))

    def _demote_row_to_host(self, node) -> None:
        """Pull a resident row back to scalar authority with a short
        hold — used when the device path hits something only the full
        host log can resolve (e.g. a below-ring send whose prev index
        the host has compacted)."""
        g = self._row_of.get(self._row_key(node))
        if g is None:
            return
        meta = self._meta.get(g)
        if meta is None or meta.dirty:
            return
        self._materialize_rows([g])
        meta.dirty = True
        meta.set_escalation_hold(node.config)

    def _persist_and_process(self, updates, worker_id: int) -> None:
        """save -> send/apply with per-LogDB fault isolation.  A failed
        batched save loses nothing: peer.commit(u) never ran for those
        nodes, so their entries/commits re-emit via _drain_update_retries
        on a later step; other LogDBs' batches still save and process
        (one member's disk fault must not stall the cluster)."""
        by_db: Dict[int, Tuple] = {}
        for node, u in updates:
            by_db.setdefault(id(node.logdb), (node.logdb, []))[1].append(
                (node, u)
            )
        for db, pairs in by_db.values():
            try:
                db.save_raft_state([u for _, u in pairs], worker_id)
            except Exception:  # noqa: BLE001
                self.stats["save_failures"] += 1
                _log.exception(
                    "batched save failed for %d update(s); will re-emit",
                    len(pairs),
                )
                self._on_save_failure(pairs)
                continue
            self._on_save_ok(pairs)
            for node, u in pairs:
                if node.process_update(u):
                    node.engine_apply_ready(node.shard_id)

    def _persist_lane_batches(self, batches, worker_id: int) -> None:
        """Array-batched persist for slot-backed lane rows: one
        ``save_state_slots`` scatter per LogDB, zero per-row Python on
        the state-only success path.  ``batches`` entries are ``(db,
        slots, terms, votes, commits, live, js, applies)`` — the node
        list is materialized from ``live[j]`` ONLY on a save failure
        (re-emit + quarantine, the _persist_and_process contract) or
        while a quarantine is active.  ``applies`` carries the batch's
        commit rows' ``(node, committed-entries)`` handoffs; they run
        strictly AFTER the batch's save lands (peer.commit's
        persist-before-apply order) and not at all on failure — the
        failed rows re-emit classic updates with cursors untouched.
        Same ordering contract as _persist_lane_rows: runs before this
        step's _drain_update_retries."""
        if not batches:
            return
        n = 0
        n_commit = 0
        handoffs: List[Tuple] = []
        for db, slots, terms, votes, commits, live, js, applies \
                in batches:
            n += len(slots)
            try:
                db.save_state_slots(slots, terms, votes, commits,
                                    worker_id)
            except Exception:  # noqa: BLE001
                self.stats["save_failures"] += 1
                _log.exception(
                    "batched slot save failed for %d row(s); will "
                    "re-emit",
                    len(slots),
                )
                self._on_save_failure(
                    [(live[j][0], None) for j in js.tolist()]
                )
                continue
            if self._save_quarantine:
                self._on_save_ok(
                    [(live[j][0], None) for j in js.tolist()]
                )
            # collected, not applied inline: the whole generation's
            # commit rows hand off in ONE batched per-SM-worker pass
            # below (each row still strictly after ITS batch's save
            # landed — failed batches never reach this list)
            handoffs.extend(applies)
            n_commit += len(applies)
        _apply_lane_commits(handoffs)
        if n:
            self.stats["lane_rows"] = (
                self.stats.get("lane_rows", 0) + n
            )
        if n_commit:
            self.stats["lane_commit_rows"] = (
                self.stats.get("lane_commit_rows", 0) + n_commit
            )

    def _persist_lane_rows(self, rows, worker_id: int) -> None:
        """Persist + apply-handoff for LANE rows — the batched
        replacement for per-row save_raft_state/process_update/
        peer.commit on rows whose whole effect is a hard-state move
        and/or a commit advance.

        ``rows`` is a list of ``(node, term, vote, commit, ce)`` where
        ``ce`` is the row's committed-entries list (None when only the
        hard state moved).  One ``save_state_lanes`` call per LogDB
        persists every row's (term, vote, commit) triple; only then do
        commit rows hand their entries to the apply queue and advance
        the processed cursor — peer.commit's job, inlined: ``ce`` came
        from ``entries_to_apply(processed+1 .. committed+1)``, so the
        new processed is in (processed, committed] by construction
        (the commit_update guard, pre-verified).  A failed batched
        save advances NOTHING: the nodes re-emit classic full updates
        (state + the same committed entries, cursors untouched) via
        _drain_update_retries — exactly the _persist_and_process
        contract.  MUST run before this step's _drain_update_retries,
        or a retrying node's fresh get_update would collect entries a
        pending lane handoff is about to deliver too."""
        if not rows:
            return
        self.stats["lane_rows"] = (
            self.stats.get("lane_rows", 0) + len(rows)
        )
        by_db: Dict[int, Tuple] = {}
        for t in rows:
            db = t[0].logdb
            by_db.setdefault(id(db), (db, []))[1].append(t)
        n_commit = 0
        handoffs: List[Tuple] = []
        for db, rs in by_db.values():
            try:
                save_slots = getattr(db, "save_state_slots", None)
                if save_slots is not None:
                    # vectorized scatter by cached slot (the ILogDB
                    # optional slot protocol): slot resolution is a
                    # once-per-node event, the steady save is three
                    # numpy scatters under one lock hold
                    get_slot = db.state_lane_slot
                    slots = []
                    for t in rs:
                        node = t[0]
                        s = node.hs_lane_slot
                        if s < 0:
                            s = get_slot(node.shard_id, node.replica_id)
                            node.hs_lane_slot = s
                        slots.append(s)
                    save_slots(
                        slots,
                        [t[1] for t in rs],
                        [t[2] for t in rs],
                        [t[3] for t in rs],
                        worker_id,
                    )
                else:
                    db.save_state_lanes(
                        [t[0].shard_id for t in rs],
                        [t[0].replica_id for t in rs],
                        [t[1] for t in rs],
                        [t[2] for t in rs],
                        [t[3] for t in rs],
                        worker_id,
                    )
            except Exception:  # noqa: BLE001
                self.stats["save_failures"] += 1
                _log.exception(
                    "batched lane save failed for %d row(s); will "
                    "re-emit",
                    len(rs),
                )
                self._on_save_failure([(t[0], None) for t in rs])
                continue
            self._on_save_ok([(t[0], None) for t in rs])
            for node, _term, _vote, _commit, ce in rs:
                if not ce:
                    continue
                n_commit += 1
                handoffs.append((node, ce))
        _apply_lane_commits(handoffs)
        if n_commit:
            self.stats["lane_commit_rows"] = (
                self.stats.get("lane_commit_rows", 0) + n_commit
            )

    def _on_save_failure(self, pairs) -> None:
        """Queue re-emission and quarantine the nodes to the scalar
        path until a save succeeds (see _save_quarantine)."""
        with self._retry_lock:
            for node, _u in pairs:
                self._update_retry.add(node)
                self._save_quarantine.add(node)
        for node, _u in pairs:
            if node.notify_work is not None:
                node.notify_work()

    def _on_save_ok(self, pairs) -> None:
        if not self._save_quarantine:
            return
        with self._retry_lock:
            for node, _u in pairs:
                self._save_quarantine.discard(node)

    def _encode_batch(self, batch, slot_offset: int = 0):
        """Plans -> (per-row Message lists, staging, proposal rows).

        Shared by the base and colocated device steps: slot order mirrors
        the scalar replay order; staged payload entries are keyed by slot
        for the post-step append reconstruction; ``prop_rows`` marks rows
        whose slot_base detail must be gathered (local 'prop' slots AND
        wire PROPOSE messages — a forwarded proposal arriving at the
        leader carries staged entries too).

        ``slot_offset`` shifts staging keys to ASSEMBLED slot indices:
        the colocated engine prepends its routed regions (width P*B)
        before the host slots, and the kernel reports slot_base/
        ent_drop/src_slot in assembled coordinates.

        ``tick_fed`` (4th return, row -> fused tick count) is the
        device-window mirror input for the lease evidence lanes
        (hostplane.LeaseLanes.row_step)."""
        msg_rows: List[List[Message]] = [[] for _ in range(self.capacity)]
        staging: Dict[int, Dict[int, List[Entry]]] = {}
        prop_rows: List[int] = []
        tick_fed: Dict[int, int] = {}
        for node, g, si, plan in batch:
            row_msgs = msg_rows[g]
            stage: Dict[int, List[Entry]] = {}
            base = int(self._base[g])
            for plan_slot, (kind, payload) in enumerate(plan):
                slot = slot_offset + plan_slot
                if kind == "msg":
                    if payload.entries:
                        stage[slot] = list(payload.entries)
                    row_msgs.append(_shift_msg_indexes(payload, -base))
                elif kind == "prop":
                    row_msgs.append(
                        Message(
                            type=MessageType.PROPOSE,
                            entries=tuple(payload),
                        )
                    )
                    stage[slot] = list(payload)
                elif kind == "read":
                    self.stats["device_reads"] += 1
                    row_msgs.append(
                        Message(
                            type=MessageType.READ_INDEX,
                            hint=payload.low,
                            hint_high=payload.high,
                        )
                    )
                else:  # tick — log_index carries the fused count; hint
                    # lanes carry the latest pending read ctx so lost
                    # confirmations retry on the heartbeat cadence
                    tick_fed[g] = payload
                    pc = node.device_reads.peek_ctx()
                    row_msgs.append(
                        Message(
                            type=MessageType.LOCAL_TICK,
                            log_index=payload,
                            hint=pc.low if pc else 0,
                            hint_high=pc.high if pc else 0,
                        )
                    )
            if stage:
                staging[g] = stage
            if any(k == "prop" for k, _ in plan) or any(
                k == "msg" and int(p.type) == int(MessageType.PROPOSE)
                for k, p in plan
            ):
                prop_rows.append(g)
        return msg_rows, staging, prop_rows, tick_fed

    def _parity_fail(self, what: str) -> None:
        """Count and latch a parity mismatch, then raise."""
        msg = (
            f"parity: {what} differs from the plain version at device "
            f"step {self.stats['device_steps']}"
        )
        self.stats["parity_failures"] += 1
        if self.parity_failure is None:
            self.parity_failure = msg
        raise AssertionError(msg)

    def _move_rows(self, fn, *args) -> DeviceState:
        """Run the row mover ``fn`` (``_scatter_rows``, ``_select_rows``,
        ``_gather_rows`` or ``_set_remote_snapshot``); with
        ``parity_every`` on, run it again through the plain version and
        require bit equality on every field."""
        got = fn(*args)
        if self._parity_every > 0:
            self.stats["parity_row_attempts"] += 1
            want = fn(*args, impl=engine_ref)
            for f in DeviceState._fields:
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    self._parity_fail(f"{fn.__name__} state.{f}")
            self.stats["parity_checked_row_moves"] += 1
        return got

    def _parity_check(self, old_state, inbox, new_state, out, flags) -> None:
        """Re-run this launch's step and flag word through the plain
        PyTorch versions on the same device tensors, block by block, and
        require bit equality (``parity_every``); the readback is checked
        after the fetch (``_parity_check_readback``).  No kernel is
        launched here."""
        self.stats["parity_step_attempts"] += 1
        for d in range(self._blocks.D):
            old_d, new_d, out_d = (old_state.parts[d], new_state.parts[d],
                                   out.parts[d])
            ref_state, ref_out = kernel_ref.step(old_d, inbox.parts[d],
                                                 self.O)
            pairs = [
                (f"state.{f}", getattr(new_d, f), getattr(ref_state, f))
                for f in DeviceState._fields
            ] + [
                (f"out.{f}", getattr(out_d, f), getattr(ref_out, f))
                for f in DeviceOut._fields
            ]
            pairs.append((
                "flags", flags[d],
                engine_ref.summarize_flags(old_d, new_d, out_d),
            ))
            for name, got, want in pairs:
                if not torch.equal(got, want):
                    self._parity_fail(name)

    def _parity_check_readback(self, new_state, out, sets, sum_rows,
                               detail, vals_np) -> None:
        ref_detail, ref_vals = self._fetch(
            new_state.parts, out.parts, sets, sum_rows, self.M,
            pack=engine_ref.gather_pack,
        )
        same = (ref_detail is None) == (detail is None) and (
            detail is None
            or all(np.array_equal(a, b) for a, b in zip(detail, ref_detail))
        ) and (ref_vals is None) == (vals_np is None) and (
            vals_np is None or np.array_equal(vals_np, ref_vals)
        )
        if not same:
            self._parity_fail("readback pack")
        self.stats["parity_checked_launches"] += 1

    def _device_step(self, batch) -> List[Tuple]:  # mesh-hot
        G, M, E = self.capacity, self.M, self.E
        # wall-time breakdown of a launch (ms, cumulative): host encode,
        # the device step with its flag readback, the parity self-check,
        # the escalations' replay, the detail fetch, the merge tail
        t0 = time.perf_counter()
        msg_rows, staging, prop_rows, tick_fed = self._encode_batch(batch)
        inbox, overflow = S.encode_inbox(msg_rows, M, E)
        assert not overflow, f"planner let oversized rows through: {overflow}"
        t1 = time.perf_counter()
        inbox = self._put_rows(inbox)

        old_state = self._state
        from ..profiling import annotate

        with annotate("raft-device-step"):
            steps = [K.step(st, ib, out_capacity=self.O)
                     for st, ib in zip(old_state.parts, inbox.parts)]
            new_state = placement.Sharded(tuple(n for n, _ in steps))
            out = placement.Sharded(tuple(o for _, o in steps))
            flags_t = [_summarize_flags(*a) for a in zip(
                old_state.parts, new_state.parts, out.parts)]
            flags = self._blocks.numpy(flags_t)
        t_step = time.perf_counter()
        parity = (
            self._parity_every > 0
            and self.stats["device_steps"] % self._parity_every == 0
        )
        if parity:
            self._parity_check(old_state, inbox, new_state, out, flags_t)
        t_chk = time.perf_counter()
        inj = self.fault_injector
        if (
            inj is not None
            and not self._consume_engine_fault_at_plan
            and getattr(inj, "has_active", lambda k: True)("escalate")
        ):
            # nemesis: force the kernel-escalation recovery path for the
            # selected rows — their device effects are discarded below
            # exactly as for a real ESC_* escalation.  Take a copy to
            # flip bits in (only on the injected path — never in
            # production)
            flags = np.array(flags)
            for node, g, si, plan in batch:
                if not flags[g] & _F_ESC and inj.on_engine_step(
                    node.shard_id, node.replica_id
                ):
                    flags[g] |= _F_ESC
        self._behind = (flags & _F_PEERS_BEHIND) != 0
        self.stats["device_steps"] += 1
        self.stats["device_rows_stepped"] += len(batch)

        # ---- escalations: restore + scalar replay --------------------
        esc_rows = [
            (node, g, si)
            for node, g, si, plan in batch
            if flags[g] & _F_ESC
        ]
        updates: List[Tuple] = []
        if esc_rows:
            self.stats["escalations"] += len(esc_rows)
            keep_new = np.ones((G,), bool)
            for _, g, _ in esc_rows:
                keep_new[g] = False
            new_state = self._select_state(keep_new, old_state, new_state)
            self._materialize_rows([g for _, g, _ in esc_rows], old_state)
            for node, g, si in esc_rows:
                meta = self._meta.get(g)
                if meta is None:  # halted + detached during materialize
                    continue
                meta.dirty = True
                meta.set_escalation_hold(node.config)
                # quiesce note: _plan_device already consumed this step's
                # quiesce ticks; the replay re-ticks the manager, which can
                # only make the shard quiesce EARLIER — benign for a perf
                # heuristic that exits on any activity
                u = node.step_with_inputs(si)
                if u is not None:
                    updates.append((node, u))
        self._state = new_state
        esc_set = {g for _, g, _ in esc_rows}

        # ---- gather detail for affected rows (ONE fused dispatch: the
        # per-step latency floor is dispatch round-trips, which on remote
        # device links cost far more than the extra padded bytes) -------
        live = [(node, g, si) for node, g, si, plan in batch if g not in esc_set]
        buf_rows = [g for _, g, _ in live if flags[g] & _F_COUNT]
        append_rows = [g for _, g, _ in live if flags[g] & _F_APPEND]
        slot_rows = [g for g in prop_rows if g not in esc_set]
        need_rows = [g for _, g, _ in live if flags[g] & _F_NEED_SS]
        # rows whose VALUES the merge loop reads: anything flagged or
        # carrying proposal slots (the rest only tick)
        slot_set = set(slot_rows)
        sum_rows = [
            g for _, g, _ in live
            if (flags[g] & _F_ANY_LIVE) or g in slot_set
        ]
        sets = (buf_rows, slot_rows, need_rows, append_rows)
        t2 = time.perf_counter()
        detail, vals_np = self._fetch(new_state.parts, out.parts, sets,
                                      sum_rows, self.M)
        t3 = time.perf_counter()
        if parity:
            self._parity_check_readback(new_state, out, sets, sum_rows,
                                        detail, vals_np)
        t_chk2 = time.perf_counter()
        if detail is not None:
            (buf_np, slot_base, slot_term, ent_drop, need_np, ring_t,
             ring_c) = detail
        else:
            buf_np = slot_base = slot_term = ent_drop = need_np = None
            ring_t = ring_c = None
        buf_at = {g: k for k, g in enumerate(buf_rows)}
        ring_at = {g: k for k, g in enumerate(append_rows)}
        slot_at = {g: k for k, g in enumerate(slot_rows)}
        need_at = {g: k for k, g in enumerate(need_rows)}
        sum_at = {g: k for k, g in enumerate(sum_rows)}

        # ---- per-row update construction -----------------------------
        # A generation's effects classify ARRAY-SIDE first: one
        # plan_update_sync pass over the update lanes yields per-row
        # U_* effect bits, and rows with no heavy sections (append /
        # outbox / slot / snapshot-need) sync from the plan's words and
        # hand a (node, term, vote, commit, entries) LANE tuple to the
        # batched _persist_lane_rows — no per-row get_update object
        # walk, no per-row Update/State/UpdateCommit construction
        # (hostplane.UpdateLanes).  Heavy rows keep the
        # classic full-body merge.
        gs_live = np.asarray([g for _, g, _ in live], np.int64)
        vals_for_plan = (
            vals_np if vals_np is not None
            else np.zeros((1, N_VALS), np.int64)
        )
        ub_l = w_term = w_vote = w_com = w_lead = w_role = None
        so_mask = None
        if len(gs_live):
            uplan = _plan_lane_words(
                self._ulanes, self._base, gs_live, sum_rows,
                vals_for_plan, self.capacity, mirror=self._mirror,
            )
            ub_l = uplan.ubits.tolist()
            w_term = uplan.words[_R_TERM].tolist()
            w_vote = uplan.words[_R_VOTE].tolist()
            w_com = uplan.words[_R_COMMIT].tolist()
            w_lead = uplan.words[_R_LEADER].tolist()
            w_role = uplan.words[_R_ROLE].tolist()
            # rows eligible for the array-batched persist (hard-state
            # effect, no heavy sections, slot-backed store) classify
            # vectorized; the loop only CLEARS exceptions (residue
            # fallbacks).  Their persist is three scatters per LogDB
            # (_persist_lane_batches); commit rows additionally hand
            # (node, entries) to the post-save apply leg.
            so_mask = (uplan.ubits & (U_STATE | U_COMMIT)) != 0
            if so_mask.any():
                hv = np.zeros((self.capacity,), bool)
                if buf_rows:
                    hv[buf_rows] = True
                if slot_rows:
                    hv[slot_rows] = True
                if need_rows:
                    hv[need_rows] = True
                so_mask &= ~hv[gs_live]
                so_mask &= (flags[gs_live] & _F_APPEND) == 0
                so_mask &= self._lane_dbi[gs_live] >= 0
            so_l = so_mask.tolist()
        lane_rows = self._lane_pending
        lane_apply: List[Tuple] = []
        sum_get = sum_at.get
        # (g, p, lane-or-None, pid, ss_index) — see _send_snapshots
        snapshot_sends: List[Tuple[int, int, Optional[int], int, int]] = []
        for j, (node, g, si) in enumerate(live):
            r = node.peer.raft
            # PRE-launch clock for lease window starts: stamping after
            # bookkeeping would date a window up to half an election
            # window late (the fused tick count) and overstate the
            # lease by the same amount — the colocated _lease_pass
            # follows the same pre-bookkeeping contract
            now0 = node.tick_count
            # tick bookkeeping, inlined (mirrors Node.step_with_inputs
            # / _tick_bookkeeping: clock lockstep + hint-gated GC)
            t = si.ticks + si.gc_ticks
            if t:
                tc = now0 + t
                node.tick_count = tc
                r.tick_count += t
                if tc >= node.pending_deadline_hint[0]:
                    gc_tables(
                        node.pending_tables, node.pending_deadline_hint,
                        tc,
                    )
            k = sum_get(g, -1)
            if k < 0:
                # no flags, no slots: the row only ticked — but an
                # armed leader's window mirror still advances, and the
                # quorum-active flag may anchor the lease (ROADMAP 4b)
                a = self._lease.row_step(
                    g, tick_fed.get(g, 0), now0, int(flags[g])
                )
                if a >= 0:
                    r.anchor_quorum_evidence(a)
                continue
            ub = ub_l[j]
            term = w_term[j]
            vote = w_vote[j]
            committed = w_com[j]
            leader = w_lead[j]
            role = w_role[j]
            # lease lanes track role transitions observed at merge: an
            # on-device election win arms a FRESH window model
            # (election_tick reset to 0 by the kernel's _reset), any
            # other transition disarms.  U_ROLE is exactly the old
            # `role != mirror role` probe: lanes and mirror both seed
            # at upload and sync at every merge.
            if ub & U_ROLE:
                if role == ROLE_LEADER_I and r.check_quorum:
                    self._lease.arm(g, r.election_timeout, 0)
                else:
                    self._lease.disarm(g)
            a = self._lease.row_step(
                g, tick_fed.get(g, 0), now0, int(flags[g])
            )
            log = r.log
            appended = bool(flags[g] & _F_APPEND)
            if not (
                appended or g in buf_at or g in slot_at or g in need_at
            ):
                # ---- LANE row: no heavy sections ---------------------
                # NOTE: this residue-probe + U_*-application block is
                # intentionally OPEN-CODED in three places — here,
                # colocated._lane_commit_pass and the bench's
                # _lane_stage twin — because a shared per-row helper
                # (call/closure per row) costs exactly the altitude
                # this loop exists to remove.  Any semantic change
                # MUST land in all three; the bench's twin-population
                # raft-word + persisted-state equality is the
                # application-level drift detector.
                im = log.inmem
                if (
                    r.msgs or r.ready_to_reads or r.dropped_entries
                    or r.dropped_read_indexes or im.snapshot.index
                    or im.saved_to + 1 - im.marker < len(im.entries)
                ):
                    # scalar-side residue (a resident-clean row should
                    # never accumulate any — defense in depth): only
                    # the classic get_update walk drains it
                    r.term, r.vote, r.leader_id = term, vote, leader
                    r.role = _ROLE_OF[role]
                    if a >= 0:
                        r.anchor_quorum_evidence(a)
                    if committed > log.committed:
                        log.commit_to(committed)
                    if (
                        role != ROLE_LEADER_I
                        and node.device_reads.has_pending()
                    ):
                        node.drop_device_reads()
                    u = node.peer.get_update(
                        last_applied=node.sm.last_applied
                    )
                    node.dispatch_dropped(u)
                    updates.append((node, u))
                    node._check_leader_change()
                    so_mask[j] = False  # residue rows left the array path
                    continue
                if ub & U_STATE:
                    r.term = term
                    r.vote = vote
                if ub & U_LEADER:
                    r.leader_id = leader
                if ub & U_ROLE:
                    r.role = _ROLE_OF[role]
                if a >= 0:
                    r.anchor_quorum_evidence(a)  # post-sync role
                if ub & U_LOST_LEAD and node.device_reads.has_pending():
                    # leadership lost: confirmations will never arrive.
                    # U_LOST_LEAD is exact for lane rows: device reads
                    # only register off merged outbox messages (a heavy
                    # row by definition), so any pending read predates
                    # this sync — if the row is no longer leader, the
                    # losing transition is THIS generation's lane diff
                    # (docs/PARITY.md "Update-lane contract").
                    node.drop_device_reads()
                if ub & U_COMMIT:
                    log.commit_to(committed)
                    ce = log.entries_to_apply()
                    if so_l[j]:
                        # persist rides the array batch; entries hand
                        # off after that batch's save proves durable
                        lane_apply.append((j, node, ce))
                    else:
                        lane_rows.append(
                            (node, term, vote, committed, ce)
                        )
                elif ub & U_STATE and not so_l[j]:
                    # hard-state move without a slot-backed store:
                    # tuple form through save_state_lanes
                    lane_rows.append((node, term, vote, committed, None))
                if ub & U_LEADER:
                    node._check_leader_change()
                continue
            # ---- heavy row: the classic full-body merge --------------
            sv = vals_np[k]
            base = int(self._base[g])
            last = int(sv[_R_LAST]) + base
            # 1. append reconstruction
            if appended:
                self._merge_appends(
                    r,
                    g,
                    int(sv[_R_APPEND_LO]) + base,
                    last,
                    staging.get(g, {}),
                    slot_at.get(g, -1),
                    slot_base,
                    slot_term,
                    ent_drop,
                    ring_t[ring_at[g]],
                    ring_c[ring_at[g]],
                    base=base,
                )
            # 2. protocol scalar sync
            r.term, r.vote, r.leader_id = term, vote, leader
            r.role = _ROLE_OF[role]
            if a >= 0:
                r.anchor_quorum_evidence(a)  # post-sync: role is fresh
            if committed > r.log.committed:
                r.log.commit_to(committed)
            if (
                role != ROLE_LEADER_I
                and node.device_reads.has_pending()
            ):
                # leadership lost: confirmations will never arrive
                node.drop_device_reads()
            # 3. outbox -> messages with payload attachment
            if g in buf_at:
                self._attach_messages(
                    r,
                    node,
                    buf_np[buf_at[g]],
                    int(sv[_R_COUNT]),
                    staging.get(g, {}),
                    base=base,
                )
            # 4. dropped proposal slots / cc-gated entries -> futures
            if g in slot_at:
                sb = slot_base[slot_at[g]]
                drop = ent_drop[slot_at[g]]
                for slot, ents in staging.get(g, {}).items():
                    if sb[slot] == SLOT_DROPPED:
                        r.dropped_entries.extend(ents)
                    elif sb[slot] >= 0:
                        r.dropped_entries.extend(
                            e
                            for j2, e in enumerate(ents)
                            if drop[slot, j2]
                        )
            # 5. peers needing a snapshot stream
            if g in need_at:
                self._send_snapshots(
                    r, g, need_np[need_at[g]], snapshot_sends
                )
            u = node.peer.get_update(last_applied=node.sm.last_applied)
            node.dispatch_dropped(u)
            updates.append((node, u))
            node._check_leader_change()

        if so_mask is not None and so_mask.any():
            # array-batched persist: group the survivors by LogDB
            # through the db-index lane; node lists materialize lazily
            # (only on save failure / active quarantine); commit rows'
            # apply handoffs ride with their db's batch so entries
            # never reach the apply queue before their save lands
            js = np.nonzero(so_mask)[0]
            gs_so = gs_live[js]
            dbi = self._lane_dbi[gs_so]
            slots = self._lane_slot[gs_so]
            w = uplan.words
            app_by_db: Dict[int, List] = {}
            if lane_apply:
                dbi_all = self._lane_dbi
                for j, node, ce in lane_apply:
                    app_by_db.setdefault(
                        int(dbi_all[gs_live[j]]), []
                    ).append((node, ce))
            for d in np.unique(dbi).tolist():
                m = dbi == d
                jd = js[m]
                self._lane_pending_arr.append((
                    self._lane_dbs[d], slots[m], w[_R_TERM][jd],
                    w[_R_VOTE][jd], w[_R_COMMIT][jd], live, jd,
                    app_by_db.get(d, ()),
                ))

        lanes = [t for t in snapshot_sends if t[2] is not None]
        if lanes:
            self._state = self._snapshot_state(self._state, lanes)
        below = [t for t in snapshot_sends if t[2] is None]
        if below:
            # see _send_snapshots: these rows continue on the scalar path
            gs = sorted(
                {t[0] for t in below if self._meta.get(t[0]) is not None}
            )
            for g in gs:
                self._meta[g].dirty = True
            self._materialize_rows(gs)
            # mark the scalar remotes AFTER materialize (which overwrote
            # them from the device): the SNAPSHOT state both suppresses
            # probe spam and keeps the planner off the device path
            for g, p, _, pid, ss_index in below:
                meta = self._meta.get(g)
                if meta is None or meta.node.stopped:
                    continue
                rm = meta.node.peer.raft.get_remote(pid)
                if rm is not None:
                    rm.become_snapshot(ss_index)
        st = self.stats
        t4 = time.perf_counter()
        for k, v in (("t_encode_ms", t1 - t0), ("t_dev_step_ms", t_step - t1),
                     ("t_parity_ms", (t_chk - t_step) + (t_chk2 - t3)),
                     ("t_escalate_ms", t2 - t_chk), ("t_fetch_ms", t3 - t2),
                     ("t_merge_ms", t4 - t_chk2)):
            st[k] = st.get(k, 0.0) + v * 1000.0
        return updates

    # -- append reconstruction -----------------------------------------
    def _merge_appends(
        self,
        r: Raft,
        g: int,
        lo: int,
        last: int,
        stage: Dict[int, List[Entry]],
        slot_idx: int,
        slot_base,
        slot_term,
        ent_drop,
        ring_term_row,
        ring_cc_row,
        fallback=None,
        barrier: Optional[Tuple[int, int]] = None,
        base: int = 0,
    ) -> List[Entry]:
        # ``slot_idx`` is the row's position in the gathered slot
        # sections (-1 = the row carried no proposal slots) — an
        # index-array lookup the callers batch-compute, replacing the
        # old per-row `g in slot_at` dict probes (hostplane refactor)
        W = self.W
        # candidates[idx] = (slot_order, Entry, term); later slots win
        cand: Dict[int, List[Tuple[int, Entry, int]]] = {}
        sb = slot_base[slot_idx] if slot_idx >= 0 else None
        stm = slot_term[slot_idx] if slot_idx >= 0 else None
        drop = ent_drop[slot_idx] if slot_idx >= 0 else None
        for slot in sorted(stage):
            ents = stage[slot]
            if sb is not None and sb[slot] >= 0:
                # a PROPOSE slot accepted at pre-append index sb[slot]
                # (device-shifted; sentinels < 0 never shift)
                pos = int(sb[slot]) + base
                for j, e in enumerate(ents):
                    if drop is not None and drop[slot, j]:
                        continue
                    pos += 1
                    cand.setdefault(pos, []).append(
                        (slot, e, int(stm[slot]))
                    )
            elif ents and ents[0].index > 0:
                # REPLICATE payload: wire entries carry index+term
                for e in ents:
                    cand.setdefault(e.index, []).append((slot, e, e.term))
        stamped: List[Entry] = []
        for idx in range(lo, last + 1):
            rt = int(ring_term_row[idx & (W - 1)])
            pick: Optional[Tuple[int, Entry, int]] = None
            for c in cand.get(idx, ()):
                if c[2] == rt and (pick is None or c[0] >= pick[0]):
                    pick = c
            if pick is None and fallback is not None:
                # device-routed append: the payload never crossed this
                # host's wire — reconstruct from the colocated cache
                fe = fallback(r, idx, rt)
                if fe is not None:
                    pick = (-1, fe, rt)
            if pick is None:
                # become-leader noop barrier (the only unstaged append)
                if int(ring_cc_row[idx & (W - 1)]) != 0:
                    raise RuntimeError(
                        f"[{r.shard_id}:{r.replica_id}] unstaged config "
                        f"change at index {idx}"
                    )
                if fallback is not None and (
                    barrier is None
                    or idx != barrier[0]
                    or rt != barrier[1]
                ):
                    # routed-append mode: the ONLY legitimately unstaged
                    # append is the barrier this row self-appended this
                    # step (kernel-reported, valid even if the row then
                    # stepped down in the same step).  Anything else came
                    # over the device route and its payload is gone —
                    # stamping an empty noop would silently diverge the
                    # SM, so fail-stop (same policy as the last_index
                    # divergence halt).
                    raise RuntimeError(
                        f"[{r.shard_id}:{r.replica_id}] unreconstructible "
                        f"routed append at index {idx} (term {rt})"
                    )
                stamped.append(
                    Entry(term=rt, index=idx, type=EntryType.APPLICATION)
                )
            else:
                e = pick[1]
                stamped.append(
                    Entry(
                        term=rt,
                        index=idx,
                        type=e.type,
                        key=e.key,
                        client_id=e.client_id,
                        series_id=e.series_id,
                        responded_to=e.responded_to,
                        cmd=e.cmd,
                    )
                )
        r.log.inmem.merge(stamped)
        return stamped

    # -- outbox decode + payload attachment ----------------------------
    def _attach_messages(
        self,
        r: Raft,
        node,
        buf_row: np.ndarray,
        count: int,
        stage: Dict[int, List[Entry]],
        delivered_row: Optional[np.ndarray] = None,
        base: int = 0,
    ) -> None:
        shim = {"count": np.array([count]), "buf": buf_row[None]}
        for k, (msg, n_ent, src_slot) in enumerate(
            S.decode_out_row(shim, 0, r.shard_id, r.replica_id)
        ):
            if delivered_row is not None and delivered_row[k]:
                continue  # already scattered into a peer row on device
            msg = _shift_msg_indexes(msg, base)
            if (
                msg.type == MessageType.READ_INDEX_RESP
                and msg.to == r.replica_id
            ):
                # synthetic host-coordination message from the kernel's
                # ReadIndex hot path — never hits the wire
                node.handle_device_read_resp(msg)
                continue
            if msg.type == MessageType.REPLICATE and n_ent > 0:
                if msg.log_term == 0 and msg.log_index > 0:
                    # below-ring send (see kernel._send_replicate): the
                    # device couldn't resolve the prev term; stamp it
                    # from the authoritative log
                    try:
                        msg = dataclasses.replace(
                            msg, log_term=r.log.term(msg.log_index)
                        )
                    except Exception:  # noqa: BLE001
                        # prev compacted on the host: nothing below the
                        # ring is sendable and the device's next_idx
                        # already advanced — demote the row so the
                        # SCALAR path (full log + its own snapshot
                        # machinery) drives this follower; silently
                        # dropping starves it
                        self._demote_row_to_host(node)
                        continue
                ents = self._replicate_payload(r, msg, n_ent)
                if ents is None:
                    continue  # stale vs final log; dropping is raft-safe
                msg = dataclasses.replace(msg, entries=tuple(ents))
            elif msg.type == MessageType.PROPOSE and src_slot >= 0:
                msg = dataclasses.replace(
                    msg, entries=tuple(stage.get(src_slot, ()))
                )
            r.msgs.append(msg)

    def _replicate_payload(
        self, r: Raft, msg: Message, n_ent: int
    ) -> Optional[List[Entry]]:
        from ..raft.log import LogCompactedError, LogUnavailableError

        try:
            if msg.log_index > 0 and r.log.term(msg.log_index) != msg.log_term:
                return None
            ents = r.log._get_entries(
                msg.log_index + 1, msg.log_index + 1 + n_ent, 2**62
            )
        except (LogCompactedError, LogUnavailableError):
            return None
        if len(ents) != n_ent:
            return None
        if msg.to in r.witnesses:
            ents = [r._to_witness_entry(e) for e in ents]
        return ents

    # -- snapshot streaming kick-off -----------------------------------
    def _send_snapshots(
        self,
        r: Raft,
        g: int,
        need_row: np.ndarray,
        snapshot_sends: List[Tuple[int, int, Optional[int], int, int]],
    ) -> None:
        # snapshot_sends entries are (g, p, lane, pid, ss_index); lane is
        # None when the durable snapshot sits below the row's base (the
        # host-excursion path)
        d = self._blocks.block_of(g)  # small row fetch
        peer_ids = _to_np(
            self._state.parts[d].peer_id[g - d * self._blocks.per])
        ss = r.log.logdb.snapshot()
        for p in range(self.P):
            if not need_row[p]:
                continue
            pid = int(peer_ids[p])
            if pid == 0 or ss.is_empty():
                continue  # remote stays WAIT; retried via heartbeat resp
            send = ss
            if pid in r.witnesses:
                send = Snapshot(
                    index=ss.index,
                    term=ss.term,
                    membership=ss.membership,
                    dummy=True,
                    witness=True,
                    shard_id=r.shard_id,
                )
            r.msgs.append(
                Message(
                    type=MessageType.INSTALL_SNAPSHOT,
                    to=pid,
                    from_=r.replica_id,
                    shard_id=r.shard_id,
                    term=r.term,
                    snapshot=send,
                )
            )
            lane = ss.index - int(self._base[g])
            if lane <= 0:
                # the durable snapshot sits below this row's base (a
                # compacted leader whose retained window outruns the
                # snapshot): the int32 lane can't represent it, and a
                # zero/negative lane would corrupt the remote's snapshot
                # tracking.  The INSTALL message above still goes out
                # (absolute, host wire); the ROW takes a host excursion
                # and the scalar remote is marked SNAPSHOT after the
                # materialize (below) so the planner keeps the row off
                # the device until the install resolves — otherwise
                # every re-upload would re-fire need_snapshot and
                # stream a duplicate full snapshot.
                snapshot_sends.append((g, p, None, pid, ss.index))
                continue
            # the device's snap_index lane is rebased like every index
            snapshot_sends.append((g, p, lane, pid, ss.index))


def torch_step_engine_factory(
    capacity: int = 1024,
    P: int = 5,
    W: int = 32,
    M: int = 8,
    E: int = 4,
    O: int = 32,
    device=None,
    mesh=None,
    parity_every: int = 0,
):
    """ExpertConfig.step_engine_factory hook:

        expert.step_engine_factory = torch_step_engine_factory(capacity=2048)

    ``device`` defaults to the CUDA card (``placement.default_device``);
    pass ``device="cpu"`` for the plain PyTorch path.  ``mesh`` (a
    ``placement.GroupsMesh``, e.g. ``GroupsMesh(["cpu"] * 2)`` or
    ``GroupsMesh([cuda:0] * 4)``) spreads the rows over its devices'
    blocks instead (``TorchStepEngine``); capacity must divide over it.
    """

    def factory(nodehost):
        return TorchStepEngine(
            nodehost.logdb, capacity=capacity, P=P, W=W, M=M, E=E, O=O,
            device=device, mesh=mesh, parity_every=parity_every,
        )

    return factory
