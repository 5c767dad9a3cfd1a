"""Colocated-cluster mode: one device state shared by several NodeHosts.

Port of ``dragonboat_tpu/ops/colocated.py``.  The reference's step
workers hand every outbound message to the transport even when the peer
replica lives in the same process (reference: engine.go stepWorkerMain
-> transport.Send [U]).  When a whole cluster is colocated on one card
(multiple NodeHosts in one process — the production topology for the
BASELINE configurations 2-4), that detour is the scaling bottleneck.

``ColocatedEngineGroup`` is the product configuration that removes it:

    group = ColocatedEngineGroup(capacity=64, P=5, budget=2)
    for each NodeHost config:
        cfg.expert.step_engine_factory = group.factory

Every member NodeHost's step engine becomes a facade over ONE shared
``ColocatedTorchEngine``: all replicas live in one device state, and
``ops/route.py`` scatters each step's outbox straight into co-located
peers' inbox regions — elections, replication and commit advance run
device-side, while off-device peers (and host-only message classes)
fall back to the per-host transport unchanged (route's ``delivered``
mask tells the host which messages it still owns).

The device programs of a launch (top of this module) each dispatch to
their plain version (``colocated_ref.py``) for CPU tensors and to their
kernels for CUDA tensors: ``_assemble_and_step`` = CUDA ``inbox``
(assemble) + ``raft_step``; ``_route_step`` = ``merge_escalated``
(the in-place escalation merge) + ``route`` (with the delivered
bit-pack fused) + ``summarize_flags`` (with the undelivered override);
``_select_and_blob`` = ``select_and_blob`` + ``gather_pack`` (values);
``_host_inbox_from_ticks`` / ``_zero_inbox_rows`` = ``inbox``;
``_scatter_inbox_rows`` = ``place_rows``.

Payload reconstruction across replicas: device-routed REPLICATE carries
only (term, is-config-change) per entry — the cmd bytes never leave the
sending host.  Every stamped append is published to a shared per-shard
entry cache (bounded by the ring lifetime), and a receiving replica's
merge pulls payloads from the cache by (index, term).  A miss on a
non-leader row fail-stops the replica (see
``TorchStepEngine._merge_appends``) — silent empty entries would diverge
the SM.

Mesh mode (``ColocatedEngineGroup(mesh=GroupsMesh(...))``): the rows
are cut into the mesh's blocks (``placement.RowBlocks``) and every
program of a launch runs once a block on its device.  Each block routes
over its local view of the tables; a message toward another block rides
the cross-device lane as ``route.make_sharded_round`` runs it: the
block's route step packs it (``xlane_pack`` holds it to the receiver's
alive word, sets its delivered bit and rewrites the row's undelivered
word, before the flag word), ``ring_shift`` moves the lane buffers and
each block adds what it received into its pending regions.  The blocks'
blobs are read as one (``_round_head``), with the lane's counts folded
into the route stats, so the host sees exactly the single-device
engine's launch.  Rows are placed with the reference's striped free
list and shard affinity (``_pick_row``).

Readback: each round's (head, detail) blobs are copied with
``non_blocking=True`` into PINNED host buffers allocated for that
generation, and a ``torch.cuda.Event`` is recorded after the copies at
dispatch.  ``_collect_blob`` waits on the event before it reads a
buffer: a pinned buffer read before its copy completes holds stale rows
with no error.  The buffers belong to their in-flight record and are
never reused while it is in flight.

Concurrency: the colocated step holds the core lock end-to-end.  Member
NodeHosts keep their own ExecEngines, apply workers, LogDBs and
transports; only the step stage is fused.  A launch triggered by any
member steps EVERY resident row (routed traffic may target any of
them), and updates are persisted to each node's own LogDB before its
messages are dispatched (the reference's save -> send -> apply order).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import profiling
from ..engine.execengine import IStepEngine
from . import _native
from . import colocated_ref
from . import hostplane
from ..logger import get_logger
from ..node import StepInputs
from ..pb import Entry
from ..raft.raft import RaftRole
from ..request import gc_tables
from . import kernel as K
from . import placement
from . import plumbing
from . import sync as S
from .engine import (
    TorchStepEngine,
    _shift_msg_indexes,
    _F_APPEND,
    _F_PEERS_BEHIND,
    _R_APPEND_LO,
    _R_BARRIER_IDX,
    _R_BARRIER_TERM,
    _R_COMMIT,
    _R_COUNT,
    _R_LEADER,
    _R_ROLE,
    _R_TERM,
    _R_VOTE,
    _R_LAST,
    _ROLE_OF,
    _bucket,
    _pos_map,
    N_FIELDS_BUF,
    N_VALS,
    _tick_bookkeeping,
)
from .types import (
    ROLE_LEADER as _ROLE_LEADER_I,
    U_COMMIT,
    U_LEADER,
    U_LOST_LEAD,
    U_ROLE,
    U_STATE,
)
from .route import (
    build_route_tables,
    new_inbox,
    ring_shift,
    route_cuda,
    split_route_tables,
    xbudget_for,
    xlane_pack,
    xlane_scatter,
)
from .types import (
    I32,
    MT_TICK,
    SLOT_UNUSED as SLOT_UNUSED_I,
    DeviceState,
    Inbox,
    make_inbox,
)
from ..metrics import global_registry as _metrics

_log = get_logger("engine")

import os as _os

_DEBUG_LAUNCH = _os.environ.get("COLOC_DEBUG_LAUNCH", "") == "1"

# -- double-buffered generations (the launch pipeline) -----------------
# DRAGONBOAT_TPU_PIPELINE_DEPTH: how many generations may be in flight
# at once.  2 (the default) double-buffers: while generation N's blob
# readback is in flight, generation N+1 assembles, uploads and
# dispatches.  1 = the serial loop (dispatch, sync, merge, repeat).
_PIPE_DEPTH_DEFAULT = int(
    _os.environ.get("DRAGONBOAT_TPU_PIPELINE_DEPTH", "2") or 2
)
# DRAGONBOAT_TPU_SYNC_FLOOR_MS: simulated sync latency shim — a
# readback's data is not considered landed until <floor> ms after the
# D2H copy was REQUESTED.  Models a latency-floor link on the CPU:
# requests issued early (at dispatch) collect late for free, which is
# exactly what the pipeline exploits.
_SYNC_FLOOR_MS_DEFAULT = float(
    _os.environ.get("DRAGONBOAT_TPU_SYNC_FLOOR_MS", "0") or 0
)
# DRAGONBOAT_TPU_FUSED_ROUNDS: how many consecutive consensus rounds a
# routable generation chains device-side before its ONE readback (the
# fused commit wave).  3 (the default) is one full
# propose -> replicate/ack -> commit/deliver sequence.  1 disables
# fusing.
_FUSED_ROUNDS_DEFAULT = int(
    _os.environ.get("DRAGONBOAT_TPU_FUSED_ROUNDS", "3") or 3
)

# fast-lane invalidation margin: re-validate a row's int32 headroom via
# the full plan well before the hard 2^31 ceiling (margin >> M*E and
# any per-launch term burst)
_LIM_SOFT = 2**31 - 2**24


# per-launch [G, 4] host-upload lane assignments: every per-launch [G]
# host input rides ONE host-to-device copy
from .colocated_ref import (  # noqa: E402 — alias block
    C_ALIVE as _C_ALIVE,
    C_BATCH as _C_BATCH,
    C_PROP as _C_PROP,
    C_TICKS as _C_TICKS,
)


def _assemble_inbox(host: Inbox, pending: Inbox, combo) -> Inbox:
    """Concatenate the ROUTED regions first, then the host-encoded
    slots, zeroing rows that are not device-authoritative (alive lane 0:
    dirty / detached — a stale device row receiving traffic could
    double-vote).  Routed-first is the scalar replay order (received
    messages before proposals/reads/ticks).  CUDA ``inbox`` (assemble)."""
    if _native.on_cpu(combo, "assemble_inbox"):
        return colocated_ref.assemble_inbox(host, pending, combo)
    G, PB = pending.mtype.shape
    Mh, E = host.mtype.shape[1], host.ent_term.shape[2]
    flat, full = new_inbox(G, PB + Mh, E, combo.device)
    _native.launch("assemble_inbox", host, pending, combo, flat)
    return full


def _assemble_and_step(state, host: Inbox, pending: Inbox, combo,
                       *, out_capacity: int):
    """Inbox assembly + kernel step.  ``combo`` is the [G, 4] fused
    host-upload (see _C_*); the alive lane masks rows."""
    full = _assemble_inbox(host, pending, combo)
    return K.step(state, full, out_capacity=out_capacity)


def _route_step(old_state, new_state, out, dest, rank, combo,
                *, PB: int, E: int, budget: int,
                lane: Optional[colocated_ref.Lane] = None):
    """Post-launch tail: discard escalated rows' effects, route the
    outboxes into the next launch's pending regions (width P*budget,
    base=0 — host slots are prepended at the next assemble), and compute
    the per-row flag word + bit-packed delivered mask so the host reads
    back O(1)-width arrays instead of the full summary/delivered
    matrices.  Returns (merged, regions, stats [6], packed [G, nw] int32
    words of uint32 bits, flags).  Consumes ``new_state`` (the
    reference donates it): merged is new_state with the escalated rows
    put back in place.  On CUDA: ``merge_escalated`` (the in-place
    escalation merge), ``route`` (bit-pack and undelivered word fused),
    then ``summarize_flags`` with the undelivered F_COUNT override.

    ``lane``: a mesh block's lane operands (``colocated_ref.route_step``);
    the block's ``xlane_pack`` then runs between ``route`` and
    ``summarize_flags`` and the lane buffer and its [8] stats row are
    returned after the five."""
    if _native.on_cpu(combo, "route_step"):
        return colocated_ref.route_step(
            old_state, new_state, out, dest, rank, combo,
            PB=PB, E=E, budget=budget, lane=lane,
        )
    G, O = out.buf.shape[:2]
    dev = combo.device
    merged = DeviceState(*plumbing.merge_escalated(
        out.escalate, list(old_state), list(new_state)
    ))
    packed = torch.empty((G, (O + 31) // 32), dtype=I32, device=dev)
    undeliv = torch.empty((G,), dtype=I32, device=dev)
    regions, kstats, _ = route_cuda(
        merged, out, dest, rank, M=PB, E=E, budget=budget, base=0,
        suppress=out.escalate, alive=combo, alive_stride=4,
        packed=packed, undeliv=undeliv,
    )
    xlane = ()
    if lane is not None:
        xlane = xlane_pack(
            merged, out, lane.dest_local, lane.dest_dev, lane.rank,
            me=lane.me, n_dev=lane.n_dev, E=E, budget=budget,
            xbudget=lane.xbudget, suppress=out.escalate,
            dest_alive=lane.combo, alive_stride=4, packed=packed,
            undeliv=undeliv,
        )
    flags = plumbing.summarize_flags(old_state, merged, out, undeliv)
    return (merged, regions, kstats[:6], packed, flags) + tuple(xlane)


def _lane_scatter(regions: Inbox, recv, lane_stats, *, budget: int):
    """The lane's receiving half on a mesh block: the rows ``recv`` that
    the ring shifts brought (``route.ring_shift``) added into the block's
    pending regions in place, the count in ``lane_stats[1]``.  CUDA
    ``xlane_scatter``; CPU: ``colocated_ref.lane_scatter``."""
    if _native.on_cpu(recv, "lane_scatter"):
        return colocated_ref.lane_scatter(regions, recv, lane_stats,
                                          budget=budget)
    xlane_scatter(regions, recv, budget=budget, base=0, stats=lane_stats)
    return regions, lane_stats


# deterministic select-capacity ladder (clamped to G at use): three
# fixed tiers plus a storm tier; any count beyond the big tier falls
# back to the exact host-side gather for that launch.
_SEL_TIERS = (
    {"b": 16, "sl": 64, "n": 8, "a": 64, "s": 1024},
    {"b": 64, "sl": 1024, "n": 32, "a": 1024, "s": 16384},
    {"b": 256, "sl": 4096, "n": 64, "a": 4096, "s": 65536},
    # storm tier for scale geometries (mass-start elections append the
    # become-leader barrier on tens of thousands of rows per launch)
    {"b": 1024, "sl": 8192, "n": 256, "a": 32768, "s": 1 << 18},
)


# the five selected sections, in the head's order, and the section each
# of _parse_detail's seven arrays belongs to (buf; slot_base, slot_term,
# ent_drop; need; ring_term, ring_cc)
_SEL_KEYS = ("b", "sl", "n", "a", "s")
_DETAIL_SECTION = (0, 1, 1, 1, 2, 3, 3)


def _join_sections(parts, counts, cap: int) -> np.ndarray:
    """Each block's first ``counts[d]`` rows of ``parts[d]``, concatenated
    in block order and cut or zero-padded to ``cap`` rows: a section of
    a global blob read from the blocks' blobs (exact whenever the total
    fits ``cap``; past it the engine takes the exact gather)."""
    cat = np.concatenate([p[:int(n)] for p, n in zip(parts, counts)])[:cap]
    out = np.zeros((cap,) + parts[0].shape[1:], parts[0].dtype)
    out[:cat.shape[0]] = cat
    return out


def _blob_sizes(G: int, O: int, Mo: int, E: int, P: int, W: int,
                caps, HOST_OFF: int) -> Tuple[int, int]:
    """Word counts of the (head, detail) blobs (layouts in
    csrc/select_blob.cu)."""
    CB, CSL, CN, CA, CS = caps
    nw = (O + 31) // 32
    Mh = Mo - HOST_OFF
    head = G + G * nw + 6 + 5 + CB + CSL + CN + CA + CS + CS * N_VALS
    detail = (CB * O * N_FIELDS_BUF + 2 * CSL * Mh + CSL * Mh * E
              + CN * P + 2 * CA * W)
    return head, detail


# rows a block of csrc/select_blob.cu's count and write passes
# (SB_THREADS there)
_SEL_BLOCK_ROWS = 256


def _sel_scratch_words(G: int) -> int:
    """Words of select_and_blob's scratch: the block totals and offsets
    ([ceil(G / 256), 5] each), then a mask byte a row."""
    return 10 * -(-G // _SEL_BLOCK_ROWS) + (G + 3) // 4


def _select_and_blob(merged, out, stats, packed, flags, combo,
                     *, CAP_B: int, CAP_SL: int, CAP_N: int, CAP_A: int,
                     CAP_S: int, HOST_OFF: int):
    """Device-side row selection + detail/vals gather + split-blob
    packing — the launch's one commit-proving readback, as a (head,
    detail) pair of int32 vectors.

    The HEAD carries the flags/delivered prefix, route stats, section
    counts, the selected row ids and the per-row VALUES block —
    everything that PROVES a proposal's commit; the pipeline completes
    futures from it without waiting for the detail payload to merge.
    The DETAIL carries the heavy sections (outbox bytes, slot
    bookkeeping, need rows, ring windows).  Each section compacts its
    rows with a stable argsort of where(sel, 0, 1) cut to its capacity.
    Counts above the capacities are reported so the host can fall back
    to an exact gather.  The slot sections ship only the HOST-region
    columns (HOST_OFF = P*budget onward).  On CUDA: ``select_and_blob``
    (count, scan and write; the head, the detail and the kernels' scratch
    are views of one allocation) then ``gather_pack`` (the values block,
    into the head)."""
    caps = (CAP_B, CAP_SL, CAP_N, CAP_A, CAP_S)
    if _native.on_cpu(combo, "select_and_blob"):
        return colocated_ref.select_and_blob(
            merged, out, stats, packed, flags, combo, CAP_B=CAP_B,
            CAP_SL=CAP_SL, CAP_N=CAP_N, CAP_A=CAP_A, CAP_S=CAP_S,
            HOST_OFF=HOST_OFF,
        )
    G = flags.shape[0]
    O, Mo = out.buf.shape[1], out.slot_base.shape[1]
    E, P, W = out.ent_drop.shape[2], out.need_snapshot.shape[1], \
        merged.ring_term.shape[1]
    if any(not 0 <= c <= G for c in caps):
        raise ValueError("select_and_blob: capacities must lie in [0, G]")
    n_head, n_detail = _blob_sizes(G, O, Mo, E, P, W, caps, HOST_OFF)
    head, detail, scratch = _native.alloc_views(
        ((n_head,), (n_detail,), (_sel_scratch_words(G),)), flags.device)[1]
    _native.launch(
        "select_and_blob", flags, combo, packed, stats,
        [out.buf, out.slot_base, out.slot_term, out.ent_drop,
         out.need_snapshot, merged.ring_term, merged.ring_cc],
        head, detail, scratch, list(caps), HOST_OFF,
    )
    nw = (O + 31) // 32
    off_sum = G + G * nw + 11 + CAP_B + CAP_SL + CAP_N + CAP_A
    off_vals = off_sum + CAP_S
    if CAP_S:
        plumbing.gather_pack(merged, out, None, head[off_sum:off_vals],
                             dst=head[off_vals:])
    return head, detail


def _zero_inbox_rows(inbox: Inbox, mask) -> Inbox:
    """Zero the inbox rows where ``mask`` ([G], nonzero) — CUDA
    ``inbox`` (zero_rows)."""
    if _native.on_cpu(mask, "zero_inbox_rows"):
        return colocated_ref.zero_inbox_rows(inbox, mask)
    G, M = inbox.mtype.shape
    flat, res = new_inbox(G, M, inbox.ent_term.shape[2], mask.device)
    _native.launch("zero_inbox_rows", inbox, mask.to(I32), flat)
    return res


def _host_inbox_from_ticks(combo, *, M: int, E: int) -> Inbox:
    """Build the host inbox region ON DEVICE from the [G] fused tick
    counts: nearly every row's host region is exactly one
    count-carrying LOCAL_TICK slot, so the dense [G, M(, E)] upload is
    avoided.  Rows with real host slots (wire messages, proposals,
    reads, tick-with-read-hint) are placed over this base by
    _scatter_inbox_rows.  CUDA ``inbox`` (from_ticks)."""
    if _native.on_cpu(combo, "host_inbox_from_ticks"):
        return colocated_ref.host_inbox_from_ticks(combo, M=M, E=E)
    flat, res = new_inbox(combo.shape[0], M, E, combo.device)
    _native.launch("host_inbox_from_ticks", combo, flat, M, E)
    return res


def _scatter_inbox_rows(host: Inbox, pos, sub: Inbox) -> Inbox:
    """Place sub's rows at pos (a [G] position map, -1 = keep) — the
    shared pos-map gather-select (CUDA ``place_rows``)."""
    return Inbox(*plumbing.place_rows(list(host), list(sub), pos))


# the kernels each device program launches on CUDA (the parity
# self-check counts its checks per kernel)
PROGRAM_KERNELS: Dict[str, Tuple[str, ...]] = {
    "assemble_and_step": ("inbox", "raft_step"),
    "route_step": ("merge_escalated", "route", "summarize_flags"),
    # a mesh block's route step adds the lane pack (lane_route_step)
    "lane_route_step": ("merge_escalated", "route", "xlane_pack",
                        "summarize_flags"),
    "lane_scatter": ("xlane_scatter",),
    "select_and_blob": ("select_and_blob", "gather_pack"),
    "zero_inbox_rows": ("inbox",),
    "host_inbox_from_ticks": ("inbox",),
    "scatter_inbox_rows": ("place_rows",),
}


# the positional arguments a device program consumes (updates in place):
# the parity self-check hands its plain version copies taken before the
# kernels ran
PROGRAM_CONSUMES: Dict[str, Tuple[int, ...]] = {
    "route_step": (1,), "lane_route_step": (1,), "lane_scatter": (0, 2),
}


def _device_of(x):
    """The device of the first tensor among a program's arguments."""
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (tuple, list)):
        for y in x:
            d = _device_of(y)
            if d is not None:
                return d
    return None


def _tensors(x):
    """The tensors of a program's output (nested tuples flattened)."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _tensors(y)]


class _Readback:
    """One blob's readback, requested at dispatch.  On CUDA: a
    ``non_blocking`` copy into a PINNED host buffer allocated for this
    blob alone, and a ``torch.cuda.Event`` recorded on the stream after
    the copy; ``numpy()`` waits on the event before it exposes the
    buffer (read before the copy completes, a pinned buffer holds stale
    rows with no error).  On the CPU the tensor is the host copy."""

    __slots__ = ("host", "event")

    def __init__(self, dev_t: torch.Tensor):
        if dev_t.device.type == "cuda":
            self.host = torch.empty(
                tuple(dev_t.shape), dtype=dev_t.dtype, pin_memory=True
            )
            self.host.copy_(dev_t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev_t.device))
        else:
            self.host = dev_t
            self.event = None

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _InFlightGen:
    """One dispatched-but-unmerged generation of the launch pipeline.

    Holds every host-side fact the deferred merge tail needs (the
    generation's OWN inputs — the parity oracle must run against these,
    not the interleaved stream) plus the device handles the exact
    two-sync fallback gather reads.  ``merged``/``out`` pin the
    generation's buffers alive until its merge runs; with depth 2 that
    is two in-flight state handles.  ``head_dev``/``detail_dev`` hold
    the generation's ``_Readback`` records: their pinned host buffers
    belong to this generation alone until it is merged.

    A FUSED generation (``rounds > 1``) carries one entry per round in
    ``merged``/``out``/``head_dev``/``detail_dev``: the wave dispatched
    K rounds back-to-back with every round's (head, detail) copy
    requested at dispatch, so the whole wave's blobs land in ONE
    readback window and the merge tail unpacks them round by round."""

    __slots__ = (
        "batch", "staging", "alive_np", "batch_gs", "prop_gs", "caps",
        "merged", "out", "head_dev", "detail_dev", "t_req", "tick_fed",
        "rounds", "lane_dev", "heads",
    )

    def __init__(self, *, batch, staging, alive_np, batch_gs, prop_gs,
                 caps, merged, out, head_dev, detail_dev, t_req,
                 tick_fed=None, rounds=1, lane_dev=()):
        self.batch = batch
        self.staging = staging
        self.alive_np = alive_np
        self.batch_gs = batch_gs
        self.prop_gs = prop_gs
        self.caps = caps
        self.merged = merged          # per-round list of Sharded states
        self.out = out                # per-round list of Sharded DeviceOut
        # per round: one head / detail _Readback per row block
        self.head_dev = head_dev
        self.detail_dev = detail_dev
        self.t_req = t_req
        self.tick_fed = tick_fed or {}
        self.rounds = rounds
        # mesh mode: one _Readback per block of its [rounds, 8] lane stats
        self.lane_dev = lane_dev
        self.heads: Dict[int, list] = {}  # round -> its blocks' parsed heads

    def readbacks(self):
        """Every blob readback of the generation."""
        for rbs in (*self.head_dev, *self.detail_dev):
            yield from rbs
        yield from self.lane_dev


class ColocatedTorchEngine(TorchStepEngine):
    """Shared device engine for several NodeHosts in one process.

    Do not construct directly — use ``ColocatedEngineGroup``.
    """

    def __init__(self, *, budget: int = 2, capacity: int = 64, P: int = 5,
                 W: int = 32, M: int = 8, E: int = 4, O: int = 32,
                 rebase_chunk: int = 1 << 30, device=None, mesh=None,
                 pipeline_depth: Optional[int] = None,
                 sync_floor_ms: Optional[float] = None,
                 fused_rounds: Optional[int] = None,
                 parity_every: int = 0):
        self.budget = budget
        # the parity self-check's allocator pools, one a CUDA device
        # (see _parity_pool)
        self._parity_pools: Dict[int, "torch.cuda.MemPool"] = {}
        self._pending: Optional[Inbox] = None
        self._pending_live = False  # last route delivered > 0 messages
        self._host_shard = np.zeros((capacity,), np.int64)
        self._host_replica = np.zeros((capacity,), np.int64)
        self._host_peers = np.zeros((capacity, P), np.int64)
        self._tables_dirty = True
        # per block: the local view of the route tables (a peer on
        # another block is -1) and, with several blocks, the lane's mesh
        # tables and per-edge budget (see _rebuild_tables)
        self._dest_dev = None
        self._rank_dev = None
        self._lane_tabs = None
        self._xbudget = 1
        # shard -> OrderedDict[(index, term) -> Entry]; bounded FIFO per
        # shard.  Depth must cover BOTH lifetimes an entry is needed
        # for: the device ring window (8*W) and the stamp-to-consumption
        # gap of a routed append — the receiver merges one launch after
        # the sender stamped, and a proposal storm can stamp up to ~M*E
        # entries per launch in between, evicting the referenced entry
        # from a W-sized budget (chaos finding: rare fail-stops at
        # W=8 under full-rate clients).  8*M*E covers several launches
        # of worst-case append volume.
        self._entry_cache: Dict[int, "OrderedDict[Tuple[int, int], Entry]"] = {}
        self._cache_depth = max(8 * W, 8 * M * E)
        # per-SHARD shared index base (the colocated 64-bit story):
        # routed messages carry raw int32 index lanes between rows, so a
        # per-row base would desynchronize them — instead every resident
        # row of a shard shares one W-aligned base, advanced by whole-
        # shard rebases (see _maybe_rebase_shards).  rebase_chunk is how
        # far committed may outrun the base before a rebase (tests
        # shrink it to exercise multi-rebase traffic at ordinary scale).
        self._shard_base: Dict[int, int] = {}
        self._rebase_chunk = rebase_chunk
        # shard -> committed level below which rebase attempts are
        # suppressed (set when an attempt finds no representable
        # progress, e.g. a lagging peer lane pins the candidate min)
        self._rebase_block: Dict[int, int] = {}
        # chaos/fault plug point: (shard_id, replica_id) -> partition
        # group.  Rows in different groups lose their device route (the
        # link falls back to the host transport — counted in
        # routed_dropped as dest<0 — where the usual drop hooks apply);
        # both sides keep ticking and campaigning, exactly a network
        # partition.  None = fully connected.
        self._part_fn = None
        # rate limit for the O(resident rows) coalesce scan (see
        # _coalesce); 0 = never scanned yet
        self._last_coalesce_scan = 0.0
        self._scan_cost = 0.0
        # adaptive device-select capacities for the single-sync launch
        # blob (see _select_and_blob): detail rows are ~2 KB each so
        # CAP_D tracks actual peaks tightly; vals rows are 40 B so
        # CAP_S can ride elections up to G cheaply
        # deterministic select-capacity tier (see _SEL_TIERS): index into
        # the warmed ladder + the consecutive-fits-lower-tier streak
        self._sel_tier = 0
        self._sel_fit_streak = 0
        # ---- launch pipeline (double-buffered generations) ----------
        # FIFO of dispatched-but-unmerged generations; the merge tail
        # runs one generation behind the device at depth 2.  The fence
        # contract (docs/PARITY.md "Pipeline safety argument"): rows
        # being evicted/escalated/detached drain this to depth 0 before
        # membership mutates — mirroring the ≤1-launch detach-race
        # argument at any depth.
        from collections import deque as _deque

        self._inflight: "_deque[_InFlightGen]" = _deque()
        self._pipeline_depth = max(
            1,
            pipeline_depth
            if pipeline_depth is not None
            else _PIPE_DEPTH_DEFAULT,
        )
        self._sync_floor_s = (
            sync_floor_ms
            if sync_floor_ms is not None
            else _SYNC_FLOOR_MS_DEFAULT
        ) / 1000.0
        # fused commit waves: K consecutive routed rounds
        # chained device-side per routable generation — propose ->
        # commit in one launch + one readback.  Non-routable
        # generations (membership mutation in sight, escalation holds,
        # save quarantine, stopping rows) fence to the single-round
        # path, extending the pipeline fence argument unchanged.
        self._fuse_rounds = max(
            1,
            fused_rounds
            if fused_rounds is not None
            else _FUSED_ROUNDS_DEFAULT,
        )
        # deferred membership actions discovered mid-completion
        # (escalation replays, snapshot-below / save-failure evictions,
        # demotes): they mutate membership, so they run only once the
        # pipeline is drained to depth 0 — never from inside a merge.
        self._deferred: List[Tuple] = []
        self._running_deferred = False
        # True while a generation's merge tail is executing: membership
        # mutators called from inside it (demote, save-failure evict)
        # must defer instead of fencing — a fence mid-merge would
        # complete LATER generations before this one finishes.
        self._completing = False
        # row slots freed while generations are in flight: an in-flight
        # merge still references them by id, so they re-enter _free only
        # at depth 0 (a re-attach reusing the slot mid-flight would let
        # one generation's effects merge into another replica's row)
        self._free_pending: List[int] = []
        self._last_worker_id = 0
        super().__init__(None, capacity=capacity, P=P, W=W, M=M, E=E, O=O,
                         device=device, mesh=mesh, parity_every=parity_every)
        # nemesis escalations are consumed at plan time here: routed
        # regions suppress escalated rows ON device, so the base
        # engine's post-launch flag flip would desync the merged state
        self._consume_engine_fault_at_plan = True
        # loop-invariant delivered-bit unpack tables (word index and
        # in-word shift per outbox slot) — hoisted out of the merge loop
        self._dw_word = np.arange(self.O) // 32
        self._dw_shift = (np.arange(self.O) % 32).astype(np.uint32)
        self.stats.update(
            launches=0, routed_delivered=0, routed_host_carried=0,
            routed_dropped=0, coalesced_rows=0, shard_rebases=0,
            # cumulative wall-time breakdown (float ms) of the launch
            # path — the single-core CPU backend hides where a 65k-row
            # launch goes without it; each stage is also the recorder
            # span colocated.<stage> (profiling.stage)
            t_coalesce_ms=0.0, t_plan_ms=0.0, t_upload_ms=0.0,
            t_device_ms=0.0, t_detail_ms=0.0, t_updates_ms=0.0,
            t_persist_ms=0.0,
            # pipeline observability: host work overlapped with an
            # in-flight readback request (the double-buffering win),
            # fences (drains to depth 0 forced by membership mutation),
            # futures completed from the head-only early pass, and the
            # floor-shim wait actually paid at collect time
            pipeline_overlap_s=0.0, pipeline_fences=0,
            early_completions=0, t_sync_wait_ms=0.0,
            # fused commit waves: waves dispatched, rounds
            # stepped inside them, single-round fences (a routable-work
            # generation that could NOT fuse), and readback windows —
            # ONE per completed generation regardless of its round
            # count (plus one per exact-gather fallback round), the
            # counter proving one readback per fused wave
            fused_waves=0, fused_rounds_stepped=0, fused_fences=0,
            readback_windows=0,
        )
        lane = self._blocks.D > 1
        if lane:
            # the cross-block lane (mesh mode): messages carried, received
            # and refused for want of a lane slot (structurally 0: the
            # per-edge budget is xbudget_for the tables)
            self.stats.update(lane_sent=0, lane_delivered=0,
                              lane_dropped_xlane=0)
        for name, ks in PROGRAM_KERNELS.items():
            if name.startswith("lane_") and not lane:
                continue
            for k in ks:
                self.stats[f"parity_attempts_{k}"] = 0
                self.stats[f"parity_checks_{k}"] = 0

    def _compute_base(self, r) -> int:
        # the SHARD's shared base, not a per-row quantity — see __init__
        return self._shard_base.get(r.shard_id, 0)

    def _lease_pass(self, live, flags, vals_np, pos_sum,
                    tick_fed) -> None:
        """Per-generation device-lease evidence pass (ROADMAP 4b): see
        hostplane.LeaseLanes.  Runs before the bulk mirror write (role
        transitions read the OLD mirror) and before per-row tick
        bookkeeping (window starts stamp the pre-launch clock — the
        conservative side)."""
        for node, g, si in live:
            if node.stopped or self._meta.get(g) is None:
                continue
            r = node.peer.raft
            if vals_np is not None:
                k = int(pos_sum[g])
                if k >= 0:
                    role = int(vals_np[k, _R_ROLE])
                    if role != int(self._mirror[_R_ROLE, g]):
                        if (
                            role == int(RaftRole.LEADER)
                            and r.check_quorum
                        ):
                            self._lease.arm(g, r.election_timeout, 0)
                        else:
                            self._lease.disarm(g)
            a = self._lease.row_step(
                g, tick_fed.get(g, 0), node.tick_count, int(flags[g])
            )
            if a >= 0:
                r.anchor_quorum_evidence(a)

    def device_coordinate(self, shard_id: int, replica_id=None):
        """Device block hosting the (shard, replica) row — with no
        replica, the shard's lowest row — or None when unknown / no
        mesh."""
        if self._mesh is None:
            return None
        if replica_id is None:
            gs = [
                g for (s, _r), g in self._row_of.items() if s == shard_id
            ]
            g = min(gs) if gs else None
        else:
            g = self._row_of.get((shard_id, replica_id))
        if g is None:
            return None
        return g // (self.capacity // self._mesh.size)

    def _pick_row(self, node) -> int:
        """Mesh-mode shard affinity: place a shard's replicas on the
        device block already hosting the shard, so a shard's commit
        rounds route inside one block and only cross-SHARD load spreads
        over the mesh.  The scan is bounded to the free-list tail — with
        the striped base order the tail alternates blocks, so the
        preferred block is almost always within a few slots; after heavy
        churn it degrades to the plain pop."""
        if self._mesh is None:
            return self._free.pop()
        per = self.capacity // self._mesh.size
        want = None
        for (s, _r), g0 in self._row_of.items():
            if s == node.shard_id:
                want = g0 // per
                break
        if want is None:
            return self._free.pop()
        lo = max(0, len(self._free) - 4 * self._mesh.size)
        for i in range(len(self._free) - 1, lo - 1, -1):
            if self._free[i] // per == want:
                return self._free.pop(i)
        return self._free.pop()

    def _tier_caps(self, t: int) -> Dict[str, int]:
        return {k: min(self.capacity, v) for k, v in _SEL_TIERS[t].items()}

    def _block_caps(self, caps: Dict[str, int]) -> Dict[str, int]:
        """A tier's capacities on one row block (select_and_blob takes at
        most the block's rows a section): when the whole launch's count
        of a section fits its capacity, each block's fits too."""
        return {k: min(self._blocks.per, v) for k, v in caps.items()}

    def _fresh_pending(self):
        """Empty routed regions on every block."""
        per, dv = self._blocks.per, self._blocks.devices
        return placement.Sharded(tuple(
            make_inbox(per, self.P * self.budget, self.E, device=dv[d])
            for d in range(self._blocks.D)))

    def _on_blocks(self, name: str, fn, *args, parity: bool = False, **kw):  # mesh-hot
        """The device program ``fn`` once per row block (``_run``): each
        ``Sharded`` argument gives its block's part.  A program of one
        output returns a ``Sharded``; of several, a tuple of them."""
        res = [
            self._run(name, fn, *(
                a.parts[d] if isinstance(a, placement.Sharded) else a
                for a in args), parity=parity, **kw)
            for d in range(self._blocks.D)
        ]
        if isinstance(res[0], tuple) and not hasattr(res[0], "_fields"):
            return tuple(placement.Sharded(tuple(r[i] for r in res))
                         for i in range(len(res[0])))
        return placement.Sharded(tuple(res))

    def _run(self, name: str, fn, *args, parity: bool = False,
             counted: bool = True, **kw):
        """Run the device program ``fn`` (``name`` in
        ``colocated_ref.PROGRAMS``); with ``parity`` run it again through
        its plain version on the same inputs and require bit equality on
        every output tensor.  Each check begun counts one
        ``parity_attempts_<kernel>`` for every kernel the program
        launches on CUDA, and one ``parity_checks_<kernel>`` once it has
        passed (unless not ``counted``: the warm-up's checks); a mismatch
        is counted, latched and raised (``_parity_fail``).  The argument
        a program consumes (``PROGRAM_CONSUMES``) reaches the plain
        version as a copy taken before the kernels ran.  The copies and
        the plain version allocate in the parity pool."""
        if not parity:
            return fn(*args, **kw)
        dev = _device_of(args)
        ref_args = list(args)
        with self._parity_pool(dev):
            for i in PROGRAM_CONSUMES.get(name, ()):
                a = args[i]
                ref_args[i] = (a.clone() if isinstance(a, torch.Tensor)
                               else type(a)(*(t.clone() for t in a)))
        got = fn(*args, **kw)
        kernels = PROGRAM_KERNELS[name] if counted else ()
        for k in kernels:
            self.stats[f"parity_attempts_{k}"] += 1
        with self._parity_pool(dev):
            want = colocated_ref.PROGRAMS[name](*ref_args, **kw)
            for i, (a, b) in enumerate(zip(_tensors(got), _tensors(want))):
                if not torch.equal(a, b):
                    self._parity_fail(f"{name} output {i}")
        for k in kernels:
            self.stats[f"parity_checks_{k}"] += 1
        return got

    def _parity_pool(self, device):
        """Where the parity self-check allocates: on a CUDA device, an
        allocator pool of its own (``torch.cuda.MemPool``).  The plain
        versions' temporaries are few and large (the plain route's
        [G, O, P, B] selections: hundreds of MB at 65,536 rows); in the
        shared pool the launches between two checks split their cached
        blocks, and the next check allocates again mid-run.  In a pool of
        their own the blocks stay whole, and a check after the warm-up's
        (``_warm_parity``) allocates nothing new.  On the CPU, the
        default allocator."""
        if device is None or device.type != "cuda":
            return contextlib.nullcontext()
        pool = self._parity_pools.get(device.index)
        if pool is None:
            pool = self._parity_pools[device.index] = torch.cuda.MemPool()
        return torch.cuda.use_mem_pool(pool, device)

    # -- row identity ---------------------------------------------------
    def _row_key(self, node):
        # several NodeHosts share this engine: replicas of one shard are
        # distinct rows
        return (node.shard_id, node.replica_id)

    def _free_slot(self, g: int) -> None:
        """Return a row slot to the free pool — quarantined in
        ``_free_pending`` while generations are in flight (an in-flight
        merge still references the slot by id; re-attaching it before
        depth 0 would merge one replica's device effects into
        another's scalar state).  Flushed back at every drain."""
        (self._free_pending if self._inflight else self._free).append(g)

    def _flush_free_pending(self) -> None:
        if self._free_pending and not self._inflight:
            self._free.extend(self._free_pending)
            self._free_pending.clear()

    def _attach(self, node) -> Optional[int]:
        key = self._row_key(node)
        g = self._row_of.get(key)
        if g is not None and self._meta[g].node is not node:
            # replica restarted without a detach (stop raced the step):
            # drop the stale binding and re-key freshly.  PIPELINE
            # FENCE first — this is a membership mutation like any
            # detach, and in-flight merges still reference row g (the
            # old node's device acks must persist before the row is
            # released); the call site is the plan loop, never a
            # merge, so fencing is legal here
            self._fence()
            self._row_of.pop(key)
            self._meta.pop(g, None)
            self._free_slot(g)
            self._release_row(g, node.shard_id)
            g = None
        is_new = key not in self._row_of
        g = super()._attach(node)
        if g is not None and is_new:
            self._host_shard[g] = node.shard_id
            self._host_replica[g] = node.replica_id
            self._host_peers[g, :] = 0
            self._tables_dirty = True
        return g

    def _release_row(self, g: int, shard_id: int) -> None:
        """Clear the route-table claim of a freed row (caller holds the
        lock and has already popped _row_of/_meta).  Also drops the
        shard's entry cache when its last resident replica is gone —
        without this a process cycling many shards leaks one payload
        cache per shard id ever hosted."""
        self._host_shard[g] = 0
        self._host_replica[g] = 0
        self._host_peers[g, :] = 0
        self._lanes.reset_row(g, attached=False)
        self._tables_dirty = True
        if not any(
            s == shard_id for s, _ in self._row_of
        ):
            self._entry_cache.pop(shard_id, None)
            # base resets with the last replica; a returning shard with
            # a large log re-establishes it via _maybe_rebase_shards
            # before any row can pass the planner's lane bounds
            self._shard_base.pop(shard_id, None)
            self._rebase_block.pop(shard_id, None)

    def _halt_replica(self, g: int) -> None:
        node = self._meta[g].node
        super()._halt_replica(g)  # appends g to _free
        if self._inflight and g in self._free:
            # fail-stops happen mid-merge with later generations in
            # flight: quarantine the slot until depth 0 (see _free_slot)
            self._free.remove(g)
            self._free_pending.append(g)
        self._release_row(g, node.shard_id)

    def detach_replica(self, shard_id: int, replica_id: int) -> None:
        self.detach_replicas([(shard_id, replica_id)])

    def detach_replicas(self, pairs) -> None:
        """Batch detach under ONE core-lock acquisition (NodeHost.close
        releases every row of a member at once; per-row locking would
        interleave thousands of acquisitions with live launches).

        PIPELINE FENCE: membership must not mutate under an in-flight
        generation — the pending merges still reference these rows, and
        a stopping node's device acks were already routed, so its
        appends must persist before the row goes away (the ≤1-launch
        detach-race argument, now enforced at any depth by draining
        first: the drained merges run while the node is still live,
        then the row is released)."""
        with self._lock:
            self._fence()
            for shard_id, replica_id in pairs:
                g = self._row_of.pop((shard_id, replica_id), None)
                if g is not None:
                    self._meta.pop(g, None)
                    self._free_slot(g)
                    self._release_row(g, shard_id)

    def _upload_rows(self, rows) -> None:
        super()._upload_rows(rows)
        for g, r in rows:
            lay = np.zeros((self.P,), np.int64)
            for s, (pid, _) in enumerate(S.peer_layout(r)):
                lay[s] = pid
            if (self._host_peers[g] != lay).any():
                self._host_peers[g] = lay
                self._tables_dirty = True
            self._publish_ring_window(r)

    def _publish_ring_window(self, r) -> None:
        """Publish an uploading row's ring window to the shard cache:
        entries appended on the HOST path (scalar excursions, WAL
        replay) can later be device-route-replicated straight from this
        row's ring, and the receiving replica reconstructs payloads
        from the cache.  Witness rows must NOT publish — their own log
        holds stripped metadata entries (no cmd) under the same
        (index, term) keys; publishing them would overwrite real
        payloads in the shared cache and silently diverge any replica
        that reconstructs from it (witness RECEIVERS get the stripped
        form applied at _cache_lookup instead)."""
        if r.replica_id in r.witnesses:
            return
        last = r.log.last_index()
        lo = max(r.log.first_index(), last - self.W + 1)
        if last >= lo:
            try:
                ents = r.log._get_entries(lo, last + 1, 2**62)
            except Exception:  # noqa: BLE001 — compacted tails are fine
                ents = []
            self._cache_put(r.shard_id, ents)

    def _demote_row_to_host(self, node) -> None:
        g = self._row_of.get(self._row_key(node))
        if g is None:
            return
        meta = self._meta.get(g)
        if meta is None or meta.dirty:
            return
        self._evict_rows_to_host([g], "demote")  # drains pending routed traffic
        meta.set_escalation_hold(node.config)

    def _on_save_failure(self, pairs) -> None:
        super()._on_save_failure(pairs)
        # evict the failing nodes' rows (we hold the core lock:
        # colocated persist runs inside _step_colocated) so no further
        # device launch routes acks for appends their WAL cannot hold;
        # the scalar path only sends after a successful save.  With the
        # pipeline live this defers to the next depth-0 point (before
        # the next dispatch): the base class's save quarantine already
        # keeps the rows out of every new plan, and the ≤depth launches
        # already in flight were dispatched before the failure was
        # knowable — the same exposure window as the detach race.
        self._evict_rows_to_host([
            g
            for node, _u in pairs
            if (g := self._row_of.get(self._row_key(node))) is not None
        ], "save_failure")

    def _rebuild_tables(self) -> None:
        """The route tables of the resident rows: global ``dest`` / ``rank``
        (build_route_tables), the partition cut applied to the GLOBAL
        ``dest`` — so it severs a block's own routes and the lane's alike
        — then cut into the row blocks (split_route_tables): each block
        routes over its local view (a peer on another block: -1) and,
        with several blocks, the lane carries the rest with a per-edge
        budget of ``xbudget_for`` the tables (``dropped_xlane`` stays
        structurally 0)."""
        dest, rank = build_route_tables(
            self._host_shard, self._host_replica, self._host_peers
        )
        if self._part_fn is not None:
            # cut cross-partition links by severing the device route:
            # the message is left undelivered (dest<0, counted in
            # routed_dropped) and the sending host re-sends it via its
            # transport, where the partition's drop hook loses it — the
            # destination row still ticks, campaigns and answers its
            # own side, which is what a real network partition does
            part = np.array([
                self._part_fn(int(s), int(r)) if s else 0
                for s, r in zip(self._host_shard, self._host_replica)
            ])
            cut = (dest >= 0) & (
                part[np.clip(dest, 0, len(part) - 1)] != part[:, None]
            )
            dest = np.where(cut, -1, dest)
        self._set_tables(dest, rank)

    def _set_tables(self, dest: np.ndarray, rank: np.ndarray) -> None:
        """Install global ``dest`` / ``rank`` tables on the row blocks."""
        D = self._blocks.D
        tabs = split_route_tables(dest, rank, D)
        block = (np.arange(self.capacity) // self._blocks.per)[:, None]
        self._dest_dev = self._put_rows(
            np.where(tabs.dest_dev == block, tabs.dest_local, -1))
        self._rank_dev = self._put_rows(rank)
        if D > 1:
            self._lane_tabs = list(zip(*(self._put_rows(t).parts
                                         for t in tabs)))
            self._xbudget = xbudget_for(tabs, self.budget, D)
        self._tables_dirty = False

    def set_partition(self, fn) -> None:
        """Install (or clear, with ``None``) a partition-group function
        ``fn(shard_id, replica_id) -> int``: device routes between rows
        in different groups are severed until cleared — cross-group
        messages fall back to each sender's host transport (chaos
        testing — see _rebuild_tables).  Takes effect from the next
        launch."""
        with self._lock:
            self._part_fn = fn
            self._tables_dirty = True

    # -- entry cache ----------------------------------------------------
    def _cache_put(self, shard_id: int, entries: List[Entry]) -> None:
        od = self._entry_cache.setdefault(shard_id, OrderedDict())
        for e in entries:
            od[(e.index, e.term)] = e
            od.move_to_end((e.index, e.term))
        while len(od) > self._cache_depth:
            # evict the LOWEST index, not the FIFO-oldest: a follower
            # catch-up re-inserts evicted low keys one batch at a time,
            # and FIFO eviction then rolls a wave through the insert
            # order that eventually eats the NEWEST entries — the very
            # ones the leader's ring can still device-route, fail-
            # stopping the follower at the last ring-window hop (a
            # chaos finding: wedged at last-W+2 after a 300-entry lag)
            od.pop(min(od))

    def _cache_lookup(self, r, idx: int, term: int) -> Optional[Entry]:
        od = self._entry_cache.get(r.shard_id)
        e = od.get((idx, term)) if od else None
        if e is not None and r.replica_id in r.witnesses:
            e = r._to_witness_entry(e)
        return e

    # -- warm -----------------------------------------------------------
    def _warm(self) -> None:  # mesh-hot
        """Run every program of a launch once on the inert state, so the
        kernels are built and loaded before the first real step (torch
        runs eagerly; there is nothing to trace), and set up the routed
        pending regions.  The select runs at every tier of the ladder,
        and each tier's blobs go through the pinned readback as many
        times at once as a full pipeline holds in flight, so that a tier
        change mid-run finds its device and pinned blocks cached (the
        reference warms every tier for its trace cache)."""
        G, P, B, E, O = self.capacity, self.P, self.budget, self.E, self.O
        D, per = self._blocks.D, self._blocks.per
        self._pending = self._fresh_pending()
        # persistent all-zero combo: rounds >= 2 of a fused wave build
        # their (empty) host inbox region from it ON DEVICE — ticks and
        # host slots are fed exactly once, in round 1
        self._zero_combo = self._put_rows(np.zeros((G, 4), np.int32))
        tiers = [self._block_caps(self._tier_caps(t))
                 for t in range(len(_SEL_TIERS))]
        in_flight = self._pipeline_depth * self._fuse_rounds
        xbufs = []
        for d in range(D):
            st, combo = self._state.parts[d], self._zero_combo.parts[d]
            dest = self._put(np.full((per, P), -1, np.int32), d)
            rank = self._put(np.zeros((per, P), np.int32), d)
            host = _host_inbox_from_ticks(combo, M=self.M, E=E)
            new_st, out = _assemble_and_step(
                st, host, self._pending.parts[d], combo, out_capacity=O
            )
            kw = {}
            if D > 1:
                kw["lane"] = colocated_ref.Lane(
                    dest, dest, rank, self._put(np.zeros((G, 4), np.int32),
                                                d), d, D, 1)
            res = _route_step(st, new_st, out, dest, rank, combo,
                              PB=P * B, E=E, budget=B, **kw)
            merged_w, _regions_w, stats_w, packed_w, flags_w = res[:5]
            xbufs.append(res[5:])
            for caps in tiers:
                blobs = _select_and_blob(
                    merged_w, out, stats_w, packed_w, flags_w, combo,
                    CAP_B=caps["b"], CAP_SL=caps["sl"], CAP_N=caps["n"],
                    CAP_A=caps["a"], CAP_S=caps["s"], HOST_OFF=P * B,
                )
                reads = [_Readback(t) for _ in range(in_flight)
                         for t in blobs]
                for r in reads:
                    r.numpy()
            if self._parity_every > 0 and combo.device.type == "cuda":
                self._warm_parity(d, st, dest, rank, kw, tiers[-1])
            _zero_inbox_rows(self._pending.parts[d],
                             self._put(np.zeros((per,), np.int32), d))
            idx = self._put(np.zeros((1,), np.int32), d)
            _scatter_inbox_rows(
                host, self._put(np.full((per,), -1, np.int32), d),
                Inbox(*plumbing.place_rows(None, list(host), idx)),
            )
        if D > 1:
            recv = ring_shift(self._blocks.mesh, [x[0] for x in xbufs])
            for d in range(D):
                _lane_scatter(self._pending.parts[d], recv[d], xbufs[d][1],
                              budget=B)
        super()._warm()

    def _warm_parity(self, d: int, st, dest, rank, kw, caps) -> None:
        """One parity self-check of a launch's programs on row block
        ``d`` (not counted in the stats), so that the parity pool
        (``_parity_pool``) holds what a check under traffic needs before
        the first launch: every row alive and a host inbox carrying
        every hot message type (the plain step allocates for each type it
        meets), the route over the block's tables, the select at the
        storm tier ``caps``."""
        from .convert import inbox_from_numpy, to_numpy
        from .fuzz import fuzz_inbox_np

        P, B, E = self.P, self.budget, self.E
        per = self._blocks.per
        combo_np = np.zeros((per, 4), np.int32)
        combo_np[:, _C_ALIVE] = 1
        combo_np[:, _C_BATCH] = 1
        combo = self._put(combo_np, d)
        dev = combo.device
        sub = inbox_from_numpy(fuzz_inbox_np(
            to_numpy(st), np.random.default_rng(0), self.M, E), dev)

        def check(name, fn, *args, **kw_):
            return self._run(name, fn, *args, parity=True, counted=False,
                             **kw_)

        host = check("host_inbox_from_ticks", _host_inbox_from_ticks, combo,
                     M=self.M, E=E)
        host = check("scatter_inbox_rows", _scatter_inbox_rows, host,
                     self._put(np.arange(per, dtype=np.int32), d), sub)
        new_st, out = check("assemble_and_step", _assemble_and_step, st,
                            host, self._pending.parts[d], combo,
                            out_capacity=self.O)
        merged, _regions, stats, packed, flags = check(
            "lane_route_step" if kw else "route_step", _route_step, st,
            new_st, out, dest, rank, combo, PB=P * B, E=E, budget=B,
            **kw)[:5]
        check("select_and_blob", _select_and_blob, merged, out, stats,
              packed, flags, combo, CAP_B=caps["b"], CAP_SL=caps["sl"],
              CAP_N=caps["n"], CAP_A=caps["a"], CAP_S=caps["s"],
              HOST_OFF=P * B)

    def _evict_rows_to_host(self, gs, cause: str = "other") -> None:
        """Move resident rows to the host path losing nothing.  Order is
        a correctness invariant encoded ONCE here: drain each row's
        routed-but-unconsumed inbox traffic into its node's receive
        queue FIRST (the next launch's alive mask would destroy it —
        losing a heartbeat stream turns a brief host excursion into an
        election storm), then materialize device state into the scalar
        mirrors, then mark the rows host-authoritative.  Already-dirty
        rows are skipped wholesale: their scalar side is authoritative
        and materializing stale device lanes over it would corrupt it.
        Caller holds the core lock.

        PIPELINE FENCE: eviction mutates membership (rows leave the
        device), so in-flight generations drain to depth 0 first —
        their merges still reference these rows, and materializing a
        row whose unmerged device appends are in flight would trip a
        false divergence halt.  A caller running INSIDE a generation's
        merge (demote on a compacted below-ring send, a save-failure
        mid-persist) must not fence — completing later generations
        before the current one finishes would break the FIFO scalar
        sync — so the eviction defers to the next depth-0 point
        instead (before the next dispatch, see _run_deferred)."""
        if self._completing:
            self._deferred.append(("evict", [int(g) for g in gs], cause))
            return
        if self._inflight and any(
            (m := self._meta.get(g)) is not None and not m.dirty
            for g in gs
        ):
            self._fence()
        pairs = []
        for g in gs:
            meta = self._meta.get(g)
            if meta is not None and not meta.dirty:
                pairs.append((meta.node, g))
        if not pairs:
            return
        self.stats[f"evict_{cause}"] = (
            self.stats.get(f"evict_{cause}", 0) + len(pairs)
        )
        self._drain_pending_to_host(pairs)
        self._materialize_rows([g for _, g in pairs])
        for _, g in pairs:
            meta = self._meta.get(g)
            if meta is not None:
                meta.dirty = True

    def _drain_pending_to_host(self, pairs) -> None:
        """Decode rows' pending routed-inbox regions into wire Messages
        and enqueue them on the owning nodes (rows transitioning device
        -> host).  REPLICATE payloads reconstruct from the entry cache;
        an unreconstructible message is dropped (raft retries it)."""
        from ..pb import Message, MessageType
        from .types import MT_REPLICATE

        if self._pending is None or not pairs:
            return
        sub = Inbox(*self._gather_blocks(
            self._pending.parts, [g for _, g in pairs],
            lambda part, idx: plumbing.place_rows(None, list(part), idx)))
        for k, (node, g) in enumerate(pairs):
            r = node.peer.raft
            base = int(self._base[g])  # routed lanes are shard-rebased
            for s in range(sub.mtype.shape[1]):
                mt = int(sub.mtype[k, s])
                if mt == 0:
                    continue
                n = int(sub.n_entries[k, s])
                msg = _shift_msg_indexes(
                    Message(
                        type=MessageType(mt),
                        to=node.replica_id,
                        from_=int(sub.from_id[k, s]),
                        shard_id=node.shard_id,
                        term=int(sub.term[k, s]),
                        log_term=int(sub.log_term[k, s]),
                        log_index=int(sub.log_index[k, s]),
                        commit=int(sub.commit[k, s]),
                        reject=bool(sub.reject[k, s]),
                        hint=int(sub.hint[k, s]),
                        hint_high=int(sub.hint_high[k, s]),
                    ),
                    base,
                )
                ents = []
                ok = True
                if mt == MT_REPLICATE and n > 0:
                    for j in range(n):
                        e = self._cache_lookup(
                            r,
                            msg.log_index + 1 + j,
                            int(sub.ent_term[k, s, j]),
                        )
                        if e is None:
                            ok = False
                            break
                        ents.append(e)
                if not ok:
                    continue
                if ents:
                    msg = dataclasses.replace(msg, entries=tuple(ents))
                node.enqueue_received(msg)
        # drained => CLEARED: the pending copies are dead the moment
        # they re-enter the host queues.  Without this, a shard rebase
        # that re-uploads its rows in the SAME step re-delivers the
        # stale copies with index lanes encoded against the OLD base
        #; the host-excursion path only survived it because
        # drained rows stayed dirty through the next launch's alive mask.
        mask = np.zeros((self.capacity,), bool)
        mask[[g for _, g in pairs]] = True
        self._pending = self._on_blocks(
            "zero_inbox_rows", _zero_inbox_rows, self._pending,
            self._put_rows(mask), parity=self._parity_every > 0,
        )

    # -- the launch pipeline -------------------------------------------
    def _fence(self) -> None:
        """Drain the pipeline to depth 0, run the deferred membership
        actions and persist every drained update — invoked before any
        membership mutation (evict/detach/rebase/stale re-attach).
        No-op when nothing is in flight or deferred.  Caller holds the
        core lock; must NOT be called from inside a generation's merge
        (those paths defer instead — see _evict_rows_to_host)."""
        if not self._inflight and not self._deferred:
            self._flush_free_pending()
            return
        if self._inflight:
            self.stats["pipeline_fences"] += 1
        updates = self._drain_pipeline()
        if updates:
            self._drain_update_retries(updates)
            self._persist_and_process(updates, self._last_worker_id)

    def _drain_pipeline(self) -> List[Tuple]:
        """Complete every in-flight generation in dispatch order, then
        run the deferred actions; returns the updates to persist."""
        updates: List[Tuple] = []
        while self._inflight:
            updates.extend(self._complete_oldest())
        updates.extend(self._run_deferred())
        self._flush_free_pending()
        return updates

    def _complete_oldest(self) -> List[Tuple]:
        rec = self._inflight.popleft()
        self._completing = True
        try:
            return self._complete_generation(rec)
        except BaseException:
            # the generation chain is poisoned (its outputs feed every
            # later in-flight handle): roll the resident set back to
            # the last merged generation
            self._reset_after_pipeline_failure()
            raise
        finally:
            self._completing = False

    def _run_deferred(self) -> List[Tuple]:
        """Execute deferred membership actions (escalation replays,
        snapshot-below/save-failure evictions, demotes) in the order
        they were recorded — only at depth 0, so every generation that
        stepped the affected rows has merged first.  Returns updates to
        persist.  Reentrancy guard: an action's own eviction fences,
        which calls back here — the inner call no-ops and the outer
        loop keeps draining."""
        if self._running_deferred or self._inflight:
            return []
        updates: List[Tuple] = []
        self._running_deferred = True
        try:
            while self._deferred and not self._inflight:
                action = self._deferred.pop(0)
                kind = action[0]
                if kind == "esc":
                    updates.extend(
                        self._apply_escalation(action[1], action[2],
                                               action[3])
                    )
                elif kind == "evict":
                    # covers mid-merge demotes and save-failure
                    # quarantine evictions too — both defer through
                    # _evict_rows_to_host's completing check
                    self._evict_rows_to_host(action[1], action[2])
                elif kind == "below":
                    self._apply_snapshot_below(action[1])
        finally:
            self._running_deferred = False
        return updates

    def _apply_escalation(self, node, g: int, si) -> List[Tuple]:
        """Deferred kernel-escalation recovery — the pipeline-safe form
        of the serial restore-and-replay.  The device already restored
        the row's pre-step state (_route_step's suppress mask), and any
        LATER in-flight generation re-stepped it from there: a valid
        raft evolution whose routed acks were delivered, so its effects
        merged normally before this runs (FIFO drain).  Recovery is
        therefore a plain eviction of the row's CURRENT device state
        (drains pending routed traffic, materializes, marks dirty)
        followed by a scalar replay of the escalated generation's
        drained inputs — late replay of messages/proposals/ticks is
        raft-safe, and at depth 1 the current state IS the restored
        pre-step state, so this degenerates to the old serial shape."""
        meta = self._meta.get(g)
        if meta is None or meta.node is not node or node.stopped:
            return []
        self._evict_rows_to_host([g], "escalation")
        meta = self._meta.get(g)
        if meta is None:  # halted during the eviction's materialize
            return []
        meta.set_escalation_hold(node.config)
        if si is None:
            return []  # routed-only inputs: raft-safe to lose
        u = node.step_with_inputs(si)
        return [(node, u)] if u is not None else []

    def _apply_snapshot_below(self, below) -> None:
        """Deferred snapshot-below host excursion: evict the rows (the
        int32 lane can't represent the durable snapshot index), then
        mark the scalar remotes SNAPSHOT — after the materialize, which
        would otherwise overwrite them and re-fire duplicate full
        snapshot streams on every re-upload."""
        self._evict_rows_to_host(
            sorted({t[0] for t in below}), "snapshot_below"
        )
        for g, p, _, pid, ss_index in below:
            meta = self._meta.get(g)
            if meta is None or meta.node.stopped:
                continue
            rm = meta.node.peer.raft.get_remote(pid)
            if rm is not None:
                rm.become_snapshot(ss_index)

    def _floor_wait(self, t_req: float) -> None:
        """Simulated sync latency: data counts as landed no
        earlier than the floor after the D2H request was issued.  A
        request issued at dispatch and collected after host work pays
        only the remainder — the overlap the pipeline exists for."""
        if self._sync_floor_s <= 0:
            return
        import time as _time

        rem = self._sync_floor_s - (_time.monotonic() - t_req)
        if rem > 0:
            _time.sleep(rem)
            self.stats["t_sync_wait_ms"] += rem * 1000.0

    def _collect_blob(self, rb: "_Readback", t_req: float) -> np.ndarray:
        """THE launch readback: blocking collect of a blob whose copy
        into its pinned buffer was requested at dispatch — waits on the
        copy's event before the buffer is read — honoring the
        sync-floor shim."""
        arr = rb.numpy()
        self._floor_wait(t_req)
        return arr

    def _reset_after_pipeline_failure(self) -> None:
        """A launch program failed after later generations chained onto
        its outputs: every in-flight handle (state, pending regions,
        blobs) is transitively poisoned.  Roll the WHOLE resident set
        back to the last merged generation: scalar state is
        authoritative through it, and the unmerged generations' effects
        existed only device-side — appends and the acks they earned
        vanish TOGETHER for every colocated row (one shared device
        state), which is raft-safe message loss.  Rows re-upload from
        scratch on their next step."""
        # keep the one-readback identity (readback_windows + in-flight
        # == launches + sel_fallbacks, the fused-round smoke's gate) an
        # invariant across resets: the discarded generations' windows
        # will never be collected, so account them here
        self.stats["readback_windows"] += len(self._inflight)
        self._inflight.clear()
        self._pending_live = False
        self._flush_free_pending()
        for g, meta in list(self._meta.items()):
            if not meta.dirty:
                meta.dirty = True
                meta.plan_ok = False
                if meta.node.device_reads.has_pending():
                    meta.node.drop_device_reads()
        try:
            self._state = self._inert_state()
            self._pending = self._fresh_pending()
        except Exception:  # noqa: BLE001 — rebuilt lazily next launch
            self._pending = None

    # -- the colocated step --------------------------------------------
    def step_shards(self, nodes, worker_id: int) -> None:
        if all(n.stopped or n.stopping for n in nodes):
            # teardown fast path: don't contend for the core lock (the
            # owning worker may be asked to stop while we'd be queued
            # behind another member's multi-second launch)
            return
        # floor pre-wait: never hold the core lock just to wait out a
        # readback's latency floor.  Two shapes paid the floor IN the
        # lock and stalled every other worker's fresh proposal behind
        # ~a full floor (measured: the unloaded probe sat at ~2
        # floors): (a) the poke-driven idle drain (no node has work —
        # the call exists only to merge the tail generation) blocking
        # on the oldest collect, and (b) the dispatch room check with
        # the pipe FULL, blocking on the oldest collect before a new
        # generation may launch.  Both waits are for the SAME event —
        # the oldest in-flight readback reaching its floor — so sleep
        # it out here in small slices with the lock free: an idle call
        # aborts the moment any of its nodes gains real work (it can
        # then dispatch), a full-pipe call waits regardless (it needs
        # the room anyway).  Racy peeks of the in-flight deque are
        # benign — the in-lock paths re-check everything.
        if self._sync_floor_s > 0 and self._inflight:
            import time as _time

            # bounded at ONE floor from entry: under multi-worker
            # contention the oldest in-flight keeps getting fresher
            # (another worker merges + redispatches), and an unbounded
            # re-wait could starve this worker's nodes — past the
            # bound it falls into the lock and blocks there exactly as
            # before (correctness never depended on the pre-wait)
            _cap = _time.monotonic() + self._sync_floor_s
            while _time.monotonic() < _cap:
                if not self._inflight:
                    break
                try:
                    t_req = self._inflight[0].t_req  # racy peek
                except IndexError:
                    break
                rem = t_req + self._sync_floor_s - _time.monotonic()
                if rem <= 0:
                    break
                if (
                    len(self._inflight) < self._pipeline_depth
                    and any(n.has_work() for n in nodes)
                ):
                    break
                _time.sleep(min(rem, 0.002))
        with self._lock:
            self._step_colocated(nodes, worker_id)

    def _coalesce(self, nodes) -> List:
        """Pull every other attached node with queued work into this
        launch: a full-width kernel step costs the same whether it
        carries one member NodeHost's inputs or all of them, so one
        launch serves the whole cluster's tick generation instead of
        one launch per member (at 10k shards x 5 members that is the
        difference between 1 and 5 multi-second launches per
        generation).  Safe under the core lock: ALL colocated node
        stepping happens inside it, so no other worker can be draining
        these queues concurrently."""
        # throttle: the scan is O(resident rows) of pure Python and ran
        # once per generation — ~1000 small preload generations during a
        # 50k-row mass start made it the single largest cost of a scale
        # run.  Skipping it is always SAFE: a node with
        # work was notified, so its own exec worker delivers it in
        # `nodes` on an upcoming generation; coalescing is a batching
        # optimization, not a delivery guarantee.
        import time as _time

        now = _time.monotonic()
        # interval scales with the measured scan cost (>=10x) so the
        # scan can never consume more than ~10% of wall time: at 250k
        # resident rows one scan is 1-2 s of Python and a fixed 200 ms
        # interval let it dominate the 50k-shard election
        if now - self._last_coalesce_scan < max(0.2, 10 * self._scan_cost):
            return list(nodes)
        self._last_coalesce_scan = now
        seen = {id(n) for n in nodes}
        out = list(nodes)
        for meta in self._meta.values():
            n = meta.node
            if (
                id(n) not in seen
                and not n.stopped
                and not n.stopping
                and n.has_work()
            ):
                seen.add(id(n))
                out.append(n)
        self._scan_cost = _time.monotonic() - now
        coalesced = len(out) - len(nodes)
        if coalesced:
            self.stats["coalesced_rows"] += coalesced
        return out

    def _maybe_rebase_shards(self, nodes) -> None:
        """Whole-shard group rebasing (the colocated 64-bit story).

        When any row's committed outruns its shard's shared base by
        ``rebase_chunk``, every RESIDENT row of that shard leaves the
        device together — in-flight routed traffic drains to the host
        queues first, so no rebased int32 lane survives the base change
        — and the shard's base advances to the largest W-multiple safe
        for ALL its rows (min across rows; leader rows bound it by
        their laggiest peer lane).  Rows re-upload with the new base on
        their next step.  Reference: uint64 log indexes throughout
        raftpb [U]; this keeps the colocated device path unbounded
        instead of aging shards off at 2^31."""
        need = set()
        for node in nodes:
            if node.stopped or node.stopping:
                continue
            r = node.peer.raft
            shard = node.shard_id
            if (
                r.log.committed - self._shard_base.get(shard, 0)
                >= self._rebase_chunk
                and r.log.committed >= self._rebase_block.get(shard, 0)
            ):
                need.add(shard)
        if not need:
            return
        # the trigger uses committed (device-synced every step); the
        # CANDIDATE base needs fresh peer lanes, which only materialize
        # refreshes — so pull the shard's rows off the device first,
        # then decide.  If the candidate cannot advance (a lagging peer
        # lane or a freshly joined replica pins the min), the base must
        # neither regress nor be retried every step: back off until committed grows by
        # another chunk.
        self._evict_rows_to_host(
            [g for (shard, _), g in self._row_of.items() if shard in need],
            "rebase",
        )
        for shard in need:
            rafts = [
                self._meta[g].node.peer.raft
                for (s, _), g in self._row_of.items()
                if s == shard and self._meta.get(g) is not None
            ]
            if not rafts:
                continue
            candidate = min(
                TorchStepEngine._compute_base(self, r) for r in rafts
            )
            if candidate > self._shard_base.get(shard, 0):
                self._shard_base[shard] = candidate
                self._rebase_block.pop(shard, None)
                self.stats["shard_rebases"] += 1
            else:
                # back off by a FRACTION of the chunk, not a whole one:
                # a full-chunk block scheduled the retry at ~2x chunk,
                # which under the default chunk (2^30) lands at/past the
                # int32 planner ceiling — a transiently lagging peer
                # then doomed the shard to a whole-shard scalar eviction
                # even though a valid rebase opened up long before.
                # chunk//8 keeps the thrash amortized (one materialize
                # per chunk//8 commit growth) while leaving ~8 retries
                # of headroom before the ceiling.
                self._rebase_block[shard] = (
                    max(r.log.committed for r in rafts)
                    + max(self.W, self._rebase_chunk // 8)
                )

    def _plan_device(self, node, si, mirror_leader: bool, g):
        # a replica rejoining a shard whose base already advanced past
        # its committed position cannot upload (its lanes would go
        # negative): scalar path until host-wire catch-up reaches the
        # base.  Rows known at rebase time can never be in this state —
        # the candidate min() is bounded by them.
        if node.peer.raft.log.committed < self._shard_base.get(
            node.shard_id, 0
        ):
            return None
        return super()._plan_device(node, si, mirror_leader, g)

    def _step_colocated(self, nodes, worker_id: int) -> None:
        import time as _time

        self._last_worker_id = worker_id
        # ---- opportunistic completion: the earliest ripe sync -------
        # Merge any in-flight generation whose readback has LANDED
        # (floor elapsed, value ready) without blocking: proposals
        # complete from the earliest sync that proves their commit, not
        # from the pipe-full room check several generations later.
        # Runs before planning, so the plan also sees the freshest
        # merged scalars the link can provide.
        ripe: List[Tuple] = []
        while self._inflight:
            rec = self._inflight[0]
            if self._sync_floor_s > 0:
                import time as _t

                if _t.monotonic() - rec.t_req < self._sync_floor_s:
                    break
            # EVERY round's blobs must have landed: the merge may read
            # any round's detail payload too, and blocking the core
            # lock on a still-in-flight transfer is exactly the stall
            # this non-blocking pass exists to avoid
            if not all(rb.is_ready() for rb in rec.readbacks()):
                break
            ripe.extend(self._complete_oldest())
        if ripe:
            self._drain_update_retries(ripe)
            self._persist_and_process(ripe, worker_id)
        if self._deferred:
            # deferred membership actions (recorded mid-merge, e.g. a
            # save-failure eviction during the caller's persist or an
            # escalation a ripe completion just surfaced) run before
            # anything new dispatches
            self._fence()
        updates: List[Tuple] = []
        host_rows: List[Tuple] = []
        batch: List[Tuple] = []
        _t0 = _time.time_ns()
        nodes = self._coalesce(nodes)
        self._maybe_rebase_shards(nodes)
        self.stats["t_coalesce_ms"] += profiling.stage(
            "colocated.coalesce", _t0)
        _t0 = _time.time_ns()
        n_fast = 0
        # ---- batched plan classifier --------------------------------
        # ONE vectorized pass over the SoA lanes (ops/hostplane.py)
        # decides static eligibility for the whole generation —
        # plan_ok/dirty/esc_hold as bool lanes instead of per-row
        # _RowMeta attribute probes.  Rows that pass still re-verify
        # the cheap per-launch dynamic conditions (empty queues, clean
        # binding, no snapshot/read state) inline; rows that fail take
        # the scalar _plan_device classifier below — the escalation/
        # slow-path oracle, exactly the contract the plan_ok fast tick
        # lane (57 µs -> 5 µs per row) proved.
        row_of = self._row_of
        gs_list = [
            row_of.get((n.shard_id, n.replica_id), -1) for n in nodes
        ]
        static_arr = hostplane.classify_static(
            self._lanes, np.asarray(gs_list, np.int64)
        )
        if hostplane.PARITY:
            hostplane.check_classify_parity(
                self._lanes, gs_list, static_arr
            )
        static_ok = static_arr.tolist()
        # rows of nodes seen stopping THIS generation: cleared from the
        # launch's alive mask (their detach may still be queued behind
        # the core lock)
        self._gen_stopping = []
        for i, node in enumerate(nodes):
            if node.stopped or node.stopping:
                if gs_list[i] >= 0:
                    self._gen_stopping.append(gs_list[i])
                continue
            # ---- fast tick lane -------------------------------------
            # A clean resident row whose ONLY input is the lock-free
            # tick lane skips the drain lock and the full classifier:
            # the static checks were proven by the last full plan
            # (the plan_ok lane, batch-checked above) and everything
            # that can change them either arrives through the queues
            # (checked empty right here, GIL-atomic truthiness) or
            # invalidates plan_ok at its source.  The full per-row plan
            # costs an order of magnitude more than this lane.
            g = gs_list[i]
            meta = self._meta.get(g) if static_ok[i] else None
            if (
                meta is not None
                and meta.node is node  # not a stale pre-restart binding
                and node not in self._save_quarantine
                and not (
                    node._received
                    or node._proposals
                    or node._read_indexes
                    or node._config_changes
                    or node._cc_to_apply
                    or node._snapshot_reqs
                    or node._leader_transfers
                )
            ):
                r = node.peer.raft
                if not (
                    r.snapshotting
                    or r.read_index.pending
                    or r.read_index.queue
                ):
                    # ONE shared definition of the tick drain/cap/defer
                    # arithmetic (node.drain_ticks_only) — see its
                    # locking contract: this worker holds the core lock
                    ticks, gc_t = node.drain_ticks_only(
                        r.election_timeout // 2
                    )
                    q = node.quiesce
                    if q.enabled and ticks:
                        busy = bool(self._behind[g])
                        no_leader = int(self._mirror[_R_LEADER, g]) == 0
                        was = q.quiesced
                        ticks_dev = q.tick_n(ticks, busy=busy,
                                             block=no_leader)
                        if q.quiesced and not was:
                            node.broadcast_quiesce_enter()
                    else:
                        ticks_dev = ticks
                    n_fast += 1
                    if ticks_dev:
                        si = StepInputs(ticks=ticks, gc_ticks=gc_t)
                        batch.append(
                            (node, g, si, [("tick", ticks_dev)])
                        )
                    else:
                        _tick_bookkeeping(node, ticks + gc_t)
                    continue
            # ---- full path ------------------------------------------
            si = node.drain_step_inputs()
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
            # every static eligibility check passed: arm the fast lane
            self._meta[g].plan_ok = True
            if not plan and not self._meta[g].dirty:
                _tick_bookkeeping(node, si.ticks + si.gc_ticks)
                continue
            batch.append((node, g, si, plan))

        self._evict_rows_to_host([
            g
            for node, _si in host_rows
            if (g := self._row_of.get(self._row_key(node))) is not None
        ], "host_plan")

        # host path runs under the core lock in colocated mode: update
        # construction for OTHER hosts' rows happens inside launches, so
        # one lock must order both (the per-host parallelism the base
        # engine preserves is deliberately traded away here)
        for node, si in host_rows:
            if node.stopped:
                continue
            u = node.step_with_inputs(si)
            self.stats["host_rows_stepped"] += 1
            if u is not None:
                updates.append((node, u))

        if n_fast:
            self.stats["fast_lane_rows"] = self.stats.get(
                "fast_lane_rows", 0
            ) + n_fast
        self.stats["t_plan_ms"] += profiling.stage("colocated.plan", _t0)
        launched = False
        if batch or self._pending_live:
            if self._pending_live or any(plan for _, _, _, plan in batch):
                _t0 = _time.time_ns()
                dirty_lane = self._lanes.dirty  # one load; np bool [G]
                self._upload_rows(
                    [
                        (g, node.peer.raft)
                        for node, g, si, plan in batch
                        if dirty_lane[g]
                    ]
                )
                self.stats["t_upload_ms"] += profiling.stage(
                    "colocated.upload", _t0)
                self._launch_generation(batch)
                launched = True
            else:
                # pure preload: nothing to step and no routed traffic in
                # flight — skip the launch AND the upload (mass start
                # streams thousands of such registrations, and the
                # incremental small-batch preload uploads dominated the
                # start loop).  Rows
                # stay dirty/host-authoritative and upload lazily in
                # the first generation that actually steps them.
                # Clock bookkeeping matches what the launch path's live
                # loop would have done for these rows: si.ticks still
                # counts quiesce-swallowed ticks, gc_ticks the dropped.
                for node, g, si, plan in batch:
                    _tick_bookkeeping(node, si.ticks + si.gc_ticks)

        # ---- pipeline completion ------------------------------------
        # Depth 1 completes its own generation in-call (the serial
        # loop).  At depth >= 2 a dispatched generation stays in flight
        # until the pipe is FULL at the next dispatch (the room check
        # inside _launch_generation): its readback — requested at
        # dispatch — then stays in flight for a full pipeline's worth
        # of host work (plan/upload/dispatch of the following
        # generations), which is what turns the sync floor from a
        # per-generation cost into a hidden one.  An idle call (nothing
        # to launch) drains fully so no generation waits on work that
        # never comes, and a completion that recorded deferred
        # membership actions forces a full drain — they must run
        # before the next dispatch.
        if (not launched) or self._pipeline_depth == 1 or self._deferred:
            while self._inflight:
                updates.extend(self._complete_oldest())
        if self._deferred and not self._inflight:
            updates.extend(self._run_deferred())
        self._flush_free_pending()

        self._drain_update_retries(updates)
        if updates:
            _t0 = _time.time_ns()
            self._persist_and_process(updates, worker_id)
            self.stats["t_persist_ms"] += profiling.stage(
                "colocated.persist", _t0)
        if self._inflight:
            # completion guarantee: a dispatched generation must be
            # merged even if no member ever has work again — poke ONE
            # live node so some worker calls back in (that call,
            # finding nothing to launch, drains the pipeline).  One
            # notify suffices and per-generation fan-out to the whole
            # batch measurably serialized the 1-core bench.  A
            # pending-live-only launch has an EMPTY batch (review
            # finding), so fall back to any alive resident node.
            poked = False
            for node, _g, _si, _plan in batch:
                if not node.stopped and node.notify_work is not None:
                    node.notify_work()
                    poked = True
                    break
            if not poked:
                for g in np.nonzero(self._lanes.alive_mask())[0].tolist():
                    meta = self._meta.get(g)
                    if (
                        meta is not None
                        and not meta.node.stopped
                        and meta.node.notify_work is not None
                    ):
                        meta.node.notify_work()
                        break

    def _sel_cover(self, G, caps, counts, sel_rows, sets):  # hostplane-hot
        """Index-array coverage of the device's single-sync row
        selection: when every host-side merge set is contained in the
        device-selected sections (and the counts fit the warmed
        capacity tier), return the five row->gather-position maps plus
        the vals source rows; ``None`` sends the launch down the exact
        two-sync fallback.  Replaces the old per-row ``*_at`` dict
        builds and ``all(g in …)`` membership scans (O(rows) Python per
        launch — pinned array-at-once by raftlint's host-loop rule)."""
        n_buf, n_slot, n_need, n_append, n_sum = counts
        if not (
            n_buf <= caps["b"] and n_slot <= caps["sl"]
            and n_need <= caps["n"] and n_append <= caps["a"]
            and n_sum <= caps["s"]
        ):
            return None
        rows_buf, rows_slot, rows_need, rows_append, rows_sum = sel_rows
        pos_buf = hostplane.pos_of(G, rows_buf[:n_buf])
        pos_slot = hostplane.pos_of(G, rows_slot[:n_slot])
        pos_need = hostplane.pos_of(G, rows_need[:n_need])
        pos_ring = hostplane.pos_of(G, rows_append[:n_append])
        pos_sum = hostplane.pos_of(G, rows_sum[:n_sum])
        if not (
            hostplane.covered(pos_buf, sets.buf_rows)
            and hostplane.covered(pos_slot, sets.slot_rows)
            and hostplane.covered(pos_need, sets.need_rows)
            and hostplane.covered(pos_ring, sets.append_rows)
            and hostplane.covered(pos_sum, sets.sum_rows)
        ):
            return None
        return (pos_buf, pos_slot, pos_need, pos_ring, pos_sum,
                rows_sum[:n_sum])

    def _bookkeeping_pass(self, live) -> None:
        """Batched tick bookkeeping for one generation's live rows —
        hoisted out of the merge loops so every row pays it exactly
        once, BEFORE any effects merge (and AFTER _lease_pass: lease
        window starts stamp the PRE-launch clock).  Zero-tick rows (a
        launch-rate above the wall-tick cadence makes them the
        majority) skip with two attribute loads; ticked rows advance
        both clocks and take the hint-gated single-lock pending-table
        sweep inside _tick_bookkeeping."""
        meta_get = self._meta.get
        for node, g, si in live:
            if si is None:
                continue
            t = si.ticks + si.gc_ticks
            if t and not node.stopped and meta_get(g) is not None:
                # _tick_bookkeeping, inlined (clock lockstep +
                # hint-gated single-lock pending-table sweep)
                tc = node.tick_count + t
                node.tick_count = tc
                node.peer.raft.tick_count += t
                if tc >= node.pending_deadline_hint[0]:
                    gc_tables(
                        node.pending_tables,
                        node.pending_deadline_hint, tc,
                    )

    def _lane_commit_pass(self, live, flags, pos_sum, pos_buf, pos_slot,
                          pos_need, vals_np, early_done) -> None:
        """Array-side update assembly for commit-only rows — the
        update-lane contract (docs/PARITY.md).

        Eligible: live rows with a values entry but no append, no
        host-visible outbox bytes, no proposal slots and no
        snapshot-needing peer — their whole merge is the scalar sync +
        commit advance + update emission, none of which touches the
        detail payload.  One ``plan_update_sync`` pass over the update
        lanes classifies their effects (``U_*`` bits vs the last
        synced words); the residual loop then only writes the scalar
        words that moved and collects ``(node, term, vote, commit,
        entries)`` LANE tuples for ONE batched ``_persist_lane_rows``
        call — no per-row ``get_update`` walk, no per-row Update/
        State/UpdateCommit objects.  On the pipelined path this still
        runs straight off the HEAD blob, so a proposal whose commit
        this generation proves completes without waiting for the
        detail payload (the early-completion win, kept).

        Rows with scalar-side residue (pending raft msgs / reads /
        drops / unsaved entries / snapshot — a resident-clean row
        should never accumulate any; defense in depth) fall back to
        the classic get_update emission.  Marks completed positions in
        ``early_done`` so the heavy loop skips them."""
        if not live:
            return
        # raftlint: ignore[sync-budget] host-built index array, not a device readback
        gs_all = np.asarray([g for _, g, _ in live], np.int64)
        sum_k = pos_sum[gs_all]
        eligible = (
            (sum_k >= 0)
            & ((flags[gs_all] & _F_APPEND) == 0)
            & (pos_buf[gs_all] < 0)
            & (pos_slot[gs_all] < 0)
            & (pos_need[gs_all] < 0)
        )
        if not eligible.any():
            return
        idx = np.nonzero(eligible)[0]
        gs = gs_all[idx]
        k_sel = sum_k[idx]
        old_w = self._ulanes.words[:, gs]
        uplan = hostplane.plan_update_sync(
            old_w, k_sel, vals_np, self._base[gs]
        )
        if hostplane.PARITY:
            hostplane.check_update_plan_parity(
                old_w, k_sel, vals_np, self._base[gs], uplan
            )
        # rows the loop below skips (stopped/halted mid-flight) are
        # freed and re-seeded at their next upload — bulk write is moot
        # for them, exactly the mirror-table argument
        self._ulanes.words[:, gs] = uplan.words
        ub_l = uplan.ubits.tolist()
        w_term = uplan.words[_R_TERM].tolist()
        w_vote = uplan.words[_R_VOTE].tolist()
        w_com = uplan.words[_R_COMMIT].tolist()
        w_lead = uplan.words[_R_LEADER].tolist()
        w_role = uplan.words[_R_ROLE].tolist()
        # rows eligible for the array-batched persist (hard-state
        # effect, slot-backed store; `eligible` already proved no heavy
        # sections) — the loop only records exceptions; commit rows
        # hand (node, entries) to the post-save apply leg
        so_mask = (
            ((uplan.ubits & (U_STATE | U_COMMIT)) != 0)
            & (self._lane_dbi[gs] >= 0)
        )
        so_drop: List[int] = []
        meta_get = self._meta.get
        lane_rows: List[Tuple] = []
        lane_append = lane_rows.append
        lane_apply: List[Tuple] = []
        fulls: List[Tuple] = []
        for j, ub, term, vote, committed, leader, role, so in zip(
            idx.tolist(), ub_l, w_term, w_vote, w_com, w_lead, w_role,
            so_mask.tolist(),
        ):
            node, g, si = live[j]
            early_done[j] = True
            if node.stopped or meta_get(g) is None:
                if so:
                    so_drop.append(j)
                continue
            r = node.peer.raft
            log = r.log
            im = log.inmem
            # NOTE: open-coded in lockstep with the engine lane branch
            # and the bench twin — see the note in engine._device_step
            if (
                r.msgs or r.ready_to_reads or r.dropped_entries
                or r.dropped_read_indexes or im.snapshot.index
                or im.saved_to + 1 - im.marker < len(im.entries)
            ):
                # residue: the classic path drains it
                if so:
                    so_drop.append(j)
                r.term, r.vote, r.leader_id = term, vote, leader
                r.role = _ROLE_OF[role]
                if committed > log.committed:
                    log.commit_to(committed)
                if (
                    role != _ROLE_LEADER_I
                    and node.device_reads.has_pending()
                ):
                    node.drop_device_reads()
                u = node.peer.get_update(
                    last_applied=node.sm.last_applied
                )
                node.dispatch_dropped(u)
                fulls.append((node, u))
                node._check_leader_change()
                continue
            if ub & U_STATE:
                r.term = term
                r.vote = vote
            if ub & U_LEADER:
                r.leader_id = leader
            if ub & U_ROLE:
                r.role = _ROLE_OF[role]
            if ub & U_LOST_LEAD and node.device_reads.has_pending():
                # leadership lost: confirmations will never arrive.
                # Exact for lane rows — device reads only register off
                # merged outbox messages (a heavy row by definition),
                # so any pending read predates this sync and the
                # losing transition is THIS generation's lane diff
                # (docs/PARITY.md "Update-lane contract").
                node.drop_device_reads()
            if ub & U_COMMIT:
                log.commit_to(committed)
                ce = log.entries_to_apply()
                if so:
                    lane_apply.append((g, node, ce))
                else:
                    lane_append((node, term, vote, committed, ce))
            elif ub & U_STATE and not so:
                # hard-state move without a slot-backed store
                lane_append((node, term, vote, committed, None))
            if ub & U_LEADER:
                node._check_leader_change()
        n_so = 0
        if so_mask.any():
            if so_drop:
                so_mask &= ~np.isin(idx, np.asarray(so_drop))
            ii = np.nonzero(so_mask)[0]
            n_so = len(ii)
            if n_so:
                gs_so = gs[ii]
                dbi = self._lane_dbi[gs_so]
                slots = self._lane_slot[gs_so]
                w = uplan.words
                app_by_db: Dict[int, List] = {}
                if lane_apply:
                    dbi_all = self._lane_dbi
                    for g2, node, ce in lane_apply:
                        app_by_db.setdefault(
                            int(dbi_all[g2]), []
                        ).append((node, ce))
                batches = []
                for d in np.unique(dbi).tolist():
                    m = dbi == d
                    im_ = ii[m]
                    batches.append((
                        self._lane_dbs[d], slots[m], w[_R_TERM][im_],
                        w[_R_VOTE][im_], w[_R_COMMIT][im_], live,
                        idx[im_], app_by_db.get(d, ()),
                    ))
                self._persist_lane_batches(
                    batches, self._last_worker_id
                )
        n = len(lane_rows) + len(fulls) + n_so
        if n:
            self.stats["early_completions"] += n
        if lane_rows:
            self._persist_lane_rows(lane_rows, self._last_worker_id)
        if fulls:
            self._persist_and_process(fulls, self._last_worker_id)

    def _launch_generation(self, batch) -> None:  # sync-hot
        """Assemble, upload and dispatch one generation, request its
        (head, detail) readback, and push the in-flight record — the
        merge tail runs later in _complete_generation (behind the
        device by up to pipeline_depth generations).  Caller holds the
        core lock."""
        # room check: the pipe holds up to depth dispatched-unmerged
        # generations; complete the oldest BEFORE adding a new one so
        # each readback stays in flight across a full pipeline's worth
        # of host work — completing right after dispatch (the naive
        # order) gave every readback only ONE cycle of overlap and
        # left half the floor exposed on the 1-core bench.  (An
        # "express" +1 slot for proposal-carrying waves was tried and
        # REVERTED: exceeding the depth makes the next dispatch drain
        # TWO generations, the second still mid-floor — a systematic
        # in-lock stall that measured worse than the wait it removed.)
        while len(self._inflight) >= self._pipeline_depth:
            room_updates = self._complete_oldest()
            if room_updates:
                self._drain_update_retries(room_updates)
                self._persist_and_process(
                    room_updates, self._last_worker_id
                )
        G, M, E, P, B = self.capacity, self.M, self.E, self.P, self.budget
        # staging keys in ASSEMBLED coordinates: the routed regions
        # (width P*B) come first, host slots after (see _assemble_inbox)
        msg_rows, staging, prop_rows, tick_fed = self._encode_batch(
            batch, slot_offset=P * B
        )
        # compact host-inbox upload: tick-only rows (the overwhelming
        # majority at scale) ride a [G] count vector built into an inbox
        # ON DEVICE; only rows with real host slots upload dense rows
        tick_counts = np.zeros((G,), np.int32)
        sparse: List[Tuple[int, List]] = []
        for node, g, si, plan in batch:
            msgs = msg_rows[g]
            if not msgs:
                continue
            m0 = msgs[0]
            if (
                len(msgs) == 1
                and int(m0.type) == MT_TICK
                and m0.hint == 0
                and m0.hint_high == 0
            ):
                tick_counts[g] = m0.log_index
            else:
                sparse.append((g, msgs))
        if self._tables_dirty:
            self._rebuild_tables()
        # ONE fused [G, 4] host upload for every per-launch [G] input
        # (alive, batch membership, proposal rows, fused tick counts):
        # each separate host-to-device copy pays its own latency
        combo_np = np.zeros((G, 4), np.int32)
        combo_np[:, _C_TICKS] = tick_counts
        # alive straight off the SoA lanes (attached & clean) — the old
        # per-launch Python scan over the whole meta table cost
        # ~0.5 µs/row (~125 ms/launch at 250k rows).  Stopping rows
        # must neither consume routed traffic nor be routable targets
        # (a stopped-but-undetached leader would keep winning device
        # elections while its host no longer publishes payloads to the
        # entry cache — healthy peers then fail-stop on
        # unreconstructible appends): STOPPED rows can never be
        # lane-alive because every stop path detaches first
        # (stop_shard/unregister, close/unregister_many, _halt_replica
        # all clear the lane before node.stop() runs); a STOPPING
        # not-yet-detached row is cleared here from this generation's
        # plan-loop observations, and for the at-most-one launch that
        # can race the detach's core-lock acquisition a stopping node
        # still merges and publishes payloads (see the stopping-row
        # merge contract below), so routed appends stay
        # reconstructible.
        alive_np = self._lanes.alive_mask()
        gen_stopping = getattr(self, "_gen_stopping", None)
        if gen_stopping:
            alive_np[gen_stopping] = False
        # raftlint: ignore[sync-budget] host-built index arrays, not device readbacks
        batch_gs = np.asarray(
            [g for _, g, _, _ in batch], np.int64
        )
        # raftlint: ignore[sync-budget] host-built index array, not a device readback
        prop_gs = np.asarray(prop_rows, np.int64)
        # ---- fused commit wave decision ------------------
        # Chain K rounds device-side only when the generation's pending
        # work is ROUTABLE: there is multi-round work to do (proposals
        # riding this launch, or routed traffic already in flight whose
        # delivery spawns responses) and nothing in sight mutates
        # membership — stopping rows, deferred actions, quarantined
        # saves, quarantined row slots and escalation holds all fence
        # to the single-round path, which keeps the detach-race
        # argument at its proven <=1-launch exposure (a K-round wave
        # would widen it to K).  Tick-only generations with an idle
        # route stay single-round: rounds 2..K would step an empty
        # inbox for every row.
        rounds = 1
        if self._fuse_rounds > 1 and (len(prop_gs) or self._pending_live):
            # multi-round work exists; fuse unless a fence condition
            # holds.  fused_fences counts ONLY this shape — routable
            # work forced single-round — so the stat carries fence
            # signal instead of drowning in idle tick generations
            #
            if (
                not gen_stopping
                and not self._deferred
                and not self._free_pending
                and not self._save_quarantine
                and not self._lanes.esc_hold.any()
            ):
                rounds = self._fuse_rounds
                self.stats["fused_waves"] += 1
                self.stats["fused_rounds_stepped"] += rounds
                _metrics.counter("fused_waves_total").add(1)
            else:
                self.stats["fused_fences"] += 1
        combo_np[:, _C_ALIVE] = alive_np
        combo_np[batch_gs, _C_BATCH] = 1
        combo_np[prop_gs, _C_PROP] = 1
        # the whole combo on every block's device: a block's programs
        # take its rows, and its lane pack reads the receivers' alive
        # lane in the global row order
        combo_all = self._blocks.put_each(combo_np)
        combo = placement.Sharded(tuple(
            c[slice(*self._blocks.span(d))] for d, c in enumerate(combo_all)))
        # the parity self-check (parity_every) re-runs every program of
        # every Nth launch through its plain version
        parity = (
            self._parity_every > 0
            and self.stats["launches"] % self._parity_every == 0
        )
        host_inbox = self._on_blocks(
            "host_inbox_from_ticks", _host_inbox_from_ticks, combo,
            M=M, E=E, parity=parity,
        )
        if sparse:
            nsb = _bucket(len(sparse))
            # pad with COPIES of the last real row: _pad_idx repeats its
            # g, and duplicate .at[idx].set() is only benign when every
            # duplicate writes identical data (an empty pad row would
            # race the real one and could zero its messages)
            batches = (
                [m for _, m in sparse]
                + [sparse[-1][1]] * (nsb - len(sparse))
            )
            sub, overflow = S.encode_inbox(batches, M, E)
            assert not overflow, (
                "planner let oversized rows through: "
                f"{[sparse[i][0] for i in overflow if i < len(sparse)]}"
            )
            pos = _pos_map(G, [g for g, _ in sparse])
            parts = list(host_inbox.parts)
            for d in range(self._blocks.D):
                pos_d = pos[slice(*self._blocks.span(d))]
                if (pos_d >= 0).any():
                    parts[d] = self._run(
                        "scatter_inbox_rows", _scatter_inbox_rows,
                        parts[d], self._put(pos_d, d), self._put(sub, d),
                        parity=parity,
                    )
            host_inbox = placement.Sharded(tuple(parts))

        old_state = self._state
        import time as _time

        if self._pending is None:
            # a prior launch failure dropped the pending inbox and could
            # not rebuild it (see the handler below)
            self._pending = self._fresh_pending()
        if _DEBUG_LAUNCH:
            # debug-only sync: how much PRIOR device work (uploads,
            # materialize, scatters) is in flight?
            import sys as _sys
            _td = _time.perf_counter()
            _occ = self._blocks.numpy([
                (h.mtype != 0).sum(dim=1) + (p.mtype != 0).sum(dim=1)
                for h, p in zip(host_inbox.parts, self._pending.parts)])
            print(
                f"[pre ] prior-work wait "
                f"{(_time.perf_counter() - _td) * 1000:.0f} ms "
                f"n_occ_max={int(_occ.max())} "
                f"occ_mean={float(_occ.mean()):.2f} "
                f"ticks_max={int(tick_counts.max())}",
                file=_sys.stderr, flush=True,
            )
        _t0 = _time.time_ns()
        try:
            with profiling.annotate("raft-colocated-step"):
                _t1 = profiling.begin()
                new_state, out = self._on_blocks(
                    "assemble_and_step", _assemble_and_step,
                    old_state, host_inbox, self._pending, combo,
                    out_capacity=self.O, parity=parity,
                )
                profiling.end("colocated.step", _t1)
                _t1 = profiling.begin()
                merged, regions, stats_dev, packed_dev, flags_dev, lane_k = (
                    self._route_blocks(old_state, new_state, out, combo,
                                       combo_all, parity)
                )
                profiling.end("colocated.route", _t1)
        except BaseException:
            # the launch failed part-way (an out-of-memory allocation,
            # a refused launch, a parity mismatch): drop the in-flight
            # routed traffic — raft-safe message loss — and start the
            # next launch from fresh pending regions.  Clear FIRST, then
            # try to rebuild — the rebuild itself allocates and can fail
            # under the same condition, so a None sentinel (rebuilt
            # lazily at the next launch) must never be skipped over.
            self._pending = None
            self._pending_live = False
            try:
                self._pending = self._fresh_pending()
            except Exception:  # noqa: BLE001 — next launch rebuilds
                pass
            raise
        # from here the generation is the new device truth: the next
        # launch (possibly dispatched before this one merges) chains on
        # merged/regions.  A failure past this point poisons the chain
        # and takes the pipeline-reset recovery instead.
        self._pending = regions
        self._state = merged
        try:
            with profiling.annotate("raft-colocated-select"):
                # the wave's one commit-proving readback, requested NOW
                # and collected at merge time: flags + delivered +
                # counts + row ids + vals in each round's head, heavy
                # sections in its detail (see _select_and_blob).  Every
                # round's pair is copied into its own pinned buffers at
                # dispatch (_Readback, one a row block), so the whole
                # wave's blobs land in ONE readback window while the
                # host assembles and dispatches the NEXT generation.
                caps = self._tier_caps(self._sel_tier)
                bcaps = self._block_caps(caps)
                merged_l, out_l = [merged], [out]
                head_l, detail_l, lane_l = [], [], [lane_k]

                def _sel(merged_k, out_k, stats_k, packed_k, flags_k):
                    head_dev, detail_dev = self._on_blocks(
                        "select_and_blob", _select_and_blob,
                        merged_k, out_k, stats_k, packed_k, flags_k,
                        combo, CAP_B=bcaps["b"], CAP_SL=bcaps["sl"],
                        CAP_N=bcaps["n"], CAP_A=bcaps["a"],
                        CAP_S=bcaps["s"], HOST_OFF=P * B, parity=parity,
                    )
                    head_l.append([_Readback(h) for h in head_dev.parts])
                    detail_l.append([_Readback(t) for t in detail_dev.parts])

                _sel(merged, out, stats_dev, packed_dev, flags_dev)
                # ---- fused wave: rounds 2..K, dispatched back-to-back
                # with NO host sync between rounds.  Each round is the
                # exact single-round program chain (assemble over the
                # previous round's routed regions with an EMPTY host
                # inbox — ticks and proposals fed once, in round 1 —
                # then step, route (and the lane between blocks), select),
                # so a K-round wave is bit-exact with K serial launches by
                # construction.  Every round routes with round 1's alive
                # lane (combo).
                for _k in range(1, rounds):
                    host_k = self._on_blocks(
                        "host_inbox_from_ticks", _host_inbox_from_ticks,
                        self._zero_combo, M=M, E=E, parity=parity,
                    )
                    new_k, out_k = self._on_blocks(
                        "assemble_and_step", _assemble_and_step,
                        self._state, host_k, self._pending, combo,
                        out_capacity=self.O, parity=parity,
                    )
                    (merged_k, regions_k, stats_k, packed_k, flags_k,
                     lane_kk) = self._route_blocks(
                        self._state, new_k, out_k, combo, combo_all, parity)
                    self._pending = regions_k
                    self._state = merged_k
                    merged_l.append(merged_k)
                    out_l.append(out_k)
                    lane_l.append(lane_kk)
                    _sel(merged_k, out_k, stats_k, packed_k, flags_k)
                lane_dev = ()
                if lane_k is not None:
                    # one readback a block of its rounds' lane stats rows
                    lane_dev = tuple(
                        _Readback(torch.stack([r[d] for r in lane_l]))
                        for d in range(self._blocks.D))
        except BaseException:
            self._reset_after_pipeline_failure()
            raise
        self.stats["t_device_ms"] += profiling.stage("colocated.device", _t0)
        self.stats["launches"] += 1
        self.stats["device_steps"] += rounds
        self.stats["device_rows_stepped"] += len(batch)
        if _DEBUG_LAUNCH:
            import sys as _sys

            print(
                f"[launch {self.stats['launches']}] tier="
                f"{self._sel_tier} batch={len(batch)} rounds={rounds} "
                f"inflight={len(self._inflight) + 1}",
                file=_sys.stderr, flush=True,
            )
        self._inflight.append(_InFlightGen(
            batch=batch, staging=staging, alive_np=alive_np,
            batch_gs=batch_gs, prop_gs=prop_gs, caps=caps,
            merged=merged_l, out=out_l, head_dev=head_l,
            detail_dev=detail_l, t_req=_time.monotonic(),
            tick_fed=tick_fed, rounds=rounds, lane_dev=lane_dev,
        ))

    def _route_blocks(self, old_state, new_state, out, combo, combo_all,
                      parity: bool):
        """One round's route step on every row block over its local view
        of the tables; with several blocks, the lane between them as
        ``route.make_sharded_round`` runs it (route.py:666-745): every
        block's route step packs its cross-block messages (``xlane_pack``
        with the alive lane, before its flag word), ``ring_shift`` moves
        the lane buffers, and each block adds what it received into its
        pending regions.  Returns (merged, regions, stats, packed, flags)
        as ``Sharded`` and the blocks' [8] lane stats rows (None with one
        block)."""
        P, B, E, D = self.P, self.budget, self.E, self._blocks.D
        if D == 1:
            return self._on_blocks(
                "route_step", _route_step, old_state, new_state, out,
                self._dest_dev, self._rank_dev, combo, PB=P * B, E=E,
                budget=B, parity=parity) + (None,)
        res = [
            self._run(
                "lane_route_step", _route_step, old_state.parts[d],
                new_state.parts[d], out.parts[d], self._dest_dev.parts[d],
                self._rank_dev.parts[d], combo.parts[d], PB=P * B, E=E,
                budget=B, parity=parity,
                lane=colocated_ref.Lane(*self._lane_tabs[d], combo_all[d],
                                        d, D, self._xbudget))
            for d in range(D)
        ]
        recv = ring_shift(self._blocks.mesh, [r[5] for r in res])
        lane = [
            self._run("lane_scatter", _lane_scatter, res[d][1], recv[d],
                      res[d][6], budget=B, parity=parity)[1]
            for d in range(D)
        ]
        outs = tuple(placement.Sharded(tuple(r[i] for r in res))
                     for i in range(5))
        return outs + (lane,)

    def _round_head(self, rec, rnd: int, lane):  # sync-hot
        """Round ``rnd``'s head, collected and parsed (``_parse_head``).
        With several row blocks their heads read as one: flags and
        delivered bits joined in row order, the route stats and section
        counts summed, each section's rows concatenated in block order
        with global row ids (stable per-block compactions of ascending
        row ranges: the global stable compaction), the values likewise;
        the lane's stats row (``lane[rnd]``, summed over the blocks) is
        folded into the route stats so that they count as the
        single-device route's: a message the lane carried as delivered,
        one it refused (PROPOSE, receiver not alive) as host_carried, its
        budget and ring drops as the route's — not as off-device, where
        each block's route put every message toward another block."""
        per, nw = self._blocks.per, (self.O + 31) // 32
        bcaps = self._block_caps(rec.caps)
        parts = [
            self._parse_head(self._collect_blob(rb, rec.t_req), bcaps, per,
                             nw)
            for rb in rec.head_dev[rnd]
        ]
        rec.heads[rnd] = parts
        if len(parts) == 1:
            return parts[0]
        counts = [p[3] for p in parts]
        rstats = sum(p[2].astype(np.int64) for p in parts)
        sent, delivered, budget, xlane, ring = lane[rnd][:5]
        refused = lane[rnd][7]
        rstats[0] += delivered
        rstats[1] -= sent + budget + ring + refused
        rstats[2] += budget
        rstats[3] += ring
        rstats[5] += refused
        self.stats["lane_sent"] += int(sent)
        self.stats["lane_delivered"] += int(delivered)
        self.stats["lane_dropped_xlane"] += int(xlane)
        rows = tuple(
            _join_sections(
                [p[4][i] + d * per for d, p in enumerate(parts)],
                [c[i] for c in counts], rec.caps[k])
            for i, k in enumerate(_SEL_KEYS))
        vals = _join_sections([p[5] for p in parts], [c[4] for c in counts],
                              rec.caps["s"])
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]), rstats,
                sum(c.astype(np.int64) for c in counts), rows, vals)

    def _round_detail(self, rec, rnd: int):  # sync-hot
        """Round ``rnd``'s detail, collected and parsed
        (``_parse_detail``); several blocks' sections joined as
        ``_round_head`` joins their rows (each block's first ``count``
        rows, in block order)."""
        bcaps = self._block_caps(rec.caps)
        dets = [self._parse_detail(self._collect_blob(rb, rec.t_req), bcaps)
                for rb in rec.detail_dev[rnd]]
        if len(dets) == 1:
            return dets[0]
        counts = [p[3] for p in rec.heads[rnd]]
        return tuple(
            _join_sections([dt[f] for dt in dets], [c[i] for c in counts],
                           rec.caps[_SEL_KEYS[i]])
            for f, i in enumerate(_DETAIL_SECTION))

    def _parse_head(self, head, caps, G: int, nw: int):  # sync-hot
        """Host-side parse of one round's head blob (_select_and_blob's
        head layout): flags, packed delivered bits, route stats, the
        five section counts, the five selected-row-id sections and the
        values block."""
        flags = head[:G]
        delivered_bits = (
            head[G:G + G * nw].view(np.uint32).reshape(G, nw)
        )  # [G, ceil(O/32)] u32
        _parse = [G + G * nw]

        def take(n, shape=None):
            part = head[_parse[0]:_parse[0] + n]
            _parse[0] += n
            return part.reshape(shape) if shape is not None else part

        rstats = take(6)
        sel_counts = take(5)
        sel_rows = (
            take(caps["b"]), take(caps["sl"]), take(caps["n"]),
            take(caps["a"]), take(caps["s"]),
        )
        sel_vals = take(caps["s"] * N_VALS, (caps["s"], N_VALS))
        return flags, delivered_bits, rstats, sel_counts, sel_rows, sel_vals

    def _parse_detail(self, det, caps):  # sync-hot
        """Host-side parse of one round's detail blob, re-padding the
        routed-region slot columns the device omitted (always unused
        for slot bookkeeping — forwarded PROPOSE never rides the
        routed regions)."""
        O, W, M, E = self.O, self.W, self.M, self.E
        PB = self.P * self.budget
        _dp = [0]

        def dtake(n, shape):
            part = det[_dp[0]:_dp[0] + n]
            _dp[0] += n
            return part.reshape(shape)

        buf_np = dtake(
            caps["b"] * O * N_FIELDS_BUF, (caps["b"], O, N_FIELDS_BUF)
        )
        sel_slot_base = dtake(caps["sl"] * M, (caps["sl"], M))
        sel_slot_term = dtake(caps["sl"] * M, (caps["sl"], M))
        sel_ent_drop = dtake(caps["sl"] * M * E, (caps["sl"], M, E))
        need_np = dtake(caps["n"] * self.P, (caps["n"], self.P))
        ring_t = dtake(caps["a"] * W, (caps["a"], W))
        ring_c = dtake(caps["a"] * W, (caps["a"], W))
        slot_base = np.concatenate([
            np.full((caps["sl"], PB), SLOT_UNUSED_I, np.int32),
            sel_slot_base,
        ], axis=1)
        slot_term = np.concatenate([
            np.zeros((caps["sl"], PB), np.int32), sel_slot_term
        ], axis=1)
        ent_drop = np.concatenate([
            np.zeros((caps["sl"], PB, E), np.int32), sel_ent_drop
        ], axis=1)
        return (buf_np, slot_base, slot_term, ent_drop, need_np,
                ring_t, ring_c)

    def _merge_intermediate_round(  # sync-hot
        self, rec, rnd, caps, sets, flags, delivered_bits, sel_counts,
        sel_rows, sel_vals, needs_max, touched, esc_seen,
    ) -> None:
        """Merge ONE intermediate round of a fused wave, in two legs:

        * HEAVY rows (appends, host-visible outbox bytes, round-1
          proposal slots, snapshot-needing rows) take the per-row
          merge: scalar sync from THIS round's values, append
          reconstruction against THIS round's ring (entries published
          to the shard cache round-by-round so a receiver's round k+1
          reconstructs exactly as across k+1 serial launches), message
          attachment against THIS round's delivered bits.  Their ONE
          get_update rides the final round (``touched``).  The
          snapshot-need SECTION itself is final-round-only — the need
          flag re-fires while the condition persists (benign refire) —
          but need-flagged rows still sync state here.
        * every other row of the round's values block takes the LANE
          pass — the same ``_lane_commit_pass`` a single-round
          generation runs.  This is load-bearing, not an optimization:
          the flags word's F_CHANGED is a per-ROUND delta, so a commit
          advance or granted vote landing in an intermediate round is
          INVISIBLE to the final round's flags — only the lane diff
          (new words vs last HOST sync) sees it.  Skipping this leg
          stranded mid-wave commits' futures forever (found by the
          one-readback test's first soak)."""
        import time as _time

        G = self.capacity
        n_buf_d, n_slot_d, n_need_d, n_append_d, n_sum_d = (
            int(x) for x in sel_counts
        )
        for key, need in (
            ("b", max(n_buf_d, len(sets.buf_rows))),
            ("sl", max(n_slot_d, len(sets.slot_rows))),
            ("n", max(n_need_d, len(sets.need_rows))),
            ("a", max(n_append_d, len(sets.append_rows))),
            ("s", max(n_sum_d, len(sets.sum_rows))),
        ):
            needs_max[key] = max(needs_max[key], need)
        slot_live = len(sets.slot_rows) if rnd == 0 else 0
        has_heavy = bool(
            len(sets.buf_rows) or len(sets.append_rows) or slot_live
        )
        if not has_heavy and not len(sets.sum_rows):
            # nothing host-visible happened this round: its detail
            # payload is never read (same contract as a pure
            # commit/tick generation)
            self.stats["detail_skipped"] = self.stats.get(
                "detail_skipped", 0
            ) + 1
            return
        _t0 = _time.time_ns()
        cover = self._sel_cover(
            G, caps,
            (n_buf_d, n_slot_d, n_need_d, n_append_d, n_sum_d),
            sel_rows, sets,
        )
        if cover is not None:
            pos_buf, pos_slot, pos_need, pos_ring, pos_sum, _src = cover
            vals_np = sel_vals[:n_sum_d]
            if has_heavy:
                (buf_np, slot_base, slot_term, ent_drop, _need_np,
                 ring_t, ring_c) = self._round_detail(rec, rnd)
            else:
                buf_np = slot_base = slot_term = ent_drop = None
                ring_t = ring_c = None
                self.stats["detail_skipped"] = self.stats.get(
                    "detail_skipped", 0
                ) + 1
        else:
            # exact host-side selection for this round (capacity
            # overflow): one extra sync round trip, charged one fresh
            # floor — identical to the single-round fallback
            self.stats["sel_fallbacks"] = (
                self.stats.get("sel_fallbacks", 0) + 1
            )
            self.stats["readback_windows"] += 1
            _tq = _time.monotonic()
            detail, vals_np = self._fetch(
                rec.merged[rnd].parts, rec.out[rnd].parts,
                (sets.buf_rows.tolist(), sets.slot_rows.tolist(),
                 sets.need_rows.tolist(), sets.append_rows.tolist()),
                sets.sum_rows.tolist(), self.M + self.P * self.budget,
                allow_fused=False,
            )
            self._floor_wait(_tq)
            if detail is not None:
                (buf_np, slot_base, slot_term, ent_drop, _need_np,
                 ring_t, ring_c) = detail
            else:
                buf_np = slot_base = slot_term = ent_drop = None
                ring_t = ring_c = None
            pos_buf = hostplane.pos_of(G, sets.buf_rows)
            pos_ring = hostplane.pos_of(G, sets.append_rows)
            pos_slot = hostplane.pos_of(G, sets.slot_rows)
            pos_need = hostplane.pos_of(G, sets.need_rows)
            pos_sum = hostplane.pos_of(G, sets.sum_rows)
        from .engine import SLOT_DROPPED

        stage_map = rec.staging if rnd == 0 else {}
        vals_l = vals_np.tolist() if vals_np is not None else None
        heavy_gs = set(sets.buf_rows.tolist())
        heavy_gs.update(sets.append_rows.tolist())
        # need-flagged rows sync state here (their SECTION waits for
        # the final round — benign refire); without this a
        # need-only row's mid-wave state change would strand like any
        # other non-final F_CHANGED
        heavy_gs.update(sets.need_rows.tolist())
        if rnd == 0:
            heavy_gs.update(sets.slot_rows.tolist())
        for g in sorted(heavy_gs):
            meta = self._meta.get(g)
            if meta is None or meta.node.stopped or vals_l is None:
                continue
            node = meta.node
            r = node.peer.raft
            base = int(self._base[g])
            k = int(pos_sum[g])
            if k < 0:
                continue  # heavy rows always carry values; defense
            sv = vals_l[k]
            term, vote, committed, leader, role, last = sv[:6]
            committed += base
            last += base
            # scalar sync BEFORE the merge — same order as the final
            # round's loop (see the noop-barrier note there)
            r.term, r.vote, r.leader_id = term, vote, leader
            r.role = _ROLE_OF[role]
            if (flags[g] & _F_APPEND) and int(pos_ring[g]) >= 0:
                try:
                    stamped = self._merge_appends(
                        r, g, int(sv[_R_APPEND_LO]) + base, last,
                        stage_map.get(g, {}),
                        int(pos_slot[g]) if rnd == 0 else -1,
                        slot_base, slot_term, ent_drop,
                        ring_t[int(pos_ring[g])],
                        ring_c[int(pos_ring[g])],
                        fallback=self._cache_lookup,
                        barrier=(
                            int(sv[_R_BARRIER_IDX]) + base,
                            int(sv[_R_BARRIER_TERM]),
                        ),
                        base=base,
                    )
                except RuntimeError:
                    od = self._entry_cache.get(r.shard_id)
                    _log.critical(
                        "[%d:%d] routed append reconstruction failed "
                        "in fused round %d; halting replica (cache "
                        "keys tail: %s)",
                        r.shard_id, r.replica_id, rnd,
                        list(od.keys())[-12:] if od else [],
                        exc_info=True,
                    )
                    self._halt_replica(g)
                    continue
                self._cache_put(r.shard_id, stamped)
            if committed > r.log.committed:
                r.log.commit_to(committed)
            if (
                role != int(RaftRole.LEADER)
                and node.device_reads.has_pending()
            ):
                node.drop_device_reads()
            if int(pos_buf[g]) >= 0 and buf_np is not None:
                bits = delivered_bits[g]
                dr = (
                    (bits[self._dw_word] >> self._dw_shift) & 1
                ).astype(bool)
                self._attach_messages(
                    r, node, buf_np[int(pos_buf[g])], int(sv[_R_COUNT]),
                    stage_map.get(g, {}), delivered_row=dr, base=base,
                )
            sk = int(pos_slot[g]) if rnd == 0 else -1
            if sk >= 0 and slot_base is not None:
                sb = slot_base[sk]
                drop = ent_drop[sk]
                for slot, ents in stage_map.get(g, {}).items():
                    if sb[slot] == SLOT_DROPPED:
                        r.dropped_entries.extend(ents)
                    elif sb[slot] >= 0:
                        r.dropped_entries.extend(
                            e for i_e, e in enumerate(ents)
                            if drop[slot, i_e]
                        )
            touched[g] = node
        # ---- lane leg: every OTHER row with values this round --------
        # The same lane commit pass a single-round generation runs —
        # heavy rows fall out of its eligibility mask by construction
        # (append flag / buf / slot / need positions), rows already
        # deferred to escalation recovery are excluded, and rows it
        # syncs update the lanes so the NEXT round's diff composes.
        if vals_np is not None and len(sets.sum_rows):
            live_k: List[Tuple] = [
                (node, g, si)
                for node, g, si, _plan in rec.batch
                if g not in esc_seen
            ]
            live_set = {g for _, g, _ in live_k}
            meta_get = self._meta.get
            for g in sets.live_other.tolist():
                if g in esc_seen or g in live_set:
                    continue
                meta = meta_get(g)
                if meta is not None:
                    live_k.append((meta.node, g, None))
            pos_slot_k = (
                pos_slot if rnd == 0
                else hostplane.pos_of(G, sets.slot_rows)
            )
            self._lane_commit_pass(
                live_k, flags, pos_sum, pos_buf, pos_slot_k, pos_need,
                vals_np, np.zeros((len(live_k),), bool),
            )
            # bulk mirror + update-lane write for the round's sum rows
            # — the final round's bulk write only covers rows flagged
            # in the FINAL round, and F_CHANGED is a per-round delta:
            # without this, a leader elected mid-wave left a
            # permanently stale leader=0 mirror, which blocked quiesce
            # parking on the whole shard (found by test_scale's
            # cold-kill gate).  Lane-pass rows were already written —
            # identical values, idempotent; heavy rows sync here.
            gs_sum = sets.sum_rows
            sum_pos = pos_sum[gs_sum]
            ok = sum_pos >= 0
            if ok.any():
                gs_ok = gs_sum[ok].astype(np.int64)
                w = vals_np[sum_pos[ok], :6].T
                # lease arm/disarm on role transitions observed THIS
                # round, probed against the PRE-write mirror — the
                # final _lease_pass compares against the mirror too,
                # and this write is about to refresh it, so a mid-wave
                # election win would otherwise never arm its
                # CheckQuorum lease (found by
                # test_device_lease_reads_colocated: a resident leader
                # whose win landed inside a wave held lease 0 forever)
                chg = np.nonzero(
                    w[_R_ROLE] != self._mirror[_R_ROLE, gs_ok]
                )[0]
                for i in chg.tolist():
                    g2 = int(gs_ok[i])
                    meta2 = self._meta.get(g2)
                    if meta2 is None or meta2.node.stopped:
                        continue
                    r2 = meta2.node.peer.raft
                    if (
                        int(w[_R_ROLE, i]) == _ROLE_LEADER_I
                        and r2.check_quorum
                    ):
                        self._lease.arm(g2, r2.election_timeout, 0)
                    else:
                        self._lease.disarm(g2)
                self._mirror[:6, gs_ok] = w
                w_abs = w.astype(np.int64)
                b_abs = self._base[gs_ok]
                w_abs[_R_COMMIT] += b_abs
                w_abs[_R_LAST] += b_abs
                self._ulanes.words[:, gs_ok] = w_abs
        self.stats["t_updates_ms"] += profiling.stage(
            "colocated.updates", _t0)

    def _complete_generation(self, rec: _InFlightGen) -> List[Tuple]:  # sync-hot
        """Merge one in-flight generation: collect each round's head
        (the earliest commit-proving sync), complete commit-only rows
        straight off the FINAL round's head, and read detail payloads
        (all in flight since dispatch) only for rounds with heavy
        sections.  A fused wave (rec.rounds > 1, the fused-wave design) unpacks its
        per-round delivered bits and heavy sections round by round —
        intermediate rounds merge appends/outboxes/round-1 slots into
        the scalar rafts, the final round runs the full single-round
        tail (lease, bookkeeping, lane commit pass, get_update) over
        the wave's end state, so every row emits at most ONE update
        per wave.  Caller holds the core lock; generations complete in
        dispatch order (_complete_oldest)."""
        import time as _time

        G, M, E, P, B = self.capacity, self.M, self.E, self.P, self.budget
        batch, staging, caps = rec.batch, rec.staging, rec.caps
        alive_np, batch_gs, prop_gs = (
            rec.alive_np, rec.batch_gs, rec.prop_gs
        )
        K = rec.rounds
        nw = (self.O + 31) // 32
        updates: List[Tuple] = []
        esc_seen: set = set()
        # rows whose scalar state an intermediate round already
        # mutated: they owe ONE get_update at the end of the wave even
        # if the final round left them quiet
        touched: Dict[int, object] = {}
        needs_max = {"b": 0, "sl": 0, "n": 0, "a": 0, "s": 0}
        empty_gs = np.zeros((0,), np.int64)
        # ONE readback window per generation: every round's blobs were
        # requested together at dispatch and share rec.t_req, so the
        # first collect pays the floor remainder and the rest land in
        # the same round trip — the one-readback-per-wave budget the
        # fused-round smoke asserts
        self.stats["readback_windows"] += 1
        # mesh mode: the wave's lane stats rows, summed over the blocks
        # ([rounds, 8]; each round's are folded into its route stats)
        lane = None
        if rec.lane_dev:
            lane = sum(self._collect_blob(rb, rec.t_req).astype(np.int64)
                       for rb in rec.lane_dev)
        for rnd in range(K):
            final = rnd == K - 1
            round_props = prop_gs if rnd == 0 else empty_gs
            _t0 = _time.time_ns()
            _tc = _time.monotonic()
            head = self._round_head(rec, rnd, lane)
            if rnd == 0 and self._pipeline_depth > 1:
                # host-side work done between the D2H request
                # (dispatch) and this collect ran concurrently with
                # the readback — the double-buffering win, visible
                # without hardware
                overlap = max(0.0, _tc - rec.t_req)
                if self._sync_floor_s > 0:
                    overlap = min(overlap, self._sync_floor_s)
                self.stats["pipeline_overlap_s"] += overlap
                _metrics.counter(
                    "pipeline_overlap_seconds_total"
                ).add(overlap)
            _ms = profiling.stage("colocated.blob", _t0)
            self.stats["t_dev_blob_ms"] = self.stats.get(
                "t_dev_blob_ms", 0.0) + _ms
            self.stats["t_device_ms"] += _ms
            (flags, delivered_bits, rstats, sel_counts, sel_rows,
             sel_vals) = head
            (sel_rows_buf, sel_rows_slot, sel_rows_need,
             sel_rows_append, sel_rows_sum) = sel_rows
            if final:
                self._behind = (flags & _F_PEERS_BEHIND) != 0
                self._pending_live = int(rstats[0]) > 0
            self.stats["routed_delivered"] += int(rstats[0])
            self.stats["routed_host_carried"] += int(rstats[5])
            self.stats["routed_dropped"] += int(
                rstats[1] + rstats[2] + rstats[3]
            )
            # per-cause breakdown (RouteStats order: the aggregate hid
            # which drop class dominates)
            self.stats["routed_dropped_off_device"] = self.stats.get(
                "routed_dropped_off_device", 0
            ) + int(rstats[1])
            self.stats["routed_dropped_budget"] = self.stats.get(
                "routed_dropped_budget", 0
            ) + int(rstats[2])
            self.stats["routed_dropped_ring"] = self.stats.get(
                "routed_dropped_ring", 0
            ) + int(rstats[3])

            # ---- merge row sets (array-at-once) ----------------------
            # ONE vectorized pass over the [G] flags word classifies
            # every row of the round (ops/hostplane.py).  The scalar
            # twins remain the parity oracle
            # (DRAGONBOAT_TPU_HOSTPLANE_PARITY runs both every round).
            sets = hostplane.build_merge_sets(
                flags, alive_np, batch_gs, round_props, G=G
            )
            hostplane.record_generation(
                flags, alive_np, batch_gs, round_props, G
            )
            if hostplane.PARITY:
                hostplane.check_merge_parity(
                    flags, alive_np, batch_gs, round_props, sets, G=G
                )

            # ---- escalations: DEFERRED to the pipeline drain ---------
            # The device already restored escalated rows (suppress mask
            # in _route_step) and suppressed their outboxes; later
            # rounds/generations re-stepped them from the restored
            # state, so the recovery (evict + scalar replay) runs only
            # at depth 0 (see _apply_escalation).  A wave records each
            # escalated row ONCE: the batch inputs are replayed only
            # when round 1 suppressed them — a row escalating first in
            # a LATER round consumed its inputs in round 1, so only
            # the routed-only (input-less) recovery applies, exactly
            # the cross-generation contract.
            n_esc = len(sets.esc_batch_pos) + len(sets.esc_other)
            if n_esc:
                self.stats["escalations"] += n_esc
                for i in sets.esc_batch_pos.tolist():
                    node, g, si, _plan = batch[i]
                    if g in esc_seen:
                        continue
                    esc_seen.add(g)
                    self._deferred.append(
                        ("esc", node, g, si if rnd == 0 else None)
                    )
                for g in sets.esc_other.tolist():
                    if g in esc_seen:
                        continue
                    meta = self._meta.get(g)
                    if meta is not None:
                        esc_seen.add(g)
                        # routed-only inputs: discarded (raft-safe)
                        self._deferred.append(("esc", meta.node, g, None))

            if not final:
                self._merge_intermediate_round(
                    rec, rnd, caps, sets, flags, delivered_bits,
                    sel_counts, sel_rows, sel_vals, needs_max, touched,
                    esc_seen,
                )
                continue

            # ================= FINAL round ===========================
            break  # fall through to the final-round tail below

        stage_map = staging if K == 1 else {}
        rnd = K - 1
        # ---- live rows: batch rows + any resident row with effects ----
        esc_keep = np.ones((len(batch),), bool)
        # every batch row whose device row escalated in ANY round of
        # the wave is excluded from the final merge (its recovery is
        # the deferred evict+replay above)
        esc_keep[[
            i for i, (_n, g, _s, _p) in enumerate(batch)
            if g in esc_seen
        ]] = False
        live: List[Tuple] = [
            (node, g, si)
            for (node, g, si, plan), k in zip(batch, esc_keep.tolist())
            if k
        ]
        live_gs = {g for _, g, _ in live}
        for g in sets.live_other.tolist():
            meta = self._meta.get(g)
            if meta is not None:
                live.append((meta.node, g, None))
                live_gs.add(g)
        # rows an intermediate round touched that the final round left
        # quiet still owe their get_update (merged appends/messages
        # must persist and dispatch)
        for g, node in touched.items():
            if g not in live_gs and g not in esc_seen:
                live.append((node, g, None))
                live_gs.add(g)

        buf_rows = sets.buf_rows
        append_rows = sets.append_rows
        slot_rows = sets.slot_rows
        need_rows = sets.need_rows
        sum_rows = sets.sum_rows
        n_buf_d, n_slot_d, n_need_d, n_append_d, n_sum_d = (
            int(x) for x in sel_counts
        )
        _t0 = _time.time_ns()
        # device-selected detail (the split-blob fast path): the head
        # already carries counts/row-ids/vals for the rows the DEVICE
        # selected with the same flag logic; verify the host's sets are
        # covered and fall back to an exact two-sync gather when not
        # (capacity overflow, or a row the device's live approximation
        # missed).  Coverage and row->gather-position maps are index
        # arrays (hostplane.pos_of/covered) — the old per-row dict
        # builds and `all(g in …)` membership scans were O(rows) Python
        cover = self._sel_cover(
            G, caps,
            (n_buf_d, n_slot_d, n_need_d, n_append_d, n_sum_d),
            (sel_rows_buf, sel_rows_slot, sel_rows_need,
             sel_rows_append, sel_rows_sum),
            sets,
        )
        dev_ok = cover is not None
        early_done = np.zeros((len(live),), bool)
        lease_done = False
        if dev_ok:
            pos_buf, pos_slot, pos_need, pos_ring, pos_sum, sum_src = cover
            if K > 1:
                # the DEVICE's slot selection keys off the wave-wide
                # prop mask (combo rides every round), but host slot
                # bookkeeping is round-1-only and round 1's
                # intermediate merge already consumed it — the final
                # round's host semantics (empty slot set) rule, or the
                # loop would index slot sections it never collected
                pos_slot = hostplane.pos_of(G, slot_rows)
            # live rows only: the padded capacity tail is garbage the
            # merge loop never indexes, and converting it cost tens of
            # ms/launch at storm-tier capacities
            sel_vals = sel_vals[:n_sum_d]
            vals_np = sel_vals
            # lease pass BEFORE bookkeeping: lease window starts must
            # stamp the PRE-launch clock (see _lease_pass); then ONE
            # batched bookkeeping pass for the whole generation
            self._lease_pass(live, flags, vals_np, pos_sum, rec.tick_fed)
            lease_done = True
            self._bookkeeping_pass(live)
            # ---- EARLY completion: the commit-proving prefix --------
            # A live row with values but NO append/outbox/slot/need
            # sections (the common shape: a leader whose routed acks
            # just advanced commit, a follower applying) needs nothing
            # from the detail payload — the LANE pass diffs its words
            # against the update lanes, syncs only what moved and
            # persists the whole set in one batched lane save NOW, so
            # proposals complete from the earliest sync that proves
            # their commit instead of waiting for the detail to land
            # and the heavy merge tail to run.
            self._lane_commit_pass(
                live, flags, pos_sum, pos_buf, pos_slot, pos_need,
                vals_np, early_done,
            )
            need_detail = bool(
                len(buf_rows) or len(append_rows)
                or len(slot_rows) or len(need_rows)
            )
            if need_detail:
                (buf_np, slot_base, slot_term, ent_drop, need_np,
                 ring_t, ring_c) = self._round_detail(rec, rnd)
            else:
                # pure commit/tick generation: the detail payload is
                # never read — on hardware its bytes still rode the
                # same round trip, and nothing here waits for them
                self.stats["detail_skipped"] = self.stats.get(
                    "detail_skipped", 0
                ) + 1
                buf_np = slot_base = slot_term = ent_drop = None
                need_np = ring_t = ring_c = None
        else:
            # exact host-side selection (the two-sync path) — an
            # extra sync round trip; the floor shim charges it one
            # fresh floor from request time
            self.stats["sel_fallbacks"] = (
                self.stats.get("sel_fallbacks", 0) + 1
            )
            self.stats["readback_windows"] += 1
            _tq = _time.monotonic()
            # the kernel ran on the ASSEMBLED inbox (host slots + routed
            # regions), so the out slot arrays are M + P*B wide
            detail, vals_np = self._fetch(
                rec.merged[rnd].parts, rec.out[rnd].parts,
                (buf_rows.tolist(), slot_rows.tolist(),
                 need_rows.tolist(), append_rows.tolist()),
                sum_rows.tolist(), M + P * B, allow_fused=False,
            )
            self._floor_wait(_tq)
            if detail is not None:
                (buf_np, slot_base, slot_term, ent_drop, need_np, ring_t,
                 ring_c) = detail
            else:
                buf_np = slot_base = slot_term = ent_drop = need_np = None
                ring_t = ring_c = None
            # position maps over the HOST-ordered gather sections (the
            # order the host built them in)
            pos_buf = hostplane.pos_of(G, buf_rows)
            pos_ring = hostplane.pos_of(G, append_rows)
            pos_slot = hostplane.pos_of(G, slot_rows)
            pos_need = hostplane.pos_of(G, need_rows)
            pos_sum = hostplane.pos_of(G, sum_rows)
            sum_src = sum_rows
        # tier selection: promote immediately to the smallest warmed
        # tier that fits this generation's needs — the max over EVERY
        # round of the wave (overflow used the exact fallback above,
        # once per overflowing round); demote only after 64
        # consecutive launches that would have fit the lower tier
        needs = {
            "b": max(needs_max["b"], n_buf_d, len(buf_rows)),
            "sl": max(needs_max["sl"], n_slot_d, len(slot_rows)),
            "n": max(needs_max["n"], n_need_d, len(need_rows)),
            "a": max(needs_max["a"], n_append_d, len(append_rows)),
            "s": max(needs_max["s"], n_sum_d, len(sum_rows)),
        }
        need_tier = len(_SEL_TIERS) - 1
        for t in range(len(_SEL_TIERS)):
            c = self._tier_caps(t)
            if all(needs[k] <= c[k] for k in c):
                need_tier = t
                break
        if need_tier > self._sel_tier:
            self._sel_tier = need_tier
            self._sel_fit_streak = 0
        elif need_tier < self._sel_tier:
            self._sel_fit_streak += 1
            if self._sel_fit_streak >= 64:
                self._sel_tier = need_tier
                self._sel_fit_streak = 0
        else:
            self._sel_fit_streak = 0
        self.stats["t_detail_ms"] += profiling.stage(
            "colocated.detail", _t0)
        # device-plane lease evidence (ROADMAP 4b): advance each batch
        # row's CheckQuorum window mirror and anchor the scalar voting
        # remotes when the quorum-active flag holds — BEFORE the bulk
        # mirror write below so role transitions are still observable.
        # The dev_ok path already ran this pass (pre-early-commit, so
        # window starts stamp the pre-launch clock); running it again
        # would feed tick_fed twice and halve the modeled window period.
        # On the exact-fallback path the bookkeeping + lane passes run
        # here instead (detail and position maps only just landed) —
        # same order as dev_ok: lease, bookkeeping, lane commit.
        if not lease_done:
            self._lease_pass(live, flags, vals_np, pos_sum, rec.tick_fed)
            self._bookkeeping_pass(live)
            if vals_np is not None:
                self._lane_commit_pass(
                    live, flags, pos_sum, pos_buf, pos_slot, pos_need,
                    vals_np, early_done,
                )
        # one C-level conversion for the merge loop's 10-ints-per-row
        # reads (numpy scalar -> int costs ~100 ns each)
        vals_l = vals_np.tolist() if vals_np is not None else None

        from .engine import SLOT_DROPPED

        _t0 = _time.time_ns()
        # ---- per-row effect merge, batch-indexed ---------------------
        # Everything the loop used to look up per row (gather positions
        # via the *_at dicts, flag probes, bases, delivered-bit unpack,
        # limit checks, mirror writes) is gathered ONCE here over the
        # [*, G] arrays; the residual per-row body below only mutates
        # the Python raft objects it must (scalar sync, append merge,
        # update construction) — see ops/hostplane.py.
        # raftlint: ignore[sync-budget] host-built index array, not a device readback
        gs_m = np.asarray([g for _, g, _ in live], np.int64)
        n_live = len(gs_m)
        if n_live:
            sum_k = pos_sum[gs_m]
            buf_k = pos_buf[gs_m]
            slot_k = pos_slot[gs_m]
            need_k = pos_need[gs_m]
            ring_k = pos_ring[gs_m]
            app_l = ((flags[gs_m] & _F_APPEND) != 0).tolist()
            bases_l = self._base[gs_m].tolist()
            sum_k_l = sum_k.tolist()
            buf_k_l = buf_k.tolist()
            slot_k_l = slot_k.tolist()
            need_k_l = need_k.tolist()
            ring_k_l = ring_k.tolist()
            # delivered bits unpacked for ALL buf rows in one shot (the
            # per-row word/shift unpack cost ~1-2 µs a row)
            has_buf = buf_k >= 0
            nb = int(has_buf.sum())
            if nb:
                bits = delivered_bits[gs_m[has_buf]]
                dr_pack = (
                    (bits[:, self._dw_word] >> self._dw_shift) & 1
                ).astype(bool)
                dr_at = np.full((n_live,), -1, np.int32)
                dr_at[has_buf] = np.arange(nb, dtype=np.int32)
                dr_at_l = dr_at.tolist()
            # bulk mirror write for every row the loop will merge
            # (rows it then skips — stopped/halted — are freed and
            # re-seeded at their next upload, so the write is moot)
            in_sum = sum_k >= 0
            if vals_np is not None and in_sum.any():
                self._mirror[:6, gs_m[in_sum]] = (
                    vals_np[sum_k[in_sum], :6].T
                )
                # update lanes follow for the HEAVY rows the loop below
                # syncs per-row (lane-pass rows were already written —
                # identical values, idempotent), absolute frame: the
                # next generation's lane diff must see what was synced
                w_abs = vals_np[sum_k[in_sum], :6].T.astype(np.int64)
                b_abs = self._base[gs_m[in_sum]]
                w_abs[_R_COMMIT] += b_abs
                w_abs[_R_LAST] += b_abs
                self._ulanes.words[:, gs_m[in_sum]] = w_abs
        if vals_np is not None and len(sum_src):
            # fast-lane invalidation, batch-wide: rows approaching an
            # int32 lane limit or streaming a snapshot re-run the full
            # plan (the only plan facts a DEVICE step can change;
            # everything else arrives via the host queues, which the
            # fast lane checks each launch).  Safe-side: clearing
            # plan_ok for a row the loop later skips only forces one
            # extra full plan.  (The fallback gather pads vals to a
            # bucket; only the first len(sum_src) rows are real.)
            v = vals_np[: len(sum_src)]
            over = (
                (v[:, _R_TERM] > _LIM_SOFT) | (v[:, _R_LAST] > _LIM_SOFT)
            )
            if over.any():
                # raftlint: ignore[sync-budget] host numpy row ids, not a device readback
                self._lanes.plan_ok[np.asarray(sum_src)[over]] = False
        if len(need_rows):
            self._lanes.plan_ok[need_rows] = False
        # (g, p, lane-or-None, pid, ss_index) — see _send_snapshots
        snapshot_sends: List[Tuple[int, int, Optional[int], int, int]] = []
        for j, (node, g, si) in enumerate(live):
            if early_done[j]:
                continue  # fully handled by the early commit pass
            # a STOPPING node still merges and persists this launch's
            # results: its device acks were already routed to peers in
            # this very launch, and dropping the corresponding append
            # persist would let an acked entry vanish on restart — the
            # follower then wedges forever on the by-design
            # reject<=match floor (a chaos finding: kill racing a
            # launch left a replica acked-at-23 with a WAL at 22).
            # Only truly STOPPED nodes (logdb closing) are skipped; the
            # alive mask already keeps stopping rows out of the NEXT
            # launch.
            if node.stopped or self._meta.get(g) is None:
                continue
            r = node.peer.raft
            base = bases_l[j]  # the shard's shared base
            # (tick bookkeeping already ran in _bookkeeping_pass)
            k = sum_k_l[j]
            if k < 0:
                # no final-round flags, no slots — but a row an
                # intermediate round of the wave touched (merged
                # appends, attached messages, dropped slots) still
                # owes its ONE wave-end update: the scalar sync ran in
                # its last heavy round, so only the emission remains
                if g in touched:
                    u = node.peer.get_update(
                        last_applied=node.sm.last_applied
                    )
                    node.dispatch_dropped(u)
                    updates.append((node, u))
                    node._check_leader_change()
                # else: the row only ticked
                continue
            sv = vals_l[k]
            term, vote, committed, leader, role, last = sv[:6]
            committed += base
            last += base
            # scalar sync BEFORE the merge: the noop-barrier-vs-lost-
            # payload distinction in _merge_appends needs the POST-step
            # role (a row that just won its election self-appends the
            # barrier; its host mirror still says candidate)
            r.term, r.vote, r.leader_id = term, vote, leader
            r.role = RaftRole(role)
            if app_l[j]:
                try:
                    stamped = self._merge_appends(
                        r, g, int(sv[_R_APPEND_LO]) + base, last,
                        stage_map.get(g, {}), slot_k_l[j], slot_base,
                        slot_term, ent_drop, ring_t[ring_k_l[j]],
                        ring_c[ring_k_l[j]],
                        fallback=self._cache_lookup,
                        barrier=(
                            int(sv[_R_BARRIER_IDX]) + base,
                            int(sv[_R_BARRIER_TERM]),
                        ),
                        base=base,
                    )
                except RuntimeError:
                    # fail-stop THIS replica only (divergence policy);
                    # aborting the loop would strand every other row's
                    # merge and spread the inconsistency
                    od = self._entry_cache.get(r.shard_id)
                    _log.critical(
                        "[%d:%d] routed append reconstruction failed; "
                        "halting replica (cache keys tail: %s)",
                        r.shard_id, r.replica_id,
                        list(od.keys())[-12:] if od else [],
                        exc_info=True,
                    )
                    self._halt_replica(g)
                    continue
                self._cache_put(r.shard_id, stamped)
            if committed > r.log.committed:
                r.log.commit_to(committed)
            if (
                role != int(RaftRole.LEADER)
                and node.device_reads.has_pending()
            ):
                node.drop_device_reads()
            if buf_k_l[j] >= 0:
                self._attach_messages(
                    r, node, buf_np[buf_k_l[j]], int(sv[_R_COUNT]),
                    stage_map.get(g, {}), delivered_row=dr_pack[dr_at_l[j]],
                    base=base,
                )
            sk = slot_k_l[j]
            if sk >= 0:
                sb = slot_base[sk]
                drop = ent_drop[sk]
                for slot, ents in stage_map.get(g, {}).items():
                    if sb[slot] == SLOT_DROPPED:
                        r.dropped_entries.extend(ents)
                    elif sb[slot] >= 0:
                        r.dropped_entries.extend(
                            e for i_e, e in enumerate(ents)
                            if drop[slot, i_e]
                        )
            if need_k_l[j] >= 0:
                self._send_snapshots(r, g, need_np[need_k_l[j]],
                                     snapshot_sends)
            u = node.peer.get_update(last_applied=node.sm.last_applied)
            node.dispatch_dropped(u)
            updates.append((node, u))
            node._check_leader_change()
        self.stats["t_updates_ms"] += profiling.stage(
            "colocated.updates", _t0)

        lanes = [t for t in snapshot_sends if t[2] is not None]
        if lanes:
            # applied to the CURRENT state handle — possibly one
            # generation past the one that flagged the need.  Benign:
            # the need flag re-fires while the condition persists, the
            # lane write is idempotent, and at most one extra probe
            # volley reaches a peer already being streamed to
            self._state = self._snapshot_state(self._state, lanes)
        below = [t for t in snapshot_sends if t[2] is None]
        if below:
            # the durable snapshot sits below the shard base (see
            # TorchStepEngine._send_snapshots): these rows take a host
            # excursion — a membership mutation, so it runs at the next
            # depth-0 point (_apply_snapshot_below), never mid-merge
            self._deferred.append(("below", below))

        if self._pending_live:
            # in-flight routed traffic: wake every ALIVE resident
            # node's engine so some worker launches again and the
            # messages are consumed (lane scan — the notify itself is
            # per-node, but dirty rows no longer pay a Python probe)
            for g in np.nonzero(self._lanes.alive_mask())[0].tolist():
                meta = self._meta.get(g)
                if meta is not None and meta.node.notify_work is not None:
                    meta.node.notify_work()
        return updates


class _ColocatedFacade(IStepEngine):
    """Per-NodeHost view of the shared core (the IStepEngine each
    ExecEngine drives).  Tracks shard -> replica so ``detach(shard_id)``
    — the IStepEngine contract — releases only THIS host's replica."""

    def __init__(self, core: ColocatedTorchEngine):
        self.core = core
        self._replica_of: Dict[int, int] = {}

    @property
    def stats(self):
        return self.core.stats

    def step_shards(self, nodes, worker_id: int) -> None:
        for n in nodes:
            self._replica_of[n.shard_id] = n.replica_id
        self.core.step_shards(nodes, worker_id)

    def device_coordinate(self, shard_id: int):
        return self.core.device_coordinate(
            shard_id, self._replica_of.get(shard_id)
        )

    def device_chip_count(self) -> int:
        return self.core.device_chip_count()

    def detach(self, shard_id: int) -> None:
        rid = self._replica_of.pop(shard_id, None)
        if rid is not None:
            self.core.detach_replica(shard_id, rid)

    def detach_many(self, shard_ids) -> None:
        pairs = []
        for s in shard_ids:
            rid = self._replica_of.pop(s, None)
            if rid is not None:
                pairs.append((s, rid))
        if pairs:
            self.core.detach_replicas(pairs)


class ColocatedEngineGroup:
    """Product plug point: one group per colocated cluster.

        group = ColocatedEngineGroup(capacity=64, P=5, budget=2)
        cfg.expert.step_engine_factory = group.factory   # every member

    ``device``: where the shared row state lives and the programs run —
    the CUDA card by default (``placement.default_device()``), which
    raises here when there is none; ``"cpu"`` runs the plain PyTorch
    versions.  ``mesh`` (a ``placement.GroupsMesh``: ``["cpu"] * D``,
    ``[cuda:0] * 4``, or distinct cards) decides the device instead: the
    rows are cut into its devices' blocks, each block's programs run on
    its device, and messages between blocks ride the cross-device lane
    (``ColocatedTorchEngine``).  The other keywords go to
    ``ColocatedTorchEngine``.
    """

    def __init__(self, *, device=None, mesh=None, **kw):
        if mesh is None:
            device = placement.resolve_device(device)
        self._kw = dict(kw, device=device, mesh=mesh)
        self._core: Optional[ColocatedTorchEngine] = None
        self._lock = threading.Lock()

    @property
    def core(self) -> Optional[ColocatedTorchEngine]:
        return self._core

    def factory(self, nodehost) -> _ColocatedFacade:
        with self._lock:
            if self._core is None:
                self._core = ColocatedTorchEngine(**self._kw)
            return _ColocatedFacade(self._core)
