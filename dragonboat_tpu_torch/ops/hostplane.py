"""Array-at-once host-plane machinery for the colocated launch path.

The r5 ledger (docs/BENCH_NOTES_r05.md, Config 4) showed that at 250k
replica rows the DEVICE plane costs ~4 s of a 2,731 s 50k-shard
election while ``t_plan`` (887 s) and ``t_updates`` (538 s) — per-row
Python in the colocated engine's plan and merge stages — dominate.
This module is the fix: the per-row work that is pure *metadata math*
(eligibility classification, merge row-set construction, coverage
checks, index maps) runs as numpy array ops over ALL rows per
generation instead of per-row attribute probes and dict builds.

Three layers:

* ``RowLanes`` — the SoA truth store for per-row engine metadata
  (``attached``/``dirty``/``plan_ok``/``esc_hold``).  The per-row
  ``_RowMeta`` objects in ``ops/engine.py`` are thin property views
  over these lanes, so every existing scalar path keeps its field
  syntax while the vectorized passes read whole lanes at once.

* vectorized passes — ``classify_static`` (the batched plan
  classifier's static-eligibility prefilter), ``build_merge_sets``
  (the post-launch row sets: escalations, live rows, buf/append/
  need/slot/sum), ``pos_of``/``covered`` (index-array replacements
  for the old per-row ``*_at`` dict builds and ``all(g in …)``
  membership scans).  These carry the ``# hostplane-hot`` marker:
  raftlint's ``host-loop`` rule bans ``for``-over-rows inside them so
  the vectorization cannot rot back into per-row Python.

* scalar twins — ``classify_static_scalar`` / ``build_merge_sets_scalar``
  replicate the pre-vectorization per-row logic verbatim.  They are
  the PARITY ORACLE: with ``PARITY`` enabled (env
  ``DRAGONBOAT_TPU_HOSTPLANE_PARITY=1``, or set directly by tests) the
  colocated engine runs both implementations on every generation and
  fail-stops on any divergence.  They also let ``bench.py
  phase_hostplane`` measure the stage cost the vectorization removed.

The scalar ``_plan_device`` classifier in ops/engine.py remains the
slow-path fallback for rows that fail the static prefilter — exactly
the contract the ``plan_ok`` fast tick lane (57 µs -> 5 µs) proved.
Deliberately numpy-only: nothing here may touch jax — the host plane
must never inject device syncs into the launch tail (that is the
device plane's job, audited separately by analysis/jaxcheck).
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Sequence

import numpy as np

from .types import (
    F_ANY_LIVE,
    F_APPEND,
    F_COUNT,
    F_ESC,
    F_NEED_SS,
    F_QUORUM_ACTIVE,
    R_COMMIT,
    R_LAST,
    R_LEADER,
    R_ROLE,
    R_TERM,
    R_VOTE,
    ROLE_LEADER,
    U_COMMIT,
    U_LEADER,
    U_LOST_LEAD,
    U_ROLE,
    U_STATE,
    UL_N,
)

# parity mode: run the scalar twins beside every vectorized pass and
# assert identical outputs (tests flip the module attribute directly;
# the env var serves soak/CI runs).  Off by default — the twins are
# O(rows) Python, the very cost this module exists to remove.
PARITY = os.environ.get("DRAGONBOAT_TPU_HOSTPLANE_PARITY", "") == "1"


class HostPlaneParityError(AssertionError):
    """Vectorized and scalar host-plane passes disagreed (a bug in one
    of them); the engine fail-stops the launch loudly rather than
    letting the two decode paths diverge the cluster."""


class RowLanes:
    """SoA metadata lanes for device rows — the ``_RowMeta`` truth store.

    One lane per static plan fact the classifier needs:

    * ``attached`` — a ``_RowMeta`` exists for this row (set at attach,
      cleared at detach/halt/release; ``attached & ~dirty`` is the
      device-authoritative "alive" set the launch masks ride on).
    * ``dirty`` — the scalar Raft is authoritative and the device row
      is stale (fresh rows, cold-stepped rows, escalated rows).
    * ``plan_ok`` — the last FULL ``_plan_device`` pass passed every
      static eligibility check (the fast tick lane's proof).
    * ``esc_hold`` — steps left to hold the row on the scalar path
      after an escalation.

    All writes happen under the engine's core lock (the same contract
    the ``_RowMeta`` fields always had); the vectorized readers run
    under that lock too.
    """

    __slots__ = ("attached", "dirty", "plan_ok", "esc_hold")

    def __init__(self, capacity: int):
        self.attached = np.zeros((capacity,), bool)
        # rows start dirty: scalar-authoritative until the first upload
        self.dirty = np.ones((capacity,), bool)
        self.plan_ok = np.zeros((capacity,), bool)
        self.esc_hold = np.zeros((capacity,), np.int64)

    def reset_row(self, g: int, attached: bool) -> None:
        """Fresh-row state (attach) or freed-row state (detach/halt)."""
        self.attached[g] = attached
        self.dirty[g] = True
        self.plan_ok[g] = False
        self.esc_hold[g] = 0

    def alive_mask(self) -> np.ndarray:  # hostplane-hot
        """The device-authoritative row set: attached and clean.  A
        fresh [G] bool array (callers mutate it for per-generation
        stopping corrections).  Replaces the old per-launch Python scan
        over the whole ``_meta`` table (~0.5 µs/row — ~125 ms/launch at
        250k rows)."""
        return self.attached & ~self.dirty


class LeaseLanes:
    """Host model of resident CheckQuorum leaders' activity windows —
    the device-plane lease evidence plumbing (ROADMAP 4b).

    The device SoA tracks ``check_quorum``/``active`` per row but never
    drove the scalar remotes' ``last_resp_tick``, so lease reads on
    device-hosted shards always fell back to ReadIndex.  The wiring:

    * the kernel's flags word gains ``F_QUORUM_ACTIVE`` — a CheckQuorum
      leader whose CURRENT activity window already holds a quorum of
      active voter lanes (engine._summarize_flags; rides the existing
      per-launch readback for free);
    * the host mirrors each armed row's device ``election_tick`` from
      the ticks it feeds (``row_step``), so it knows when the device's
      CheckQuorum sweep cleared the lanes — the WINDOW START, recorded
      on the row's own node clock;
    * when the flag is up mid-window, the scalar voting remotes are
      anchored at that window start (``Raft.anchor_quorum_evidence``),
      and ``quorum_responded_tick``/``lease_remaining_ticks`` work
      unchanged — the ~0.006 ms lease read stays on the engines that
      host the most shards.

    SAFETY SHAPE: an ``active`` lane proves its peer responded AFTER
    the sweep observed it cleared, so the quorum's election clocks
    reset no earlier than (window start - one in-flight probe delay).
    Window-start anchoring is therefore the classic clock-based
    CheckQuorum lease (etcd's leader lease), one notch weaker than the
    scalar path's probe-send FIFO anchoring; the margin lease callers
    already keep (NodeHost.try_lease_read) absorbs the in-flight skew.
    The leader's own FIRST window is never anchored (window_start
    starts at -1): become_leader fabricates a full activity window
    (kernel._become_leader), and only a window that began with a real
    on-device sweep counts as evidence.

    All writes run under the engine's core lock, like RowLanes.
    """

    __slots__ = ("window_start", "dev_el", "et")

    def __init__(self, capacity: int):
        self.window_start = np.full((capacity,), -1, np.int64)
        self.dev_el = np.zeros((capacity,), np.int64)
        self.et = np.zeros((capacity,), np.int64)  # 0 = disarmed

    def disarm(self, g: int) -> None:
        self.et[g] = 0
        self.dev_el[g] = 0
        self.window_start[g] = -1

    def arm(self, g: int, election_timeout: int, election_tick: int) -> None:
        """Arm a row entering device residency (or winning an election
        on-device) as a CheckQuorum leader.  ``election_tick`` seeds
        the device-window mirror (uploads carry the scalar's tick; an
        on-device win resets it to 0)."""
        self.et[g] = election_timeout
        self.dev_el[g] = election_tick
        self.window_start[g] = -1  # first window: fabricated actives

    def row_step(self, g: int, fed_ticks: int, now: int,
                 flags_word: int) -> int:
        """Advance one armed row by the ticks its launch fed and return
        the anchor tick (>= 0) when the quorum-active flag holds inside
        an observed window, else -1.  Crossings mirror kernel._tick's
        leader leg exactly: el += n, fired at el >= et, reset to 0 (the
        planner's half-window tick cap guarantees at most one crossing
        per launch)."""
        et = self.et[g]
        if et <= 0:
            return -1
        el = self.dev_el[g] + fed_ticks
        if el >= et:
            # the device's CheckQuorum sweep ran this launch: actives
            # cleared, a fresh window starts on this row's clock NOW
            self.dev_el[g] = 0
            self.window_start[g] = now
            return -1
        self.dev_el[g] = el
        ws = self.window_start[g]
        if ws >= 0 and (flags_word & F_QUORUM_ACTIVE):
            return int(ws)
        return -1


class UpdateLanes:
    """SoA mirror of the scalar words the merge tail syncs into each
    resident row's ``Raft`` — the array-side ``pb.Update`` truth store
    (ISSUE 13 / ROADMAP item 1's "Raft-less host rows").

    One ``[UL_N, G]`` int64 block, rows indexed by the values-block
    layout (``types.R_TERM`` … ``types.R_LAST``), holding the LAST
    SYNCED absolute-frame words per device row: term / vote / commit /
    leader / role / last-log-index (commit and last carry the shard
    base added back, so rebases never perturb them).  Beside the lanes
    the device plane already tracks per row — delivered outbox bits
    (the head blob), lease evidence (:class:`LeaseLanes`) and the
    plan/alive flags (:class:`RowLanes`) — this completes the set: a
    generation's *effects* now diff as ``new words != lane words``
    over whole ``[G]`` gathers (:func:`plan_update_sync`) instead of
    one Python object walk per affected row.

    Chip-sharded by construction: the block's G axis is the engine row
    axis, so under the ``ops/placement.py`` row-block contract a
    device's G-slice is the contiguous column slice
    :meth:`device_slice` returns — per-device lane views compose with
    zero copies (docs/MULTICHIP.md), ready for the mesh plane.

    Lifecycle mirrors the ``_mirror`` table: seeded at upload
    (``_upload_rows``) from the scalar raft, bulk-written at every
    merge for the rows the generation synced; rows skipped by a merge
    (stopped / halted mid-flight) are freed and re-seeded at their
    next upload, so their stale words are moot.  All access runs under
    the engine's core lock, like RowLanes.
    """

    __slots__ = ("words",)

    def __init__(self, capacity: int):
        self.words = np.zeros((UL_N, capacity), np.int64)

    def seed_row(self, g: int, term: int, vote: int, commit: int,
                 leader: int, role: int, last: int) -> None:
        """Scalar -> lanes at upload: the raft is authoritative."""
        w = self.words
        w[R_TERM, g] = term
        w[R_VOTE, g] = vote
        w[R_COMMIT, g] = commit
        w[R_LEADER, g] = leader
        w[R_ROLE, g] = role
        w[R_LAST, g] = last

    def device_slice(self, device_index: int, n_devices: int) -> np.ndarray:
        """The contiguous per-device lane view under the row-block
        contract (placement.device_of_row): device ``d`` owns columns
        ``[d*Gl, (d+1)*Gl)``.  A VIEW, never a copy — the mesh test
        asserts the slices tile the block exactly."""
        from .placement import rows_per_device

        per = rows_per_device(self.words.shape[1], n_devices)
        return self.words[:, device_index * per:(device_index + 1) * per]


class UpdateSyncPlan(NamedTuple):
    """One generation's vectorized effect classification: the new
    absolute words ``[UL_N, n]`` for the planned rows and the per-row
    ``U_*`` effect bits ``[n]`` (0 = the row's merged values are
    byte-identical to the last sync — nothing to write, persist or
    notify)."""

    words: np.ndarray
    ubits: np.ndarray


def plan_update_sync(  # hostplane-hot
    old_words: np.ndarray,
    sum_k: np.ndarray,
    vals: np.ndarray,
    bases: np.ndarray,
) -> UpdateSyncPlan:
    """Vectorized update-sync classification for one generation.

    ``old_words`` is the ``[UL_N, n]`` gather of the rows' current
    lanes, ``sum_k`` the per-row position into the ``[m, N_VALS]``
    values block (-1 = the row carried no values this generation —
    its words are kept and its ubits are 0), ``bases`` the per-row
    shard bases converting the device frame to the absolute frame.

    The ``U_*`` bits come from lane diffs, NOT from the device's
    F_CHANGED flag: F_CHANGED compares one step's old/new device
    state, while the lanes compare against the last HOST sync — the
    quantity the merge tail actually owes an action for.  The caller
    writes ``plan.words`` back into the lanes for exactly the rows it
    then merges (skipped rows re-seed at their next upload).
    """
    in_sum = sum_k >= 0
    if not len(vals):
        # no row carried values this generation: every sum_k is -1 and
        # the gather below must still be indexable
        vals = np.zeros((1, UL_N), np.int64)
    safe_k = np.where(in_sum, sum_k, 0)
    new = vals[safe_k, :UL_N].T.astype(np.int64)
    new[R_COMMIT] += bases
    new[R_LAST] += bases
    new = np.where(in_sum[None, :], new, old_words)
    state_chg = (
        (new[R_TERM] != old_words[R_TERM])
        | (new[R_VOTE] != old_words[R_VOTE])
        | (new[R_COMMIT] != old_words[R_COMMIT])
    )
    ubits = (
        np.where(state_chg, U_STATE, 0)
        | np.where(new[R_COMMIT] > old_words[R_COMMIT], U_COMMIT, 0)
        | np.where(new[R_ROLE] != old_words[R_ROLE], U_ROLE, 0)
        | np.where(new[R_LEADER] != old_words[R_LEADER], U_LEADER, 0)
        | np.where(
            (old_words[R_ROLE] == ROLE_LEADER)
            & (new[R_ROLE] != ROLE_LEADER),
            U_LOST_LEAD,
            0,
        )
    )
    return UpdateSyncPlan(words=new, ubits=ubits)


# raftlint: ignore[host-loop] parity oracle — the per-row decision shape the lanes replaced, kept for the harness
def plan_update_sync_scalar(  # hostplane-hot
    old_words: np.ndarray,
    sum_k: Sequence[int],
    vals: np.ndarray,
    bases: Sequence[int],
) -> UpdateSyncPlan:
    """Per-row twin of :func:`plan_update_sync` — the old merge loop's
    implicit per-row comparisons (scalar sync always wrote, commit
    advance probed ``committed > r.log.committed``, role/leader
    transitions probed per row), made explicit row by row."""
    n = len(sum_k)
    words = np.array(old_words, np.int64, copy=True)
    ubits = np.zeros((n,), np.int64)
    for i in range(n):
        k = int(sum_k[i])
        if k < 0:
            continue
        term, vote, commit, leader, role, last = (
            int(vals[k, c]) for c in range(UL_N)
        )
        commit += int(bases[i])
        last += int(bases[i])
        ub = 0
        if (
            term != int(old_words[R_TERM, i])
            or vote != int(old_words[R_VOTE, i])
            or commit != int(old_words[R_COMMIT, i])
        ):
            ub |= U_STATE
        if commit > int(old_words[R_COMMIT, i]):
            ub |= U_COMMIT
        if role != int(old_words[R_ROLE, i]):
            ub |= U_ROLE
        if leader != int(old_words[R_LEADER, i]):
            ub |= U_LEADER
        if (
            int(old_words[R_ROLE, i]) == ROLE_LEADER
            and role != ROLE_LEADER
        ):
            ub |= U_LOST_LEAD
        words[:, i] = (term, vote, commit, leader, role, last)
        ubits[i] = ub
    return UpdateSyncPlan(words=words, ubits=ubits)


def assert_update_plan_parity(
    old_words: np.ndarray,
    sum_k: np.ndarray,
    vals: np.ndarray,
    bases: np.ndarray,
    plan: UpdateSyncPlan,
) -> None:
    ref = plan_update_sync_scalar(
        old_words, np.asarray(sum_k).tolist(), vals,
        np.asarray(bases).tolist(),
    )
    if not np.array_equal(np.asarray(plan.ubits), ref.ubits):
        raise HostPlaneParityError(_diff("update_ubits", plan.ubits,
                                         ref.ubits))
    if not np.array_equal(np.asarray(plan.words), ref.words):
        raise HostPlaneParityError(_diff("update_words", plan.words,
                                         ref.words))


def check_update_plan_parity(old_words, sum_k, vals, bases, plan) -> None:
    try:
        assert_update_plan_parity(old_words, sum_k, vals, bases, plan)
    except HostPlaneParityError as e:  # pragma: no cover - bug path
        _record_failure(e)


# ---------------------------------------------------------------------------
# the batched plan classifier (static-eligibility prefilter)
# ---------------------------------------------------------------------------


def classify_static(lanes: RowLanes, gs: np.ndarray) -> np.ndarray:  # hostplane-hot
    """[n] bool: rows whose last full-plan proof still stands.

    ``gs`` is the per-node row-id array (-1 for unattached).  A True
    lane means the row may take the fast tick lane PROVIDED the cheap
    per-launch dynamic conditions (empty queues, no snapshot/read
    state, save quarantine, stale binding) also hold — those live on
    Python objects and are re-verified per row by the caller, exactly
    as the fast lane always did.  A False lane routes the node to the
    scalar ``_plan_device`` classifier (the slow-path oracle)."""
    ok = gs >= 0
    safe = np.where(ok, gs, 0)
    return (
        ok
        & lanes.plan_ok[safe]
        & ~lanes.dirty[safe]
        & (lanes.esc_hold[safe] == 0)
    )


# raftlint: ignore[host-loop] parity oracle — the pre-vectorization per-row shape, kept for the harness
def classify_static_scalar(lanes: RowLanes, gs: Sequence[int]) -> np.ndarray:
    """Per-row twin of :func:`classify_static` (the r5 probe shape)."""
    out = np.zeros((len(gs),), bool)
    for i, g in enumerate(gs):
        if g < 0:
            continue
        out[i] = (
            bool(lanes.plan_ok[g])
            and not bool(lanes.dirty[g])
            and int(lanes.esc_hold[g]) == 0
        )
    return out


# ---------------------------------------------------------------------------
# merge row sets (the post-launch tail's classification)
# ---------------------------------------------------------------------------
class MergeSets(NamedTuple):
    """Row sets the merge stage consumes, as sorted int32 row-id arrays
    (``esc_batch_pos`` is positions into the BATCH list, everything
    else is device row ids).  Replaces the old per-row list/dict
    comprehensions over the whole meta table."""

    esc_batch_pos: np.ndarray  # batch positions whose row escalated
    esc_other: np.ndarray      # alive non-batch rows that escalated
    live_other: np.ndarray     # alive non-batch rows with any-live flags
    buf_rows: np.ndarray       # live rows with host-visible outbox bytes
    append_rows: np.ndarray    # live rows that ring-appended
    slot_rows: np.ndarray      # non-escalated proposal-slot rows
    need_rows: np.ndarray      # live rows with a peer needing a snapshot
    sum_rows: np.ndarray       # live rows whose VALUES the merge reads


def _mask_of(G: int, rows) -> np.ndarray:  # hostplane-hot
    m = np.zeros((G,), bool)
    if len(rows):
        m[np.asarray(rows, np.int64)] = True
    return m


def build_merge_sets(  # hostplane-hot
    flags: np.ndarray,
    alive: np.ndarray,
    batch_gs: np.ndarray,
    prop_gs: np.ndarray,
    *,
    G: int,
) -> MergeSets:
    """Vectorized merge-row classification for one launch.

    Inputs: the [G] int32 flags word (types.F_*), the [G] bool alive
    mask (attached & clean, with this generation's stopping rows
    cleared), the batch row ids in batch order, and the proposal-slot
    row ids.  Mirrors the scalar semantics bit for bit (the parity
    harness holds both to it):

    * escalated batch rows replay on the scalar path; escalated ALIVE
      non-batch rows (stepped only by routed traffic) just discard
      their device effects;
    * live = batch rows + alive resident rows with any-live flags,
      minus escalations;
    * buf/append/need sets are flag-gated subsets of live; slot rows
      are the non-escalated proposal rows; sum rows are live rows with
      any-live flags or proposal slots (the rest only ticked).
    """
    batch_mask = _mask_of(G, batch_gs)
    prop_mask = _mask_of(G, prop_gs)
    esc = (flags & F_ESC) != 0
    anylive = (flags & F_ANY_LIVE) != 0
    esc_batch_pos = np.nonzero(esc[batch_gs])[0].astype(np.int32) if len(
        batch_gs
    ) else np.zeros((0,), np.int32)
    esc_other = np.nonzero(alive & ~batch_mask & esc)[0].astype(np.int32)
    live_mask = ~esc & (batch_mask | (alive & ~batch_mask & anylive))
    slot_mask = prop_mask & ~esc  # prop rows ride the batch; esc drops them
    i32 = np.int32
    return MergeSets(
        esc_batch_pos=esc_batch_pos,
        esc_other=esc_other,
        live_other=np.nonzero(live_mask & ~batch_mask)[0].astype(i32),
        buf_rows=np.nonzero(live_mask & ((flags & F_COUNT) != 0))[0].astype(i32),
        append_rows=np.nonzero(live_mask & ((flags & F_APPEND) != 0))[0].astype(i32),
        slot_rows=np.nonzero(slot_mask)[0].astype(i32),
        need_rows=np.nonzero(live_mask & ((flags & F_NEED_SS) != 0))[0].astype(i32),
        sum_rows=np.nonzero(live_mask & (anylive | slot_mask))[0].astype(i32),
    )


# raftlint: ignore[host-loop] parity oracle — replicates the r5 per-row loops verbatim for the harness
def build_merge_sets_scalar(
    flags: Sequence[int],
    alive: Sequence[bool],
    batch_gs: Sequence[int],
    prop_gs: Sequence[int],
    *,
    G: int,
) -> MergeSets:
    """Per-row twin of :func:`build_merge_sets` — the exact loop shapes
    the colocated merge tail ran before vectorization (flag probes per
    row, membership via Python sets), with outputs sorted into the
    canonical MergeSets form for comparison."""
    flags = list(flags)
    batch_set = set(int(g) for g in batch_gs)
    esc_batch_pos = [
        i for i, g in enumerate(batch_gs) if flags[int(g)] & F_ESC
    ]
    esc_other = [
        g for g in range(G)
        if alive[g] and g not in batch_set and flags[g] & F_ESC
    ]
    esc_set = {int(batch_gs[i]) for i in esc_batch_pos} | set(esc_other)
    live = [int(g) for g in batch_gs if int(g) not in esc_set]
    for g in range(G):
        if (
            alive[g]
            and g not in batch_set
            and g not in esc_set
            and flags[g] & F_ANY_LIVE
        ):
            live.append(g)
    slot_rows = [int(g) for g in prop_gs if int(g) not in esc_set]
    slot_set = set(slot_rows)
    buf_rows = [g for g in live if flags[g] & F_COUNT]
    append_rows = [g for g in live if flags[g] & F_APPEND]
    need_rows = [g for g in live if flags[g] & F_NEED_SS]
    sum_rows = [
        g for g in live if (flags[g] & F_ANY_LIVE) or g in slot_set
    ]
    live_other = [g for g in live if g not in batch_set]
    srt = lambda xs: np.asarray(sorted(xs), np.int32)  # noqa: E731
    return MergeSets(
        esc_batch_pos=np.asarray(sorted(esc_batch_pos), np.int32),
        esc_other=srt(esc_other),
        live_other=srt(live_other),
        buf_rows=srt(buf_rows),
        append_rows=srt(append_rows),
        slot_rows=srt(slot_rows),
        need_rows=srt(need_rows),
        sum_rows=srt(sum_rows),
    )


# ---------------------------------------------------------------------------
# index maps (the *_at dict replacements)
# ---------------------------------------------------------------------------
def pos_of(G: int, rows: np.ndarray) -> np.ndarray:  # hostplane-hot
    """[G] int32 position map: pos[g] = index of g in ``rows``, -1
    elsewhere — the index-array replacement for the per-row
    ``{g: k for k, g in enumerate(rows)}`` dict builds."""
    pos = np.full((G,), -1, np.int32)
    n = len(rows)
    if n:
        pos[np.asarray(rows, np.int64)] = np.arange(n, dtype=np.int32)
    return pos


def covered(pos: np.ndarray, rows: np.ndarray) -> bool:  # hostplane-hot
    """Every row of ``rows`` has a position in ``pos`` — the
    index-array replacement for ``all(g in at for g in rows)``."""
    if not len(rows):
        return True
    return bool((pos[np.asarray(rows, np.int64)] >= 0).all())


# ---------------------------------------------------------------------------
# parity harness
# ---------------------------------------------------------------------------
def _diff(name: str, a: np.ndarray, b: np.ndarray) -> str:
    return (
        f"{name}: vectorized {np.asarray(a).tolist()[:32]} != "
        f"scalar {np.asarray(b).tolist()[:32]}"
    )


def assert_classify_parity(lanes: RowLanes, gs: Sequence[int],
                           vec: np.ndarray) -> None:
    ref = classify_static_scalar(lanes, list(gs))
    if not np.array_equal(np.asarray(vec, bool), ref):
        raise HostPlaneParityError(_diff("classify_static", vec, ref))


def assert_merge_parity(
    flags: np.ndarray,
    alive: np.ndarray,
    batch_gs: np.ndarray,
    prop_gs: np.ndarray,
    vec: MergeSets,
    *,
    G: int,
) -> None:
    """Run the scalar oracle on the same launch inputs and compare
    every set (vectorized outputs sorted first — the oracle's canonical
    form).  Raises :class:`HostPlaneParityError` naming the first
    diverging set."""
    ref = build_merge_sets_scalar(
        np.asarray(flags).tolist(),
        np.asarray(alive, bool).tolist(),
        list(np.asarray(batch_gs).tolist()),
        list(np.asarray(prop_gs).tolist()),
        G=G,
    )
    for name in MergeSets._fields:
        got = np.sort(np.asarray(getattr(vec, name)))
        want = np.asarray(getattr(ref, name))
        if not np.array_equal(got, want):
            raise HostPlaneParityError(_diff(name, got, want))


# parity failures observed by the in-engine checker (check_* wrappers):
# the engine must not crash a live launch mid-merge over a checker
# finding, so the wrappers record + log instead of raising — tests and
# soaks gate on PARITY_FAILURE_COUNT == 0 / the list being empty.  The
# list keeps only the first _FAILURE_CAP diffs (a multi-day soak with
# a persistent divergence appends per launch — an unbounded list would
# OOM the soak long before anyone reads it); the counter is exact.
PARITY_FAILURES: List[str] = []
PARITY_FAILURE_COUNT = 0
_FAILURE_CAP = 256


def _record_failure(e: Exception) -> None:  # pragma: no cover - bug path
    global PARITY_FAILURE_COUNT
    PARITY_FAILURE_COUNT += 1
    if len(PARITY_FAILURES) < _FAILURE_CAP:
        PARITY_FAILURES.append(str(e))


def check_classify_parity(lanes: RowLanes, gs, vec) -> None:
    try:
        assert_classify_parity(lanes, gs, vec)
    except HostPlaneParityError as e:  # pragma: no cover - bug path
        _record_failure(e)


def check_merge_parity(flags, alive, batch_gs, prop_gs, vec, *, G) -> None:
    try:
        assert_merge_parity(flags, alive, batch_gs, prop_gs, vec, G=G)
    except HostPlaneParityError as e:  # pragma: no cover - bug path
        _record_failure(e)


# recorded generation traces (parity satellite): with ``RECORD`` on,
# the colocated engine appends one entry per launch so tests can replay
# scalar-vs-vectorized over REAL generation inputs (elections,
# escalations, membership churn) rather than only fabricated ones.
RECORD = False
TRACE: List[dict] = []
_TRACE_CAP = 512


def record_generation(flags, alive, batch_gs, prop_gs, G: int) -> None:
    if not RECORD:
        return
    TRACE.append(
        dict(
            flags=np.array(flags, np.int64, copy=True),
            alive=np.array(alive, bool, copy=True),
            batch_gs=np.array(batch_gs, np.int64, copy=True),
            prop_gs=np.array(prop_gs, np.int64, copy=True),
            G=G,
        )
    )
    if len(TRACE) > _TRACE_CAP:
        del TRACE[: len(TRACE) - _TRACE_CAP]
