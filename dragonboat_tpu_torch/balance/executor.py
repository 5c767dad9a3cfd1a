"""Move executor: realizes one planned move as the safe sequence

    add-replica -> wait-for-catchup -> transfer-leadership -> remove-replica

with a deadline and backoff per step, membership steps driven by GOAL
STATE rather than per-attempt acks (``client.propose_with_retry``-style
deadline discipline; see ``_member_goal``), rollback on failure (the
added replica is removed again, restoring the pre-move membership), and
every transition exported as labelled metrics and ``balance_move_*``
system events.  The nemesis hooks in via
``FaultController.on_balance_step`` (kind ``balance_abort`` /
``balance_stall``) so chaos schedules can kill a move mid-sequence.

Ordering is what makes the sequence safe: the new replica joins as a
voter FIRST and must catch up BEFORE the old one is removed, so the
shard never drops below its replication factor and never commits
through a quorum that contains a hollow member for longer than the
catch-up window; leadership is handed off explicitly so the removal
never triggers an election.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..logger import get_logger
from ..raftio import BalanceMoveInfo
from .planner import Move
from .view import ClusterView

_log = get_logger("balance")


def _live(nh) -> bool:
    """Host-handle liveness (the executor-side twin of
    Collector.host_alive): registered and not closed."""
    return nh is not None and not getattr(nh, "_closed", False)


class MoveFailed(Exception):
    """The move could not complete; rollback has been attempted."""


class BalanceAborted(MoveFailed):
    """A nemesis ``balance_abort`` fault killed the move mid-sequence."""


class MoveExecutor:
    """Executes moves against a live host map.

    ``hosts`` maps host key (raft address) -> NodeHost; ``sm_factory``
    and ``config_factory(shard_id, replica_id) -> Config`` tell the
    executor how to start the replacement replica on the destination
    host (the same factories the shards were originally started with).
    """

    def __init__(
        self,
        hosts: Dict[str, object],
        sm_factory: Callable,
        config_factory: Callable,
        *,
        metrics=None,
        events=None,
        fault_injector=None,
        step_timeout: float = 10.0,
        catchup_timeout: float = 30.0,
        catchup_gap: int = 0,
    ):
        self.hosts = hosts
        self.sm_factory = sm_factory
        self.config_factory = config_factory
        self.events = events
        self.fault_injector = fault_injector
        self.step_timeout = step_timeout
        self.catchup_timeout = catchup_timeout
        self.catchup_gap = catchup_gap
        if metrics is None:
            from ..metrics import MetricsRegistry

            metrics = MetricsRegistry(enabled=True)
        self.metrics = metrics
        # progress cadence for catchup_progress events (seconds)
        self.progress_interval = 0.5
        # per-move report: the catchup leg surfaces live
        # snapshot_stream_* progress here (bytes, resumes, ETA) instead
        # of a blind applied-index poll (ROADMAP 5b); rewritten at each
        # execute(), readable after it returns/raises
        self.last_move_report: Dict[str, object] = {}

    # -- plumbing --------------------------------------------------------
    def _info(self, move: Move, step: str, detail: str = "") -> BalanceMoveInfo:
        return BalanceMoveInfo(
            shard_id=move.shard_id, kind=move.kind, src=move.src_host,
            dst=move.dst_host, replica_id=move.new_replica_id, step=step,
            detail=detail,
        )

    def _event(self, name: str, move: Move, step: str,
               detail: str = "") -> None:
        if self.events is not None:
            getattr(self.events, name)(self._info(move, step, detail))

    @staticmethod
    def _stream_totals(hosts) -> Dict[str, int]:
        """Aggregate ``snapshot_stream_*`` counters across the fleet's
        transports (the SENDER side carries them — whichever member
        streams the joiner's snapshot).  Hosts without a transport
        (test doubles, closed hosts) contribute zeros."""
        out = {"bytes": 0, "resumes": 0, "active": 0}
        for nh in hosts.values():
            tr = getattr(nh, "transport", None)
            m = getattr(tr, "metrics", None)
            if not isinstance(m, dict):
                continue
            out["bytes"] += int(m.get("stream_bytes", 0))
            out["resumes"] += int(m.get("stream_resumes", 0))
            active_fn = getattr(tr, "active_stream_jobs", None)
            if callable(active_fn):
                out["active"] += int(active_fn())
        return out

    def _count(self, name: str, **labels) -> None:
        self.metrics.counter(f"balance_{name}", labels or None).add()

    def _checkpoint(self, move: Move, step: str) -> None:
        """Per-step fault point + progress event."""
        inj = self.fault_injector
        if inj is not None and inj.on_balance_step(move.shard_id, step):
            raise BalanceAborted(
                f"nemesis aborted {move.describe()} at step {step!r}"
            )
        self._event("balance_move_step", move, step)

    def _api_host(self, move: Move, view: ClusterView):
        """A live host holding the shard to issue requests through
        (prefer the leader's host, avoid the src being evicted; src is
        kept as the LAST resort — for a one-member shard it is the only
        door)."""
        s = view.shard(move.shard_id)
        order = []
        if s is not None:
            if s.leader_host and s.leader_host != move.src_host:
                order.append(s.leader_host)
            order.extend(h for _, h in s.members if h != move.src_host)
            order.extend(h for _, h in s.members)
        for key in order:
            nh = self.hosts.get(key)
            if _live(nh):
                return nh
        raise MoveFailed(
            f"no live host holds shard {move.shard_id} to drive the move"
        )

    @staticmethod
    def _applied(nh, shard_id: int, replica_id: Optional[int] = None) -> int:
        top = -1
        for row in nh.balance_shard_stats():
            if row["shard_id"] != shard_id:
                continue
            if replica_id is not None and row["replica_id"] != replica_id:
                continue
            top = max(top, row["applied"])
        return top

    def _member_goal(self, move: Move, api, replica_id: int, present: bool,
                     request) -> None:
        """Drive a membership change by GOAL STATE, not per-attempt acks
        (the de-flake discipline the membership tests use): an attempt's
        future can time out while its entry still commits, making the
        retry REJECTED even though the goal is reached — so success is
        the membership containing (or no longer containing) the replica,
        and rejections only matter while the goal state isn't seen."""
        from ..nodehost import RequestRejected

        deadline = time.monotonic() + self.step_timeout
        last = None
        while True:
            m = api.get_shard_membership(move.shard_id)
            if (replica_id in m.addresses) == present:
                return
            try:
                request()
            except RequestRejected as e:
                last = e  # may have raced a commit; the poll decides
            except Exception as e:  # noqa: BLE001 — transient; retry
                last = e
            if time.monotonic() >= deadline:
                raise MoveFailed(
                    f"membership goal (replica {replica_id} "
                    f"{'present' if present else 'absent'}) not reached "
                    f"for {move.describe()}: last error {last!r}"
                )
            time.sleep(0.05)

    # -- the move state machine -----------------------------------------
    def execute(self, move: Move, view: ClusterView) -> None:
        """Run one move to completion.  Raises :class:`MoveFailed` (after
        attempting rollback) on any step failure; a failed TRANSFER-only
        move needs no rollback (no membership was changed)."""
        self._event("balance_move_started", move, "plan")
        self._count("moves_started_total", kind=move.kind)
        self.last_move_report = {"move": move.describe(), "kind": move.kind}
        t0 = time.perf_counter()
        try:
            if move.kind == "transfer":
                self._checkpoint(move, "transfer")
                self._transfer(move, view, target=move.new_replica_id)
            elif move.kind == "remove":
                self._remove_only(move, view)
            else:
                self._membership_move(move, view)
        except Exception as e:  # noqa: BLE001 — a move failure must never
            # abort the whole pass: a host can stop its replica between
            # view collection and execution (ShardNotFound, closed host),
            # and those raw errors must get the same failed-move
            # accounting as a MoveFailed
            self._count("moves_failed_total", kind=move.kind)
            self._event("balance_move_failed", move, "failed")
            if isinstance(e, MoveFailed):
                raise
            raise MoveFailed(f"{move.describe()} failed: {e!r}") from e
        # move durations run seconds-to-minutes (catchup polls); the
        # default sub-second latency bounds would dump everything in +Inf
        self.metrics.histogram(
            "balance_move_seconds",
            bounds=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
        ).observe(time.perf_counter() - t0)
        self._count("moves_completed_total", kind=move.kind)
        self._event("balance_move_completed", move, "done")

    def _membership_move(self, move: Move, view: ClusterView) -> None:
        api = self._api_host(move, view)
        dst_nh = self.hosts.get(move.dst_host)
        if not _live(dst_nh):
            raise MoveFailed(f"destination host {move.dst_host} not alive")
        added = False
        removing = False
        try:
            # -- add ----------------------------------------------------
            self._checkpoint(move, "add")
            self._member_goal(
                move, api, move.new_replica_id, present=True,
                request=lambda: api.sync_request_add_replica(
                    move.shard_id, move.new_replica_id, move.dst_host,
                    timeout=2.0,
                ),
            )
            added = True
            # a stale LOCAL replica of this shard on dst can only be the
            # leftover of an earlier killed move (the planner never picks
            # a dst already holding a member) — clear it so the fresh
            # join can start
            if move.shard_id in getattr(dst_nh, "_nodes", {}):
                try:
                    dst_nh.stop_shard(move.shard_id)
                    _log.warning(
                        "dst %s had a stale replica of shard %d; stopped it",
                        move.dst_host, move.shard_id,
                    )
                except Exception:  # noqa: BLE001 — raced its removal
                    pass
            # join seeded with the CURRENT membership (it includes the
            # replica just added): a snapshot-less catch-up replays a
            # log that never mentions the bootstrap members, so an
            # unseeded joiner would know no voters but itself — the
            # leadership-transfer leg would then split-brain (see
            # Node.__init__)
            cfg = self.config_factory(move.shard_id, move.new_replica_id)
            seed = dict(api.get_shard_membership(move.shard_id).addresses)
            dst_nh.start_replica(seed, True, self.sm_factory, cfg)
            # -- catchup ------------------------------------------------
            self._checkpoint(move, "catchup")
            self._wait_catchup(move, api, dst_nh)
            if move.kind == "replace":
                # -- transfer (only if the evictee leads, by FRESH
                # leader info — the view can be a whole move stale) ----
                lid, ok = api.get_leader_id(move.shard_id)
                leads = ok and lid != 0 and lid == move.src_replica_id
                if leads:
                    self._checkpoint(move, "transfer")
                    self._transfer(move, view, target=move.new_replica_id,
                                   api=api)
                # -- remove ---------------------------------------------
                self._checkpoint(move, "remove")
                removing = True
                self._member_goal(
                    move, api, move.src_replica_id, present=False,
                    request=lambda: api.sync_request_delete_replica(
                        move.shard_id, move.src_replica_id, timeout=2.0
                    ),
                )
                src_nh = self.hosts.get(move.src_host)
                if _live(src_nh):
                    try:
                        src_nh.stop_shard(move.shard_id)
                    except Exception:  # noqa: BLE001 — already gone
                        pass
        except Exception as e:  # noqa: BLE001 — any step error fails the move
            # a failure DURING the final remove rolls FORWARD, not back:
            # the new replica is caught up (and may already lead), so
            # removing it now could leave the shard short if the
            # evictee's delete commits late — the next pass just sees a
            # surplus draining member and retries the remove
            if not removing:
                self._rollback(move, view, added)
            if isinstance(e, MoveFailed):
                raise
            raise MoveFailed(
                f"{move.describe()} failed: {e!r} "
                f"({'remove retries next pass' if removing else 'rolled back'})"
            ) from e

    def _remove_only(self, move: Move, view: ClusterView) -> None:
        """Trim a surplus member (planner invariant 0: ghosts left by a
        killed move's failed rollback, or an over-replicated shard).
        No replica is added, so there is nothing to roll back."""
        self._checkpoint(move, "remove")
        api = self._api_host(move, view)
        try:
            self._member_goal(
                move, api, move.src_replica_id, present=False,
                request=lambda: api.sync_request_delete_replica(
                    move.shard_id, move.src_replica_id, timeout=2.0
                ),
            )
        except Exception as e:  # noqa: BLE001
            if isinstance(e, MoveFailed):
                raise
            raise MoveFailed(f"{move.describe()} failed: {e!r}") from e
        src_nh = self.hosts.get(move.src_host)
        if _live(src_nh):
            try:
                src_nh.stop_shard(move.shard_id)
            except Exception:  # noqa: BLE001 — already gone
                pass

    def _wait_catchup(self, move: Move, api, dst_nh) -> None:
        """Wait until the new replica's applied index reaches the
        shard's applied frontier (captured per poll; ``catchup_gap``
        relaxes the threshold for write-heavy shards that never quite
        close the last few entries).

        While polling, the leg samples the fleet's ``snapshot_stream_*``
        counters and surfaces TRANSFER progress — bytes moved, resume
        count, active streams, and an applied-rate ETA — in
        ``last_move_report["catchup"]`` plus rate-limited
        ``balance_move_step``/``catchup_progress`` events (ROADMAP 5b:
        the old leg was a blind applied-index poll; an operator
        watching a big-state catch-up saw nothing until it finished or
        timed out)."""
        deadline = time.monotonic() + self.catchup_timeout
        t0 = time.monotonic()
        base = self._stream_totals(self.hosts)
        first_got: Optional[int] = None
        last_emit = 0.0
        while True:
            target = self._applied(api, move.shard_id)
            got = self._applied(dst_nh, move.shard_id, move.new_replica_id)
            now = time.monotonic()
            if first_got is None and got >= 0:
                first_got = got
            done = (
                got >= 0 and target >= 0
                and got >= target - self.catchup_gap
            )
            # sample the stream counters and (re)build the report only
            # at the emit cadence (and on the terminal states): the
            # poll loop runs every 20 ms for legs that can take
            # minutes, and sampling every host's transport 50x/s to
            # feed a 2 Hz progress event is pure waste (review
            # finding) — between windows the loop stays the cheap
            # applied-index comparison it always was
            timed_out = now >= deadline
            if done or timed_out or now - last_emit >= self.progress_interval:
                totals = self._stream_totals(self.hosts)
                eta = None
                if first_got is not None and target > got > first_got:
                    rate = (got - first_got) / max(now - t0, 1e-6)
                    if rate > 0:
                        eta = (target - got) / rate
                report = {
                    "snapshot_stream_bytes": (
                        totals["bytes"] - base["bytes"]
                    ),
                    "snapshot_stream_resumes": (
                        totals["resumes"] - base["resumes"]
                    ),
                    "snapshot_stream_active": totals["active"],
                    "applied": got,
                    "target": target,
                    "eta_seconds": eta,
                }
                self.last_move_report["catchup"] = report
                last_emit = now
                self._event(
                    "balance_move_step", move, "catchup_progress",
                    detail=(
                        f"stream_bytes={report['snapshot_stream_bytes']} "
                        f"resumes={report['snapshot_stream_resumes']} "
                        f"active={report['snapshot_stream_active']} "
                        f"applied={got}/{target}"
                        + (f" eta={eta:.1f}s" if eta is not None else "")
                    ),
                )
            if done:
                return
            if timed_out:
                report = self.last_move_report.get("catchup", {})
                raise MoveFailed(
                    f"catchup timed out for {move.describe()}: "
                    f"applied {got} < target {target} - {self.catchup_gap} "
                    "(stream: "
                    f"{report.get('snapshot_stream_bytes', 0)} bytes, "
                    f"{report.get('snapshot_stream_resumes', 0)} resumes)"
                )
            time.sleep(0.02)

    def _leader_nh(self, move: Move, api):
        """The host handle currently holding the shard's LEADER replica.
        A leadership transfer must be requested ON the leader (a
        follower ignores it) — and the leader may well sit on the very
        host being drained, which _api_host deliberately avoids."""
        try:
            lid, ok = api.get_leader_id(move.shard_id)
            if ok and lid:
                m = api.get_shard_membership(move.shard_id)
                nh = self.hosts.get(m.addresses.get(lid, ""))
                if _live(nh):
                    return nh
        except Exception:  # noqa: BLE001 — mid-election; fall back
            pass
        return api

    def _transfer(self, move: Move, view: ClusterView, target: int,
                  api=None) -> None:
        api = api or self._api_host(move, view)
        deadline = time.monotonic() + self.step_timeout
        last_issue = -1.0
        while True:
            lid, ok = api.get_leader_id(move.shard_id)
            if ok and lid == target:
                return
            now = time.monotonic()
            if now - last_issue >= 0.25:  # don't hammer a slow handoff
                try:
                    self._leader_nh(move, api).request_leader_transfer(
                        move.shard_id, target
                    )
                except Exception:  # noqa: BLE001 — mid-election; retry
                    pass
                last_issue = now
            if now >= deadline:
                raise MoveFailed(
                    f"leadership transfer to {target} timed out for "
                    f"{move.describe()}"
                )
            time.sleep(0.05)

    def _rollback(self, move: Move, view: ClusterView, added: bool) -> None:
        """Best-effort restore of the pre-move membership: remove the
        replica this move added (the original replica was never removed
        — the remove step is last — so the shard keeps its factor)."""
        self._count("rollbacks_total", kind=move.kind)
        if not added:
            return
        try:
            api = self._api_host(move, view)
            self._member_goal(
                move, api, move.new_replica_id, present=False,
                request=lambda: api.sync_request_delete_replica(
                    move.shard_id, move.new_replica_id, timeout=2.0
                ),
            )
        except Exception:  # noqa: BLE001 — quorum may be gone; log and move on
            _log.warning("rollback: could not remove replica %d of shard %d",
                         move.new_replica_id, move.shard_id)
        dst_nh = self.hosts.get(move.dst_host)
        if _live(dst_nh):
            try:
                dst_nh.stop_shard(move.shard_id)
            except Exception:  # noqa: BLE001 — never started / already gone
                pass
        self._event("balance_move_rolled_back", move, "rollback")
