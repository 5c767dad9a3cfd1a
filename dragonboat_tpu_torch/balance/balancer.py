"""Balancer: the public handle of the placement & rebalancing control
plane.

Owns the host map and the collect -> plan -> execute loop::

    b = Balancer(sm_factory, config_factory, hosts={"nh-1": nh1, ...},
                 replication_factor=3, seed=7)
    b.rebalance_once()       # one pass, returns a report
    b.run(interval=0.5)      # background loop
    b.join("nh-5", nh5)      # new host starts absorbing load
    b.drain("nh-2")          # blocks until nh-2 holds zero replicas
    b.stop()

Moves execute strictly in plan order on the balancer thread — one move
in flight at a time, so a failure (or a nemesis kill) leaves at most
one shard with a superfluous replica, which the executor's rollback
removes again.  Re-planning from a FRESH view each pass is what makes
the loop self-healing: whatever a crashed/killed pass left behind is
just another observed state the next plan converges from.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..events import EventFanout
from ..logger import get_logger
from .executor import MoveExecutor, MoveFailed
from .planner import MovePlan, Planner
from .view import ClusterView, Collector, ShardLoad

_log = get_logger("balance")


class DrainTimeout(Exception):
    """drain() did not converge within its deadline."""


@dataclass(frozen=True)
class LoadPolicy:
    """Thresholds + thrash guards for the load-feedback mode
    (docs/BALANCE.md "Load-reactive rebalancing").

    A shard is HOT in one window when its observed commit p99 crosses
    ``hot_p99_s`` (with at least ``min_samples`` samples backing the
    estimate — a two-sample p99 is noise) OR the gateway shed at least
    ``hot_shed`` requests for it this window.  ``hot_submit`` adds an
    absolute submit-delta trigger, disabled by default (0).  A hot
    reading only FIRES a move after ``hysteresis`` consecutive hot
    windows, and a fired shard then cools for ``cooldown`` windows —
    counted in PASSES, not wall time, per the determinism rule (the
    planner and faults planes ban wall clocks; the Balancer's pass
    cadence is the one legitimate clock here).  ``max_moves`` clamps
    each firing pass."""

    hot_p99_s: float = 0.25
    hot_shed: int = 8
    hot_submit: int = 0
    min_samples: int = 12
    hysteresis: int = 3
    cooldown: int = 6
    max_moves: int = 1

    def is_hot(self, row: ShardLoad) -> bool:
        if row.samples >= self.min_samples and (
                row.p99_ms >= int(self.hot_p99_s * 1000)):
            return True
        if self.hot_shed and row.shed >= self.hot_shed:
            return True
        if self.hot_submit and row.submitted >= self.hot_submit:
            return True
        return False


class HotTracker:
    """Pure hysteresis/cooldown state machine over per-pass hot sets
    (unit-tested in isolation — tests/test_balance.py).  ``observe``
    takes the shards hot THIS pass and returns the sorted subset whose
    hot streak just reached the hysteresis bar and that are not
    cooling; ``fired`` starts their cooldown."""

    def __init__(self, hysteresis: int = 3, cooldown: int = 6):
        self.hysteresis = max(1, hysteresis)
        self.cooldown = max(0, cooldown)
        self._streak: Dict[int, int] = {}
        self._cooling: Dict[int, int] = {}

    def observe(self, hot_now) -> list:
        hot_now = set(hot_now)
        for sid in list(self._streak):
            if sid not in hot_now:
                del self._streak[sid]
        fire = []
        for sid in sorted(hot_now):
            self._streak[sid] = self._streak.get(sid, 0) + 1
            if sid in self._cooling:
                continue
            if self._streak[sid] >= self.hysteresis:
                fire.append(sid)
        # cooldown ages at the END of the pass so cooldown=N suppresses
        # exactly N subsequent passes
        for sid in list(self._cooling):
            self._cooling[sid] -= 1
            if self._cooling[sid] <= 0:
                del self._cooling[sid]
        return fire

    def fired(self, shard_ids) -> None:
        for sid in shard_ids:
            self._cooling[sid] = self.cooldown
            self._streak.pop(sid, None)


class Balancer:
    def __init__(
        self,
        sm_factory: Callable,
        config_factory: Callable,
        *,
        hosts: Optional[Dict[str, object]] = None,
        replication_factor: int = 3,
        seed: int = 0,
        balance_replicas: bool = True,
        metrics=None,
        event_listener=None,
        step_timeout: float = 10.0,
        catchup_timeout: float = 30.0,
        catchup_gap: int = 0,
        alive: Optional[Callable] = None,
        load_policy: Optional[LoadPolicy] = None,
    ):
        self.hosts: Dict[str, object] = dict(hosts or {})
        self.seed = seed
        self._draining: set = set()
        self._lock = threading.RLock()
        # serializes whole passes: drain() may overlap the run() loop,
        # and two executors moving concurrently would race membership
        self._pass_lock = threading.Lock()
        if metrics is None:
            from ..metrics import MetricsRegistry

            metrics = MetricsRegistry(enabled=True)
        self.metrics = metrics
        self.events = (
            EventFanout(None, event_listener)
            if event_listener is not None else None
        )
        self.collector = Collector(alive=alive)
        self.planner = Planner(
            seed=seed,
            replication_factor=replication_factor,
            balance_replicas=balance_replicas,
        )
        # nemesis plug point (FaultController.install_balancer)
        self.fault_injector = None
        # load-feedback mode (docs/BALANCE.md "Load-reactive
        # rebalancing"): hysteresis state + the most recent pass report
        self.load_policy = load_policy or LoadPolicy()
        self._hot = HotTracker(
            hysteresis=self.load_policy.hysteresis,
            cooldown=self.load_policy.cooldown,
        )
        self._load_moves = self.metrics.counter("balance_load_moves_total")
        self.last_load_report: dict = {}
        # the most recent pass's final collect (see _rebalance_locked)
        self._last_view: Optional[ClusterView] = None
        # shard -> consecutive passes its membership showed an all-live
        # surplus; at _TRIM_LIVE_PASSES the planner may trim a live
        # member (an interrupted replace's roll-forward leftover)
        self._surplus_streak: Dict[int, int] = {}
        self.executor = MoveExecutor(
            self.hosts,
            sm_factory,
            config_factory,
            metrics=self.metrics,
            events=self.events,
            step_timeout=step_timeout,
            catchup_timeout=catchup_timeout,
            catchup_gap=catchup_gap,
        )
        self._run_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.metrics.gauge(
            "balance_hosts", lambda: len(self.hosts)
        )
        self.metrics.gauge(
            "balance_draining_hosts", lambda: len(self._draining)
        )

    @property
    def last_move_report(self) -> dict:
        """The executor's most recent move report (incl. the
        ``"catchup"`` snapshot-stream progress block) — surfaced so
        drain/rebalance drivers (the scenario orchestrator's region
        drain foremost) can put stream totals in their ledgers without
        reaching into the executor."""
        return self.executor.last_move_report

    # -- membership of the host fleet -----------------------------------
    def join(self, key: str, nh) -> None:
        """Register a (new or returning) host; subsequent passes spread
        replicas and leaders onto it."""
        with self._lock:
            self.hosts[key] = nh
            self._draining.discard(key)

    def remove_host(self, key: str) -> None:
        """Forget a host (after drain, or after it died — the repair
        invariant then restores its replicas elsewhere)."""
        with self._lock:
            self.hosts.pop(key, None)
            self._draining.discard(key)

    def mark_draining(self, key: str) -> None:
        with self._lock:
            self._draining.add(key)

    # -- the control loop ------------------------------------------------
    def view(self) -> ClusterView:
        with self._lock:
            hosts = dict(self.hosts)
            draining = set(self._draining)
        return self.collector.collect(hosts, draining)

    def plan(self) -> MovePlan:
        return self.planner.plan(self.view())

    def rebalance_once(self, max_moves: Optional[int] = None) -> dict:
        """One collect -> plan -> execute pass.  Executes the plan's
        moves in order, re-collecting the view after each membership
        move (the next move must see the world the previous one made).
        Whole passes are serialized (``drain`` may overlap the ``run``
        loop; two executors moving concurrently would race membership).
        ``max_moves`` caps how many of the planned moves execute this
        pass (the churn nemesis races exactly ONE move against its
        schedule; later passes converge the rest).  Returns
        ``{"planned": n, "executed": n, "failed": n}``."""
        with self._pass_lock:
            return self._rebalance_locked(max_moves)

    _TRIM_LIVE_PASSES = 3

    def _update_surplus_streaks(self, view: ClusterView) -> set:
        """Track shards whose ALL-LIVE surplus persists across passes;
        a one-view surplus can be a stale snapshot (remove committed
        but not applied at the reporter), a persistent one is a
        rolled-forward replace's leftover voter."""
        rf = self.planner.replication_factor
        seen = set()
        for s in view.shards:
            live_hosts = {r.host for r in s.replicas}
            if (len(s.members) > rf
                    and all(h in live_hosts for _, h in s.members)):
                seen.add(s.shard_id)
                self._surplus_streak[s.shard_id] = (
                    self._surplus_streak.get(s.shard_id, 0) + 1
                )
        for sid in list(self._surplus_streak):
            if sid not in seen:
                del self._surplus_streak[sid]
        return {
            sid for sid, n in self._surplus_streak.items()
            if n >= self._TRIM_LIVE_PASSES
        }

    def _rebalance_locked(self, max_moves: Optional[int] = None) -> dict:
        view = self.view()
        plan = self.planner.plan(view, self._update_surplus_streaks(view))
        self.metrics.gauge("balance_last_plan_size").set(len(plan))
        executed = failed = 0
        # propagate the nemesis plug point installed after construction
        self.executor.fault_injector = self.fault_injector
        for move in plan:
            if self._stop.is_set():
                break
            if max_moves is not None and executed + failed >= max_moves:
                break
            try:
                self.executor.execute(move, view)
                executed += 1
            except MoveFailed as e:
                failed += 1
                _log.warning("move failed: %s", e)
            view = self.view()
        # the pass's final view is fresh (re-collected after the last
        # move): expose it so drain() doesn't pay a third full collect
        # per pass just to re-learn what this loop already knows
        self._last_view = view
        return {"planned": len(plan), "executed": executed, "failed": failed}

    # -- load-feedback mode ---------------------------------------------
    def set_load_policy(self, policy: LoadPolicy) -> None:
        """Swap the load policy AND reset the hysteresis tracker (a
        policy change mid-streak would make stale streaks fire under
        thresholds they never saw)."""
        self.load_policy = policy
        self._hot = HotTracker(
            hysteresis=policy.hysteresis, cooldown=policy.cooldown
        )

    def attach_load_source(self, fn: Callable[[], Dict[int, dict]]) -> None:
        """Wire the serving plane's evidence (``Gateway.shard_load``)
        into the collector; subsequent views carry per-shard load rows
        and ``load_rebalance_once`` can react to them."""
        self.collector.load_source = fn

    def load_rebalance_once(self) -> dict:
        """One load-feedback pass: collect (with load rows), classify
        hot shards against the policy, advance the hysteresis tracker,
        and — only for shards whose hot streak reached the bar — plan a
        seeded ``spread_hot`` pass and execute it with the normal move
        discipline (one move at a time, fresh view after each,
        rollback in the executor).  Fired shards start their cooldown
        whether their move succeeded or not: hammering a shard whose
        move just failed is exactly the thrash the guard exists for."""
        with self._pass_lock:
            return self._load_rebalance_locked()

    def _load_rebalance_locked(self) -> dict:
        pol = self.load_policy
        view = self.view()
        hot_now = [l.shard_id for l in view.load if pol.is_hot(l)]
        fire = self._hot.observe(hot_now)
        report = {
            "hot": sorted(hot_now), "fired": list(fire),
            "planned": 0, "executed": 0, "failed": 0, "moves": [],
        }
        if fire:
            plan = self.planner.plan_spread_hot(
                view, fire, max_moves=pol.max_moves
            )
            report["planned"] = len(plan)
            self.executor.fault_injector = self.fault_injector
            for move in plan:
                if self._stop.is_set():
                    break
                try:
                    self.executor.execute(move, view)
                    report["executed"] += 1
                    self._load_moves.add()
                    report["moves"].append(move.describe())
                except MoveFailed as e:
                    report["failed"] += 1
                    _log.warning("load move failed: %s", e)
                view = self.view()
            self._last_view = view
            self._hot.fired([m.shard_id for m in plan])
        self.last_load_report = report
        return report

    def drain(self, key: str, *, timeout: float = 120.0,
              settle_passes: int = 1) -> dict:
        """Drain a host: mark it, then rebalance until it holds zero
        member replicas AND the plan is empty (leader counts settled
        within ±1), or raise :class:`DrainTimeout`.  Returns the final
        pass report plus convergence stats."""
        self.mark_draining(key)
        deadline = time.monotonic() + timeout
        passes = 0
        settled = 0
        last = {"planned": 0, "executed": 0, "failed": 0}
        while True:
            if time.monotonic() >= deadline:
                raise DrainTimeout(
                    f"drain({key!r}) did not converge within {timeout}s: "
                    f"{self.view().replicas_on(key)} replicas left"
                )
            report = self.rebalance_once()
            passes += 1
            last = report
            view = self._last_view  # the pass's own final collect
            targets = set(view.target_hosts())
            # full leader coverage on survivors is part of the fixed
            # point: an empty plan over a view with a mid-election
            # (leaderless) shard is a lucky snapshot, not convergence —
            # that shard's leader may land anywhere and unbalance ±1
            covered = all(
                s.leader_host and s.leader_host in targets
                for s in view.shards
            )
            if not (report["planned"] == 0 and view.replicas_on(key) == 0
                    and covered):
                settled = 0
                # pace the loop: an unconverged pass (mid-election
                # shard, remove not yet applied) should not busy-spin
                # full cluster collects back-to-back for the whole
                # timeout
                time.sleep(0.05)
                continue
            settled += 1
            # one extra empty pass confirms a fixed point, not a
            # lucky snapshot between a remove-commit and its stats
            if settled >= settle_passes:
                break
        last["passes"] = passes
        return last

    def run(self, interval: float = 0.5, *,
            load_feedback: bool = False) -> None:
        """Start the continuous rebalancing loop on a daemon thread.
        With ``load_feedback=True`` each pass also runs the
        load-reactive pass (requires an attached load source; a pass
        without load rows is a no-op)."""
        with self._lock:
            if self._run_thread is not None:
                raise RuntimeError("balancer already running")
            self._stop.clear()
            self._run_thread = threading.Thread(
                target=self._run_main, args=(interval, load_feedback),
                daemon=True, name="tpu-raft-balancer",
            )
            self._run_thread.start()

    def _run_main(self, interval: float, load_feedback: bool = False) -> None:
        while not self._stop.wait(interval):
            try:
                self.rebalance_once()
                if load_feedback:
                    self.load_rebalance_once()
            except Exception:  # noqa: BLE001 — the loop must survive a bad pass
                _log.exception("rebalance pass raised")

    def stop(self) -> None:
        self._stop.set()
        t = self._run_thread
        if t is not None:
            t.join(timeout=5.0)
            if t.is_alive():
                # a pass can legitimately outlive the join (catchup
                # deadlines run tens of seconds): leave _stop SET and
                # the handle in place so the loop exits at its next
                # check and a later stop() can reap it — clearing the
                # event here would revive the loop as an unstoppable
                # zombie (review finding)
                _log.warning(
                    "balancer loop still finishing a move; it will "
                    "stop at the next pass boundary"
                )
                return
            self._run_thread = None
        self._stop.clear()
        if self.events is not None:
            self.events.close()
