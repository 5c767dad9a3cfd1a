"""The host execution engine: fixed worker pools over all shards.

reference: engine.go [U].  The shape is the reference's exactly:

  * shards are partitioned by ``shard_id % worker_count``;
  * each **step worker** drains its ready set, calls ``node.step()`` for
    each ready shard, then issues ONE batched ``logdb.save_raft_state``
    for all their Updates (the single-fsync-per-iteration trick), then
    ``node.process_update`` per shard (send + schedule apply);
  * **apply workers** drain ``rsm.TaskQueue``s;
  * ``WorkReady`` is the per-partition ready-set + condition pair so idle
    shards cost nothing.

This is also the "StepEngineFactory" seam: a vectorized engine replaces
the per-shard ``node.step()`` loop with one device call over the whole
partition (see engine/tpu_engine.py).
"""
from __future__ import annotations

import abc
import threading
import time
from typing import Dict, List, Optional, TYPE_CHECKING

from ..logger import get_logger
from ..metrics import MetricsRegistry
from ..utils.stopper import Stopper

if TYPE_CHECKING:
    from ..node import Node

_log = get_logger("engine")


class WorkReady:
    """Per-partition ready-shard set with wakeup (reference: workReady [U])."""

    def __init__(self, partitions: int):
        self.partitions = partitions
        self._sets: List[set] = [set() for _ in range(partitions)]
        self._conds = [threading.Condition() for _ in range(partitions)]

    def partition(self, shard_id: int) -> int:
        return shard_id % self.partitions

    def notify(self, shard_id: int) -> None:
        p = self.partition(shard_id)
        with self._conds[p]:
            self._sets[p].add(shard_id)
            self._conds[p].notify()

    def notify_all(self, shard_ids) -> None:
        by_p: Dict[int, List[int]] = {}
        for s in shard_ids:
            by_p.setdefault(self.partition(s), []).append(s)
        for p, ids in by_p.items():
            with self._conds[p]:
                self._sets[p].update(ids)
                self._conds[p].notify()

    def wait(self, p: int, timeout: float, stop: threading.Event) -> List[int]:
        with self._conds[p]:
            if not self._sets[p] and not stop.is_set():
                self._conds[p].wait(timeout)
            out = list(self._sets[p])
            self._sets[p].clear()
            return out

    def wake(self) -> None:
        for c in self._conds:
            with c:
                c.notify_all()


class IStepEngine(abc.ABC):
    """The sanctioned plug point (north star: StepEngineFactory beside
    LogDBFactory/TransportFactory under ExpertConfig)."""

    @abc.abstractmethod
    def step_shards(self, nodes: List["Node"], worker_id: int) -> None:
        """Step every node, batch-persist, dispatch."""

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def detach(self, shard_id: int) -> None:
        """A shard was unregistered; release any engine-held row state."""

    def detach_many(self, shard_ids) -> None:
        """Batch detach (NodeHost.close): engines holding shared state
        behind one lock override this so a 10k-shard teardown is one
        lock acquisition, not 10k interleaved with live launches."""
        for s in shard_ids:
            self.detach(s)

    def device_coordinate(self, shard_id: int):
        """Device/chip coordinate hosting this shard's engine row, or
        None when unknown (host path, no mesh).  Mesh-capable engines
        override (VectorStepEngine); the balance plane reads it through
        ExecEngine so chip placement becomes a planner dimension
        (ROADMAP 3 / docs/MULTICHIP.md "Placement")."""
        return None

    def device_chip_count(self) -> int:
        """Chips this engine spreads rows over (1 = single device)."""
        return 1


class HostStepEngine(IStepEngine):
    """Default serial step loop with cross-shard batched WAL writes."""

    def __init__(self, logdb):
        self.logdb = logdb

    def step_shards(self, nodes: List["Node"], worker_id: int) -> None:
        updates = []
        stepped = []
        for node in nodes:
            u = node.step()
            if u is not None:
                updates.append(u)
                stepped.append((node, u))
        if not updates:
            return
        # one batched fsync for every shard stepped this iteration
        self.logdb.save_raft_state(updates, worker_id)
        for node, u in stepped:
            if node.process_update(u):
                node.engine_apply_ready(node.shard_id)  # type: ignore[attr-defined]


class ExecEngine:
    def __init__(
        self,
        logdb,
        step_workers: int = 16,
        apply_workers: int = 16,
        step_engine: Optional[IStepEngine] = None,
        metrics=None,
    ):
        self.logdb = logdb
        # a disabled registry no-ops every record call, so the worker
        # loop needs no metrics-enabled branch; resolve the instruments
        # once — the step loop is hot
        self.metrics = metrics or MetricsRegistry(enabled=False)
        self._step_hist = self.metrics.histogram("raft_engine_step_seconds")
        self._step_iters = self.metrics.counter(
            "raft_engine_step_iterations_total"
        )
        # obs tentpole: the step-batch-size distribution is THE signal
        # separating "many idle wakeups" from "healthy batching" (the
        # single-fsync-per-iteration trick only pays when batches > 1);
        # bucket bounds are shard counts, not seconds
        self._step_batch_hist = self.metrics.histogram(
            "raft_engine_step_batch_size",
            bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )
        self._apply_hist = self.metrics.histogram("raft_engine_apply_seconds")
        self.step_ready = WorkReady(step_workers)
        self.apply_ready = WorkReady(apply_workers)
        self.step_engine = step_engine or HostStepEngine(logdb)
        self._nodes: Dict[int, "Node"] = {}  # shard_id -> node
        self._nodes_lock = threading.RLock()
        # owned-thread lifecycle (reference: syncutil.Stopper [U]):
        # stop() signals + joins every worker and reports stragglers
        self._stopper = Stopper("tpu-raft-engine")
        self._stop = self._stopper.should_stop
        self._worker_plan = [
            (self._step_worker_main, f"tpu-raft-step-{i}")
            for i in range(step_workers)
        ] + [
            (self._apply_worker_main, f"tpu-raft-apply-{i}")
            for i in range(apply_workers)
        ]

    def start(self) -> None:
        self.step_engine.start()
        for i, (fn, name) in enumerate(self._worker_plan):
            wid = int(name.rsplit("-", 1)[1])
            self._stopper.run_worker(lambda f=fn, w=wid: f(w), name)

    def stop(self) -> None:
        self._stop.set()
        self.step_ready.wake()
        self.apply_ready.wake()
        # the join must outlast one worst-case step iteration: in
        # colocated mode a worker can be blocked on the shared core lock
        # behind another member's full-width launch (multi-second at 64k
        # rows on CPU) — 2s here is what produced the r03 MULTICHIP
        # 'workers leaked at stop' artifact.  The join returns the
        # moment workers exit, so a healthy stop stays fast.
        leaked = self._stopper.stop(timeout=30.0)
        if leaked:
            _log.warning("engine workers leaked at stop: %s", leaked)
        self.step_engine.stop()

    # -- registration -----------------------------------------------------
    def register(self, node: "Node") -> None:
        # callbacks must be in place before the node is visible to workers:
        # a stale workReady entry for this shard id can step it immediately
        node.notify_work = lambda s=node.shard_id: self.step_ready.notify(s)
        node.engine_apply_ready = lambda s: self.apply_ready.notify(s)
        # the WorkReady itself, for the batched per-SM-worker commit
        # handoff (ops/engine._apply_lane_commits): one notify_all per
        # partition per generation instead of one lock take per row
        node.apply_work_ready = self.apply_ready
        with self._nodes_lock:
            self._nodes[node.shard_id] = node
        self.step_ready.notify(node.shard_id)

    def unregister(self, shard_id: int) -> None:
        with self._nodes_lock:
            self._nodes.pop(shard_id, None)
        self.step_engine.detach(shard_id)

    def unregister_many(self, shard_ids) -> None:
        with self._nodes_lock:
            for s in shard_ids:
                self._nodes.pop(s, None)
        self.step_engine.detach_many(shard_ids)

    def nodes_for_partition(self, shard_ids: List[int]) -> List["Node"]:
        with self._nodes_lock:
            return [
                self._nodes[s]
                for s in shard_ids
                if s in self._nodes and not self._nodes[s].stopped
            ]

    def notify(self, shard_id: int) -> None:
        self.step_ready.notify(shard_id)

    # -- placement -> device coordinate (the balance plane's chip axis) --
    def device_coordinate(self, shard_id: int):
        return self.step_engine.device_coordinate(shard_id)

    def device_chip_count(self) -> int:
        return self.step_engine.device_chip_count()

    def notify_many(self, shard_ids) -> None:
        self.step_ready.notify_all(shard_ids)

    # -- workers ----------------------------------------------------------
    def _step_worker_main(self, worker_id: int) -> None:
        while not self._stop.is_set():
            ready = self.step_ready.wait(worker_id, timeout=0.1, stop=self._stop)
            if self._stop.is_set():
                return
            nodes = self.nodes_for_partition(ready)
            if not nodes:
                continue
            try:
                t0 = time.perf_counter()
                self.step_engine.step_shards(nodes, worker_id)
                self._step_hist.observe(time.perf_counter() - t0)
                self._step_batch_hist.observe(len(nodes))
                self._step_iters.add()
            except Exception:  # noqa: BLE001
                _log.exception("step worker %d failed", worker_id)
            # shards with remaining work re-arm immediately
            for n in nodes:
                if n.has_work():
                    self.step_ready.notify(n.shard_id)

    def _apply_worker_main(self, worker_id: int) -> None:
        while not self._stop.is_set():
            ready = self.apply_ready.wait(worker_id, timeout=0.1, stop=self._stop)
            if self._stop.is_set():
                return
            with self._nodes_lock:
                nodes = [self._nodes[s] for s in ready if s in self._nodes]
            for node in nodes:
                try:
                    t0 = time.perf_counter()
                    node.apply()
                    self._apply_hist.observe(time.perf_counter() - t0)
                except Exception:  # noqa: BLE001
                    _log.exception(
                        "apply worker %d shard %d failed", worker_id, node.shard_id
                    )
                # applying may have unblocked step work (e.g. config change)
                if node.has_work():
                    self.step_ready.notify(node.shard_id)
