"""Admission control + deadline-aware shedding for the gateway.

Two gates run BEFORE a proposal is queued (docs/GATEWAY.md "Shedding
policy"):

* **bounded queue per shard** — ``depth[shard]`` counts ops admitted
  but not yet completed; at ``max_queue_per_shard`` new ops shed with
  reason ``queue_full``.  Rejecting at the door BOUNDS the in-gateway
  wait inside every admitted request's latency — the p99 the budget
  observes (admission to completion) stays within a queue-depth factor
  of the raft path's p99 instead of growing without bound, which is
  what keeps the deadline gate below meaningful under overload;
* **deadline feasibility** — ``LatencyBudget.can_meet``: an op whose
  remaining deadline is under the observed p99 commit latency (scaled
  by the queue ahead of it) cannot make it; shed with reason
  ``deadline`` now rather than time out after consuming a slot.

Every shed increments ``gateway_shed_total{reason=...}``.  Sustained
shedding — more than ``dump_threshold`` sheds inside a sliding
``dump_window``-second window — fires the ``dump_cb`` at most once per
``dump_cooldown`` (the gateway wires it to the flight-recorder merged
timeline, so the moment the front door starts refusing work there is a
cross-host record of why).

Depth accounting is a plain per-shard int mutated under ``_lock`` on
admit/complete (cold-ish: two short acquisitions per op, never held
across any wait).  The shed probe itself reads the depth once —
the hot READ path of the routing cache stays lock-free; admission is
where the one lock of the gateway front door lives, by design.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..logger import get_logger

_log = get_logger("gateway")


class AdmissionController:
    def __init__(
        self,
        budget,
        *,
        max_queue_per_shard: int = 256,
        batch_hint: int = 64,
        dump_threshold: int = 50,
        dump_window: float = 5.0,
        dump_cooldown: float = 30.0,
        dump_cb: Optional[Callable[[str], None]] = None,
        metrics=None,
    ):
        self.budget = budget  # client.LatencyBudget (shared with gateway)
        self.max_queue_per_shard = max_queue_per_shard
        self.batch_hint = batch_hint
        self._lock = threading.Lock()
        self._depth: Dict[int, int] = {}  # guarded-by: _lock
        self._metrics = metrics
        self._shed_counters: Dict[str, object] = {}  # guarded-by: _lock
        self.shed_total = 0  # guarded-by: _lock
        # sustained-shed detection: ring of recent shed timestamps
        self._shed_times: deque = deque(maxlen=max(dump_threshold, 1))  # guarded-by: _lock
        self.dump_threshold = dump_threshold
        self.dump_window = dump_window
        self.dump_cooldown = dump_cooldown
        self.dump_cb = dump_cb
        self._last_dump = 0.0  # guarded-by: _lock
        self.dumps = 0  # guarded-by: _lock

    # -- depth accounting -------------------------------------------------
    def depth(self, shard_id: int) -> int:
        # raftlint: ignore[guarded-by] lock-free scrape-time snapshot
        return self._depth.get(shard_id, 0)

    def _shed(self, shard_id: int, reason: str) -> str:
        """Account one shed.  All shed-side state mutates under _lock
        (concurrent client threads shed simultaneously — unlocked
        read-modify-writes lost counts and double-fired dumps; review
        finding); the expensive dump callback runs OUTSIDE it."""
        now = time.monotonic()
        fire_dump = False
        with self._lock:
            self.shed_total += 1
            c = self._shed_counters.get(reason)
            if c is None and self._metrics is not None:
                c = self._metrics.counter(
                    "gateway_shed_total", {"reason": reason}
                )
                self._shed_counters[reason] = c
            if c is not None:
                c.add()
            self._shed_times.append(now)
            if (
                self.dump_cb is not None
                and len(self._shed_times) >= self.dump_threshold
                and now - self._shed_times[0] <= self.dump_window
                and now - self._last_dump >= self.dump_cooldown
            ):
                self._last_dump = now
                self.dumps += 1
                fire_dump = True
        if fire_dump:
            self._fire_dump(shard_id, reason)
        return reason

    def admit(self, shard_id: int, deadline: float) -> Optional[str]:
        """Admit or shed one proposal aimed at ``shard_id`` with an
        absolute ``time.monotonic()`` ``deadline``.  Returns None on
        admit (depth charged; caller MUST pair with :meth:`complete`)
        or the shed reason string."""
        now = time.monotonic()
        remaining = deadline - now
        if remaining <= 0:
            return self._shed(shard_id, "deadline")
        with self._lock:
            d = self._depth.get(shard_id, 0)
            if d >= self.max_queue_per_shard:
                queue_full = True
            else:
                queue_full = False
                if self.budget.can_meet(
                    remaining, queued_ahead=d, batch_hint=self.batch_hint
                ):
                    self._depth[shard_id] = d + 1
                    return None
        if queue_full:
            return self._shed(shard_id, "queue_full")
        return self._shed(shard_id, "deadline")

    def complete(self, shard_id: int) -> None:
        """Release one admitted op's depth charge (every completion
        path: applied, failed, timed out)."""
        with self._lock:
            d = self._depth.get(shard_id, 0)
            if d <= 1:
                self._depth.pop(shard_id, None)
            else:
                self._depth[shard_id] = d - 1

    # -- sustained-shed auto-dump -----------------------------------------
    def _fire_dump(self, shard_id: int, reason: str) -> None:
        try:
            self.dump_cb(
                f"sustained shedding: {self.dump_threshold}+ sheds "
                f"inside {self.dump_window:.1f}s (last: shard "
                f"{shard_id}, {reason})"
            )
        except Exception:  # noqa: BLE001 — the dump is evidence, not
            # a dependency; shedding must keep working without it
            _log.exception("shed dump callback raised")
