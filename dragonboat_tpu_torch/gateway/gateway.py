"""The serving front plane: session multiplexing, batched submission,
leader routing, overload shedding, lease reads.

reference: dragonboat serves client traffic straight off NodeHost; the
missing production layer this module adds is the INGRESS story the
ROADMAP's item 4 describes — many lightweight client handles multiplexed
onto few raft-path submissions:

* :class:`ClientHandle` — a cheap per-client object wrapping one
  exactly-once ``client.Session`` (keyed into the replicated
  ``rsm/session.py`` SessionManager for dedupe).  Per-session ordering
  is STRUCTURAL: a handle has at most one proposal in flight; later
  proposals queue on the handle and are released by the completion of
  the previous one — exactly the series-id discipline the session
  registry requires.
* :class:`Gateway` — accepts handles' proposals, sheds at the door
  (``gateway/admission.py``), coalesces admitted ones into per-shard
  batches drained by a small worker pool, and submits each batch
  through the routed leader host's ``NodeHost.propose`` (one
  ``engine.notify`` wake per request, but the node-level proposal
  queue drains the whole batch into ONE raft append).  Reads take the
  CheckQuorum lease fast path (``NodeHost.try_lease_read``) and fall
  back to ReadIndex.

Retry discipline inside the worker: DROPPED (definitely not committed)
attempts are retried for every handle; timed-out (maybe committed)
attempts are retried ONLY on exactly-once handles, where the unchanged
series id makes the retry dedupe-safe (reference client semantics [U])
— noop handles surface the timeout instead, preserving at-most-once.
Once any attempt is maybe-committed, every terminal failure path burns
the series (``proposal_completed``) so the handle's NEXT op can never
be mistaken for a retry of the dead one.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from ..client import LatencyBudget, Session
from ..logger import get_logger
from ..metrics import MetricsRegistry
from ..readplane import (
    BOUND_TICKS_DEFAULT,
    Consistency,
    PATH_BOUNDED,
    PATH_FOLLOWER,
    PATH_LEASE,
    PATH_READ_INDEX,
    READ_PATHS,
    ReadResult,
    ReadRouter,
    ReadUnsupported,
    STALENESS_TICK_BOUNDS,
    StaleBoundExceeded,
)
from ..request import RequestResultCode, ShardNotFound, SystemBusy
from .admission import AdmissionController
from .routing import RoutingCache

_log = get_logger("gateway")


class GatewayBusy(SystemBusy):
    """Shed at the gateway door (queue full / deadline infeasible).
    Subclasses SystemBusy so ``client.call_with_retry`` treats it as
    the transient it is."""


class GatewayClosed(RuntimeError):
    pass


class GatewayConfig:
    """Knobs for one Gateway (defaults suit the in-proc test fleets;
    see docs/GATEWAY.md for sizing guidance)."""

    def __init__(
        self,
        *,
        workers: int = 2,
        max_batch: int = 64,
        max_queue_per_shard: int = 256,
        default_timeout: float = 5.0,
        lease_margin_ticks: int = 2,
        shed_dump_threshold: int = 50,
        shed_dump_window: float = 5.0,
        shed_dump_cooldown: float = 30.0,
        budget: Optional[LatencyBudget] = None,
        cap_feedback: bool = True,
        cap_feedback_target_p99: float = 0.25,
        cap_feedback_interval: float = 1.0,
    ):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.workers = workers
        self.max_batch = max_batch
        self.max_queue_per_shard = max_queue_per_shard
        self.default_timeout = default_timeout
        self.lease_margin_ticks = lease_margin_ticks
        self.shed_dump_threshold = shed_dump_threshold
        self.shed_dump_window = shed_dump_window
        self.shed_dump_cooldown = shed_dump_cooldown
        self.budget = budget
        # snapshot-stream cap feedback (ROADMAP 5a): a NodeHost with a
        # gateway attached gets its `bigstate.pacing.CapFeedback` AIMD
        # loop fed from THIS gateway's LatencyBudget automatically —
        # the gateway observes every commit's latency anyway, which is
        # exactly the live signal the loop was missing.  cap_feedback=
        # False opts out (operators driving the cap by hand or from
        # their own control loop).
        self.cap_feedback = cap_feedback
        self.cap_feedback_target_p99 = cap_feedback_target_p99
        self.cap_feedback_interval = cap_feedback_interval


class _ShardLoadState:
    """Per-shard overload evidence (docs/BALANCE.md "Load-reactive
    rebalancing"): an observed-latency budget plus cumulative
    submit/shed counters, read by ``Gateway.shard_load`` and consumed
    by the balance Collector as window deltas.  The counters follow the
    read-path convention — lock-free-ish increments, nothing depends on
    them exactly — and the budget window is deliberately small (128)
    so a post-move latency picture flushes the storm's tail quickly."""

    __slots__ = ("budget", "submitted", "shed")

    def __init__(self):
        self.budget = LatencyBudget(bootstrap=0.25, floor=0.05, window=128)
        self.submitted = 0
        self.shed = 0


class GatewayFuture:
    """Completion future for one gateway proposal."""

    __slots__ = ("_event", "_result", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def _complete(self, result=None, exc: Optional[BaseException] = None):
        self._result = result
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            from ..nodehost import TimeoutError_

            raise TimeoutError_("gateway future wait timed out")
        if self._exc is not None:
            raise self._exc
        return self._result


class _GwReq:
    __slots__ = ("handle", "cmd", "deadline", "future", "t_admit",
                 "ambiguous")

    def __init__(self, handle, cmd: bytes, deadline: float):
        self.handle = handle
        self.cmd = cmd
        self.deadline = deadline
        self.future = GatewayFuture()
        self.t_admit = time.monotonic()
        # True once ANY attempt of this op may have committed (a node-
        # side timeout, or termination with the outcome unobserved):
        # the series must then be burned on EVERY terminal path, not
        # just the final-code-TIMEOUT one — a later DROPPED attempt
        # does not un-commit the earlier ambiguous one (review
        # finding: reusing the series for the next op would let the
        # dedupe registry swallow it as a retry of this one)
        self.ambiguous = False


class ClientHandle:
    """One logical client: a Session plus its not-yet-released op FIFO.

    Cheap by design (a Session dataclass, a deque, one bool) — the
    multiplexing economics come from handles sharing the gateway's
    worker pool and per-shard lanes instead of each owning threads."""

    __slots__ = ("gateway", "session", "shard_id", "_lock", "_queue",
                 "_inflight", "closed")

    def __init__(self, gateway: "Gateway", session: Session):
        self.gateway = gateway
        self.session = session
        self.shard_id = session.shard_id
        self._lock = threading.Lock()
        self._queue: deque = deque()  # guarded-by: _lock
        self._inflight = False  # guarded-by: _lock
        self.closed = False

    def is_exactly_once(self) -> bool:
        return not self.session.is_noop()

    def propose(self, cmd: bytes, timeout: Optional[float] = None):
        """Queue one proposal; returns a :class:`GatewayFuture`.
        Sheds (GatewayBusy) at the door, never after queueing."""
        return self.gateway._submit(self, cmd, timeout)

    def sync_propose(self, cmd: bytes, timeout: Optional[float] = None):
        t = timeout if timeout is not None else self.gateway.config.default_timeout
        return self.propose(cmd, timeout=t).result(t + 1.0)

    def close(self, timeout: float = 2.0) -> None:
        self.gateway.close_handle(self, timeout=timeout)


class Gateway:
    """See module docstring.  ``hosts`` maps host key -> NodeHost (the
    same shape the balance Collector consumes); in-proc fleets pass the
    test harness's dict, a real deployment registers its single local
    host plus any co-located ones."""

    def __init__(
        self,
        hosts: Dict[str, object],
        config: Optional[GatewayConfig] = None,
        *,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.config = config or GatewayConfig()
        # copy-on-write (same discipline as RoutingCache._table and
        # EventFanout._taps): NEVER mutated in place — add/remove_host
        # build a fresh dict under _hosts_lock and swap the reference,
        # so the per-request paths (reads, proposal routing, shed
        # recording) read it in ONE attribute load with no lock and no
        # copy (review finding: a per-request locked dict copy
        # reintroduced exactly the per-request-mutex shape the
        # gateway-hot lint rule bans)
        self._hosts: Dict[str, object] = dict(hosts)
        self._hosts_lock = threading.Lock()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.budget = self.config.budget or LatencyBudget(
            bootstrap=0.25, floor=0.05
        )
        self.routes = RoutingCache(self._live_hosts, metrics=self.metrics)
        self.admission = AdmissionController(
            self.budget,
            max_queue_per_shard=self.config.max_queue_per_shard,
            batch_hint=self.config.max_batch,
            dump_threshold=self.config.shed_dump_threshold,
            dump_window=self.config.shed_dump_window,
            dump_cooldown=self.config.shed_dump_cooldown,
            dump_cb=self._shed_dump,
            metrics=self.metrics,
        )
        # completion counters mutate under _done_lock: tests and the
        # bench read them as exact deltas, and Counter.add is a GIL-
        # racy read-modify-write when several workers complete
        # concurrently (review finding).  The read-path counters
        # (lease/fallback/route) keep the project-wide lock-free-ish
        # metrics convention — nothing depends on them exactly.
        self._done_lock = threading.Lock()
        self._committed = self.metrics.counter("gateway_committed_total")  # guarded-by: _done_lock
        self._failed = self.metrics.counter("gateway_failed_total")  # guarded-by: _done_lock
        self._lease_reads = self.metrics.counter("gateway_lease_read_total")
        self._fallback_reads = self.metrics.counter(
            "gateway_read_fallback_total"
        )
        # read-plane counters (docs/READPLANE.md): one per served path
        # plus sheds; pre-resolved so the read path never takes the
        # registry lock (counter() locks on lookup)
        self._read_paths: Dict[str, int] = {p: 0 for p in READ_PATHS}
        self._read_paths["bounded_shed"] = 0
        self._read_counters = {
            p: self.metrics.counter("gateway_read_total", {"path": p})
            for p in self._read_paths
        }
        self.read_router = ReadRouter()
        # per-shard overload evidence for the elastic balance loop
        # (created lazily on first touch; the lock guards only dict
        # insertion — counter bumps are lock-free-ish by convention)
        self._shard_load: Dict[int, _ShardLoadState] = {}
        self._shard_load_lock = threading.Lock()
        self._staleness = self.metrics.histogram(
            "readplane_staleness_ticks", bounds=STALENESS_TICK_BOUNDS
        )
        self._latency = self.metrics.histogram("gateway_request_seconds")
        # per-shard submission lanes: shard -> deque of _GwReq released
        # by their handles; lanes are partitioned over workers by
        # shard_id so one shard's batch is always built by one worker
        self._lanes: Dict[int, deque] = {}
        self._lanes_lock = threading.Lock()
        self._closed = False
        self.last_shed_dump = ""
        # resolved once per host-set change, NOT per shed: the shed
        # path runs on client threads exactly when the gateway is
        # overloaded, so it must be one attribute load + one ring
        # append (review finding: a per-shed host-dict copy under
        # _hosts_lock concentrated contention on the overload path)
        self._shed_recorder = None
        self._taps = []  # (host, fn) pairs for detach on close
        # per-host snapshot-cap AIMD loops fed from self.budget (see
        # GatewayConfig.cap_feedback); guarded-by: _hosts_lock
        self._cap_loops: Dict[str, object] = {}
        self._cap_stop = threading.Event()
        self._cap_thread: Optional[threading.Thread] = None
        for key, nh in self._hosts.items():
            self._attach_host(key, nh)
        self._refresh_shed_recorder()
        if self.config.cap_feedback:
            self._cap_thread = threading.Thread(
                target=self._cap_feedback_main,
                daemon=True,
                name="tpu-gw-capfeedback",
            )
            self._cap_thread.start()
        self._wake_events = [
            threading.Event() for _ in range(self.config.workers)
        ]
        self._workers = [
            threading.Thread(
                target=self._worker_main,
                args=(i,),
                daemon=True,
                name=f"tpu-gw-worker-{i}",
            )
            for i in range(self.config.workers)
        ]
        for t in self._workers:
            t.start()

    # -- host membership ---------------------------------------------------
    def _live_hosts(self) -> Dict[str, object]:
        """Current host-map snapshot: one attribute load, lock-free
        (copy-on-write — treat as immutable, never mutate)."""
        return self._hosts

    def _attach_host(self, key: str, nh) -> None:
        tap = self.routes.host_tap(key)
        try:
            nh.add_event_tap(tap)
            self._taps.append((nh, tap))
        except Exception:  # noqa: BLE001 — a host without a fanout
            # (test double) still routes via discovery
            _log.exception("gateway: could not tap host %s", key)
        self._maybe_attach_cap_feedback(key, nh)

    def _maybe_attach_cap_feedback(self, key: str, nh) -> None:
        """Register the host for snapshot-cap feedback (ROADMAP 5a):
        the gateway's feedback thread wires any CONFIGURED stream cap
        (transport.snapshot_pacer) to a ``CapFeedback`` AIMD loop fed
        from ``self.budget``.  Binding is resolved PER TICK, not here:
        the operator's runtime knob (``set_snapshot_send_rate``) can
        create, retune or remove the bucket long after attach — a
        snapshot taken now would miss a late-configured cap, clamp a
        raised one back to a stale base, or keep ticking an orphaned
        bucket (review findings).  Hosts without a cap are left alone —
        the loop never INVENTS a cap the operator didn't configure."""
        if not self.config.cap_feedback:
            return
        if getattr(nh, "transport", None) is None:
            return
        with self._hosts_lock:
            self._cap_loops[key] = {"nh": nh, "fb": None}

    def _cap_feedback_main(self) -> None:
        from ..bigstate.pacing import CapFeedback  # stdlib-only module

        while not self._cap_stop.wait(self.config.cap_feedback_interval):
            samples_fn = getattr(self.budget, "samples", None)
            # no observed commits yet: p99() is returning the BOOTSTRAP
            # guess, not a measurement — keep binding/tracking loops
            # but make no rate adjustment.  An idle gateway must not
            # read a default 1s bootstrap as a degraded commit path and
            # shrink the operator's cap to the floor with zero load —
            # the exact big-state joiner-before-traffic window the cap
            # exists for (review finding).
            have_signal = not (callable(samples_fn) and samples_fn() == 0)
            with self._hosts_lock:
                loops = list(self._cap_loops.items())
            for key, ent in loops:
                try:
                    # each tick runs UNDER _hosts_lock with a membership
                    # re-check: remove_host/close pop the entry and then
                    # RESTORE the cap to base — a tick racing past that
                    # restore from a stale snapshot would re-shrink a
                    # cap nothing will ever grow back (review finding).
                    # The tick body is cheap (cached p99 + set_rate),
                    # and host add/remove is rare, so the lock hold is
                    # fine.
                    with self._hosts_lock:
                        if self._cap_loops.get(key) is not ent:
                            continue  # retired while we walked
                        tr = getattr(ent["nh"], "transport", None)
                        pacer = getattr(tr, "snapshot_pacer", None)
                        fb = ent["fb"]
                        if pacer is None:
                            # cap removed (set_snapshot_send_rate(0)):
                            # the loop retires, never ticks the orphan
                            ent["fb"] = None
                            continue
                        # the operator's configured base, re-read per
                        # tick so a runtime retune moves the ceiling too
                        base = float(
                            getattr(tr, "max_snapshot_send_rate", 0) or 0
                        )
                        if base <= 0:
                            ent["fb"] = None
                            continue
                        if fb is None or fb.bucket is not pacer:
                            fb = CapFeedback(
                                pacer,
                                base_rate=base,
                                target_p99=(
                                    self.config.cap_feedback_target_p99
                                ),
                                budget=self.budget,
                            )
                            ent["fb"] = fb
                        elif fb.base_rate != base:
                            fb.base_rate = base
                            fb.floor_rate = base / 16.0
                        if have_signal:
                            fb.tick()
                except Exception:  # noqa: BLE001 — one host's loop
                    # must not kill the others'
                    _log.exception("gateway: cap feedback tick failed")

    @staticmethod
    def _retire_cap_loop(ent) -> None:
        """Restore the host's cap to its configured base when the
        feedback stops owning it (remove_host / close): without this a
        cap shrunk by a transient latency spike would strand the host
        at the AIMD floor forever — nothing else would grow it back
        (review finding)."""
        fb = ent.get("fb")
        if fb is None:
            return
        tr = getattr(ent["nh"], "transport", None)
        if getattr(tr, "snapshot_pacer", None) is fb.bucket and (
            fb.bucket.rate != fb.base_rate
        ):
            try:
                fb.bucket.set_rate(fb.base_rate)
            except Exception:  # noqa: BLE001 — host mid-close
                pass

    def cap_feedback_stats(self) -> Dict[str, dict]:
        """Per-host cap-feedback observability: current rate vs base
        and the number of adjustments applied (hosts whose cap is
        unconfigured/removed have no live loop and are omitted)."""
        with self._hosts_lock:
            loops = dict(self._cap_loops)
        out = {}
        for key, ent in loops.items():
            fb = ent.get("fb")
            if fb is not None:
                out[key] = {
                    "rate": fb.bucket.rate,
                    "base_rate": fb.base_rate,
                    "adjustments": fb.adjustments,
                }
        return out

    def _refresh_shed_recorder(self) -> None:
        rec = None
        for _, nh in sorted(self._live_hosts().items()):
            r = getattr(nh, "recorder", None)
            if r is not None:
                rec = r
                break
        self._shed_recorder = rec

    def add_host(self, key: str, nh) -> None:
        with self._hosts_lock:
            t = dict(self._hosts)
            t[key] = nh
            self._hosts = t
        self._attach_host(key, nh)
        self._refresh_shed_recorder()

    def remove_host(self, key: str) -> None:
        with self._hosts_lock:
            t = dict(self._hosts)
            nh = t.pop(key, None)
            self._hosts = t
        if nh is None:
            return
        with self._hosts_lock:
            cap_ent = self._cap_loops.pop(key, None)
        if cap_ent is not None:
            self._retire_cap_loop(cap_ent)
        for pair in list(self._taps):
            if pair[0] is nh:
                try:
                    nh.remove_event_tap(pair[1])
                except Exception:  # noqa: BLE001 — host already closed
                    pass
                self._taps.remove(pair)
        self.routes.invalidate_all()
        self._refresh_shed_recorder()

    # -- session lifecycle -------------------------------------------------
    def connect(self, shard_id: int, timeout: float = 5.0) -> ClientHandle:
        """Register an exactly-once session through the routed leader
        host and wrap it in a handle (reference: SyncGetSession [U]).
        Retries the transient failures a still-electing shard emits
        until ``timeout`` (client.call_with_retry discipline)."""
        if self._closed:
            raise GatewayClosed("gateway closed")
        from ..client import call_with_retry

        deadline = time.monotonic() + timeout

        def register():
            nh = self._host_for(shard_id, any_ok=True)
            if nh is None:
                raise ShardNotFound(f"no live host for shard {shard_id}")
            per_try = max(0.2, min(2.0, deadline - time.monotonic()))
            return nh.sync_get_session(shard_id, timeout=per_try)

        session = call_with_retry(register, deadline=deadline)
        return ClientHandle(self, session)

    def noop_handle(self, shard_id: int) -> ClientHandle:
        """At-most-once handle (no dedupe; reference: NoOPSession [U])."""
        return ClientHandle(self, Session.noop(shard_id))

    def close_handle(self, handle: ClientHandle, timeout: float = 2.0) -> None:
        handle.closed = True
        if not handle.is_exactly_once():
            return
        nh = self._host_for(handle.shard_id, any_ok=True)
        if nh is None:
            return
        try:
            nh.sync_close_session(handle.session, timeout=timeout)
        except Exception:  # noqa: BLE001 — registry LRU will evict it
            pass

    # -- submission path -----------------------------------------------------
    def _submit(self, handle: ClientHandle, cmd: bytes,
                timeout: Optional[float]):
        if self._closed:
            raise GatewayClosed("gateway closed")
        if handle.closed:
            raise GatewayClosed("handle closed")
        t = timeout if timeout is not None else self.config.default_timeout
        deadline = time.monotonic() + t
        reason = self.admission.admit(handle.shard_id, deadline)
        if reason is not None:
            self._record_shed(handle.shard_id, reason)
            raise GatewayBusy(f"shed: {reason} (shard {handle.shard_id})")
        self._shard_load_state(handle.shard_id).submitted += 1
        req = _GwReq(handle, cmd, deadline)
        with handle._lock:
            if handle._inflight:
                handle._queue.append(req)
                return req.future
            handle._inflight = True
        self._enqueue(req)
        return req.future

    def _enqueue(self, req: _GwReq) -> None:
        sid = req.handle.shard_id
        with self._lanes_lock:
            # re-check closed UNDER the lanes lock: close() swaps the
            # lanes dict out under this lock and seals what it swapped —
            # a request landing in the fresh dict after the swap would
            # have no worker left to drain it and its caller would hang
            # (review finding)
            if not self._closed:
                lane = self._lanes.get(sid)
                if lane is None:
                    lane = self._lanes[sid] = deque()
                lane.append(req)
                sealed = False
            else:
                sealed = True
        if sealed:
            self._fail(req, GatewayClosed("gateway closed"))
            return
        self._wake_events[sid % self.config.workers].set()

    def _release_next(self, handle: ClientHandle) -> None:
        """Completion of a handle's in-flight op releases its next one
        (per-session ordering: the series id advanced only now).  After
        close, queued ops are sealed here in a loop — no worker will
        drain them and their callers must not hang."""
        while True:
            with handle._lock:
                if handle._queue:
                    nxt = handle._queue.popleft()
                else:
                    handle._inflight = False
                    return
            if not self._closed:
                self._enqueue(nxt)
                return
            with self._done_lock:
                self._failed.add()
            self.admission.complete(nxt.handle.shard_id)
            nxt.future._complete(exc=GatewayClosed("gateway closed"))

    # -- worker pool ---------------------------------------------------------
    def _my_lanes(self, idx: int):
        with self._lanes_lock:
            return [
                sid for sid in self._lanes
                if sid % self.config.workers == idx
            ]

    def _drain(self, sid: int, limit: int):
        out = []
        with self._lanes_lock:
            lane = self._lanes.get(sid)
            while lane and len(out) < limit:
                out.append(lane.popleft())
        return out

    def _worker_main(self, idx: int) -> None:
        """Drain-submit-poll loop.  Completions are POLLED, never
        blocked on: a shard that lost quorum must not head-of-line
        block the other shards mapped to this worker for its requests'
        whole deadlines (review finding) — its pending pairs just ride
        the ``pending`` list while every other lane keeps draining.
        The poll cadence (5ms with work in flight) bounds the added
        completion latency."""
        ev = self._wake_events[idx]
        pending = []  # (req, rs) submitted, awaiting completion
        while not self._closed:
            ev.wait(timeout=0.005 if pending else 0.05)
            ev.clear()
            for sid in self._my_lanes(idx):
                for req in self._drain(sid, self.config.max_batch):
                    rs = self._propose_once(req)
                    if rs is not None:
                        pending.append((req, rs))
            if pending:
                still = []
                for req, rs in pending:
                    nrs = self._poll_finish(req, rs)
                    if nrs is not None:
                        still.append((req, nrs))
                pending = still
        for req, _rs in pending:
            # submitted but unresolved at close: may still commit
            req.ambiguous = True
            self._fail(req, GatewayClosed("gateway closed"))

    def _host_for(self, shard_id: int, any_ok: bool = False):
        key = self.routes.resolve(shard_id)
        hosts = self._live_hosts()
        nh = hosts.get(key) if key is not None else None
        if nh is not None and not getattr(nh, "_closed", False):
            return nh
        if key is not None:
            self.routes.invalidate(shard_id)
        if not any_ok:
            return None
        # no known leader: any live host carrying the shard will do —
        # followers forward proposals, session ops and read_index alike
        for _, nh in sorted(hosts.items()):
            if getattr(nh, "_closed", False):
                continue
            try:
                nh._get_node(shard_id)
                return nh
            except Exception:  # noqa: BLE001 — shard not on this host
                continue
        return None

    def _propose_once(self, req: _GwReq):
        """One submission attempt; completes the future on terminal
        errors, returns the RequestState otherwise."""
        remaining = req.deadline - time.monotonic()
        if remaining <= 0:
            # expired while queued (e.g. behind a retrying predecessor
            # on its handle): fail BEFORE submission — a doomed submit
            # wastes a raft append and its inevitable timeout marks
            # the op ambiguous, burning a series for nothing (review
            # finding).  Nothing was proposed, so nothing is ambiguous.
            from ..nodehost import TimeoutError_

            self._fail(req, TimeoutError_("gateway deadline (pre-submit)"))
            return None
        nh = self._host_for(req.handle.shard_id, any_ok=True)
        if nh is None:
            self._fail(req, ShardNotFound(
                f"no live host for shard {req.handle.shard_id}"))
            return None
        try:
            return nh.propose(req.handle.session, req.cmd, remaining)
        except Exception as e:  # noqa: BLE001 — classified below
            self.routes.invalidate(req.handle.shard_id)
            self._fail(req, e)
            return None

    def _poll_finish(self, req: _GwReq, rs):
        """Non-blocking completion check for one submitted request.
        Returns None when the gateway future was completed (done,
        failed, or timed out), else the RequestState — possibly a NEW
        one after a dedupe-safe resubmission — to keep polling."""
        from ..nodehost import _CODE_ERRORS, TimeoutError_

        if not rs._event.is_set():
            # still pending node-side (the event is set LAST in
            # notify, after code/result — a set event is a complete,
            # readable outcome)
            if time.monotonic() < req.deadline:
                return rs
            # gateway deadline exhausted on an op that may still
            # commit: ambiguous (the _fail path burns the series —
            # audit-client discipline)
            req.ambiguous = True
            self._fail(req, TimeoutError_("gateway deadline"))
            return None
        code = rs.code
        if code == RequestResultCode.COMPLETED:
            lat = time.monotonic() - req.t_admit
            if req.handle.is_exactly_once():
                req.handle.session.proposal_completed()
            self.budget.observe(lat)
            self._shard_load_state(req.handle.shard_id).budget.observe(lat)
            with self._done_lock:
                self._latency.observe(lat)
                self._committed.add()
            self._done(req, result=rs.result)
            return None
        if code in (
            RequestResultCode.TIMEOUT,
            RequestResultCode.TERMINATED,
            RequestResultCode.ABORTED,
        ):
            # maybe-committed outcomes (the audit client's
            # _MAYBE_COMMITTED_ERRORS set): a timed-out entry may
            # commit later, and a TERMINATED one may already be
            # PERSISTED in the raft log — a shard restart replays and
            # applies it (review finding).  Ambiguity is forever for
            # this op — even if a LATER attempt ends DROPPED, an
            # earlier copy may still commit, so the terminal path must
            # burn the series.  DROPPED and REJECTED are definitive
            # no-effect outcomes and stay unambiguous.
            req.ambiguous = True
        # DROPPED (definitely not committed) retries for everyone.
        # TIMEOUT (maybe committed) retries ONLY for exactly-once
        # handles, whose unchanged series id lets the session registry
        # dedupe a double apply; resubmitting a maybe-committed noop
        # proposal would break noop_handle's at-most-once contract
        # (review finding).
        retryable = code == RequestResultCode.DROPPED or (
            code == RequestResultCode.TIMEOUT
            and req.handle.is_exactly_once()
        )
        if retryable and req.deadline - time.monotonic() > 0.01:
            # pacing comes from the node round trip + the poll cadence
            self.routes.invalidate(req.handle.shard_id)
            return self._propose_once(req)  # None => future completed
        err = _CODE_ERRORS.get(code, TimeoutError_)
        self._fail(req, err(code.name if code is not None else "unknown"))
        return None

    def _done(self, req: _GwReq, result) -> None:
        self.admission.complete(req.handle.shard_id)
        req.future._complete(result=result)
        self._release_next(req.handle)

    def _fail(self, req: _GwReq, exc: BaseException) -> None:
        if req.ambiguous and req.handle.is_exactly_once():
            # some attempt of this op may still commit: burn the
            # series exactly once so the handle's NEXT op can never be
            # taken for a retry of this one (review finding — a
            # terminal DROPPED after an ambiguous TIMEOUT previously
            # skipped the burn)
            req.ambiguous = False
            req.handle.session.proposal_completed()
        with self._done_lock:
            self._failed.add()
        self.admission.complete(req.handle.shard_id)
        req.future._complete(exc=exc)
        self._release_next(req.handle)

    # -- reads ---------------------------------------------------------------
    def read(self, shard_id: int, query, timeout: Optional[float] = None):
        """Linearizable read (value only; the pre-readplane surface).
        Fast path: the routed leader host serves it under its
        CheckQuorum lease, skipping the per-read ReadIndex quorum round
        trip; fallback: plain ``sync_read`` (ReadIndex) through any
        live host.  Safety: docs/GATEWAY.md."""
        return self.read_at(shard_id, query, timeout=timeout).value

    def read_at(
        self,
        shard_id: int,
        query,
        *,
        consistency: Consistency = Consistency.LINEARIZABLE,
        timeout: Optional[float] = None,
        bound_ticks: int = BOUND_TICKS_DEFAULT,
    ) -> ReadResult:
        """Consistency-routed read (docs/READPLANE.md).

        LINEARIZABLE goes to the routed leader (lease fast path,
        ReadIndex fallback); FOLLOWER_LINEARIZABLE and
        BOUNDED_STALENESS fan out over the shard's replica set, the
        serving replica picked by power-of-two-choices on observed
        per-replica p99 (``read_router``).  Returns the value with its
        provenance stamp; BOUNDED_STALENESS raises
        :class:`StaleBoundExceeded` when no replica can serve within
        ``bound_ticks``."""
        if self._closed:
            raise GatewayClosed("gateway closed")
        t = timeout if timeout is not None else self.config.default_timeout
        deadline = time.monotonic() + t
        if consistency == Consistency.FOLLOWER_LINEARIZABLE:
            return self._read_follower(shard_id, query, deadline)
        if consistency == Consistency.BOUNDED_STALENESS:
            return self._read_bounded(shard_id, query, deadline, bound_ticks)
        return self._read_linearizable(shard_id, query, deadline)

    def _count_read(self, path: str) -> None:
        # GIL-racy like the other read-path counters (nothing depends
        # on them exactly); the dict mirror feeds stats()/the ledger
        self._read_paths[path] += 1
        self._read_counters[path].add()

    def _read_event(self, shard_id: int, detail: str) -> None:
        """`read_path` flight-recorder lane: fallback transitions only
        (lease->read_index, follower->leader, bounded sheds) — the
        evidence trail for WHY a read took the path it took."""
        rec = self._shed_recorder  # one attribute load on the hot path
        if rec is not None:
            rec.record(shard_id, "read_path", detail)

    def _read_linearizable(self, shard_id: int, query,
                           deadline: float) -> ReadResult:
        key = self.routes.resolve(shard_id)
        if key is not None:
            nh = self._live_hosts().get(key)
            if nh is not None and not getattr(nh, "_closed", False):
                try:
                    ok, val = nh.try_lease_read(
                        shard_id, query,
                        margin_ticks=self.config.lease_margin_ticks,
                    )
                    if ok:
                        self._lease_reads.add()
                        self._count_read(PATH_LEASE)
                        return ReadResult(val, PATH_LEASE, host=key)
                except Exception:  # noqa: BLE001 — host/shard stopping:
                    # fall through to the quorum path
                    self.routes.invalidate(shard_id)
        # ReadIndex fallback, retried across hosts until the deadline
        self._fallback_reads.add()
        self._read_event(shard_id, "lease->read_index")
        last_exc: Optional[BaseException] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                from ..nodehost import TimeoutError_

                raise last_exc or TimeoutError_("gateway read deadline")
            nh = self._host_for(shard_id, any_ok=True)
            if nh is None:
                time.sleep(0.02)
                continue
            try:
                val = nh.sync_read(shard_id, query, timeout=remaining)
                self._count_read(PATH_READ_INDEX)
                return ReadResult(val, PATH_READ_INDEX)
            except Exception as e:  # noqa: BLE001 — reads are
                # idempotent; retry through another route
                last_exc = e
                self.routes.invalidate(shard_id)
                time.sleep(0.02)

    def _pick_replica(self, shard_id: int, tried):
        """One p2c selection over the live, untried replica set.
        Returns (key, nh) or (None, None) when no candidate remains."""
        hosts = self._live_hosts()
        cands = [
            k for k in self.routes.resolve_replicas(shard_id)
            if k not in tried
            and not getattr(hosts.get(k), "_closed", True)
        ]
        key = self.read_router.pick(cands)
        if key is None:
            return None, None
        return key, hosts.get(key)

    def _read_follower(self, shard_id: int, query,
                       deadline: float) -> ReadResult:
        """FOLLOWER_LINEARIZABLE: any replica confirms via a ReadIndex
        round to the leader and serves from its local state machine.
        Failed replicas are penalized and excluded; an old server
        without the consistency byte degrades to a leader read."""
        last_exc: Optional[BaseException] = None
        tried: set = set()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                from ..nodehost import TimeoutError_

                raise last_exc or TimeoutError_("gateway read deadline")
            key, nh = self._pick_replica(shard_id, tried)
            if nh is None:
                if not tried:
                    # no replica set known at all yet: rediscover
                    time.sleep(0.02)
                    self.routes.invalidate_replicas(shard_id)
                    continue
                tried.clear()  # every replica failed once: fresh round
                time.sleep(0.02)
                continue
            t0 = time.monotonic()
            try:
                val, applied = nh.follower_read(
                    shard_id, query, timeout=remaining
                )
                self.read_router.observe(key, time.monotonic() - t0)
                self._count_read(PATH_FOLLOWER)
                return ReadResult(val, PATH_FOLLOWER,
                                  applied_index=applied, host=key)
            except ReadUnsupported:
                # remote predates the consistency byte: leader read is
                # the compatible contract-preserving fallback
                self._read_event(shard_id,
                                 f"follower->leader: {key} unsupported")
                return self._read_linearizable(shard_id, query, deadline)
            except Exception as e:  # noqa: BLE001 — replica dark/
                # leaderless/mid-transfer: penalize and fan to the next
                self.read_router.penalize(key)
                tried.add(key)
                last_exc = e

    def _read_bounded(self, shard_id: int, query, deadline: float,
                      bound_ticks: int) -> ReadResult:
        """BOUNDED_STALENESS: a replica serves immediately from local
        state, stamped; replicas past the bound shed and the next is
        tried — when EVERY replica sheds, the caller gets
        StaleBoundExceeded (escalate the level or retry later)."""
        last_exc: Optional[BaseException] = None
        shed_exc: Optional[StaleBoundExceeded] = None
        tried: set = set()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                from ..nodehost import TimeoutError_

                raise shed_exc or last_exc or TimeoutError_(
                    "gateway read deadline")
            key, nh = self._pick_replica(shard_id, tried)
            if nh is None:
                if shed_exc is not None:
                    # every live replica is past the bound: shed the
                    # read rather than spin the deadline down
                    raise shed_exc
                if not tried:
                    time.sleep(0.02)
                    self.routes.invalidate_replicas(shard_id)
                    continue
                tried.clear()
                time.sleep(0.02)
                continue
            t0 = time.monotonic()
            try:
                res = nh.bounded_read(shard_id, query,
                                      bound_ticks=bound_ticks)
                self.read_router.observe(key, time.monotonic() - t0)
                self._count_read(PATH_BOUNDED)
                self._staleness.observe(res.staleness_ticks)
                res.host = key
                return res
            except ReadUnsupported:
                self._read_event(shard_id,
                                 f"bounded->leader: {key} unsupported")
                return self._read_linearizable(shard_id, query, deadline)
            except StaleBoundExceeded as e:
                # not a latency fault — the replica is out of leader
                # contact; bias away AND record the shed evidence
                self._count_read("bounded_shed")
                self._read_event(
                    shard_id, f"bounded shed: {key}: {e}")
                self.read_router.penalize(key)
                tried.add(key)
                shed_exc = e
            except Exception as e:  # noqa: BLE001 — replica dark
                self.read_router.penalize(key)
                tried.add(key)
                last_exc = e

    # -- overload evidence -----------------------------------------------------
    def _shard_load_state(self, shard_id: int) -> _ShardLoadState:
        st = self._shard_load.get(shard_id)
        if st is None:
            with self._shard_load_lock:
                st = self._shard_load.setdefault(shard_id, _ShardLoadState())
        return st

    def shard_load(self) -> Dict[int, dict]:
        """Per-shard overload evidence for the elastic balance loop:
        observed commit p99 (seconds, this gateway's view), sample
        count, and CUMULATIVE submitted/shed counts — the Collector
        turns the cumulative counters into per-window deltas with the
        same first-sight baseline it uses for proposal rates."""
        out = {}
        for sid in sorted(self._shard_load):
            st = self._shard_load[sid]
            out[sid] = {
                "p99_s": st.budget.p99(),
                "samples": st.budget.samples(),
                "submitted": st.submitted,
                "shed": st.shed,
            }
        return out

    def _record_shed(self, shard_id: int, reason: str) -> None:
        self._shard_load_state(shard_id).shed += 1
        rec = self._shed_recorder  # one attribute load on the hot path
        if rec is not None:
            rec.record(shard_id, "gateway_shed", reason)

    def _shed_dump(self, why: str) -> None:
        """Sustained shedding: capture the merged cross-host timeline
        (the flight recorder's whole point — evidence at the moment the
        front door starts refusing work)."""
        from ..obs import format_timeline, merged_timeline

        hosts = list(self._live_hosts().values())
        recs = [h for h in (getattr(n, "recorder", None) for n in hosts)
                if h is not None]
        tracers = [t for t in (getattr(n, "tracer", None) for n in hosts)
                   if t is not None]
        dump = why
        if recs or tracers:
            try:
                dump = why + "\n" + format_timeline(
                    merged_timeline(recorders=recs, tracers=tracers)
                )
            except Exception:  # noqa: BLE001 — evidence best-effort
                pass
        self.last_shed_dump = dump
        _log.warning("gateway overload: %s", dump[:4000])

    # -- observability ----------------------------------------------------------
    def stats(self) -> dict:
        with self._done_lock:
            committed = self._committed.value
            failed = self._failed.value
        return {
            "committed": committed,
            "failed": failed,
            "shed": self.admission.shed_total,
            "shed_dumps": self.admission.dumps,
            "lease_reads": self._lease_reads.value,
            "read_fallbacks": self._fallback_reads.value,
            # per-consistency-path serve counts + the router's observed
            # per-replica p99 (the read plane's ledger row inputs)
            "read_paths": dict(self._read_paths),
            "read_p99_by_host": self.read_router.snapshot(),
            "route_table": self.routes.table(),
            "replica_table": self.routes.replica_table(),
            # the commit path's live latency picture, as the scenario
            # ledger samples it per phase (docs/SCENARIO.md): p99 is the
            # budget's sliding-window estimate (bootstrap until any
            # sample lands — see samples)
            "p99_s": self.budget.p99(),
            "budget_samples": self.budget.samples(),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._cap_stop.set()
        if self._cap_thread is not None:
            self._cap_thread.join(timeout=2.0)
        with self._hosts_lock:
            cap_loops, self._cap_loops = self._cap_loops, {}
        for ent in cap_loops.values():
            # hosts outlive the gateway: give them their configured
            # caps back (see _retire_cap_loop)
            self._retire_cap_loop(ent)
        for ev in self._wake_events:
            ev.set()
        for t in self._workers:
            t.join(timeout=2.0)
        for nh, tap in self._taps:
            try:
                nh.remove_event_tap(tap)
            except Exception:  # noqa: BLE001 — host already closed
                pass
        self._taps.clear()
        # seal everything still queued: no worker will drain it now
        with self._lanes_lock:
            lanes, self._lanes = self._lanes, {}
        for lane in lanes.values():
            for req in lane:
                self._fail(req, GatewayClosed("gateway closed"))
