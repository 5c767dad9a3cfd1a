"""Unified deterministic fault-injection subsystem (the nemesis).

reference: the drummer/monkeytest chaos methodology [U] — long-running
clusters shaken by partitions, message loss, disk faults and crash
cycles, with invariant checks after every heal.  This module replaces
the three ad-hoc injection points that grew organically (the in-proc
transport's ``drop_hook``, ``StrictMemFS.fault_hook`` and the tan
LogDB's ``fault_hook``) with ONE seeded, declarative fault plane that
every layer consumes:

* **wire** — both raw transports (``transport/inproc.py``,
  ``transport/tcp.py``) pass every outbound ``MessageBatch``/``Chunk``
  through :meth:`FaultController.on_wire`, which applies symmetric or
  asymmetric partitions, probabilistic drop / delay / duplicate /
  reorder, and snapshot-chunk corruption.
* **storage** — ``StrictMemFS`` and the tan WAL consult
  :meth:`on_fs_op` before data-touching operations; active fault
  windows raise injected fsync / torn-write errors.
* **engine** — the device step engines consult
  :meth:`on_engine_step` per row per launch; an active ``escalate``
  fault forces the kernel-escalation recovery path (discard device
  effects, replay on the scalar).
* **process** — ``crash`` faults call harness-registered kill/restart
  callbacks, so replica crash-restart cycles ride the same schedule.
* **balance** — the rebalancing move executor (``balance/executor.py``)
  consults :meth:`on_balance_step` before every step of a move;
  ``balance_abort`` kills the move mid-sequence (forcing the rollback
  path) and ``balance_stall`` stretches a step so other planes can
  strike while the move is in flight.
* **stream** — the snapshot stream jobs (``transport/transport.py``)
  consult :meth:`on_snapshot_stream` per outbound chunk;
  ``snapshot_stream_kill`` raises mid-transfer (the streamer dies and
  the retry must RESUME from the receiver's cursor — docs/BIGSTATE.md)
  and ``snapshot_stream_stall`` stretches the transfer so other planes
  can strike while a laggard is mid-catch-up.
* **churn** — drummer-style scheduled churn (:meth:`install_churn`):
  ``leader_kill`` samples and kills the CURRENT leader of a shard,
  ``leader_transfer`` forces leadership to another voter,
  ``member_cycle`` adds/removes a non-voting member mid-traffic and
  ``balance_move`` races one ``Balancer`` move against the schedule —
  each optionally followed by a per-event recovery-SLA assert
  (re-election bound + commit continuity; misses collect in
  :attr:`FaultController.churn_violations`).  The linearizability
  audit harness (``dragonboat_tpu.audit``, docs/AUDIT.md) records
  client histories while this plane runs and checks them offline.

Determinism contract: a plan is executed strictly in schedule order by
one nemesis thread, and :attr:`FaultController.event_log` records each
activation/heal with its plan step index and parameters — NO wall-clock
values — so the same seed and plan produce a byte-identical event log
on every run.  Per-payload decisions (e.g. which messages a 30%% drop
window actually eats) come from per-lane RNGs seeded from
``(seed, kind, source, target, payload_type)``; their sequence is
deterministic per lane even though cross-lane interleaving is
scheduling-dependent.

Seed-replay workflow: every chaos failure prints ``controller.seed``;
re-running with that seed replays the identical fault schedule (see
docs/FAULTS.md).
"""
from __future__ import annotations

import math
import threading
import time
import zlib
from dataclasses import dataclass, field
from random import Random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .logger import get_logger

_log = get_logger("faults")

# operations on_fs_op treats as durability points
_SYNC_OPS = ("sync", "sync_dir", "wal_append")
# operations that mutate file data (torn-write / write-error windows)
_WRITE_OPS = ("write", "create", "truncate", "rename", "unlink", "wal_append")

WIRE_KINDS = (
    "partition",
    "drop",
    "delay",
    "duplicate",
    "reorder",
    "chunk_corrupt",
    # directional kinds: targets are "src->dst" PAIRS (asym_pair), not
    # source addresses — A's sends to B suffer while B's to A flow
    # clean, the one-way partition / one-way delay the symmetric kinds
    # above cannot express (A sees B but B drops A).  Both the in-proc
    # and the TCP transport consume them through the same on_wire hook.
    "asym_drop",
    "asym_delay",
)
ASYM_KINDS = ("asym_drop", "asym_delay")


def asym_pair(src: str, dst: str) -> str:
    """Canonical target form for the directional wire kinds."""
    return f"{src}->{dst}"
FS_KINDS = ("fsync_err", "torn_write", "write_err")
ENGINE_KINDS = ("escalate",)
PROCESS_KINDS = ("crash",)
# balance plane: kill a rebalancing move mid-sequence.  ``balance_abort``
# makes the executor's next fault-point check raise (targets = shard
# ids, empty = every shard); ``balance_stall`` sleeps ``delay`` seconds
# at the fault point, widening the window in which wire/process faults
# can land mid-move.
BALANCE_KINDS = ("balance_abort", "balance_stall")
# churn plane (drummer-style scheduled churn; see install_churn):
# ``leader_kill`` samples the CURRENT leader of a target shard and
# kills its host replica through the harness kill handler (duration =
# downtime before the restart handler fires); ``leader_transfer``
# forces leadership to a deterministically-drawn other voter;
# ``member_cycle`` adds a fresh non-voting member mid-traffic and
# removes it again at heal; ``balance_move`` races one Balancer move
# (balance/) against whatever else the schedule has active.  Targets
# are shard ids (empty = one drawn from the installed churn shards).
# The SCHEDULE stays byte-identical per seed (event_log records only
# the declarative faults); runtime-sampled victims go to ``churn_log``.
CHURN_KINDS = (
    "leader_kill",
    "leader_transfer",
    "member_cycle",
    "balance_move",
)
# snapshot-stream plane (the big-state nemesis; docs/BIGSTATE.md):
# ``snapshot_stream_kill`` raises inside the sender's stream job
# mid-transfer (the streamer thread dies exactly as a torn connection
# would) — the transport's bounded-retry path must RESUME from the
# receiver's cursor, not restart from zero; ``snapshot_stream_stall``
# sleeps ``delay`` per chunk, stretching the transfer so leader churn /
# wire faults can land while a laggard is mid-catch-up.  Targets are
# SENDER transport addresses (wire-kind convention; empty = any sender)
# or ``"dst:<addr>"`` entries scoping by RECEIVER — the witness/dummy
# chaos schedule needs "every stream going TO this replica" regardless
# of which live voter happens to lead (and therefore send) that round.
STREAM_KINDS = ("snapshot_stream_kill", "snapshot_stream_stall")
STREAM_DST_PREFIX = "dst:"
ALL_KINDS = (
    WIRE_KINDS + FS_KINDS + ENGINE_KINDS + PROCESS_KINDS + BALANCE_KINDS
    + CHURN_KINDS + STREAM_KINDS
)


class TornWriteError(OSError):
    """Raised by ``on_fs_op`` inside a torn-write window.  ``keep``
    tells a cooperating FS what fraction of the write to apply before
    failing (StrictMemFS persists that prefix, reproducing a torn
    final write without a full crash)."""

    def __init__(self, keep: float):
        super().__init__("nemesis: injected torn write")
        self.keep = keep


@dataclass(frozen=True)
class Fault:
    """One declarative fault.

    ``at``/``duration`` are seconds from plan start (one-shot faults
    use duration 0; ``crash`` interprets duration as downtime before
    the restart callback fires).  ``targets`` scopes the fault:
    transport addresses for wire kinds (a ``partition``'s targets are
    side A), component keys for fs kinds, shard ids for ``escalate``,
    harness keys for ``crash``; empty = every installed component.
    ``p`` is the per-event probability inside the window.
    """

    kind: str
    at: float = 0.0
    duration: float = 0.0
    targets: Tuple = ()
    p: float = 1.0
    delay: float = 0.05  # kind="delay": seconds each affected send stalls
    both_ways: bool = True  # kind="partition": symmetric vs A->rest only

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(f"unknown fault kind: {self.kind!r}")

    def describe(self) -> str:
        return (
            f"{self.kind}(at={self.at:g},dur={self.duration:g},"
            f"targets={tuple(self.targets)!r},p={self.p:g},"
            f"delay={self.delay:g},both_ways={self.both_ways})"
        )


@dataclass
class FaultPlan:
    """An ordered fault schedule.  ``describe()`` is the canonical
    byte-form used by the determinism tests — two plans are the same
    schedule iff their describe() strings are equal."""

    faults: List[Fault] = field(default_factory=list)

    def describe(self) -> str:
        return "\n".join(f.describe() for f in self.faults)

    @staticmethod
    def randomized(
        seed: int,
        *,
        addrs: Sequence[str],
        fs_keys: Sequence = (),
        crash_keys: Sequence = (),
        shards: Sequence[int] = (),
        churn_shards: Sequence[int] = (),
        stream_addrs: Sequence[str] = (),
        stream_recv_addrs: Sequence[str] = (),
        asym_pairs: Sequence[str] = (),
        balance_shards: Sequence[int] = (),
        rounds: int = 8,
        mean_gap: float = 0.8,
        mean_duration: float = 0.8,
    ) -> "FaultPlan":
        """Generate a randomized-but-deterministic plan: same arguments
        and seed produce the identical plan (the soak entry point's
        replay contract).  ``churn_shards`` adds the churn plane's
        leader kills / transfers / membership cycles to the kind pool
        (the consumer must have called ``install_churn``);
        ``stream_addrs`` adds the snapshot-stream plane (kill/stall the
        streamer of the named sender addresses) — opt-in so existing
        seeded schedules stay byte-identical.  ``stream_recv_addrs``
        widens the stream plane's target pool with RECEIVER-scoped
        entries (``dst:<addr>``): a schedule can then strike every
        stream going TO a witness/dummy or laggard replica no matter
        which voter is the current sender; passing only
        ``stream_addrs`` keeps the drawn plan byte-identical to
        pre-``stream_recv_addrs`` trees (same pool, same draws).
        ``asym_pairs`` (``asym_pair(src, dst)`` strings) adds the
        directional wire kinds to the pool — same opt-in discipline:
        omitting it keeps every pre-existing seeded schedule
        byte-identical.  ``balance_shards`` adds ``balance_move``
        (race ONE planner move against the schedule; the consumer must
        have called ``install_balancer``) with its own shard target
        pool — opt-in like every knob before it."""
        rng = Random(seed)
        addrs = list(addrs)
        stream_pool = list(stream_addrs) + [
            STREAM_DST_PREFIX + a for a in stream_recv_addrs
        ]
        kinds = ["partition", "drop", "delay", "duplicate", "reorder"]
        if fs_keys:
            kinds += ["fsync_err", "torn_write"]
        if crash_keys:
            kinds.append("crash")
        if shards:
            kinds.append("escalate")
        if churn_shards:
            kinds += ["leader_kill", "leader_transfer", "member_cycle"]
        if stream_pool:
            kinds += ["snapshot_stream_kill", "snapshot_stream_stall"]
        if asym_pairs:
            kinds += ["asym_drop", "asym_delay"]
        if balance_shards:
            kinds.append("balance_move")
        t = 0.0
        faults: List[Fault] = []
        for _ in range(rounds):
            t += rng.uniform(0.2, 2 * mean_gap)
            kind = rng.choice(kinds)
            dur = rng.uniform(0.3, 2 * mean_duration)
            if kind == "partition":
                side = tuple(
                    sorted(rng.sample(addrs, rng.choice((1, len(addrs) // 2 or 1))))
                )
                faults.append(Fault(kind, at=t, duration=dur, targets=side))
            elif kind in ("drop", "delay", "duplicate", "reorder"):
                src = tuple(sorted(rng.sample(addrs, rng.randrange(1, len(addrs) + 1))))
                faults.append(
                    Fault(
                        kind,
                        at=t,
                        duration=dur,
                        targets=src,
                        p=round(rng.uniform(0.1, 0.6), 3),
                        delay=round(rng.uniform(0.01, 0.1), 3),
                    )
                )
            elif kind in ("fsync_err", "torn_write"):
                faults.append(
                    Fault(
                        kind,
                        at=t,
                        duration=dur,
                        targets=(rng.choice(list(fs_keys)),),
                        p=round(rng.uniform(0.3, 0.9), 3),
                    )
                )
            elif kind == "crash":
                faults.append(
                    Fault(
                        kind,
                        at=t,
                        duration=max(0.4, dur),
                        targets=(rng.choice(list(crash_keys)),),
                    )
                )
            elif kind in CHURN_KINDS:
                pool = balance_shards if kind == "balance_move" else churn_shards
                faults.append(
                    Fault(
                        kind,
                        at=t,
                        duration=max(0.4, dur) if kind != "leader_transfer" else 0.0,
                        targets=(rng.choice(list(pool)),),
                    )
                )
            elif kind in STREAM_KINDS:
                faults.append(
                    Fault(
                        kind,
                        at=t,
                        duration=dur,
                        targets=(rng.choice(stream_pool),),
                        p=round(rng.uniform(0.05, 0.3), 3),
                        delay=round(rng.uniform(0.01, 0.1), 3),
                    )
                )
            elif kind in ASYM_KINDS:
                faults.append(
                    Fault(
                        kind,
                        at=t,
                        duration=dur,
                        targets=(rng.choice(list(asym_pairs)),),
                        p=round(rng.uniform(0.2, 0.8), 3),
                        delay=round(rng.uniform(0.01, 0.1), 3),
                    )
                )
            else:  # escalate
                faults.append(
                    Fault(
                        kind,
                        at=t,
                        duration=dur,
                        targets=tuple(sorted(rng.sample(list(shards), 1))),
                        p=round(rng.uniform(0.2, 0.8), 3),
                    )
                )
            t += dur
        return FaultPlan(faults)


class _BoundFS:
    """Per-component fs-hook adapter: remembers which component key the
    hook belongs to (the controller scopes fs faults by key)."""

    __slots__ = ("_ctl", "_key")

    def __init__(self, ctl: "FaultController", key):
        self._ctl = ctl
        self._key = key

    def on_fs_op(self, op: str, path: str) -> None:
        self._ctl.on_fs_op(self._key, op, path)


class RecoverySLAViolation(AssertionError):
    """The cluster failed to re-converge within the tick bound after
    the fault plan healed.  When any host in the checked cluster has a
    flight recorder/tracer, ``timeline`` carries the merged cross-host
    timeline captured at violation time (also logged) — the
    post-incident view, taken automatically (obs/, docs/OBSERVABILITY.md)."""

    timeline: str = ""


def _sla_violation(hosts, shard_id: int, msg: str) -> RecoverySLAViolation:
    """Build the violation with the merged flight-recorder/trace
    timeline auto-dumped into it (obs.attach_timeline; a dump failure
    must never mask the violation itself)."""
    exc = RecoverySLAViolation(msg)
    try:
        from .obs import attach_timeline
    except Exception:  # noqa: BLE001 — observability is best-effort
        return exc
    return attach_timeline(
        exc, hosts, shard_id=shard_id,
        label=f"recovery SLA violated for shard {shard_id}", log=_log,
    )


class RecoverySLAAborted(Exception):
    """The SLA check was cut short by ``should_abort`` (teardown) —
    no verdict, neither a pass nor a violation."""


class RecoveryStats:
    """Process-wide recovery aggregator, one bucket per ``fault_class``
    (the label :func:`assert_recovery_sla` stamps on each check).

    Every SLA check that reaches a verdict records its wall recovery
    time and its margin against the tick budget here, so consumers that
    need "recovery per disturbance class" — the scenario orchestrator's
    ``DayReport`` dip table (docs/SCENARIO.md) foremost — read ONE
    source instead of wrapping every recovery in an ad-hoc timer.
    Aborted checks (:class:`RecoverySLAAborted`) record nothing: an
    abort has no verdict.  ``reset()`` starts a fresh measurement epoch
    (the runner calls it at day start); snapshot() is cheap enough for
    per-phase ledger sampling."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Dict[str, List[float]] = {}  # guarded-by: _lock
        self._violations: Dict[str, int] = {}  # guarded-by: _lock
        self._min_margin: Dict[str, float] = {}  # guarded-by: _lock

    def record(
        self, fault_class: str, seconds: float, budget: float, ok: bool
    ) -> None:
        cls = fault_class or "unclassified"
        margin = budget - seconds
        with self._lock:
            self._samples.setdefault(cls, []).append(float(seconds))
            if not ok:
                self._violations[cls] = self._violations.get(cls, 0) + 1
            cur = self._min_margin.get(cls)
            if cur is None or margin < cur:
                self._min_margin[cls] = margin

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._violations.clear()
            self._min_margin.clear()

    def snapshot(self) -> Dict[str, dict]:
        """``{fault_class: {count, worst_s, p99_s, violations,
        min_margin_s}}`` over everything recorded since the last
        reset()."""
        with self._lock:
            samples = {k: list(v) for k, v in self._samples.items()}
            violations = dict(self._violations)
            margins = dict(self._min_margin)
        out: Dict[str, dict] = {}
        for cls, xs in samples.items():
            s = sorted(xs)
            p99_i = max(0, math.ceil(len(s) * 0.99) - 1)
            out[cls] = {
                "count": len(s),
                "worst_s": round(s[-1], 4),
                "p99_s": round(s[p99_i], 4),
                "violations": violations.get(cls, 0),
                "min_margin_s": round(margins.get(cls, 0.0), 4),
            }
        return out


#: the process-wide aggregator every assert_recovery_sla records into
RECOVERY_STATS = RecoveryStats()


def assert_recovery_sla(
    nhs: Dict,
    shard_id: int = 1,
    sla_ticks: int = 5000,
    cmd: Optional[bytes] = None,
    rtt_ms: Optional[int] = None,
    per_try_timeout: float = 1.0,
    should_abort: Optional[Callable[[], bool]] = None,
    fault_class: str = "",
) -> int:
    """Recovery-SLA invariant: after faults heal, the cluster must
    re-establish FULL leader coverage (every NodeHost knows the same
    leader) and — when ``cmd`` is given — resume commit progress, all
    within ``sla_ticks`` logical ticks (converted to wall time via the
    hosts' rtt).  ``per_try_timeout`` must exceed the cluster's commit
    latency (at launch-generation scale a 1s try can never witness its
    own commit — derive it from an observed p99, e.g.
    ``LatencyBudget.per_try_timeout()``).  ``should_abort`` is polled
    between waits/tries (a caller's stop flag — the nemesis thread must
    not sit in a minutes-long SLA wait while teardown joins it); when
    it fires, :class:`RecoverySLAAborted` is raised — an aborted check
    has NO verdict.  ``fault_class`` labels the disturbance being
    recovered from ("leader_kill", "rolling_restart", ...); every
    verdict — pass or violation — lands in :data:`RECOVERY_STATS`
    under that label with its wall recovery time and budget margin.
    Returns the leader id.  Raises :class:`RecoverySLAViolation`
    otherwise."""
    hosts = list(nhs.values())
    if not hosts:
        raise ValueError("no nodehosts")
    if rtt_ms is None:
        rtt_ms = max(nh.config.rtt_millisecond for nh in hosts)
    budget = sla_ticks * rtt_ms / 1000.0
    t_start = time.monotonic()
    deadline = t_start + budget
    leader = None
    while time.monotonic() < deadline:
        if should_abort is not None and should_abort():
            raise RecoverySLAAborted(f"shard {shard_id}: caller stopping")
        seen = set()
        for nh in hosts:
            try:
                lid, ok = nh.get_leader_id(shard_id)
            except Exception:  # noqa: BLE001 — shard mid-restart etc.
                # the whole point of the SLA is that a just-healed
                # cluster may still be re-adding shards: not-found /
                # closed hosts count as "not converged yet", not a crash
                ok = False
            if not ok:
                break
            seen.add(lid)
        else:
            if len(seen) == 1:
                leader = seen.pop()
                break
        time.sleep(0.02)
    if leader is None:
        RECOVERY_STATS.record(
            fault_class, time.monotonic() - t_start, budget, ok=False
        )
        raise _sla_violation(
            hosts, shard_id,
            f"no full leader coverage for shard {shard_id} within "
            f"{sla_ticks} ticks ({budget:.1f}s)",
        )
    if cmd is not None:
        from .client import propose_with_retry

        nh = hosts[0]
        # sliced so should_abort is polled between tries: one slice is
        # a couple of tries, and an in-flight sync_propose blocks at
        # most per_try_timeout — the bound on abort latency
        while True:
            if should_abort is not None and should_abort():
                raise RecoverySLAAborted(f"shard {shard_id}: caller stopping")
            slice_end = min(
                deadline,
                time.monotonic() + max(2.0 * per_try_timeout, 2.0),
            )
            try:
                propose_with_retry(
                    nh,
                    nh.get_noop_session(shard_id),
                    cmd,
                    deadline=slice_end,
                    per_try_timeout=per_try_timeout,
                )
                break
            except Exception as e:  # noqa: BLE001 — retry until the SLA
                # deadline; the verdict at the deadline is the same
                # violation whether the error was transient or terminal
                if time.monotonic() >= deadline:
                    RECOVERY_STATS.record(
                        fault_class, time.monotonic() - t_start, budget,
                        ok=False,
                    )
                    raise _sla_violation(
                        hosts, shard_id,
                        f"no commit progress on shard {shard_id} within "
                        f"{sla_ticks} ticks ({budget:.1f}s): {e!r}",
                    ) from e
    RECOVERY_STATS.record(
        fault_class, time.monotonic() - t_start, budget, ok=True
    )
    return leader


class FaultController:
    """Seeded nemesis: owns the fault plan, the hook plane and the
    deterministic event log.

    Imperative use (most ported chaos tests)::

        ctl = FaultController(seed=7)
        ctl.install_transport(nh.transport)
        f = ctl.activate(Fault("partition", targets=("nh-1",)))
        ... shake ...
        ctl.deactivate(f)            # or ctl.heal_wire() / ctl.heal_all()

    Declarative use (the soak / acceptance scenarios)::

        ctl = FaultController(seed=7, plan=FaultPlan([...]))
        ctl.start(); ctl.wait()
        assert_recovery_sla(nhs, cmd=...)
    """

    def __init__(self, seed: int = 0, plan: Optional[FaultPlan] = None):
        self.seed = seed
        self.plan = plan or FaultPlan()
        self._lock = threading.RLock()
        self._active: List[Fault] = []
        self._lane_rngs: Dict[Tuple, Random] = {}
        # (source, target) -> payload held back by an active reorder
        self._held: Dict[Tuple[str, str], object] = {}
        self.event_log: List[Tuple] = []
        self._seq = 0
        self.stats: Dict[str, int] = {}
        self._crash_fn: Optional[Callable] = None
        self._restart_fn: Optional[Callable] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # -- churn plane (install_churn) --------------------------------
        self._churn_hosts = None  # dict or callable -> {key: NodeHost}
        self._churn_shards: Tuple = ()
        self._churn_balancer = None
        self._churn_kill_fn: Optional[Callable] = None
        self._churn_restart_fn: Optional[Callable] = None
        self._churn_sla_ticks = 0
        self._churn_sla_cmd = None
        self._churn_sla_per_try = 1.0
        self._churn_member_seq = 0
        self._churn_state: Dict[int, Tuple] = {}  # id(fault) -> victim
        # runtime-sampled victims/outcomes (NOT part of the byte-
        # identical event_log contract — leaders are schedule-dependent;
        # churn_log has its OWN counter so notes never perturb the
        # event_log sequence numbers)
        self.churn_log: List[Tuple] = []
        self._churn_seq = 0
        # per-event recovery-SLA misses (re-election bound / commit
        # continuity); tests assert this stays empty
        self.churn_violations: List[str] = []
        self.metrics = None  # set by install_churn (or directly)
        # flight recorders tapped into the fault plane (obs/): every
        # activate/heal and churn action lands in the recorders' rings
        # so a post-incident dump shows WHAT the nemesis did between
        # the cluster's own state transitions
        self._recorders: List = []

    # ------------------------------------------------------------------
    # installation
    # ------------------------------------------------------------------
    def install_transport(self, transport) -> None:
        """Install on a ``Transport`` wrapper (propagates to its raw
        ITransport) or directly on a raw transport."""
        setter = getattr(transport, "set_fault_injector", None)
        if setter is not None:
            setter(self)
        else:
            transport.fault_injector = self

    def install_vfs(self, key, fs) -> None:
        fs.fault_injector = _BoundFS(self, key)

    def install_logdb(self, key, logdb) -> None:
        logdb.fault_injector = _BoundFS(self, key)

    def install_engine(self, engine) -> None:
        engine.fault_injector = self

    def install_nodehost(self, key, nh) -> None:
        """Wire one NodeHost's transport + logdb in one call (plus its
        flight recorder, when NodeHostConfig.enable_flight_recorder is
        on — nemesis actions belong on the same timeline as the state
        transitions they cause)."""
        self.install_transport(nh.transport)
        self.install_logdb(key, nh.logdb)
        rec = getattr(nh, "recorder", None)
        if rec is not None:
            self.install_recorder(rec)

    def install_recorder(self, recorder) -> None:
        """Tap the fault plane into an obs.FlightRecorder: fault
        activations/heals and churn actions are recorded alongside the
        cluster's own state transitions."""
        with self._lock:
            if recorder not in self._recorders:
                self._recorders.append(recorder)

    def install_balancer(self, balancer) -> None:
        """Install on a balance-plane Balancer (its executor consults
        :meth:`on_balance_step` before every move step)."""
        balancer.fault_injector = self

    def set_crash_handlers(
        self, crash_fn: Callable, restart_fn: Callable
    ) -> None:
        """``crash_fn(key)`` / ``restart_fn(key)`` from the harness;
        consumed by ``crash`` faults."""
        self._crash_fn = crash_fn
        self._restart_fn = restart_fn

    def install_churn(
        self,
        hosts,
        *,
        shards: Sequence[int] = (1,),
        balancer=None,
        kill_fn: Optional[Callable] = None,
        restart_fn: Optional[Callable] = None,
        sla_ticks: int = 0,
        sla_cmd=None,
        sla_per_try: float = 1.0,
        metrics=None,
    ) -> None:
        """Arm the churn plane (kinds in :data:`CHURN_KINDS`).

        ``hosts`` is a ``{host_key: NodeHost}`` dict or a zero-arg
        callable returning one (re-read per event — churn kills hosts).
        ``kill_fn(host_key, shard_id)`` / ``restart_fn(host_key,
        shard_id)`` override the kill granularity; by default the
        PROCESS-plane crash handlers are used (whole-host kill).  With
        ``sla_ticks`` > 0 every churn event is followed by a
        per-event recovery-SLA check — full re-election within the tick
        bound plus (when ``sla_cmd`` bytes or a zero-arg callable
        producing them is given) commit continuity — and misses are
        appended to :attr:`churn_violations`.  ``metrics`` (a
        MetricsRegistry) receives ``churn_events_total{kind=...}`` and
        ``churn_sla_violations_total`` counters."""
        self._churn_hosts = hosts
        self._churn_shards = tuple(shards)
        self._churn_balancer = balancer
        self._churn_kill_fn = kill_fn
        self._churn_restart_fn = restart_fn
        self._churn_sla_ticks = sla_ticks
        self._churn_sla_cmd = sla_cmd
        self._churn_sla_per_try = sla_per_try
        if metrics is not None:
            self.metrics = metrics

    # ------------------------------------------------------------------
    # imperative fault control
    # ------------------------------------------------------------------
    def activate(self, fault: Fault) -> Fault:
        with self._lock:
            self._active.append(fault)
            self._record("activate", fault)
        if fault.kind == "crash" and self._crash_fn is not None:
            for t in fault.targets:
                self._crash_fn(t)
        elif fault.kind in CHURN_KINDS:
            self._churn_apply(fault)
        return fault

    def deactivate(self, fault: Fault) -> None:
        with self._lock:
            try:
                self._active.remove(fault)
            except ValueError:
                return
            self._record("heal", fault)
            if fault.kind == "reorder" and not any(
                f.kind == "reorder" for f in self._active
            ):
                # DISCARD held payloads once no reorder window remains
                # (there is no delivery path from here).  Message-batch
                # loss is raft-safe; a held snapshot chunk already
                # failed its send loudly (see the transports' chunk
                # lanes), so nothing waits on these.
                self._held.clear()
        if fault.kind == "crash" and self._restart_fn is not None:
            for t in fault.targets:
                self._restart_fn(t)
        elif fault.kind in CHURN_KINDS:
            self._churn_heal(fault)

    def set_partition(self, side: Sequence[str], both_ways: bool = True) -> Fault:
        """Replace any current partition with a new one (test helper)."""
        with self._lock:
            for f in [f for f in self._active if f.kind == "partition"]:
                self._active.remove(f)
                self._record("heal", f)
        return self.activate(
            # sorted: callers pass sets, and describe() is the canonical
            # byte-form of the schedule — hash-randomized set order would
            # break cross-process event-log comparison
            Fault("partition", targets=tuple(sorted(side)), both_ways=both_ways)
        )

    def heal_wire(self) -> None:
        self._heal_kinds(WIRE_KINDS)

    def heal_all(self) -> None:
        self._heal_kinds(ALL_KINDS)

    def _heal_kinds(self, kinds, restart: bool = True) -> None:
        crashed = []
        churned = []
        with self._lock:
            for f in [f for f in self._active if f.kind in kinds]:
                self._active.remove(f)
                self._record("heal", f)
                if f.kind == "crash":
                    crashed.append(f)
                elif f.kind in CHURN_KINDS:
                    churned.append(f)
            self._held.clear()
        if restart and self._restart_fn is not None:
            for f in crashed:
                for t in f.targets:
                    self._restart_fn(t)
        for f in churned:
            if restart:
                self._churn_heal(f)
            else:
                # teardown path: abandon victim state without restarting
                # onto a cluster being closed (mirrors crash semantics)
                self._churn_state.pop(id(f), None)

    def active_faults(self) -> List[Fault]:
        with self._lock:
            return list(self._active)

    def has_active(self, kind: str) -> bool:
        """Cheap gate for hot paths (the engines check it once per
        launch before paying for per-row hook calls)."""
        with self._lock:
            return any(f.kind == kind for f in self._active)

    def _record(self, action: str, fault: Fault) -> None:
        # plan-step-indexed, wall-clock-free: the determinism contract
        self.event_log.append((self._seq, action, fault.describe()))
        self._seq += 1
        self._rec_fr(self._fault_shard(fault), f"fault:{action}",
                     fault.describe())

    @staticmethod
    def _fault_shard(fault: Fault) -> int:
        """Flight-recorder lane for a fault: churn faults target shard
        ids (record in that shard's ring); wire/fs/process faults
        target host/component keys (global lane 0)."""
        if fault.kind in CHURN_KINDS and fault.targets:
            t = fault.targets[0]
            if isinstance(t, int):
                return t
        return 0

    def _rec_fr(self, shard_id: int, kind: str, detail: str) -> None:
        """Fan a nemesis event out to the tapped flight recorders —
        observability must never break the fault plane."""
        for r in self._recorders:
            try:
                r.record(shard_id, kind, detail)
            except Exception:  # noqa: BLE001
                _log.exception("flight recorder tap raised")

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] = self.stats.get(key, 0) + 1

    def _draw(self, kind: str, source, target, ptype: str = "") -> float:
        """One deterministic per-lane uniform draw.  Lanes are keyed by
        payload type too (a MessageBatch sender thread and a snapshot
        stream-job thread share (source, target) but must not interleave
        draws from one RNG), and the draw happens under the controller
        lock so concurrent lanes can't corrupt each other's sequences."""
        key = (kind, source, target, ptype)
        with self._lock:
            rng = self._lane_rngs.get(key)
            if rng is None:
                seed = zlib.crc32(
                    f"{self.seed}:{kind}:{source}:{target}:{ptype}".encode()
                )
                rng = self._lane_rngs.setdefault(key, Random(seed))
            return rng.random()

    # ------------------------------------------------------------------
    # plan execution (nemesis thread)
    # ------------------------------------------------------------------
    def start(self) -> "FaultController":
        if self._thread is not None:
            raise RuntimeError("nemesis already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run_plan, daemon=True, name="tpu-raft-nemesis"
        )
        self._thread.start()
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def stop(self) -> None:
        """Tear the nemesis down.  Active faults are healed WITHOUT
        firing restart handlers — stop() runs from teardown/finally
        paths where restarting a crashed node (onto a cluster being
        closed) would only add churn, and a restart failure there would
        mask the original test error (review finding).  Use heal_all()
        for a mid-run heal that should restart crashed nodes."""
        self._stop.set()
        if self._thread is not None:
            # bound the join by the nemesis thread's worst-case
            # non-abortable wait: an SLA probe slice (~2 tries), a
            # member_cycle call_with_retry (8s) or a balance-move
            # worker join (10s), plus margin — healing while the
            # nemesis still runs would race _churn_state
            self._thread.join(
                timeout=max(30.0, 2.0 * self._churn_sla_per_try + 10.0)
            )
            if self._thread.is_alive():
                _log.warning(
                    "nemesis thread did not exit before stop() healed; "
                    "teardown may race a stuck churn event"
                )
            self._thread = None
        self._heal_kinds(ALL_KINDS, restart=False)

    def run_phase(
        self, plan: FaultPlan, timeout: Optional[float] = None
    ) -> bool:
        """Execute one declarative plan to completion and return whether
        it finished (False = timeout with the nemesis thread still
        live).  The scenario orchestrator's phase hook: a production-day
        run is a SEQUENCE of plans over ONE controller, so every phase
        shares the seed, the per-lane RNGs and the event log (phase
        boundaries are visible as plan gaps; docs/SCENARIO.md).  Unlike
        :meth:`start`, the controller is reusable immediately after a
        completed phase."""
        if self._thread is not None:
            raise RuntimeError("nemesis already running a plan")
        self.plan = plan
        self.start()
        done = self.wait(timeout)
        if done:
            self._thread = None
        return done

    def _run_plan(self) -> None:
        # timeline = activations + heals merged in schedule order; ties
        # break by plan position so execution order is deterministic
        timeline: List[Tuple[float, int, str, Fault]] = []
        for i, f in enumerate(self.plan.faults):
            timeline.append((f.at, i, "activate", f))
            timeline.append((f.at + max(f.duration, 0.0), i, "heal", f))
        timeline.sort(key=lambda e: (e[0], e[1], e[2] == "heal"))
        t0 = time.monotonic()
        for when, _i, action, f in timeline:
            while not self._stop.is_set():
                lag = when - (time.monotonic() - t0)
                if lag <= 0:
                    break
                time.sleep(min(lag, 0.05))
            if self._stop.is_set():
                return
            if action == "activate":
                self.activate(f)
            else:
                self.deactivate(f)

    # ------------------------------------------------------------------
    # the hook plane
    # ------------------------------------------------------------------
    def on_wire(self, source: str, target: str, payload) -> List:
        """Filter one outbound payload (MessageBatch or Chunk).
        Returns the list of payloads to deliver now — possibly empty
        (drop/partition/held), possibly longer than one (duplicate, or
        a reorder releasing its held message)."""
        # reorder lanes are keyed by payload TYPE too: batches and
        # snapshot chunks share (source, target) but travel different
        # connections — swapping across them would hand a Chunk to the
        # message path (review finding)
        lane = (source, target, payload.__class__.__name__)
        with self._lock:
            active = list(self._active)
            held = self._held.pop(lane, None)
        # a released held payload joins BEFORE the fault loop, so an
        # active partition/drop window applies to it too — appending it
        # afterwards would let a held message cross a live partition
        # (review finding)
        out: List = [payload] if held is None else [payload, held]
        for f in active:
            if not out:
                break
            if f.kind == "partition":
                a = set(f.targets)
                cut = (
                    (source in a) != (target in a)
                    if f.both_ways
                    else (source in a and target not in a)
                )
                if cut:
                    self._count("wire_partitioned")
                    out = []
            elif f.kind in ("asym_drop", "asym_delay"):
                # directional: matched by the (source, target) PAIR —
                # this must precede the generic source filter below,
                # which would mis-read the "src->dst" targets as
                # source addresses and skip every payload
                if f.targets and f"{source}->{target}" not in f.targets:
                    continue
                if f.kind == "asym_drop":
                    if self._draw("asym_drop", source, target, lane[2]) < f.p:
                        self._count("wire_asym_dropped")
                        out = []
                elif self._draw("asym_delay", source, target, lane[2]) < f.p:
                    self._count("wire_asym_delayed")
                    time.sleep(f.delay)
            elif f.targets and source not in f.targets:
                continue
            elif f.kind == "drop":
                if self._draw("drop", source, target, lane[2]) < f.p:
                    self._count("wire_dropped")
                    out = []
            elif f.kind == "delay":
                if self._draw("delay", source, target, lane[2]) < f.p:
                    self._count("wire_delayed")
                    time.sleep(f.delay)
            elif f.kind == "duplicate":
                if self._draw("duplicate", source, target, lane[2]) < f.p:
                    self._count("wire_duplicated")
                    out = out + [out[0]]
            elif f.kind == "reorder":
                if self._draw("reorder", source, target, lane[2]) < f.p:
                    self._count("wire_reordered")
                    with self._lock:
                        # at most one held payload per lane; a second
                        # trigger releases the first (swapped)
                        if lane not in self._held:
                            self._held[lane] = out.pop(0)
            elif f.kind == "chunk_corrupt":
                out = [self._maybe_corrupt(f, source, target, p) for p in out]
        return out

    def _maybe_corrupt(self, f: Fault, source, target, payload):
        data = getattr(payload, "data", None)
        chunk_id = getattr(payload, "chunk_id", None)
        if chunk_id is None or not data:
            return payload  # not a snapshot chunk (or empty/dummy)
        if self._draw("chunk_corrupt", source, target) >= f.p:
            return payload
        import dataclasses

        pos = min(
            int(self._draw("chunk_corrupt_pos", source, target) * len(data)),
            len(data) - 1,
        )
        corrupted = data[:pos] + bytes([data[pos] ^ 0xFF]) + data[pos + 1:]
        self._count("chunks_corrupted")
        return dataclasses.replace(payload, data=corrupted)

    def on_fs_op(self, key, op: str, path: str) -> None:
        """Storage hook: raise to inject an I/O error at this exact
        durability point."""
        with self._lock:
            active = list(self._active)
        for f in active:
            if f.targets and key not in f.targets:
                continue
            if f.kind == "fsync_err" and op in _SYNC_OPS:
                if self._draw("fsync_err", key, op) < f.p:
                    self._count("fs_fsync_errors")
                    raise OSError(f"nemesis: injected fsync error ({op} {path})")
            elif f.kind == "torn_write" and op in ("write", "wal_append"):
                # on a cooperating FS (StrictMemFS) the prefix persists;
                # the WAL append path can't split a frame and treats the
                # TornWriteError as a plain injected I/O failure
                if self._draw("torn_write", key, op) < f.p:
                    self._count("fs_torn_writes")
                    raise TornWriteError(
                        keep=self._draw("torn_write_keep", key, op)
                    )
            elif f.kind == "write_err" and op in _WRITE_OPS:
                if self._draw("write_err", key, op) < f.p:
                    self._count("fs_write_errors")
                    raise OSError(f"nemesis: injected write error ({op} {path})")

    def on_snapshot_stream(self, source: str, target: str, chunk) -> None:
        """Stream-job hook, consulted per outbound snapshot chunk
        (transport.Transport._stream_once).  ``snapshot_stream_kill``
        raises — the streamer dies mid-transfer and the sender's
        bounded-retry path must resume from the receiver's cursor;
        ``snapshot_stream_stall`` sleeps ``delay`` seconds.  Kills only
        strike past chunk 0 so every killed transfer IS mid-transfer
        (a pre-first-chunk kill would test plain retry, not resume) —
        which also means a witness's DUMMY stream (exactly one chunk,
        chunk_id 0) is structurally immune to kills: it either lands
        whole or the ordinary send-failure retry applies.  Targets
        match the SENDER address, or the RECEIVER when written as
        ``dst:<addr>`` (docs/FAULTS.md, witness/dummy chaos)."""
        with self._lock:
            active = list(self._active)
        for f in active:
            if f.kind not in STREAM_KINDS:
                continue
            if (
                f.targets
                and source not in f.targets
                and (STREAM_DST_PREFIX + str(target)) not in f.targets
            ):
                continue
            if f.kind == "snapshot_stream_stall":
                if self._draw("snapshot_stream_stall", source, target) < f.p:
                    self._count("stream_stalled")
                    time.sleep(f.delay)
            elif chunk.chunk_id > 0:
                if self._draw("snapshot_stream_kill", source, target) < f.p:
                    self._count("stream_kills")
                    raise ConnectionError(
                        "nemesis: snapshot streamer killed mid-transfer"
                    )

    def on_balance_step(self, shard_id: int, step: str) -> bool:
        """Balance hook, consulted by the move executor before each step
        of the add -> catchup -> transfer -> remove sequence.  True tells
        the executor to abort the move (it must then roll back); an
        active ``balance_stall`` window sleeps here instead, stretching
        the step so other planes can strike mid-move."""
        with self._lock:
            active = list(self._active)
        for f in active:
            if f.kind not in BALANCE_KINDS:
                continue
            if f.targets and shard_id not in f.targets:
                continue
            if f.kind == "balance_stall":
                if self._draw("balance_stall", shard_id, step) < f.p:
                    self._count("balance_stalled")
                    time.sleep(f.delay)
            elif self._draw("balance_abort", shard_id, step) < f.p:
                self._count("balance_aborted")
                return True
        return False

    def on_engine_step(self, shard_id: int, replica_id: int) -> bool:
        """Engine hook: True forces the kernel-escalation recovery path
        for this row this launch."""
        with self._lock:
            active = list(self._active)
        for f in active:
            if f.kind != "escalate":
                continue
            if f.targets and shard_id not in f.targets:
                continue
            if self._draw("escalate", shard_id, replica_id) < f.p:
                self._count("engine_escalations")
                return True
        return False

    # ------------------------------------------------------------------
    # the churn plane (install_churn)
    # ------------------------------------------------------------------
    # churn_log actions that INITIATE an executed event — skips, errors,
    # unresolved/leak notes and heal halves (restart, member_remove)
    # must not inflate churn_events_total: one scheduled fault is one
    # event, and a run where every event skipped must not look like one
    # that churned
    _CHURN_EXECUTED = frozenset(
        ("kill", "transfer", "member_add", "balance")
    )

    def _churn_note(self, fault: Fault, action: str, detail: str) -> None:
        with self._lock:
            self.churn_log.append(
                (self._churn_seq, fault.kind, action, detail)
            )
            self._churn_seq += 1
        # the victim-resolved action (e.g. WHICH host a leader_kill hit)
        # belongs on the shard's flight-recorder timeline — this is the
        # "injected leader-kill" marker the post-incident dump shows
        # between the last pre-kill apply and the re-election
        self._rec_fr(self._fault_shard(fault),
                     f"churn:{fault.kind}:{action}", detail)
        if self.metrics is not None and action in self._CHURN_EXECUTED:
            self.metrics.counter(
                "churn_events_total", {"kind": fault.kind}
            ).add()

    def _churn_live_hosts(self) -> Dict:
        h = self._churn_hosts
        if h is None:
            return {}
        d = h() if callable(h) else h
        return {
            k: nh for k, nh in d.items() if not getattr(nh, "_closed", False)
        }

    def _churn_pick_shard(self, fault: Fault) -> Optional[int]:
        if fault.targets:
            return fault.targets[0]
        if not self._churn_shards:
            return None
        i = int(
            self._draw("churn_shard", fault.kind, fault.at)
            * len(self._churn_shards)
        ) % len(self._churn_shards)
        return self._churn_shards[i]

    def _find_leader(self, shard_id: int):
        """(host_key, nodehost, leader_replica_id) of the shard's
        current leader, or None while leaderless/mid-restart."""
        hosts = self._churn_live_hosts()
        lid = 0
        for nh in hosts.values():
            try:
                l, ok = nh.get_leader_id(shard_id)
            except Exception:  # noqa: BLE001 — host may not hold the shard
                continue
            if ok and l:
                lid = l
                break
        if not lid:
            return None
        for key, nh in hosts.items():
            node = nh._nodes.get(shard_id)
            if node is not None and node.replica_id == lid:
                return key, nh, lid
        return None

    def _churn_apply(self, fault: Fault) -> None:
        if self._churn_hosts is None:
            self._churn_note(fault, "skip", "churn plane not installed")
            return
        try:
            if fault.kind == "leader_kill":
                self._churn_leader_kill(fault)
            elif fault.kind == "leader_transfer":
                self._churn_leader_transfer(fault)
            elif fault.kind == "member_cycle":
                self._churn_member_add(fault)
            elif fault.kind == "balance_move":
                self._churn_balance_move(fault)
        except Exception as e:  # noqa: BLE001 — the schedule must go on
            _log.warning("churn %s failed: %r", fault.kind, e)
            self._churn_note(fault, "error", repr(e))

    def _churn_heal(self, fault: Fault) -> None:
        try:
            if fault.kind == "leader_kill":
                v = self._churn_state.pop(id(fault), None)
                if v is not None:
                    shard_id, key = v
                    fn = self._churn_restart_fn
                    if fn is not None:
                        fn(key, shard_id)
                    elif self._restart_fn is not None:
                        self._restart_fn(key)
                    self._churn_note(
                        fault, "restart", f"shard={shard_id} host={key}"
                    )
                    self._churn_sla(shard_id, fault.kind)
            elif fault.kind == "member_cycle":
                v = self._churn_state.pop(id(fault), None)
                if v is not None:
                    self._churn_member_remove(fault, *v)
            elif fault.kind == "balance_move":
                t = self._churn_state.pop(id(fault), None)
                if t is not None:
                    t.join(timeout=10.0)
        except Exception as e:  # noqa: BLE001
            _log.warning("churn heal %s failed: %r", fault.kind, e)
            self._churn_note(fault, "error", repr(e))

    def _churn_leader_kill(self, fault: Fault) -> None:
        shard_id = self._churn_pick_shard(fault)
        found = shard_id and self._find_leader(shard_id)
        if not found:
            self._churn_note(
                fault, "skip", f"no leader found (shard={shard_id})"
            )
            return
        key, _nh, lid = found
        self._churn_state[id(fault)] = (shard_id, key)
        fn = self._churn_kill_fn
        if fn is not None:
            fn(key, shard_id)
        elif self._crash_fn is not None:
            self._crash_fn(key)
        else:
            self._churn_state.pop(id(fault), None)
            self._churn_note(fault, "skip", "no kill handler installed")
            return
        self._count("churn_leader_kills")
        self._churn_note(
            fault, "kill", f"shard={shard_id} host={key} leader={lid}"
        )

    def _churn_leader_transfer(self, fault: Fault) -> None:
        shard_id = self._churn_pick_shard(fault)
        found = shard_id and self._find_leader(shard_id)
        if not found:
            self._churn_note(
                fault, "skip", f"no leader found (shard={shard_id})"
            )
            return
        key, nh, lid = found
        node = nh._nodes.get(shard_id)
        if node is None:
            self._churn_note(fault, "skip", "leader node vanished")
            return
        voters = sorted(
            r for r in node.get_membership().addresses if r != lid
        )
        if not voters:
            self._churn_note(fault, "skip", "no transfer candidate")
            return
        target = voters[
            int(self._draw("churn_transfer", shard_id, lid) * len(voters))
            % len(voters)
        ]
        nh.request_leader_transfer(shard_id, target)
        self._count("churn_leader_transfers")
        self._churn_note(
            fault, "transfer", f"shard={shard_id} {lid} -> {target}"
        )
        self._churn_sla(shard_id, fault.kind)

    def _churn_member_add(self, fault: Fault) -> None:
        shard_id = self._churn_pick_shard(fault)
        hosts = self._churn_live_hosts()
        if not shard_id or not hosts:
            self._churn_note(fault, "skip", "no shard/hosts")
            return
        keys = sorted(hosts, key=str)
        addr_key = keys[
            int(self._draw("churn_member", shard_id, fault.at) * len(keys))
            % len(keys)
        ]
        addr = hosts[addr_key].raft_address()
        api = self._churn_api_host(shard_id)
        if api is None:
            self._churn_note(fault, "skip", "no live host holds the shard")
            return
        with self._lock:
            self._churn_member_seq += 1
            rid = 70_000 + self._churn_member_seq
        # the throwaway rid must clear EVERY id the shard has ever seen:
        # other planes allocate max(known ids)+1 (the balance executor's
        # next_replica_id walks voters+non-votings+witnesses+removed), so
        # a fixed 70_000+seq can COLLIDE with a move-created voter once a
        # churned id lands in `removed` — the add then rejects and the
        # heal would remove a REAL member (found by the production-day
        # soak: cycle-1 member_cycle deleted the voter cycle-0's drain
        # had just placed, docs/SCENARIO.md)
        try:
            m = api.get_shard_membership(shard_id)
            known = [
                *m.addresses, *m.non_votings, *m.witnesses, *m.removed,
            ]
            rid = max(rid, max(known, default=0) + 1)
        except Exception:  # noqa: BLE001 — membership mid-change; the
            # remove-side guard still protects real members
            pass
        from .client import call_with_retry

        # record the victim BEFORE the RPC: an add whose ack times out
        # may still have committed, and the heal must try the remove
        # either way (removing a never-committed member just rejects,
        # which the remove path counts as member_leak noise — better
        # than a phantom non-voting member replicated-to forever).  The
        # ADDRESS rides along so the heal can recognize a non-voting
        # that is NOT ours (a concurrent plane winning the same rid)
        self._churn_state[id(fault)] = (shard_id, rid, addr)
        # the new member is never started: a transiently-unreachable
        # NON-VOTING add (quorum untouched) the heal removes again —
        # the membership entries themselves are the churn
        try:
            call_with_retry(
                lambda: api.sync_request_add_non_voting(
                    shard_id, rid, addr, timeout=1.0
                ),
                timeout=8.0,
            )
        except Exception as e:  # noqa: BLE001 — maybe-committed add
            self._count("churn_member_add_unresolved")
            self._churn_note(
                fault, "member_add_unresolved",
                f"shard={shard_id} rid={rid}: {e!r}",
            )
            return
        self._count("churn_member_adds")
        self._churn_note(
            fault, "member_add", f"shard={shard_id} rid={rid} addr={addr}"
        )

    def _churn_member_remove(
        self, fault: Fault, shard_id: int, rid: int,
        addr: Optional[str] = None,
    ) -> None:
        api = self._churn_api_host(shard_id)
        if api is None:
            self._count("churn_member_failures")
            self._churn_note(
                fault, "member_leak", f"shard={shard_id} rid={rid}"
            )
            return
        # the heal may only remove the NON-VOTING member this cycle
        # added: if the rid now resolves to a voter or witness — or to
        # a non-voting at a DIFFERENT address — some other plane owns
        # it (an id collision, e.g. a concurrent balance move's
        # catch-up replica winning the same max(known)+1 draw) and
        # removing it would damage the real membership; leak loudly
        # instead
        try:
            m = api.get_shard_membership(shard_id)
            stolen = (
                rid in m.addresses
                or rid in m.witnesses
                or (
                    addr is not None
                    and m.non_votings.get(rid, addr) != addr
                )
            )
            if stolen:
                self._count("churn_member_failures")
                self._churn_note(
                    fault, "member_remove_skipped",
                    f"shard={shard_id} rid={rid} is another plane's "
                    "member (id collision), not removing",
                )
                return
        except Exception:  # noqa: BLE001 — membership mid-change; the
            # remove below still rejects ids that vanished
            pass
        from .client import call_with_retry

        try:
            call_with_retry(
                lambda: api.sync_request_delete_replica(
                    shard_id, rid, timeout=1.0
                ),
                timeout=8.0,
            )
            self._count("churn_member_removes")
            self._churn_note(
                fault, "member_remove", f"shard={shard_id} rid={rid}"
            )
        except Exception as e:  # noqa: BLE001 — a leftover non-voting
            # member is harmless to quorum; count it loudly instead of
            # failing the schedule
            self._count("churn_member_failures")
            self._churn_note(
                fault, "member_leak", f"shard={shard_id} rid={rid}: {e!r}"
            )
        self._churn_sla(shard_id, fault.kind)

    def _churn_api_host(self, shard_id: int):
        """A live host holding the shard (prefer the leader's)."""
        found = self._find_leader(shard_id)
        if found:
            return found[1]
        for nh in self._churn_live_hosts().values():
            if nh._nodes.get(shard_id) is not None:
                return nh
        return None

    def _churn_balance_move(self, fault: Fault) -> None:
        b = self._churn_balancer
        if b is None:
            self._churn_note(fault, "skip", "no balancer installed")
            return

        def run():
            try:
                report = b.rebalance_once(max_moves=1)
                self._count("churn_balance_moves")
                self._churn_note(fault, "balance", repr(report))
            except Exception as e:  # noqa: BLE001 — nemesis may abort it
                self._churn_note(fault, "balance_abort", repr(e))

        t = threading.Thread(
            target=run, daemon=True, name="tpu-raft-churn-balance"
        )
        self._churn_state[id(fault)] = t
        t.start()

    def _churn_sla(self, shard_id: int, fault_class: str = "") -> None:
        """Per-event recovery-SLA assert: full re-election within the
        tick bound + commit continuity (when a probe cmd is armed).
        Runs on the nemesis thread — the next scheduled fault fires
        after the cluster has either recovered or violated.  The churn
        kind rides along as the SLA's ``fault_class``, so every churn
        recovery lands in :data:`RECOVERY_STATS` under its own label."""
        if not self._churn_sla_ticks:
            return
        hosts = {
            k: nh
            for k, nh in self._churn_live_hosts().items()
            if nh._nodes.get(shard_id) is not None
        }
        if not hosts:
            self.churn_violations.append(
                f"shard {shard_id}: no live replica after churn event"
            )
            return
        cmd = self._churn_sla_cmd
        if callable(cmd):
            cmd = cmd()
        try:
            assert_recovery_sla(
                hosts, shard_id, sla_ticks=self._churn_sla_ticks, cmd=cmd,
                per_try_timeout=self._churn_sla_per_try,
                should_abort=self._stop.is_set,
                fault_class=fault_class,
            )
            self._count("churn_sla_ok")
        except RecoverySLAAborted:
            # teardown raced the check: no verdict, and the nemesis
            # thread exits promptly instead of outliving stop()'s join
            self._count("churn_sla_aborted")
        except RecoverySLAViolation as e:
            self._count("churn_sla_violations")
            if self.metrics is not None:
                self.metrics.counter("churn_sla_violations_total").add()
            self.churn_violations.append(f"shard {shard_id}: {e}")
