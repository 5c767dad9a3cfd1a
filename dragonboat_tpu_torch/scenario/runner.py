"""The production-day orchestrator: execute a :class:`~.plan.DayPlan`
over a :class:`~.fleet.DayFleet` under live gateway traffic.

The runner is the monitoring loop of the drummer heritage: it fires
each phase's nemesis sub-plan and maneuver, wraps EVERY recovery in
``assert_recovery_sla`` (labelled with the phase's fault class, so the
per-class dip/recovery table reads straight out of
:data:`dragonboat_tpu.faults.RECOVERY_STATS`), keeps open-loop session
traffic flowing through the Gateway the whole time, records the entire
client-observed history — both shards, one recorder — for the offline
Wing–Gong audit, and emits a :class:`~.report.DayReport` ledger.  A
failed SLA ABORTS the day: remaining phases are skipped and the merged
flight-recorder timeline is captured into the report (the post-incident
artifact a failed production day must leave behind).

DR boundary discipline: writes to the exported shard are FENCED (the
traffic plane parks its writers and drains in-flight ops) before the
export is cut, exactly like a production runbook would — an ack issued
after the export point would be silently rolled back by the import,
which is real data loss, not an audit artifact.  Reads keep flowing
through the outage (they fail cleanly) and the post-import reads join
the SAME history, so the checker's verdict spans the boundary.
"""
from __future__ import annotations

import os
import threading
import time
from random import Random
from typing import Dict, List, Optional

from .. import settings
from ..audit import (
    AuditReport,
    audit_set_cmd,
    check_bounded_reads,
    check_linearizable,
    check_sessions,
    check_stale_reads,
    settle_journals,
)
from ..audit.history import HistoryRecorder
from ..faults import (
    RECOVERY_STATS,
    Fault,
    FaultPlan,
    RecoverySLAViolation,
    STREAM_DST_PREFIX,
    assert_recovery_sla,
)
from ..gateway import GatewayBusy
from ..logger import get_logger
from ..obs import FleetScope, record_all
from ..readplane import Consistency
from .fleet import CORE, LAGGARD, SPARE, WITNESS, DayFleet
from .plan import SH_DISK, SH_MEM, DayPlan, Phase
from .report import DayReport

_log = get_logger("scenario")


class _Traffic:
    """Open-loop gateway traffic with full history recording.

    Per shard: writer threads (exactly-once handles on the audited
    in-memory shard, an at-most-once handle on the big-state shard) and
    one never-pausing reader thread — reads must straddle every outage
    so the history witnesses the failure AND the recovery."""

    def __init__(self, fleet: DayFleet, rec: HistoryRecorder,
                 pace: float = 0.012):
        self.fleet = fleet
        self.rec = rec
        self.pace = pace
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._paused: Dict[int, threading.Event] = {
            SH_MEM: threading.Event(), SH_DISK: threading.Event(),
        }
        self._parked: List[tuple] = []  # (shard, Event)
        self._handles: List = []

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        gw = self.fleet.gateway
        for i in range(2):
            h = gw.connect(SH_MEM, timeout=10.0)
            self._handles.append(h)
            self._spawn(SH_MEM, f"mem-w{i}", self._writer_mem, h)
        self._handles.append(gw.noop_handle(SH_DISK))
        self._spawn(SH_DISK, "disk-w0", self._writer_disk,
                    self._handles[-1])
        for shard, name in ((SH_MEM, "mem-r"), (SH_DISK, "disk-r")):
            t = threading.Thread(
                target=self._reader, args=(shard,),
                daemon=True, name=f"tpu-day-{name}",
            )
            self._threads.append(t)
            t.start()

    def _spawn(self, shard: int, name: str, fn, handle) -> None:
        parked = threading.Event()
        self._parked.append((shard, parked))
        t = threading.Thread(
            target=fn, args=(handle, self.rec.new_client(), parked),
            daemon=True, name=f"tpu-day-{name}",
        )
        self._threads.append(t)
        t.start()

    def pause_writers(self, shard: int, timeout: float = 15.0) -> bool:
        """Fence writes to one shard: park its writers and wait until
        every in-flight op has settled (the DR export precondition)."""
        self._paused[shard].set()
        deadline = time.monotonic() + timeout
        ok = True
        for s, parked in self._parked:
            if s != shard:
                continue
            ok = parked.wait(max(0.0, deadline - time.monotonic())) and ok
        return ok

    def resume_writers(self, shard: int) -> None:
        for s, parked in self._parked:
            if s == shard:
                parked.clear()
        self._paused[shard].clear()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=15.0)
        for h in self._handles:
            try:
                h.close(timeout=1.0)
            except Exception:  # noqa: BLE001 — gateway may be closed
                pass

    # -- drivers --------------------------------------------------------
    def _park_if_paused(self, shard: int, parked: threading.Event) -> bool:
        if not self._paused[shard].is_set():
            # a writer that raced resume_writers (observed the pause,
            # was preempted, then set its marker after the resume
            # cleared it) clears the stale marker HERE, before starting
            # another op — so a set parked flag always means the writer
            # is really parked and the next DR fence cannot pass with
            # an op in flight (review finding)
            if parked.is_set():
                parked.clear()
            return False
        parked.set()
        time.sleep(0.02)
        return True

    def _writer_mem(self, handle, cid: int, parked) -> None:
        rng = Random(7_000 + cid)
        seq = 0
        while not self._stop.is_set():
            if self._park_if_paused(SH_MEM, parked):
                continue
            seq += 1
            key = f"m:k{rng.randrange(24)}"
            val = f"{cid}:{seq}"
            op = self.rec.invoke(cid, "w", key, val)
            try:
                handle.sync_propose(audit_set_cmd(key, val), timeout=2.5)
                self.rec.ok(op)
            except GatewayBusy:
                self.rec.fail(op)  # shed at the door: definitely not in
            except Exception:  # noqa: BLE001 — timeout/terminated/closed
                self.rec.ambiguous(op)
            time.sleep(self.pace)

    def _writer_disk(self, handle, cid: int, parked) -> None:
        from ..bigstate.ondisk import put_cmd

        rng = Random(8_000 + cid)
        seq = 0
        while not self._stop.is_set():
            if self._park_if_paused(SH_DISK, parked):
                continue
            seq += 1
            key = f"d:k{rng.randrange(8)}"
            val = f"{cid}:{seq}"
            op = self.rec.invoke(cid, "w", key, val)
            try:
                handle.sync_propose(
                    put_cmd(key.encode(), val.encode()), timeout=2.5
                )
                self.rec.ok(op)
            except GatewayBusy:
                self.rec.fail(op)
            except Exception:  # noqa: BLE001 — at-most-once: maybe in
                self.rec.ambiguous(op)
            time.sleep(2 * self.pace)

    def _reader(self, shard: int) -> None:
        rng = Random(9_000 + shard)
        cid = self.rec.new_client()
        gw = self.fleet.gateway
        while not self._stop.is_set():
            if shard == SH_MEM:
                key = f"m:k{rng.randrange(24)}"
                query = key
            else:
                key = f"d:k{rng.randrange(8)}"
                query = key.encode()
            op = self.rec.invoke(cid, "r", key)
            try:
                v = gw.read(shard, query, timeout=2.0)
                if isinstance(v, bytes):
                    v = v.decode()
                self.rec.ok(op, output=v)
            except Exception:  # noqa: BLE001 — outage reads fail clean
                self.rec.fail(op)
            time.sleep(2 * self.pace)


class _SlotObs:
    """Fleet-scope target for one in-proc day slot, resolved at POLL
    time: a rolling restart replaces ``fleet.hosts[addr]`` with a new
    NodeHost, and the scope's epoch check reads the new incarnation's
    rings from their start without re-registration."""

    def __init__(self, fleet: DayFleet, addr: str):
        self._fleet = fleet
        self._addr = addr
        self.host = addr

    def _nh(self):
        return self._fleet.hosts.get(self._addr)

    def raft_address(self) -> str:
        return self._addr

    @property
    def metrics(self):
        return getattr(self._nh(), "metrics", None)

    @property
    def recorder(self):
        return getattr(self._nh(), "recorder", None)

    @property
    def tracer(self):
        return getattr(self._nh(), "tracer", None)

    @property
    def nodehost_id(self):
        return getattr(self._nh(), "nodehost_id", "")

    @property
    def uptime_s(self):
        return getattr(self._nh(), "uptime_s", None)


class _GatewayObs:
    """The day's gateway as a fleet-scope target (its own registry
    carries the request histogram + shed counters the SLO catalog
    selects)."""

    def __init__(self, fleet: DayFleet):
        self._fleet = fleet
        self.host = "gateway"
        self.recorder = None
        self.tracer = None

    @property
    def metrics(self):
        return getattr(self._fleet.gateway, "metrics", None)


class ScenarioRunner:
    """Execute one :class:`DayPlan`; see module docstring."""

    def __init__(
        self,
        plan: DayPlan,
        *,
        tag: str = "day",
        workdir: str = "/tmp",
        sla_ticks: int = 15_000,
        traffic_pace: float = 0.012,
        colocated: bool = False,
    ):
        self.plan = plan
        self.fleet = DayFleet(
            plan.seed, tag=tag, workdir=workdir, colocated=colocated
        )
        self.sla_ticks = sla_ticks
        self.traffic_pace = traffic_pace
        self.rec = HistoryRecorder()
        self.report = DayReport(
            seed=plan.seed, gear=plan.gear, plan=plan.describe(),
            classes_planned=list(plan.classes_planned()),
        )
        self._dr_epoch = 0
        self._probe_cid: Optional[int] = None
        # the day's telemetry plane: polled at phase boundaries, its
        # burn-rate rows land on report.slo (docs/OBSERVABILITY.md)
        self.scope: Optional[FleetScope] = None

    # ------------------------------------------------------------------
    def run(self) -> DayReport:
        saved = (
            settings.Soft.snapshot_chunk_size,
            settings.Soft.snapshot_stream_max_tries,
        )
        # small chunks + a wide retry budget: kill windows must leave
        # room to RESUME, not exhaust the stream job (docs/BIGSTATE.md)
        settings.Soft.snapshot_chunk_size = 128 * 1024
        settings.Soft.snapshot_stream_max_tries = 10
        RECOVERY_STATS.reset()
        t_day = time.monotonic()
        traffic = None
        try:
            self.fleet.build()
            self.scope = FleetScope()
            for addr in list(self.fleet.hosts):
                self.scope.add_process(addr, _SlotObs(self.fleet, addr))
            self.scope.add_process("gateway", _GatewayObs(self.fleet))
            self.scope.poll()  # baseline window: warmup deltas start here
            self._probe_cid = self.rec.new_client()
            traffic = _Traffic(self.fleet, self.rec, pace=self.traffic_pace)
            traffic.start()
            self._traffic = traffic
            for phase in self.plan.phases:
                # ANY phase failure aborts the day through the same
                # path: an SLA miss and an unexpected maneuver error
                # (wedged wait_for_leader, membership race) must both
                # leave the ledger + timeline artifact a failed
                # production day owes its operator (review finding —
                # a bare traceback with no report is not a verdict)
                try:
                    self._run_phase(phase)
                except RecoverySLAViolation as e:
                    self.report.aborted = phase.name
                    self.report.violations.append(
                        f"{phase.name}: {e}"
                    )
                    self.report.timeline = (
                        getattr(e, "timeline", "")
                        or self.fleet.dump_timeline()
                    )
                    _log.error(
                        "day ABORTED in phase %s: %s", phase.name, e
                    )
                    break
                except Exception as e:  # noqa: BLE001 — see above
                    self.report.aborted = phase.name
                    self.report.violations.append(
                        f"{phase.name}: unexpected {type(e).__name__}: {e}"
                    )
                    self.report.timeline = self.fleet.dump_timeline()
                    _log.exception(
                        "day ABORTED in phase %s (unexpected)", phase.name
                    )
                    break
            traffic.stop()
            traffic = None
            nemesis = self.fleet.nemesis
            if nemesis is not None:
                self.report.violations.extend(nemesis.churn_violations)
            self.report.colocated = self.fleet.colo_stats()
            if self.report.colocated:
                # the colocated member's own invariants, phrased as day
                # verdicts: the launch pipeline must actually STEP on
                # the device path (a day that silently fell back to the
                # host engine proves nothing), and scheduled churn must
                # never trip a divergence fail-stop (I5).  With one
                # colocated slot its two replicas are the only group
                # members, so rows-stepped — not intra-group routing —
                # is the device-path evidence.
                if not self.report.colocated.get("device_rows_stepped", 0):
                    self.report.violations.append(
                        "colocated member never stepped on the device "
                        f"path: {self.report.colocated}"
                    )
                if self.report.colocated.get("divergence_halts", 0):
                    self.report.violations.append(
                        "colocated member divergence fail-stop under "
                        f"scheduled churn: {self.report.colocated}"
                    )
            if not self.report.aborted:
                self._final_audit()
        finally:
            if traffic is not None:
                traffic.stop()
            self.fleet.close()
            (
                settings.Soft.snapshot_chunk_size,
                settings.Soft.snapshot_stream_max_tries,
            ) = saved
        self.report.recovery = RECOVERY_STATS.snapshot()
        self.report.wall_s = time.monotonic() - t_day
        self._dip_table()
        if self.scope is not None:
            self.report.slo = self.scope.slo_report()
        return self.report

    # ------------------------------------------------------------------
    # phase machinery
    # ------------------------------------------------------------------
    def _sample(self) -> Dict[str, float]:
        gw = self.fleet.gateway.stats()
        streams = self.fleet.stream_totals()
        nstats = dict(self.fleet.nemesis.stats)
        return {
            "committed": gw["committed"],
            "shed": gw["shed"],
            "lease": gw["lease_reads"],
            "fallback": gw["read_fallbacks"],
            "p99_s": gw["p99_s"],
            "stream_resumes": streams["stream_resumes"],
            "stream_kills": nstats.get("stream_kills", 0),
            "stream_stalls": nstats.get("stream_stalled", 0),
            "churn": sum(
                nstats.get(k, 0)
                for k in (
                    "churn_leader_kills", "churn_leader_transfers",
                    "churn_member_adds", "churn_balance_moves",
                )
            ),
        }

    def _run_phase(self, phase: Phase) -> None:
        record_all(
            self.fleet.live_hosts(), 0, "day:phase", phase.name
        )
        if self.scope is not None:
            self.scope.mark("phase", phase.name)
        t0 = time.monotonic()
        s0 = self._sample()
        extras: Dict[str, object] = {}
        if phase.faults:
            # a churn fault activated while the target shard is mid-
            # election SKIPS (no leader to strike); phases fire from a
            # settled cluster so every scheduled disturbance lands
            for shard in sorted({
                t for f in phase.faults for t in f.targets
                if isinstance(t, int)
            }):
                self.fleet.wait_for_leader(shard)
            done = self.fleet.nemesis.run_phase(
                FaultPlan(list(phase.faults)),
                timeout=max(60.0, 4 * phase.duration + 60.0),
            )
            if not done:
                raise RecoverySLAViolation(
                    f"nemesis sub-plan of {phase.name} did not complete"
                )
        if phase.action:
            extras = self._do_action(phase)
        floor = t0 + phase.duration
        while time.monotonic() < floor:
            time.sleep(0.05)
        s1 = self._sample()
        wall = max(1e-6, time.monotonic() - t0)
        lease_d = max(0, s1["lease"] - s0["lease"])
        fall_d = max(0, s1["fallback"] - s0["fallback"])
        ledger = {
            "name": phase.name,
            "fault_class": phase.fault_class,
            "wall_s": round(wall, 3),
            "committed": max(0, s1["committed"] - s0["committed"]),
            "committed_per_s": round(
                max(0, s1["committed"] - s0["committed"]) / wall, 2
            ),
            "shed_per_s": round(
                max(0, s1["shed"] - s0["shed"]) / wall, 2
            ),
            "p99_s": round(s1["p99_s"], 4),
            "lease_share": round(
                lease_d / (lease_d + fall_d), 4
            ) if (lease_d + fall_d) else 0.0,
            "stream_resumes": max(
                0, s1["stream_resumes"] - s0["stream_resumes"]
            ),
            "stream_kills": max(
                0, s1["stream_kills"] - s0["stream_kills"]
            ),
        }
        ledger.update(extras)
        if phase.faults and "events" not in extras:
            # faults-only phases (leader churn): executed churn events,
            # straight off the nemesis counters — a schedule whose every
            # event SKIPPED must not read as a day that churned
            ledger["events"] = max(0, s1["churn"] - s0["churn"])
        self.report.phases.append(ledger)
        if phase.name == "warmup":
            self.report.baseline_committed_per_s = ledger["committed_per_s"]
        if phase.fault_class:
            fired = ledger.get("events", 1)
            self.report.disturbances_fired[phase.fault_class] = (
                self.report.disturbances_fired.get(phase.fault_class, 0)
                + int(fired)
            )
        record_all(
            self.fleet.live_hosts(), 0, "day:phase-end", phase.name
        )
        if self.scope is not None:
            # one poll window per phase: the SLO evaluator's burn rows
            # attribute straight to phase boundaries
            self.scope.poll()

    def _do_action(self, phase: Phase) -> Dict[str, object]:
        a = phase.action
        if a == "rolling_restart":
            return self._rolling_restart(phase)
        if a == "catchup_chaos":
            return self._catchup_chaos(phase)
        if a == "drain":
            return self._drain(phase)
        if a == "dr_cycle":
            return self._dr_cycle(phase)
        if a == "read_hot":
            return self._read_hot(phase)
        if a == "write_hot":
            return self._write_hot(phase)
        if a == "diurnal":
            return self._diurnal(phase)
        if a == "elastic":
            return self._elastic(phase)
        raise ValueError(f"unknown phase action {a!r}")

    def _sla(self, shard: int, fault_class: str) -> None:
        assert_recovery_sla(
            self.fleet.hosts_holding(shard),
            shard,
            sla_ticks=self.sla_ticks,
            cmd=self.fleet.sla_probe(shard),
            per_try_timeout=2.0,
            fault_class=fault_class,
        )

    # -- maneuvers ------------------------------------------------------
    def _rolling_restart(self, phase: Phase) -> Dict[str, object]:
        n = int(phase.param("hosts", len(CORE)))
        grace = float(phase.param("grace", 0.5))
        restarted = 0
        for slot in CORE[:n]:
            addr = self.fleet.addrs[slot]
            held = sorted(self.fleet._assign.get(addr, {}))
            self.fleet.kill(addr)
            time.sleep(grace)
            self.fleet.restart(addr)
            restarted += 1
            for shard in held:
                self._sla(shard, "rolling_restart")
        return {"events": restarted}

    def _catchup_chaos(self, phase: Phase) -> Dict[str, object]:
        payload_mb = int(phase.param("payload_mb", 2))
        cap = int(phase.param("cap_mb", 4)) * 1024 * 1024
        kill_p = float(phase.param("kill_p", 0.4))
        stall_p = float(phase.param("stall_p", 0.3))
        stall_delay = float(phase.param("stall_delay", 0.01))
        fleet, ctl = self.fleet, self.fleet.nemesis
        lag_addr = fleet.addrs[LAGGARD]
        wit_addr = fleet.addrs[WITNESS]
        fleet.kill(lag_addr)
        fleet.kill(wit_addr)
        # the laggard misses a payload the leader then compacts away:
        # its catch-up MUST be a snapshot stream, the witness's a dummy
        chunk = b"\xa5" * (512 * 1024)
        n_cmds = payload_mb * 2
        last_key = b"_big%d" % (n_cmds - 1)
        from ..bigstate.ondisk import put_cmd
        from ..client import propose_with_retry

        nh = fleet.wait_for_leader(SH_DISK)
        deadline = time.monotonic() + max(60.0, payload_mb * 2.0)
        for i in range(n_cmds):
            propose_with_retry(
                nh, nh.get_noop_session(SH_DISK),
                put_cmd(b"_big%d" % i, chunk),
                deadline=deadline, per_try_timeout=3.0,
            )
        for a, h in fleet.hosts_holding(SH_DISK).items():
            try:
                h.sync_request_snapshot(SH_DISK, compaction_overhead=1)
            except Exception:  # noqa: BLE001 — follower may decline
                pass
            h.set_snapshot_send_rate(cap)
        targets = (
            STREAM_DST_PREFIX + lag_addr, STREAM_DST_PREFIX + wit_addr,
        )
        kill = Fault("snapshot_stream_kill", targets=targets, p=kill_p)
        stall = Fault(
            "snapshot_stream_stall", targets=targets, p=stall_p,
            delay=stall_delay,
        )
        ctl.activate(kill)
        ctl.activate(stall)
        kills0 = ctl.stats.get("stream_kills", 0)
        try:
            fleet.restart(lag_addr)
            fleet.restart(wit_addr)
            lag = fleet.hosts[lag_addr]
            end = time.monotonic() + 90.0
            caught = False
            while time.monotonic() < end:
                if ctl.stats.get("stream_kills", 0) > kills0:
                    # one mid-transfer kill witnessed: heal the kill
                    # window so the RESUME (not endless retries) is
                    # what completes the transfer
                    ctl.deactivate(kill)
                try:
                    if lag.stale_read(SH_DISK, last_key) == chunk:
                        caught = True
                        break
                except Exception:  # noqa: BLE001 — replica mid-restore
                    pass
                time.sleep(0.05)
        finally:
            ctl.deactivate(kill)
            ctl.deactivate(stall)
            # the chaos-tier cap must not leak into later phases'
            # catch-ups (rolling restarts, balance moves) and skew
            # their ledger rows; 0 retires the cap entirely (the fleet
            # runs uncapped by default; drain sets its own before
            # moving and retires it after)
            for h in fleet.hosts_holding(SH_DISK).values():
                h.set_snapshot_send_rate(0)
        if not caught:
            raise RecoverySLAViolation(
                "big-state laggard never caught up under stream chaos: "
                f"stats={ctl.stats}"
            )
        self._sla(SH_DISK, "stream_chaos")
        return {
            "events": 1,
            "payload_mb": payload_mb,
            "kills": ctl.stats.get("stream_kills", 0) - kills0,
        }

    def _drain(self, phase: Phase) -> Dict[str, object]:
        fleet = self.fleet
        slot = str(phase.param("host", "h3"))
        addr = fleet.addrs[slot]
        to_slot = str(phase.param("to", SPARE))
        to_addr = fleet.addrs[to_slot]
        # the receiving region may itself have been drained by an
        # earlier cycle (the full gear alternates h3<->h6): re-join it
        # so the planner has somewhere to land the moves
        if to_addr in fleet.live_hosts():
            fleet.balancer.join(to_addr, fleet.hosts[to_addr])
        for h in fleet.hosts_holding(SH_DISK).values():
            h.set_snapshot_send_rate(8 * 1024 * 1024)
        try:
            rep = fleet.balancer.drain(
                addr, timeout=float(phase.param("timeout", 90.0))
            )
        except Exception as e:  # noqa: BLE001 — a drain that cannot
            # converge is a failed recovery, and the day must abort
            # through the same path as an SLA miss
            raise RecoverySLAViolation(f"region drain failed: {e!r}") from e
        fleet.refresh_assignments()
        for shard in (SH_MEM, SH_DISK):
            self._sla(shard, "drain")
        # retire the drain-tier cap so later phases' catch-ups run
        # uncapped again (same cross-phase leak as the chaos tier's)
        for h in fleet.hosts_holding(SH_DISK).values():
            h.set_snapshot_send_rate(0)
        catchup = {}
        last = fleet.balancer.last_move_report
        if isinstance(last, dict):
            catchup = dict(last.get("catchup") or {})
        return {
            "events": max(1, int(rep.get("executed", 0))),
            "drain_passes": rep.get("passes", 0),
            "drain_catchup": catchup,
        }

    def _dr_cycle(self, phase: Phase) -> Dict[str, object]:
        fleet = self.fleet
        shard = int(phase.param("shard", SH_MEM))
        self._dr_epoch += 1
        epoch = self._dr_epoch
        outdir = os.path.join(
            fleet.workdir, f"{fleet.tag}-dr-{epoch}"
        )
        cid = self._probe_cid
        # boundary reads BEFORE the export: the checker's verdict must
        # span the DR boundary inside one history
        pre_keys = ["m:k0", "m:k1"]
        for key in pre_keys:
            op = self.rec.invoke(cid, "r", key)
            try:
                self.rec.ok(
                    op, output=fleet.gateway.read(shard, key, timeout=3.0)
                )
            except Exception:  # noqa: BLE001
                self.rec.fail(op)
        # fence writes; an ack issued after the export point would be
        # rolled back by the import (module docstring)
        if not self._traffic.pause_writers(shard):
            raise RecoverySLAViolation(
                "DR write fence did not drain: an in-flight op could "
                "ack after the export point (lost-ack risk); aborting"
            )
        try:
            leader = fleet.wait_for_leader(shard)
            manifest = leader.export_snapshot(shard, outdir)
            holders = fleet.hosts_holding(shard)
            for nh in holders.values():
                nh.stop_shard(shard)
            slot_order = {s: i for i, s in enumerate(
                CORE + (WITNESS, LAGGARD, SPARE))}
            addrs = sorted(
                holders, key=lambda a: slot_order[fleet.slots[a]]
            )
            members = {
                10 * epoch + i + 1: a for i, a in enumerate(addrs)
            }
            for rid, a in members.items():
                nh = fleet.hosts[a]
                ss = nh.import_snapshot(outdir, shard, rid, members)
                if not ss.imported or ss.index != manifest.index:
                    raise RecoverySLAViolation(
                        f"DR import mismatch on {a}: {ss}"
                    )
                nh.start_replica(
                    members, False, fleet.sm_factory,
                    fleet.config_factory(shard, rid),
                )
            fleet.set_member_map(shard, members)
            self._sla(shard, "dr_cycle")
        finally:
            self._traffic.resume_writers(shard)
        # boundary reads AFTER the import, same history, same client
        for key in pre_keys:
            op = self.rec.invoke(cid, "r", key)
            try:
                self.rec.ok(
                    op, output=fleet.gateway.read(shard, key, timeout=5.0)
                )
            except Exception:  # noqa: BLE001
                self.rec.fail(op)
        return {"events": 1, "dr_index": manifest.index}

    def _read_hot(self, phase: Phase) -> Dict[str, object]:
        """The zipfian read storm (ROADMAP 5c, traffic shape): hot-key
        skewed readers hammer one shard through the gateway's read
        plane, split across FOLLOWER_LINEARIZABLE / BOUNDED_STALENESS /
        LINEARIZABLE (docs/READPLANE.md).  Follower reads join the
        Wing-Gong history as plain "r" ops — the offline audit, not
        this method, is the safety argument; bounded reads carry their
        stamp in ``op.value`` for check_bounded_reads.  The ledger row
        carries the observed read-path split; a storm that never
        reached a replica-served path is a failed phase, not a quiet
        row."""
        import bisect

        fleet = self.fleet
        gw = fleet.gateway
        shard = int(phase.param("shard", SH_MEM))
        n_keys = int(phase.param("keys", 24))
        skew = float(phase.param("skew", 1.2))
        readers = int(phase.param("readers", 3))
        bound = int(phase.param("bound_ticks", 100))
        burst = max(0.8, float(phase.duration))
        fleet.wait_for_leader(shard)
        # zipf CDF over key ranks: m:k0 is the hot key (same key space
        # the writers churn, so the storm joins a contended history)
        w = [1.0 / (r ** skew) for r in range(1, n_keys + 1)]
        tot = sum(w)
        cdf: List[float] = []
        acc = 0.0
        for x in w:
            acc += x / tot
            cdf.append(acc)
        rp0 = dict(gw.stats()["read_paths"])
        stop_at = time.monotonic() + burst
        hot_hits = [0] * readers

        def storm(idx: int) -> None:
            rng = Random(12_000 + idx)
            cid = self.rec.new_client()
            while time.monotonic() < stop_at:
                key = f"m:k{bisect.bisect_left(cdf, rng.random())}"
                if key == "m:k0":
                    hot_hits[idx] += 1
                roll = rng.random()
                if roll < 0.3:
                    op = self.rec.invoke(cid, "bounded", key)
                    try:
                        res = gw.read_at(
                            shard, key,
                            consistency=Consistency.BOUNDED_STALENESS,
                            timeout=2.0, bound_ticks=bound,
                        )
                        op.value = (
                            res.applied_index, res.staleness_ticks, bound
                        )
                        v = res.value
                        if isinstance(v, bytes):
                            v = v.decode()
                        self.rec.ok(op, output=v)
                    except Exception:  # noqa: BLE001 — shed/outage
                        self.rec.fail(op)
                    continue
                level = (
                    Consistency.FOLLOWER_LINEARIZABLE
                    if roll < 0.8 else Consistency.LINEARIZABLE
                )
                op = self.rec.invoke(cid, "r", key)
                try:
                    res = gw.read_at(
                        shard, key, consistency=level, timeout=2.0
                    )
                    v = res.value
                    if isinstance(v, bytes):
                        v = v.decode()
                    self.rec.ok(op, output=v)
                except Exception:  # noqa: BLE001 — reads fail clean
                    self.rec.fail(op)

        threads = [
            threading.Thread(
                target=storm, args=(i,), daemon=True,
                name=f"tpu-day-readhot-{i}",
            )
            for i in range(readers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=burst + 30.0)
        rp1 = gw.stats()["read_paths"]
        split = {
            k: max(0, rp1.get(k, 0) - rp0.get(k, 0)) for k in rp1
        }
        served = sum(
            split.get(p, 0)
            for p in ("lease", "read_index", "follower", "bounded")
        )
        if not (split.get("follower") and split.get("bounded")):
            raise RecoverySLAViolation(
                "read-hot storm never reached the replica read paths: "
                f"split={split}"
            )
        return {
            "events": 1,
            "reads": served,
            "read_paths": split,
            "hot_key_reads": sum(hot_hits),
        }

    @staticmethod
    def _zipf_cdf(n_keys: int, skew: float) -> List[float]:
        w = [1.0 / (r ** skew) for r in range(1, n_keys + 1)]
        tot = sum(w)
        cdf: List[float] = []
        acc = 0.0
        for x in w:
            acc += x / tot
            cdf.append(acc)
        return cdf

    def _storm_writers(self, shard: int, n: int, cdf: List[float],
                       stop_at, *, seed_base: int = 13_000,
                       pace_fn=None) -> Dict[str, int]:
        """Run ``n`` zipfian writer threads against the audited shard
        until ``stop_at`` (a float deadline or a callable returning
        True to stop).  Each writer owns an exactly-once gateway handle
        and records every op in the Wing–Gong history (ok / shed-fail /
        ambiguous, the _Traffic discipline).  ``pace_fn(t)`` returns
        the inter-write sleep at elapsed day-phase time ``t`` (None:
        unpaced — the storm shape)."""
        import bisect

        gw = self.fleet.gateway
        done = (stop_at if callable(stop_at)
                else (lambda: time.monotonic() >= stop_at))
        hot_hits = [0] * n
        wrote = [0] * n
        shed = [0] * n
        t0 = time.monotonic()

        def storm(idx: int) -> None:
            rng = Random(13_000 + idx if seed_base == 13_000
                         else seed_base + idx)
            cid = self.rec.new_client()
            try:
                h = gw.connect(shard, timeout=10.0)
            except Exception:  # noqa: BLE001 — storm starts mid-outage
                return
            seq = 0
            try:
                while not done():
                    r = bisect.bisect_left(cdf, rng.random())
                    key = f"m:k{r}"
                    if r == 0:
                        hot_hits[idx] += 1
                    seq += 1
                    val = f"{cid}:{seq}"
                    op = self.rec.invoke(cid, "w", key, val)
                    try:
                        h.sync_propose(audit_set_cmd(key, val), timeout=2.5)
                        self.rec.ok(op)
                        wrote[idx] += 1
                    except GatewayBusy:
                        self.rec.fail(op)  # shed at the door: not in
                        shed[idx] += 1
                    except Exception:  # noqa: BLE001 — maybe committed
                        self.rec.ambiguous(op)
                    if pace_fn is not None:
                        time.sleep(pace_fn(time.monotonic() - t0))
            finally:
                try:
                    h.close(timeout=1.0)
                except Exception:  # noqa: BLE001 — gateway closing
                    pass

        threads = [
            threading.Thread(
                target=storm, args=(i,), daemon=True,
                name=f"tpu-day-writehot-{i}",
            )
            for i in range(n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        return {
            "writes": sum(wrote),
            "hot_key_writes": sum(hot_hits),
            "write_shed": sum(shed),
        }

    def _write_hot(self, phase: Phase) -> Dict[str, object]:
        """The write half of the zipfian storm (ROADMAP 5c, traffic
        shape): hot-key skewed writers hammer the audited shard's
        exactly-once path.  Every write joins the Wing–Gong history —
        the skew is adversarial precisely because dedupe + per-session
        ordering must hold while one key's apply order is contended."""
        fleet = self.fleet
        shard = int(phase.param("shard", SH_MEM))
        n_keys = int(phase.param("keys", 24))
        skew = float(phase.param("skew", 1.2))
        writers = int(phase.param("writers", 3))
        burst = max(0.8, float(phase.duration))
        fleet.wait_for_leader(shard)
        cdf = self._zipf_cdf(n_keys, skew)
        out = self._storm_writers(
            shard, writers, cdf, time.monotonic() + burst
        )
        if not out["writes"]:
            raise RecoverySLAViolation(
                f"write-hot storm landed zero commits: {out}"
            )
        return {"events": 1, **out}

    def _diurnal(self, phase: Phase) -> Dict[str, object]:
        """Sinusoidal offered-load swing (diurnal in miniature): writer
        pacing modulates by ``1 + amp*sin(2*pi*t/period)`` and the
        ledger row records the observed peak/trough committed rates —
        the serving plane must ride the swing without shedding at the
        trough's budget (no hard swing assert: the 1-core container
        flattens small swings; the row is the evidence)."""
        import math

        fleet = self.fleet
        gw = fleet.gateway
        shard = int(phase.param("shard", SH_MEM))
        writers = int(phase.param("writers", 3))
        period = max(0.2, float(phase.param("period", 1.0)))
        amp = min(0.95, max(0.0, float(phase.param("amp", 0.6))))
        burst = max(0.8, float(phase.duration))
        fleet.wait_for_leader(shard)
        base = 2 * self.traffic_pace

        def pace(t: float) -> float:
            # offered load ~ (1 + amp*sin): the gap is its reciprocal
            return base / max(0.05, 1.0 + amp * math.sin(
                2.0 * math.pi * t / period))

        cdf = self._zipf_cdf(int(phase.param("keys", 24)), 0.0)
        stop_at = time.monotonic() + burst
        rates: List[float] = []

        def sampler() -> None:
            dt = max(0.05, period / 8.0)
            prev = gw.stats()["committed"]
            while time.monotonic() < stop_at:
                time.sleep(dt)
                cur = gw.stats()["committed"]
                rates.append(max(0, cur - prev) / dt)
                prev = cur

        st = threading.Thread(target=sampler, daemon=True,
                              name="tpu-day-diurnal-sampler")
        st.start()
        out = self._storm_writers(
            shard, writers, cdf, stop_at, seed_base=14_000, pace_fn=pace
        )
        st.join(timeout=30.0)
        if not out["writes"]:
            raise RecoverySLAViolation(
                f"diurnal swing landed zero commits: {out}"
            )
        peak = round(max(rates), 2) if rates else 0.0
        trough = round(min(rates), 2) if rates else 0.0
        return {
            "events": 1,
            "writes": out["writes"],
            "peak_committed_per_s": peak,
            "trough_committed_per_s": trough,
            "swing": round(peak / trough, 2) if trough > 0 else 0.0,
        }

    def _elastic(self, phase: Phase) -> Dict[str, object]:
        """The elastic disturbance class (docs/BALANCE.md "Load-reactive
        rebalancing"): close the measurement->placement loop under a
        hostile write storm and PROVE the move shed the heat.

        Sequence: (1) quiet pre-check — with the phase's policy armed,
        run ``quiet_passes`` feedback passes under baseline traffic and
        require ZERO load-driven moves (the hysteresis guarantee, in
        the ledger as ``quiet_moves``); (2) manufacture genuine heat —
        transfer the big-state shard's leadership onto the audited
        shard's leader host, so both commit paths contend for that
        host's single engine worker; (3) zipfian write storm against
        the audited shard while the main loop samples the gateway's
        per-shard p99 and runs ``load_rebalance_once`` — the balancer
        must fire >=1 move; (4) keep the storm up through a tail so
        the post-move latency picture is measured UNDER the same
        offered load, and require the hot shard's p99 to drop below
        the storm peak; (5) recovery SLA around the whole maneuver,
        same as every other class."""
        from ..balance import LoadPolicy

        fleet = self.fleet
        gw = fleet.gateway
        bal = fleet.balancer
        shard = int(phase.param("shard", SH_MEM))
        n_keys = int(phase.param("keys", 24))
        skew = float(phase.param("skew", 1.4))
        writers = int(phase.param("writers", 4))
        hot_p99_ms = int(phase.param("hot_p99_ms", 60))
        hot_submit_floor = int(phase.param("hot_submit", 20))
        min_samples = int(phase.param("min_samples", 12))
        hysteresis = int(phase.param("hysteresis", 2))
        cooldown = int(phase.param("cooldown", 8))
        quiet_passes = int(phase.param("quiet_passes", 4))
        storm_s = max(1.0, float(phase.param("storm_s", 2.5)))
        pass_sleep = 0.12  # one cadence for quiet AND storm passes:
        # the submit trigger is a per-pass delta, so comparable windows
        # are what make the quiet/storm separation meaningful
        fleet.wait_for_leader(shard)
        fleet.wait_for_leader(SH_DISK)
        # thresholds are runtime-adaptive (like victim sampling, OUT of
        # describe()): the plan pins only the floors.  Submit-rate is
        # the PRIMARY trigger — offered load is what "load-reactive"
        # reacts to, and it separates storm from quiet far more
        # sharply than the absolute tail on a loaded 1-core box;
        # p99 stays as the secondary trigger with a 3x-baseline guard.
        base_row = gw.shard_load().get(shard) or {}
        base_p99 = float(base_row.get("p99_s", 0.0) or 0.0)
        sub0 = int(base_row.get("submitted", 0))
        time.sleep(0.6)
        sub1 = int((gw.shard_load().get(shard) or {}).get("submitted", 0))
        quiet_rate = max(0.0, (sub1 - sub0) / 0.6)
        hot_p99_s = max(hot_p99_ms / 1000.0, 3.0 * base_p99)
        hot_submit = max(
            hot_submit_floor, int(3.0 * quiet_rate * pass_sleep) + 1
        )
        bal.set_load_policy(LoadPolicy(
            hot_p99_s=hot_p99_s,
            hot_shed=8,
            hot_submit=hot_submit,
            min_samples=min_samples,
            hysteresis=hysteresis,
            cooldown=cooldown,
            max_moves=1,
        ))
        # (1) quiet pre-check: baseline traffic must fire ZERO moves
        quiet_moves = 0
        for _ in range(max(hysteresis + 1, quiet_passes)):
            rep = bal.load_rebalance_once()
            quiet_moves += rep["executed"] + rep["failed"]
            time.sleep(pass_sleep)
        if quiet_moves:
            raise RecoverySLAViolation(
                "elastic: quiet window fired load-driven moves "
                f"(hysteresis broken): {bal.last_load_report}"
            )
        # (2) colocate the two leaders: find the audited shard's leader
        # host and transfer the big-state shard's leadership onto it
        leader_nh = fleet.wait_for_leader(shard)
        hot_host = next(
            (a for a, h in fleet.hosts.items() if h is leader_nh), ""
        )
        colocated = False
        if hot_host:
            disk_ent = fleet._assign.get(hot_host, {}).get(SH_DISK)
            disk_rid = disk_ent[0] if disk_ent else None
            if disk_rid:
                disk_leader = fleet.wait_for_leader(SH_DISK)
                try:
                    disk_leader.request_leader_transfer(SH_DISK, disk_rid)
                    end = time.monotonic() + 5.0
                    while time.monotonic() < end:
                        if fleet.wait_for_leader(SH_DISK) is fleet.hosts[
                                hot_host]:
                            colocated = True
                            break
                        time.sleep(0.05)
                except Exception:  # noqa: BLE001 — the storm still
                    # heats the shard without the colocation boost
                    pass
        # (3) the storm + the feedback loop.  Alongside the zipfian
        # mem-shard storm, two disk-shard writers hammer the COLOCATED
        # big-state leader — the cross-shard engine contention is what
        # the move must escape.  Disk ops join the recorded history
        # (same d:k* key space as the baseline disk writer).
        from ..bigstate.ondisk import put_cmd

        state = {"stop": False}
        out_box: Dict[str, Dict[str, int]] = {}

        def run_storm() -> None:
            out_box["w"] = self._storm_writers(
                shard, writers, self._zipf_cdf(n_keys, skew),
                lambda: state["stop"], seed_base=15_000,
            )

        def disk_heat(idx: int) -> None:
            rng = Random(16_000 + idx)
            cid = self.rec.new_client()
            try:
                h = gw.connect(SH_DISK, timeout=10.0)
            except Exception:  # noqa: BLE001 — storm mid-outage
                return
            seq = 0
            try:
                while not state["stop"]:
                    key = f"d:k{rng.randrange(8)}"
                    seq += 1
                    val = f"{cid}:{seq}"
                    op = self.rec.invoke(cid, "w", key, val)
                    try:
                        h.sync_propose(
                            put_cmd(key.encode(), val.encode()),
                            timeout=2.5,
                        )
                        self.rec.ok(op)
                    except GatewayBusy:
                        self.rec.fail(op)
                    except Exception:  # noqa: BLE001 — maybe committed
                        self.rec.ambiguous(op)
            finally:
                try:
                    h.close(timeout=1.0)
                except Exception:  # noqa: BLE001 — gateway closing
                    pass

        storm_t = threading.Thread(target=run_storm, daemon=True,
                                   name="tpu-day-elastic-storm")
        heat_ts = [
            threading.Thread(target=disk_heat, args=(i,), daemon=True,
                             name=f"tpu-day-elastic-heat-{i}")
            for i in range(2)
        ]
        shed0 = int((gw.shard_load().get(shard) or {}).get("shed", 0))
        storm_t.start()
        for t in heat_ts:
            t.start()
        p99_peak = 0.0
        p99_after = 0.0
        executed = failed = 0
        moves: List[str] = []
        hard_cap = time.monotonic() + storm_s + 8.0
        try:
            # pre-move: sample heat + run the loop until a move fires
            while time.monotonic() < hard_cap:
                row = gw.shard_load().get(shard) or {}
                p99_peak = max(p99_peak, float(row.get("p99_s", 0.0)))
                rep = bal.load_rebalance_once()
                executed += rep["executed"]
                failed += rep["failed"]
                moves.extend(rep["moves"])
                if executed:
                    break
                time.sleep(pass_sleep)
            if not executed:
                raise RecoverySLAViolation(
                    "elastic: storm fired no load-driven move "
                    f"(p99_peak={p99_peak:.4f}s p99_thr={hot_p99_s:.4f}s "
                    f"submit_thr={hot_submit}/pass "
                    f"last={bal.last_load_report})"
                )
            # (4) post-move tail: same storm, fresh window — wait for
            # the per-shard budget to flush into the post-move picture
            tail_end = time.monotonic() + max(1.2, 0.6 * storm_s)
            tail_cap = time.monotonic() + max(4.0, storm_s)
            while time.monotonic() < tail_end:
                time.sleep(0.1)
            row = gw.shard_load().get(shard) or {}
            p99_after = float(row.get("p99_s", 0.0))
            while p99_after >= p99_peak and time.monotonic() < tail_cap:
                time.sleep(0.15)
                row = gw.shard_load().get(shard) or {}
                p99_after = float(row.get("p99_s", 0.0))
        finally:
            state["stop"] = True
            storm_t.join(timeout=60.0)
            for t in heat_ts:
                t.join(timeout=30.0)
        shed1 = int((gw.shard_load().get(shard) or {}).get("shed", 0))
        # (5) the same recovery gate every class gets
        self._sla(shard, "elastic")
        if p99_after >= p99_peak:
            raise RecoverySLAViolation(
                "elastic: move did not shed the hot shard's p99 "
                f"(storm peak {p99_peak:.4f}s -> after {p99_after:.4f}s, "
                f"moves={moves})"
            )
        return {
            "events": executed,
            "moves": moves,
            "moves_failed": failed,
            "colocated_leaders": colocated,
            "quiet_moves": quiet_moves,
            "p99_storm_s": round(p99_peak, 4),
            "p99_after_s": round(p99_after, 4),
            "shed_delta": max(0, shed1 - shed0),
            "writes": out_box.get("w", {}).get("writes", 0),
        }

    # ------------------------------------------------------------------
    # verdicts
    # ------------------------------------------------------------------
    def _final_audit(self) -> None:
        fleet = self.fleet
        ops = self.rec.ops()
        mem_ops = self.rec.ops_for("m:")
        sessions = None
        try:
            journals = settle_journals(
                fleet.hosts_holding(SH_MEM), SH_MEM, timeout=30.0
            )
            sessions = check_sessions(mem_ops, journals)
        except Exception as e:  # noqa: BLE001 — divergent journals ARE
            # an audit failure, not an infrastructure error
            self.report.violations.append(f"journal settle: {e!r}")
        rep = AuditReport(
            linearizability=check_linearizable(ops),
            stale=check_stale_reads(ops),
            sessions=sessions,
            bounded=check_bounded_reads(ops),
        )
        counts = self.rec.counts()
        self.report.audit = {
            "ok": bool(rep.ok) and not self.report.violations,
            "ops": counts,
            "keys_checked": rep.linearizability.keys_checked,
            "detail": "" if rep.ok else rep.describe(),
        }
        if not rep.ok:
            self.report.timeline = (
                self.report.timeline or fleet.dump_timeline()
            )

    def _dip_table(self) -> None:
        base = self.report.baseline_committed_per_s
        if base <= 0:
            return
        for p in self.report.phases:
            cls = p.get("fault_class")
            if not cls:
                continue
            dip = p["committed_per_s"] / base
            cur = self.report.fault_dips.get(cls)
            self.report.fault_dips[cls] = (
                dip if cur is None else min(cur, dip)
            )
