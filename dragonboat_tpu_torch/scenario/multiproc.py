"""Multi-process fleet harness: separate OS processes, TCP + gossip +
RPC only, zero shared memory (docs/SCENARIO.md "Multi-process gear").

:class:`ProcFleet` spawns ``scenario/procworker.py`` children, fronts
them with the ordinary :class:`~dragonboat_tpu.gateway.Gateway` over
:class:`~dragonboat_tpu.gateway.rpc.RemoteHostHandle` clients, joins
their gossip mesh as an observer and runs a
:class:`~dragonboat_tpu.gateway.rpc.RouteFeeder` so leader routing
converges with no in-proc tap.  The nemesis is REAL: ``kill()`` is
``SIGKILL`` on the worker's process, and the asymmetric wire faults
go over the RPC fault op to the victim's own FaultController.

Two entry points ride it:

* :func:`run_rpc_smoke` — the ~5s CI gate (scripts/rpc_smoke.sh): a
  2-process fleet commits over the wire, the leader's process is
  SIGKILLed mid-service, a restart over the same dirs recovers within
  ``assert_recovery_sla``, and post-recovery commits + reroutes pass.
* :func:`run_mini_multiproc_day` — the 3-process mini production day
  (``DRAGONBOAT_MULTIPROC=1`` tier-1 gear): open-loop audited traffic
  through the gateway, a real leader SIGKILL + restart, an asymmetric
  one-way drop injected and healed, routing reconvergence, and the
  Wing–Gong client-history audit over everything that happened.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

from ..audit.checker import check_linearizable, check_stale_reads
from ..audit.history import HistoryRecorder
from ..audit.model import audit_set_cmd
from ..faults import assert_recovery_sla, asym_pair
from ..gateway import Gateway, GatewayBusy, GatewayConfig
from ..gateway.rpc import RemoteHostHandle, RouteFeeder
from ..logger import get_logger
from ..obs import FleetScope, Tracer
from ..transport.gossip import GossipManager

_log = get_logger("scenario")

SHARD = 1


class _GatewayObs:
    """The PARENT process as a fleet-scope target: the gateway's own
    metrics registry plus the client tracer whose rpc:propose roots the
    cross-process stitches.  No flight recorder in the parent."""

    def __init__(self, gateway: Gateway, tracer: Optional[Tracer]):
        self.metrics = gateway.metrics
        self.tracer = tracer
        self.recorder = None
        self.host = "gateway"


class ProcFleet:
    """N procworker children + the client-side planes over them."""

    def __init__(self, n: int = 3, *, workdir: str = "/tmp/mpday",
                 base_port: int = 29650, fresh: bool = True,
                 shards: int = 1, rpc_inflight: int = 64):
        self.n = n
        self.workdir = workdir
        self.base_port = base_port
        self.shards = shards
        self.rpc_inflight = rpc_inflight
        self.procs: Dict[int, subprocess.Popen] = {}
        self.handles: Dict[str, RemoteHostHandle] = {}
        self.ready: Dict[int, dict] = {}
        self.gossip: Optional[GossipManager] = None
        self.gateway: Optional[Gateway] = None
        self.feeder: Optional[RouteFeeder] = None
        # fleet-scope telemetry: the client-side tracer rides every
        # handle (trace context on request frames) and the scope polls
        # every worker + the parent itself
        self.tracer: Optional[Tracer] = None
        self.scope: Optional[FleetScope] = None
        if fresh:
            shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir, exist_ok=True)

    # -- worker lifecycle -------------------------------------------------
    def _spawn(self, idx: int) -> subprocess.Popen:
        # the child resolves the package by PYTHONPATH, not the parent's
        # cwd — drives launched from a scratch dir must still spawn
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["DRAGONBOAT_PROC_SHARDS"] = str(self.shards)
        env["DRAGONBOAT_PROC_RPC_INFLIGHT"] = str(self.rpc_inflight)
        return subprocess.Popen(
            [sys.executable, "-m", "dragonboat_tpu_torch.scenario.procworker",
             str(idx), str(self.n), self.workdir, str(self.base_port)],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT,
            env=env,
        )

    def _wait_ready(self, idx: int, timeout: float = 90.0) -> dict:
        path = f"{self.workdir}/ready-{idx}.json"
        deadline = time.time() + timeout
        while True:
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        info = json.load(f)
                    if info.get("pid") == self.procs[idx].pid:
                        return info
                except (OSError, json.JSONDecodeError, KeyError):
                    pass
            if self.procs[idx].poll() is not None:
                raise RuntimeError(f"worker {idx} died during startup")
            if time.time() > deadline:
                raise TimeoutError(f"worker {idx} never became ready")
            time.sleep(0.1)

    def start(self) -> None:
        for idx in range(1, self.n + 1):
            self.procs[idx] = self._spawn(idx)
        for idx in range(1, self.n + 1):
            self.ready[idx] = self._wait_ready(idx)
        self.tracer = Tracer(host="gateway", sample_rate=1.0)
        for idx in range(1, self.n + 1):
            # keyed by the child's NodeHostID: with address_by_nodehost_id
            # the membership addresses (and hence the collector's
            # leader_host / the routing cache keys) ARE the nhids, and a
            # restart over the same dirs keeps the id — so the handle
            # registration survives kills
            self.handles[self._key(idx)] = RemoteHostHandle(
                self.ready[idx]["rpc"], rtt_millisecond=20,
                tracer=self.tracer,
            )
        # observer membership in the children's gossip mesh: liveness
        # for the RouteFeeder comes from DIRECT contact, exactly what a
        # cross-process balance plane would consume
        self.gossip = GossipManager(
            nodehost_id=f"observer-{os.getpid()}",
            raft_address="observer",
            bind_address="127.0.0.1:0",
            seeds=[self.ready[i]["gossip"] for i in range(1, self.n + 1)],
            interval=0.1,
        )
        self.gossip.start()
        self.gateway = Gateway(
            dict(self.handles),
            GatewayConfig(workers=2, default_timeout=5.0,
                          cap_feedback=False),
        )
        self.feeder = RouteFeeder(self.gateway, self.gossip, interval=0.25)
        self.feeder.start()
        # the telemetry plane: one collector over every worker (polled
        # via RPC_OP_OBS) AND the parent gateway process (polled
        # in-proc) — the merged timeline crosses the process boundary
        self.scope = FleetScope()
        for idx in range(1, self.n + 1):
            self.scope.add_process(self._key(idx),
                                   self.handles[self._key(idx)])
        self.scope.add_process("gateway",
                               _GatewayObs(self.gateway, self.tracer))

    def _key(self, idx: int) -> str:
        return self.ready[idx]["nhid"]

    def raft_addr(self, idx: int) -> str:
        return self.ready[idx]["raft"]

    def handle(self, idx: int) -> RemoteHostHandle:
        return self.handles[self._key(idx)]

    def live_slots(self):
        return [i for i in range(1, self.n + 1)
                if self.procs[i].poll() is None]

    # -- nemesis ----------------------------------------------------------
    def kill(self, idx: int) -> None:
        """A true crash: SIGKILL the worker's OS process.  The handle
        stays registered — its breaker darkens it, and the fixed RPC
        port lets it reconnect after restart()."""
        p = self.procs[idx]
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=10)

    def restart(self, idx: int) -> None:
        """Respawn over the SAME dirs: WAL replay + gossip rejoin +
        raft catch-up, observed purely over the wire."""
        try:
            os.remove(f"{self.workdir}/ready-{idx}.json")
        except OSError:
            pass
        self.procs[idx] = self._spawn(idx)
        self.ready[idx] = self._wait_ready(idx)

    def leader_slot(self, timeout: float = 30.0) -> int:
        """The slot whose replica currently leads SHARD, asked over the
        wire (replica ids == slot numbers)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            for idx in self.live_slots():
                try:
                    lid, ok = self.handle(idx).get_leader_id(SHARD)
                except Exception:  # noqa: BLE001 — dark/restarting host
                    continue
                if ok and lid in self.procs:
                    return lid
            time.sleep(0.1)
        raise TimeoutError("no leader observed over RPC")

    def set_asym_drop(self, src: int, dst: int, p: float = 1.0) -> None:
        """One-way partition: src's sends to dst drop, dst->src flows.
        Installed on the SOURCE worker's FaultController (on_wire runs
        sender-side), driven over the RPC fault op."""
        self.handle(src).send_fault("activate", fault={
            "kind": "asym_drop",
            "targets": [asym_pair(self.raft_addr(src), self.raft_addr(dst))],
            "p": p,
        })

    def set_asym_delay(self, src: int, dst: int, delay: float,
                       p: float = 1.0) -> None:
        self.handle(src).send_fault("activate", fault={
            "kind": "asym_delay",
            "targets": [asym_pair(self.raft_addr(src), self.raft_addr(dst))],
            "p": p, "delay": delay,
        })

    def heal_wire(self, idx: int) -> None:
        self.handle(idx).send_fault("heal_wire")

    # -- teardown ---------------------------------------------------------
    def close(self) -> None:
        if self.scope is not None:
            self.scope.close()
        if self.feeder is not None:
            self.feeder.close()
        if self.gateway is not None:
            try:
                self.gateway.close()
            except Exception:  # noqa: BLE001 — dark remotes mid-close
                pass
        for h in self.handles.values():
            h.close()
        if self.gossip is not None:
            self.gossip.close()
        for idx, p in self.procs.items():
            if p.poll() is None:
                with open(f"{self.workdir}/stop-{idx}", "w") as f:
                    f.write("stop")
        for p in self.procs.values():
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()


def _sla_hosts(fleet: ProcFleet) -> Dict[str, RemoteHostHandle]:
    """SLA convergence is judged over LIVE workers only: a SIGKILLed
    slot's handle raises on every probe and would read as 'never
    converged' long after the survivors agree."""
    return {fleet._key(i): fleet.handle(i) for i in fleet.live_slots()}


# ---------------------------------------------------------------------------
# the ~5s CI gate (scripts/rpc_smoke.sh)
# ---------------------------------------------------------------------------
def run_rpc_smoke(n: int = 2, *, workdir: str = "/tmp/rpc-smoke",
                  base_port: int = 29750) -> dict:
    fleet = ProcFleet(n, workdir=workdir, base_port=base_port)
    out = {"committed": 0, "rerouted": False}
    try:
        fleet.start()
        gw = fleet.gateway

        # commits over the wire through the gateway (exactly-once)
        h = gw.connect(SHARD, timeout=30.0)
        for i in range(5):
            h.sync_propose(audit_set_cmd(f"pre{i}", str(i)), timeout=10.0)
            out["committed"] += 1
        assert gw.read(SHARD, "pre0", timeout=10.0) == "0"

        # SIGKILL the leader's PROCESS mid-service
        victim = fleet.leader_slot()
        fleet.kill(victim)

        # with n=2 the shard has no quorum until the restart; bring the
        # victim back over the same dirs and require recovery (WAL
        # replay + gossip re-resolution + catch-up) inside the SLA
        fleet.restart(victim)
        assert_recovery_sla(
            _sla_hosts(fleet), SHARD, sla_ticks=4000,
            cmd=audit_set_cmd("sla", "probe"), rtt_ms=20,
            per_try_timeout=1.0, fault_class="proc_kill9",
        )

        # routing reconverges off gossip+stats with zero shared memory
        deadline = time.time() + 20
        while gw.routes.lookup(SHARD) is None and time.time() < deadline:
            time.sleep(0.1)
        out["rerouted"] = gw.routes.lookup(SHARD) is not None

        # post-recovery commits + read-your-write through the gateway
        for i in range(3):
            h.sync_propose(audit_set_cmd(f"post{i}", str(i)), timeout=10.0)
            out["committed"] += 1
        assert gw.read(SHARD, "post2", timeout=10.0) == "2"
        gw.close_handle(h)
        return out
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# the mini multi-process production day (DRAGONBOAT_MULTIPROC=1 gear)
# ---------------------------------------------------------------------------
class _Traffic:
    """Open-loop audited traffic over the gateway: exactly-once writers
    plus a linearizable reader, every outcome recorded for the offline
    Wing–Gong audit (the scenario runner's traffic idiom, client-side
    only — no in-proc journal exists across process boundaries)."""

    def __init__(self, gw: Gateway, rec: HistoryRecorder, writers: int = 2):
        self._gw = gw
        self.rec = rec
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._writer_main, args=(w,),
                             daemon=True, name=f"mpday-writer-{w}")
            for w in range(writers)
        ] + [
            threading.Thread(target=self._reader_main, daemon=True,
                             name="mpday-reader")
        ]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=20.0)

    def _writer_main(self, w: int) -> None:
        client = self.rec.new_client()
        handle = None
        seq = 0
        while not self._stop.is_set():
            if handle is None:
                try:
                    handle = self._gw.connect(SHARD, timeout=5.0)
                except Exception:  # noqa: BLE001 — fleet mid-outage
                    self._stop.wait(0.25)
                    continue
            key = f"w{w}-k{seq % 4}"
            val = f"{w}:{seq}"
            seq += 1
            op = self.rec.invoke(client, "w", key, val)
            try:
                handle.sync_propose(audit_set_cmd(key, val), timeout=2.5)
                self.rec.ok(op)
            except GatewayBusy:
                # shed at the door: definitely not in the history
                self.rec.fail(op)
            except Exception:  # noqa: BLE001 — maybe committed
                self.rec.ambiguous(op)
            self._stop.wait(0.02)

    def _reader_main(self) -> None:
        client = self.rec.new_client()
        seq = 0
        while not self._stop.is_set():
            key = f"w{seq % 2}-k{seq % 4}"
            seq += 1
            op = self.rec.invoke(client, "r", key)
            try:
                val = self._gw.read(SHARD, key, timeout=2.0)
                self.rec.ok(op, output=val)
            except Exception:  # noqa: BLE001 — reads are idempotent
                self.rec.fail(op)
            self._stop.wait(0.03)


def _mp_proc_kill(fleet: ProcFleet, phase, report: dict) -> None:
    """Real whole-host kill: SIGKILL the leader's process, require
    recovery inside the SLA, restart over the same dirs and wait until
    the victim answers stats over RPC again (catch-up observed from
    the outside)."""
    sla_ticks = int(phase.param("sla_ticks", 4000))
    victim = fleet.leader_slot()
    if fleet.scope is not None:
        # the kill window lands on the merged timeline AND the poll
        # window the SLO evaluator attributes the burn to
        fleet.scope.mark("proc_kill", f"slot={victim} (leader)")
    fleet.kill(victim)
    t0 = time.monotonic()
    assert_recovery_sla(
        _sla_hosts(fleet), SHARD, sla_ticks=sla_ticks,
        cmd=audit_set_cmd("sla-kill", "probe"), rtt_ms=20,
        per_try_timeout=1.0, fault_class=phase.fault_class,
    )
    report["sla"][phase.fault_class] = round(time.monotonic() - t0, 3)
    fleet.restart(victim)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            if fleet.handle(victim).balance_shard_stats():
                break
        except Exception:  # noqa: BLE001 — still replaying/joining
            pass
        time.sleep(0.2)
    if fleet.scope is not None:
        fleet.scope.mark("proc_restart", f"slot={victim}")


def _mp_asym_partition(fleet: ProcFleet, phase, report: dict) -> None:
    """Directional wire fault between real processes: the leader's
    sends toward one follower vanish (or crawl) while the reverse
    direction flows — the half-open link, held for the plan's window,
    then healed with the recovery SLA asserted after the heal.  The
    victims (who leads, which follower is struck) are runtime-sampled;
    the plan pins only kind/p/window."""
    kind = str(phase.param("kind", "asym_drop"))
    p = float(phase.param("p", 1.0))
    window = float(phase.param("window", 1.5))
    sla_ticks = int(phase.param("sla_ticks", 4000))
    leader = fleet.leader_slot()
    follower = next(i for i in fleet.live_slots() if i != leader)
    if kind == "asym_delay":
        fleet.set_asym_delay(
            leader, follower, float(phase.param("delay", 0.2)), p=p
        )
    else:
        fleet.set_asym_drop(leader, follower, p=p)
    time.sleep(window)  # let the one-way window bite under traffic
    fleet.heal_wire(leader)
    t0 = time.monotonic()
    assert_recovery_sla(
        _sla_hosts(fleet), SHARD, sla_ticks=sla_ticks,
        cmd=audit_set_cmd("sla-asym", "probe"), rtt_ms=20,
        per_try_timeout=1.0, fault_class=kind,
    )
    report["sla"][kind] = round(time.monotonic() - t0, 3)
    # routing reconverges purely off gossip + stats
    gw = fleet.gateway
    deadline = time.time() + 20
    while gw.routes.lookup(SHARD) is None and time.time() < deadline:
        time.sleep(0.1)
    assert gw.routes.lookup(SHARD) is not None, "route never reconverged"


def run_mini_multiproc_day(n: int = 3, *, workdir: str = "/tmp/mpday",
                           base_port: int = 29650, seed: int = 11) -> dict:
    """The acceptance scenario, SCHEDULE-DRIVEN: execute the seeded
    :meth:`DayPlan.multiproc` phases over a real 3-process fleet under
    open-loop gateway traffic — a real leader SIGKILL, then an
    asymmetric one-way partition injected over the RPC fault op and
    healed, each recovery under ``assert_recovery_sla``, and the full
    client history through the Wing–Gong audit.  The plan is byte-
    stable per seed (``report["plan"]``); victims stay runtime-sampled
    exactly like the in-proc gears."""
    from .plan import DayPlan

    plan = DayPlan.multiproc(seed)
    fleet = ProcFleet(n, workdir=workdir, base_port=base_port)
    report = {
        "sla": {}, "ops": 0, "audit": "pending",
        "seed": seed, "plan": plan.describe(), "phases": [],
    }
    try:
        fleet.start()
        gw = fleet.gateway
        scope = fleet.scope
        scope.start_poller(0.25)
        rec = HistoryRecorder()
        traffic = _Traffic(gw, rec)
        traffic.start()
        for phase in plan.phases:
            scope.mark("phase", phase.name)
            if phase.action == "proc_kill":
                _mp_proc_kill(fleet, phase, report)
            elif phase.action == "asym_partition":
                _mp_asym_partition(fleet, phase, report)
            else:
                # warmup/cooldown: steady-state traffic windows around
                # the disturbances (the cooldown is the post-heal tail)
                time.sleep(max(0.5, phase.duration))
            report["phases"].append(phase.name)
        traffic.stop()

        # -- the audit: full client history, Wing–Gong ------------------
        ops = rec.ops()
        report["ops"] = len(ops)
        lin = check_linearizable(ops)
        assert lin.ok, lin.describe()
        stale = check_stale_reads(ops)
        assert not stale, "\n".join(v.describe() for v in stale)
        report["audit"] = "ok"
        report["counts"] = rec.counts()

        # -- the telemetry verdict: gap, stitches, burn-rate ledger -----
        scope.close()
        scope.poll()  # final sweep so post-cooldown deltas land
        timeline = scope.merged_timeline()
        kinds = {e[3] for e in timeline}
        assert "obs_gap" in kinds, "kill window left no gap on the timeline"
        assert "proc_kill" in kinds
        stitches = scope.cross_process_stitches()
        assert stitches >= 1, "no cross-process trace stitched"
        slo_rows = scope.slo_report()
        assert slo_rows, "empty SLO report"
        report["slo"] = slo_rows
        report["obs"] = {
            "stitches": stitches,
            "polls": scope.polls,
            "reply_bytes": scope.reply_bytes,
            "procs": scope.proc_report(),
        }
        return report
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# the ~5s telemetry CI gate (scripts/fleetobs_smoke.sh)
# ---------------------------------------------------------------------------
def run_fleetobs_smoke(n: int = 2, *, workdir: str = "/tmp/fleetobs-smoke",
                       base_port: int = 29850) -> dict:
    """Fleet-scope smoke: a 2-process fleet takes gateway proposals
    carrying trace context, the scope polls every process over
    ``RPC_OP_OBS``, and the gate asserts at least one proposal's trace
    stitched across the RPC boundary plus a JSON-parseable SLO report
    with the full objective catalog."""
    fleet = ProcFleet(n, workdir=workdir, base_port=base_port)
    try:
        fleet.start()
        gw = fleet.gateway
        scope = fleet.scope
        h = gw.connect(SHARD, timeout=30.0)
        for i in range(8):
            h.sync_propose(audit_set_cmd(f"obs{i}", str(i)), timeout=10.0)
        assert gw.read(SHARD, "obs0", timeout=10.0) == "0"
        gw.close_handle(h)
        # spans end server-side on apply completion; two polls with a
        # short settle pick up the full request->raft->apply chains
        scope.poll()
        time.sleep(0.3)
        scope.poll()
        stitches = scope.cross_process_stitches()
        assert stitches >= 1, (
            f"no cross-process stitch:\n{scope.dump(SHARD)}"
        )
        rows = scope.slo_report()
        json.dumps(rows)  # the report must be a plain-JSON ledger
        assert {r["objective"] for r in rows} >= {
            "commit_p99", "shed_ratio"}, rows
        return {
            "stitches": stitches,
            "polls": scope.polls,
            "reply_bytes": scope.reply_bytes,
            "slo_objectives": len(rows),
            "burning": [r["objective"] for r in rows if r["burning"]],
        }
    finally:
        fleet.close()
