"""The production-day fleet: hosts, shards, planes, lifecycle.

One :class:`DayFleet` owns everything the scenario runner shakes:

* six in-proc NodeHosts — ``h1..h3`` core, ``h4`` witness-only, ``h5``
  a non-voting big-state laggard, ``h6`` an empty spare (the region-
  drain target);
* two shards — :data:`~.plan.SH_MEM` (in-memory AuditKV, the audited
  gateway-session shard and DR subject) and :data:`~.plan.SH_DISK`
  (on-disk ``OnDiskKV`` with 3 voters + 1 witness + 1 non-voting — the
  mixed on-disk/in-memory/witness fleet the survey's drummer scenarios
  run);
* the planes: ONE seeded nemesis (crash handlers + churn + recorders),
  a ``Balancer`` over the core+spare hosts, and a ``Gateway`` fronting
  all of them.

Kill/restart is whole-host and keeps every plane's membership in sync
(gateway host map, balancer registration, nemesis installs).  The
``_assign`` registry tracks which replicas each host must restart
with; after membership-changing maneuvers (drain, DR) the runner calls
:meth:`refresh_assignments` to re-derive it from live cluster
membership instead of trusting a stale map.
"""
from __future__ import annotations

import shutil
import threading
from typing import Dict, Optional, Tuple

from ..balance import Balancer
from ..audit import AuditKV
from ..config import Config, EngineConfig, ExpertConfig, NodeHostConfig
from ..faults import FaultController
from ..gateway import Gateway, GatewayConfig
from ..logger import get_logger
from ..nodehost import NodeHost
from .plan import SH_DISK, SH_MEM

_log = get_logger("scenario")

CORE = ("h1", "h2", "h3")
WITNESS = "h4"
LAGGARD = "h5"
SPARE = "h6"
SLOTS = CORE + (WITNESS, LAGGARD, SPARE)

WITNESS_RID = 4
LAGGARD_RID = 5

# the colocated fleet member: one CORE host whose replicas (both
# shards) step through a shared ColocatedEngineGroup — the product
# device path riding the SAME scheduled churn as everyone else
COLO_SLOT = "h2"
# small ring window (entry-cache depth 256/shard) — the geometry the
# colocated chaos suite pins, reused here so the jit cache is warm
COLO_GEOM = dict(capacity=16, P=5, W=8, M=8, E=4, O=32, budget=4)


class DayFleet:
    """See module docstring.  ``tag`` namespaces transport addresses
    and on-disk dirs so concurrent fleets (tests) never collide."""

    def __init__(self, seed: int = 0, *, tag: str = "day",
                 workdir: str = "/tmp", colocated: bool = False):
        self.seed = seed
        self.tag = tag
        self.workdir = workdir
        self.colocated = colocated
        # slot -> ColocatedEngineGroup, REUSED across that slot's
        # restarts (the chaos-tested path: state generations + WAL
        # replay re-attach the restarted replicas to the live group)
        self._colo_groups: Dict[str, object] = {}
        self.addrs: Dict[str, str] = {s: f"{tag}-{s}" for s in SLOTS}
        self.slots: Dict[str, str] = {a: s for s, a in self.addrs.items()}
        self.hosts: Dict[str, NodeHost] = {}
        self._dead: set = set()
        self._lock = threading.RLock()
        # addr -> {shard: (replica_id, kind)}; kind: voter|witness|nonvoting
        self._assign: Dict[str, Dict[int, Tuple[int, str]]] = {}
        # shard -> {rid: addr} voter map (restart initial_members)
        self._members: Dict[int, Dict[int, str]] = {}
        self.nemesis: Optional[FaultController] = None
        self.balancer: Optional[Balancer] = None
        self.gateway: Optional[Gateway] = None
        self._sla_seq = 0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _dir(self, slot: str) -> str:
        return f"{self.workdir}/nh-{self.tag}-{slot}"

    def _sm_root(self) -> str:
        return f"{self.workdir}/{self.tag}-sm"

    def sm_factory(self, shard_id: int, replica_id: int):
        """One factory for every shard (the balancer hands it to
        start_replica on move targets too)."""
        if shard_id == SH_DISK:
            from ..bigstate.ondisk import ondisk_kv_factory

            return ondisk_kv_factory(self._sm_root())(shard_id, replica_id)
        return AuditKV(shard_id, replica_id)

    def config_factory(self, shard_id: int, replica_id: int) -> Config:
        # election windows are WIDE for an in-proc fleet (100/150 ms):
        # six hosts + gateway + traffic + balancer share one box (in CI,
        # one core), and a 20 ms window flaps check-quorum under that
        # load — constant step-downs would churn leadership far beyond
        # what the day SCHEDULES, wedging snapshot sends mid-stream
        if shard_id == SH_DISK:
            return Config(
                replica_id=replica_id, shard_id=shard_id,
                election_rtt=30, heartbeat_rtt=3, check_quorum=True,
                is_witness=(replica_id == WITNESS_RID),
                is_non_voting=(replica_id == LAGGARD_RID),
            )
        return Config(
            replica_id=replica_id, shard_id=shard_id,
            election_rtt=20, heartbeat_rtt=2, check_quorum=True,
        )

    def _colo_group(self, slot: str):
        group = self._colo_groups.get(slot)
        if group is None:
            from ..ops.colocated import ColocatedEngineGroup

            group = ColocatedEngineGroup(**COLO_GEOM)
            self._colo_groups[slot] = group
        return group

    def _make_host(self, slot: str) -> NodeHost:
        # single-shard engine pools: six hosts run on one box, and the
        # day's realism comes from plane interleaving, not from intra-
        # host engine parallelism — fewer threads keep tick cadence
        # honest under the GIL
        expert = ExpertConfig(
            engine=EngineConfig(exec_shards=1, apply_shards=1)
        )
        if self.colocated and slot == COLO_SLOT:
            # the factory is NODEHOST-level: every replica this host
            # runs (both shards) steps on the shared device group
            expert = ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=1),
                step_engine_factory=self._colo_group(slot).factory,
            )
        return NodeHost(
            NodeHostConfig(
                nodehost_dir=self._dir(slot),
                rtt_millisecond=5,
                raft_address=self.addrs[slot],
                enable_flight_recorder=True,
                expert=expert,
            )
        )

    def colo_stats(self) -> Dict[str, int]:
        """Device-path counters from the colocated member's group —
        device_rows_stepped proves the launch pipeline actually rode
        the device, divergence_halts must stay zero through churn."""
        out: Dict[str, int] = {}
        for group in self._colo_groups.values():
            core = group.core
            if core is None:
                continue
            for k, v in dict(core.stats).items():
                out[k] = out.get(k, 0) + int(v)
        return out

    def build(self) -> None:
        from ..transport.inproc import reset_inproc_network

        reset_inproc_network()
        for slot in SLOTS:
            shutil.rmtree(self._dir(slot), ignore_errors=True)
        shutil.rmtree(self._sm_root(), ignore_errors=True)
        self.nemesis = FaultController(seed=self.seed)
        self.nemesis.set_crash_handlers(self.kill, self.restart)
        for slot in SLOTS:
            addr = self.addrs[slot]
            self.hosts[addr] = self._make_host(slot)
            self.nemesis.install_nodehost(addr, self.hosts[addr])
        core_addrs = {i + 1: self.addrs[s] for i, s in enumerate(CORE)}
        self._members = {SH_MEM: dict(core_addrs), SH_DISK: dict(core_addrs)}
        self._assign = {a: {} for a in self.addrs.values()}
        for rid, addr in core_addrs.items():
            nh = self.hosts[addr]
            for shard in (SH_MEM, SH_DISK):
                nh.start_replica(
                    core_addrs, False, self.sm_factory,
                    self.config_factory(shard, rid),
                )
                self._assign[addr][shard] = (rid, "voter")
        for shard in (SH_MEM, SH_DISK):
            self.wait_for_leader(shard)
        # the mixed tail: witness + non-voting big-state laggard
        self._add_member(SH_DISK, WITNESS_RID, WITNESS, "witness")
        self._add_member(SH_DISK, LAGGARD_RID, LAGGARD, "nonvoting")
        self.balancer = Balancer(
            self.sm_factory,
            self.config_factory,
            hosts={
                self.addrs[s]: self.hosts[self.addrs[s]]
                for s in CORE + (SPARE,)
            },
            replication_factor=3,
            seed=self.seed,
            catchup_timeout=90.0,
        )
        self.nemesis.install_balancer(self.balancer)
        self.nemesis.install_churn(
            self.live_hosts,
            shards=(SH_MEM,),
            balancer=self.balancer,
            sla_ticks=15_000,
            sla_cmd=self.sla_cmd,
            sla_per_try=2.0,
        )
        self.gateway = Gateway(
            dict(self.hosts), GatewayConfig(workers=2, default_timeout=4.0)
        )
        # close the loop: the balancer's collector reads the gateway's
        # per-shard latency/shed evidence (ClusterView.load rows)
        self.balancer.attach_load_source(self.gateway.shard_load)

    def _add_member(self, shard: int, rid: int, slot: str, kind: str) -> None:
        from ..client import call_with_retry

        addr = self.addrs[slot]
        api = self.hosts[self._members[shard][1]]
        if kind == "witness":
            call_with_retry(
                lambda: api.sync_request_add_witness(
                    shard, rid, addr, timeout=2.0
                ),
                timeout=20.0,
            )
        else:
            call_with_retry(
                lambda: api.sync_request_add_non_voting(
                    shard, rid, addr, timeout=2.0
                ),
                timeout=20.0,
            )
        self.hosts[addr].start_replica(
            {}, True, self.sm_factory, self.config_factory(shard, rid)
        )
        self._assign[addr][shard] = (rid, kind)

    # ------------------------------------------------------------------
    # membership views
    # ------------------------------------------------------------------
    def live_hosts(self) -> Dict[str, NodeHost]:
        with self._lock:
            return {
                a: nh for a, nh in self.hosts.items()
                if a not in self._dead and not getattr(nh, "_closed", False)
            }

    def hosts_holding(self, shard: int) -> Dict[str, NodeHost]:
        return {
            a: nh for a, nh in self.live_hosts().items()
            if nh._nodes.get(shard) is not None
        }

    def leader_host(self, shard: int) -> Optional[NodeHost]:
        for nh in self.live_hosts().values():
            try:
                if nh.is_leader_of(shard):
                    return nh
            except Exception:  # noqa: BLE001 — host closing mid-probe
                continue
        return None

    def wait_for_leader(self, shard: int, timeout: float = 20.0) -> NodeHost:
        import time as _time

        deadline = _time.time() + timeout
        while _time.time() < deadline:
            nh = self.leader_host(shard)
            if nh is not None:
                return nh
            _time.sleep(0.02)
        raise AssertionError(f"no leader for shard {shard} within {timeout}s")

    def sla_cmd(self) -> bytes:
        """A unique commit-continuity probe for the churn plane's SLA
        checks (SH_MEM; the ``_sla`` key is outside every audited key
        prefix, so the probe traffic never perturbs the history)."""
        from ..audit import audit_set_cmd

        with self._lock:
            self._sla_seq += 1
            n = self._sla_seq
        return audit_set_cmd("_sla", f"s{n}")

    def sla_probe(self, shard: int) -> bytes:
        if shard == SH_DISK:
            from ..bigstate.ondisk import put_cmd

            with self._lock:
                self._sla_seq += 1
                n = self._sla_seq
            return put_cmd(b"_sla", b"s%d" % n)
        return self.sla_cmd()

    def refresh_assignments(self) -> None:
        """Re-derive ``_assign``/``_members`` from live cluster
        membership (after drain / DR rewrote it)."""
        with self._lock:
            for a in self._assign:
                self._assign[a] = {}
            for shard in (SH_MEM, SH_DISK):
                holders = self.hosts_holding(shard)
                m = None
                for nh in holders.values():
                    try:
                        m = nh.get_shard_membership(shard)
                        if m is not None and m.addresses:
                            break
                    except Exception:  # noqa: BLE001 — mid-restart
                        continue
                if m is None:
                    continue
                self._members[shard] = dict(m.addresses)
                for rid, addr in m.addresses.items():
                    if addr in self._assign:
                        self._assign[addr][shard] = (rid, "voter")
                for rid, addr in m.witnesses.items():
                    if addr in self._assign:
                        self._assign[addr][shard] = (rid, "witness")
                for rid, addr in m.non_votings.items():
                    if addr in self._assign:
                        self._assign[addr][shard] = (rid, "nonvoting")

    def set_member_map(self, shard: int, members: Dict[int, str],
                       kind: str = "voter") -> None:
        """Overwrite one shard's voter map (the DR cycle rewrites
        membership wholesale before replicas restart)."""
        with self._lock:
            self._members[shard] = dict(members)
            for a in self._assign:
                self._assign[a].pop(shard, None)
            for rid, addr in members.items():
                if addr in self._assign:
                    self._assign[addr][shard] = (rid, kind)

    # ------------------------------------------------------------------
    # whole-host lifecycle (crash handlers + rolling restarts)
    # ------------------------------------------------------------------
    def kill(self, addr: str) -> None:
        with self._lock:
            nh = self.hosts.get(addr)
            if nh is None or addr in self._dead:
                return
            self._dead.add(addr)
        if self.gateway is not None:
            try:
                self.gateway.remove_host(addr)
            except Exception:  # noqa: BLE001 — gateway may be closing
                pass
        if self.balancer is not None and addr in self.balancer.hosts:
            self.balancer.remove_host(addr)
        nh.close()

    def restart(self, addr: str) -> None:
        slot = self.slots[addr]
        nh = self._make_host(slot)
        with self._lock:
            self.hosts[addr] = nh
            assigns = dict(self._assign.get(addr, {}))
            members = {s: dict(m) for s, m in self._members.items()}
            was_balanced = (
                self.balancer is not None
                and (slot in CORE or slot == SPARE)
            )
        self.nemesis.install_nodehost(addr, nh)
        for shard, (rid, kind) in sorted(assigns.items()):
            cfg = self.config_factory(shard, rid)
            if kind == "voter":
                nh.start_replica(members[shard], False, self.sm_factory, cfg)
            else:
                # witness / non-voting replicas joined; persisted state
                # carries their membership, a join restart re-attaches
                nh.start_replica({}, True, self.sm_factory, cfg)
        if was_balanced:
            self.balancer.join(addr, nh)
        if self.gateway is not None:
            try:
                self.gateway.add_host(addr, nh)
            except Exception:  # noqa: BLE001 — gateway may be closing
                pass
        with self._lock:
            self._dead.discard(addr)

    # ------------------------------------------------------------------
    # teardown / observability
    # ------------------------------------------------------------------
    def dump_timeline(self) -> str:
        from ..obs import hosts_timeline

        try:
            return hosts_timeline(self.live_hosts().values())
        except Exception:  # noqa: BLE001 — best-effort dump
            return ""

    def stream_totals(self) -> Dict[str, int]:
        """Cumulative snapshot-stream counters over the LIVE transports
        (restarted hosts reset theirs — ledger deltas clamp at zero)."""
        out = {"stream_resumes": 0, "stream_chunks": 0, "stream_bytes": 0}
        for nh in self.live_hosts().values():
            try:
                m = nh.transport.metrics
            except Exception:  # noqa: BLE001 — host closing
                continue
            for k in out:
                out[k] += int(m.get(k, 0))
        return out

    def close(self) -> None:
        if self.nemesis is not None:
            try:
                self.nemesis.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                _log.exception("nemesis stop failed")
        if self.gateway is not None:
            try:
                self.gateway.close()
            except Exception:  # noqa: BLE001
                _log.exception("gateway close failed")
        if self.balancer is not None:
            try:
                self.balancer.stop()
            except Exception:  # noqa: BLE001
                pass
        for nh in list(self.hosts.values()):
            try:
                nh.close()
            except Exception:  # noqa: BLE001
                pass
        self.hosts.clear()
