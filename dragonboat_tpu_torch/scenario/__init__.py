"""Production-day scenario orchestrator (docs/SCENARIO.md).

The fusing plane: every subsystem the survey names — device-backed
NodeHosts, the serving gateway, the balance control plane, big-state
storage with resumable capped streams, DR export/import, the seeded
nemesis, and the Wing–Gong audit — run TOGETHER through one
deterministic, seeded day schedule:

* :class:`DayPlan` / :class:`Phase` — the declarative schedule
  (``FaultPlan``-style byte-canonical ``describe()``); gears:
  :meth:`DayPlan.mini` (tier-1, ~30-60 s) and :meth:`DayPlan.full`
  (``DRAGONBOAT_SOAK_DAY=1``, hours);
* :class:`DayFleet` — the mixed fleet: on-disk big-state shards next
  to in-memory shards, a witness (dummy snapshots) and a non-voting
  big-state laggard, fronted by a Gateway, balanced by a Balancer,
  shaken by ONE seeded nemesis;
* :class:`ScenarioRunner` — executes the plan under live traffic,
  wraps every recovery in ``assert_recovery_sla(fault_class=...)``,
  records the whole client history for the offline audit, aborts on
  any SLA miss with a flight-recorder timeline;
* :class:`DayReport` — the per-phase ledger + per-fault-class
  recovery/dip table (JSON + printable).

The multi-process gear (:mod:`.multiproc`) lifts the same shape across
OS-process boundaries: :class:`ProcFleet` runs each host as a separate
process behind the RPC/TCP ingress with real gossip liveness, so the
nemesis's whole-host kill is a true ``SIGKILL``.
"""
from .fleet import CORE, LAGGARD, SPARE, WITNESS, DayFleet
from .multiproc import (
    ProcFleet,
    run_fleetobs_smoke,
    run_mini_multiproc_day,
    run_rpc_smoke,
)
from .plan import DISTURBANCE_CLASSES, DayPlan, Phase, SH_DISK, SH_MEM
from .report import DayReport
from .runner import ScenarioRunner

__all__ = [
    "CORE",
    "DISTURBANCE_CLASSES",
    "DayFleet",
    "DayPlan",
    "DayReport",
    "LAGGARD",
    "Phase",
    "ProcFleet",
    "SH_DISK",
    "SH_MEM",
    "SPARE",
    "ScenarioRunner",
    "WITNESS",
    "run_fleetobs_smoke",
    "run_mini_multiproc_day",
    "run_rpc_smoke",
]
