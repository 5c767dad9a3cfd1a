"""The production-day plan: a declarative, seeded phase schedule.

reference: the drummer/nemesis heritage (PAPER.md) — dragonboat's
credibility soak is scheduled churn plus a monitoring loop that keeps
repairing the fleet while traffic flows.  A :class:`DayPlan` is to the
scenario orchestrator what :class:`~dragonboat_tpu.faults.FaultPlan` is
to the nemesis: the complete, byte-canonical description of what will
be done to the cluster.  ``describe()`` is the determinism contract —
two plans built from the same seed and arguments are the SAME schedule
iff their describe() strings are byte-equal (tests/test_scenario.py
pins this), and every runtime-sampled victim (which host leads, which
stream a kill strikes) stays out of it by construction.

Two gears:

* :meth:`DayPlan.mini` — the tier-1-scale mini-day (~30-60 s, small
  fleet, every disturbance class fired at least once); ``scale < 1``
  shrinks it further for the ~10 s smoke gear.
* :meth:`DayPlan.full` — the env-gated hours-long day
  (``DRAGONBOAT_SOAK_DAY=1``, ``scripts/day_soak.sh``): repeated
  disturbance cycles sized to ``hours``, with the on-disk payload
  raised to GB scale when ``DRAGONBOAT_BIGSTATE_GB=1``
  (:func:`dragonboat_tpu.bigstate.gb_tier`).

The six disturbance classes (every gear fires each at least once):
``rolling_restart``, ``leader_churn``, ``stream_chaos``, ``drain``,
``dr_cycle``, ``elastic`` — see docs/SCENARIO.md for the class catalog
and the ledger each phase emits.  ``read_hot``, ``write_hot`` and
``diurnal`` are TRAFFIC-SHAPE phases, not disturbance classes
(ROADMAP 5c): the zipfian hot-key read/write storms against the
audited shard and the sinusoidal offered-load swing — their ledger
rows carry the observed split/swing.  ``elastic`` IS a class: it
drives a zipfian write storm and REQUIRES the balancer's
load-feedback loop to fire ≥1 move that sheds the hot shard's p99
(docs/BALANCE.md "Load-reactive rebalancing").

:meth:`DayPlan.multiproc` is the third gear (``DRAGONBOAT_MULTIPROC``):
a short schedule over the cross-process ProcFleet, the only gear whose
wire can express DIRECTIONAL faults — its ``asym_partition`` phase
fires the PR 16 ``asym_drop`` kinds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from random import Random
from typing import List, Optional, Tuple

from ..faults import Fault

#: the scenario fleet's shard ids (fixed — the plan references them)
SH_MEM = 1   # in-memory AuditKV: audited gateway session traffic + DR
SH_DISK = 2  # on-disk OnDiskKV: big-state plane, witness + non-voting

#: the six disturbance classes a production day must fire
DISTURBANCE_CLASSES = (
    "rolling_restart",
    "leader_churn",
    "stream_chaos",
    "drain",
    "dr_cycle",
    "elastic",
)


@dataclass(frozen=True)
class Phase:
    """One phase of the day.

    ``action`` names an orchestrator maneuver the runner executes
    (``rolling_restart`` / ``catchup_chaos`` / ``drain`` / ``dr_cycle``
    / ``read_hot`` or empty for traffic-only phases); ``faults`` is a nemesis
    sub-plan executed via :meth:`FaultController.run_phase` before the
    action; ``duration`` is the minimum wall time of the phase (traffic
    keeps flowing until it elapses, so even a fast action yields a
    measurable throughput window).  ``params`` is a sorted key/value
    tuple — part of the byte-canonical describe()."""

    name: str
    fault_class: str = ""
    duration: float = 0.0
    action: str = ""
    params: Tuple[Tuple[str, object], ...] = ()
    faults: Tuple[Fault, ...] = ()

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    def describe(self) -> str:
        ps = ",".join(f"{k}={v!r}" for k, v in self.params)
        fs = ";".join(f.describe() for f in self.faults)
        return (
            f"phase {self.name} class={self.fault_class} "
            f"dur={self.duration:g} action={self.action} "
            f"params({ps}) faults[{fs}]"
        )


def _p(**kw) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted(kw.items()))


@dataclass
class DayPlan:
    """An ordered production-day schedule (see module docstring)."""

    seed: int
    gear: str
    phases: List[Phase] = field(default_factory=list)

    def describe(self) -> str:
        head = f"dayplan gear={self.gear} seed={self.seed}"
        return "\n".join([head] + [p.describe() for p in self.phases])

    def classes_planned(self) -> Tuple[str, ...]:
        return tuple(
            sorted({p.fault_class for p in self.phases if p.fault_class})
        )

    # ------------------------------------------------------------------
    # builders
    # ------------------------------------------------------------------
    @staticmethod
    def mini(seed: int, *, scale: float = 1.0) -> "DayPlan":
        """The tier-1 mini-day.  ``scale`` shrinks durations, payload
        and the restart sweep (the smoke gear uses ~0.4); every
        disturbance class still fires at least once at any scale."""
        rng = Random(seed)

        def j(lo: float, hi: float) -> float:
            # schedule jitter, rounded so describe() stays byte-stable
            return round(rng.uniform(lo, hi), 3)

        sc = max(0.2, float(scale))
        restarts = 3 if sc >= 0.75 else 1
        payload_mb = max(1, int(round(3 * sc)))
        phases = [
            Phase("warmup", duration=round(3.0 * sc, 3)),
            Phase(
                "rolling_restart",
                fault_class="rolling_restart",
                duration=round(1.0 * sc, 3),
                action="rolling_restart",
                params=_p(hosts=restarts, grace=j(0.3, 0.6)),
            ),
            Phase(
                "leader_churn",
                fault_class="leader_churn",
                duration=round(1.5 * sc, 3),
                action="",
                faults=(
                    Fault("leader_kill", at=j(0.1, 0.4),
                          duration=j(0.8, 1.4), targets=(SH_MEM,)),
                    Fault("leader_transfer", at=j(2.6, 3.2),
                          targets=(SH_MEM,)),
                ),
            ),
            Phase(
                "stream_chaos",
                fault_class="stream_chaos",
                duration=round(1.0 * sc, 3),
                action="catchup_chaos",
                params=_p(
                    payload_mb=payload_mb,
                    cap_mb=4,
                    kill_p=j(0.3, 0.5),
                    stall_p=j(0.2, 0.4),
                    stall_delay=j(0.005, 0.02),
                ),
            ),
            Phase(
                "drain",
                fault_class="drain",
                duration=round(1.0 * sc, 3),
                action="drain",
                params=_p(host="h3", to="h6", timeout=90.0),
            ),
            Phase(
                "dr_cycle",
                fault_class="dr_cycle",
                duration=round(1.0 * sc, 3),
                action="dr_cycle",
                params=_p(shard=SH_MEM),
            ),
            # traffic shape, not a disturbance: the zipfian read storm
            # lands AFTER the DR cycle so follower/bounded reads are
            # served by the re-imported membership (the hard case)
            Phase(
                "read_hot",
                duration=round(1.5 * sc, 3),
                action="read_hot",
                params=_p(
                    keys=24,
                    skew=j(1.1, 1.5),
                    readers=3,
                    bound_ticks=100,
                    shard=SH_MEM,
                ),
            ),
            # write-side zipfian skew (the read_hot mirror, ROADMAP 5c:
            # the write half): a hot-key write storm against the
            # audited shard — traffic shape, no fault class
            Phase(
                "write_hot",
                duration=round(1.2 * sc, 3),
                action="write_hot",
                params=_p(
                    keys=24,
                    skew=j(1.1, 1.5),
                    writers=3,
                    shard=SH_MEM,
                ),
            ),
            # sinusoidal offered-load swing (diurnal in miniature):
            # writers modulate their pacing over `period`; the ledger
            # row records the observed peak/trough committed rates
            Phase(
                "diurnal",
                duration=round(1.6 * sc, 3),
                action="diurnal",
                params=_p(
                    writers=3,
                    period=j(0.7, 1.1),
                    amp=j(0.5, 0.8),
                    shard=SH_MEM,
                ),
            ),
            # the elastic class: a zipfian write storm heats one shard
            # while the balancer's load-feedback loop watches the
            # gateway's per-shard evidence; the phase REQUIRES >=1
            # load-driven move and a post-move p99 drop (and that a
            # preceding quiet window fired ZERO moves)
            Phase(
                "elastic",
                fault_class="elastic",
                duration=round(2.0 * sc, 3),
                action="elastic",
                params=_p(
                    keys=24,
                    skew=j(1.2, 1.6),
                    writers=4,
                    shard=SH_MEM,
                    hot_p99_ms=60,
                    hot_submit=20,
                    min_samples=12,
                    hysteresis=2,
                    cooldown=8,
                    quiet_passes=4,
                    storm_s=round(2.5 * sc, 3),
                ),
            ),
            Phase("cooldown", duration=round(2.0 * sc, 3)),
        ]
        return DayPlan(seed=seed, gear="mini", phases=phases)

    @staticmethod
    def full(
        seed: int,
        *,
        hours: float = 1.0,
        gb: Optional[bool] = None,
    ) -> "DayPlan":
        """The hours-long day: warmup, then repeated disturbance cycles
        (churn -> stream chaos -> rolling restart -> alternating region
        drain) with a DR cycle every third round, sized so the whole
        schedule spans ~``hours``.  ``gb=None`` reads the
        ``DRAGONBOAT_BIGSTATE_GB`` gate; at the GB tier the FIRST
        stream-chaos phase carries a ~1 GiB on-disk payload behind an
        8 MB/s cap (the capped-stream economics measured in
        docs/BIGSTATE.md), later ones stay MB-scale so the day is churn-
        bound, not transfer-bound."""
        if gb is None:
            from ..bigstate import gb_tier

            gb = gb_tier()
        rng = Random(seed)

        def j(lo: float, hi: float) -> float:
            return round(rng.uniform(lo, hi), 3)

        # one cycle is ~5 min of scheduled day; steady traffic padding
        # dominates, so cycles scale linearly with the requested hours
        cycles = max(2, int(round(hours * 3600 / 300.0)))
        phases: List[Phase] = [Phase("warmup", duration=20.0)]
        for c in range(cycles):
            drain_from, drain_to = (
                ("h3", "h6") if c % 2 == 0 else ("h6", "h3")
            )
            payload_mb = 1024 if (gb and c == 0) else max(2, int(j(2, 6)))
            cap_mb = 8 if (gb and c == 0) else 4
            phases += [
                Phase(
                    f"c{c}/leader_churn",
                    fault_class="leader_churn",
                    duration=30.0,
                    faults=(
                        Fault("leader_kill", at=j(0.5, 2.0),
                              duration=j(1.0, 2.5), targets=(SH_MEM,)),
                        Fault("leader_transfer", at=j(6.0, 9.0),
                              targets=(SH_MEM,)),
                        Fault("member_cycle", at=j(10.0, 13.0),
                              duration=j(1.0, 2.0), targets=(SH_MEM,)),
                    ),
                ),
                Phase(
                    f"c{c}/stream_chaos",
                    fault_class="stream_chaos",
                    duration=30.0,
                    action="catchup_chaos",
                    params=_p(
                        payload_mb=payload_mb,
                        cap_mb=cap_mb,
                        kill_p=j(0.2, 0.5),
                        stall_p=j(0.2, 0.4),
                        stall_delay=j(0.005, 0.03),
                    ),
                ),
                Phase(
                    f"c{c}/rolling_restart",
                    fault_class="rolling_restart",
                    duration=30.0,
                    action="rolling_restart",
                    params=_p(hosts=3, grace=j(0.4, 0.9)),
                ),
                Phase(
                    f"c{c}/drain",
                    fault_class="drain",
                    duration=30.0,
                    action="drain",
                    params=_p(host=drain_from, to=drain_to, timeout=300.0),
                ),
            ]
            if c % 3 == 2:
                phases.append(
                    Phase(
                        f"c{c}/dr_cycle",
                        fault_class="dr_cycle",
                        duration=30.0,
                        action="dr_cycle",
                        params=_p(shard=SH_MEM),
                    )
                )
        # the mini gear guarantees every class once; the full gear must
        # too even at tiny `hours` (cycles>=2 fires all but dr_cycle)
        if not any(p.fault_class == "dr_cycle" for p in phases):
            phases.append(
                Phase(
                    "final/dr_cycle",
                    fault_class="dr_cycle",
                    duration=30.0,
                    action="dr_cycle",
                    params=_p(shard=SH_MEM),
                )
            )
        # one zipfian read storm per day (traffic shape, no fault class)
        phases.append(
            Phase(
                "read_hot",
                duration=30.0,
                action="read_hot",
                params=_p(
                    keys=24,
                    skew=j(1.1, 1.5),
                    readers=4,
                    bound_ticks=100,
                    shard=SH_MEM,
                ),
            )
        )
        # the adversarial-traffic tail (ISSUE 18): write-side skew,
        # a diurnal swing, then the elastic class — full-gear sized
        phases += [
            Phase(
                "write_hot",
                duration=30.0,
                action="write_hot",
                params=_p(
                    keys=24,
                    skew=j(1.1, 1.5),
                    writers=4,
                    shard=SH_MEM,
                ),
            ),
            Phase(
                "diurnal",
                duration=45.0,
                action="diurnal",
                params=_p(
                    writers=4,
                    period=j(8.0, 12.0),
                    amp=j(0.5, 0.8),
                    shard=SH_MEM,
                ),
            ),
            Phase(
                "elastic",
                fault_class="elastic",
                duration=30.0,
                action="elastic",
                params=_p(
                    keys=24,
                    skew=j(1.2, 1.6),
                    writers=5,
                    shard=SH_MEM,
                    hot_p99_ms=60,
                    hot_submit=20,
                    min_samples=12,
                    hysteresis=2,
                    cooldown=8,
                    quiet_passes=4,
                    storm_s=8.0,
                ),
            ),
        ]
        phases.append(Phase("cooldown", duration=15.0))
        return DayPlan(seed=seed, gear="full", phases=phases)

    @staticmethod
    def multiproc(seed: int) -> "DayPlan":
        """The cross-process gear (``DRAGONBOAT_MULTIPROC=1``,
        docs/SCENARIO.md "The multi-process gear"): a short schedule
        the ProcFleet dispatcher executes over real OS processes —
        whole-host SIGKILL, then an ASYMMETRIC partition (the PR 16
        directional wire kinds the in-proc transport can't express):
        a one-way ``asym_drop`` from the leader's process toward one
        follower, healed after ``window`` seconds, with the recovery
        SLA asserted after the heal and the Wing–Gong audit across the
        whole day.  Victims (which process leads, which follower is
        struck) are runtime-sampled and stay out of describe() by
        construction."""
        rng = Random(seed)

        def j(lo: float, hi: float) -> float:
            return round(rng.uniform(lo, hi), 3)

        phases = [
            Phase("warmup", duration=j(1.5, 2.5)),
            Phase(
                "proc_kill",
                fault_class="proc_kill9",
                duration=j(1.0, 2.0),
                action="proc_kill",
                params=_p(sla_ticks=4000),
            ),
            Phase(
                "asym_partition",
                fault_class="asym_partition",
                duration=j(1.0, 2.0),
                action="asym_partition",
                params=_p(
                    kind="asym_drop",
                    p=1.0,
                    window=j(1.2, 1.8),
                    sla_ticks=4000,
                ),
            ),
            Phase("cooldown", duration=j(0.8, 1.2)),
        ]
        return DayPlan(seed=seed, gear="multiproc", phases=phases)
