"""The port's production-day orchestrator against the reference's cases.

``scenario/`` is carried into ``dragonboat_tpu_torch/`` (byte for byte
but for the child process's imports and its spawn line,
``tests/test_torch_isolation.py``); here the reference's own cases run
on the port's copies, their source executed with every
``dragonboat_tpu`` import taken from ``dragonboat_tpu_torch``
(``load_on_port``; ``test_nodehost.py`` is loaded the same way):

* ``test_scenario.py``: ``TestPlanDeterminism``, ``TestRecoveryStats``,
  ``TestWitnessStreamChaos``, ``TestMemberCycleIdCollision``,
  ``TestPhaseAbort``, ``TestMiniDay`` and ``TestColocatedFleetMember``,
  with their ``flaky_isolated`` marks; the colocated member's
  ``ColocatedEngineGroup(**COLO_GEOM)`` runs on ``device="cpu"`` (the
  port's group defaults to ``cuda`` and never falls back);
* across the two packages: ``DayPlan.mini``, ``DayPlan.mini(scale=0.4)``,
  ``DayPlan.full`` and ``DayPlan.multiproc`` describe byte-identical
  days for the same seeds;
* ``test_rpc.py::test_rpc_smoke_two_process_fleet`` on the port's
  worker processes (``python -m dragonboat_tpu_torch.scenario.procworker``).

The reference's copies of these cases may run at the same time in
another worker, so every fleet here takes its own tag (``tsc-*``), every
NodeHost and state machine directory the case's ``tmp_path`` (the cases'
fixed ``/tmp`` paths become ``WORKDIR``), and the worker processes the
loopback ports 31351-31352 (raft), 31451-31452 (gossip) and 31551-31552
(RPC), which no other test uses.
"""
from __future__ import annotations

import subprocess

import pytest

from dragonboat_tpu.scenario import DayPlan as RefDayPlan
from dragonboat_tpu_torch import RECOVERY_STATS, NodeHost
from dragonboat_tpu_torch.scenario import DayPlan, ScenarioRunner
from dragonboat_tpu_torch.scenario import fleet as port_fleet
from dragonboat_tpu_torch.scenario import multiproc as port_multiproc

from test_torch_storage import load_on_port

TAG = "tsc"
RPC_BASE_PORT = 31350

_scen = load_on_port(
    "test_scenario.py", f"{TAG}_scenario", tag=TAG,
    replace=[
        ('tag="mday")', 'tag="tsc-mday", workdir=WORKDIR)', 1),
        ('tag="coloday", colocated=True)',
         'tag="tsc-coloday", colocated=True,\n'
         '                         workdir=WORKDIR)', 1),
        ('tag="abrt", sla_ticks=0)',
         'tag="tsc-abrt", sla_ticks=0,\n'
         '                           workdir=WORKDIR)', 1),
        ('f"/tmp/nh-', 'f"{WORKDIR}/nh-', 6),
        ('"/tmp/wsc-sm"', 'WORKDIR + "/wsc-sm"', 2),
    ])


@pytest.fixture(autouse=True)
def port_day(tmp_path, monkeypatch):
    """Each case: its own workdir, the colocated member on the CPU, and
    the port's process-wide recovery stats empty (as the reference's
    cases leave the reference's)."""
    monkeypatch.setattr(_scen, "WORKDIR", str(tmp_path), raising=False)
    monkeypatch.setitem(port_fleet.COLO_GEOM, "device", "cpu")
    RECOVERY_STATS.reset()
    yield
    RECOVERY_STATS.reset()


def test_cases_run_on_the_port():
    assert _scen.NodeHost is NodeHost
    assert _scen.ScenarioRunner is ScenarioRunner
    assert _scen.RECOVERY_STATS is RECOVERY_STATS
    assert _scen.KVStore.__module__ == f"{TAG}_test_nodehost"


# ---------------------------------------------------------------------------
# test_scenario.py on the port
# ---------------------------------------------------------------------------
class TestPlanDeterminism(_scen.TestPlanDeterminism):
    pass


class TestRecoveryStats(_scen.TestRecoveryStats):
    pass


class TestWitnessStreamChaos(_scen.TestWitnessStreamChaos):
    pass


class TestMemberCycleIdCollision(_scen.TestMemberCycleIdCollision):
    pass


class TestPhaseAbort(_scen.TestPhaseAbort):
    pass


class TestMiniDay(_scen.TestMiniDay):
    pass


class TestColocatedFleetMember(_scen.TestColocatedFleetMember):
    pass


# ---------------------------------------------------------------------------
# the same days in both packages
# ---------------------------------------------------------------------------
PLANS = {
    "mini": lambda mod, s: mod.mini(s),
    "mini_scaled": lambda mod, s: mod.mini(s, scale=0.4),
    "full": lambda mod, s: mod.full(s, hours=0.25, gb=False),
    "full_gb": lambda mod, s: mod.full(s, hours=0.1),
    "multiproc": lambda mod, s: mod.multiproc(s),
}


@pytest.mark.parametrize("seed", [0, 11, 42, 20261017])
@pytest.mark.parametrize("kind", list(PLANS))
def test_same_seed_same_day_in_both_packages(kind, seed):
    port = PLANS[kind](DayPlan, seed)
    ref = PLANS[kind](RefDayPlan, seed)
    assert port.describe() == ref.describe()
    assert port.classes_planned() == ref.classes_planned()
    assert [p.name for p in port.phases] == [p.name for p in ref.phases]


# ---------------------------------------------------------------------------
# the worker processes (test_rpc.py::test_rpc_smoke_two_process_fleet)
# ---------------------------------------------------------------------------
def test_rpc_smoke_two_process_fleet(tmp_path, monkeypatch):
    spawned = []
    popen = subprocess.Popen

    def record(argv, *a, **kw):
        spawned.append(list(argv))
        return popen(argv, *a, **kw)

    monkeypatch.setattr(port_multiproc.subprocess, "Popen", record)
    out = port_multiproc.run_rpc_smoke(n=2, workdir=str(tmp_path / "rpc"),
                                       base_port=RPC_BASE_PORT)
    assert out["committed"] == 8
    assert out["rerouted"]
    # two workers and the killed leader's restart, all the port's
    assert len(spawned) == 3, spawned
    assert all(a[1:3] == ["-m", "dragonboat_tpu_torch.scenario.procworker"]
               and a[6] == str(RPC_BASE_PORT) for a in spawned), spawned


# ---------------------------------------------------------------------------
# the chip smoke's day: a failed day that points at the colocated member
# is not run again
# ---------------------------------------------------------------------------
def _failed_day(**kw):
    from types import SimpleNamespace

    addr = f"chipday0-{port_fleet.COLO_SLOT}"
    fleet = SimpleNamespace(
        addrs={port_fleet.COLO_SLOT: addr, "h6": "chipday0-h6"},
        hosts={addr: SimpleNamespace(nodehost_id="nhid-colo")},
        _colo_groups={})
    report = SimpleNamespace(
        aborted=kw.get("aborted", "elastic"), violations=kw.get("viol", []),
        phases=[{"name": "elastic", "moves": kw.get("moves", [])}],
        colocated={"divergence_halts": kw.get("halts", 0)})
    return SimpleNamespace(fleet=fleet), report


@pytest.mark.parametrize("case,suspect", [
    (dict(), False),
    (dict(moves=["transfer(shard=2,src=3@chipday0-h6,dst=1@chipday0-h1)"]),
     False),
    (dict(viol=["elastic: transfer onto chipday0-h2 timed out"]), True),
    (dict(moves=["transfer(shard=2,src=3@chipday0-h6,dst=2@chipday0-h2)"]),
     True),
    (dict(warn=["load move failed: ... dst=2@chipday0-h2 ..."]), True),
    (dict(warn=["collect: host nhid-colo failed to report"]), True),
    (dict(halts=1), True),
])
def test_chip_day_retry_refuses_a_colocated_suspect(case, suspect):
    import chip_smoke

    runner, report = _failed_day(**case)
    found = chip_smoke.day_colo_suspect(runner, report, case.get("warn", []))
    assert bool(found) is suspect, found
