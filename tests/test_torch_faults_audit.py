"""The port's fault plane and audit against the reference's cases.

``faults.py`` and ``audit/`` are carried byte for byte
(``tests/test_torch_isolation.py``); here the reference's own cases run
on the port's copies, their source executed with every
``dragonboat_tpu`` import taken from ``dragonboat_tpu_torch``
(``load_on_port``; helper modules such as ``test_chaos.py`` and
``test_nodehost.py`` are loaded the same way, so every NodeHost, state
machine and fault is the port's):

* ``test_faults.py``: ``TestPlanDeterminism``, ``TestWirePlane``,
  ``TestFSPlane``, ``TestNemesisDeterminism`` (in-proc, and TCP on ports
  26601-26603), ``TestAsymmetricWireFaults``, and the forced-escalation
  case on ``torch_step_engine_factory(device="cpu")``;
* across the two packages: the same seed gives the same ``FaultPlan``,
  and the same schedule the same nemesis ``event_log`` on an in-proc
  cluster (the determinism contract of ``faults.py`` held across both);
* ``test_audit.py``: ``TestCheckerAccepts``, ``TestCheckerRejects``,
  ``TestPendingLifecycle``, and ``TestAuditedChurnCluster`` on three
  port NodeHosts stepping through ``torch_step_engine_factory(
  device="cpu")``, whose real history both packages' checkers must
  judge alike (verdict and counterexample).

``test_chaos_colocated.py``'s cases on the port's colocated engine are
in ``test_torch_chaos_colocated.py`` (their storm alone takes half a
minute here).

Directories are ``nh-tfa-*`` (port) and ``nh-tfr-*`` (the reference's
side of a cross-package run) under the temp dir: no other test uses them.
In-proc addresses are those of the reference's cases; they live in the
port's own in-proc registry, which no reference test touches, and every
cluster resets it before it starts.
"""
from __future__ import annotations

import copy
import dataclasses
import random
import tempfile

import pytest
import torch

from dragonboat_tpu import faults as ref_faults
from dragonboat_tpu.audit import checker as ref_checker
from dragonboat_tpu.audit import history as ref_history
from dragonboat_tpu_torch import (
    EngineConfig,
    ExpertConfig,
    Fault,
    FaultController,
    FaultPlan,
    NodeHost,
    NodeHostConfig,
    propose_with_retry,
)
from dragonboat_tpu_torch.audit import checker as port_checker
from dragonboat_tpu_torch.audit.history import HistoryRecorder
from dragonboat_tpu_torch.ops.engine import torch_step_engine_factory
from dragonboat_tpu_torch.storage.tan import tan_logdb_factory
from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

from test_torch_storage import (  # noqa: F401 (a fixture)
    load_on_port,
    port_lock_witness,
)

# the port's lock-order witness over the whole module
pytestmark = pytest.mark.usefixtures("port_lock_witness")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the engines' small tensors: several
    engines step at once in one process here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TAG = "tfa"
TMP = tempfile.gettempdir()


# the base engine's geometry of the port's NodeHost tests; its clusters
# tick every 40 ms where the reference's tick every 2-5 ms: with three
# engines in one process on the CPU, a launch with a full inbox takes
# tens of ms of plain-version CPU time (ROADMAP §3, PR 9), and a slower
# clock starves the churn case's op count
GEOM = dict(capacity=16, P=5, W=32, M=8, E=4, O=32)
RTT_MS = 40

# test_chaos.py's TCP cluster moves from 27601-27603 to 26601-26603
load_on_port("test_chaos.py", f"{TAG}_test_chaos", tag=TAG,
             replace=[("127.0.0.1:2760", "127.0.0.1:2660", 3)])
_faults = load_on_port("test_faults.py", f"{TAG}_faults", tag=TAG)
_audit = load_on_port("test_audit.py", f"{TAG}_audit", tag=TAG)
# the same sources on the reference, for the cross-package cases
_ref_faults_cases = load_on_port("test_faults.py", "tfr_faults",
                                 port=False, tag="tfr")


def test_cases_run_on_the_port():
    assert _faults.FaultController is FaultController
    assert _faults.Cluster.__module__ == f"{TAG}_test_chaos"
    assert _faults.NodeHost is NodeHost
    assert _audit.check_linearizable is port_checker.check_linearizable
    assert _ref_faults_cases.FaultController is ref_faults.FaultController
    cluster = _faults.Cluster.__new__(_faults.Cluster)
    assert cluster._dir(1) == f"{TMP}/nh-tfa-chaos-1"


# ---------------------------------------------------------------------------
# test_faults.py on the port
# ---------------------------------------------------------------------------
class TestPlanDeterminism(_faults.TestPlanDeterminism):
    pass


class TestWirePlane(_faults.TestWirePlane):
    pass


class TestFSPlane(_faults.TestFSPlane):
    pass


class TestNemesisDeterminism(_faults.TestNemesisDeterminism):
    pass


class TestAsymmetricWireFaults(_faults.TestAsymmetricWireFaults):
    pass


class TestBaseEngineForcedEscalation:
    def test_torch_engine_escalate_fault_recovers(self):
        """``test_faults.py``'s forced-escalation case on the port's base
        engine: ``escalate`` faults are consumed POST-launch (the row's
        device effects discarded, its inputs replayed on the scalar
        path); under a p=1 window the shard keeps committing."""
        import shutil

        reset_inproc_network()
        shutil.rmtree(f"{TMP}/nh-tfa-vesc-1", ignore_errors=True)
        ctl = FaultController(seed=5)
        nh = NodeHost(NodeHostConfig(
            nodehost_dir=f"{TMP}/nh-tfa-vesc-1",
            rtt_millisecond=RTT_MS,
            raft_address="tfa-vesc-1",
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=1),
                step_engine_factory=torch_step_engine_factory(
                    **GEOM, device="cpu"),
            ),
        ))
        try:
            ctl.install_engine(nh.engine.step_engine)
            nh.start_replica(
                {1: "tfa-vesc-1"}, False, _faults.KVStore,
                _faults.shard_config(1, election_rtt=20, heartbeat_rtt=2),
            )
            s = nh.get_noop_session(1)
            set_cmd = _faults.set_cmd
            propose_with_retry(nh, s, set_cmd("pre", b"0"), timeout=10.0)
            eng = nh.engine.step_engine
            steps0 = eng.stats.get("device_steps", 0)
            f = ctl.activate(Fault("escalate", targets=(1,), p=1.0))
            for i in range(5):
                propose_with_retry(
                    nh, s, set_cmd(f"e{i}", b"%d" % i), timeout=10.0
                )
            ctl.deactivate(f)
            assert ctl.stats.get("engine_escalations", 0) > 0
            assert eng.stats.get("escalations", 0) > 0
            assert eng.stats.get("divergence_halts", 0) == 0
            propose_with_retry(nh, s, set_cmd("post", b"1"), timeout=10.0)
            assert eng.stats.get("device_steps", 0) > steps0
        finally:
            nh.close()


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------
PLAN_ARGS = [
    dict(_faults.TestPlanDeterminism.ARGS),
    dict(addrs=["x", "y"], fs_keys=[1], rounds=12),
    dict(addrs=["x", "y"], asym_pairs=["x->y", "y->x"], rounds=48),
    dict(addrs=["x", "y"], fs_keys=[1], churn_shards=[1, 2],
         asym_pairs=["x->y"], balance_shards=[7, 8], rounds=64),
]


@pytest.mark.parametrize("seed", [1234, 42, 20261017])
@pytest.mark.parametrize("case", range(len(PLAN_ARGS)))
def test_same_seed_same_plan_in_both_packages(seed, case):
    kw = PLAN_ARGS[case]
    ref = ref_faults.FaultPlan.randomized(seed, **kw)
    got = FaultPlan.randomized(seed, **kw)
    assert got.describe() == ref.describe()
    assert ([dataclasses.asdict(f) for f in got.faults]
            == [dataclasses.asdict(f) for f in ref.faults])


def test_same_schedule_same_event_log_in_both_packages():
    """``test_faults.py``'s fixed plan on its in-proc chaos cluster, run
    once on the reference and once on the port with the same seed: the
    two nemeses record the same event log, entry for entry."""
    ref = _ref_faults_cases._run_plan_once(_ref_faults_cases.Cluster, seed=99)
    got = _faults._run_plan_once(_faults.Cluster, seed=99)
    assert got == ref
    assert any("partition" in e[2] for e in got)


# ---------------------------------------------------------------------------
# test_audit.py on the port
# ---------------------------------------------------------------------------
class TestCheckerAccepts(_audit.TestCheckerAccepts):
    pass


class TestCheckerRejects(_audit.TestCheckerRejects):
    pass


class TestPendingLifecycle(_audit.TestPendingLifecycle):
    pass


class PortAuditCluster(_audit.AuditCluster):
    """``test_audit.py``'s AuditCluster with every host stepping its
    shards through ``torch_step_engine_factory(device="cpu")``."""

    engines: list = []

    def start(self, rid):
        self.nhs[rid] = NodeHost(NodeHostConfig(
            nodehost_dir=self._dir(rid),
            rtt_millisecond=RTT_MS,
            raft_address=self.ADDRS[rid],
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=2, apply_shards=2),
                logdb_factory=tan_logdb_factory,
                step_engine_factory=torch_step_engine_factory(
                    **GEOM, device="cpu"),
            ),
        ))
        self.engines.append(self.nhs[rid].engine.step_engine)
        self.nemesis.install_nodehost(rid, self.nhs[rid])


class _KeptRecorder(HistoryRecorder):
    """The recorder the churn case builds, kept for the checkers'
    cross-package comparison after the case returns."""

    kept: list = []

    def __init__(self):
        super().__init__()
        self.kept.append(self)


# the reference's case body builds its cluster and recorder by these names
_audit.AuditCluster = PortAuditCluster
_audit.HistoryRecorder = _KeptRecorder


def _ref_ops(ops):
    """Port ``Op``s as the reference's, through their plain-data form."""
    return [ref_history.Op(**dataclasses.asdict(o)) for o in ops]


def _same_verdict(ops):
    """Both packages' checkers on one history: the same verdict and the
    same counterexamples."""
    got = port_checker.check_linearizable(ops)
    ref = ref_checker.check_linearizable(_ref_ops(ops))
    assert (got.ok, got.bounded, got.keys_checked) == (
        ref.ok, ref.bounded, ref.keys_checked)
    assert got.describe() == ref.describe()
    assert ([[o.describe() for o in v.ops] for v in got.violations]
            == [[o.describe() for o in v.ops] for v in ref.violations])
    stale = port_checker.check_stale_reads(ops)
    assert ([v.describe() for v in stale] == [
        v.describe() for v in ref_checker.check_stale_reads(_ref_ops(ops))])
    return got


class TestAuditedChurnCluster(_audit.TestAuditedChurnCluster):
    def test_history_linearizable_and_exactly_once_under_churn(self):
        PortAuditCluster.engines.clear()
        _KeptRecorder.kept.clear()
        super().test_history_linearizable_and_exactly_once_under_churn()
        engines = PortAuditCluster.engines
        assert len(engines) >= 3  # the killed host restarts on a new one
        assert sum(e.stats.get("device_steps", 0) for e in engines) > 0
        assert all(e.stats.get("divergence_halts", 0) == 0 for e in engines)
        # the run's real history: accepted alike, and a corrupted copy
        # refused alike with the same counterexample window
        (rec,) = _KeptRecorder.kept
        ops = rec.ops()
        assert _same_verdict(ops).ok
        bad = copy.deepcopy(ops)
        victim = next(o for o in bad if o.kind == "r" and o.status == "ok"
                      and o.output is not None)
        victim.output = "bogus-value-never-written"
        assert not _same_verdict(bad).ok


def _synthetic_history(seed, n=80):
    """Overlapping writes and reads of three clients on two keys, every
    op linearized at its index; some writes end ambiguous."""
    rng = random.Random(seed)
    rec = HistoryRecorder()
    clients = [rec.new_client() for _ in range(3)]
    value = {"a": None, "b": None}
    ops = []
    for i in range(n):
        key = rng.choice("ab")
        kind = rng.choice("wwr")
        op = rec.invoke(rng.choice(clients), kind, key,
                        f"v{i}" if kind == "w" else None)
        op.invoke, op.ret = i - rng.uniform(0, 3), i + rng.uniform(0, 3)
        if kind == "w":
            value[key] = op.value
            op.status = "ambig" if rng.random() < 0.1 else "ok"
            if op.status == "ambig":
                op.ret = float("inf")
        else:
            op.status, op.output = "ok", value[key]
        ops.append(op)
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_checkers_agree_on_synthetic_histories(seed):
    ops = _synthetic_history(seed)
    assert _same_verdict(ops).ok
    # a read returns the value of write w1 though a later write w2 of
    # its key completed before the read began, and w1 before w2 began
    ok_w = [o for o in ops if o.kind == "w" and o.status == "ok"]
    stale = [(r, w1) for r in ops if r.kind == "r"
             for w2 in ok_w if w2.key == r.key and w2.ret < r.invoke
             for w1 in ok_w if w1.key == r.key and w1.ret < w2.invoke]
    assert stale
    r, w1 = stale[random.Random(seed).randrange(len(stale))]
    bad = copy.deepcopy(ops)
    bad[ops.index(r)].output = w1.value
    assert not _same_verdict(bad).ok
