"""The port's balancer and gateway against the reference's cases.

``balance/`` and ``gateway/`` are carried byte for byte
(``tests/test_torch_isolation.py``); here the reference's own cases run
on the port's copies, their source executed with every
``dragonboat_tpu`` import taken from ``dragonboat_tpu_torch``
(``load_on_port``):

* ``test_balance.py``: ``TestPlannerDeterminism``,
  ``TestPlannerInvariants``, ``TestSpreadHotPlanner``,
  ``TestExecutorSequencing`` (stub hosts), ``TestDrainAcceptance`` on
  port NodeHosts in the reference's shape (the host path: sixteen shards
  on four CPU engines outrun the plain step, ROADMAP §3), and
  ``TestBalanceChaos`` plus one replace move on port NodeHosts stepping
  through ``torch_step_engine_factory(device="cpu")``;
* across the two packages: the same ``ClusterView`` built in both gives
  byte-identical ``MovePlan`` descriptions, and three port hosts sharing
  ``ColocatedEngineGroup(mesh=GroupsMesh(["cpu"] * 4))`` give the same
  ``Collector`` view (replica devices, chips, ``describe()``) as three
  reference hosts sharing ``ColocatedEngineGroup(mesh=Mesh(cpu[:4]))``
  after the same joins;
* ``test_gateway.py``: ``TestRoutingCache``, ``TestRaftLease`` (on the
  port's raft, ``raft_harness.py`` loaded onto it), ``TestAdmission``,
  ``TestGatewayEndToEnd``, ``TestLeaseReads`` (the stale-read
  containment pass under leader-kill churn included) and
  ``TestOverload`` in the reference's shape (the host path);
* one RPC round trip on three hosts sharing
  ``ColocatedEngineGroup(device="cpu")``, the product path:
  ``RpcServer`` plus ``RemoteHostHandle`` over TCP (ports 26610-26612),
  proposing and reading through a ``Gateway``.

The base-engine clusters tick every 60 ms and the colocated ones every
20 ms, where the reference's tick every 2 ms: the eager torch step is
slower a launch than the reference's scalar step.  Directories are
``nh-tbg-*`` (and ``nh-tbr-*`` for the reference's side) under the temp
dir, used by no other test; in-proc addresses live in the port's own in-proc
registry, and every cluster resets it before it starts.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time

import numpy as np
import pytest
import torch

import dragonboat_tpu as ref
from dragonboat_tpu.ops import colocated as ref_colocated
from dragonboat_tpu_torch import (
    Config,
    EngineConfig,
    ExpertConfig,
    Gateway,
    GatewayConfig,
    NodeHost,
    NodeHostConfig,
    assert_recovery_sla,
    propose_with_retry,
)
from dragonboat_tpu_torch.audit.model import AuditKV, audit_set_cmd
from dragonboat_tpu_torch.balance import Collector
from dragonboat_tpu_torch.gateway.rpc import RemoteHostHandle, RpcServer
from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup
from dragonboat_tpu_torch.ops.engine import torch_step_engine_factory
from dragonboat_tpu_torch.ops.placement import GroupsMesh
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


TAG = "tbg"
TMP = tempfile.gettempdir()


# the base-engine clusters tick every 60 ms where the reference's tick
# every 2 ms: with several engines in one process on the CPU, a launch
# with a full inbox takes tens of ms of plain-version CPU time, and a
# leadership transfer or a joiner's catch-up must fit in an election
# window of 10 ticks (ROADMAP §3, PR 9)
RTT_MS = 60
# the base engine's geometry of the port's NodeHost tests; room for the
# 16 rows a drained fleet's survivor holds, and a move's extra member
GEOM = dict(capacity=32, P=5, W=32, M=8, E=4, O=32)

_bal = load_on_port("test_balance.py", f"{TAG}_balance", tag=TAG)
_gw = load_on_port("test_gateway.py", f"{TAG}_gateway", tag=TAG)
# the same source on the reference, for the cross-package planner case
_ref_bal = load_on_port("test_balance.py", "tbr_balance", port=False,
                        tag="tbr")


def _engine_config(**engine):
    return ExpertConfig(
        engine=EngineConfig(**engine),
        step_engine_factory=torch_step_engine_factory(**GEOM, device="cpu"),
    )


def _balance_host(i, rtt_ms=2):
    """``test_balance.py``'s ``make_host`` on the port's engine."""
    d = f"{TMP}/nh-{TAG}-bal-{i}"
    shutil.rmtree(d, ignore_errors=True)
    return NodeHost(NodeHostConfig(
        nodehost_dir=d,
        rtt_millisecond=RTT_MS,
        raft_address=_bal.HOSTS[i],
        enable_metrics=True,
        expert=_engine_config(exec_shards=2, apply_shards=2),
    ))


# the colocated geometry of the port's colocated tests
COLO_GEOM = dict(capacity=16, P=5, W=32, M=8, E=4, O=32, budget=4)
COLO_RTT_MS = 20


def _colocated_cluster(sm_factory, tag):
    """Three port hosts sharing one ``ColocatedEngineGroup(device="cpu")``
    (one launch a round for every host's rows), shard 1 started on each
    with ``test_gateway.py``'s config."""
    reset_inproc_network()
    group = ColocatedEngineGroup(**COLO_GEOM, device="cpu")
    addrs = {r: f"{TAG}-{tag}-{r}" for r in (1, 2, 3)}
    nhs = {}
    for r, a in addrs.items():
        d = f"{TMP}/nh-{TAG}-{tag}-{r}"
        shutil.rmtree(d, ignore_errors=True)
        nhs[a] = NodeHost(NodeHostConfig(
            nodehost_dir=d,
            rtt_millisecond=COLO_RTT_MS,
            raft_address=a,
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=2),
                step_engine_factory=group.factory),
        ))
    for r, a in addrs.items():
        nhs[a].start_replica(
            addrs, False, sm_factory,
            Config(replica_id=r, shard_id=1, election_rtt=10,
                   heartbeat_rtt=1, check_quorum=True))
    return addrs, nhs


def test_cases_run_on_the_port():
    assert _bal.Planner.__module__ == "dragonboat_tpu_torch.balance.planner"
    assert _gw.Gateway is Gateway
    assert _ref_bal.Planner.__module__ == "dragonboat_tpu.balance.planner"
    reset_inproc_network()
    nh = _balance_host(1)
    try:
        assert type(nh.engine.step_engine).__module__ == (
            "dragonboat_tpu_torch.ops.engine")
    finally:
        nh.close()


# ---------------------------------------------------------------------------
# test_balance.py on the port
# ---------------------------------------------------------------------------
class TestPlannerDeterminism(_bal.TestPlannerDeterminism):
    pass


class TestPlannerInvariants(_bal.TestPlannerInvariants):
    pass


class TestSpreadHotPlanner(_bal.TestSpreadHotPlanner):
    pass


class TestExecutorSequencing(_bal.TestExecutorSequencing):
    pass


class TestDrainAcceptance(_bal.TestDrainAcceptance):
    pass


class TestBalanceChaos(_bal.TestBalanceChaos):
    @pytest.fixture(autouse=True)
    def _port_engine_hosts(self, monkeypatch):
        monkeypatch.setattr(_bal, "make_host", _balance_host)


def test_replace_move_on_the_port_engine():
    """A Balancer move on hosts stepping through the port's engine: the
    leader's replica of a shard under traffic is replaced by one on a
    fourth host (add, catch-up, leadership transfer, remove); the shard
    keeps every acknowledged write and commits after the move."""
    reset_inproc_network()
    nhs = {_bal.HOSTS[i]: _balance_host(i) for i in _bal.HOSTS}
    members = {r: _bal.HOSTS[r] for r in (1, 2, 3)}
    for r, key in members.items():
        nhs[key].start_replica(members, False, _bal.KVStore,
                               _bal.shard_cfg(1, r))
    b = _bal.make_balancer(nhs)
    try:
        lid = _bal.wait_for_leader(
            {k: nhs[k] for k in members.values()}, timeout=30.0)
        api = nhs[members[lid]]
        s = api.get_noop_session(1)
        for i in range(5):
            propose_with_retry(api, s, _bal.set_cmd(f"pre{i}", b"v"),
                               timeout=20.0)
        view = b.view()
        move = _bal.Move(kind="replace", shard_id=1, src_host=members[lid],
                         src_replica_id=lid, dst_host=_bal.HOSTS[4],
                         new_replica_id=view.shard(1).next_replica_id)
        b.executor.execute(move, view)
        m = nhs[_bal.HOSTS[4]].get_shard_membership(1)
        assert set(m.addresses) == {1, 2, 3, 4} - {lid} | {
            move.new_replica_id}
        assert lid not in m.addresses
        live = {k: nh for k, nh in nhs.items() if k != members[lid]}
        assert_recovery_sla(live, shard_id=1,
                            cmd=_bal.set_cmd("post", b"ok"))
        for key, nh in live.items():
            sm = nh._nodes[1].sm.managed.sm
            deadline = time.time() + 20.0
            while sm.data.get("post") != b"ok":
                assert time.time() < deadline, key
                time.sleep(0.05)
            assert all(sm.data.get(f"pre{i}") == b"v" for i in range(5))
        for nh in nhs.values():
            st = nh.engine.step_engine.stats
            assert st["device_steps"] > 0 and st["divergence_halts"] == 0
    finally:
        b.stop()
        for nh in nhs.values():
            nh.close()


def _views(mod):
    """The same cluster views, built with one package's balance classes
    (``test_balance.py``'s ``mk_view`` / ``mk_shard``): a drain, a dead
    host, a joined host, skewed leaders, per-host chip weights, and a
    hot shard's load rows."""
    mk_shard, mk_view = mod.mk_shard, mod.mk_view
    three = [(1, "h1"), (2, "h2"), (3, "h3")]
    drain = mk_view(["h1", "h2", "h3", "h4"],
                    [mk_shard(i, three, leader_rid=1) for i in range(1, 9)],
                    draining=["h1"])
    dead = mk_view(["h1", "h2", "h4"],
                   [mk_shard(i, three, leader_rid=1 + i % 3)
                    for i in range(1, 6)])
    join = mk_view(["h1", "h2", "h3", "h4", "h5"],
                   [mk_shard(i, three, leader_rid=1 + i % 2)
                    for i in range(1, 11)])
    skew = mk_view(["h1", "h2", "h3"],
                   [mk_shard(i, three, leader_rid=1) for i in range(1, 7)])
    chips = dataclasses.replace(join, chips=(("h4", 4), ("h5", 2)))
    hot = dataclasses.replace(skew, load=tuple(
        mod.ShardLoad(shard_id=i, p99_ms=10 * i, samples=20,
                      submitted=100 * i, shed=i % 2)
        for i in range(1, 7)))
    return {"drain": drain, "dead": dead, "join": join, "skew": skew,
            "chips": chips, "hot": hot}


@pytest.mark.parametrize("seed", [_bal.SEED, 7])
@pytest.mark.parametrize("name", ["drain", "dead", "join", "skew", "chips",
                                  "hot"])
def test_same_view_same_plan_in_both_packages(name, seed):
    got_view, ref_view = _views(_bal)[name], _views(_ref_bal)[name]
    assert got_view.describe() == ref_view.describe()
    got = _bal.Planner(seed=seed).plan(got_view)
    want = _ref_bal.Planner(seed=seed).plan(ref_view)
    assert got.describe() == want.describe()
    assert len(got) > 0 or name == "hot"
    got_hot = _bal.Planner(seed=seed).plan_spread_hot(got_view, [1, 2])
    want_hot = _ref_bal.Planner(seed=seed).plan_spread_hot(ref_view, [1, 2])
    assert got_hot.describe() == want_hot.describe()


# ---------------------------------------------------------------------------
# the chip dimension: one Collector view of a 4-block mesh, both packages
# ---------------------------------------------------------------------------
def _join_one_by_one(nhs, core, sm, config, shards):
    """Start every replica in a fixed order, each only after the one
    before holds its engine row: the mesh placement (shard affinity, the
    striped free list) then depends on nothing but that order."""
    for nh in nhs.values():
        nh.pause_ticks()  # no election: the view's applied/leader stay 0
    for s in shards:
        for r, (key, nh) in enumerate(sorted(nhs.items()), start=1):
            nh.start_replica({i: k for i, k in enumerate(sorted(nhs), 1)},
                             False, sm, config(replica_id=r, shard_id=s))
            deadline = time.time() + 30.0
            while core().device_coordinate(s, r) is None:
                assert time.time() < deadline, (key, s, r)
                time.sleep(0.01)


def _replica_devices(view):
    return {(s.shard_id, r.replica_id): (r.host, r.device)
            for s in view.shards for r in s.replicas}


CHIP_GEOM = dict(capacity=16, P=3, W=16, M=8, E=4, O=32, budget=4)
CHIP_SHARDS = (1, 2, 3, 4, 5)  # four fill a 4-row block each; one straddles


def test_collector_view_of_a_mesh_matches_reference(monkeypatch):
    import jax
    from jax.sharding import Mesh

    hosts = [f"{TAG}-chip-{r}" for r in (1, 2, 3)]
    # port: three hosts sharing one colocated engine on 4 CPU blocks
    reset_inproc_network()
    group = ColocatedEngineGroup(**CHIP_GEOM, mesh=GroupsMesh(["cpu"] * 4))
    port = {}
    for key in hosts:
        d = f"{TMP}/nh-{key}"
        shutil.rmtree(d, ignore_errors=True)
        port[key] = NodeHost(NodeHostConfig(
            nodehost_dir=d, rtt_millisecond=RTT_MS, raft_address=key,
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=1),
                step_engine_factory=group.factory)))
    try:
        _join_one_by_one(port, lambda: group.core, _bal.KVStore,
                         _bal.Config, CHIP_SHARDS)
        got = Collector().collect(port)
    finally:
        for nh in port.values():
            nh.close()
    # reference: the same on a 4-device jax mesh; no step ever runs (the
    # ticks stay paused), so its programs need no warm-up compile
    from dragonboat_tpu.transport.inproc import \
        reset_inproc_network as ref_reset

    monkeypatch.setattr(ref_colocated.ColocatedVectorEngine, "_warm",
                        lambda self: None)
    ref_reset()
    rgroup = ref_colocated.ColocatedEngineGroup(**CHIP_GEOM, mesh=Mesh(
        np.asarray(jax.devices("cpu")[:4]), ("groups",)))
    theirs = {}
    for key in hosts:
        d = f"{TMP}/nh-tbr-{key}"
        shutil.rmtree(d, ignore_errors=True)
        theirs[key] = ref.NodeHost(ref.NodeHostConfig(
            nodehost_dir=d, rtt_millisecond=RTT_MS, raft_address=key,
            expert=ref.ExpertConfig(
                engine=ref.EngineConfig(exec_shards=1, apply_shards=1),
                step_engine_factory=rgroup.factory)))
    try:
        _join_one_by_one(theirs, lambda: rgroup.core, _ref_bal.KVStore,
                         _ref_bal.Config, CHIP_SHARDS)
        want = _ref_bal.Collector().collect(theirs)
    finally:
        for nh in theirs.values():
            nh.close()
    assert _replica_devices(got) == _replica_devices(want)
    assert got.chips == want.chips == tuple((k, 4) for k in hosts)
    assert got.describe() == want.describe()
    devs = _replica_devices(got)
    assert len(devs) == 3 * len(CHIP_SHARDS)
    assert {d for _, d in devs.values()} == {0, 1, 2, 3}
    # the fifth shard straddles blocks
    assert len({devs[(5, r)][1] for r in (1, 2, 3)}) > 1


# ---------------------------------------------------------------------------
# test_gateway.py on the port
# ---------------------------------------------------------------------------
class TestRoutingCache(_gw.TestRoutingCache):
    pass


class TestRaftLease(_gw.TestRaftLease):
    pass


class TestAdmission(_gw.TestAdmission):
    pass


class TestGatewayEndToEnd(_gw.TestGatewayEndToEnd):
    pass


class TestLeaseReads(_gw.TestLeaseReads):
    pass


class TestOverload(_gw.TestOverload):
    pass


RPC_PORTS = {1: 26610, 2: 26611, 3: 26612}


def test_rpc_round_trip_through_a_gateway():
    """``test_rpc.py``'s gateway-over-RPC fleet, without its leader kill:
    each port host behind an ``RpcServer`` on a fixed TCP port, a
    ``Gateway`` over ``RemoteHostHandle``s proposing through an
    exactly-once handle and reading back (linearizable and lease)."""
    addrs, nhs = _colocated_cluster(AuditKV, "rpc")
    srvs, handles, gw = {}, {}, None
    try:
        for r, a in addrs.items():
            srvs[a] = RpcServer(nhs[a], f"127.0.0.1:{RPC_PORTS[r]}")
            srvs[a].start()
            assert srvs[a].listen_address.endswith(f":{RPC_PORTS[r]}")
            handles[a] = RemoteHostHandle(srvs[a].listen_address,
                                          rtt_millisecond=COLO_RTT_MS)
        gw = Gateway(dict(handles), GatewayConfig(
            workers=2, default_timeout=10.0, cap_feedback=False))
        h = gw.connect(1, timeout=30.0)
        for i in range(5):
            h.sync_propose(audit_set_cmd(f"k{i}", str(i)), timeout=15.0)
        assert [gw.read(1, f"k{i}", timeout=10.0) for i in range(5)] == [
            "0", "1", "2", "3", "4"]
        leader = _gw.wait_leader(nhs)
        deadline = time.time() + 10.0
        while True:
            ok, val = handles[leader].try_lease_read(1, "k4")
            if ok:
                assert val == "4"
                break
            assert time.time() < deadline, "lease never held over RPC"
            time.sleep(0.05)
        gw.close_handle(h)
        st = gw.stats()
        assert st["committed"] >= 5, st
    finally:
        if gw is not None:
            gw.close()
        for h in handles.values():
            h.close()
        for s in srvs.values():
            s.close()
        for nh in nhs.values():
            nh.close()
