"""The port's NodeHost with the carried observability and TCP/gossip modules.

``obs/slo.py``, ``obs/fleetscope.py``, ``obs/__init__.py``,
``transport/tcp.py`` and ``transport/gossip.py`` are byte-identical
copies of the reference's (``tests/test_torch_isolation.py`` holds them
so).  These are the reference's own cases, run on
``dragonboat_tpu_torch``'s NodeHost on the CPU:

* ``NodeHost.dump_timeline()`` of a host without tracing is ``""``
  (``tests/test_obs.py`` ``TestConfigGates.test_disabled_by_default``),
  and a traced three-host cluster's timeline shows the proposals' spans
  and the election (``TestNodeHostSurface.test_dump_export_and_gauges``);
* three hosts addressed by their nodehost ids over TCP and gossip elect
  a leader and commit a proposal that a follower reads back
  (``tests/test_aux.py`` ``nhid_cluster`` /
  ``TestNodeHostIDAddressing``), and a plain TCP cluster does the same
  (``tests/test_tcp_transport.py`` ``TestTCPCluster``).

Ports: the reference's tests bind 27301-27303, 27401-27403 and
28401-28403, and pytest-xdist may run their files beside this one, so
these clusters bind 26501-26503 (raft, nodehost-id cluster), 26511-26513
(its gossip) and 26521-26523 (the TCP cluster): below the kernel's
ephemeral range and used by no other test of the repo.
"""
from __future__ import annotations

import json
import time

import pytest

from dragonboat_tpu_torch.config import (
    EngineConfig,
    ExpertConfig,
    GossipConfig,
    NodeHostConfig,
)
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.transport.inproc import reset_inproc_network
from dragonboat_tpu_torch.transport.tcp import tcp_transport_factory
from test_torch_engine import (
    PortKV,
    propose_r,
    read_r,
    set_cmd,
    shard_config,
    wait_for_leader,
)

NHID_PORTS = {1: 26501, 2: 26502, 3: 26503}
NHID_GOSSIP = {1: 26511, 2: 26512, 3: 26513}
TCP_ADDRS = {1: "127.0.0.1:26521", 2: "127.0.0.1:26522",
             3: "127.0.0.1:26523"}
OBS_ADDRS = {1: "tobs-1", 2: "tobs-2", 3: "tobs-3"}


def _engine():
    return EngineConfig(exec_shards=2, apply_shards=2)


def _close_all(nhs):
    for nh in nhs.values():
        nh.close()


def test_dump_timeline_disabled_by_default(tmp_path):
    nh = NodeHost(NodeHostConfig(
        nodehost_dir=str(tmp_path), raft_address="tobs-gate-1",
    ))
    try:
        assert nh.tracer is None and nh.recorder is None
        assert nh.dump_timeline() == ""
        assert json.loads(nh.export_trace_json()) == {"traceEvents": []}
    finally:
        nh.close()


def test_traced_cluster_timeline(tmp_path):
    reset_inproc_network()
    nhs = {
        rid: NodeHost(NodeHostConfig(
            nodehost_dir=str(tmp_path / f"nh-{rid}"),
            rtt_millisecond=5,
            raft_address=addr,
            enable_tracing=True,
            trace_sample_rate=1.0,
            enable_flight_recorder=True,
            expert=ExpertConfig(engine=_engine()),
        ))
        for rid, addr in OBS_ADDRS.items()
    }
    try:
        for rid, nh in nhs.items():
            nh.start_replica(OBS_ADDRS, False, PortKV, shard_config(rid))
        lid = wait_for_leader(nhs)
        leader = nhs[lid]
        s = leader.get_noop_session(1)
        for i in range(3):
            propose_r(leader, s, set_cmd(f"d{i}", b"v"))
        out = leader.dump_timeline(shard_id=1)
        assert "span:propose" in out and "leader_change" in out
        path = tmp_path / "trace.json"
        data = json.loads(leader.export_trace_json(str(path)))
        assert data["traceEvents"]
        assert json.loads(path.read_text()) == data
    finally:
        _close_all(nhs)


@pytest.fixture
def nhid_cluster(tmp_path):
    seed = f"127.0.0.1:{NHID_GOSSIP[1]}"
    nhs = {}
    try:
        for rid, port in NHID_PORTS.items():
            nhs[rid] = NodeHost(NodeHostConfig(
                nodehost_dir=str(tmp_path / f"nh-id-{rid}"),
                rtt_millisecond=5,
                raft_address=f"127.0.0.1:{port}",
                address_by_nodehost_id=True,
                gossip=GossipConfig(
                    bind_address=f"127.0.0.1:{NHID_GOSSIP[rid]}",
                    seed=[seed],
                ),
                expert=ExpertConfig(
                    engine=_engine(),
                    transport_factory=tcp_transport_factory,
                ),
            ))
        yield nhs
    finally:
        _close_all(nhs)


def test_cluster_by_nodehost_id(nhid_cluster):
    nhs = nhid_cluster
    members = {rid: nh.nodehost_id for rid, nh in nhs.items()}
    assert all(m.startswith("nhid-") for m in members.values())
    for rid, nh in nhs.items():
        nh.start_replica(members, False, PortKV, shard_config(rid))
    wait_for_leader(nhs)
    s = nhs[1].get_noop_session(1)
    propose_r(nhs[1], s, set_cmd("gk", b"gv"))
    assert read_r(nhs[3], 1, "gk") == b"gv"


@pytest.fixture
def tcp_cluster(tmp_path):
    nhs = {}
    try:
        for rid, addr in TCP_ADDRS.items():
            nhs[rid] = NodeHost(NodeHostConfig(
                nodehost_dir=str(tmp_path / f"nh-tcp-{rid}"),
                rtt_millisecond=5,
                raft_address=addr,
                expert=ExpertConfig(
                    engine=_engine(),
                    transport_factory=tcp_transport_factory,
                ),
            ))
        for rid, nh in nhs.items():
            nh.start_replica(TCP_ADDRS, False, PortKV, shard_config(rid))
        yield nhs
    finally:
        _close_all(nhs)


def test_tcp_cluster_elect_propose_read(tcp_cluster):
    wait_for_leader(tcp_cluster)
    nh = tcp_cluster[1]
    s = nh.get_noop_session(1)
    propose_r(nh, s, set_cmd("k", b"v"))
    deadline = time.time() + 10.0
    while True:
        try:
            assert tcp_cluster[3].sync_read(1, "k", timeout=2.0) == b"v"
            break
        except AssertionError:
            raise
        except Exception:  # noqa: BLE001 — retried like the reference's case
            if time.time() > deadline:
                raise
            time.sleep(0.05)
