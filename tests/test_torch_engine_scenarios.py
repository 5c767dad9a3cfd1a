"""The reference's engine scenarios on the port's engine.

``test_vector_engine.py``'s ``TestVectorQuiesce``, ``TestDeviceReadIndex``
and ``TestCheckQuorumGrace``, with every NodeHost stepping its shards
through ``torch_step_engine_factory(device="cpu")`` (the plain PyTorch
versions of the kernels) and the protocol harness of
``tests/raft_harness.py`` loaded from its source onto the port's ``pb``
and ``raft``.  The clocks are those of ``test_torch_engine.py`` (rtt
20 ms, election_rtt 20): the eager torch step is slower a launch than
JAX's compiled CPU step.
"""
from __future__ import annotations

import time

from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

from test_torch_engine import (
    ADDRS,
    PortKV,
    make_nodehost,
    propose_r,
    read_r,
    set_cmd,
    shard_config,
    stats,
    wait_for_leader,
)
from test_torch_storage import load_on_port


def _cluster(tmp_path, rtt_ms=20, **cfg_kw):
    reset_inproc_network()
    nhs = {rid: make_nodehost(rid, tmp_path, rtt_ms=rtt_ms) for rid in ADDRS}
    for rid, nh in nhs.items():
        cfg = shard_config(rid, **{k: v for k, v in cfg_kw.items()
                                   if k != "quiesce"})
        cfg.quiesce = cfg_kw.get("quiesce", False)
        nh.start_replica(ADDRS, False, PortKV, cfg)
    return nhs


class TestVectorQuiesce:
    def test_idle_shard_quiesces_on_device(self, tmp_path):
        """Quiesce-enabled rows stay device-resident: after the idle
        threshold the shard exchanges no messages, its hosts park it and
        its logical clock freezes, and a proposal wakes it back up."""
        nhs = _cluster(tmp_path, quiesce=True)
        try:
            wait_for_leader(nhs)
            s = nhs[1].get_noop_session(1)
            propose_r(nhs[1], s, set_cmd("q0", b"v"))
            # idle threshold = election_rtt * 10 = 200 ticks (4 s at 20 ms)
            deadline = time.time() + 40.0
            while time.time() < deadline:
                if all(nh._nodes[1].quiesce.is_quiesced()
                       for nh in nhs.values()):
                    break
                time.sleep(0.1)
            else:
                raise AssertionError(
                    "never quiesced: "
                    f"{[nh._nodes[1].quiesce.quiesced for nh in nhs.values()]}")
            # one fully quiet window (straggler messages may still drain
            # right after entry)
            for _ in range(10):
                sent0 = {r: nh.transport.metrics["sent"]
                         for r, nh in nhs.items()}
                time.sleep(0.5)
                sent1 = {r: nh.transport.metrics["sent"]
                         for r, nh in nhs.items()}
                if sent0 == sent1 and all(
                        nh._nodes[1].quiesce.is_quiesced()
                        for nh in nhs.values()):
                    break
            else:
                raise AssertionError(
                    f"no quiet window while quiesced: {sent0} -> {sent1}")
            # a quiesced idle node parks and its logical clock freezes
            deadline = time.time() + 20.0
            while time.time() < deadline and not all(
                    1 in nh._parked for nh in nhs.values()):
                time.sleep(0.1)
            assert all(1 in nh._parked for nh in nhs.values())
            tc0 = {r: nh._nodes[1].tick_count for r, nh in nhs.items()}
            time.sleep(0.5)
            tc1 = {r: nh._nodes[1].tick_count for r, nh in nhs.items()}
            assert tc0 == tc1, (tc0, tc1)
            propose_r(nhs[1], s, set_cmd("q1", b"w"))  # wakes the shard
            assert 1 not in nhs[1]._parked
            propose_r(nhs[2], s, set_cmd("q1", b"w"), deadline=15.0)
            assert read_r(nhs[3], 1, "q1") == b"w"
            assert not nhs[1]._nodes[1].quiesce.is_quiesced()
            st = stats(nhs)
            assert all(v["divergence_halts"] == 0 for v in st.values()), st
        finally:
            for nh in nhs.values():
                nh.close()


class TestDeviceReadIndex:
    def test_reads_stay_device_resident(self, tmp_path):
        """sync_read on the leader's host rides the kernel's ReadIndex
        path (ctx heartbeats and echo confirmations, no row moved to the
        host) for most reads: a batch too big for the M=8 inbox falls
        back to the host path by design, so the bound is 5 of 10."""
        nhs = _cluster(tmp_path, heartbeat_rtt=3)
        try:
            lid = wait_for_leader(nhs)
            nh = nhs[lid]
            s = nh.get_noop_session(1)
            r = propose_r(nh, s, set_cmd("dev-read", b"42"))
            assert r.value >= 1
            time.sleep(0.5)  # the commit barrier and a few heartbeats
            st0 = nh.engine.step_engine.stats_snapshot()
            for _ in range(10):
                assert read_r(nh, 1, "dev-read") == b"42"
                time.sleep(0.05)
            st1 = nh.engine.step_engine.stats_snapshot()
            assert st1["device_reads"] - st0["device_reads"] >= 5, (st0, st1)
        finally:
            for h in nhs.values():
                h.close()

    def test_follower_reads_still_work(self, tmp_path):
        """Reads through followers forward on the scalar path and still
        complete linearizably."""
        nhs = _cluster(tmp_path)
        try:
            lid = wait_for_leader(nhs)
            nh = nhs[lid]
            s = nh.get_noop_session(1)
            propose_r(nh, s, set_cmd("f-read", b"7"))
            for other in nhs.values():
                assert read_r(other, 1, "f-read") == b"7"
        finally:
            for h in nhs.values():
                h.close()


class TestCheckQuorumGrace:
    """The residency-boundary CheckQuorum grace of ``TorchStepEngine``
    DELAYS the check and never fabricates activity: a minority-
    partitioned leader crossing the boundary once a window still steps
    down, and a healthy one stays."""

    @staticmethod
    def _leader_net():
        harness = load_on_port("raft_harness.py", "torch_raft_harness")
        net = harness.Network.of(3, check_quorum=True)
        net.elect(1)
        return net

    def test_partitioned_oscillating_leader_steps_down(self):
        from dragonboat_tpu_torch.ops.engine import TorchStepEngine
        from dragonboat_tpu_torch.pb import Message, MessageType
        from dragonboat_tpu_torch.raft.raft import RaftRole

        net = self._leader_net()
        r = net.peers[1]
        net.isolate(1)
        for _window in range(4):
            TorchStepEngine._cq_grace(r)
            for _ in range(r.election_timeout + 1):
                r.handle(Message(type=MessageType.LOCAL_TICK))
                r.drain_messages()  # discarded: the leader is partitioned
            if r.role != RaftRole.LEADER:
                break
        assert r.role != RaftRole.LEADER, (
            "grace masked a lost quorum for 4 consecutive windows")

    def test_healthy_oscillating_leader_stays(self):
        from dragonboat_tpu_torch.ops.engine import TorchStepEngine
        from dragonboat_tpu_torch.raft.raft import RaftRole

        net = self._leader_net()
        r = net.peers[1]
        assert type(r).__module__ == "dragonboat_tpu_torch.raft.raft"
        for window in range(4):
            TorchStepEngine._cq_grace(r)
            net.tick_all(r.election_timeout + 1)
            assert r.role == RaftRole.LEADER, f"stepped down in window {window}"
