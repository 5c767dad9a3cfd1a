"""The port's colocated product path: ``ColocatedEngineGroup(device="cpu")``.

The cases of ``test_colocated.py`` on the port: three NodeHosts of
``dragonboat_tpu_torch`` in one process share ONE ``ColocatedTorchEngine``
(the plain PyTorch versions of the kernels), with the port's default
logdb, tan.  Consensus routes on the device state, payloads reconstruct
through the shared entry cache, the cold paths (reads, membership,
restart) still work, whole-shard rebases keep the device path in use, a
shard whose log starts past 2^31 commits on the device path, and the
entry cache's publish rules hold.  Pipeline depth 1
and 2 and fused waves of 1 and 3 rounds apply the same commands, and a
lockstep case runs the same scripted proposals on a JAX colocated
cluster of the reference package and on a port cluster: the same
applied commands and state machine contents on every replica.  Every
cluster ends with ``divergence_halts == 0``.

The eager torch step is slower per launch than JAX's compiled CPU step,
so the clocks are those of ``test_torch_engine.py`` (rtt 20 ms,
election_rtt 20) and client calls retry.
Under ``DRAGONBOAT_TPU_JITCHECK=1`` every case runs under the port's
post-warm-up sentry (``test_torch_jitcheck.port_stall_sentry``), as the
reference's conftest arms its recompile sentry over its engine modules.
"""
from __future__ import annotations

import time

import pytest
import torch

from dragonboat_tpu_torch.config import (
    Config,
    EngineConfig,
    ExpertConfig,
    NodeHostConfig,
)
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup
from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

from test_torch_engine import (
    ADDRS,
    SCRIPT,
    PortKV,
    make_kv,
    propose_r,
    read_r,
    set_cmd,
    wait_for_leader,
)

from test_torch_jitcheck import port_stall_sentry  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_stall_sentry")

GEOM = dict(capacity=16, P=5, W=32, M=8, E=4, O=32, budget=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: faster here,
    and it leaves the other cores to the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def colo_shard_config(rid, shard_id=1, **kw):
    kw.setdefault("election_rtt", 20)
    kw.setdefault("heartbeat_rtt", 2)
    kw.setdefault("pre_vote", True)
    kw.setdefault("check_quorum", True)
    return Config(replica_id=rid, shard_id=shard_id, **kw)


def make_colocated_cluster(tmp_path, rtt_ms=20, parity_every=4, **geom):
    """Three port NodeHosts on one ColocatedEngineGroup (device="cpu",
    the default tan logdb); every ``parity_every``-th launch re-runs its
    programs through the plain versions (the self-check)."""
    reset_inproc_network()
    group = ColocatedEngineGroup(**dict(GEOM, **geom), device="cpu",
                                 parity_every=parity_every)
    nhs = {
        rid: NodeHost(NodeHostConfig(
            nodehost_dir=str(tmp_path / f"nh-colo-{rid}"),
            rtt_millisecond=rtt_ms,
            raft_address=ADDRS[rid],
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=2),
                step_engine_factory=group.factory,
            ),
        ))
        for rid in ADDRS
    }
    return group, nhs


def start_shards(nhs, shards=(1,), sm=PortKV):
    for shard in shards:
        for rid, nh in nhs.items():
            nh.start_replica(ADDRS, False, sm,
                             colo_shard_config(rid, shard_id=shard))


def assert_healthy(group):
    st = group.core.stats_snapshot()
    assert st["divergence_halts"] == 0, st
    assert st["parity_failures"] == 0, group.core.parity_failure
    return st


@pytest.fixture
def ccluster(tmp_path):
    group, nhs = make_colocated_cluster(tmp_path)
    start_shards(nhs)
    yield group, nhs
    for nh in nhs.values():
        nh.close()
    assert_healthy(group)


def transport_sent(nhs):
    return {r: nh.transport.metrics["sent"] for r, nh in nhs.items()}


class TestColocatedCluster:
    def test_one_shared_core(self, ccluster):
        group, nhs = ccluster
        cores = {id(nh.engine.step_engine.core) for nh in nhs.values()}
        assert len(cores) == 1
        assert nhs[1].engine.step_engine.core is group.core

    def test_consensus_routes_on_device(self, ccluster):
        group, nhs = ccluster
        wait_for_leader(nhs)
        nh = nhs[1]
        s = nh.get_noop_session(1)
        for i in range(20):
            propose_r(nh, s, set_cmd(f"k{i}", str(i).encode()))
        for rid in ADDRS:
            assert read_r(nhs[rid], 1, "k19") == b"19"
        st = assert_healthy(group)
        assert st["routed_delivered"] > 0, st
        assert st["launches"] > 0, st
        # the self-check re-ran programs of every kernel, all equal
        for k in ("raft_step", "route", "inbox", "select_and_blob"):
            assert st[f"parity_checks_{k}"] == st[f"parity_attempts_{k}"] > 0

    def test_steady_state_transport_is_quiet(self, ccluster):
        """Once every row is device-resident, heartbeats and replication
        ride the device route: the host transport goes silent while
        routed traffic keeps flowing."""
        group, nhs = ccluster
        wait_for_leader(nhs)
        s = nhs[1].get_noop_session(1)
        propose_r(nhs[1], s, set_cmd("warm", b"1"))
        time.sleep(1.0)
        for _ in range(20):
            sent0 = transport_sent(nhs)
            routed0 = group.core.stats["routed_delivered"]
            time.sleep(1.0)
            wire = sum(transport_sent(nhs).values()) - sum(sent0.values())
            routed = group.core.stats["routed_delivered"] - routed0
            if routed > 0 and wire == 0:
                return
        raise AssertionError(
            f"no quiet-wire window: wire delta {wire}, routed {routed}"
        )

    def test_payloads_survive_follower_apply(self, ccluster):
        """Routed REPLICATE carries no cmd bytes; followers must apply
        the true payload (cache reconstruction), not empty noops."""
        group, nhs = ccluster
        wait_for_leader(nhs)
        s = nhs[1].get_noop_session(1)
        blob = bytes(range(256)) * 4
        propose_r(nhs[1], s, set_cmd("blob", blob))
        deadline = time.time() + 20.0
        while time.time() < deadline:
            try:
                if all(nhs[r].stale_read(1, "blob") == blob for r in ADDRS):
                    return
            except Exception:  # noqa: BLE001 — not applied yet
                pass
            time.sleep(0.05)
        raise AssertionError("followers never applied the routed payload")

    def test_reads_and_membership_cold_paths(self, ccluster):
        from test_nodehost import add_non_voting_poll

        group, nhs = ccluster
        wait_for_leader(nhs)
        nh = nhs[1]
        s = nh.get_noop_session(1)
        propose_r(nh, s, set_cmd("pre", b"1"))
        for rid in ADDRS:
            assert read_r(nhs[rid], 1, "pre") == b"1"
        m2 = add_non_voting_poll(nh, 1, 9, "nh-9")
        assert 9 in m2.non_votings
        propose_r(nh, s, set_cmd("post", b"2"))
        assert read_r(nh, 1, "post") == b"2"

    def test_replica_restart_rejoins_device(self, ccluster):
        group, nhs = ccluster
        wait_for_leader(nhs)
        s = nhs[1].get_noop_session(1)
        for i in range(5):
            propose_r(nhs[1], s, set_cmd(f"r{i}", str(i).encode()))
        nhs[3].stop_replica(1, 3)
        propose_r(nhs[1], s, set_cmd("while-down", b"x"), deadline=30.0)
        nhs[3].start_replica(ADDRS, False, PortKV, colo_shard_config(3))
        deadline = time.time() + 30.0
        while time.time() < deadline:
            try:
                if nhs[3].stale_read(1, "while-down") == b"x":
                    break
            except Exception:  # noqa: BLE001 — not applied yet
                pass
            time.sleep(0.05)
        else:
            raise AssertionError("restarted replica never caught up")
        propose_r(nhs[1], s, set_cmd("after", b"y"))
        assert read_r(nhs[3], 1, "after") == b"y"

    def test_multi_shard_routing(self, ccluster):
        group, nhs = ccluster
        start_shards(nhs, shards=(2, 3))
        for shard in (1, 2, 3):
            wait_for_leader(nhs, shard_id=shard, timeout=30.0)
            s = nhs[1].get_noop_session(shard)
            propose_r(nhs[1], s, set_cmd(f"s{shard}", bytes([shard])),
                      deadline=30.0)
        for shard in (1, 2, 3):
            assert read_r(nhs[2], shard, f"s{shard}") == bytes([shard])


def test_multi_rebase_under_traffic(tmp_path):
    """A tiny rebase_chunk forces several whole-shard rebases while
    routed consensus traffic flows; every write stays readable on every
    member and the device path stays in use."""
    group, nhs = make_colocated_cluster(tmp_path, rebase_chunk=32)
    try:
        start_shards(nhs)
        wait_for_leader(nhs)
        s = nhs[1].get_noop_session(1)
        for i in range(100):
            propose_r(nhs[1], s, set_cmd(f"rb{i}", str(i).encode()))
        core = group.core
        with core._lock:
            rebases = core.stats["shard_rebases"]
            base = core._shard_base.get(1, 0)
        assert rebases >= 2, core.stats
        assert base > 0 and base % GEOM["W"] == 0
        assert core.stats["routed_delivered"] > 0
        for rid in ADDRS:
            assert read_r(nhs[rid], 1, "rb99") == b"99"
    finally:
        for nh in nhs.values():
            nh.close()
    assert_healthy(group)


def test_commits_across_2_31_on_device(tmp_path):
    """A shard imported from a snapshot whose log begins past 2^31
    elects, establishes a shared shard base and commits client writes on
    the device path at absolute indexes > 2^31."""
    import io
    import os
    import pickle

    from dragonboat_tpu_torch import tools
    from dragonboat_tpu_torch.pb import Membership, Snapshot
    from dragonboat_tpu_torch.rsm.session import SessionManager
    from dragonboat_tpu_torch.storage.snapshotio import SnapshotWriter
    from dragonboat_tpu_torch.transport.wire import encode_snapshot_meta

    B31 = 2**31
    export_dir = str(tmp_path / "export")
    os.makedirs(export_dir)
    membership = Membership(config_change_id=1, addresses=dict(ADDRS))
    buf = io.BytesIO()
    w = SnapshotWriter(
        buf, index=B31 + 100, term=3, membership=membership,
        sessions=SessionManager().serialize(), on_disk=False,
    )
    w.write(pickle.dumps(({"seed": b"s"}, [])))  # PortKV.save_snapshot
    w.close()
    payload = buf.getvalue()
    with open(f"{export_dir}/snapshot.bin", "wb") as f:
        f.write(payload)
    meta = Snapshot(index=B31 + 100, term=3, membership=membership,
                    shard_id=1, file_size=len(payload))
    with open(f"{export_dir}/META", "wb") as f:
        f.write(encode_snapshot_meta(meta))

    group, nhs = make_colocated_cluster(tmp_path)
    try:
        for rid, nh in nhs.items():
            tools.import_snapshot(nh, export_dir, 1, rid, dict(ADDRS))
            nh.start_replica(ADDRS, False, PortKV, colo_shard_config(rid))
        wait_for_leader(nhs, timeout=60.0)
        s = nhs[1].get_noop_session(1)
        for i in range(20):
            propose_r(nhs[1], s, set_cmd(f"hi{i}", str(i).encode()))
        core = group.core
        with core._lock:
            base = core._shard_base.get(1, 0)
            stepped = core.stats["device_rows_stepped"]
        committed = nhs[1]._nodes[1].peer.raft.log.committed
        assert committed > B31 + 100, committed
        assert base > B31, f"shard base never established: {base}"
        assert base % GEOM["W"] == 0
        assert stepped > 0
        for rid in ADDRS:
            assert read_r(nhs[rid], 1, "hi19") == b"19"
            assert read_r(nhs[rid], 1, "seed") == b"s"
    finally:
        for nh in nhs.values():
            nh.close()
    assert_healthy(group)


class TestEntryCachePublishing:
    """The shared entry cache's publish rules."""

    def test_witness_row_never_publishes_stripped_entries(self):
        """A witness's own log holds stripped metadata entries under the
        SAME (index, term) keys as the real ones; its upload must not
        publish them over the real payloads."""
        from dragonboat_tpu_torch.pb import Entry, EntryType
        from dragonboat_tpu_torch.raft.raft import Raft

        group = ColocatedEngineGroup(**GEOM, device="cpu")
        group.factory(None)
        eng = group.core
        real = [
            Entry(term=1, index=i, type=EntryType.APPLICATION,
                  cmd=f"cmd{i}".encode())
            for i in range(1, 6)
        ]
        voter = Raft(1, 1, {1: "a", 2: "b"}, witnesses={3: "c"})
        voter.log.inmem.merge(real)
        eng._publish_ring_window(voter)
        assert eng._cache_lookup(voter, 3, 1).cmd == b"cmd3"
        witness = Raft(1, 3, {1: "a", 2: "b"}, witnesses={3: "c"},
                       is_witness=True)
        witness.log.inmem.merge([Raft._to_witness_entry(e) for e in real])
        eng._publish_ring_window(witness)
        assert eng._cache_lookup(voter, 3, 1).cmd == b"cmd3"
        got = eng._cache_lookup(witness, 3, 1)
        assert got.cmd == b"" and got.type == EntryType.METADATA

    def test_cache_depth_covers_launch_append_volume(self):
        group = ColocatedEngineGroup(**dict(GEOM, W=4, M=8, E=4),
                                     device="cpu")
        group.factory(None)
        assert group.core._cache_depth >= 8 * 8 * 4


def _run_script(nhs, shard=1):
    """SCRIPT's proposals, each acknowledged before the next, spread
    over the leader and the followers; then every replica's applied
    commands and data."""
    lid = wait_for_leader(nhs, shard_id=shard, timeout=60.0)
    for i, cmd in enumerate(SCRIPT):
        nh = nhs[(lid + i) % 3 + 1]
        propose_r(nh, nh.get_noop_session(shard), cmd)
    out = {}
    for rid, nh in nhs.items():
        applied = read_r(nh, shard, "__applied__")
        deadline = time.time() + 20.0
        while len(applied) < len(SCRIPT) and time.time() < deadline:
            time.sleep(0.05)
            applied = read_r(nh, shard, "__applied__")
        out[rid] = (applied, read_r(nh, shard, "__data__"))
    return out


def _squash(applied):
    """A client retry after a lost acknowledgement may apply a command
    twice in a row (no-op sessions do not deduplicate); SCRIPT has no
    equal neighbours."""
    return [c for i, c in enumerate(applied) if i == 0 or c != applied[i - 1]]


def _assert_script_applied(res, data=None):
    data = res[1][1] if data is None else data
    for rid in ADDRS:
        assert _squash(res[rid][0]) == SCRIPT, f"replica {rid}"
        assert res[rid][1] == data, f"replica {rid} data"
    return data


@pytest.mark.parametrize("depth,rounds", [(1, 1), (2, 3)])
def test_pipeline_depth_and_fused_rounds_apply_the_script(tmp_path, depth,
                                                           rounds):
    """Depth 1 with single-round launches (the serial loop) and depth 2
    with fused 3-round waves apply SCRIPT identically on every replica,
    and the depth-2 run really fused waves and overlapped readbacks."""
    group, nhs = make_colocated_cluster(
        tmp_path, pipeline_depth=depth, fused_rounds=rounds)
    try:
        start_shards(nhs)
        res = _run_script(nhs)
    finally:
        for nh in nhs.values():
            nh.close()
    st = assert_healthy(group)
    want = {f"lk-{i % 5}": f"v{i}".encode() for i in range(12)}
    assert _assert_script_applied(res) == want
    if rounds > 1:
        assert st["fused_waves"] > 0, st
    else:
        assert st["fused_waves"] == 0, st
    if depth == 1:
        assert not group.core._inflight


def test_lockstep_with_reference_colocated_engine(tmp_path):
    """The same scripted proposals on a JAX ColocatedEngineGroup cluster
    of the reference package and on a port cluster: identical applied
    command sequences and state machine contents on all three
    replicas."""
    import dragonboat_tpu as ref
    from dragonboat_tpu.ops.colocated import (
        ColocatedEngineGroup as RefGroup,
    )
    from dragonboat_tpu.transport.inproc import (
        reset_inproc_network as ref_reset,
    )

    class RefKV(make_kv(ref.IStateMachine)):
        @staticmethod
        def _result(n):
            return ref.Result(value=n)

    ref_reset()
    rgroup = RefGroup(**GEOM)
    ref_nhs = {
        rid: ref.NodeHost(ref.NodeHostConfig(
            nodehost_dir=str(tmp_path / f"ref-{rid}"),
            rtt_millisecond=20,
            raft_address=ADDRS[rid],
            expert=ref.ExpertConfig(
                engine=ref.EngineConfig(exec_shards=1, apply_shards=2),
                step_engine_factory=rgroup.factory,
            ),
        ))
        for rid in ADDRS
    }
    try:
        for rid, nh in ref_nhs.items():
            nh.start_replica(ADDRS, False, RefKV, ref.Config(
                replica_id=rid, shard_id=1, election_rtt=20, heartbeat_rtt=2,
                pre_vote=True, check_quorum=True,
            ))
        want = _run_script(ref_nhs)
    finally:
        for nh in ref_nhs.values():
            nh.close()
    assert rgroup.core.stats["divergence_halts"] == 0

    group, nhs = make_colocated_cluster(tmp_path / "port")
    try:
        start_shards(nhs)
        got = _run_script(nhs)
    finally:
        for nh in nhs.values():
            nh.close()
    st = assert_healthy(group)
    assert st["routed_delivered"] > 0
    data = _assert_script_applied(want)
    _assert_script_applied(got, data)
