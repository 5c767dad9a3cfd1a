"""The port's slice as a whole: NodeHost clusters on TorchStepEngine.

Three NodeHosts of ``dragonboat_tpu_torch`` in one process on its
in-proc transport, every shard stepped through
``torch_step_engine_factory(device="cpu")`` (the plain PyTorch versions
of the kernels).  The cases are those of ``test_vector_engine.py``:
election, replication, reads, multi-shard, and the divergence
fail-stop; every cluster must end with ``divergence_halts == 0`` unless
the case provokes one.  A lockstep case runs the same scripted
proposals on a JAX-engine cluster of the reference package and on a
port cluster and requires the same applied commands and state machine
contents on every replica.

The eager torch step is slower per launch than JAX's compiled CPU step,
so the clocks are slower (rtt 20 ms, election_rtt 20) and reads retry.
Under ``DRAGONBOAT_TPU_JITCHECK=1`` every case runs under the port's
post-warm-up sentry (``test_torch_jitcheck.port_stall_sentry``), as the
reference's conftest arms its recompile sentry over its engine modules.
"""
from __future__ import annotations

import pickle
import time

import pytest

import dragonboat_tpu_torch as pt
from dragonboat_tpu_torch.config import Config, EngineConfig, ExpertConfig
from dragonboat_tpu_torch.nodehost import (
    NodeHost,
    RequestDropped,
    TimeoutError_,
)
from dragonboat_tpu_torch.ops.engine import torch_step_engine_factory
from dragonboat_tpu_torch.request import SystemBusy
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.storage.logdb import in_mem_logdb_factory
from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

from test_torch_jitcheck import port_stall_sentry  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_stall_sentry")

GEOM = dict(capacity=16, P=5, W=32, M=8, E=4, O=32)
ADDRS = {1: "tnh-1", 2: "tnh-2", 3: "tnh-3"}


def set_cmd(k, v):
    return pickle.dumps(("set", k, v))


def make_kv(base):
    """An in-memory KV state machine on ``base``'s IStateMachine that
    also records every applied command in order."""

    class KV(base):
        def __init__(self, shard_id, replica_id):
            self.data = {}
            self.applied = []

        def update(self, entry):
            op, k, v = pickle.loads(entry.cmd)
            self.applied.append(entry.cmd)
            if op != "set":
                raise ValueError(op)
            self.data[k] = v
            return self._result(len(self.data))

        def lookup(self, query):
            if query == "__applied__":
                return list(self.applied)
            if query == "__data__":
                return dict(self.data)
            return self.data.get(query)

        def save_snapshot(self, w, files, done):
            w.write(pickle.dumps((self.data, self.applied)))

        def recover_from_snapshot(self, r, files, done):
            self.data, self.applied = pickle.loads(r.read())

    return KV


class PortKV(make_kv(IStateMachine)):
    @staticmethod
    def _result(n):
        return Result(value=n)


def shard_config(rid, shard_id=1, **kw):
    kw.setdefault("election_rtt", 20)
    kw.setdefault("heartbeat_rtt", 2)
    return Config(replica_id=rid, shard_id=shard_id, **kw)


def make_nodehost(rid, tmp_path, rtt_ms=20, parity_every=0,
                  logdb_factory=in_mem_logdb_factory):
    """A port NodeHost on ``torch_step_engine_factory(device="cpu")``;
    ``logdb_factory=None`` takes the port's default logdb (tan)."""
    from dragonboat_tpu_torch.config import NodeHostConfig

    return NodeHost(NodeHostConfig(
        nodehost_dir=str(tmp_path / f"nh-{rid}"),
        rtt_millisecond=rtt_ms,
        raft_address=ADDRS[rid],
        expert=ExpertConfig(
            engine=EngineConfig(exec_shards=1, apply_shards=2),
            logdb_factory=logdb_factory,
            step_engine_factory=torch_step_engine_factory(
                **GEOM, device="cpu", parity_every=parity_every
            ),
        ),
    ))


def wait_for_leader(nhs, shard_id=1, timeout=30.0):
    """Wait until every nodehost knows the same leader for the shard."""
    end = time.time() + timeout
    while time.time() < end:
        seen = set()
        for nh in nhs.values():
            lid, ok = nh.get_leader_id(shard_id)
            if not ok:
                break
            seen.add(lid)
        else:
            if len(seen) == 1:
                return seen.pop()
        time.sleep(0.02)
    raise AssertionError(f"no leader for shard {shard_id}")


def propose_r(nh, session, cmd, deadline=20.0, timeout=2.0):
    end = time.time() + deadline
    while True:
        try:
            return nh.sync_propose(session, cmd, timeout=timeout)
        except (TimeoutError_, RequestDropped, SystemBusy):
            if time.time() >= end:
                raise
            time.sleep(0.02)


def read_r(nh, shard_id, query, deadline=20.0, timeout=2.0):
    end = time.time() + deadline
    while True:
        try:
            return nh.sync_read(shard_id, query, timeout=timeout)
        except Exception:  # noqa: BLE001 — retried like a client would
            if time.time() >= end:
                raise
            time.sleep(0.05)


def stats(nhs):
    return {rid: nh.engine.step_engine.stats_snapshot()
            for rid, nh in nhs.items()}


@pytest.fixture
def tancluster(tmp_path):
    """The cluster on the port's default logdb: tan, the durable WAL."""
    reset_inproc_network()
    nhs = {rid: make_nodehost(rid, tmp_path, parity_every=4,
                              logdb_factory=None)
           for rid in ADDRS}
    for rid, nh in nhs.items():
        nh.start_replica(ADDRS, False, PortKV, shard_config(rid))
    yield nhs
    for nh in nhs.values():
        nh.close()
    assert all(s["divergence_halts"] == 0 for s in stats(nhs).values())


@pytest.fixture
def tcluster(tmp_path):
    reset_inproc_network()
    # every 4th launch re-runs through the plain versions (self-check)
    nhs = {rid: make_nodehost(rid, tmp_path, parity_every=4) for rid in ADDRS}
    for rid, nh in nhs.items():
        nh.start_replica(ADDRS, False, PortKV, shard_config(rid))
    yield nhs
    for nh in nhs.values():
        nh.close()


def test_package_exports():
    assert {"NodeHost", "NodeHostConfig", "Config", "ExpertConfig",
            "EngineConfig", "IStateMachine", "Result"} <= set(pt.__all__)


def test_cpu_engines_share_one_device_lock():
    """CPU engines of one process take turns in their device sections
    (concurrent plain steps thrash the GIL), mesh or not."""
    from dragonboat_tpu_torch.ops import engine as E
    from dragonboat_tpu_torch.ops.placement import GroupsMesh

    one = E.TorchStepEngine(None, capacity=4, device="cpu")
    two = E.TorchStepEngine(None, capacity=4, mesh=GroupsMesh(["cpu"] * 2))
    assert one._device_lock is two._device_lock is E._CPU_DEVICE_LOCK


def test_cuda_request_without_card_raises():
    import torch

    from dragonboat_tpu_torch.ops import placement

    if torch.cuda.is_available():
        assert placement.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError):
        placement.default_device()
    with pytest.raises(RuntimeError):
        placement.resolve_device("cuda")
    assert placement.resolve_device("cpu").type == "cpu"


class TestTorchCluster:
    def test_leader_elected_on_device(self, tcluster):
        assert wait_for_leader(tcluster) in ADDRS
        st = stats(tcluster)
        assert any(s["device_rows_stepped"] > 0 for s in st.values()), st
        assert all(s["divergence_halts"] == 0 for s in st.values()), st

    def test_propose_and_read_everywhere(self, tcluster):
        wait_for_leader(tcluster)
        for rid, nh in tcluster.items():
            s = nh.get_noop_session(1)
            propose_r(nh, s, set_cmd(f"k{rid}", bytes([rid])))
        for rid in ADDRS:
            for other in tcluster.values():
                assert read_r(other, 1, f"k{rid}") == bytes([rid])
        st = stats(tcluster)
        assert all(s["divergence_halts"] == 0 for s in st.values()), st

    def test_many_proposals_replicate(self, tcluster):
        wait_for_leader(tcluster)
        nh = tcluster[1]
        s = nh.get_noop_session(1)
        for i in range(20):
            propose_r(nh, s, set_cmd(f"key-{i}", str(i).encode()))
        assert read_r(tcluster[3], 1, "key-19") == b"19"
        st = stats(tcluster)
        assert sum(s["device_steps"] for s in st.values()) > 0, st
        assert all(s["parity_checked_launches"] > 0 for s in st.values()), st
        assert all(s["parity_checked_row_moves"] > 0 for s in st.values()), st
        for s in st.values():
            assert s["parity_failures"] == 0, st
            assert s["parity_checked_row_moves"] == s["parity_row_attempts"]
        assert all(s["divergence_halts"] == 0 for s in st.values()), st

    def test_multi_shard(self, tcluster):
        for shard in (2, 3):
            for rid, nh in tcluster.items():
                nh.start_replica(ADDRS, False, PortKV,
                                 shard_config(rid, shard_id=shard))
        for shard in (2, 3):
            wait_for_leader(tcluster, shard_id=shard)
            s = tcluster[1].get_noop_session(shard)
            propose_r(tcluster[1], s, set_cmd(f"s{shard}", bytes([shard])))
        for shard in (2, 3):
            assert read_r(tcluster[2], shard, f"s{shard}") == bytes([shard])
        st = stats(tcluster)
        assert all(s["divergence_halts"] == 0 for s in st.values()), st


class TestTanCluster:
    """The cases of ``test_vector_engine.py`` that need the durable WAL,
    on the port's default logdb (tan)."""

    def test_default_logdb_is_tan(self, tancluster):
        from dragonboat_tpu_torch.storage.tan import TanLogDB

        assert all(isinstance(nh.logdb, TanLogDB)
                   for nh in tancluster.values())

    def test_membership_change_cold_path(self, tancluster):
        from test_nodehost import add_non_voting_poll

        wait_for_leader(tancluster)
        nh = tancluster[1]
        s = nh.get_noop_session(1)
        propose_r(nh, s, set_cmd("pre", b"1"))
        m2 = add_non_voting_poll(nh, 1, 9, "nh-9")
        assert 9 in m2.non_votings
        # the shard keeps working after the cold excursion
        propose_r(nh, s, set_cmd("post", b"2"))
        assert read_r(nh, 1, "post") == b"2"

    def test_restart_replays(self, tancluster):
        wait_for_leader(tancluster)
        nh = tancluster[1]
        s = nh.get_noop_session(1)
        for i in range(10):
            propose_r(nh, s, set_cmd(f"r-{i}", str(i).encode()))
        assert read_r(tancluster[2], 1, "r-9") == b"9"
        # stop replica 3 and bring it back: WAL replay + catch-up
        tancluster[3].stop_replica(1, 3)
        propose_r(nh, s, set_cmd("while-down", b"x"))
        tancluster[3].start_replica(ADDRS, False, PortKV, shard_config(3))
        deadline = time.time() + 30.0
        while time.time() < deadline:
            try:
                if tancluster[3].stale_read(1, "while-down") == b"x":
                    break
            except Exception:  # noqa: BLE001 — not applied yet
                pass
            time.sleep(0.05)
        else:
            raise AssertionError("restarted replica never caught up")
        # the replayed replica holds every write from before the stop
        assert tancluster[3].stale_read(1, "r-9") == b"9"


class TestDivergenceFailStop:
    def test_device_host_divergence_halts_replica(self, tcluster):
        """A materialized device row whose last_index disagrees with the
        host log must fail-stop the replica."""
        wait_for_leader(tcluster)
        nh = tcluster[1]
        s = nh.get_noop_session(1)
        propose_r(nh, s, set_cmd("pre", b"1"))
        eng = nh.engine.step_engine
        node = nh._nodes[1]
        deadline = time.time() + 20.0
        while time.time() < deadline:
            with eng._lock:
                g = eng._row_of.get(1)
                if g is not None and not eng._meta[g].dirty:
                    break
            time.sleep(0.05)
        else:
            raise AssertionError("row never became device-resident")
        real_log = node.peer.raft.log

        class LyingLog:
            def __getattr__(self, name):
                return getattr(real_log, name)

            def __setattr__(self, name, value):
                setattr(real_log, name, value)

            def last_index(self):
                return real_log.last_index() + 7

        with eng._lock:
            node.peer.raft.log = LyingLog()
            eng._meta[g].dirty = True
            eng._materialize_rows([g])
        assert node.stopped, "divergence did not halt the replica"
        assert eng.stats["divergence_halts"] >= 1


# a kernel path that disagrees with its plain version: (module, name,
# how its result is spoiled, the name the parity check reports)
SPOIL = {
    "raft_step": ("kernel", "step",
                  lambda r: (r[0]._replace(term=r[0].term + 1), r[1]),
                  "state.term"),
    "summarize_flags": ("plumbing", "summarize_flags", lambda r: r ^ 1,
                        "flags"),
    "gather_pack": ("plumbing", "gather_pack", lambda r: r + 1,
                    "readback pack"),
    "place_rows": ("plumbing", "place_rows",
                   lambda r: [r[0] + 1] + list(r[1:]), "_scatter_rows"),
}


@pytest.mark.parametrize("kernel", sorted(SPOIL))
def test_parity_mismatch_is_counted_and_latched(tmp_path, monkeypatch,
                                                 kernel):
    """A launch whose kernel path disagrees with the plain version is
    caught on the main path.  The exec engine's step worker only logs
    what step_shards raises, so the engine must count the failure,
    latch its first message, and never count that check as passed."""
    from dragonboat_tpu_torch.ops import kernel as PK
    from dragonboat_tpu_torch.ops import plumbing

    mod, name, spoil, reported = SPOIL[kernel]
    target = {"kernel": PK, "plumbing": plumbing}[mod]
    real = getattr(target, name)
    reset_inproc_network()
    nhs = {rid: make_nodehost(rid, tmp_path, parity_every=1)
           for rid in ADDRS}
    try:
        monkeypatch.setattr(target, name,
                            lambda *a, **k: spoil(real(*a, **k)))
        for rid, nh in nhs.items():
            nh.start_replica(ADDRS, False, PortKV, shard_config(rid))
        engines = [nh.engine.step_engine for nh in nhs.values()]
        end = time.time() + 30.0
        while time.time() < end and not all(
            e.stats["parity_failures"] for e in engines
        ):
            time.sleep(0.05)
        for e in engines:
            st = e.stats
            assert st["parity_failures"] >= 1, st
            assert e.parity_failure.startswith("parity: "), e.parity_failure
            assert reported in e.parity_failure, e.parity_failure
            assert (
                st["parity_checked_launches"] < st["parity_step_attempts"]
                or st["parity_checked_row_moves"] < st["parity_row_attempts"]
            ), st
    finally:
        monkeypatch.undo()
        for nh in nhs.values():
            nh.close()


SCRIPT = [set_cmd(f"lk-{i % 5}", f"v{i}".encode()) for i in range(12)]


def _run_script(nhs, ses_of, timeout=2.0):
    """SCRIPT through ``nhs``; ``timeout``: each request's wait before a
    retry (propose_r, read_r)."""
    lid = wait_for_leader(nhs)
    for i, cmd in enumerate(SCRIPT):
        nh = nhs[(lid + i) % 3 + 1]  # spread over leader and followers
        propose_r(nh, ses_of(nh), cmd, timeout=timeout)
    out = {}
    for rid, nh in nhs.items():
        applied = read_r(nh, 1, "__applied__", timeout=timeout)
        deadline = time.time() + 20.0
        while len(applied) < len(SCRIPT) and time.time() < deadline:
            time.sleep(0.05)
            applied = read_r(nh, 1, "__applied__", timeout=timeout)
        out[rid] = (applied, read_r(nh, 1, "__data__", timeout=timeout))
    return out


def test_lockstep_with_reference_engine(tmp_path):
    """The same scripted proposals on a JAX-engine cluster of the
    reference package and on a port cluster: identical applied command
    sequences and state machine contents on all three replicas."""
    import dragonboat_tpu as ref
    from dragonboat_tpu.ops.engine import vector_step_engine_factory
    from dragonboat_tpu.storage.logdb import (
        in_mem_logdb_factory as ref_in_mem,
    )
    from dragonboat_tpu.transport.inproc import (
        reset_inproc_network as ref_reset,
    )

    class RefKV(make_kv(ref.IStateMachine)):
        @staticmethod
        def _result(n):
            return ref.Result(value=n)

    ref_reset()
    ref_nhs = {
        rid: ref.NodeHost(ref.NodeHostConfig(
            nodehost_dir=str(tmp_path / f"ref-{rid}"),
            rtt_millisecond=20,
            raft_address=ADDRS[rid],
            expert=ref.ExpertConfig(
                engine=ref.EngineConfig(exec_shards=1, apply_shards=2),
                logdb_factory=ref_in_mem,
                step_engine_factory=vector_step_engine_factory(**GEOM),
            ),
        ))
        for rid in ADDRS
    }
    try:
        for rid, nh in ref_nhs.items():
            nh.start_replica(ADDRS, False, RefKV, ref.Config(
                replica_id=rid, shard_id=1, election_rtt=20, heartbeat_rtt=2,
            ))
        want = _run_script(ref_nhs, lambda nh: nh.get_noop_session(1))
    finally:
        for nh in ref_nhs.values():
            nh.close()

    reset_inproc_network()
    nhs = {rid: make_nodehost(rid, tmp_path / "port") for rid in ADDRS}
    try:
        for rid, nh in nhs.items():
            nh.start_replica(ADDRS, False, PortKV, shard_config(rid))
        got = _run_script(nhs, lambda nh: nh.get_noop_session(1))
        st = stats(nhs)
    finally:
        for nh in nhs.values():
            nh.close()
    assert all(s["divergence_halts"] == 0 for s in st.values()), st
    assert all(s["device_steps"] > 0 for s in st.values()), st
    # a client retry after a lost acknowledgement may apply a command
    # twice in a row (no-op sessions do not deduplicate); collapse such
    # repeats before comparing — SCRIPT has no equal neighbours
    def squash(applied):
        return [c for i, c in enumerate(applied) if i == 0 or c != applied[i - 1]]

    want_data = want[1][1]
    for rid in ADDRS:
        assert squash(want[rid][0]) == SCRIPT, f"reference replica {rid}"
        assert squash(got[rid][0]) == SCRIPT, f"port replica {rid}"
        assert want[rid][1] == want_data, f"reference replica {rid} data"
        assert got[rid][1] == want_data, f"port replica {rid} data"
