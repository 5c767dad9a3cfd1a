"""The port's on-disk state machine and KV logdb against the reference's cases.

``storage/kvstore.py``, ``storage/kvlogdb.py`` and ``bigstate/ondisk.py``
are carried byte for byte (``tests/test_torch_isolation.py``); here the
reference's own cases run on the port's copies:

* ``TestKVStore`` and ``TestShardedKVLogDB`` (both entry codecs) of
  ``test_kvlogdb.py``, on ``dragonboat_tpu_torch.storage``;
* the power-loss fuzz of ``test_kvlogdb.py`` at the reference's seeds
  and parametrisations, on the harness of ``test_vfs_crash.py`` loaded
  from that file's source with the port's ``pb``, ``tan`` and ``vfs`` in
  place of the reference's (the harness compares ``pb`` objects, and the
  two packages' dataclasses are different classes);
* ``TestOnDiskKV`` of ``test_bigstate.py`` on a port ``StrictMemFS``;
* three port NodeHosts on ``torch_step_engine_factory(device="cpu")``:
  one cluster on ``kv_logdb_factory`` whose restarted follower replays
  the KV journal, and one whose state machine is ``OnDiskKV`` that
  restarts, recovers each replica's applied index from its own files and
  replays only the log's tail past it.
"""
from __future__ import annotations

import io
import os
import random
import threading
import time

import pytest

from dragonboat_tpu_torch.pb import Bootstrap, Snapshot, State
from dragonboat_tpu_torch.statemachine import SMEntry
from dragonboat_tpu_torch.storage.kvlogdb import (
    ShardedKVLogDB,
    kv_logdb_factory,
)
from dragonboat_tpu_torch.storage.kvstore import KVStore, WriteBatch
from dragonboat_tpu_torch.storage.vfs import StrictMemFS
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

from port_loader import load_on_port  # noqa: F401 (re-exported)


@pytest.fixture(scope="module")
def port_lock_witness():
    """The port's lock-order witness over a module that asks for it
    (``pytestmark = pytest.mark.usefixtures("port_lock_witness")``), under
    the reference's switch (``DRAGONBOAT_TPU_LOCKCHECK``, on in the
    suite): locks the port creates while it is armed are tracked, and a
    lock-order cycle fails the module at teardown.  The reference's
    witness is never armed at the same time (its root is a string prefix
    of the port's)."""
    from dragonboat_tpu.analysis import lockcheck as ref_lockcheck
    from dragonboat_tpu_torch.analysis import lockcheck as port_lockcheck

    if not port_lockcheck.ENABLED:
        yield None
        return
    assert ref_lockcheck.current() is None
    w = port_lockcheck.install()
    try:
        yield w
    finally:
        port_lockcheck.uninstall()
    w.assert_clean()


_crash = load_on_port("test_vfs_crash.py", "torch_vfs_crash")
up, ent, run_powerloss_fuzz = _crash.up, _crash.ent, _crash.run_powerloss_fuzz


def test_harness_builds_port_objects():
    from dragonboat_tpu_torch import pb

    u = up(1, 1, 2, [ent(1, 2)])
    assert type(u) is pb.Update and type(u.state) is pb.State
    assert type(u.entries_to_save[0]) is pb.Entry
    assert _crash.StrictMemFS is StrictMemFS


def test_ondisk_module_imports():
    from dragonboat_tpu_torch.bigstate import ondisk

    assert ondisk.OnDiskKV.__module__ == "dragonboat_tpu_torch.bigstate.ondisk"


# ---------------------------------------------------------------------------
# KVStore (test_kvlogdb.py TestKVStore)
# ---------------------------------------------------------------------------
class TestKVStore:
    def test_roundtrip_and_order(self):
        fs = StrictMemFS()
        kv = KVStore("/kv", fs=fs)
        wb = WriteBatch()
        for k in (b"b", b"a", b"c", b"aa"):
            wb.put(k, b"v-" + k)
        kv.commit(wb)
        assert kv.get(b"aa") == b"v-aa"
        assert [k for k, _ in kv.iterate(b"a", b"c")] == [b"a", b"aa", b"b"]
        kv.close()
        kv2 = KVStore("/kv", fs=fs)  # replay
        assert [k for k, _ in kv2.iterate(b"", b"zz")] == [
            b"a", b"aa", b"b", b"c"]
        kv2.close()

    def test_delete_range_and_replay(self):
        fs = StrictMemFS()
        kv = KVStore("/kv", fs=fs)
        wb = WriteBatch()
        for i in range(10):
            wb.put(b"k%02d" % i, b"x")
        kv.commit(wb)
        wb = WriteBatch()
        wb.delete_range(b"k02", b"k07")
        wb.delete(b"k09")
        kv.commit(wb)
        want = [b"k00", b"k01", b"k07", b"k08"]
        assert [k for k, _ in kv.iterate(b"", b"zz")] == want
        kv.close()
        kv2 = KVStore("/kv", fs=fs)
        assert [k for k, _ in kv2.iterate(b"", b"zz")] == want
        kv2.close()

    def test_rotation_checkpoint_gc(self):
        fs = StrictMemFS()
        kv = KVStore("/kv", fs=fs, max_journal_bytes=400, gc_segments=1)
        for i in range(60):
            wb = WriteBatch()
            wb.put(b"key-%03d" % i, bytes(20))
            kv.commit(wb)
        assert len(kv._segments()) <= 4  # GC ran
        kv.close()
        kv2 = KVStore("/kv", fs=fs)
        assert len(kv2.iterate(b"", b"\xff")) == 60
        kv2.close()

    def test_torn_checkpoint_discarded(self):
        """A checkpoint without its END marker is ignored wholesale: the
        pre-checkpoint segments still hold the data."""
        fs = StrictMemFS()
        kv = KVStore("/kv", fs=fs, max_journal_bytes=300, gc_segments=1)
        wrote = 0
        state = {"armed": False}

        def hook(op, path):
            # kill the first unlink: the checkpoint is written and synced
            # but the old segments survive
            if state["armed"] and op == "unlink":
                raise RuntimeError("boom")

        for i in range(40):
            wb = WriteBatch()
            wb.put(b"key-%03d" % i, bytes(20))
            state["armed"] = True
            fs.fault_hook = hook
            try:
                kv.commit(wb)
                wrote += 1
            except RuntimeError:
                wrote += 1  # the batch itself was durable pre-checkpoint
                break
            finally:
                fs.fault_hook = None
                state["armed"] = False
        fs.fault_hook = None
        fs.crash(random.Random(7))
        kv2 = KVStore("/kv", fs=fs)
        assert len(kv2.iterate(b"", b"\xff")) == wrote
        kv2.close()


# ---------------------------------------------------------------------------
# the ILogDB contract, both codecs (test_kvlogdb.py TestShardedKVLogDB)
# ---------------------------------------------------------------------------
@pytest.fixture(params=["batched", "plain"])
def kvdb(request):
    fs = StrictMemFS()

    def reopen():
        return ShardedKVLogDB(
            "/ldb", fs=fs, stores=2, batched=request.param == "batched",
            batch_size=4, max_journal_bytes=2000, gc_segments=2,
        )

    return fs, reopen


class TestShardedKVLogDB:
    def test_state_entries_roundtrip(self, kvdb):
        fs, reopen = kvdb
        db = reopen()
        db.save_bootstrap_info(1, 1, Bootstrap(addresses={1: "a1"}))
        db.save_raft_state(
            [up(1, 1, 2, [ent(i, 2, b"x%d" % i) for i in range(1, 11)],
                commit=3)], 0,
        )
        rs = db.read_raft_state(1, 1, 0)
        assert rs.state == State(term=2, vote=0, commit=3)
        assert rs.first_index == 1 and rs.entry_count == 10
        ents = db.iterate_entries(1, 1, 3, 8, 1 << 30)
        assert [e.index for e in ents] == [3, 4, 5, 6, 7]
        assert ents[0].cmd == b"x3"
        assert db.term(1, 1, 10) == 2
        assert db.term(1, 1, 11) is None
        db.close()
        db2 = reopen()  # replay
        assert db2.read_raft_state(1, 1, 0).entry_count == 10
        assert db2.get_bootstrap_info(1, 1).addresses == {1: "a1"}
        assert [n.shard_id for n in db2.list_node_info()] == [1]
        db2.close()

    def test_conflicting_suffix_overwrite(self, kvdb):
        fs, reopen = kvdb
        db = reopen()
        db.save_raft_state([up(1, 1, 1, [ent(i, 1) for i in range(1, 10)])],
                           0)
        # a term-2 rewrite from index 6 truncates the old tail
        db.save_raft_state([up(1, 1, 2, [ent(6, 2, b"n6"), ent(7, 2, b"n7")])],
                           0)
        ents = db.iterate_entries(1, 1, 1, 100, 1 << 30)
        assert [(e.index, e.term) for e in ents] == [
            (1, 1), (2, 1), (3, 1), (4, 1), (5, 1), (6, 2), (7, 2)
        ]
        db.close()
        db2 = reopen()
        assert db2.term(1, 1, 6) == 2 and db2.term(1, 1, 8) is None
        db2.close()

    def test_compaction_straddles_batches(self, kvdb):
        fs, reopen = kvdb
        db = reopen()
        db.save_raft_state([up(1, 1, 1, [ent(i, 1) for i in range(1, 12)])],
                           0)
        db.remove_entries_to(1, 1, 6)  # mid-batch for batch_size=4
        assert db.iterate_entries(1, 1, 7, 100, 1 << 30)[0].index == 7
        assert db.term(1, 1, 6) is None
        rs = db.read_raft_state(1, 1, 0)
        assert rs.first_index == 7 and rs.entry_count == 5
        db.close()
        db2 = reopen()
        rs = db2.read_raft_state(1, 1, 0)
        assert rs.first_index == 7 and rs.entry_count == 5
        db2.close()

    def test_snapshot_and_import(self, kvdb):
        fs, reopen = kvdb
        db = reopen()
        db.save_raft_state([up(1, 1, 1, [ent(1, 1), ent(2, 1)])], 0)
        db.save_snapshots(
            [up(1, 1, 1, snapshot=Snapshot(index=2, term=1, shard_id=1))])
        assert db.get_snapshot(1, 1).index == 2
        # a stale snapshot is ignored
        db.save_snapshots(
            [up(1, 1, 1, snapshot=Snapshot(index=1, term=1, shard_id=1))])
        assert db.get_snapshot(1, 1).index == 2
        db.import_snapshot(Snapshot(index=9, term=3, shard_id=7), 2)
        rs = db.read_raft_state(7, 2, 0)
        assert rs.state.term == 3 and rs.state.commit == 9
        assert rs.first_index == 10 and rs.entry_count == 0
        db.close()
        db2 = reopen()
        assert db2.get_snapshot(7, 2).index == 9
        db2.close()

    def test_remove_node_data(self, kvdb):
        fs, reopen = kvdb
        db = reopen()
        db.save_raft_state([up(3, 2, 1, [ent(1, 1)])], 0)
        db.remove_node_data(3, 2)
        assert db.read_raft_state(3, 2, 0) is None
        assert db.iterate_entries(3, 2, 1, 10, 1 << 30) == []
        db.close()

    def test_cross_shard_batch_shares_stores(self, kvdb):
        fs, reopen = kvdb
        db = reopen()
        db.save_raft_state([up(s, 1, 1, [ent(1, 1, b"s%d" % s)])
                            for s in range(1, 9)], 0)
        for s in range(1, 9):
            assert db.term(s, 1, 1) == 1
        db.close()


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("batched", [True, False])
def test_kv_powerloss_fuzz(seed, batched):
    """The kill-at-any-fsync-boundary fuzz the tan WAL passes
    (test_kvlogdb.py, the same seeds and sizes)."""
    fs = StrictMemFS()
    run_powerloss_fuzz(
        fs,
        lambda: ShardedKVLogDB(
            "/ldb", fs=fs, stores=2, batched=batched, batch_size=3,
            max_journal_bytes=600, gc_segments=1,
        ),
        seed,
    )


# ---------------------------------------------------------------------------
# OnDiskKV (test_bigstate.py TestOnDiskKV)
# ---------------------------------------------------------------------------
def _put(sm, index, k, v):
    from dragonboat_tpu_torch.bigstate.ondisk import put_cmd

    es = [SMEntry(index=index, cmd=put_cmd(k, v))]
    sm.update(es)
    return es[0].result


class TestOnDiskKV:
    def test_open_reports_applied_and_crash_replay(self):
        """Synced writes survive a crash; the torn unsynced tail is
        dropped frame by frame; open() reports the recovered index."""
        from dragonboat_tpu_torch.bigstate.ondisk import OnDiskKV

        fs = StrictMemFS()
        stop = threading.Event()
        sm = OnDiskKV(1, 1, base_dir="/d/1-1", fs=fs,
                      compact_wal_bytes=1 << 30)
        assert sm.open(stop) == 0
        for i in range(1, 11):
            _put(sm, i, b"k%d" % i, b"v%d" % i)
        sm.sync()
        for i in range(11, 16):
            _put(sm, i, b"k%d" % i, b"v%d" % i)  # unsynced tail
        fs.crash(random.Random(42))
        sm2 = OnDiskKV(1, 1, base_dir="/d/1-1", fs=fs)
        applied = sm2.open(stop)
        assert 10 <= applied <= 15
        for i in range(1, applied + 1):
            assert sm2.lookup(b"k%d" % i) == b"v%d" % i, i
        for i in range(applied + 1, 16):
            assert sm2.lookup(b"k%d" % i) is None

    def test_replay_skips_below_checkpoint_index(self):
        """Frames at or below the checkpoint's applied index are skipped
        on reopen (the window between the checkpoint's rename and the
        WAL's truncation)."""
        from dragonboat_tpu_torch.bigstate.ondisk import OnDiskKV

        fs = StrictMemFS()
        stop = threading.Event()
        sm = OnDiskKV(1, 1, base_dir="/d/skip", fs=fs,
                      compact_wal_bytes=1 << 30)
        sm.open(stop)
        for i in range(1, 9):
            _put(sm, i, b"k%d" % i, b"v%d" % i)
        sm.sync()
        # a checkpoint WITHOUT truncating the WAL
        sm._write_checkpoint(sm.applied, sm._data.items())
        sm.close()
        sm2 = OnDiskKV(1, 1, base_dir="/d/skip", fs=fs)
        assert sm2.open(stop) == 8
        assert sm2.stats["skipped"] == 8
        assert sm2.stats["replayed"] == 0
        assert sm2.lookup(b"k8") == b"v8"

    def test_checkpoint_compaction_and_delete(self):
        from dragonboat_tpu_torch.bigstate.ondisk import OnDiskKV, del_cmd

        fs = StrictMemFS()
        stop = threading.Event()
        sm = OnDiskKV(2, 1, base_dir="/d/2-1", fs=fs, compact_wal_bytes=64)
        sm.open(stop)
        for i in range(1, 30):
            _put(sm, i, b"a%d" % i, b"x" * 20)
            sm.sync()
        assert sm.stats["checkpoints"] > 0
        sm.update([SMEntry(index=30, cmd=del_cmd(b"a1"))])
        sm.sync()
        sm2 = OnDiskKV(2, 1, base_dir="/d/2-1", fs=fs)
        assert sm2.open(stop) == 30
        assert sm2.lookup(b"a1") is None
        assert sm2.lookup(b"a29") == b"x" * 20

    def test_snapshot_stream_roundtrip_durable(self):
        from dragonboat_tpu_torch.bigstate.ondisk import OnDiskKV

        fs = StrictMemFS()
        stop = threading.Event()
        sm = OnDiskKV(3, 1, base_dir="/d/3-1", fs=fs)
        sm.open(stop)
        for i in range(1, 20):
            _put(sm, i, b"k%d" % i, os.urandom(64))
        sm.sync()
        ctx = sm.prepare_snapshot()
        buf = io.BytesIO()
        sm.save_snapshot(ctx, buf, threading.Event())
        buf.seek(0)
        dst = OnDiskKV(3, 2, base_dir="/d/3-2", fs=fs)
        dst.open(stop)
        dst.recover_from_snapshot(buf, threading.Event())
        assert dst.applied == 19
        assert dst.lookup(b"k7") == sm.lookup(b"k7")
        # the recovered state survives an immediate crash
        fs.crash(random.Random(7))
        dst2 = OnDiskKV(3, 2, base_dir="/d/3-2", fs=fs)
        assert dst2.open(stop) == 19
        assert dst2.lookup(b"k7") == sm.lookup(b"k7")

    def test_malformed_cmd_rejected_not_fatal(self):
        from dragonboat_tpu_torch.bigstate.ondisk import OnDiskKV

        fs = StrictMemFS()
        sm = OnDiskKV(4, 1, base_dir="/d/4-1", fs=fs)
        sm.open(threading.Event())
        es = [SMEntry(index=1, cmd=b"garbage")]
        sm.update(es)
        assert es[0].result.value == 0
        assert sm.applied == 1  # the index still advances


# ---------------------------------------------------------------------------
# port clusters on the KV logdb and on OnDiskKV
# ---------------------------------------------------------------------------
def _wait_stale(nh, query, want, timeout=30.0):
    deadline = time.time() + timeout
    got = None
    while time.time() < deadline:
        try:
            got = nh.stale_read(1, query)
        except Exception:  # noqa: BLE001 — not applied yet
            got = None
        if got == want:
            return
        time.sleep(0.05)
    raise AssertionError(f"{query!r}: {got!r} != {want!r}")


def test_nodehost_cluster_on_kv_backend(tmp_path):
    reset_inproc_network()
    nhs = {rid: make_nodehost(rid, tmp_path, logdb_factory=kv_logdb_factory)
           for rid in ADDRS}
    try:
        for rid, nh in nhs.items():
            assert nh.logdb.name().startswith("sharded-kv")
            nh.start_replica(ADDRS, False, PortKV, shard_config(rid))
        lid = wait_for_leader(nhs)
        nh = nhs[lid]
        s = nh.get_noop_session(1)
        for i in range(10):
            propose_r(nh, s, set_cmd(f"kv-{i}", bytes([i])))
        # restart a follower: the KV journal replays it back
        fid = 1 + (lid % 3)
        nhs[fid].close()
        nhs[fid] = make_nodehost(fid, tmp_path,
                                 logdb_factory=kv_logdb_factory)
        nhs[fid].start_replica(ADDRS, False, PortKV, shard_config(fid))
        _wait_stale(nhs[fid], "kv-9", bytes([9]))
        assert all(s_["divergence_halts"] == 0 for s_ in stats(nhs).values())
    finally:
        for h in nhs.values():
            h.close()


def _ondisk_factory(fs, opened, seen):
    """OnDiskKV replicas on ``fs`` that record the applied index their
    open() reports (``opened``) and every index update() receives
    (``seen``), by replica."""
    from dragonboat_tpu_torch.bigstate.ondisk import OnDiskKV

    class TracedKV(OnDiskKV):
        def open(self, stopc):
            n = super().open(stopc)
            opened[self.replica_id] = n
            return n

        def update(self, entries):
            seen.setdefault(self.replica_id, []).extend(
                e.index for e in entries)
            return super().update(entries)

    def factory(shard_id, replica_id):
        return TracedKV(shard_id, replica_id,
                        base_dir=f"/sm/{shard_id}-{replica_id}", fs=fs)

    return factory


def test_ondisk_cluster_restart_replays_tail(tmp_path):
    """test_ondisk_witness.py's restart on the port's engine: propose,
    read back from all three replicas, make every state machine durable,
    restart; each replica's open() reports the applied index it
    recovered from its own files, the data is there before any new
    entry, and raft replays only the log's tail past that index (the tan
    WAL keeps the log)."""
    from dragonboat_tpu_torch.bigstate.ondisk import put_cmd

    fs = StrictMemFS()
    opened, seen = {}, {}
    factory = _ondisk_factory(fs, opened, seen)
    reset_inproc_network()
    nhs = {rid: make_nodehost(rid, tmp_path, logdb_factory=None)
           for rid in ADDRS}
    try:
        for rid, nh in nhs.items():
            nh.start_replica(ADDRS, False, factory, shard_config(rid))
        lid = wait_for_leader(nhs)
        s = nhs[lid].get_noop_session(1)
        for i in range(10):
            propose_r(nhs[lid], s, put_cmd(b"t-%d" % i, b"%d" % i))
        for nh in nhs.values():
            assert read_r(nh, 1, b"t-9") == b"9"
        # every replica's state machine makes what it applied durable
        synced = {}
        for rid, nh in nhs.items():
            sm = nh._nodes[1].sm.managed.sm
            sm.sync()
            synced[rid] = sm.applied
        assert all(n >= 10 for n in synced.values()), synced
        assert all(s_["divergence_halts"] == 0 for s_ in stats(nhs).values())
    finally:
        for nh in nhs.values():
            nh.close()
    opened.clear()
    seen.clear()
    reset_inproc_network()
    nhs = {rid: make_nodehost(rid, tmp_path, logdb_factory=None)
           for rid in ADDRS}
    try:
        for rid, nh in nhs.items():
            nh.start_replica(ADDRS, False, factory, shard_config(rid))
            # recovered from its own files before raft applies anything
            assert opened[rid] >= synced[rid], (opened, synced)
            assert nh._nodes[1].sm.managed.sm.lookup(b"t-9") == b"9"
        lid = wait_for_leader(nhs)
        s = nhs[lid].get_noop_session(1)
        propose_r(nhs[lid], s, put_cmd(b"post", b"x"))
        for nh in nhs.values():
            assert read_r(nh, 1, b"post") == b"x"
            for i in range(10):
                assert nh.stale_read(1, b"t-%d" % i) == b"%d" % i
        # the tail past the recovered index was applied, and nothing at
        # or below it was applied again
        for rid in ADDRS:
            assert seen[rid] and min(seen[rid]) > opened[rid], (rid, opened,
                                                               seen)
        assert all(s_["divergence_halts"] == 0 for s_ in stats(nhs).values())
    finally:
        for nh in nhs.values():
            nh.close()
