"""The port's post-warm-up stall sentry (``analysis/jitcheck.py``).

The reference's recompile sentry watches JAX trace caches; the port's
counterpart keeps its API and watches what stalls a launch of the port
mid-run instead: the caching allocator's device allocations, retries and
all-stream syncs, the pinned pool's host allocations and the kernel
extension's builds.

* The reference's three ``TestJitcheckSentry`` cases
  (``tests/test_jaxcheck.py:296-320``) on fixture counters: growth after
  the mark is caught and formatted, a repeat at a warmed size is not
  growth, an unmarked sentry reports nothing.
* The default entries name the five counters and read 0 on the CPU
  without initialising CUDA.
* Both engines mark at the end of ``_warm()`` when the sentry is on, and
  not when it is off; the colocated warm-up runs the select at every
  tier and takes each tier's blobs through the readback as often at once
  as a full pipeline holds in flight; its parity pass (``_warm_parity``,
  run on a CUDA block) checks every program of a launch uncounted.
* The reference's ``TestClusterSentryPass`` (``:330-370``), always run:
  a port 3-replica colocated cluster (``device="cpu"``, the colocated
  siblings loaded on the port, a 20 ms tick), 10 warm-up proposals, the
  mark, 30 proposals, a leader transfer and 10 more; no counter grew.

``port_stall_sentry`` arms the sentry over a port test that asks for it,
under the reference's switch (``DRAGONBOAT_TPU_JITCHECK=1``), as the
reference's conftest arms it over its engine-driven modules.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch.analysis import jitcheck
from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import colocated as PC
from dragonboat_tpu_torch.ops import engine as PE

CPU_TICK_MS = 20


@pytest.fixture
def port_stall_sentry():
    """The post-warm-up sentry over one test, when the reference's switch
    is on: the test starts from a fresh mark (an engine it builds marks
    again at the end of its warm-up) and fails if a watched counter grew
    after the last mark."""
    if not jitcheck.ENABLED:
        yield
        return
    jitcheck.mark_warm()
    yield
    rows = jitcheck.retraces()
    if rows:
        pytest.fail("jitcheck: post-warmup stall(s) during this test\n"
                    + jitcheck.format_retraces(rows), pytrace=False)


@pytest.fixture
def sentry_on():
    was = jitcheck.ENABLED
    jitcheck.enable(True)
    yield
    jitcheck.enable(was)


class FixturePool:
    """A cache keyed on size, like the caching allocator: a size it has
    not held yet costs one allocation."""

    def __init__(self):
        self.sizes = set()
        self.allocs = 0

    def get(self, size: int) -> None:
        if size not in self.sizes:
            self.sizes.add(size)
            self.allocs += 1


# ---------------------------------------------------------------------------
# the reference's TestJitcheckSentry, on fixture counters
# ---------------------------------------------------------------------------
class TestJitcheckSentry:
    def test_forced_post_warmup_growth_caught(self):
        pool = FixturePool()
        s = jitcheck.Sentry([("fix.alloc", lambda: pool.allocs)])
        pool.get(4)  # warmup size
        s.mark()
        assert s.retraces() == []
        pool.get(4)  # same size: cached, no growth
        assert s.retraces() == []
        pool.get(5)  # a size the warm-up never held: growth
        rows = s.retraces()
        assert rows and rows[0][0] == "fix.alloc"
        assert rows[0][2] > rows[0][1]
        assert "post-warmup stall" in jitcheck.format_retraces(rows)

    def test_repeat_is_not_growth(self):
        pool = FixturePool()
        s = jitcheck.Sentry([("a", lambda: pool.allocs),
                             ("b", lambda: 7)])
        for size in (1, 2, 4):
            pool.get(size)
        s.mark()
        for size in (4, 2, 1, 4):
            pool.get(size)
        assert s.retraces() == []
        assert s.snapshot() == {"a": 3, "b": 7}

    def test_unmarked_sentry_reports_nothing(self):
        s = jitcheck.Sentry([])
        assert s.retraces() == []
        pool = FixturePool()
        s = jitcheck.Sentry([("fix.alloc", lambda: pool.allocs)])
        pool.get(1)
        assert s.retraces() == []


# ---------------------------------------------------------------------------
# the default entries
# ---------------------------------------------------------------------------
DEFAULT_NAMES = ["cuda.device_alloc", "cuda.alloc_retries",
                 "cuda.sync_all_streams", "cuda.host_alloc",
                 "native.builds"]


def test_default_entries_read_zero_on_cpu_without_initialising_cuda(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the sentry touched CUDA")

    for name in ("memory_stats", "host_memory_stats", "init",
                 "_lazy_init", "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert not torch.cuda.is_initialized()
    s = jitcheck.Sentry()
    assert [n for n, _ in s.entries()] == DEFAULT_NAMES
    assert s.snapshot() == {n: 0 for n in DEFAULT_NAMES}
    s.mark()
    assert s.retraces() == []
    assert not torch.cuda.is_initialized()


def test_default_entries_read_the_allocators_counters(monkeypatch):
    """With CUDA initialised the device counters are summed over the
    devices, the host counter is the pinned pool's, and the build
    counter is ``_native.BUILDS``."""
    stats = {0: {"num_device_alloc": 5, "num_alloc_retries": 1,
                 "num_sync_all_streams": 2},
             1: {"num_device_alloc": 3}}
    host = {"num_host_alloc": 4}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d])
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: host)
    monkeypatch.setattr(_native, "BUILDS", 1)
    s = jitcheck.Sentry()
    assert s.snapshot() == {"cuda.device_alloc": 8, "cuda.alloc_retries": 1,
                            "cuda.sync_all_streams": 2,
                            "cuda.host_alloc": 4, "native.builds": 1}
    s.mark()
    stats[1]["num_device_alloc"] += 1
    host["num_host_alloc"] += 2
    monkeypatch.setattr(_native, "BUILDS", 2)
    assert s.retraces() == [("cuda.device_alloc", 8, 9),
                            ("cuda.host_alloc", 4, 6),
                            ("native.builds", 1, 2)]


# ---------------------------------------------------------------------------
# the engines' warm-up marks
# ---------------------------------------------------------------------------
def count_marks(monkeypatch) -> list:
    marks = []
    monkeypatch.setattr(jitcheck, "mark_warm", lambda: marks.append(1))
    return marks


def test_base_engine_marks_at_end_of_warm_when_enabled(monkeypatch,
                                                       sentry_on):
    marks = count_marks(monkeypatch)
    synced = []
    sync = PE.TorchStepEngine._sync

    def recorded(self):
        synced.append(len(marks))
        return sync(self)

    monkeypatch.setattr(PE.TorchStepEngine, "_sync", recorded)
    PE.TorchStepEngine(None, capacity=8, device="cpu")
    assert marks == [1]
    assert synced and synced[-1] == 0  # the mark follows the warm's work


def test_colocated_engine_marks_at_end_of_warm_when_enabled(monkeypatch,
                                                            sentry_on):
    marks = count_marks(monkeypatch)
    sel = []
    select = PC._select_and_blob

    def recorded(*a, **kw):
        sel.append(len(marks))
        return select(*a, **kw)

    monkeypatch.setattr(PC, "_select_and_blob", recorded)
    group = PC.ColocatedEngineGroup(capacity=16, P=5, W=16, M=8, E=2, O=32,
                                    budget=8, device="cpu")
    group.factory(None)
    assert marks == [1]
    assert sel and max(sel) == 0


@pytest.mark.parametrize("kind", ["base", "colocated"])
def test_engines_do_not_mark_when_disabled(monkeypatch, kind):
    monkeypatch.setattr(jitcheck, "ENABLED", False)
    marks = count_marks(monkeypatch)
    if kind == "base":
        PE.TorchStepEngine(None, capacity=8, device="cpu")
    else:
        PC.ColocatedEngineGroup(capacity=16, P=5, W=16, M=8, E=2, O=32,
                                budget=8, device="cpu").factory(None)
    assert marks == []


@pytest.mark.parametrize("depth,rounds", [(1, 1), (2, 3)])
def test_colocated_warm_covers_every_tier_and_its_readbacks(
        monkeypatch, depth, rounds):
    """The select at every tier of ``_SEL_TIERS`` (clamped to the
    capacity), and each tier's head and detail through the readback
    ``depth * rounds`` times at once."""
    caps, reads = [], []
    select = PC._select_and_blob
    readback = PC._Readback

    def sel(*a, **kw):
        caps.append((kw["CAP_B"], kw["CAP_SL"], kw["CAP_N"], kw["CAP_A"],
                     kw["CAP_S"]))
        head, detail = select(*a, **kw)
        reads.append([])
        return head, detail

    def rb(t):
        reads[-1].append(t.numel())
        return readback(t)

    monkeypatch.setattr(PC, "_select_and_blob", sel)
    monkeypatch.setattr(PC, "_Readback", rb)
    G = 1 << 12
    PC.ColocatedEngineGroup(capacity=G, P=5, W=16, M=8, E=2, O=32,
                            budget=8, device="cpu", pipeline_depth=depth,
                            fused_rounds=rounds).factory(None)
    want = [tuple(min(G, t[k]) for k in ("b", "sl", "n", "a", "s"))
            for t in PC._SEL_TIERS]
    assert caps == want
    for r in reads:
        assert len(r) == 2 * depth * rounds
    # a tier's blobs grow with its caps: each tier its own sizes
    assert len({tuple(r) for r in reads}) == len(PC._SEL_TIERS)


def test_colocated_warm_parity_pass_checks_every_program_uncounted(
        monkeypatch):
    """``_warm_parity`` (the warm-up of an engine with ``parity_every`` on
    a CUDA block runs it, so the parity pool holds a check's temporaries
    before the first launch) on CPU tensors: each program of a launch is
    checked against its plain version, every row alive and a host inbox
    carrying every hot message type, the select at the storm tier; the
    stats count none of it, and on the CPU the parity pool is the
    default allocator."""
    group = PC.ColocatedEngineGroup(capacity=64, P=5, W=16, M=8, E=2, O=32,
                                    budget=8, device="cpu", parity_every=4)
    group.factory(None)
    core = group.core
    before = dict(core.stats)
    seen = []
    run = core._run

    def recorded(name, fn, *a, **kw):
        seen.append((name, kw.get("parity"), kw.get("counted")))
        return run(name, fn, *a, **kw)

    monkeypatch.setattr(core, "_run", recorded)
    per = core._blocks.per
    dest = core._put(np.full((per, 5), -1, np.int32), 0)
    rank = core._put(np.zeros((per, 5), np.int32), 0)
    core._warm_parity(0, core._state.parts[0], dest, rank, {},
                      core._block_caps(core._tier_caps(3)))
    assert [n for n, *_ in seen] == [
        "host_inbox_from_ticks", "scatter_inbox_rows", "assemble_and_step",
        "route_step", "select_and_blob"]
    assert all(p is True and c is False for _, p, c in seen)
    assert core.stats == before
    assert isinstance(core._parity_pool(torch.device("cpu")),
                      contextlib.nullcontext)


# ---------------------------------------------------------------------------
# the reference's TestClusterSentryPass, always run, on the port
# ---------------------------------------------------------------------------
TAG = "tjc"


def test_colocated_3replica_zero_postwarm_stalls(sentry_on):
    from port_loader import assert_port_only, load_colocated_siblings

    sib = load_colocated_siblings(TAG, "cpu")
    colo = sib["test_colocated"]
    tnh = __import__(f"{TAG}_test_nodehost")
    for mod in (colo, tnh):
        assert_port_only(mod)
    jitcheck._DEFAULT._snap = None
    group, nhs = colo.make_colocated_cluster(rtt_ms=CPU_TICK_MS)
    try:
        for rid, nh in nhs.items():
            nh.start_replica(tnh.ADDRS, False, tnh.KVStore,
                             colo.colo_shard_config(rid))
        # the engine's warm-up marked the sentry
        assert group.core._device.type == "cpu"
        assert jitcheck._DEFAULT._snap is not None
        tnh.wait_for_leader(nhs)
        lid, ok = nhs[1].get_leader_id(1)
        assert ok
        s = nhs[lid].get_noop_session(1)
        for i in range(10):  # warmup traffic: all launch shapes hit
            tnh.propose_r(nhs[lid], s, tnh.set_cmd(f"warm{i}", b"v"))
        jitcheck.mark_warm()
        for i in range(30):
            tnh.propose_r(nhs[lid], s, tnh.set_cmd(f"load{i}", b"v"))
        nhs[lid].request_leader_transfer(1, (lid % 3) + 1)
        for i in range(10):
            lid2, ok = nhs[1].get_leader_id(1)
            if ok:
                s2 = nhs[lid2].get_noop_session(1)
                tnh.propose_r(nhs[lid2], s2,
                              tnh.set_cmd(f"post{i}", b"v"))
        rows = jitcheck.retraces()
        assert rows == [], (
            "post-warmup stalls in the cluster pass:\n"
            + jitcheck.format_retraces(rows))
        assert group.core.stats["launches"] > 0
        assert group.core.stats["divergence_halts"] == 0
    finally:
        for nh in nhs.values():
            nh.close()
