"""The port's span recorder (``dragonboat_tpu_torch/profiling.py``): its
switch (the profiler's own flag), its clock (the profiler's), its ring
and totals, its Chrome export, the fused wave's dispatch spans, and the
benchmark's readers of them (``portbench/metrics/dispatch_*``,
``native_launches_per_round``)."""
from __future__ import annotations

import json
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dragonboat_tpu_torch import profiling
from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import plumbing
from dragonboat_tpu_torch.ops import route
from dragonboat_tpu_torch.ops import types as T
from portbench.harness import manifest


@pytest.fixture
def recorder():
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.fixture
def cpu_profiler():
    """A CPU-only profiler session, started; stopped at teardown if the
    test left it running."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    live = [True]

    def stop():
        if live[0]:
            prof.stop()
            live[0] = False
        return prof

    yield stop
    stop()


def _op_event(prof, name: str):
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == name]
    assert len(evs) == 1, [e.name() for e in prof.profiler.kineto_results.events()]
    return evs[0]


def test_off_records_nothing(recorder):
    assert not torch.autograd.profiler._is_profiler_enabled
    t = profiling.begin()
    assert t == 0
    profiling.end("x", t)
    assert profiling.stage("y", 1) >= 0
    with profiling.annotate("z"):
        pass
    assert profiling.totals() == {}
    assert profiling.spans() == []
    assert profiling.dropped() == 0


def test_ring_is_allocated_by_the_first_record(recorder, monkeypatch):
    for ring in ("_names", "_starts", "_ends", "_threads"):
        monkeypatch.setattr(profiling, ring, None)
    profiling.end("x", profiling.begin())
    with profiling.annotate("y"):
        pass
    assert profiling._names is None and profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.end("x", profiling.begin())
    for ring in ("_names", "_starts", "_ends", "_threads"):
        assert len(getattr(profiling, ring)) == profiling.CAPACITY
    assert [r[0] for r in profiling.spans()] == ["x"]


def test_annotate_is_the_shared_null_context_when_off(recorder):
    a, b = profiling.annotate("a"), profiling.annotate("b")
    assert a is b
    with a as v:
        assert v is None
    assert profiling.totals() == {}


def test_spans_follow_the_profiler_session(recorder, cpu_profiler):
    x = torch.ones(1000)
    t = profiling.begin()
    assert t > 0
    y = x * 2
    profiling.end("mul", t)
    with profiling.annotate("outer"):
        t0 = __import__("time").time_ns()
        profiling.stage("inner", t0)
    prof = cpu_profiler()
    profiling.end("late", profiling.begin())   # after stop: nothing
    assert float(y.sum()) == 2000.0
    tot = profiling.totals()
    assert set(tot) == {"mul", "outer", "inner"}
    assert all(n == 1 for n, _ in tot.values())
    recs = {r[0]: r for r in profiling.spans()}
    assert [r[0] for r in profiling.spans()] == ["mul", "inner", "outer"]
    for name, (n, ns) in tot.items():
        assert ns == recs[name][2] - recs[name][1] >= 0
        assert recs[name][3] == threading.get_native_id()
    # the parent is the innermost containing span of the same thread
    assert recs["outer"][1] <= recs["inner"][1] <= recs["inner"][2] <= recs["outer"][2]
    # one clock: the span encloses the profiler's own event of the op
    ev = _op_event(prof, "aten::mul")
    _, a, b, _ = recs["mul"]
    assert a <= ev.start_ns() <= ev.end_ns() <= b


def test_ring_overflow_counts_dropped_and_keeps_totals(recorder, monkeypatch,
                                                      cpu_profiler):
    monkeypatch.setattr(profiling, "CAPACITY", 8)
    for ring in ("_names", "_starts", "_ends", "_threads"):
        monkeypatch.setattr(profiling, ring, [0] * 8)
    for i in range(20):
        t = profiling.begin()
        profiling.end("a" if i % 2 else "b", t)
    cpu_profiler()
    assert profiling.dropped() == 12
    tot = profiling.totals()
    assert tot["a"][0] == 10 and tot["b"][0] == 10
    recs = profiling.spans()
    assert len(recs) == 8
    # the newest eight, oldest first
    assert [r[0] for r in recs] == ["b", "a"] * 4
    assert all(x[1] <= y[1] for x, y in zip(recs, recs[1:]))
    profiling.reset()
    assert profiling.dropped() == 0 and profiling.spans() == []


def test_totals_stay_exact_across_threads(recorder, cpu_profiler):
    n_threads, n_each = 2 * (os.cpu_count() or 1) + 2, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                profiling.end("w", profiling.begin())

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    cpu_profiler()
    assert profiling.totals()["w"][0] == n_threads * n_each
    assert profiling.dropped() == max(0, n_threads * n_each - profiling.CAPACITY)


def test_trace_merges_program_spans_into_the_chrome_trace(recorder, tmp_path):
    x = torch.ones(1000)
    with profiling.trace(str(tmp_path)):
        t = profiling.begin()
        y = x * 3
        profiling.end("mul", t)
    assert float(y.sum()) == 3000.0
    doc = json.loads((tmp_path / "trace.json").read_text())
    prog = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    assert [e["name"] for e in prog] == ["mul"]
    op = [e for e in doc["traceEvents"]
          if e.get("name") == "aten::mul" and e.get("ph") == "X"]
    assert len(op) == 1
    s, o = prog[0], op[0]
    assert (s["pid"], s["tid"]) == (o["pid"], o["tid"])
    eps = 1e-3  # the file's microseconds, to the nanosecond
    assert s["ts"] <= o["ts"] + eps
    assert o["ts"] + o["dur"] <= s["ts"] + s["dur"] + eps


def test_interval_union_counts_overlaps_once():
    assert profiling.interval_union([]) == 0
    assert profiling.interval_union([(0, 10), (5, 20), (30, 40)]) == 30
    assert profiling.interval_union([(5, 6), (0, 10)]) == 10


# -- the fused wave's dispatch spans, with the bindings stubbed out --------
class _FakeBinding:
    """Every bound entry point as a no-op: the wave's host path runs on
    CPU tensors up to and through ``_native.launch``."""

    def __getattr__(self, entry):
        return lambda *args: None


def _stub_cuda_path(monkeypatch):
    monkeypatch.setattr(_native, "_module", _FakeBinding())
    monkeypatch.setattr(route, "_device", lambda t: "cuda")
    monkeypatch.setattr(plumbing, "_device", lambda t: "cuda")
    monkeypatch.setattr(K, "step", lambda st, ib, out_capacity: K._step_cuda(
        st, ib, out_capacity))


def _wave_inputs(G=6, P=3, W=8, E=2, budget=2, base=2):
    M = base + P * budget
    st = T.make_state(G, P, W, device="cpu",
                      peer_ids=[[1, 2, 3]] * G, replica_ids=[1, 2, 3] * (G // 3))
    ib = T.make_inbox(G, M, E, device="cpu")
    tab = torch.zeros((G, P), dtype=torch.int32)
    return st, ib, tab, dict(out_capacity=4, budget=budget, base=base)


def test_fused_rounds_records_the_dispatch_split(recorder, monkeypatch,
                                                 cpu_profiler):
    _stub_cuda_path(monkeypatch)
    st, ib, tab, kw = _wave_inputs()
    rounds = 3
    route.fused_rounds(st, ib, tab, tab, rounds=rounds, **kw)
    cpu_profiler()
    tot = profiling.totals()
    assert {k: n for k, (n, _) in tot.items()} == {
        "fused_rounds": 1,
        "raft_step.check": rounds, "raft_step.alloc": rounds,
        "merge_escalated.check": rounds,
        "route.check": rounds, "route.alloc": rounds,
        "launch.raft_step": rounds, "launch.merge_escalated": rounds,
        "launch.route": rounds,
    }
    recs = profiling.spans()
    wave = [r for r in recs if r[0] == "fused_rounds"][0]
    assert all(wave[1] <= r[1] <= r[2] <= wave[2] for r in recs)
    ctx = dict(rounds=rounds)
    launches = manifest.metric_reader("native_launches_per_round").read(ctx)
    assert launches == 3.0
    parts = sum(manifest.metric_reader(m).read(ctx) for m in _MS_READERS)
    assert parts == pytest.approx(tot["fused_rounds"][1] / 1e6 / rounds)


# -- the benchmark's readers -------------------------------------------------
_MS_READERS = ("dispatch_check_ms_per_round", "dispatch_alloc_ms_per_round",
               "dispatch_launch_ms_per_round", "dispatch_self_ms_per_round")

# 2 waves of 3 rounds; every figure in nanoseconds
_KNOWN = {
    "fused_rounds": (2, 6_000_000),
    "raft_step.check": (6, 600_000), "merge_escalated.check": (6, 300_000),
    "route.check": (6, 300_000),
    "raft_step.alloc": (6, 900_000), "route.alloc": (6, 300_000),
    "launch.raft_step": (6, 1_200_000), "launch.merge_escalated": (6, 600_000),
    "launch.route": (6, 1_200_000),
}


@pytest.mark.parametrize("name, want", [
    ("dispatch_check_ms_per_round", 0.2),
    ("dispatch_alloc_ms_per_round", 0.2),
    ("dispatch_launch_ms_per_round", 0.5),
    ("dispatch_self_ms_per_round", 0.1),
    ("native_launches_per_round", 3.0),
])
def test_dispatch_readers_read_known_totals(monkeypatch, name, want):
    monkeypatch.setattr(profiling, "totals", lambda: dict(_KNOWN))
    reader = manifest.metric_reader(name)
    assert reader.read(dict(rounds=6)) == pytest.approx(want)
    assert reader.read(dict(rounds=0)) is None
    no_wave = {k: v for k, v in _KNOWN.items() if k != "fused_rounds"}
    monkeypatch.setattr(profiling, "totals", lambda: no_wave)
    assert reader.read(dict(rounds=6)) is None
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert reader.read(dict(rounds=6)) is None
    # a program from before the recorder reads nothing
    monkeypatch.delattr(profiling, "totals")
    assert reader.read(dict(rounds=6)) is None


def test_dispatch_split_adds_up_to_the_wave(monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: dict(_KNOWN))
    ctx = dict(rounds=6)
    parts = sum(manifest.metric_reader(m).read(ctx) for m in _MS_READERS)
    assert parts == pytest.approx(_KNOWN["fused_rounds"][1] / 1e6 / 6)
