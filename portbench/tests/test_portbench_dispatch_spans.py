"""The program's host dispatch spans under the benchmark's CUDA-only
profiler, on the card: the split's readers read, the launches a round
are three, each step's launch span (``launch.raft_step_routed`` in the
rounds, ``launch.raft_step`` on the served paths) starts before its
kernel does on the device (one clock), and the recorder allocates
nothing after the harness's own warm-up."""
import time

import pytest

from portbench.harness import trace

SPLIT = ("dispatch_check_ms_per_round", "dispatch_alloc_ms_per_round",
         "dispatch_launch_ms_per_round", "dispatch_self_ms_per_round")
STEP_SPANS = ("launch.raft_step_routed", "launch.raft_step")


@pytest.mark.card
def test_dispatch_spans_on_the_card(card, tiny, monkeypatch):
    from dragonboat_tpu_torch import profiling

    from portbench.harness import bench

    # set-up's start check and elections cut for a small cell; the steady
    # launches stay the harness's own, which reach the window's peak of
    # live buffers (4 do not: the allocator then grows in the window)
    monkeypatch.setattr(bench, "START_GROUPS", 4)
    monkeypatch.setattr(bench, "START_LAUNCHES", 6)
    monkeypatch.setattr(bench, "ELECT_EVERY", 2)

    cell = tiny("ns-100k-x3.write")
    cell.config.update(groups=3000, memberships={"3": 3000})
    seen = {}
    reduce = trace.reduce

    def keep(prof, lo, hi, spans):
        seen["prof"] = prof
        return reduce(prof, lo, hi, spans)

    monkeypatch.setattr(trace, "reduce", keep)
    profiling.reset()
    res = bench.run(cell, 2**31 + 12345, 1.0, True, time.perf_counter(),
                          device="cuda")
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["native_launches_per_round"] == 3.0
    assert m["allocs_after_warm"] == 0
    assert sum(m[k] for k in SPLIT) == pytest.approx(
        m["dispatch_ms_per_round"], rel=0.05)
    starts = [r[1] for r in profiling.spans() if r[0] in STEP_SPANS]
    kernels = sorted(
        e.start_ns() for e in trace._events(seen["prof"])
        if trace._is_device(e) and trace.kernel_name(e.name()) == "raft_step_kernel")
    assert len(starts) == len(kernels) == res["rounds"]
    lead = sorted(k - a for a, k in zip(starts, kernels))
    assert lead[0] > 0, (
        f"{sum(x <= 0 for x in lead)} of {len(lead)} kernels start before "
        f"their launch span; lead ns min {lead[0]}, median "
        f"{lead[len(lead) // 2]}, max {lead[-1]}")
