"""The rolling-restart churn cell (``c4-100k-churn.idle``) at a CPU
test's size: its configuration and schedule, and a run through the
harness that is correct, fails nothing, advances terms, and whose
election census (the program's, ``fused_rounds(census=...)``) equals the
same count taken from the frozen reference's outboxes over the window."""
import itertools
import time

import torch

from portbench.harness import check, manifest, partition
from portbench.reference import layout as RL
from portbench.reference import route as RR

from dragonboat_tpu_torch.ops import route as program_route

MT_REQUEST_VOTE, MT_REQUEST_VOTE_RESP = 6, 7
MT_REQUEST_PREVOTE, MT_REQUEST_PREVOTE_RESP = 8, 9
F_MTYPE, F_REJECT = 0, 6


def test_the_churn_configuration_is_c4_with_a_rolling_restart():
    churn = manifest.cell("c4-100k-churn.idle")
    c4 = manifest.cell("c4-100k-ragged.idle")
    own = {"name", "source", "deployment", "leader_churn", "reduced",
           "assumed", "partition"}
    for k, v in c4.config.items():
        if k not in own:
            assert churn.config[k] == v, k
    assert churn.config["leader_churn"] is True
    assert churn.config["reduced"] == []
    assert churn.traffic == c4.traffic
    phases = partition.phases(churn.config)
    assert phases == [p for k in range(1, 8) for p in (
        partition.Phase(20, (k,), 1.0), partition.Phase(20, ()))]
    assert sum(p.launches for p in phases) == 280


def _reference_census(launches, rank, kw) -> list:
    """The census of ``launches`` ((state, inbox, table) each) from the
    frozen reference's outboxes: every message below its row's count, of
    a row the round does not escalate, by type."""
    got = [0, 0, 0, 0]
    for st, ib, dest in launches:
        rec = []
        RR.fused_rounds(check.to_ref(st, RL.DeviceState, slice(None)),
                        check.to_ref(ib, RL.Inbox, slice(None)), dest, rank,
                        record=rec, **kw)
        for r in rec:
            out = r["out"]
            O = out.buf.shape[1]
            valid = ((torch.arange(O)[None, :] < out.count[:, None])
                     & (out.escalate == 0)[:, None])
            mt = out.buf[:, :, F_MTYPE]
            grant = valid & (out.buf[:, :, F_REJECT] == 0)
            got[0] += int((valid & (mt == MT_REQUEST_PREVOTE)).sum())
            got[1] += int((valid & (mt == MT_REQUEST_VOTE)).sum())
            got[2] += int((grant & (mt == MT_REQUEST_PREVOTE_RESP)).sum())
            got[3] += int((grant & (mt == MT_REQUEST_VOTE_RESP)).sum())
    return got


class _TickClock:
    """``time`` for the harness with a ``perf_counter`` that advances one
    tick a call, so a window holds the same launches on a loaded machine
    as on an idle one (``time_ns`` stays the real one)."""

    def __init__(self, tick: float):
        self._n = itertools.count()
        self.tick = tick

    def perf_counter(self) -> float:
        return next(self._n) * self.tick

    time_ns = staticmethod(time.time_ns)


def test_churn_cell_is_correct_and_counts_its_elections(small_bench, tiny,
                                                         monkeypatch):
    """9 groups, timeouts of 5 and 1 ticks: the window opens inside
    NodeHost 1's cut (set-up's 4 steady launches into the cycle) and runs
    through its heal into NodeHost 2's cut (60 launches: the window's
    clock ticks once a launch)."""
    monkeypatch.setattr(small_bench, "time", _TickClock(0.05))
    cell = tiny("c4-100k-churn.idle")
    census = torch.zeros(4, dtype=torch.int64)
    launches = []
    seen = {}

    def counted(state, inbox, dest, rank, **kw):
        launches.append((state, inbox, dest))
        seen.update(rank=rank, kw=kw)
        return program_route.fused_rounds(state, inbox, dest, rank,
                                          census=census, **kw)

    res = small_bench.run(cell, 2**41 + 19, 3.0, False, 0.0, device="cpu",
                          rounds_fn=counted, block_rows=8)
    assert res["correct"] is True, res["checks"]
    assert all(v == 0 for v, _ in res["checks"].values()), res["checks"]
    assert res["failed"] == 0, res["totals"]
    assert res["terms_advanced"] > 0
    assert res["totals"]["partition_dropped"] > 0
    assert len(launches) == res["launches"] >= 55
    # the window ran over a cut table and the whole one
    assert len({id(d) for _, _, d in launches}) >= 2

    want = _reference_census(launches, seen["rank"], seen["kw"])
    assert census.tolist() == want
    # pre-votes and votes asked and granted
    assert min(want) > 0, want
