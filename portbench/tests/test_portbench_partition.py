"""A configuration's partition schedule: its tables by hand, its phases,
its seeded draw, a cell that names one run end to end on the CPU, and the
check catching a program that ignores the cut."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from portbench.harness import check, layout, manifest, partition
from portbench.harness import loop as loop_mod
from portbench.harness.loop import program_rounds

ROOT = str(manifest.ROOT)


def _two_groups():
    """Group 0 of 3 replicas at rows 0-2, group 1 of 2 at rows 3-4, P 3."""
    cfg = dict(P=3, W=4, election_timeout=5, heartbeat_timeout=1,
               check_quorum=True, pre_vote=True)
    sizes = np.array([3, 2], np.int32)
    start, group, state, dest, rank = layout.rows_of(
        sizes, np.array([1, 2]), cfg)
    return layout.Layout(sizes=sizes, start=start, group=group, state=state,
                         inbox={}, dest_row=dest, rank_in_dest=rank)


def test_tables_by_hand():
    lay = _two_groups()
    np.testing.assert_array_equal(lay.dest_row, [[0, 1, 2], [0, 1, 2],
                                                 [0, 1, 2], [3, 4, -1],
                                                 [3, 4, -1]])
    # replica 2 cut in both groups: its own row (its own slot too) and
    # every peer's entry for it
    two = partition.table(lay, partition.Phase(3, (2,)), seed=1, index=1)
    np.testing.assert_array_equal(two, [[0, -1, 2], [-1, -1, -1],
                                        [0, -1, 2], [3, -1, -1],
                                        [-1, -1, -1]])
    # replica 3: only group 0 has one
    three = partition.table(lay, partition.Phase(3, (3,)), seed=1, index=1)
    np.testing.assert_array_equal(three, [[0, 1, -1], [0, 1, -1],
                                          [-1, -1, -1], [3, 4, -1],
                                          [3, 4, -1]])
    assert two.dtype == np.int32
    # a phase that cuts nothing is the unpartitioned table itself
    assert partition.table(lay, partition.Phase(3, ()), 1, 0) is lay.dest_row
    # the rank tables do not change
    assert lay.rank_in_dest.tolist() == [[0, 0, 0], [1, 1, 1], [2, 2, 2],
                                         [0, 0, 0], [1, 1, 0]]


def test_share_draw_is_seeded_per_membership_size():
    sizes = np.repeat(np.array([3, 5, 7], np.int32), 10)
    a = partition.cut_groups(sizes, 0.3, seed=2**33 + 1, index=1)
    np.testing.assert_array_equal(
        a, partition.cut_groups(sizes, 0.3, seed=2**33 + 1, index=1))
    for k in (3, 5, 7):
        assert int(a[sizes == k].sum()) == 3
    others = [partition.cut_groups(sizes, 0.3, seed=s, index=1)
              for s in (5, 6, 7)]
    assert any(not np.array_equal(a, b) for b in others)
    assert not np.array_equal(
        a, partition.cut_groups(sizes, 0.3, seed=2**33 + 1, index=3))
    assert partition.cut_groups(sizes, 1.0, seed=9, index=0).all()


def test_launch_to_phase_repeats_from_the_start():
    lay = _two_groups()
    sched = partition.Schedule(
        lay, [partition.Phase(2, ()), partition.Phase(3, (1,)),
              partition.Phase(1, (2,))], seed=4,
        dest=torch.from_numpy(lay.dest_row))
    sched.start = 5
    got = [sched.phase_of(n) for n in range(3, 19)]
    assert got == [None, None, 0, 0, 1, 1, 1, 2, 0, 0, 1, 1, 1, 2, 0, 0]
    assert sched.cycle == 6
    # uploaded once; the uncut phase passes the unpartitioned tensor
    assert sched.device[0] is not None and sched.host[0] is lay.dest_row
    np.testing.assert_array_equal(sched.device[1].numpy(), sched.host[1])


@pytest.mark.parametrize("block", [
    {},
    {"phases": []},
    {"phases": [{"launches": 0, "cut": []}]},
    {"phases": [{"cut": [1]}]},
    {"phases": [{"launches": 2.5, "cut": [1]}]},
    {"phases": [{"launches": 3, "cut": [8]}]},
    {"phases": [{"launches": 3, "cut": [0]}]},
    {"phases": [{"launches": 3, "cut": 1}]},
    {"phases": [{"launches": 3, "cut": [1], "share": 0}]},
    {"phases": [{"launches": 3, "cut": [1], "share": 1.5}]},
    {"phases": [[3, [1]]]},
])
def test_malformed_block_is_refused(block):
    with pytest.raises(ValueError):
        partition.phases(dict(P=7, partition=block))


def test_no_block_no_schedule():
    assert partition.phases(dict(P=7)) is None
    assert partition.phases(dict(P=7, partition={"phases": [
        {"launches": 3, "cut": [7], "share": 0.5}]})) == [
        partition.Phase(3, (7,), 0.5)]


def test_partition_cell_needs_only_new_files(tmp_path):
    """A configuration with a ``partition`` block, a mix and a cell added as
    new files and new manifest entries, in a copy of the benchmark, run
    without an edit to any file the benchmark had."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench/configs/tiny-churn.json").write_text(json.dumps(dict(
        name="tiny-churn", source="test", groups=4,
        memberships={"3": 2, "5": 2}, P=5, W=16, E=2, O=16, budget=4, base=2,
        election_timeout=5, heartbeat_timeout=1, check_quorum=True,
        pre_vote=True, rounds_per_launch=2, pipeline_depth=2, reduced=[],
        partition=dict(phases=[dict(launches=3, cut=[]),
                               dict(launches=4, cut=[1], share=0.5)],
                       about="test"))))
    (tmp_path / "portbench/traffic/trickle.json").write_text(json.dumps(dict(
        name="trickle", propose_leaders=True, propose_n=1)))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append(dict(name="tiny-churn", source="test",
                               file="portbench/configs/tiny-churn.json",
                               reduced=[], why="test"))
    man["workloads"].append(dict(name="tiny-churn.trickle",
                                 config="tiny-churn", traffic="trickle",
                                 chips=1, why="test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]
        from portbench import run
        from portbench.harness import bench, manifest
        assert manifest.ROOT == __import__('pathlib').Path({str(tmp_path)!r})
        bench.START_GROUPS, bench.START_LAUNCHES = 2, 6
        bench.STEADY_LAUNCHES, bench.ELECT_EVERY = 4, 2
        cell = manifest.cell("tiny-churn.trickle")
        res = bench.run(cell, 2**40 + 7, 0.3, False, time.perf_counter(),
                        device="cpu")
        out = run.result_line(res, False, 1, "cpu test")
        print(res["correct"], type(out["terms_advanced"]).__name__,
              "partition_dropped" in res["totals"], list(out)[-1])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["True", "int", "True", "checks"]


def _record_rounds(monkeypatch):
    """Every launch's peer table and, after it, the commit indexes summed
    over the rows of 3-replica groups."""
    seen = []
    fused = loop_mod.program_route.fused_rounds

    def rec(state, inbox, dest, rank, **kw):
        three = (state.peer_id != 0).sum(dim=1) == 3
        out = fused(state, inbox, dest, rank, **kw)
        seen.append((dest, int(out[0].committed[three].sum())))
        return out

    monkeypatch.setattr(loop_mod.program_route, "fused_rounds", rec)
    return seen


def test_churn_cell_is_correct_and_heals(small_bench, tiny, monkeypatch):
    """Replicas 1 and 2 cut for 5 launches (15 rounds, past the election
    timeout) in every group, under ticks and heartbeats: 3-replica groups
    lose their quorum and stop committing, the others elect around the
    cut; after the heal the 3-replica groups elect and commit again.
    Every compared number 0."""
    cell = tiny("c4-100k-ragged.idle")
    cell.config["partition"] = dict(phases=[dict(launches=5, cut=[]),
                                            dict(launches=5, cut=[1, 2])])
    seen = _record_rounds(monkeypatch)
    res = small_bench.run(cell, 2**41 + 9, 4.0, False, 0.0, device="cpu",
                          block_rows=8)
    assert res["correct"] is True, res["checks"]
    assert all(v == 0 for v, _ in res["checks"].values())
    assert res["launches"] >= 7, "the window did not reach a cut launch"
    assert res["terms_advanced"] > 0
    t = res["totals"]
    assert t["partition_dropped"] == t["dropped_off_device"] > 0
    assert res["failed"] == (t["escalated_rows"] + t["dropped_budget"]
                             + t["dropped_ring"])

    static = seen[0][0]
    cut = [d is not static for d, _ in seen]
    commits = [c for _, c in seen]
    assert sum(cut) >= 5
    first = cut.index(True)
    # from the cut's first launch on, nothing reaches a 3-replica group's
    # quorum: its commits stand still to the phase's end
    assert len(set(commits[first:first + 5])) == 1
    healed = first + 5
    assert not any(cut[healed:healed + 5])
    assert max(commits[healed:]) > commits[healed - 1]


def test_write_churn_trips_the_ring_window_defect(tiny):
    """Under writes, a deposed replica's uncommitted tail overwrites ring
    slots that, once the tail is truncated, lie inside the row's known
    window again (``_win_lo`` = last - (W - 1)): the row then reports the
    truncated entries' term for older committed indexes.  The program
    and the reference share that rule and agree word for word; the
    guarantee ``committed_term_conflicts`` catches it.  A known defect of
    the program (PERF.md, Open questions): when the program is repaired,
    this test fails and should then require 0."""
    from dragonboat_tpu_torch.ops import types as T

    from portbench.reference import layout as RL
    from portbench.reference import route as RR

    cfg = tiny("c4-100k-ragged.write").config
    seed = 2**41 + 9
    lay = layout.build(cfg, seed)
    ps = T.DeviceState(**{k: torch.from_numpy(v.copy())
                          for k, v in lay.state.items()})
    pi = T.Inbox(**{k: torch.from_numpy(v.copy()) for k, v in lay.inbox.items()})
    rs, ri = RL.DeviceState(*[t.clone() for t in ps]), RL.Inbox(*[t.clone() for t in pi])
    dest = torch.from_numpy(lay.dest_row)
    rank = torch.from_numpy(lay.rank_in_dest)
    gid = torch.from_numpy(lay.group.astype(np.int64))
    sched = partition.Schedule(lay, [partition.Phase(5, ()),
                                     partition.Phase(5, (1, 2))], seed, dest)
    sched.start = 12
    kw = dict(rounds=cfg["rounds_per_launch"], out_capacity=cfg["O"],
              budget=cfg["budget"], base=cfg["base"], propose_leaders=True,
              propose_n=1)
    conflicts = []
    for n in range(36):
        phase = sched.phase_of(n)
        d = dest if phase is None else sched.device[phase]
        ps, pi, _s, _e = program_rounds(ps, pi, d, rank, **kw)
        rs, ri, _s, _e = RR.fused_rounds(rs, ri, d, rank, **kw)
        assert check.mismatched_words(list(ps) + list(pi),
                                      list(rs) + list(ri)) == 0, n
        g = check.guarantees(ps, ps.committed, gid, lay.groups)
        assert g["two_leaders_one_term"] == 0
        conflicts.append(g["committed_term_conflicts"])
    assert max(conflicts) > 0, conflicts


def test_program_that_ignores_the_cut_is_caught(small_bench, tiny):
    """The program's wave routed over the unpartitioned table while
    replica 1 is cut: the window's words differ from the reference's."""
    cell = tiny("c4-100k-ragged.write")
    cell.config["partition"] = dict(phases=[dict(launches=4, cut=[1])])
    lay = layout.build(cell.config, 2**41 + 9)
    static = torch.from_numpy(lay.dest_row)

    def ignores_cut(state, inbox, dest, rank, **kw):
        return program_rounds(state, inbox, static, rank, **kw)

    res = small_bench.run(cell, 2**41 + 9, 0.3, False, 0.0, device="cpu",
                          rounds_fn=ignores_cut, block_rows=8)
    assert res["correct"] is False
    assert res["checks"]["window_words_differ"][0] > 0


def test_without_a_schedule_every_launch_gets_one_table(small_bench, tiny,
                                                        monkeypatch):
    cell = tiny("c4-100k-ragged.write")
    seen = _record_rounds(monkeypatch)
    res = small_bench.run(cell, 2**41 + 9, 0.3, False, 0.0, device="cpu",
                          block_rows=8)
    assert res["correct"] is True, res["checks"]
    assert len(seen) == res["setup_launches"] + res["launches"]
    assert all(d is seen[0][0] for d, _ in seen)
    assert res["terms_advanced"] is None
    assert "partition_dropped" not in res["totals"]
    t = res["totals"]
    assert res["failed"] == (t["escalated_rows"] + t["dropped_off_device"]
                             + t["dropped_budget"] + t["dropped_ring"])


def test_check_recomputes_over_the_launch_table():
    """``compare_launch`` given the launch's own table finds no difference
    where the unpartitioned one would, and the other way round."""
    cell = manifest.cell("c4-100k-ragged.write")
    cfg = cell.config
    cfg.update(groups=6, memberships={"3": 2, "5": 2, "7": 2},
               election_timeout=5, heartbeat_timeout=1)
    lay = layout.build(cfg, 2**36 + 1)
    from dragonboat_tpu_torch.ops import types as T

    st = T.DeviceState(**{k: torch.from_numpy(v.copy())
                          for k, v in lay.state.items()})
    ib = T.Inbox(**{k: torch.from_numpy(v.copy()) for k, v in lay.inbox.items()})
    kw = dict(rounds=cfg["rounds_per_launch"], out_capacity=cfg["O"],
              budget=cfg["budget"], base=cfg["base"], propose_leaders=True,
              propose_n=1)
    dest = torch.from_numpy(lay.dest_row)
    rank = torch.from_numpy(lay.rank_in_dest)
    for _ in range(8):
        st, ib, _s, _e = program_rounds(st, ib, dest, rank, **kw)
    cut = partition.table(lay, partition.Phase(1, (1,)), 3, 1)
    ins = (T.DeviceState(*[t.clone() for t in st]),
           T.Inbox(*[t.clone() for t in ib]))
    s2, i2, stats, esc = program_rounds(st, ib, torch.from_numpy(cut), rank,
                                        **kw)
    args = (lay, kw, ins, (s2, i2), stats.numpy().astype(np.int64),
            esc.numpy().astype(np.int64), torch.device("cpu"), 8)
    own = check.compare_launch(*args, dest_row=cut)
    assert own["words"] == 0 and own["counters"] == 0
    static = check.compare_launch(*args)
    assert static["words"] > 0
