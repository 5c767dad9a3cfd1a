"""The harness on the CPU: its files found by name, its inputs, its
checks, its byte counts and its result line."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from portbench.harness import check, layout, manifest
from portbench.roofline import raft_step as step_bytes
from portbench.roofline import route as route_bytes
from portbench.reference import layout as RL

ROOT = str(manifest.ROOT)


def _workloads():
    return manifest.load_manifest()["workloads"]


def test_every_cell_resolves_by_name():
    man = manifest.load_manifest()
    names = {m["name"] for m in man["per_layer"]}
    assert _workloads()
    for w in _workloads():
        cell = manifest.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert {m["name"] for m in cell.per_layer} <= names
        for m in cell.per_layer:
            assert callable(manifest.metric_reader(m["name"]).read)
    for kernel, mod in manifest.roofline_modules().items():
        assert mod.KERNELS and callable(mod.round_bytes), kernel


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        manifest.cell("no-such-config.write")


def test_config_files_match_manifest_entries():
    for c in manifest.load_manifest()["configs"]:
        cfg = json.loads(open(os.path.join(ROOT, c["file"])).read())
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert sum(cfg["memberships"].values()) == cfg["groups"]


def test_added_cell_needs_only_new_files(tmp_path):
    """A configuration, a mix, a metric and a cell added as new files and
    new manifest entries, in a copy of the benchmark, run without an edit
    to any file the benchmark had."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench/configs/tiny-x5.json").write_text(json.dumps(dict(
        name="tiny-x5", source="test", groups=4, memberships={"5": 4},
        P=5, W=16, E=2, O=16, budget=4, base=2, election_timeout=5,
        heartbeat_timeout=1, check_quorum=True, pre_vote=True,
        rounds_per_launch=2, pipeline_depth=2, reduced=[])))
    (tmp_path / "portbench/traffic/pairs.json").write_text(json.dumps(dict(
        name="pairs", propose_leaders=True, propose_n=1)))
    (tmp_path / "portbench/metrics/launches_seen.py").write_text(
        "def read(ctx):\n    return ctx['launches']\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append(dict(name="tiny-x5", source="test",
                               file="portbench/configs/tiny-x5.json",
                               reduced=[], why="test"))
    man["workloads"].append(dict(name="tiny-x5.pairs", config="tiny-x5",
                                 traffic="pairs", chips=1, why="test"))
    man["per_layer"].append(dict(name="launches_seen", unit="launches",
                                 better="higher", source="program_counter",
                                 layer="test", moves="group_rounds_per_s",
                                 workloads=["tiny-x5.pairs"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]
        from portbench.harness import bench, manifest
        assert manifest.ROOT == __import__('pathlib').Path({str(tmp_path)!r})
        bench.START_GROUPS, bench.START_LAUNCHES = 2, 6
        bench.STEADY_LAUNCHES, bench.ELECT_EVERY = 4, 2
        cell = manifest.cell("tiny-x5.pairs")
        res = bench.run(cell, 7, 0.3, True, time.perf_counter(), device="cpu")
        print(res["correct"], res["metrics"]["launches_seen"]["value"] > 0,
              res["entries"] > 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["True", "True", "True"]


def test_layout_matches_the_program_constructors():
    """The harness's vectorised state and tables are what the program's
    own constructors give (``make_state_np``, ``build_route_tables``)."""
    from dragonboat_tpu_torch.ops import route, types as T

    cfg = manifest.cell("c4-100k-ragged.write").config
    cfg.update(groups=12, memberships={"3": 4, "5": 4, "7": 4})
    lay = layout.build(cfg, 2**33 + 5)
    st = T.make_state_np(
        lay.G, cfg["P"], cfg["W"], shard_ids=lay.state["shard_id"],
        replica_ids=lay.state["replica_id"], peer_ids=lay.state["peer_id"],
        election_timeout=cfg["election_timeout"],
        heartbeat_timeout=cfg["heartbeat_timeout"], check_quorum=True,
        pre_vote=True)
    for k, v in st.items():
        np.testing.assert_array_equal(v, lay.state[k], err_msg=k)
    d, r = route.build_route_tables(lay.state["shard_id"],
                                    lay.state["replica_id"],
                                    lay.state["peer_id"])
    np.testing.assert_array_equal(d, lay.dest_row)
    np.testing.assert_array_equal(r, lay.rank_in_dest)


def test_seeds_run_the_same_groups_in_another_order():
    cfg = manifest.cell("c4-100k-ragged.write").config
    cfg.update(groups=30, memberships={"3": 10, "5": 10, "7": 10})
    a, b = layout.build(cfg, 1), layout.build(cfg, 2**40 + 1)
    key = lambda lay: sorted(zip(lay.state["shard_id"].tolist(),
                                 lay.state["replica_id"].tolist(),
                                 lay.state["rand_timeout"].tolist()))
    assert key(a) == key(b)
    assert not np.array_equal(a.state["shard_id"], b.state["shard_id"])
    np.testing.assert_array_equal(layout.build(cfg, 1).state["shard_id"],
                                  a.state["shard_id"])


def test_group_blocks_cover_rows_once():
    cfg = manifest.cell("c4-100k-ragged.write").config
    cfg.update(groups=30, memberships={"3": 10, "5": 10, "7": 10})
    lay = layout.build(cfg, 3)
    for rows in (1, 7, 20, 10**6):
        blocks = check.group_blocks(lay, rows)
        assert blocks[0][0] == 0 and blocks[-1][1] == lay.G
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        starts = set(lay.start.tolist()) | {lay.G}
        assert all(a in starts and b in starts for a, b in blocks)


def _state(G, P=3, W=4):
    z = {f: torch.zeros((G,), dtype=torch.int32) for f in RL.DeviceState._fields}
    for f in RL.PEER_FIELDS:
        z[f] = torch.zeros((G, P), dtype=torch.int32)
    for f in RL.RING_FIELDS:
        z[f] = torch.zeros((G, W), dtype=torch.int32)
    return RL.DeviceState(**z)


def test_guarantees_count_each_violation():
    gid = torch.tensor([0, 0, 0, 1, 1, 1])
    st = _state(6)
    ok = check.guarantees(st, st.committed.clone(), gid, 2)
    assert ok == dict(two_leaders_one_term=0, commit_went_back=0,
                      committed_term_conflicts=0)
    lead = st._replace(role=torch.tensor([3, 3, 0, 3, 0, 3], dtype=torch.int32),
                       term=torch.tensor([2, 2, 2, 1, 1, 2], dtype=torch.int32))
    assert check.guarantees(lead, st.committed, gid, 2)["two_leaders_one_term"] == 1
    back = st._replace(committed=torch.tensor([1, 0, 0, 0, 0, 0], dtype=torch.int32))
    start = torch.tensor([1, 1, 0, 0, 0, 0], dtype=torch.int32)
    assert check.guarantees(back, start, gid, 2)["commit_went_back"] == 1
    # rows 0 and 1 hold indexes 1..3 (ring slots 1..3), committed to 3 and
    # 2; they disagree on the term of index 2 (slot 2)
    ring = torch.zeros((6, 4), dtype=torch.int32)
    ring[0, 1:4] = torch.tensor([1, 1, 1])
    ring[1, 1:4] = torch.tensor([1, 2, 2])
    two = st._replace(last_index=torch.tensor([3, 3, 0, 0, 0, 0], dtype=torch.int32),
                      first_index=torch.ones(6, dtype=torch.int32),
                      committed=torch.tensor([3, 2, 0, 0, 0, 0], dtype=torch.int32),
                      ring_term=ring)
    assert check.guarantees(two, two.committed, gid, 2)["committed_term_conflicts"] == 1


def test_mismatched_words_counts_words():
    a = [torch.zeros(4, dtype=torch.int32), torch.ones((2, 3), dtype=torch.int32)]
    b = [torch.tensor([0, 1, 0, 2], dtype=torch.int32), torch.ones((2, 3), dtype=torch.int32)]
    assert check.mismatched_words(a, b) == 2
    assert check.mismatched_words(a, [a[0], torch.ones((3, 3))]) == 9


def test_raft_step_bytes_by_hand():
    st_in = _state(2)
    st_out = st_in._replace(term=torch.tensor([1, 0], dtype=torch.int32))
    M, E, O = 3, 2, 4
    ib = RL.Inbox(*([torch.zeros((2, M), dtype=torch.int32)] * 10
                    + [torch.zeros((2, M, E), dtype=torch.int32)] * 2))
    ib = ib._replace(mtype=torch.tensor([[1, 0, 4], [1, 0, 0]], dtype=torch.int32))
    out = dict(buf=torch.zeros((2, O, 11), dtype=torch.int32),
               count=torch.tensor([2, 9], dtype=torch.int32))
    rec = dict(state_in=st_in, state_out=st_out, inbox_in=ib,
               out=type("O", (), out))
    state_words = sum(t.numel() for t in st_in)
    want = (state_words + 1 + 2 * M + 3 * (9 + 2 * E) + (2 + 4) * 11 + 2)
    assert step_bytes.round_bytes(rec) == 4 * want


def test_route_bytes_by_hand():
    G, O, P, M, E = 2, 3, 3, 5, 2
    buf = torch.zeros((G, O, 11), dtype=torch.int32)
    buf[0, 0, 0] = 4          # a REPLICATE carrying 2 entries, delivered
    buf[0, 0, 9] = 2
    buf[0, 1, 0] = 10         # a heartbeat, delivered
    buf[1, 0, 0] = 4          # a REPLICATE of an escalated row
    buf[1, 0, 9] = 1
    out = type("O", (), dict(buf=buf, count=torch.tensor([2, 1], dtype=torch.int32),
                             escalate=torch.tensor([0, 1], dtype=torch.int32)))
    delivered = torch.tensor([[True, True, False], [False, False, False]])
    st = _state(G, P=P)
    ib = RL.Inbox(*([torch.zeros((G, M), dtype=torch.int32)] * 10
                    + [torch.zeros((G, M, E), dtype=torch.int32)] * 2))
    ib = ib._replace(mtype=torch.tensor([[1, 3, 4, 0, 0], [1, 0, 10, 0, 0]],
                                        dtype=torch.int32))
    rec = dict(out=out, delivered=delivered, state_out=st, inbox_out=ib)
    want = (2 * 10 + G * 6 + G * P * 3 + G * M + 5 * (9 + 2 * E) + 2 * 2)
    assert route_bytes.round_bytes(rec) == 4 * want


class _Ev:
    def __init__(self, name, a, b, dev=True):
        self._n, self._a, self._b, self._d = name, a, b, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False


def test_trace_union_and_idle_by_host(monkeypatch):
    from portbench.harness import trace

    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == 30 / 1e9
    evs = [_Ev("void raft_step_kernel(StepArgs)", 100, 200),
           _Ev("route_walk_kernel", 150, 260), _Ev("route_recv_kernel", 300, 400)]
    monkeypatch.setattr(trace, "_events", lambda prof: evs)
    tr = trace.reduce(None, 50, 450, [("dispatch", 40, 120), ("readback_wait", 255, 320)])
    assert tr["busy_s"] == pytest.approx(260 / 1e9)
    assert tr["window_s"] == pytest.approx(400 / 1e9)
    assert tr["kernel_s"]["raft_step_kernel"] == pytest.approx(100 / 1e9)
    # gaps: 50-100 (dispatch under way), 260-300 (readback_wait), 400-450
    assert tr["idle_by_host"]["dispatch"] == pytest.approx(50 / 1e9)
    assert tr["idle_by_host"]["readback_wait"] == pytest.approx(40 / 1e9)
    assert tr["idle_by_host"]["host_other"] == pytest.approx(50 / 1e9)


def test_result_line_keys(small_bench, tiny):
    from portbench import run

    res = small_bench.run(tiny("c4-100k-ragged.write"), 11, 0.3, False, 0.0,
                          device="cpu")
    out = run.result_line(res, False, 1, "cpu test")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "checks"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["correct"] is True
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    json.dumps(out)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from portbench import run

    base = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in run.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(base, dragonboat_tpu_torch=os,
                                             jaxtyping=os))
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(base, **{"jax.numpy": os,
                                                     "dragonboat_tpu.ops": os}))
    assert run.forbidden_modules() == ["dragonboat_tpu", "jax"]


def test_harness_loads_no_jax_and_the_reference_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import portbench.reference.route
        assert not [m for m in sys.modules if m.split('.')[0].startswith('dragonboat_tpu')], 'reference'
        from portbench import faults, run
        from portbench.harness import bench, trace
        print(run.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ns-100k-x3.write",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's files
    cannot run a cell."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ns-100k-x3.write",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_cells_run_on_the_card(card):
    """A short window of every cell, on the card, correct."""
    for w in _workloads():
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", w["name"],
             "--seed", "12345", "--seconds", "2", "--trace", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]


def test_roofline_readers_read_only_what_was_traced():
    ctx = dict(trace=None, round_bytes={"raft_step": 3.35e6}, rounds=10,
               kind="NVIDIA H100 80GB HBM3")
    reader = manifest.metric_reader("raft_step_roofline")
    assert reader.read(ctx) is None
    # 3.35 MB a round at 3.35 TB/s is 1 us; 2 us of device time a round
    ctx["trace"] = dict(kernel_s={"raft_step_kernel": 20e-6})
    assert reader.read(ctx) == pytest.approx(50.0)
    assert manifest.metric_reader("route_roofline").read(ctx) is None
