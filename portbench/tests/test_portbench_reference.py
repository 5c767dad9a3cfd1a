"""The frozen reference against the program's plain path, and the
checks against every planted fault, on the CPU at a small size."""
import numpy as np
import pytest
import torch

from portbench import faults
from portbench.harness import layout, manifest
from portbench.harness.loop import program_rounds
from portbench.reference import layout as RL
from portbench.reference import route as RR


@pytest.mark.parametrize("name", ["c4-100k-ragged.write", "ns-100k-x3.write",
                                  "c4-100k-ragged.idle"])
def test_reference_matches_the_program_plain_path(name):
    """The program's fused wave on CPU tensors (its plain versions) and the
    frozen reference agree word for word through elections and writes."""
    from dragonboat_tpu_torch.ops import types as T

    cell = manifest.cell(name)
    cfg = cell.config
    per = 9 // len(cfg["memberships"])
    cfg.update(groups=per * len(cfg["memberships"]),
               memberships={k: per for k in cfg["memberships"]},
               election_timeout=5, heartbeat_timeout=1)
    lay = layout.build(cfg, 2**35 + 3)
    ps = T.DeviceState(**{k: torch.from_numpy(v.copy()) for k, v in lay.state.items()})
    pi = T.Inbox(**{k: torch.from_numpy(v.copy()) for k, v in lay.inbox.items()})
    rs = RL.DeviceState(*[t.clone() for t in ps])
    ri = RL.Inbox(*[t.clone() for t in pi])
    dest = torch.from_numpy(lay.dest_row)
    rank = torch.from_numpy(lay.rank_in_dest)
    kw = dict(rounds=cfg["rounds_per_launch"], out_capacity=cfg["O"],
              budget=cfg["budget"], base=cfg["base"],
              propose_leaders=cell.traffic["propose_leaders"],
              propose_n=cell.traffic["propose_n"])
    for _ in range(12):
        ps, pi, pst, pe = program_rounds(ps, pi, dest, rank, **kw)
        rs, ri, rst, re_ = RR.fused_rounds(rs, ri, dest, rank, **kw)
        for a, b in zip(list(ps) + list(pi), list(rs) + list(ri)):
            assert torch.equal(a, b)
        assert torch.equal(pst, rst) and torch.equal(pe, re_)
    assert int((ps.role == RL.ROLE_LEADER).sum()) == lay.groups
    if cell.proposes:
        assert int(ps.committed.max()) > 0


def _cases():
    # each variant and the cell whose traffic takes the path it breaks
    return [(v, "c4-100k-ragged.write") for v in faults.VARIANTS
            if v != "control_lease"] + [
        ("control_lease", "c4-100k-ragged.idle"),
        ("state_unchanged", "c4-100k-ragged.idle"),
        ("answer_altered", "ns-100k-x3.write"),
    ]


@pytest.mark.parametrize("variant,name", _cases())
def test_each_fault_is_caught(variant, name, small_bench, tiny):
    res = small_bench.run(tiny(name), 2**41 + 9, 0.3, False, 0.0,
                          device="cpu", rounds_fn=faults.VARIANTS[variant],
                          block_rows=8)
    assert res["correct"] is False
    assert res["launches"] >= 1


@pytest.mark.parametrize("name", ["c4-100k-ragged.write", "c4-100k-ragged.idle",
                                  "ns-100k-x3.write"])
def test_sound_run_is_correct(name, small_bench, tiny):
    res = small_bench.run(tiny(name), 2**41 + 9, 0.3, False, 0.0,
                          device="cpu", block_rows=8)
    assert res["correct"] is True, res["checks"]
    assert all(v == 0 for v, _ in res["checks"].values())
    assert res["failed"] == 0
    assert res["leaders"] == 9
