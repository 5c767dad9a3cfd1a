"""The reference's scale path on the port: BASELINE configs 3 and 4.

``test_scale.py``'s ``run_scale`` — every replica of every shard on ONE
``ColocatedEngineGroup`` shared by the member NodeHosts, on-disk state
machines (its ``LazyDiskKV``), ``capacity = pow2(rows)``, W=16, M=8,
E=2, O=32, budget 8, a tick holiday while the shards start, sampled
proposals committed concurrently, then leader-election churn that
prefers a COLD kill (the victim shard quiesce-parked on every member
first, so its re-election needs ``Node.broadcast_wake``) — its source
executed with every ``dragonboat_tpu`` import taken from
``dragonboat_tpu_torch`` (``load_on_port``), on the port's
``ColocatedEngineGroup(device="cpu")``:

* config 3: 5 replicas a shard on 5 hosts, P = 5;
* config 4's ragged shape (``SCALE_MIXED=1``): 3-, 5- and 7-replica
  memberships in turn on 7 hosts, P = 7, the short ones' peer slots
  masked.

``SHARDS``, ``MIXED``, ``N_HOSTS`` and ``ADDRS`` are read when the
module loads, so each config loads it under its own tag, ``SCALE_MIXED``
set (or cleared) by ``monkeypatch`` first.  The counted edits to the
reference's source: the group's ``device="cpu"`` (the port's default is
the card, and nothing falls back to the CPU), the on-disk state
machines' ``/tmp/scale-sm`` moved under the temp dir (``nh-<tag>-``
NodeHost directories come from the tag), and the import of the
reference's ``vector_step_engine_factory`` (its other engine, unused
here) naming the port's ``torch_step_engine_factory``.  The assertions
are those of ``test_scale_churn_small`` and ``test_scale_shards``; the
clock is 60 ms, not 10 ms, as a CPU port cluster needs (ROADMAP §3),
which also makes the cold kill wait the 200 ticks a shard takes to park
(12 s of its 30 s bound).
"""
from __future__ import annotations

import tempfile

import pytest
import torch

from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup

from port_loader import assert_port_only, load_on_port

RTT_MS = 60
PROPOSALS = 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the engine's small tensors: five or seven
    NodeHosts step one shared core in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_scale(tag: str, monkeypatch, mixed: bool):
    """``tests/test_scale.py`` on the port under ``tag``, loaded with
    ``SCALE_MIXED`` set for config 4 and cleared for config 3."""
    if mixed:
        monkeypatch.setenv("SCALE_MIXED", "1")
    else:
        monkeypatch.delenv("SCALE_MIXED", raising=False)
    sm_dir = f"{tempfile.gettempdir()}/nh-{tag}-scale-sm"
    return load_on_port(
        "test_scale.py", f"{tag}_scale", tag=tag,
        replace=[
            ("group = ColocatedEngineGroup(",
             'group = ColocatedEngineGroup(device="cpu",', 1),
            ("/tmp/scale-sm", sm_dir, 2),
            ("from dragonboat_tpu.ops.engine import "
             "vector_step_engine_factory",
             "from dragonboat_tpu.ops.engine import "
             "torch_step_engine_factory as vector_step_engine_factory", 1),
        ])


def check_report(report: dict, shards: int) -> None:
    """``test_scale_churn_small``'s assertions, with ``test_scale_shards``'
    commit ratio and the device gates."""
    assert report["final_leader_coverage"] >= shards - 1, report
    assert report["proposals_committed"] >= (
        report["proposals_attempted"] * 0.9), report
    st = report["engine_stats"]
    assert st["device_rows_stepped"] > 0, report
    assert st["divergence_halts"] == 0, report
    ch = report["churn"]
    assert ch["kills"] == 1 and ch["reelected"] == 1, report
    assert ch["cold_kills"] == 1, report
    assert ch["violations"] == [], report
    assert ch["leaked_futures"] == 0, report


def run_config(tag: str, monkeypatch, shards: int, mixed: bool, P: int,
               hosts: int):
    mod = load_scale(tag, monkeypatch, mixed)
    assert_port_only(mod)
    assert mod.ColocatedEngineGroup is ColocatedEngineGroup
    assert mod.MIXED is mixed and mod.N_HOSTS == hosts
    groups = []

    class Recorded(ColocatedEngineGroup):
        def __init__(self, **kw):
            super().__init__(**kw)
            groups.append((self, kw))

    monkeypatch.setattr(mod, "ColocatedEngineGroup", Recorded)
    report = mod.run_scale(shards, engine="colocated", proposals=PROPOSALS,
                           churn_kills=1, rtt_ms=RTT_MS)
    print(report)
    [(group, kw)] = groups
    assert kw == dict(device="cpu", capacity=report["capacity"], P=P, W=16,
                      M=8, E=2, O=32, budget=8)
    assert group.core._device.type == "cpu"
    check_report(report, shards)
    return report


def test_config3_five_replicas_budget8_cold_kill(monkeypatch):
    """BASELINE config 3: 24 shards x 5 on-disk replicas on 5 hosts."""
    report = run_config("tsc3", monkeypatch, 24, mixed=False, P=5, hosts=5)
    assert report["replica_rows"] == 24 * 5
    assert report["capacity"] == 128


def test_config4_ragged_memberships_p7_cold_kill(monkeypatch):
    """BASELINE config 4's shape: 21 shards, 7 each of 3, 5 and 7
    replicas, on 7 hosts, P = 7."""
    report = run_config("tsc4", monkeypatch, 21, mixed=True, P=7, hosts=7)
    assert report["replicas"] == "3/5/7 mixed"
    assert report["replica_rows"] == 7 * (3 + 5 + 7)
    assert report["capacity"] == 128
