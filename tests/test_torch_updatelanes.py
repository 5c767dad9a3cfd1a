"""The reference's update-lane cases on the port.

``test_updatelanes.py``'s ``TestFabricatedTraces``,
``TestUpdateLanesBlock``, ``TestLiveClusterParity`` and
``TestLaneSlotPersistReadback``, their source executed with every
``dragonboat_tpu`` import taken from ``dragonboat_tpu_torch``
(``load_on_port``): the port's ``hostplane`` lane planner against its
scalar twin on seeded traces, the lane block's per-device views under
the port's ``placement.rows_per_device`` / ``device_of_row``, a live
colocated cluster on ``ColocatedEngineGroup(device="cpu")`` with the
parity checker armed (the lane path carries rows, no parity failure, no
divergence halt, every resident row's lane words mirror its raft), and
the port's ``InMemLogDB`` hard-state lanes read back.

The edits to the reference's sources are those of
``port_loader.load_colocated_siblings`` (the engines' device, and
``test_vector_engine.py``'s import of the reference's engine factory,
which names the port's ``torch_step_engine_factory``).  No clock is
slowed: the live cluster ticks every 5 ms as the reference's does.
Directories are ``nh-tul-*`` under the temp dir.
"""
from __future__ import annotations

import pytest
import torch

from dragonboat_tpu_torch.ops import hostplane, placement
from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup
from dragonboat_tpu_torch.storage.logdb import InMemLogDB

from port_loader import (
    assert_port_only,
    load_colocated_siblings,
    load_on_port,
)

TAG = "tul"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the engines' small tensors: three
    NodeHosts step one shared core in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the siblings the live case reaches, with their engines on the CPU
_tcc = load_colocated_siblings(TAG, "cpu")["test_chaos_colocated"]
_lanes = load_on_port("test_updatelanes.py", f"{TAG}_updatelanes", tag=TAG)


def test_cases_run_on_the_port():
    assert _lanes.hp is hostplane
    assert _lanes.placement is placement
    cluster = _tcc.ColocatedCluster(seed=0)
    try:
        assert type(cluster.group) is ColocatedEngineGroup
        assert cluster.group.core._device.type == "cpu"
    finally:
        cluster.close()
    for mod in (_lanes, _tcc, __import__(f"{TAG}_test_chaos"),
                __import__(f"{TAG}_test_nodehost")):
        assert_port_only(mod)
    # the cases' function-level imports name the port's modules
    for cls, fn in ((_lanes.TestLaneSlotPersistReadback,
                     "test_lane_only_replica_reads_back"),
                    (_lanes.TestLiveClusterParity,
                     "test_live_cluster_lane_path")):
        names = getattr(cls, fn).__code__.co_names
        assert not [n for n in names if n.startswith("dragonboat_tpu.")]
    assert InMemLogDB.__module__ in getattr(
        _lanes.TestLaneSlotPersistReadback,
        "test_lane_only_replica_reads_back").__code__.co_names
    assert f"{TAG}_test_chaos_colocated" in getattr(
        _lanes.TestLiveClusterParity,
        "test_live_cluster_lane_path").__code__.co_names


class TestFabricatedTraces(_lanes.TestFabricatedTraces):
    pass


class TestUpdateLanesBlock(_lanes.TestUpdateLanesBlock):
    pass


class TestLiveClusterParity(_lanes.TestLiveClusterParity):
    pass


class TestLaneSlotPersistReadback(_lanes.TestLaneSlotPersistReadback):
    pass
