"""The reference's colocated quiesce, close and live-parity cases on
the port.

``test_colocated.py``'s ``TestColocatedQuiesce`` (device-resident rows
whose only input is the tick lane take the fast-lane quiesce path, park
on every member and wake on a proposal), ``test_lifecycle.py``'s
``test_colocated_cluster_close_leaks_no_threads`` (closing a live
colocated cluster joins every ``tpu-raft-*`` thread) and
``test_hostplane.py``'s ``TestLiveClusterParity`` (the port's
``hostplane.PARITY`` / ``RECORD`` switches on over a live chaos cluster
that elects, commits, takes nemesis-forced and real kernel escalations
and a membership change; every recorded generation replayed through the
vectorized merge sets and their scalar oracle), their source
executed with every ``dragonboat_tpu`` import taken from
``dragonboat_tpu_torch`` (``load_on_port``), on the port's
``ColocatedEngineGroup(device="cpu")``.

The edits to the reference's sources are those of
``port_loader.load_colocated_siblings`` (the engines' device, and
``test_vector_engine.py``'s import of the reference's engine factory,
which names the port's ``torch_step_engine_factory``), the close case's
own ``ColocatedEngineGroup`` call on ``device="cpu"`` (the live-parity
case's cluster is ``test_chaos_colocated.py``'s, on the CPU through the
siblings' edit; ``test_hostplane.py`` itself is not edited), and one
clock: the
quiesce case's cluster ticks every 20 ms, not 2 ms (election_rtt 10, so
a 200 ms election timeout, not 20 ms).  A plain-step launch on a loaded
CPU takes tens of ms, so at 2 ms a follower's election timer fired
between heartbeats; while the other two members parked, that follower
stayed a pre-candidate for good (its pre-votes are routed on the device
and wake no parked member), in the reference as on the port (ROADMAP §3
R1).  The close case keeps its 5 ms tick.  The reference's
``flaky_isolated`` retry is not carried: the quiesce case is a method of
the port's class here without the marker.  Directories are ``nh-tcl-*``
under the temp dir.
"""
from __future__ import annotations

import os
import sys
import tempfile

import pytest
import torch

from dragonboat_tpu_torch.ops import hostplane
from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup

from port_loader import (
    assert_port_only,
    load_colocated_siblings,
    load_on_port,
)

TAG = "tcl"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the engines' small tensors: three
    NodeHosts step one shared core in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the siblings the cases reach, with their engines on the CPU; the
# quiesce case's clock from 2 to 20 ms (see the module docstring)
QUIESCE_RTT_MS = 20
_sib = load_colocated_siblings(TAG, "cpu", edits={"test_colocated": [
    ("group, nhs = make_colocated_cluster(rtt_ms=2)",
     f"group, nhs = make_colocated_cluster(rtt_ms={QUIESCE_RTT_MS})", 1)]})
_colo = _sib["test_colocated"]
_life = load_on_port(
    "test_lifecycle.py", f"{TAG}_lifecycle", tag=TAG,
    replace=[("capacity=16, P=5, W=32, M=8, E=4, O=32, budget=2\n",
              'capacity=16, P=5, W=32, M=8, E=4, O=32, budget=2,\n'
              '            device="cpu",\n', 1)])
_hp = load_on_port("test_hostplane.py", f"{TAG}_hostplane", tag=TAG)


def test_cases_run_on_the_port():
    assert _colo.ColocatedEngineGroup is ColocatedEngineGroup
    group, nhs = _colo.make_colocated_cluster(rtt_ms=QUIESCE_RTT_MS)
    try:
        assert type(group) is ColocatedEngineGroup
        assert os.path.isdir(f"{tempfile.gettempdir()}/nh-tcl-colo-1")
        group.factory(None)
        assert group.core._device.type == "cpu"
        assert sys.modules[type(group.core).__module__].hostplane \
            is hostplane
    finally:
        for nh in nhs.values():
            nh.close()
    close_case = _life.TestProfiling.test_colocated_cluster_close_leaks_no_threads
    names = close_case.__code__.co_names
    assert "dragonboat_tpu_torch.ops.colocated" in names
    assert not [n for n in names if n.startswith("dragonboat_tpu.")]
    assert _hp.hp is hostplane
    for mod in (_life, _hp, *_sib.values(),
                __import__(f"{TAG}_test_nodehost")):
        assert_port_only(mod)


class TestColocatedQuiesce(_colo.TestColocatedQuiesce):
    def test_quiesce_enters_and_wakes_through_fast_lane(self):
        # the reference's case, without its retry-once marker
        super().test_quiesce_enters_and_wakes_through_fast_lane()


class TestColocatedClose:
    test_colocated_cluster_close_leaks_no_threads = (
        _life.TestProfiling.test_colocated_cluster_close_leaks_no_threads)


class TestLiveClusterParity(_hp.TestLiveClusterParity):
    pass
