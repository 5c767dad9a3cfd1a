"""Chaos over the port's colocated engine, with the port's nemesis.

``test_chaos_colocated.py``'s ``TestColocatedChaos`` (partitions and
restarts, nemesis-forced kernel escalations under load, entry-cache
eviction pressure), its source executed with every ``dragonboat_tpu``
import taken from ``dragonboat_tpu_torch`` (``load_on_port``) and its
``ColocatedEngineGroup`` on ``device="cpu"``: the kernels' plain PyTorch
versions under the same invariants (acked writes survive, replicas
agree, routed deliveries > 0, no divergence fail-stop).  Directories
are ``nh-tcc-*`` under the temp dir, used by no other test.
"""
from __future__ import annotations

import tempfile

import pytest
import torch

from dragonboat_tpu_torch import FaultController
from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup

from test_torch_storage import (  # noqa: F401 (a fixture)
    load_on_port,
    port_lock_witness,
)

# the port's lock-order witness over the whole module
pytestmark = pytest.mark.usefixtures("port_lock_witness")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the engines' small tensors: several
    engines step at once in one process here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TAG = "tcc"
TMP = tempfile.gettempdir()


_cchaos = load_on_port(
    "test_chaos_colocated.py", f"{TAG}_chaos_colocated", tag=TAG,
    replace=[("ColocatedEngineGroup(**GEOM)",
              'ColocatedEngineGroup(**GEOM, device="cpu")', 1)])


def test_cluster_is_the_port_colocated_engine():
    cluster = _cchaos.ColocatedCluster()
    try:
        assert isinstance(cluster.nemesis, FaultController)
        assert isinstance(cluster.group, ColocatedEngineGroup)
        assert cluster._dir(1) == f"{TMP}/nh-tcc-cchaos-1"
        assert str(cluster.group.core._device) == "cpu"
        assert all(nh.engine.step_engine.core is cluster.group.core
                   for nh in cluster.nhs.values())
    finally:
        cluster.close()


class TestColocatedChaos(_cchaos.TestColocatedChaos):
    def test_forced_kernel_escalations_under_load(self):
        # the reference's case, without its retry-once marker
        super().test_forced_kernel_escalations_under_load()
