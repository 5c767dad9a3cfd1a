"""The reference's launch-pipeline and fused-wave contracts on the port.

``test_pipeline.py``'s ``TestPipelineFences``, ``TestPipelineKnobs`` and
``TestFusedWaves``, their source executed with every ``dragonboat_tpu``
import taken from ``dragonboat_tpu_torch`` (``load_on_port``), on the
port's ``ColocatedEngineGroup(device="cpu")``: the fence (F1, through
the module's ``arm_fence_probe`` on the port's core), the hostplane
parity oracle (F2, the module's autouse ``parity_oracle`` arming the
port's ``hostplane.PARITY``), exactly-once applies on every replica (F3),
one readback window per generation (W1), single-round fences under an
escalation hold (W2) and the depth and fused-round knobs.

The edits to the reference's sources are those of
``port_loader.load_colocated_siblings``: the engine's device, made once
in the geometry every case builds from (``test_colocated.py``'s ``GEOM``
and ``test_chaos_colocated.py``'s ``ColocatedEngineGroup`` call), and
``test_vector_engine.py``'s import of the reference's engine factory,
which names the port's ``torch_step_engine_factory``.  No clock is
slowed: the clusters tick every 5 ms as the reference's do.  On the CPU
a generation's readback is complete at dispatch, so the in-flight window
the fences drain comes from the reference's own sync floor
(``sync_floor_ms``).  The escalation-hold case holds the lowest resident
row; where the election put the leader there, the case cannot see a
fence in the reference or on the port, so its leadership moves off that
row first (``port_loader.leader_off_first_row``; ROADMAP §3 R2).
Directories are ``nh-tpl-*`` under the temp dir.
"""
from __future__ import annotations

import pytest
import torch

from dragonboat_tpu_torch.ops import hostplane
from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup

from port_loader import (
    assert_port_only,
    leader_off_first_row,
    load_colocated_siblings,
    load_on_port,
)

TAG = "tpl"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the engines' small tensors: three
    NodeHosts step one shared core in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the siblings the module reaches, with their engines on the CPU
_sib = load_colocated_siblings(TAG, "cpu")
_pipe = load_on_port("test_pipeline.py", f"{TAG}_pipeline", tag=TAG)

# F2: the module's autouse fixture, armed on the port's hostplane
parity_oracle = _pipe.parity_oracle


def test_cases_run_on_the_port():
    assert _pipe.ColocatedEngineGroup is ColocatedEngineGroup
    assert _pipe.hostplane is hostplane
    assert _pipe.PIPE_GEOM["device"] == "cpu"
    group = ColocatedEngineGroup(**_pipe.PIPE_GEOM)
    group.factory(None)
    assert type(group.core).__module__ == "dragonboat_tpu_torch.ops.colocated"
    assert group.core._device.type == "cpu"
    assert group.core._pipeline_depth == 2
    for mod in (_pipe, *_sib.values(), __import__(f"{TAG}_test_nodehost"),
                __import__(f"{TAG}_test_chaos")):
        assert_port_only(mod)


class TestPipelineFences(_pipe.TestPipelineFences):
    pass


class TestPipelineKnobs(_pipe.TestPipelineKnobs):
    pass


class TestFusedWaves(_pipe.TestFusedWaves):
    def test_escalation_hold_fences_to_single_round(self, monkeypatch):
        # the reference's case with its leader kept off the row it holds
        # (port_loader.leader_off_first_row, ROADMAP §3 R2)
        monkeypatch.setattr(_pipe, "wait_for_leader",
                            leader_off_first_row(_pipe.wait_for_leader))
        super().test_escalation_hold_fences_to_single_round()
