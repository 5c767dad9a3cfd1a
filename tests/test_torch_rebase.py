"""The reference's rebase scenarios on the port's base engine.

``test_rebase.py``'s ``TestRebaseArithmetic``, ``TestDeviceReadsWithBase``
and ``TestClusterRebasing``, their source executed with every
``dragonboat_tpu`` import taken from ``dragonboat_tpu_torch``
(``load_on_port``) and ``VectorStepEngine`` bound to
``TorchStepEngine(..., device="cpu")``: the per-row rebase past 2^31
(``_compute_base``, ``_upload_rows``, ``_materialize_rows``) and the
shifted encode, decode and merge paths, on the kernels' plain versions.

The cluster case's NodeHosts (``test_vector_engine.py``'s
``make_vector_nodehost``, ``read_r`` and ``vec_shard_config``, which load
JAX) are the port's here: ``torch_step_engine_factory(device="cpu")`` at
the reference's geometry, ticking every 60 ms (the CPU's plain step is
slower a launch than the reference's compiled step), with their
directories ``nh-trb-vec-*`` under the temp dir.
"""
from __future__ import annotations

import tempfile
import time

from dragonboat_tpu_torch import (
    EngineConfig,
    ExpertConfig,
    NodeHost,
    NodeHostConfig,
)
from dragonboat_tpu_torch.ops.engine import TorchStepEngine
from dragonboat_tpu_torch.ops.engine import torch_step_engine_factory

from test_torch_storage import load_on_port

TAG = "trb"
RTT_MS = 60
# test_vector_engine.py's geometry
VGEOM = dict(capacity=16, P=5, W=32, M=8, E=4, O=32)

_rebase = load_on_port(
    "test_rebase.py", f"{TAG}_rebase", tag=TAG,
    replace=[
        ("from dragonboat_tpu.ops.engine import VectorStepEngine, _RowMeta",
         "from dragonboat_tpu.ops.engine import TorchStepEngine as "
         "VectorStepEngine, _RowMeta", 1),
        ("VectorStepEngine(None, **GEOM)",
         'VectorStepEngine(None, **GEOM, device="cpu")', 1),
        ("from test_vector_engine import make_vector_nodehost, read_r, \\\n"
         "            vec_shard_config",
         "make_vector_nodehost, read_r, vec_shard_config = PORT_HELPERS", 1),
    ])


def _shard_config(replica_id, shard_id=1, **kw):
    """``vec_shard_config`` on the port's ``shard_config``."""
    from trb_test_nodehost import shard_config

    kw.setdefault("election_rtt", 20)
    kw.setdefault("heartbeat_rtt", 2)
    return shard_config(replica_id, shard_id=shard_id, **kw)


def _make_nodehost(replica_id, rtt_ms=RTT_MS):
    """``make_vector_nodehost`` on the port's base engine."""
    from trb_test_nodehost import ADDRS

    return NodeHost(NodeHostConfig(
        nodehost_dir=f"{tempfile.gettempdir()}/nh-{TAG}-vec-{replica_id}",
        rtt_millisecond=rtt_ms,
        raft_address=ADDRS[replica_id],
        expert=ExpertConfig(
            engine=EngineConfig(exec_shards=1, apply_shards=2),
            step_engine_factory=torch_step_engine_factory(
                **VGEOM, device="cpu"),
        ),
    ))


def _read_r(nh, shard_id, query, deadline=30.0):
    """``read_r``: a read retried to its deadline."""
    end = time.time() + deadline
    while True:
        try:
            return nh.sync_read(shard_id, query, timeout=2.0)
        except Exception:  # noqa: BLE001 — retried as the reference's
            if time.time() >= end:
                raise
            time.sleep(0.05)


_rebase.PORT_HELPERS = (_make_nodehost, _read_r, _shard_config)


# the reference module's engine fixture (``TorchStepEngine`` on the CPU)
engine = _rebase.engine


def test_cases_run_on_the_port(engine):
    assert _rebase.VectorStepEngine is TorchStepEngine
    assert type(engine) is TorchStepEngine
    assert _rebase.Raft.__module__ == "dragonboat_tpu_torch.raft.raft"
    assert _rebase.StepInputs.__module__ == "dragonboat_tpu_torch.node"


class TestRebaseArithmetic(_rebase.TestRebaseArithmetic):
    pass


class TestDeviceReadsWithBase(_rebase.TestDeviceReadsWithBase):
    pass


class TestClusterRebasing(_rebase.TestClusterRebasing):
    pass
