"""Execution engines (reference: engine.go execEngine [U]).

``ExecEngine`` is the host engine: fixed worker pools stepping many shards
with cross-shard batched WAL writes.  The TPU step engine
(dragonboat_tpu.engine.tpu_engine) plugs in via
``ExpertConfig.step_engine_factory``.
"""
from .execengine import ExecEngine, IStepEngine

__all__ = ["ExecEngine", "IStepEngine"]
