"""dragonboat_tpu_torch: the PyTorch/CUDA port of dragonboat_tpu.

A NodeHost hosting many raft shards whose step stage runs as hand-written
CUDA kernels (``ops/``) through ``ExpertConfig.step_engine_factory``.
The host plane (NodeHost, node, raft, storage, transport, rsm) is a
verbatim copy of the reference package's JAX-free modules; this package
imports neither ``jax`` nor ``dragonboat_tpu``.
"""
__version__ = "0.1.0"

from .config import Config, EngineConfig, ExpertConfig, NodeHostConfig
from .nodehost import NodeHost
from .statemachine import IStateMachine, Result

__all__ = [
    "Config",
    "EngineConfig",
    "ExpertConfig",
    "IStateMachine",
    "NodeHost",
    "NodeHostConfig",
    "Result",
]
