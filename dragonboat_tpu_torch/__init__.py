"""dragonboat_tpu_torch: the PyTorch/CUDA port of dragonboat_tpu.

A NodeHost hosting many raft shards whose step stage runs as hand-written
CUDA kernels (``ops/``) through ``ExpertConfig.step_engine_factory``.
The host plane (NodeHost, node, raft, storage, transport, rsm) and the
control and serving planes on top of it (the fault nemesis ``faults``,
the linearizability ``audit``, the ``balance`` control plane and the
``gateway``) are verbatim copies of the reference package's JAX-free
modules; this package imports neither ``jax`` nor ``dragonboat_tpu``.
"""
__version__ = "0.1.0"

from .balance import (
    Balancer,
    BalanceAborted,
    DrainTimeout,
    MoveFailed,
)
from .client import LatencyBudget, Session, call_with_retry, propose_with_retry
from .config import Config, EngineConfig, ExpertConfig, GossipConfig, NodeHostConfig
from .gateway import (
    ClientHandle,
    Gateway,
    GatewayBusy,
    GatewayClosed,
    GatewayConfig,
)
from .faults import (
    RECOVERY_STATS,
    Fault,
    FaultController,
    FaultPlan,
    RecoveryStats,
    RecoverySLAAborted,
    RecoverySLAViolation,
    assert_recovery_sla,
)
from .nodehost import (
    NodeHost,
    NodeHostClosed,
    RequestDropped,
    RequestRejected,
    RequestTerminated,
    TimeoutError_,
)
from .pb import (
    ConfigChange,
    ConfigChangeType,
    Entry,
    EntryType,
    Membership,
    Message,
    MessageType,
    Snapshot,
    State,
    Update,
)
from .request import (
    RequestError,
    RequestResultCode,
    RequestState,
    ShardNotFound,
    SystemBusy,
)
from .statemachine import (
    IConcurrentStateMachine,
    IOnDiskStateMachine,
    IStateMachine,
    Result,
    SMEntry,
    SnapshotStopped,
)

__all__ = [
    "RECOVERY_STATS",
    "RecoveryStats",
    "Balancer",
    "BalanceAborted",
    "DrainTimeout",
    "MoveFailed",
    "LatencyBudget",
    "Session",
    "call_with_retry",
    "propose_with_retry",
    "Config",
    "EngineConfig",
    "ExpertConfig",
    "GossipConfig",
    "NodeHostConfig",
    "ClientHandle",
    "Gateway",
    "GatewayBusy",
    "GatewayClosed",
    "GatewayConfig",
    "NodeHost",
    "NodeHostClosed",
    "RequestDropped",
    "RequestRejected",
    "RequestTerminated",
    "TimeoutError_",
    "ConfigChange",
    "ConfigChangeType",
    "Entry",
    "EntryType",
    "Membership",
    "Message",
    "MessageType",
    "Snapshot",
    "State",
    "Update",
    "RequestError",
    "RequestResultCode",
    "RequestState",
    "ShardNotFound",
    "SystemBusy",
    "IConcurrentStateMachine",
    "IOnDiskStateMachine",
    "IStateMachine",
    "Result",
    "SMEntry",
    "SnapshotStopped",
]
