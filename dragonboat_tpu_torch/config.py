"""Configuration objects (reference: config/config.go [U]).

``Config`` is per-replica, ``NodeHostConfig`` per-process, ``ExpertConfig``
holds the sanctioned plug points — including ``step_engine_factory``, the
TPU-native addition that swaps the serial host step loop for the vectorized
device engine (the north-star plug point beside ``logdb_factory`` /
``transport_factory``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


class ConfigError(ValueError):
    pass


@dataclass
class Config:
    """Per-replica raft configuration (reference: config.Config [U]).

    Time is logical: ``election_rtt`` / ``heartbeat_rtt`` are in units of
    ``NodeHostConfig.rtt_millisecond`` ticks — never wall clock.  This is
    what makes the protocol core a pure, reproducible function and lets it
    run on device.
    """

    replica_id: int = 0
    shard_id: int = 0
    check_quorum: bool = False
    pre_vote: bool = False
    election_rtt: int = 10
    heartbeat_rtt: int = 1
    snapshot_entries: int = 0          # 0 disables periodic snapshots
    compaction_overhead: int = 5
    ordered_config_change: bool = False
    max_in_mem_log_size: int = 0       # 0 = unlimited (bytes)
    snapshot_compression: int = 0
    entry_compression: int = 0
    disable_auto_compactions: bool = False
    is_non_voting: bool = False
    is_witness: bool = False
    quiesce: bool = False

    def validate(self) -> None:
        if self.replica_id == 0:
            raise ConfigError("invalid replica_id 0")
        if self.heartbeat_rtt <= 0:
            raise ConfigError("heartbeat_rtt must be > 0")
        if self.election_rtt <= 2 * self.heartbeat_rtt:
            raise ConfigError("election_rtt must be > 2 * heartbeat_rtt")
        if self.election_rtt < 10 * self.heartbeat_rtt:
            import warnings

            warnings.warn(
                "election_rtt < 10 * heartbeat_rtt; recommended ratio is 10x"
            )
        if self.max_in_mem_log_size != 0 and self.max_in_mem_log_size < 65536:
            raise ConfigError("max_in_mem_log_size must be >= 64KiB or 0")
        from .pb import CompressionType

        try:
            CompressionType(self.snapshot_compression)
        except ValueError:
            raise ConfigError(
                f"invalid snapshot_compression {self.snapshot_compression}"
            )
        if self.is_witness and self.snapshot_entries > 0:
            raise ConfigError("witness can not take snapshots")
        if self.is_witness and self.is_non_voting:
            raise ConfigError("witness can not be a non-voting replica")


@dataclass
class GossipConfig:
    """Gossip-registry config (reference: config.GossipConfig [U])."""

    bind_address: str = ""
    advertise_address: str = ""
    seed: list = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.bind_address


@dataclass
class ExpertConfig:
    """Advanced tuning + plug points (reference: config.ExpertConfig [U]).

    ``step_engine_factory`` is the TPU-native addition described in the
    north star: a callable ``(nodehost) -> IStepEngine`` that replaces the
    default host step loop with the vectorized device engine.
    """

    engine: "EngineConfig" = None  # type: ignore[assignment]
    logdb_factory: Optional[Callable] = None
    transport_factory: Optional[Callable] = None
    step_engine_factory: Optional[Callable] = None
    snapshot_storage_factory: Optional[Callable] = None
    fs: Optional[object] = None              # vfs injection for tests
    test_node_host_id: int = 0
    test_gossip_probe_interval_ms: int = 0

    def __post_init__(self):
        if self.engine is None:
            self.engine = EngineConfig()


@dataclass
class EngineConfig:
    """Worker-pool sizing (reference: config.EngineConfig / settings.Soft [U])."""

    exec_shards: int = 16
    commit_shards: int = 16
    apply_shards: int = 16
    snapshot_shards: int = 48
    close_shards: int = 32


@dataclass
class NodeHostConfig:
    """Per-process configuration (reference: config.NodeHostConfig [U]).

    ``tick_sweep_batch`` coarsens the host ticker: the per-node sweep
    runs only every Nth ``rtt_millisecond`` period, crediting N logical
    ticks at once — the same logical tick RATE at 1/N the per-node host
    cost (the mass-start tooling knob, formerly the undocumented
    ``TICK_SWEEP_BATCH`` env var, which remains honoured when this field
    is 0).  Timing-granularity implication: election/heartbeat/quiesce
    deadlines are still crossed at the right tick COUNT, but the
    crossing is only observed at sweep boundaries, so any raft timer can
    fire up to ``(N-1) * rtt_millisecond`` wall-clock late and N ticks
    land in one step with no wall time between them for responses.
    Keep ``N * heartbeat_rtt`` well under ``election_rtt`` or healthy
    leaders will flap; intended for experiments and mass-start tooling,
    not steady-state deployments.  0 = use the env var, else 1.
    """

    deployment_id: int = 0
    nodehost_dir: str = ""
    wal_dir: str = ""
    rtt_millisecond: int = 200
    raft_address: str = ""
    address_by_nodehost_id: bool = False
    listen_address: str = ""
    mutual_tls: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    max_send_queue_size: int = 0
    max_receive_queue_size: int = 0
    max_snapshot_send_bytes_per_second: int = 0
    max_snapshot_recv_bytes_per_second: int = 0
    notify_commit: bool = False
    enable_metrics: bool = False
    # observability (dragonboat_tpu.obs, docs/OBSERVABILITY.md): both
    # off by default; the disabled hot paths cost one attribute load.
    # ``trace_sample_rate`` bounds per-request tracing cost at high
    # rates (the sampling decision is made once, at the root span).
    enable_tracing: bool = False
    trace_sample_rate: float = 1.0
    enable_flight_recorder: bool = False
    tick_sweep_batch: int = 0  # 0 = TICK_SWEEP_BATCH env var, else 1
    gossip: GossipConfig = field(default_factory=GossipConfig)
    expert: ExpertConfig = field(default_factory=ExpertConfig)
    raft_event_listener: Optional[object] = None
    system_event_listener: Optional[object] = None

    def validate(self) -> None:
        if not self.nodehost_dir:
            raise ConfigError("nodehost_dir not set")
        if self.rtt_millisecond <= 0:
            raise ConfigError("rtt_millisecond must be > 0")
        if self.tick_sweep_batch < 0:
            raise ConfigError("tick_sweep_batch must be >= 0")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ConfigError("trace_sample_rate must be in [0, 1]")
        if not self.raft_address:
            raise ConfigError("raft_address not set")
        if self.address_by_nodehost_id and self.gossip.is_empty():
            raise ConfigError("gossip config required for address_by_nodehost_id")

    def get_listen_address(self) -> str:
        return self.listen_address or self.raft_address
