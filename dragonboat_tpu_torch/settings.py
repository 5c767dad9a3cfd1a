"""Package-level tunables.

reference: internal/settings/{soft,hard}.go [U].  ``Soft`` values may change
freely; ``Hard`` values are format invariants that must never change across
restarts of the same data dir.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class _Soft:
    # engine
    step_engine_worker_count: int = 16
    commit_worker_count: int = 16
    apply_worker_count: int = 16
    snapshot_worker_count: int = 48
    # queues
    incoming_proposal_queue_length: int = 2048
    incoming_read_index_queue_length: int = 4096
    received_message_queue_length: int = 1024
    # batching
    in_mem_entry_slice_size: int = 512
    max_entry_batch_size: int = 64 * 1024 * 1024
    max_message_batch_size: int = 64 * 1024 * 1024
    step_batch_max_updates: int = 1024
    # raft
    max_entries_per_replicate: int = 64
    max_replicate_bytes: int = 2 * 1024 * 1024
    in_memory_gc_cycle: int = 4
    quiesce_threshold_ticks_multiplier: int = 10
    # snapshots
    snapshot_chunk_size: int = 2 * 1024 * 1024
    max_concurrent_streaming_snapshots: int = 128
    # bounded re-stream before a stream job reports failure (each report
    # resets the remote to WAIT and costs a leader round trip)
    snapshot_stream_max_tries: int = 3
    # transport
    send_queue_length: int = 1024 * 2
    connection_retry_ticks: int = 5
    # tpu step engine
    device_msg_capacity_per_group: int = 8
    device_out_capacity_per_group: int = 8
    device_log_window: int = 256
    device_max_peers: int = 8


@dataclass
class _Hard:
    logdb_entry_batch_size: int = 48
    max_entry_size: int = 64 * 1024 * 1024
    lru_max_session_count: int = 4096
    logdb_shards: int = 16
    snapshot_header_size: int = 1024


Soft = _Soft()
Hard = _Hard()
