"""Leader's per-follower replication flow state.

reference: internal/raft/remote.go [U].  States:

  * RETRY      — probing: send one batch, then pause (WAIT) until a
                 response or heartbeat-resp resumes it.
  * WAIT       — paused probe.
  * REPLICATE  — pipelining: optimistic ``next`` advance on send.
  * SNAPSHOT   — streaming a snapshot; paused until SnapshotStatus.

The integer values are part of the device SoA encoding (ops/state.py).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List


class RemoteState(enum.IntEnum):
    RETRY = 0
    WAIT = 1
    REPLICATE = 2
    SNAPSHOT = 3


@dataclass(slots=True)
class Remote:
    match: int = 0
    next: int = 1
    state: RemoteState = RemoteState.RETRY
    snapshot_index: int = 0
    active: bool = False  # contacted since last CheckQuorum sweep
    # CheckQuorum-lease contact evidence (raft.lease_remaining_ticks):
    # ``last_resp_tick`` is the leader tick a response PROVED contact at
    # — anchored at a probe's SEND tick, never at response receipt (a
    # response can sit in flight or queue in the leader's inbox
    # arbitrarily long; anchoring at receipt would extend the claimed
    # lease past the follower's actual vote-refusal window by that
    # delay — review finding).  ``probe_queue`` is a FIFO of
    # outstanding probe send ticks: each response pops the head.  Both
    # transports deliver per peer pair in order and the follower
    # responds in processing order, so the popped tick is the send tick
    # of the answered probe — or OLDER whenever any earlier probe or
    # response was dropped (the unanswered entry stays queued and
    # shifts every later pop one probe older), which only ever makes
    # the anchor conservative.  The queue is never cleared mid-
    # leadership (clearing let a delayed response anchor at a probe
    # armed AFTER it — review finding); accumulated message loss thus
    # decays lease availability (reads fall back to ReadIndex), never
    # safety, and the queue resets with fresh leadership.  Bounded:
    # arms are skipped when full (skipping keeps pops older = safe).
    last_resp_tick: int = -1
    probe_queue: List[int] = field(default_factory=list)

    def reset(self, next_index: int, match: int = 0) -> None:
        self.match = match
        self.next = next_index
        self.state = RemoteState.RETRY
        self.snapshot_index = 0

    def is_paused(self) -> bool:
        return self.state in (RemoteState.WAIT, RemoteState.SNAPSHOT)

    def is_active(self) -> bool:
        return self.active

    def set_active(self) -> None:
        self.active = True

    def clear_active(self) -> None:
        self.active = False

    # -- state transitions ------------------------------------------------
    def become_retry(self) -> None:
        if self.state == RemoteState.SNAPSHOT:
            self.next = max(self.match + 1, self.snapshot_index + 1)
        else:
            self.next = self.match + 1
        self.snapshot_index = 0
        self.state = RemoteState.RETRY

    def become_wait(self) -> None:
        self.become_retry()
        self.state = RemoteState.WAIT

    def become_replicate(self) -> None:
        self.next = self.match + 1
        self.snapshot_index = 0
        self.state = RemoteState.REPLICATE

    def become_snapshot(self, index: int) -> None:
        self.state = RemoteState.SNAPSHOT
        self.snapshot_index = index

    def clear_pending_snapshot(self) -> None:
        self.snapshot_index = 0

    def retry_to_wait(self) -> None:
        if self.state == RemoteState.RETRY:
            self.state = RemoteState.WAIT

    def wait_to_retry(self) -> None:
        if self.state == RemoteState.WAIT:
            self.state = RemoteState.RETRY

    # -- progress ---------------------------------------------------------
    def progress(self, last_index: int) -> None:
        """Record that entries up to ``last_index`` were just sent."""
        if self.state == RemoteState.REPLICATE:
            self.next = last_index + 1
        elif self.state == RemoteState.RETRY:
            self.retry_to_wait()
        else:
            raise RuntimeError(f"progress called in state {self.state}")

    def respond_to(self) -> None:
        """A response arrived: unpause probing."""
        if self.state == RemoteState.WAIT:
            self.state = RemoteState.RETRY

    def try_update(self, index: int) -> bool:
        """Follower acked ``index``; returns True if match advanced."""
        if self.next < index + 1:
            self.next = index + 1
        if self.match < index:
            self.match = index
            if self.state == RemoteState.WAIT:
                self.state = RemoteState.RETRY
            return True
        return False

    def decrease(self, rejected_index: int, peer_last_index: int) -> bool:
        """Handle a log-matching rejection (reference: remote.decreaseTo [U]).

        ``rejected_index`` is the prev_log_index the follower rejected;
        ``peer_last_index`` the follower's hint (its last index).
        Returns False if the rejection is stale.
        """
        if self.state == RemoteState.REPLICATE:
            if rejected_index <= self.match:
                return False  # stale
            self.become_retry()
            return True
        if self.next - 1 != rejected_index:
            return False  # stale
        self.next = max(min(rejected_index, peer_last_index + 1), self.match + 1, 1)
        self.wait_to_retry()
        return True
