"""Per-shard idle detection.

reference: quiesce.go (quiesceManager) [U].  After ``threshold`` ticks with
no activity the shard enters quiesce: no heartbeats are exchanged, ticks
become a counter increment — which is what lets one NodeHost hold millions
of idle groups.  Any message or proposal exits quiesce (with a burst of
LEADER_HEARTBEAT pokes so peers exit too).
"""
from __future__ import annotations

from ..pb import Message, MessageType


class QuiesceManager:
    __slots__ = ("enabled", "threshold", "idle_ticks", "quiesced",
                 "exit_grace", "busy_ticks")
    def __init__(self, enabled: bool, election_timeout: int, threshold_mult: int = 10):
        self.enabled = enabled
        self.threshold = election_timeout * threshold_mult
        self.idle_ticks = 0
        self.quiesced = False
        self.busy_ticks = 0
        self.exit_grace = 0

    def is_quiesced(self) -> bool:
        return self.quiesced

    def tick(self, busy: bool = False, block: bool = False) -> bool:
        """Advance one tick; returns True if (now) quiesced.

        ``busy`` blocks ENTRY (and resets the idle window) without
        counting as wake-the-peers activity: a leader with a follower
        still behind must keep heartbeating/probing — entering quiesce
        mid-catch-up strands the follower forever, since nobody
        generates the activity that would exit it (r4 colocated chaos
        finding: heal -> cluster idles out before the slow follower
        caught up).

        ``block`` blocks entry UNBOUNDEDLY (no 3-window give-up): a
        shard with NO KNOWN LEADER must never quiesce — its election
        churn is the only thing that can produce a leader, and parking
        it freezes that churn forever (r5 finding: colocated elections
        are device-routed and invisible to this manager, so a shard
        still electing at the idle threshold quiesced+parked mid-churn
        and slept leaderless for good)."""
        if not self.enabled:
            return False
        if block and not self.quiesced:
            self.idle_ticks = 0
            self.busy_ticks = 0
            return False
        if busy and not self.quiesced:
            # BOUNDED hold: an active catch-up clears busy within a few
            # windows; a permanently dead peer never will, and holding
            # forever would defeat 'idle groups cost nothing' for every
            # shard with a down member (review finding).  After 3
            # windows the shard quiesces anyway — the returning peer's
            # first message is activity and wakes it.
            self.busy_ticks += 1
            if self.busy_ticks < 3 * self.threshold:
                self.idle_ticks = 0
                return False
        else:
            self.busy_ticks = 0
        self.idle_ticks += 1
        if self.exit_grace > 0:
            self.exit_grace -= 1
            return False
        if not self.quiesced and self.idle_ticks >= self.threshold:
            self.quiesced = True
        return self.quiesced

    def tick_n(self, n: int, busy: bool = False, block: bool = False) -> int:
        """Advance ``n`` ticks at once; returns the number of LIVE
        (non-quiesced) ticks.  Bit-equivalent to ``n`` sequential
        ``tick()`` calls with constant busy/block — the common cases are
        O(1) (multi-tick fusion hands the planner tens of ticks per row
        per launch; a per-tick method call loop was a measurable slice
        of the 50k-row host plane)."""
        if n <= 0:
            return 0
        if not self.enabled:
            return n
        if block and not self.quiesced:
            self.idle_ticks = 0
            self.busy_ticks = 0
            return n
        if self.quiesced and not busy and not block:
            # swallowed wholesale (same arithmetic the loop would do)
            self.idle_ticks += n
            self.busy_ticks = 0
            return 0
        if (
            not self.quiesced
            and not busy
            and self.exit_grace == 0
            and n < self.threshold - self.idle_ticks
        ):
            # far from the idle threshold: all live, no crossing
            self.idle_ticks += n
            self.busy_ticks = 0
            return n
        live = 0
        for _ in range(n):  # rare paths (grace, busy-hold, crossing)
            if not self.tick(busy=busy, block=block):
                live += 1
        return live

    def record_activity(self, msg_type: MessageType) -> bool:
        """Returns True if this activity exits quiesce (caller must then
        poke peers with LEADER_HEARTBEAT)."""
        if not self.enabled:
            return False
        if msg_type in (MessageType.HEARTBEAT, MessageType.HEARTBEAT_RESP):
            # heartbeats are NEVER "activity" — neither to stay awake
            # (an idle-but-led group must quiesce) nor to wake up (a
            # stale in-flight heartbeat from a not-yet-quiesced leader
            # must not wake a just-quiesced follower: that churns the
            # shard through wake/election cycles forever).  A quiesced
            # node still processes heartbeats in raft; quiesce only
            # gates its timers.
            return False
        was = self.quiesced
        self.idle_ticks = 0
        self.busy_ticks = 0
        if self.quiesced:
            self.quiesced = False
            self.exit_grace = self.threshold
        return was

    def quiesce_hint(self) -> None:
        """A peer announced it is entering quiesce (pb.Quiesce [U]): join
        it if this node is also idle, so the whole shard goes silent
        together (the leader stops heartbeating promptly)."""
        if not self.enabled or self.quiesced:
            return
        if self.exit_grace > 0:
            # recently woken by activity the hint sender didn't see;
            # entering now would flag quiesced while tick() still runs
            # live timers for the rest of the grace window — a
            # half-quiesced node whose election can fire into a silent
            # shard
            return
        if self.idle_ticks >= self.threshold // 2:
            self.quiesced = True

    def new_to_quiesce(self) -> bool:
        return (
            self.enabled and not self.quiesced and self.idle_ticks >= self.threshold
        )
