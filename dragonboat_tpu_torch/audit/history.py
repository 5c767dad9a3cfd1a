"""Concurrent history recording + the instrumented audit client.

An :class:`Op` is one client-visible operation with its real-time
interval ``[invoke, ret]`` (``time.monotonic`` instants) and a final
status:

* ``ok``   — the cluster acked it; it definitely took effect (writes)
  or definitely observed the returned value (reads);
* ``fail`` — it definitely did NOT take effect (rejected before
  proposal, or a read that never returned — reads have no effect);
* ``ambig`` — *maybe committed*: the client gave up on a timeout (or a
  terminated/closed replica after the entry may already have been
  replicated).  Ambiguous writes keep ``ret = +inf`` — their effect may
  surface at ANY later point, which is exactly how the checker treats
  them (free to linearize anywhere after invoke, or never).

:class:`AuditClient` drives ``Session``-based ``sync_propose`` /
``sync_read`` / ``stale_read`` against a *live host map* (hosts churn
under the nemesis, so every attempt re-picks a live NodeHost).  Write
retries keep the SAME series id, so the server's session registry
dedupes re-applies — the exactly-once property the session pass then
proves from the replica journals.
"""
from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import asdict, dataclass
from random import Random
from typing import Dict, List, Optional

from ..nodehost import (
    NodeHostClosed,
    RequestRejected,
    RequestTerminated,
    TimeoutError_,
)
from .model import audit_set_cmd

# errors after which the entry MAY already be replicated (ambiguous);
# isinstance, not type-name matching — a subclassed timeout must never
# demote "maybe committed" to "definitely failed" (that would make the
# audit unsound, not conservative)
_MAYBE_COMMITTED_ERRORS = (TimeoutError_, RequestTerminated, NodeHostClosed)


@dataclass
class Op:
    client: int
    index: int
    # "w" | "r" | "stale" | "bounded".  Follower-linearizable reads
    # record as "r": they promise the SAME contract as a leader read,
    # so they join the Wing–Gong pass unchanged — that IS the safety
    # check (docs/READPLANE.md).  "bounded" reads are exempt from
    # recency but carry their stamp in ``value`` as (applied_index,
    # staleness_ticks, bound_ticks) for check_bounded_reads.
    kind: str
    key: object
    value: object = None  # written value (writes) / stamp (bounded reads)
    output: object = None  # observed value (reads) / apply index (writes)
    status: str = "pending"  # pending -> ok | fail | ambig
    invoke: float = 0.0
    ret: float = math.inf

    def describe(self) -> str:
        iv = f"{self.invoke:.6f}"
        rv = "inf" if self.ret == math.inf else f"{self.ret:.6f}"
        return (
            f"c{self.client}#{self.index} {self.kind}({self.key!r}"
            f"{'=' + repr(self.value) if self.kind == 'w' else ''})"
            f" -> {self.status}"
            f"{':' + repr(self.output) if self.kind != 'w' else ''}"
            f" [{iv}, {rv}]"
        )


class HistoryRecorder:
    """Thread-safe append-only op log shared by all audit clients."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: List[Op] = []
        self._clients = 0

    def new_client(self) -> int:
        with self._lock:
            self._clients += 1
            return self._clients

    def invoke(self, client: int, kind: str, key, value=None) -> Op:
        op = Op(
            client=client,
            index=0,
            kind=kind,
            key=key,
            value=value,
            invoke=time.monotonic(),
        )
        with self._lock:
            op.index = len(self._ops)
            self._ops.append(op)
        return op

    def ok(self, op: Op, output=None) -> None:
        op.ret = time.monotonic()
        op.output = output
        op.status = "ok"

    def fail(self, op: Op) -> None:
        op.ret = time.monotonic()
        op.status = "fail"

    def ambiguous(self, op: Op) -> None:
        # ret stays +inf: a maybe-committed effect can land any time later
        op.status = "ambig"

    def ops(self) -> List[Op]:
        with self._lock:
            return list(self._ops)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops():
            out[o.status] = out.get(o.status, 0) + 1
        return out

    def ops_for(self, key_prefix) -> List[Op]:
        """The sub-history whose keys start with ``key_prefix`` (str or
        bytes, matched against same-typed keys).  A recorder shared by
        several shards keys each shard's traffic under its own prefix;
        the per-key linearizability search never mixes them, but the
        SESSION pass must be scoped to the one shard whose replica
        journals it is judging against — this is that scope."""
        return [
            o for o in self.ops()
            if isinstance(o.key, type(key_prefix))
            and o.key.startswith(key_prefix)
        ]

    # -- replay serialization (docs/AUDIT.md) ----------------------------
    def to_jsonl(self) -> str:
        return "\n".join(
            json.dumps(
                {**asdict(o), "ret": None if o.ret == math.inf else o.ret}
            )
            for o in self.ops()
        )

    @staticmethod
    def ops_from_jsonl(text: str) -> List[Op]:
        out = []
        for line in text.splitlines():
            if not line.strip():
                continue
            d = json.loads(line)
            if d.get("ret") is None:
                d["ret"] = math.inf
            if isinstance(d.get("key"), list):
                # tuple keys serialize as JSON lists; the checker
                # partitions by key, so it must be hashable again
                d["key"] = tuple(d["key"])
            out.append(Op(**d))
        return out


class AuditClient:
    """One logical client process (one recorder pid, one Session).

    ``hosts`` is either a dict ``key -> NodeHost`` or a zero-arg
    callable returning one (the nemesis kills/restarts hosts, so the
    map must be re-read per attempt).  All request errors are folded
    into the three-way ok/fail/ambig verdict the checker understands.
    """

    def __init__(
        self,
        hosts,
        shard_id: int,
        recorder: HistoryRecorder,
        *,
        seed: int = 0,
        budget=None,
        op_timeout: float = 8.0,
        per_try_timeout: float = 1.0,
    ):
        self._hosts = hosts
        self.shard_id = shard_id
        self.recorder = recorder
        self.client = recorder.new_client()
        self.budget = budget
        self.op_timeout = op_timeout
        self.per_try_timeout = per_try_timeout
        self._rng = Random((seed << 8) ^ self.client)
        self.session = None
        self._seq = 0
        self.stats: Dict[str, int] = {}

    # -- host selection ---------------------------------------------------
    def _live_hosts(self) -> list:
        d = self._hosts() if callable(self._hosts) else self._hosts
        # the nemesis kills/restarts hosts from its own thread, so the
        # map can resize mid-iteration — retry the snapshot instead of
        # letting RuntimeError kill the workload thread
        for _ in range(8):
            try:
                items = sorted(d.items(), key=lambda kv: str(kv[0]))
                break
            except RuntimeError:
                continue
        else:
            return []
        return [
            nh for _, nh in items if not getattr(nh, "_closed", False)
        ]

    def _host(self):
        live = self._live_hosts()
        return self._rng.choice(live) if live else None

    def _count(self, k: str) -> None:
        self.stats[k] = self.stats.get(k, 0) + 1

    def _deadline(self) -> float:
        budget = (
            self.budget.total_timeout() if self.budget is not None
            else self.op_timeout
        )
        return time.monotonic() + budget

    def _per_try(self, deadline: float) -> float:
        per = (
            self.budget.per_try_timeout() if self.budget is not None
            else self.per_try_timeout
        )
        return max(0.05, min(per, deadline - time.monotonic()))

    # -- session lifecycle ------------------------------------------------
    def register(self, deadline: Optional[float] = None) -> bool:
        """(Re-)register the exactly-once session through any live host."""
        deadline = deadline or self._deadline()
        while time.monotonic() < deadline:
            nh = self._host()
            if nh is None:
                time.sleep(0.05)
                continue
            try:
                self.session = nh.sync_get_session(
                    self.shard_id, timeout=self._per_try(deadline)
                )
                return True
            except Exception:  # noqa: BLE001 — any failure: try another host
                self._count("register_retries")
                time.sleep(0.02)
        return False

    # -- operations -------------------------------------------------------
    def write(self, key):
        """One exactly-once write of a globally-unique value.  Returns
        the value written (regardless of verdict — the checker reads
        the verdict from the history)."""
        self._seq += 1
        value = f"c{self.client}-{self._seq}"
        op = self.recorder.invoke(self.client, "w", key, value)
        deadline = self._deadline()
        if self.session is None and not self.register(deadline):
            self.recorder.fail(op)  # never proposed
            self._count("no_session")
            return value
        cmd = audit_set_cmd(key, value)
        maybe_committed = False
        while True:
            nh = self._host()
            if self.session is None:
                # evicted/rejected mid-run: re-register before retrying
                # (a dead session would burn the whole deadline raising)
                if not self.register(deadline):
                    break
                continue
            if nh is None:
                time.sleep(0.05)
            else:
                try:
                    t_try = time.monotonic()
                    r = nh.sync_propose(
                        self.session, cmd, timeout=self._per_try(deadline)
                    )
                    self.session.proposal_completed()
                    self.recorder.ok(op, getattr(r, "value", None))
                    if self.budget is not None:
                        # the SUCCESSFUL attempt's latency only: whole-
                        # loop time includes backoff/election waits and
                        # would ratchet the budget upward
                        self.budget.observe(time.monotonic() - t_try)
                    return value
                except Exception as e:  # noqa: BLE001 — classified below
                    self._count(f"write_{type(e).__name__}")
                    if isinstance(e, _MAYBE_COMMITTED_ERRORS):
                        # the entry may already be in the log
                        maybe_committed = True
                    elif isinstance(e, RequestRejected):
                        # session evicted / series marked responded —
                        # this copy was NOT applied; an earlier timed-out
                        # copy may have been, so ambiguity persists
                        self.session = None
                        if maybe_committed:
                            # do NOT re-propose under a fresh session: a
                            # maybe-committed earlier copy has no dedupe
                            # state there, and a second apply would be a
                            # real duplicate — finalize as ambiguous
                            break
                    time.sleep(0.02)
            if time.monotonic() >= deadline:
                break
        if maybe_committed:
            self.recorder.ambiguous(op)
            # burn the series: a later retry of it could double-apply
            # only through the session registry, which dedupes — but the
            # NEXT op must ride a fresh series either way
            if self.session is not None:
                self.session.proposal_completed()
        else:
            self.recorder.fail(op)
        return value

    def read(self, key):
        """Linearizable read (read-index).  A read that never returns
        constrains nothing — recorded as fail and excluded."""
        op = self.recorder.invoke(self.client, "r", key)
        deadline = self._deadline()
        while time.monotonic() < deadline:
            nh = self._host()
            if nh is None:
                time.sleep(0.05)
                continue
            try:
                v = nh.sync_read(
                    self.shard_id, ("get", key),
                    timeout=self._per_try(deadline),
                )
                self.recorder.ok(op, v)
                return v
            except Exception as e:  # noqa: BLE001 — reads are idempotent
                self._count(f"read_{type(e).__name__}")
                time.sleep(0.02)
        self.recorder.fail(op)
        return None

    def stale_read(self, key):
        """Local (non-linearizable) read: checked only against the
        weaker never-saw-an-uncommitted-value contract."""
        op = self.recorder.invoke(self.client, "stale", key)
        nh = self._host()
        if nh is None:
            self.recorder.fail(op)
            return None
        try:
            v = nh.stale_read(self.shard_id, ("get", key))
            self.recorder.ok(op, v)
            return v
        except Exception as e:  # noqa: BLE001
            self._count(f"stale_{type(e).__name__}")
            self.recorder.fail(op)
            return None

    def follower_read(self, key):
        """Follower-linearizable read (docs/READPLANE.md): served from
        any replica's local state machine after its ReadIndex round.
        Recorded as kind "r" — it promises exactly the leader read's
        contract, so the Wing–Gong pass judges it unchanged (that IS
        the follower-read safety check)."""
        op = self.recorder.invoke(self.client, "r", key)
        deadline = self._deadline()
        while time.monotonic() < deadline:
            nh = self._host()
            if nh is None:
                time.sleep(0.05)
                continue
            try:
                v, _applied = nh.follower_read(
                    self.shard_id, ("get", key),
                    timeout=self._per_try(deadline),
                )
                self.recorder.ok(op, v)
                return v
            except Exception as e:  # noqa: BLE001 — reads are idempotent
                self._count(f"follower_{type(e).__name__}")
                time.sleep(0.02)
        self.recorder.fail(op)
        return None

    def bounded_read(self, key, bound_ticks: int = 50):
        """Bounded-staleness read: one attempt against one live host
        (like stale_read — retrying elsewhere is the GATEWAY's job; the
        audit records what one replica answered).  The stamp rides
        ``op.value`` as (applied_index, staleness_ticks, bound_ticks)
        for check_bounded_reads; a shed records as fail (no effect)."""
        op = self.recorder.invoke(self.client, "bounded", key)
        nh = self._host()
        if nh is None:
            self.recorder.fail(op)
            return None
        try:
            res = nh.bounded_read(self.shard_id, ("get", key),
                                  bound_ticks=bound_ticks)
            op.value = (res.applied_index, res.staleness_ticks, bound_ticks)
            self.recorder.ok(op, res.value)
            return res.value
        except Exception as e:  # noqa: BLE001 — shed or host closing
            self._count(f"bounded_{type(e).__name__}")
            self.recorder.fail(op)
            return None

    def close(self, timeout: float = 2.0) -> None:
        """Best-effort session unregister (the registry LRU also GCs)."""
        s, self.session = self.session, None
        if s is None:
            return
        nh = self._host()
        if nh is None:
            return
        try:
            nh.sync_close_session(s, timeout=timeout)
        except Exception:  # noqa: BLE001 — the LRU will evict it
            pass


def run_workload(
    clients: List[AuditClient],
    keys: List,
    stop: threading.Event,
    *,
    read_ratio: float = 0.35,
    stale_ratio: float = 0.1,
    follower_ratio: float = 0.0,
    bounded_ratio: float = 0.0,
    bound_ticks: int = 50,
    pace: float = 0.002,
) -> List[threading.Thread]:
    """Spawn one daemon thread per client running a mixed write/read/
    stale-read(/follower/bounded) loop over ``keys`` until ``stop`` is
    set.  Returns the (started) threads; join them after setting
    ``stop``.  The readplane ratios default to 0 so pre-readplane
    workloads keep their exact op mix."""

    def loop(c: AuditClient):
        while not stop.is_set():
            key = c._rng.choice(keys)
            roll = c._rng.random()
            if roll < read_ratio:
                c.read(key)
            elif roll < read_ratio + stale_ratio:
                c.stale_read(key)
            elif roll < read_ratio + stale_ratio + follower_ratio:
                c.follower_read(key)
            elif roll < (read_ratio + stale_ratio + follower_ratio
                         + bounded_ratio):
                c.bounded_read(key, bound_ticks=bound_ticks)
            else:
                c.write(key)
            time.sleep(pace)

    threads = [
        threading.Thread(target=loop, args=(c,), daemon=True,
                         name=f"audit-client-{c.client}")
        for c in clients
    ]
    for t in threads:
        t.start()
    return threads
