"""The audited state machine and its pure replay model.

``AuditKV`` is the kv/register SM an audited cluster runs: a plain KV
store that additionally appends every applied write to an in-memory
**apply journal** ``[(index, key, value), ...]``.  The journal is what
makes the exactly-once session pass white-box checkable: audit clients
write globally-unique values, so a duplicate apply shows up as the same
value twice in a replica's journal and a lost ack as an acked value
missing from it (see :func:`dragonboat_tpu.audit.checker.check_sessions`).
The journal is serialized into snapshots beside the data so a
snapshot-recovered replica's journal stays comparable.

The *replay model* used by the linearizability search is the trivial
per-key register: a write sets the register, a read returns it — it
lives inline in the checker (the search only needs "apply one op to a
register value"), this module just pins the command codec both sides
share.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Tuple

from ..statemachine import IStateMachine, Result


def audit_set_cmd(key, value) -> bytes:
    """The one write-command shape AuditKV applies.  JSON, not pickle:
    commands travel the wire and the library-wide no-pickle guard
    (tests/test_wire_payloads.py) applies to the audit SM too."""
    return json.dumps(["set", key, value]).encode()


class AuditKV(IStateMachine):
    """Journaled KV register store (see module docstring).

    ``lookup`` accepts either a bare key or a ``("get", key)`` tuple so
    the audit client and ad-hoc test probes can share it.
    """

    def __init__(self, shard_id, replica_id):
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.data: Dict = {}
        self.journal: List[Tuple[int, object, object]] = []

    def update(self, entry):
        op, k, v = json.loads(entry.cmd.decode())
        if op != "set":
            raise ValueError(f"AuditKV: unknown op {op!r}")
        if isinstance(k, list):
            # tuple keys JSON-encode as lists; store them hashable again
            # (ops_from_jsonl and recover_from_snapshot do the same)
            k = tuple(k)
        self.data[k] = v
        self.journal.append((entry.index, k, v))
        return Result(value=entry.index)

    def lookup(self, query):
        # tuple OR list: RPC queries ride the JSON value lane, which
        # turns ("get", k) into ["get", k] (transport/wire.py contract)
        if (
            isinstance(query, (tuple, list))
            and len(query) == 2
            and query[0] == "get"
        ):
            query = query[1]
        return self.data.get(query)

    def save_snapshot(self, w, files, done):
        # data ships as a PAIR LIST: JSON object keys stringify, so a
        # dict round-trip would turn integer keys into strings and a
        # snapshot-recovered replica would miss every lookup on them —
        # an audit "violation" that is a harness artifact
        w.write(
            json.dumps([list(self.data.items()), self.journal]).encode()
        )

    def recover_from_snapshot(self, r, files, done):
        pairs, journal = json.loads(r.read().decode())
        self.data = {
            (tuple(k) if isinstance(k, list) else k): v for k, v in pairs
        }
        self.journal = [tuple(e) for e in journal]


def collect_journals(hosts: Dict, shard_id: int) -> Dict[str, list]:
    """Snapshot every live replica's ``(key, value)`` apply journal for
    one shard (white-box, like the chaos suite's agreement check)."""
    out: Dict[str, list] = {}
    for key, nh in hosts.items():
        if getattr(nh, "_closed", False):
            continue
        node = nh._nodes.get(shard_id)
        if node is None:
            continue
        sm = node.sm.managed.sm
        out[str(key)] = [(k, v) for _, k, v in list(sm.journal)]
    return out


def settle_journals(
    hosts: Dict, shard_id: int, timeout: float = 30.0
) -> Dict[str, list]:
    """Wait until every live replica's journal for ``shard_id`` agrees,
    then return the journals.  Raises AssertionError on timeout with
    the divergent sizes (the session pass would only report a less
    specific order mismatch)."""
    deadline = time.monotonic() + timeout
    journals: Dict[str, list] = {}
    while True:
        journals = collect_journals(hosts, shard_id)
        vals = list(journals.values())
        if vals and all(j == vals[0] for j in vals):
            return journals
        if time.monotonic() >= deadline:
            raise AssertionError(
                f"shard {shard_id} journals did not settle within "
                f"{timeout}s: sizes={[len(j) for j in vals]}"
            )
        time.sleep(0.05)
