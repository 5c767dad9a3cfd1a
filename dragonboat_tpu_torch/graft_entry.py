"""Entry points for a one-card compile check and a multi-device dry run
of the port: the counterpart of the reference's ``__graft_entry__.py``.

The flagship program is the raft step (``ops.kernel.step``): one launch
advances a ``[G]``-row struct-of-arrays raft state through an inbox of
message slots.  The only parallel axis is the groups axis: raft groups
are independent, so the rows are cut into device blocks of a
``GroupsMesh`` with no exchange in steady state.

* ``entry(device=None)`` — ``(forward, (state, inbox))``: the step at
  ``out_capacity=16`` and 64 example rows on the device (``cuda`` unless
  the caller asks for ``cpu``; a CUDA request without a card raises).
* ``dryrun_multichip(n_devices, device=None, devices=None, rtt_ms=5)`` —
  the reference's three parts on an ``n_devices`` mesh, with its
  postconditions word for word: the sharded step, 64 routed rounds of
  the sharded round, and three NodeHosts on one
  ``ColocatedEngineGroup(mesh=...)``.  The mesh defaults to
  ``[cuda:0] * n`` (NCCL refuses two ranks on one GPU, so one card
  stands for n).  Returns what each part produced, for a caller that
  holds it against a reference.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from .ops import placement
from .ops import route as R
from .ops.kernel import make_step_sharded, step
from .ops.types import MT_TICK, ROLE_LEADER, make_inbox, make_state

# part 2's geometry: the consensus bench's (zero drops in steady state;
# budget 4 covers a leader's worst per-peer round)
GROUPS_PER_DEV, REPL = 8, 3
P2, W2, E2, O2, BUDGET, BASE = 3, 16, 2, 16, 4, 2
M2 = BASE + P2 * BUDGET
ROUNDS = 64


def example_batch(G: int, P: int = 3, W: int = 8, M: int = 8, E: int = 1,
                  *, device="cpu"):
    """G rows: the first half single-voter groups, the rest 3-replica
    groups (ragged membership through empty peer slots); M ticks a row."""
    replica_ids = np.ones((G,), np.int32)
    peer_ids = np.zeros((G, P), np.int32)
    half = G // 2
    peer_ids[:half, 0] = 1
    peer_ids[half:, :3] = np.array([1, 2, 3], np.int32)
    st = make_state(
        G, P, W, device=device,
        shard_ids=np.arange(1, G + 1, dtype=np.int32),
        replica_ids=replica_ids, peer_ids=peer_ids,
        election_timeout=4, heartbeat_timeout=1,
    )
    inbox = make_inbox(G, M, E, device=device)
    inbox.mtype.fill_(MT_TICK)
    return st, inbox


def entry(device=None):
    """(forward step, example args) — the one-card compile check."""
    dev = placement.resolve_device(device)

    def forward(state, inbox):
        new_state, out = step(state, inbox, out_capacity=16)
        return new_state, out

    return forward, example_batch(64, device=dev)


def routed_layout(n_devices: int):
    """Part 2's rows (whole groups per block): ``(shard_ids, replica_ids,
    peer_ids)`` of ``GROUPS_PER_DEV * n_devices`` groups x ``REPL``."""
    groups = GROUPS_PER_DEV * n_devices
    rows = groups * REPL
    shard_ids = np.repeat(np.arange(1, groups + 1, dtype=np.int32), REPL)
    replica_ids = np.tile(np.arange(1, REPL + 1, dtype=np.int32), groups)
    peer_ids = np.broadcast_to(
        np.arange(1, REPL + 1, dtype=np.int32), (rows, P2)).copy()
    return shard_ids, replica_ids, peer_ids


def routed_start(n_devices: int, device="cpu"):
    """Part 2's fresh state and prefilled inbox (global rows)."""
    shard_ids, replica_ids, peer_ids = routed_layout(n_devices)
    st = make_state(
        shard_ids.shape[0], P2, W2, device=device,
        shard_ids=shard_ids, replica_ids=replica_ids, peer_ids=peer_ids,
        election_timeout=10, heartbeat_timeout=2,
    )
    return st, R.make_prefill(st, M2, E2)


def _mesh(n_devices: int, device, devices) -> placement.GroupsMesh:
    if devices is None:
        devices = [placement.resolve_device(device)] * n_devices
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for a mesh of {n_devices}")
    return placement.GroupsMesh(devices)


def dryrun_multichip(n_devices: int, device=None, devices=None, *,
                     rtt_ms: int = 5, workdir: Optional[str] = None) -> dict:
    """The sharded step, the routed round and the engine stack on an
    ``n_devices`` mesh; raises ``AssertionError`` where a postcondition
    of the reference fails.  Returns ``{"step": (state, out), "routed":
    (state, inbox), "engine": stats}`` (global trees on the mesh's first
    device)."""
    mesh = _mesh(n_devices, device, devices)
    res = _sharded_parts(mesh)
    res["engine"] = engine_on_mesh(mesh, rtt_ms=rtt_ms, workdir=workdir)
    return res


def _sharded_parts(mesh: placement.GroupsMesh) -> dict:
    """Parts 1 and 2 of the dry run on ``mesh``: ``{"step": (state,
    out), "routed": (state, inbox)}``."""
    n_devices = mesh.size
    dev0 = mesh.devices[0]
    res = {}

    # -- part 1: the raw step sharded over the mesh ----------------------
    G = 8 * n_devices
    st, inbox = example_batch(G, device=dev0)
    sharded_step = make_step_sharded(mesh, st, inbox, out_capacity=16)
    new_st, out = (mesh.join(t) for t in sharded_step(st, inbox))
    # single-voter rows won their election within the fused tick burst;
    # multi-replica rows emitted RequestVote traffic into the outbox
    half = G // 2
    roles = new_st.role.cpu().numpy()
    if not (roles[:half] == ROLE_LEADER).all():
        raise AssertionError(f"single-voter rows not all leaders: {roles[:half]}")
    if int(out.count[half:].sum()) <= 0:
        raise AssertionError("multi-replica rows emitted no election traffic")
    if int(out.escalate.sum()) != 0:
        raise AssertionError("unexpected escalation in dry-run")
    res["step"] = (new_st, out)

    # -- part 2: routed consensus (step -> route -> step) on the mesh ----
    # groups are whole per block, so routing stays on its block: no lane
    # traffic; elections, replication, proposals and commits advance on
    # every block at once
    shard_ids, replica_ids, peer_ids = routed_layout(n_devices)
    tabs = R.build_route_tables_mesh(shard_ids, replica_ids, peer_ids,
                                     n_devices)
    round_fn = R.make_sharded_round(
        mesh, M=M2, E=E2, out_capacity=O2, budget=BUDGET,
        xbudget=R.xbudget_for(tabs, BUDGET, n_devices), base=BASE,
        propose_leaders=True)
    cst, cbox = routed_start(n_devices, dev0)
    drops = off_dev = 0
    for _ in range(ROUNDS):  # elections settle, then proposals commit
        cst, cbox, rstats, lstats = round_fn(
            cst, cbox, tabs.dest_local, tabs.dest_dev, tabs.rank_in_dest)
        # RouteStats: deliv, off, budget, ring, suppressed, host; the
        # lane: sent, delivered, budget, xlane, ring, escalated, live
        s = rstats.sum(0).cpu()
        lane = lstats.sum(0).cpu()
        off_dev += int(s[1]) + int(lane[0])
        drops += int(s[2]) + int(s[3]) + int(lane[2]) + int(lane[3])
        if int(lane[5]) != 0:
            raise AssertionError("unexpected escalation in routed dry-run")
    cst, cbox = mesh.join(cst), mesh.join(cbox)
    groups = GROUPS_PER_DEV * n_devices
    roles = cst.role.cpu().numpy()
    commits = cst.committed.cpu().numpy().reshape(groups, REPL).max(1)
    leaders = int((roles == ROLE_LEADER).sum())
    if leaders != groups:
        raise AssertionError(f"routed: {leaders}/{groups} groups elected")
    if not (commits > 0).all():
        raise AssertionError(f"routed: commit stalled: {commits}")
    if off_dev != 0:
        raise AssertionError("routed: messages crossed shard boundaries")
    if drops != 0:
        raise AssertionError(f"routed: {drops} dropped messages")
    # every device really stepped its own block: per-block commit sums
    per_dev = commits.reshape(n_devices, GROUPS_PER_DEV).sum(1)
    if not (per_dev > 0).all():
        raise AssertionError(f"routed: a device made no progress: {per_dev}")
    res["routed"] = (cst, cbox)
    return res


def engine_on_mesh(mesh: placement.GroupsMesh, *, rtt_ms: int = 5,
                   workdir: Optional[str] = None) -> dict:
    """Part 3 of the dry run: three NodeHosts on one
    ``ColocatedEngineGroup(mesh=mesh)`` (NodeHost
    -> exec engine -> the shared colocated engine), with enough shards
    that live rows land on every block; one committed write a shard.
    Returns the engine's stats."""
    from . import (Config, EngineConfig, ExpertConfig, IStateMachine,
                   NodeHost, NodeHostConfig, Result)
    from .ops.colocated import ColocatedEngineGroup
    from .transport.inproc import reset_inproc_network

    class KV(IStateMachine):
        def __init__(self, shard_id, replica_id):
            self.data = {}

        def update(self, entry):
            k, v = pickle.loads(entry.cmd)
            self.data[k] = v
            return Result(value=len(self.data))

        def lookup(self, query):
            return self.data.get(query)

        def save_snapshot(self, w, files, done):
            w.write(pickle.dumps(self.data))

        def recover_from_snapshot(self, r, files, done):
            self.data = pickle.loads(r.read())

    n_devices = mesh.size
    capacity = 4 * n_devices
    rows_per_dev = capacity // n_devices
    # enough shards that attached rows reach the LAST device block
    n_shards = (capacity - rows_per_dev) // 3 + 1
    addrs = {1: "mesh-nh-1", 2: "mesh-nh-2", 3: "mesh-nh-3"}
    reset_inproc_network()
    group = ColocatedEngineGroup(
        capacity=capacity, P=3, W=16, M=8, E=2, O=16, budget=4, mesh=mesh)
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="nh-mesh-", dir=workdir)
    nhs = {}
    try:
        for rid, addr in addrs.items():
            nhs[rid] = NodeHost(NodeHostConfig(
                nodehost_dir=f"{root}/{rid}",
                rtt_millisecond=rtt_ms,
                raft_address=addr,
                expert=ExpertConfig(
                    engine=EngineConfig(exec_shards=1, apply_shards=2),
                    step_engine_factory=group.factory,
                ),
            ))
        for shard in range(1, n_shards + 1):
            for rid, nh in nhs.items():
                nh.start_replica(
                    addrs, False, KV,
                    Config(replica_id=rid, shard_id=shard,
                           election_rtt=20, heartbeat_rtt=2,
                           pre_vote=True, check_quorum=True),
                )
        core = group.core
        # the shared state really is cut over every device block
        n_span = len(core._state.parts)
        if n_span != n_devices:
            raise AssertionError(
                f"engine state spans {n_span} devices, wanted {n_devices}")
        deadline = time.time() + 180.0
        while time.time() < deadline:
            if all(nhs[1]._nodes[shard].peer.raft.log.committed >= 1
                   for shard in range(1, n_shards + 1)):
                break
            time.sleep(0.2)
        else:
            raise AssertionError("mesh cluster never elected all shards")
        # one committed write per shard, via rotating NodeHosts
        for shard in range(1, n_shards + 1):
            nh = nhs[1 + (shard % 3)]
            s = nh.get_noop_session(shard)
            deadline = time.time() + 90.0
            while True:
                try:
                    nh.sync_propose(s, pickle.dumps((f"k{shard}", shard)),
                                    timeout=10.0)
                    break
                except Exception:  # noqa: BLE001 — retried to the deadline
                    if time.time() > deadline:
                        raise
                    time.sleep(0.05)
        # rows landed on every device block, and consensus routed on-device
        with core._lock:
            blocks = {g // rows_per_dev for g in core._row_of.values()}
            stats = dict(core.stats)
        if blocks != set(range(n_devices)):
            raise AssertionError(
                f"live rows only on device blocks {sorted(blocks)} "
                f"of {n_devices}")
        if stats["routed_delivered"] <= 0:
            raise AssertionError(f"no device-routed traffic: {stats}")
        if stats["divergence_halts"] != 0:
            raise AssertionError(f"divergence halts: {stats}")
    finally:
        for nh in nhs.values():
            nh.close()
        shutil.rmtree(root, ignore_errors=True)
    # every engine/ticker thread is joined after close
    deadline = time.time() + 10.0
    while True:
        leaked = [t.name for t in threading.enumerate()
                  if t.name.startswith("tpu-raft-") and t.is_alive()]
        if not leaked:
            break
        if time.time() > deadline:
            raise AssertionError(f"engine threads leaked after close: {leaked}")
        time.sleep(0.2)
    return stats


if __name__ == "__main__":
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry() ok")
    dryrun_multichip(4)
    print("dryrun_multichip(4) ok")
