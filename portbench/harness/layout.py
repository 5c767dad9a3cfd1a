"""The cell's inputs, made on the host from the seed (numpy, vectorised).

Rows are laid out group-contiguous, each group's replicas side by side
(how the colocated engine places replicas that start shard by shard).
Every seed gets the same groups: shard ``s`` (1-based) has the
membership that ``s`` draws in the configuration's fixed list, and its
election-timeout jitter hashes ``s``.  The seed draws the order in which
the groups lie on the card, so each seed runs the same work (the same
elections, the same heartbeat phases) in another order.  The same
arrays go to the system under test and to the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the reference layout's codes (portbench/reference/layout.py)
from ..reference.layout import MT_TICK, ROLE_FOLLOWER, DeviceState, Inbox


@dataclass
class Layout:
    """One cell's rows: ``sizes[g]`` replicas in group ``g`` at rows
    ``start[g] .. start[g] + sizes[g]``; ``group[r]`` the group of row
    ``r``; ``state``, ``inbox``, ``dest_row`` and ``rank_in_dest`` the
    initial operands as int32 numpy arrays."""

    sizes: np.ndarray
    start: np.ndarray
    group: np.ndarray
    state: dict
    inbox: dict
    dest_row: np.ndarray
    rank_in_dest: np.ndarray

    @property
    def G(self) -> int:
        return int(self.group.shape[0])

    @property
    def groups(self) -> int:
        return int(self.sizes.shape[0])


def membership_sizes(cfg: dict) -> np.ndarray:
    """The membership of shard ``s`` at ``[s - 1]``: ``cfg["memberships"]``
    maps a replica count to its number of groups, laid out smallest
    count first."""
    sizes = np.concatenate([
        np.full(int(n), int(k), np.int32)
        for k, n in sorted(cfg["memberships"].items(), key=lambda kv: int(kv[0]))
    ])
    if sizes.shape[0] != int(cfg["groups"]):
        raise ValueError("memberships do not add up to groups")
    if int(sizes.max()) > int(cfg["P"]):
        raise ValueError("a membership is wider than P")
    return sizes


def splitmix32(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x.astype(np.uint32) + np.uint32(0x9E3779B9)
        z = z ^ (z >> np.uint32(16))
        z = z * np.uint32(0x85EBCA6B)
        z = z ^ (z >> np.uint32(13))
        z = z * np.uint32(0xC2B2AE35)
        z = z ^ (z >> np.uint32(16))
    return z


def rows_of(sizes: np.ndarray, shard_ids: np.ndarray, cfg: dict) -> tuple:
    """(start, group, state, dest_row, rank_in_dest) of a group-contiguous
    layout of groups with ``sizes`` replicas (replica ids 1..n, slot i
    holding replica i + 1), every row a fresh follower at term 0."""
    P, W = int(cfg["P"]), int(cfg["W"])
    if W & (W - 1):
        raise ValueError(f"W must be a power of two, got {W}")
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    group = np.repeat(np.arange(sizes.shape[0]), sizes)
    G = int(group.shape[0])
    n = sizes[group].astype(np.int32)
    replica = (np.arange(G) - start[group] + 1).astype(np.int32)
    slot = np.arange(P, dtype=np.int32)[None, :]
    in_group = slot < n[:, None]
    peer_id = np.where(in_group, slot + 1, 0).astype(np.int32)
    dest_row = np.where(in_group, start[group][:, None] + slot, -1).astype(np.int32)
    rank = np.where(in_group, (replica - 1)[:, None], 0).astype(np.int32)

    zg = np.zeros((G,), np.int32)
    zgp = np.zeros((G, P), np.int32)
    et = np.full((G,), int(cfg["election_timeout"]), np.int32)
    shard = shard_ids[group].astype(np.int32)
    seq = np.ones((G,), np.int32)
    # the constructor's first randomized timeout: seq 0 -> 1
    h = splitmix32((shard.astype(np.uint32) << np.uint32(24))
                   ^ (replica.astype(np.uint32) << np.uint32(8))
                   ^ seq.astype(np.uint32))
    rand_timeout = (et + (h % et.astype(np.uint32)).astype(np.int32)).astype(np.int32)
    cols = dict(
        shard_id=shard,
        replica_id=replica,
        self_slot=(replica - 1).astype(np.int32),
        election_timeout=et,
        heartbeat_timeout=np.full((G,), int(cfg["heartbeat_timeout"]), np.int32),
        check_quorum=np.full((G,), int(bool(cfg["check_quorum"])), np.int32),
        pre_vote=np.full((G,), int(bool(cfg["pre_vote"])), np.int32),
        term=zg.copy(), vote=zg.copy(), leader_id=zg.copy(),
        role=np.full((G,), ROLE_FOLLOWER, np.int32),
        committed=zg.copy(), last_index=zg.copy(),
        first_index=np.ones((G,), np.int32), base_term=zg.copy(),
        election_tick=zg.copy(), heartbeat_tick=zg.copy(),
        rand_timeout=rand_timeout, timeout_seq=seq,
        pending_cc=zg.copy(), transfer_target=zg.copy(),
        peer_id=peer_id, peer_kind=zgp.copy(), match=zgp.copy(),
        next_idx=in_group.astype(np.int32), rstate=zgp.copy(),
        snap_index=zgp.copy(), active=zgp.copy(), granted=zgp.copy(),
        ring_term=np.zeros((G, W), np.int32),
        ring_cc=np.zeros((G, W), np.int32),
    )
    assert tuple(cols) == DeviceState._fields
    return start, group, cols, dest_row, rank


def tick_inbox(G: int, cfg: dict) -> dict:
    """The first round's inbox: a LOCAL_TICK in slot 0 of every row (no
    row leads yet, so no proposal slot)."""
    M = int(cfg["base"]) + int(cfg["P"]) * int(cfg["budget"])
    E = int(cfg["E"])
    ib = {f: np.zeros((G, M), np.int32) for f in Inbox._fields[:10]}
    ib["mtype"][:, 0] = MT_TICK
    ib["ent_term"] = np.zeros((G, M, E), np.int32)
    ib["ent_cc"] = np.zeros((G, M, E), np.int32)
    return ib


def build(cfg: dict, seed: int) -> Layout:
    """The cell's initial operands for ``seed`` (any integer; only its
    value modulo 2**64 reaches the generator)."""
    rng = np.random.default_rng(int(seed) % 2**64)
    order = rng.permutation(int(cfg["groups"]))
    sizes = membership_sizes(cfg)[order]
    shard_ids = (1 + order).astype(np.int64)
    start, group, state, dest, rank = rows_of(sizes, shard_ids, cfg)
    return Layout(sizes=sizes, start=start, group=group, state=state,
                  inbox=tick_inbox(int(group.shape[0]), cfg),
                  dest_row=dest, rank_in_dest=rank)


def sub_layout(lay: Layout, groups: np.ndarray) -> tuple:
    """(rows, dest_row, rank_in_dest) of the listed groups alone, the
    tables renumbered to the rows' positions in ``rows``: groups never
    exchange messages, so the subset is a complete problem."""
    groups = np.sort(np.asarray(groups))
    rows = np.concatenate([np.arange(lay.start[g], lay.start[g] + lay.sizes[g])
                           for g in groups]).astype(np.int64)
    pos = np.full((lay.G,), -1, np.int64)
    pos[rows] = np.arange(rows.shape[0])
    d = lay.dest_row[rows]
    dest = np.where(d >= 0, pos[np.clip(d, 0, None)], -1).astype(np.int32)
    return rows, dest, lay.rank_in_dest[rows].copy()
