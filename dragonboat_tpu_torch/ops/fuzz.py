"""Seeded live inputs for the device programs, as numpy field dicts.

Rows come in groups of three: rows 3s, 3s+1, 3s+2 are replicas 1, 2, 3
of shard s+1 (``cluster_state_np``; ``padded_cluster_np`` leaves the rows
past the last whole group empty, as an engine's unused capacity holds
them).  ``route_np`` turns one step's outboxes into the next step's
inboxes inside each group; ``fuzz_inbox_np`` draws inboxes over every
hot message type with fields near each row's own state.  The chip smoke
test and the program registry's live inputs draw from here.
"""
from __future__ import annotations

import numpy as np

from . import types as T


def cluster_state_np(G: int, P_: int, W_: int, seed: int) -> dict:
    """Rows 3s, 3s+1, 3s+2 are replicas 1, 2, 3 of shard s+1; a third of
    the shards run pre-vote, a third check-quorum."""
    if G % 3:
        raise ValueError("G must be a multiple of 3")
    shard = np.arange(G) // 3 + 1
    rid = np.arange(G) % 3 + 1
    peers = np.zeros((G, P_), np.int32)
    peers[:, :3] = [1, 2, 3]
    cols = T.make_state_np(
        G, P_, W_, shard_ids=shard, replica_ids=rid, peer_ids=peers,
        election_timeout=10, heartbeat_timeout=2,
    )
    rng = np.random.default_rng(seed)
    cols["pre_vote"] = (shard % 3 == 1).astype(np.int32)
    cols["check_quorum"] = (shard % 3 == 2).astype(np.int32)
    # spread the first elections out
    cols["election_tick"] = rng.integers(0, 10, G).astype(np.int32)
    return cols


def padded_cluster_np(G: int, P_: int, W_: int, seed: int) -> dict:
    """``cluster_state_np`` on the first G - G % 3 rows, then empty rows
    (no peers), as the unused capacity of an engine holds them."""
    live = G - G % 3
    cols = cluster_state_np(live, P_, W_, seed)
    if live == G:
        return cols
    z = np.zeros((G - live,), np.int32)
    pad = T.make_state_np(G - live, P_, W_, shard_ids=z, replica_ids=z,
                          peer_ids=np.zeros((G - live, P_), np.int32))
    return {k: np.concatenate([cols[k], pad[k]]) for k in cols}


def route_np(st: dict, out: dict, rng, M_: int, E_: int, *,
             tick_p: float = 0.6, prop_p: float = 0.1) -> dict:
    """Turn one step's outboxes into the next step's inboxes: every
    message goes to its destination replica's row in the same group, in
    source order, after an optional tick in slot 0; the last slot may
    carry a fresh proposal.  REPLICATE entries carry the sender's ring
    terms."""
    buf, count = out["buf"], out["count"]
    G, O_, _ = buf.shape
    W_ = st["ring_term"].shape[1]
    rid = np.arange(G) % 3 + 1
    to = buf[..., T.F_TO]
    mt = buf[..., T.F_MTYPE]
    live = np.arange(O_)[None, :] < count[:, None]
    self_resp = (mt == T.MT_READ_INDEX_RESP) & (to == rid[:, None])
    ok = live & ~self_resp & (to >= 1) & (to <= 3)
    sg, sk = np.nonzero(ok)
    dest = 3 * (sg // 3) + to[sg, sk] - 1
    order = np.argsort(dest, kind="stable")
    sg, sk, dest = sg[order], sk[order], dest[order]
    ib = {f: np.zeros((G, M_), np.int32) for f in (
        "mtype", "from_id", "term", "log_term", "log_index", "commit",
        "reject", "hint", "hint_high", "n_entries")}
    ib["ent_term"] = np.zeros((G, M_, E_), np.int32)
    ib["ent_cc"] = np.zeros((G, M_, E_), np.int32)
    tick = rng.random(G) < tick_p
    ib["mtype"][tick, 0] = T.MT_TICK
    ib["log_index"][tick, 0] = 1
    first = tick.astype(np.int64)
    start = np.searchsorted(dest, dest, side="left")
    slot = first[dest] + (np.arange(dest.size) - start)
    keep = slot < M_ - 1
    sg, sk, dest, slot = sg[keep], sk[keep], dest[keep], slot[keep]
    rec = buf[sg, sk]
    for f, col in (("mtype", T.F_MTYPE), ("term", T.F_TERM),
                   ("log_term", T.F_LOG_TERM), ("log_index", T.F_LOG_INDEX),
                   ("commit", T.F_COMMIT), ("reject", T.F_REJECT),
                   ("hint", T.F_HINT), ("hint_high", T.F_HINT_HIGH),
                   ("n_entries", T.F_N_ENTRIES)):
        ib[f][dest, slot] = rec[:, col]
    ib["from_id"][dest, slot] = rid[sg]
    rep = rec[:, T.F_MTYPE] == T.MT_REPLICATE
    for j in range(E_):
        has = rep & (rec[:, T.F_N_ENTRIES] > j)
        pos = (rec[:, T.F_LOG_INDEX] + 1 + j) & (W_ - 1)
        ib["ent_term"][dest[has], slot[has], j] = st["ring_term"][sg[has], pos[has]]
        ib["ent_cc"][dest[has], slot[has], j] = st["ring_cc"][sg[has], pos[has]]
    prop = rng.random(G) < prop_p
    ib["mtype"][prop, M_ - 1] = T.MT_PROPOSE
    ib["n_entries"][prop, M_ - 1] = rng.integers(1, E_ + 1, int(prop.sum()))
    ib["ent_cc"][prop, M_ - 1] = (rng.random((int(prop.sum()), E_)) < 0.05)
    return ib


def fuzz_inbox_np(st: dict, rng, M_: int, E_: int, *,
                  window: int = 32) -> dict:
    """Seeded inboxes over every hot message type, with fields near each
    row's own state (terms, indexes) so every handler branch is reached;
    a tenth of the indexes reach ``window`` to twice ``window`` entries
    below the row's last index."""
    G = st["term"].shape[0]
    hot = np.asarray(T.HOT_TYPES, np.int32)
    occ = rng.random((G, M_)) < 0.6
    ib = {}
    ib["mtype"] = np.where(occ, hot[rng.integers(0, hot.size, (G, M_))], 0)
    # a few cold types: the row must escalate
    cold = occ & (rng.random((G, M_)) < 0.02)
    ib["mtype"][cold] = T.MT_INSTALL_SNAPSHOT
    ib["mtype"] = ib["mtype"].astype(np.int32)

    def near(base, lo, hi):
        return (base[:, None] + rng.integers(lo, hi + 1, (G, M_))).astype(np.int32)

    ib["from_id"] = rng.integers(0, 4, (G, M_)).astype(np.int32)
    ib["term"] = np.maximum(near(st["term"], -1, 1), 0)
    ib["term"][rng.random((G, M_)) < 0.15] = 0
    ib["log_term"] = np.maximum(near(st["term"], -1, 1), 0)
    ib["log_index"] = np.maximum(near(st["last_index"], -3, 2), 0)
    # some reach below the W-entry ring window
    far = rng.random((G, M_)) < 0.1
    ib["log_index"][far] = np.maximum(near(st["last_index"], -2 * window, -window)[far], 0)
    ib["commit"] = np.maximum(near(st["committed"], -1, 3), 0)
    ib["reject"] = (rng.random((G, M_)) < 0.3).astype(np.int32)
    ib["hint"] = np.where(rng.random((G, M_)) < 0.5, 0,
                          near(st["last_index"], -2, 2)).astype(np.int32)
    ib["hint_high"] = (rng.random((G, M_)) < 0.2).astype(np.int32)
    ib["n_entries"] = rng.integers(0, E_ + 1, (G, M_)).astype(np.int32)
    tick = ib["mtype"] == T.MT_TICK
    ib["log_index"][tick] = rng.integers(0, 4, int(tick.sum()))
    ib["ent_term"] = np.maximum(
        st["term"][:, None, None] + rng.integers(-1, 2, (G, M_, E_)), 1
    ).astype(np.int32)
    ib["ent_cc"] = (rng.random((G, M_, E_)) < 0.1).astype(np.int32)
    return {k: np.ascontiguousarray(v, dtype=np.int32) for k, v in ib.items()}
