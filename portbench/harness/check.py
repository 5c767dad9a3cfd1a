"""What decides ``correct``: the frozen reference against the program's
own outputs, and the guarantees of the configuration on every group.

* ``compare_launch``: a launch of the timed window recomputed by the
  reference from that launch's inputs, over every row, in blocks of
  whole groups (groups never exchange messages, so a block is a complete
  problem).  Every int32 word of the state and the next inbox, and every
  per-round route counter and escalated-row count, is compared.
* ``start_check``: a seeded sample of groups followed by the reference
  from the seed's own initial rows through the first launches of
  set-up (the elections), against the program's rows at that point.
* ``guarantees``: on every group at the end of the window, no two
  leaders in one term, no commit index that went backward over the
  window, and replicas that agree on the term of every committed index
  that both still hold.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import layout as RL
from ..reference import route as RR


def to_ref(nt, cls, rows: slice):
    """The program's NamedTuple as the reference's: its tensors' ``rows``,
    cloned."""
    return cls(*[t[rows].clone() for t in nt])


def mismatched_words(a, b) -> int:
    """How many int32 words differ between two trees of one layout."""
    n = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            n += max(x.numel(), y.numel())
        else:
            n += int((x != y.to(x.device)).sum())
    return n


def group_blocks(lay, block_rows: int) -> List[tuple]:
    """[(row0, row1)] of consecutive whole groups, each at most
    ``block_rows`` rows (or one group, if a group is wider)."""
    ends = lay.start + lay.sizes
    out, g = [], 0
    while g < lay.groups:
        r0 = int(lay.start[g])
        g1 = int(np.searchsorted(ends, r0 + block_rows, side="right"))
        g1 = max(g1, g + 1)
        out.append((r0, int(ends[g1 - 1])))
        g = g1
    return out


def _local_tables(lay, r0: int, r1: int, dev):
    d = lay.dest_row[r0:r1]
    dest = torch.from_numpy(np.where(d >= 0, d - r0, -1).astype(np.int32)).to(dev)
    rank = torch.from_numpy(lay.rank_in_dest[r0:r1].copy()).to(dev)
    return dest, rank


def compare_launch(lay, kw: dict, inputs, outputs, stats: np.ndarray,
                   n_esc: np.ndarray, dev, block_rows: int,
                   rooflines: Optional[dict] = None) -> Dict[str, object]:
    """Recompute one launch with the reference over every row and count
    what differs.  ``inputs`` / ``outputs`` are the program's (state,
    inbox) before and after the launch, ``stats`` [K, 6] and ``n_esc``
    [K] its counters as read back.  With ``rooflines`` ({kernel:
    module}) also sums each kernel's ``round_bytes`` over the launch's
    rounds."""
    s_in, i_in = inputs
    s_out, i_out = outputs
    K = int(kw["rounds"])
    ref_stats = np.zeros((K, stats.shape[1]), np.int64)
    ref_esc = np.zeros((K,), np.int64)
    words = 0
    nbytes = {k: 0 for k in (rooflines or {})}
    for r0, r1 in group_blocks(lay, block_rows):
        sl = slice(r0, r1)
        dest, rank = _local_tables(lay, r0, r1, dev)
        rec: Optional[list] = [] if rooflines else None
        st, ib, rs, re_ = RR.fused_rounds(
            to_ref(s_in, RL.DeviceState, sl), to_ref(i_in, RL.Inbox, sl),
            dest, rank, record=rec, **kw)
        words += mismatched_words([t[sl] for t in s_out], st)
        words += mismatched_words([t[sl] for t in i_out], ib)
        ref_stats += rs.cpu().numpy().astype(np.int64)
        ref_esc += re_.cpu().numpy().astype(np.int64)
        for k, mod in (rooflines or {}).items():
            nbytes[k] += sum(int(mod.round_bytes(r)) for r in rec)
        del st, ib, rec
    return dict(
        words=words,
        counters=int((ref_stats != stats).sum() + (ref_esc != n_esc).sum()),
        round_bytes={k: v / K for k, v in nbytes.items()},
    )


def start_rows(lay, n_groups: int, seed: int):
    """The start check's sample: (rows, dest, rank) of ``n_groups``
    groups drawn from the seed."""
    from .layout import sub_layout

    rng = np.random.default_rng([int(seed) % 2**64, 1])
    groups = rng.choice(lay.groups, size=min(n_groups, lay.groups),
                        replace=False)
    return sub_layout(lay, groups)


def start_check(lay, kw: dict, rows: np.ndarray, dest: np.ndarray,
                rank: np.ndarray, launches: int, program_rows, dev) -> int:
    """Follow the sampled rows with the reference from the seed's
    initial state through ``launches`` launches; the count of words that
    differ from ``program_rows`` ((state, inbox) trees of those rows)."""
    st = RL.DeviceState(*[torch.from_numpy(lay.state[f][rows].copy()).to(dev)
                          for f in RL.DeviceState._fields])
    ib = RL.Inbox(*[torch.from_numpy(lay.inbox[f][rows].copy()).to(dev)
                    for f in RL.Inbox._fields])
    d = torch.from_numpy(dest).to(dev)
    r = torch.from_numpy(rank).to(dev)
    for _ in range(launches):
        st, ib, _s, _e = RR.fused_rounds(st, ib, d, r, **kw)
    ps, pi = program_rows
    return mismatched_words(ps, st) + mismatched_words(pi, ib)


def group_commit_max(committed: torch.Tensor, gid: torch.Tensor,
                     groups: int) -> torch.Tensor:
    """Per-group maximum of the rows' commit indexes (on the device)."""
    out = torch.zeros((groups,), dtype=committed.dtype,
                      device=committed.device)
    return out.scatter_reduce_(0, gid, committed, "amax", include_self=False)


def guarantees(state, committed_start: torch.Tensor, gid: torch.Tensor,
               groups: int) -> Dict[str, int]:
    """The configuration's guarantees on every group (see the module
    docstring); each count must be 0."""
    role, term = state.role, state.term
    lead = role == RL.ROLE_LEADER
    keys = gid[lead].to(torch.int64) * 2**32 + term[lead].to(torch.int64)
    _, counts = torch.unique(keys, return_counts=True)
    two_leaders = int((counts - 1).clamp(min=0).sum()) if counts.numel() else 0

    regress = int((state.committed < committed_start).sum())

    # the row of each group with the highest commit (lowest row on ties)
    G = role.shape[0]
    W = state.ring_term.shape[1]
    cmax = group_commit_max(state.committed, gid, groups)
    row = torch.arange(G, device=role.device, dtype=torch.int64)
    cand = torch.where(state.committed == cmax[gid], row,
                       torch.full_like(row, G))
    lrow = torch.full((groups,), G, dtype=torch.int64, device=role.device)
    lrow = lrow.scatter_reduce_(0, gid, cand, "amin", include_self=True)
    L = lrow[gid]
    last = state.last_index.to(torch.int64)
    lo = torch.maximum(state.first_index.to(torch.int64), last - (W - 1))
    slot = torch.arange(W, device=role.device, dtype=torch.int64)[None, :]
    # the index each ring slot holds: the largest idx <= last with
    # idx = slot (mod W)
    idx = last[:, None] - torch.remainder(last[:, None] - slot, W)
    held = (idx >= lo[:, None]) & (idx >= 1)
    both = held & held[L] & (idx == idx[L])
    upto = torch.minimum(state.committed, state.committed[L]).to(torch.int64)
    committed = both & (idx <= upto[:, None])
    conflicts = int((committed & (state.ring_term != state.ring_term[L])).sum())
    return dict(two_leaders_one_term=two_leaders, commit_went_back=regress,
                committed_term_conflicts=conflicts)
