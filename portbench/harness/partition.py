"""A configuration's partition schedule: which replicas are cut off, launch
by launch.

A configuration may carry a ``partition`` block::

    "partition": {"phases": [{"launches": 40, "cut": []},
                             {"launches": 20, "cut": [1], "share": 0.1}],
                  "about": "..."}

Phase ``i`` lasts ``launches`` launches and cuts, in a ``share`` of the
groups (default 1.0), every replica whose id is in ``cut``.  The layout
puts replica id ``k`` of every group in the group's ``k``-th row, as
upstream puts replica ``k`` on NodeHost ``k``, so cutting an id models
losing a NodeHost.  A cut works both ways: every entry of a cut row's
peer table, and every peer's entry for a cut row, becomes -1 (the
destination is not resident), so nothing leaves or reaches it; the row
still gets its tick, and its proposals while it leads.

The phases repeat in order from the launch ``start`` on.  Launch ``n``'s
phase is a function of ``n - start`` alone, and a phase's table a
function of the phase, its index and the run's seed: the share's groups
are drawn once, from the seed and the index, the same count of each
membership size, so every seed cuts the same work in other groups.  A
phase cuts the same groups on every pass, and a cut leader's group has
moved its leadership by the next pass: a schedule whose window should
see fresh cuts throughout lists phases for longer than set-up's steady
launches and the window together.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Phase:
    launches: int
    cut: Tuple[int, ...]
    share: float = 1.0


def phases(cfg: dict) -> Optional[List[Phase]]:
    """The configuration's phases, or None without a ``partition`` block.
    Raises ``ValueError`` on a malformed block."""
    block = cfg.get("partition")
    if block is None:
        return None
    raw = block.get("phases") if isinstance(block, dict) else None
    if not raw:
        raise ValueError("partition: 'phases' must be a non-empty list")
    P = int(cfg["P"])
    out = []
    for i, ph in enumerate(raw):
        if not isinstance(ph, dict):
            raise ValueError(f"partition phase {i}: not an object: {ph!r}")
        n = ph.get("launches")
        if not isinstance(n, int) or isinstance(n, bool) or n < 1:
            raise ValueError(f"partition phase {i}: launches must be a "
                             f"whole number >= 1, got {n!r}")
        cut = ph.get("cut")
        if not isinstance(cut, list) or any(
                not isinstance(k, int) or isinstance(k, bool) or not 1 <= k <= P
                for k in cut):
            raise ValueError(f"partition phase {i}: cut must list replica "
                             f"ids in 1..{P}, got {cut!r}")
        share = ph.get("share", 1.0)
        if (not isinstance(share, (int, float)) or isinstance(share, bool)
                or not 0.0 < share <= 1.0):
            raise ValueError(f"partition phase {i}: share must lie in "
                             f"(0, 1], got {share!r}")
        out.append(Phase(launches=n, cut=tuple(sorted(set(cut))),
                         share=float(share)))
    return out


def cut_groups(sizes: np.ndarray, share: float, seed: int,
               index: int) -> np.ndarray:
    """[groups] bool: the groups phase ``index`` cuts in, drawn from the
    seed and the index: ``round(share * n)`` of the ``n`` groups of each
    membership size."""
    rng = np.random.default_rng([int(seed) % 2**64, 3, int(index)])
    chosen = np.zeros(sizes.shape[0], bool)
    for k in np.unique(sizes):
        of_k = np.flatnonzero(sizes == k)
        n = int(round(share * of_k.shape[0]))
        chosen[rng.choice(of_k, size=n, replace=False)] = True
    return chosen


def table(lay, phase: Phase, seed: int, index: int) -> np.ndarray:
    """The [G, P] int32 peer table of phase ``index``: ``lay.dest_row``
    with every entry of a cut row, and every entry that names one, -1."""
    d = lay.dest_row
    if not phase.cut:
        return d
    groups = cut_groups(lay.sizes, phase.share, seed, index)
    replica = lay.state["replica_id"]
    cut_row = groups[lay.group] & np.isin(replica, phase.cut)
    names_cut = (d >= 0) & cut_row[np.clip(d, 0, None)]
    return np.where(cut_row[:, None] | names_cut, -1, d).astype(np.int32)


class Schedule:
    """The phases of one run and their tables: ``host[i]`` on the host
    (for the check), ``device[i]`` uploaded once; a phase that cuts
    nothing shares the unpartitioned table itself."""

    def __init__(self, lay, phase_list: List[Phase], seed: int, dest):
        self.ends = np.cumsum([p.launches for p in phase_list]).tolist()
        self.cycle = self.ends[-1]
        self.start = 0
        self.host = [table(lay, p, seed, i) for i, p in enumerate(phase_list)]
        self.device = [dest if h is lay.dest_row else
                       torch.from_numpy(h).to(dest.device) for h in self.host]

    def phase_of(self, n: int) -> Optional[int]:
        """The phase of launch ``n``; None before ``start``."""
        if n < self.start:
            return None
        return bisect.bisect_right(self.ends, (n - self.start) % self.cycle)
