"""Plain PyTorch versions of the engine's launch plumbing.

References for the CUDA kernels ``flags.cu`` (``summarize_flags``),
``gather_pack.cu`` (``gather_pack``) and ``place_rows.cu``
(``place_rows`` / ``merge_escalated`` / ``set_remote_snapshot``);
``ops/plumbing.py`` runs these for CPU tensors.  ``select_escalated``
is the out-of-place merge that ``merge_escalated`` is held against.  Each is the function the reference computes in
``dragonboat_tpu/ops/engine.py`` (``_summarize_flags``, the
``_gather_*`` programs, ``_scatter_rows`` / ``_select_rows`` /
``_gather_rows`` / ``_set_remote_snapshot``), written in eager torch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .types import (
    APPEND_LO_NONE,
    F_APPEND,
    F_CHANGED,
    F_COUNT,
    F_ESC,
    F_NEED_SS,
    F_PEERS_BEHIND,
    F_QUORUM_ACTIVE,
    I32,
    KIND_VOTER,
    KIND_WITNESS,
    N_FIELDS,
    ROLE_LEADER,
    RS_SNAPSHOT,
    DeviceOut,
    DeviceState,
)

# the [G] sources of the values block, in R_* order
VALS_STATE = ("term", "vote", "committed", "leader_id", "role", "last_index")
VALS_OUT = ("count", "append_lo", "barrier_idx", "barrier_term")


def detail_width(O: int, M: int, E: int, P: int, W: int) -> int:
    """Per-row int32 width of the detail packing."""
    return O * N_FIELDS + M + M + M * E + P + W + W


def _bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(I32)


def summarize_flags(
    old: DeviceState, new: DeviceState, out: DeviceOut,
    undeliv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-row flag word (F_* bits); with ``undeliv`` the F_COUNT bit is
    ``undeliv != 0`` (the colocated override, colocated.py:241-246)."""
    changed = (
        (new.term != old.term)
        | (new.vote != old.vote)
        | (new.committed != old.committed)
        | (new.leader_id != old.leader_id)
        | (new.role != old.role)
        | (new.last_index != old.last_index)
    )
    P = new.peer_id.shape[1]
    lane = torch.arange(P, device=new.term.device)[None, :]
    f = _bit(changed, F_CHANGED)
    f = f | _bit(out.count > 0 if undeliv is None else undeliv != 0,
                 F_COUNT)
    f = f | _bit(out.append_lo != APPEND_LO_NONE, F_APPEND)
    f = f | _bit((out.need_snapshot == 1).any(dim=1), F_NEED_SS)
    f = f | _bit(out.escalate != 0, F_ESC)
    self_lane = lane == new.self_slot[:, None]
    peer_lane = (new.peer_id != 0) & ~self_lane
    behind = (new.role == ROLE_LEADER) & (
        peer_lane & (new.match < new.last_index[:, None])
    ).any(dim=1)
    f = f | _bit(behind, F_PEERS_BEHIND)
    voters = (new.peer_id != 0) & (
        (new.peer_kind == KIND_VOTER) | (new.peer_kind == KIND_WITNESS)
    )
    quorum = voters.sum(dim=1, dtype=I32) // 2 + 1
    self_is_voter = (
        self_lane & (new.peer_id != 0) & (new.peer_kind == KIND_VOTER)
    ).any(dim=1)
    n_active = 1 + (voters & ~self_lane & (new.active == 1)).sum(
        dim=1, dtype=I32
    )
    q_active = (
        (new.role == ROLE_LEADER)
        & (new.check_quorum == 1)
        & self_is_voter
        & (n_active >= quorum)
    )
    return f | _bit(q_active, F_QUORUM_ACTIVE)


def _rows(idx: torch.Tensor, G: int) -> torch.Tensor:
    """Row indexes as the reference's gathers read them: negative counts
    from the end, then clamp into [0, G)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + G, idx).clamp(0, G - 1)


def gather_pack(
    state: DeviceState,
    out: DeviceOut,
    idx4: Optional[torch.Tensor],
    idx_sum: Optional[torch.Tensor],
) -> torch.Tensor:
    """Flat int32 readback: ``b`` detail rows (``idx4`` = [4, b] row sets
    for buf / slot arrays / need_snapshot / ring), then ``b2`` values
    rows (``idx_sum``, N_VALS words each, R_* order)."""
    G = state.term.shape[0]
    parts: List[torch.Tensor] = []
    if idx4 is not None:
        b = idx4.shape[1]
        ib, isl, ine, iri = (_rows(idx4[k], G) for k in range(4))
        detail = (
            out.buf[ib],
            out.slot_base[isl],
            out.slot_term[isl],
            out.ent_drop[isl],
            out.need_snapshot[ine],
            state.ring_term[iri],
            state.ring_cc[iri],
        )
        parts.append(torch.cat([p.reshape(b, -1) for p in detail], dim=1)
                     .reshape(-1))
    if idx_sum is not None:
        ix = _rows(idx_sum, G)
        cols = [getattr(state, f)[ix] for f in VALS_STATE]
        cols += [getattr(out, f)[ix] for f in VALS_OUT]
        parts.append(torch.stack(cols, dim=1).reshape(-1))
    if not parts:
        return torch.empty((0,), dtype=I32, device=state.term.device)
    return torch.cat(parts).to(I32)


def check_place_source(G_out: int, G_src: int) -> None:
    """A placement of rows from a source with none raises, as the
    reference's gather does (``jnp.clip`` to row -1 fails to trace)."""
    if G_out and not G_src:
        raise ValueError("place_rows: the source has no rows")


def place_rows(
    dst: Optional[Sequence[torch.Tensor]],
    src: Sequence[torch.Tensor],
    pos: torch.Tensor,
) -> List[torch.Tensor]:
    """Per field: out[g] = src[pos[g]] where pos[g] >= 0, else dst[g]
    (zeros when ``dst`` is None — the gather case, where every pos is a
    row).  A pos past the source's last row reads the last row."""
    check_place_source(pos.shape[0], src[0].shape[0])
    outs = []
    take = pos.long().clamp(min=0)
    for k, s in enumerate(src):
        t = take.clamp(max=s.shape[0] - 1)
        picked = s[t]
        base = (
            torch.zeros_like(picked) if dst is None else dst[k]
        )
        m = (pos >= 0).reshape((-1,) + (1,) * (picked.dim() - 1))
        outs.append(torch.where(m, picked, base))
    return outs


def set_remote_snapshot(
    rstate: torch.Tensor,
    snap_index: torch.Tensor,
    g_idx: torch.Tensor,
    p_idx: torch.Tensor,
    snap: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """rstate[g, p] = RS_SNAPSHOT and snap_index[g, p] = snap at every
    pair; the last pair naming a slot wins, negative indexes count from
    the end, and a pair outside the arrays writes nothing."""
    G, P = rstate.shape
    rs = rstate.clone()
    sn = snap_index.clone()
    for g, p, s in zip(g_idx.tolist(), p_idx.tolist(), snap.tolist()):
        g = g + G if g < 0 else g
        p = p + P if p < 0 else p
        if 0 <= g < G and 0 <= p < P:
            rs[g, p] = RS_SNAPSHOT
            sn[g, p] = s
    return rs, sn


def select_escalated(
    escalate: torch.Tensor,
    old: Sequence[torch.Tensor],
    new: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """Per field: old's row where ``escalate`` is nonzero, else new's."""
    keep = escalate == 0
    return [
        torch.where(keep.reshape((-1,) + (1,) * (b.dim() - 1)), b, a)
        for a, b in zip(old, new)
    ]


def merge_escalated(
    escalate: torch.Tensor,
    old: Sequence[torch.Tensor],
    new: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """In place: per field, new[escalate != 0] = old[escalate != 0];
    returns ``new``."""
    esc = escalate != 0
    for a, b in zip(old, new):
        b[esc] = a[esc]
    return list(new)
