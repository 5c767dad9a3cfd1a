"""Plain PyTorch versions of the colocated engine's device programs.

References for the CUDA kernels ``csrc/inbox.cu`` and
``csrc/select_blob.cu`` and for the kernel compositions of
``ops/colocated.py``; that module runs these for CPU tensors, and the
engine's parity self-check runs them on the card beside the kernels.
Each is the program ``dragonboat_tpu/ops/colocated.py`` defines
(``_assemble_inbox`` :175, ``_assemble_and_step`` :199, ``_route_step``
:215, ``_select_and_blob`` :285, ``_zero_inbox_rows`` :399,
``_host_inbox_from_ticks`` :411, ``_scatter_inbox_rows`` :441), written
in eager torch.

``combo`` is the launch's fused [G, 4] int32 host upload (alive, batch,
prop, ticks — the ``_C_*`` lanes).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import engine_ref
from . import kernel_ref
from . import route_ref
from .types import I32, MT_TICK, DeviceOut, DeviceState, Inbox

# per-launch [G, 4] host-upload lane assignments
C_ALIVE, C_BATCH, C_PROP, C_TICKS = range(4)


def _rowmask(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return m.reshape((-1,) + (1,) * (a.dim() - 1))


def assemble_inbox(host: Inbox, pending: Inbox, combo: torch.Tensor) -> Inbox:
    """The routed regions first, then the host slots; rows whose alive
    lane is 0 are zeroed."""
    alive = combo[:, C_ALIVE] != 0

    def cat(h, p):
        x = torch.cat([p, h], dim=1)
        return torch.where(_rowmask(alive, x), x, 0)

    return Inbox(*(cat(getattr(host, f), getattr(pending, f))
                   for f in Inbox._fields))


def assemble_and_step(state: DeviceState, host: Inbox, pending: Inbox,
                      combo: torch.Tensor, *, out_capacity: int):
    """Assemble, then step every row."""
    return kernel_ref.step(
        state, assemble_inbox(host, pending, combo), out_capacity
    )


# [G, O] bool -> [G, ceil(O/32)] int32 words of uint32 bits
pack_delivered = route_ref.pack_bits


class Lane(NamedTuple):
    """A mesh-mode route step's lane operands for one block: its mesh
    tables (``route.MeshTables`` rows, [Gl, P] each), the launch's whole
    [G, 4] combo on the block's device (the receivers' alive lane), the
    block's coordinate, the block count and the lane's per-edge
    budget."""

    dest_local: torch.Tensor
    dest_dev: torch.Tensor
    rank: torch.Tensor
    combo: torch.Tensor
    me: int
    n_dev: int
    xbudget: int


def route_step(old_state: DeviceState, new_state: DeviceState,
               out: DeviceOut, dest: torch.Tensor, rank: torch.Tensor,
               combo: torch.Tensor, *, PB: int, E: int, budget: int,
               lane: Optional[Lane] = None):
    """Post-launch tail: discard escalated rows' effects, route the
    outboxes into the next launch's pending regions (width PB, base 0),
    the flag word with the colocated F_COUNT override, and the packed
    delivered bits.  Returns (merged, regions, stats [6], packed, flags).
    Consumes ``new_state``: merged is new_state with the escalated rows
    put back in place (the reference donates it, colocated.py:213).

    With ``lane`` (a mesh block: ``dest`` is the local view of its
    tables) the lane pack runs between the route and the flag word:
    messages toward another block are packed for it (``lane_pack`` with
    the alive lane), their delivered bits set and the undelivered words
    rewritten, so the F_COUNT override sees what the lane carried.  Then
    it also returns the block's lane buffer and its [8] lane stats row."""
    merged = DeviceState(*engine_ref.merge_escalated(
        out.escalate, old_state, new_state))
    regions, stats, delivered = route_ref.route(
        merged, out, dest, rank, M=PB, E=E, budget=budget, base=0,
        suppress=out.escalate != 0, dest_alive=combo[:, C_ALIVE] != 0,
    )
    O = delivered.shape[1]
    valid = torch.arange(O, device=out.count.device)[None, :] < out.count[:, None]
    undeliv = (valid & ~delivered).any(dim=1).to(I32)
    packed = pack_delivered(delivered)
    xlane = ()
    if lane is not None:
        xlane = route_ref.lane_pack(
            merged, out, lane.dest_local, lane.dest_dev, lane.rank,
            me=lane.me, n_dev=lane.n_dev, E=E, budget=budget,
            xbudget=lane.xbudget, suppress=out.escalate,
            dest_alive=lane.combo, alive_stride=4, packed=packed,
            undeliv=undeliv,
        )
    flags = engine_ref.summarize_flags(old_state, merged, out, undeliv)
    return (merged, regions, stats, packed, flags) + tuple(xlane)


def lane_scatter(regions: Inbox, recv: torch.Tensor, lane_stats: torch.Tensor,
                 *, budget: int):
    """The lane's receiving half on a block: the received rows added into
    its pending regions in place (``lane_scatter``, base 0) and the count
    written into ``lane_stats[1]``.  Returns (regions, lane_stats)."""
    regions, n = route_ref.lane_scatter(regions, recv, budget=budget, base=0)
    lane_stats[1] = n
    return regions, lane_stats


def selection_masks(flags: torch.Tensor, combo: torch.Tensor):
    """The five row sets (buf, slot, need, append, sum) of a launch."""
    from .types import F_ANY_LIVE, F_APPEND, F_COUNT, F_ESC, F_NEED_SS

    alive = combo[:, C_ALIVE] != 0
    batch_mask = combo[:, C_BATCH] != 0
    prop_mask = combo[:, C_PROP] != 0
    esc = (flags & F_ESC) != 0
    anylive = (flags & F_ANY_LIVE) != 0
    live = (batch_mask | (alive & anylive)) & ~esc
    buf_sel = live & ((flags & F_COUNT) != 0)
    append_sel = live & ((flags & F_APPEND) != 0)
    need_sel = live & ((flags & F_NEED_SS) != 0)
    slot_sel = prop_mask & ~esc
    sum_sel = live & (anylive | slot_sel)
    return buf_sel, slot_sel, need_sel, append_sel, sum_sel


def select_and_blob(merged: DeviceState, out: DeviceOut, stats: torch.Tensor,
                    packed: torch.Tensor, flags: torch.Tensor,
                    combo: torch.Tensor, *, CAP_B: int, CAP_SL: int,
                    CAP_N: int, CAP_A: int, CAP_S: int,
                    HOST_OFF: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row selection + detail/vals gather into the (head, detail) int32
    blobs (layouts in csrc/select_blob.cu)."""
    sels = selection_masks(flags, combo)
    caps = (CAP_B, CAP_SL, CAP_N, CAP_A, CAP_S)

    def pick(sel, cap):
        order = torch.argsort(torch.where(sel, 0, 1), stable=True)
        return order[:cap].to(I32), sel.sum(dtype=I32)

    picked = [pick(s, c) for s, c in zip(sels, caps)]
    rows_buf, rows_slot, rows_need, rows_append, rows_sum = (
        r for r, _ in picked
    )
    counts = torch.stack([n for _, n in picked])
    vals = engine_ref.gather_pack(merged, out, None, rows_sum)
    head = torch.cat([
        flags, packed.reshape(-1), stats.to(I32), counts,
        rows_buf, rows_slot, rows_need, rows_append, rows_sum, vals,
    ])
    rb, rs, rn, ra = (r.long() for r in (rows_buf, rows_slot, rows_need,
                                         rows_append))
    detail = torch.cat([
        out.buf[rb].reshape(-1),
        out.slot_base[rs][:, HOST_OFF:].reshape(-1),
        out.slot_term[rs][:, HOST_OFF:].reshape(-1),
        out.ent_drop[rs][:, HOST_OFF:].reshape(-1),
        out.need_snapshot[rn].reshape(-1),
        merged.ring_term[ra].reshape(-1),
        merged.ring_cc[ra].reshape(-1),
    ])
    return head, detail


def zero_inbox_rows(inbox: Inbox, mask: torch.Tensor) -> Inbox:
    """Zero the inbox rows where ``mask`` ([G]) is nonzero."""
    m = mask != 0
    return Inbox(*(torch.where(_rowmask(m, a), 0, a) for a in inbox))


def host_inbox_from_ticks(combo: torch.Tensor, *, M: int, E: int) -> Inbox:
    """The host inbox region from the fused tick counts: slot 0 is
    LOCAL_TICK where the count is above 0; log_index[:, 0] is the count."""
    tick_counts = combo[:, C_TICKS]
    G = tick_counts.shape[0]
    dev = combo.device

    def z():
        return torch.zeros((G, M), dtype=I32, device=dev)

    mtype = z()
    log_index = z()
    if M:
        mtype[:, 0] = torch.where(tick_counts > 0, MT_TICK, 0)
        log_index[:, 0] = tick_counts
    return Inbox(
        mtype=mtype, from_id=z(), term=z(), log_term=z(),
        log_index=log_index, commit=z(), reject=z(), hint=z(),
        hint_high=z(), n_entries=z(),
        ent_term=torch.zeros((G, M, E), dtype=I32, device=dev),
        ent_cc=torch.zeros((G, M, E), dtype=I32, device=dev),
    )


def scatter_inbox_rows(host: Inbox, pos: torch.Tensor, sub: Inbox) -> Inbox:
    """Place sub's rows at pos (a [G] position map, -1 = keep)."""
    return Inbox(*engine_ref.place_rows(list(host), list(sub), pos))


# program name -> plain version (the parity self-check's table)
PROGRAMS: Dict[str, object] = {
    "assemble_and_step": assemble_and_step,
    "route_step": route_step,
    "lane_route_step": route_step,
    "lane_scatter": lane_scatter,
    "select_and_blob": select_and_blob,
    "zero_inbox_rows": zero_inbox_rows,
    "host_inbox_from_ticks": host_inbox_from_ticks,
    "scatter_inbox_rows": scatter_inbox_rows,
}
