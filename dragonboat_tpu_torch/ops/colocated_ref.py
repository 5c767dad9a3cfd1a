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

from typing import Dict, Tuple

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


def pack_delivered(delivered: torch.Tensor) -> torch.Tensor:
    """[G, O] bool -> [G, ceil(O/32)] int32 words of uint32 bits."""
    G, O = delivered.shape
    nwords = (O + 31) // 32
    shift = torch.arange(O, device=delivered.device) % 32
    word = torch.arange(O, device=delivered.device) // 32
    bits = torch.where(delivered, torch.ones_like(shift) << shift, 0)
    cols = []
    for w in range(nwords):
        s = torch.where(word[None, :] == w, bits, 0).sum(dim=1)  # int64
        cols.append(torch.where(s >= 2**31, s - 2**32, s))
    return torch.stack(cols, dim=1).to(I32)


def route_step(old_state: DeviceState, new_state: DeviceState,
               out: DeviceOut, dest: torch.Tensor, rank: torch.Tensor,
               combo: torch.Tensor, *, PB: int, E: int, budget: int):
    """Post-launch tail: discard escalated rows' effects, route the
    outboxes into the next launch's pending regions (width PB, base 0),
    the flag word with the colocated F_COUNT override, and the packed
    delivered bits.  Returns (merged, regions, stats [6], packed, flags).
    Consumes ``new_state``: merged is new_state with the escalated rows
    put back in place (the reference donates it, colocated.py:213)."""
    merged = DeviceState(*engine_ref.merge_escalated(
        out.escalate, old_state, new_state))
    regions, stats, delivered = route_ref.route(
        merged, out, dest, rank, M=PB, E=E, budget=budget, base=0,
        suppress=out.escalate != 0, dest_alive=combo[:, C_ALIVE] != 0,
    )
    O = delivered.shape[1]
    valid = torch.arange(O, device=out.count.device)[None, :] < out.count[:, None]
    undeliv = (valid & ~delivered).any(dim=1)
    flags = engine_ref.summarize_flags(old_state, merged, out, undeliv.to(I32))
    return merged, regions, stats, pack_delivered(delivered), flags


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
    "select_and_blob": select_and_blob,
    "zero_inbox_rows": zero_inbox_rows,
    "host_inbox_from_ticks": host_inbox_from_ticks,
    "scatter_inbox_rows": scatter_inbox_rows,
}
