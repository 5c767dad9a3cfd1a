"""Wrappers of the engine's launch-plumbing kernels.

Each function launches its CUDA kernel for tensors on a CUDA device
and runs its plain version (``engine_ref.py``) for tensors on the CPU;
any other device raises.  The wrapper checks shapes and allocates its
outputs with ``torch.empty``; the binding (``csrc/bindings.cpp``)
checks dtype (int32), device and contiguity, launches on the current
stream and checks the launch.

* ``summarize_flags`` — csrc/flags.cu
* ``gather_pack``     — csrc/gather_pack.cu
* ``place_rows`` / ``set_remote_snapshot`` — csrc/place_rows.cu
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import _native
from . import engine_ref
from .engine_ref import VALS_OUT, VALS_STATE, detail_width
from .types import DeviceOut, DeviceState


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def summarize_flags(
    old: DeviceState, new: DeviceState, out: DeviceOut
) -> torch.Tensor:
    """[G] int32 flag word per row."""
    if _device(new.term) == "cpu":
        return engine_ref.summarize_flags(old, new, out)
    G, P = new.peer_id.shape
    srcs = (
        [getattr(old, f) for f in VALS_STATE]
        + [getattr(new, f) for f in VALS_STATE]
        + [new.peer_id, new.peer_kind, new.match, new.active, new.self_slot,
           new.check_quorum, out.count, out.append_lo, out.escalate,
           out.need_snapshot]
    )
    for t in srcs:
        if t.shape[0] != G:
            raise ValueError("summarize_flags: row counts differ")
    for t in (new.peer_kind, new.match, new.active, out.need_snapshot):
        if tuple(t.shape) != (G, P):
            raise ValueError("summarize_flags: peer arrays must be [G, P]")
    flags = torch.empty((G,), dtype=torch.int32, device=new.term.device)
    if G:
        _native.launch("summarize_flags", srcs, flags, G, P)
    return flags


def gather_pack(
    state: DeviceState,
    out: DeviceOut,
    idx4: Optional[torch.Tensor],
    idx_sum: Optional[torch.Tensor],
) -> torch.Tensor:
    """Flat int32 readback of ``b`` detail rows (``idx4``: [4, b] row
    sets) followed by ``b2`` values rows (``idx_sum``: [b2])."""
    if _device(state.term) == "cpu":
        return engine_ref.gather_pack(state, out, idx4, idx_sum)
    G, O = out.buf.shape[:2]
    M, E = out.ent_drop.shape[1:]
    P = state.peer_id.shape[1]
    W = state.ring_term.shape[1]
    b = 0 if idx4 is None else idx4.shape[1]
    b2 = 0 if idx_sum is None else idx_sum.shape[0]
    if idx4 is not None and (idx4.dim() != 2 or idx4.shape[0] != 4):
        raise ValueError("gather_pack: idx4 must be [4, b]")
    if idx_sum is not None and idx_sum.dim() != 1:
        raise ValueError("gather_pack: idx_sum must be [b2]")
    srcs = [out.buf, out.slot_base, out.slot_term, out.ent_drop,
            out.need_snapshot, state.ring_term, state.ring_cc]
    vals = [getattr(state, f) for f in VALS_STATE]
    vals += [getattr(out, f) for f in VALS_OUT]
    K = detail_width(O, M, E, P, W)
    flat = torch.empty((b * K + b2 * len(vals),), dtype=torch.int32,
                       device=state.term.device)
    if b + b2:
        _native.launch("gather_pack", srcs, vals, idx4, idx_sum, flat,
                       G, O, M, E, P, W, b, b2)
    return flat


def place_rows(
    dst: Optional[Sequence[torch.Tensor]],
    src: Sequence[torch.Tensor],
    pos: torch.Tensor,
) -> List[torch.Tensor]:
    """Per field: out[g] = src[pos[g]] where pos[g] >= 0, else dst[g]
    (``dst=None``: a fresh gather, every pos a source row).  A source
    with no rows raises when there are rows to place, as the
    reference's gather does."""
    if _device(pos) == "cpu":
        return engine_ref.place_rows(dst, src, pos)
    if pos.dim() != 1:
        raise ValueError("place_rows: pos must be [G]")
    if not 1 <= len(src) <= 32:
        raise ValueError("place_rows: 1..32 fields")
    G_out = pos.shape[0]
    G_src = src[0].shape[0]
    engine_ref.check_place_source(G_out, G_src)
    outs = []
    for k, s in enumerate(src):
        if s.shape[0] != G_src:
            raise ValueError("place_rows: source row counts differ")
        shape = (G_out,) + tuple(s.shape[1:])
        if dst is not None and tuple(dst[k].shape) != shape:
            raise ValueError(f"place_rows: field {k} shapes differ")
        outs.append(torch.empty(shape, dtype=torch.int32, device=pos.device))
    if G_out:
        _native.launch("place_rows", pos, list(dst or ()), list(src), outs)
    return outs


def set_remote_snapshot(
    rstate: torch.Tensor,
    snap_index: torch.Tensor,
    g_idx: torch.Tensor,
    p_idx: torch.Tensor,
    snap: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copies of rstate / snap_index with RS_SNAPSHOT / snap at each
    (g_idx[k], p_idx[k])."""
    if _device(rstate) == "cpu":
        return engine_ref.set_remote_snapshot(
            rstate, snap_index, g_idx, p_idx, snap
        )
    G, P = rstate.shape
    n = g_idx.shape[0]
    if tuple(snap_index.shape) != (G, P) or any(
        t.dim() != 1 or t.shape[0] != n for t in (g_idx, p_idx, snap)
    ):
        raise ValueError("set_remote_snapshot: bad shapes")
    rs = torch.empty_like(rstate)
    sn = torch.empty_like(snap_index)
    if G * P:
        _native.launch("place_rows", rstate, snap_index, g_idx, p_idx, snap,
                       rs, sn, entry="set_remote_snapshot")
    return rs, sn
