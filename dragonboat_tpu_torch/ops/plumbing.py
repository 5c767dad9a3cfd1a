"""Wrappers of the engine's launch-plumbing kernels.

Each function launches its CUDA kernel for tensors on a CUDA device
and runs its plain version (``engine_ref.py``) for tensors on the CPU;
any other device raises.  The wrapper checks shapes and allocates its
outputs with ``torch.empty``; the binding (``csrc/bindings.cpp``)
checks dtype (int32), device and contiguity, launches on the current
stream and checks the launch.

* ``summarize_flags`` — csrc/flags.cu
* ``gather_pack``     — csrc/gather_pack.cu
* ``place_rows`` / ``merge_escalated`` / ``set_remote_snapshot`` —
  csrc/place_rows.cu (every call's outputs are views of one allocation:
  ``kernel._alloc_views``)
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from .. import profiling
from . import _native
from . import engine_ref
from . import kernel as K
from .engine_ref import VALS_OUT, VALS_STATE, detail_width
from .types import DeviceOut, DeviceState


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def summarize_flags(
    old: DeviceState, new: DeviceState, out: DeviceOut,
    undeliv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[G] int32 flag word per row.  With ``undeliv`` ([G] int32) the
    F_COUNT bit is set where ``undeliv`` is nonzero instead of where the
    row emitted messages (the colocated override)."""
    if _device(new.term) == "cpu":
        return engine_ref.summarize_flags(old, new, out, undeliv)
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
    if undeliv is not None and tuple(undeliv.shape) != (G,):
        raise ValueError("summarize_flags: undeliv must be [G]")
    flags = torch.empty((G,), dtype=torch.int32, device=new.term.device)
    if G:
        _native.launch("summarize_flags", srcs, undeliv, flags, G, P)
    return flags


def gather_pack(
    state: DeviceState,
    out: DeviceOut,
    idx4: Optional[torch.Tensor],
    idx_sum: Optional[torch.Tensor],
    dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flat int32 readback of ``b`` detail rows (``idx4``: [4, b] row
    sets) followed by ``b2`` values rows (``idx_sum``: [b2]).  ``dst``: a
    contiguous int32 vector of the packed size to write into instead of
    a fresh one (the colocated readback writes its values block into the
    head blob)."""
    if _device(state.term) == "cpu":
        flat = engine_ref.gather_pack(state, out, idx4, idx_sum)
        if dst is None:
            return flat
        dst.copy_(flat)
        return dst
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
    n = b * K + b2 * len(vals)
    if dst is not None and (tuple(dst.shape) != (n,) or dst.dtype != torch.int32
                            or not dst.is_contiguous()):
        raise ValueError("gather_pack: dst must be a contiguous int32 [n]")
    flat = dst if dst is not None else torch.empty(
        (n,), dtype=torch.int32, device=state.term.device
    )
    if b + b2:
        _native.launch("gather_pack", srcs, vals, idx4, idx_sum, flat,
                       G, O, M, E, P, W, b, b2)
    return flat


@functools.lru_cache(maxsize=256)
def _row_shapes(name: str, G_out: int, src: tuple, dst: Optional[tuple],
                same_rows: bool) -> tuple:
    """The output shapes of a row move of fields shaped ``src`` (a tuple
    of torch.Size) into ``G_out`` rows; ``dst``: the dst fields' shapes,
    which must be the outputs'; ``same_rows``: the sources must have
    ``G_out`` rows (a merge).  Raises on a mismatch; cached, as a path
    moves the same shapes call after call."""
    if not 1 <= len(src) <= 32:
        raise ValueError(f"{name}: 1..32 fields")
    G_src = src[0][0] if src[0] else 0
    if any(not s or s[0] != G_src for s in src):
        raise ValueError(f"{name}: source row counts differ")
    if same_rows and G_src != G_out:
        raise ValueError(f"{name}: escalate [G] and the fields' rows differ")
    engine_ref.check_place_source(G_out, G_src)
    shapes = tuple((G_out,) + tuple(s[1:]) for s in src)
    if dst is not None and (len(dst) != len(src) or any(
            tuple(d) != s for d, s in zip(dst, shapes))):
        raise ValueError(f"{name}: field shapes differ")
    return shapes


def _shapes(ts) -> tuple:
    return tuple(t.shape for t in ts)


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
    shapes = _row_shapes("place_rows", pos.shape[0], _shapes(src),
                         None if dst is None else _shapes(dst), False)
    flat, outs, offs = K._alloc_views(shapes, pos.device)
    if pos.shape[0]:
        _native.launch("place_rows", pos, list(dst or ()), list(src), flat,
                       offs)
    return outs


def merge_escalated(
    escalate: torch.Tensor,
    old: Sequence[torch.Tensor],
    new: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """In place: every field of ``new`` takes old's row where
    ``escalate`` ([G] int32) is nonzero; returns ``new``.  For callers
    whose ``new`` is the step's fresh output that nothing reads after the
    merge (the routed rounds' tail); the result equals
    ``engine_ref.select_escalated``'s."""
    if _device(escalate) == "cpu":
        return engine_ref.merge_escalated(escalate, old, new)
    if escalate.dim() != 1:
        raise ValueError("merge_escalated: escalate must be [G]")
    G = escalate.shape[0]
    t0 = profiling.begin()
    _row_shapes("merge_escalated", G, _shapes(new), _shapes(old), True)
    profiling.end("merge_escalated.check", t0)
    if G:
        _native.launch("merge_escalated", escalate, list(old), list(new))
    return list(new)


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
    rs, sn = K._views(((G, P), (G, P)), rstate.device)
    if G * P:
        _native.launch("set_remote_snapshot", rstate, snap_index, g_idx,
                       p_idx, snap, rs, sn)
    return rs, sn
