"""Carry device state across frameworks as numpy arrays.

This system has no weights; its "checkpoint" is the int32 row state.
These functions turn the reference package's ``DeviceState``, ``Inbox``
and ``DeviceOut`` (read out as numpy arrays, one per field) into the
port's tensors on a device, and back.  Every parity test goes through
them, so both sides always see identical int32 inputs.

The internal-layout helpers at the end move the same tensors between
the external ``[G, ...]`` layout and the reference's internal G-last
layout (``kernel.py:119-168``): state peer/ring arrays ``[P, G]`` /
``[W, G]``, inbox ``[M, G]`` / ``[M, E, G]``, ``out.buf``
``[O, N_FIELDS, G]``, ``need_snapshot`` ``[P, G]``, ``slot_base`` /
``slot_term`` ``[M, G]``, ``ent_drop`` ``[M, E, G]``.  Every result is
contiguous (the kernels take contiguous tensors only).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .types import DeviceOut, DeviceState, Inbox


def _tensors(cls, fields: Mapping[str, np.ndarray], device):
    missing = set(cls._fields) - set(fields)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(
        **{
            k: torch.from_numpy(
                np.array(fields[k], dtype=np.int32, order="C", copy=True)
            ).to(device)
            for k in cls._fields
        }
    )


def state_from_numpy(fields: Mapping[str, np.ndarray], device) -> DeviceState:
    """A ``DeviceState`` on ``device`` from a field -> int32 array map
    (e.g. ``make_state_np``'s output, or a reference state read out with
    ``np.asarray`` per field)."""
    return _tensors(DeviceState, fields, device)


def inbox_from_numpy(fields: Mapping[str, np.ndarray], device) -> Inbox:
    return _tensors(Inbox, fields, device)


def out_from_numpy(fields: Mapping[str, np.ndarray], device) -> DeviceOut:
    return _tensors(DeviceOut, fields, device)


def to_numpy(nt: NamedTuple) -> dict:
    """Inverse of the ``*_from_numpy`` functions: field -> numpy array."""
    return {k: getattr(nt, k).detach().cpu().numpy() for k in nt._fields}


# ---------------------------------------------------------------------------
# internal (G-last) layout
# ---------------------------------------------------------------------------
PEER_FIELDS = ("peer_id", "peer_kind", "match", "next_idx", "rstate",
               "snap_index", "active", "granted")
RING_FIELDS = ("ring_term", "ring_cc")


def _c(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous()


def state_to_internal(st: DeviceState) -> DeviceState:
    """[G, P] -> [P, G], [G, W] -> [W, G]; [G] fields untouched.  The
    transpose is its own inverse, as in the reference."""
    return st._replace(
        **{f: _c(getattr(st, f).t()) for f in PEER_FIELDS + RING_FIELDS}
    )


state_from_internal = state_to_internal


def inbox_to_internal(ib: Inbox) -> Inbox:
    """[G, M] -> [M, G]; [G, M, E] -> [M, E, G]."""
    return Inbox(*(_c(t.permute(1, 2, 0)) if t.dim() == 3 else _c(t.t())
                   for t in ib))


def inbox_from_internal(ib: Inbox) -> Inbox:
    return Inbox(*(_c(t.permute(2, 0, 1)) if t.dim() == 3 else _c(t.t())
                   for t in ib))


def out_to_internal(out: DeviceOut) -> DeviceOut:
    return out._replace(
        buf=_c(out.buf.permute(1, 2, 0)),
        need_snapshot=_c(out.need_snapshot.t()),
        slot_base=_c(out.slot_base.t()),
        slot_term=_c(out.slot_term.t()),
        ent_drop=_c(out.ent_drop.permute(1, 2, 0)),
    )


def out_from_internal(out: DeviceOut) -> DeviceOut:
    return out._replace(
        buf=_c(out.buf.permute(2, 0, 1)),
        need_snapshot=_c(out.need_snapshot.t()),
        slot_base=_c(out.slot_base.t()),
        slot_term=_c(out.slot_term.t()),
        ent_drop=_c(out.ent_drop.permute(2, 0, 1)),
    )
