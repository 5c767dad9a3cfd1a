"""Carry device state across frameworks as numpy arrays.

This system has no weights; its "checkpoint" is the int32 row state.
These functions turn the reference package's ``DeviceState``, ``Inbox``
and ``DeviceOut`` (read out as numpy arrays, one per field) into the
port's tensors on a device, and back.  Every parity test goes through
them, so both sides always see identical int32 inputs.
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
