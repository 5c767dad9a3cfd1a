"""The raft step: ``step(state, inbox, out_capacity)``.

Port of ``dragonboat_tpu/ops/kernel.py`` ``step``: external ``[G, ...]``
layout in and out.  On CUDA tensors it launches the hand-written kernel
``csrc/raft_step.cu`` (one thread per row) and nothing else; on CPU
tensors it runs the plain PyTorch version in ``kernel_ref.py``.  Any
other device raises.

Escalation contract (unchanged from the reference): if a row needs
anything the device cannot resolve (a log term outside the W-ring, an
outbox overflow, a cold message type) its ESC bit is set in
``out.escalate``; the host replays that row's inbox on the scalar
oracle from the pre-step snapshot and discards every device-side effect
for the row.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _native
from . import kernel_ref
from .types import N_FIELDS, DeviceOut, DeviceState, Inbox

# largest peer-slot count the CUDA kernel's quorum sort holds
PMAX = 16


def step(
    state: DeviceState, inbox: Inbox, out_capacity: int = 32
) -> Tuple[DeviceState, DeviceOut]:
    """Advance every row through its inbox; returns (state', out)."""
    dev = state.term.device
    if dev.type == "cpu":
        return kernel_ref.step(state, inbox, out_capacity)
    if dev.type != "cuda":
        raise ValueError(f"step: unsupported device {dev}")
    return _step_cuda(state, inbox, out_capacity)


def _step_cuda(state: DeviceState, inbox: Inbox, O: int):
    G, P = state.peer_id.shape
    W = state.ring_term.shape[1]
    M = inbox.mtype.shape[1]
    E = inbox.ent_term.shape[2]
    if not 1 <= P <= PMAX:
        raise ValueError(f"raft_step: P={P} outside [1, {PMAX}]")
    if W < 1 or W & (W - 1):
        raise ValueError(f"raft_step: W={W} must be a power of two")
    if O < 1:
        raise ValueError(f"raft_step: out_capacity={O} must be >= 1")
    want = {
        "peer": (G, P), "ring": (G, W), "row": (G,), "slots": (G, M),
        "ents": (G, M, E),
    }
    for f in DeviceState._fields:
        kind = (
            "ring" if f.startswith("ring_")
            else "peer" if getattr(state, f).dim() == 2 else "row"
        )
        if tuple(getattr(state, f).shape) != want[kind]:
            raise ValueError(f"raft_step: state.{f} has shape "
                             f"{tuple(getattr(state, f).shape)}")
    for f in Inbox._fields:
        kind = "ents" if f.startswith("ent_") else "slots"
        if tuple(getattr(inbox, f).shape) != want[kind]:
            raise ValueError(f"raft_step: inbox.{f} has shape "
                             f"{tuple(getattr(inbox, f).shape)}")
    dev = state.term.device
    new = DeviceState(*(torch.empty_like(t) for t in state))

    def e(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = DeviceOut(
        buf=e(G, O, N_FIELDS),
        count=e(G),
        escalate=e(G),
        need_snapshot=e(G, P),
        slot_base=e(G, M),
        slot_term=e(G, M),
        ent_drop=e(G, M, E),
        append_lo=e(G),
        barrier_idx=e(G),
        barrier_term=e(G),
    )
    if G == 0:
        return new, out
    _native.launch("raft_step", list(state), list(new), list(inbox),
                   list(out), G, P, W, M, E, O)
    return new, out
