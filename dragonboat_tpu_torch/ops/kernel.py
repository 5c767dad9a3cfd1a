"""The raft step: ``step``, ``step_internal`` and ``make_step_sharded``.

Port of ``dragonboat_tpu/ops/kernel.py`` ``step`` (:1652, external
``[G, ...]`` layout in and out), ``step_internal`` (:1674, the internal
G-last layout: state peer/ring arrays ``[P, G]`` / ``[W, G]``, inbox
``[M, G]`` / ``[M, E, G]``, ``out.buf`` ``[O, N_FIELDS, G]``, see
``convert.py``), ``state_to_internal`` / ``inbox_to_internal`` (:1692,
:1700) and ``make_step_sharded`` (:1707).  On CUDA tensors ``step`` and
``step_internal`` launch the hand-written kernel ``csrc/raft_step.cu``
(one thread per row; the row logic compiled once per layout, the
G-last one in ``csrc/raft_step_internal.cu``) and nothing else —
``step_internal`` does not transpose around the external kernel; on CPU
tensors they run the plain PyTorch versions in ``kernel_ref.py``.  Any
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
from . import convert
from . import kernel_ref
from .placement import GroupsMesh, Sharded
from .types import N_FIELDS, DeviceOut, DeviceState, Inbox

state_to_internal = convert.state_to_internal
inbox_to_internal = convert.inbox_to_internal

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


def step_internal(
    state: DeviceState, inbox: Inbox, out_capacity: int = 32
) -> Tuple[DeviceState, DeviceOut]:
    """``step`` with every operand and result in the internal (G-last)
    layout; a device-resident loop keeps its state in that layout across
    launches (``state_to_internal`` / ``inbox_to_internal``)."""
    dev = state.term.device
    if dev.type == "cpu":
        new, out = kernel_ref.step_internal(state, inbox, out_capacity)
        return (DeviceState(*(t.contiguous() for t in new)),
                DeviceOut(*(t.contiguous() for t in out)))
    if dev.type != "cuda":
        raise ValueError(f"step_internal: unsupported device {dev}")
    return _step_cuda(state, inbox, out_capacity, internal=True)


def _step_cuda(state: DeviceState, inbox: Inbox, O: int,
               internal: bool = False):
    G = state.term.shape[0]
    P = state.peer_id.shape[0 if internal else 1]
    W = state.ring_term.shape[0 if internal else 1]
    M = inbox.mtype.shape[0 if internal else 1]
    E = inbox.ent_term.shape[1 if internal else 2]
    name = "raft_step_internal" if internal else "raft_step"
    if not 1 <= P <= PMAX:
        raise ValueError(f"{name}: P={P} outside [1, {PMAX}]")
    if W < 1 or W & (W - 1):
        raise ValueError(f"{name}: W={W} must be a power of two")
    if O < 1:
        raise ValueError(f"{name}: out_capacity={O} must be >= 1")

    def shape(*dims):  # a per-row array of ``dims`` in this layout
        return (*dims, G) if internal else (G, *dims)

    want = {
        "peer": shape(P), "ring": shape(W), "row": (G,), "slots": shape(M),
        "ents": shape(M, E),
    }
    for f in DeviceState._fields:
        kind = (
            "ring" if f.startswith("ring_")
            else "peer" if getattr(state, f).dim() == 2 else "row"
        )
        if tuple(getattr(state, f).shape) != want[kind]:
            raise ValueError(f"{name}: state.{f} has shape "
                             f"{tuple(getattr(state, f).shape)}")
    for f in Inbox._fields:
        kind = "ents" if f.startswith("ent_") else "slots"
        if tuple(getattr(inbox, f).shape) != want[kind]:
            raise ValueError(f"{name}: inbox.{f} has shape "
                             f"{tuple(getattr(inbox, f).shape)}")
    dev = state.term.device
    new = DeviceState(*(torch.empty_like(t) for t in state))

    def e(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = DeviceOut(
        buf=e(*shape(O, N_FIELDS)),
        count=e(G),
        escalate=e(G),
        need_snapshot=e(*shape(P)),
        slot_base=e(*shape(M)),
        slot_term=e(*shape(M)),
        ent_drop=e(*shape(M, E)),
        append_lo=e(G),
        barrier_idx=e(G),
        barrier_term=e(G),
    )
    if G == 0:
        return new, out
    _native.launch(name, list(state), list(new), list(inbox), list(out), G,
                   P, W, M, E, O)
    return new, out


def make_step_sharded(
    mesh: GroupsMesh, state: DeviceState, inbox: Inbox, *,
    out_capacity: int, internal: bool = False,
):
    """The step over a 1-D groups mesh: returns
    ``step_fn(state, inbox) -> (state', out)`` that steps each device's
    row block with ``step`` (or ``step_internal``) on that device.  The
    step is row-local, so there is no exchange between devices (the
    reference's shard_map program has zero collectives) and the result
    equals the single-device step on the concatenated blocks.

    ``state`` / ``inbox`` are example operands, as in the reference; the
    callable takes global trees (cut into blocks on entry, as ``jit``
    reshards uncommitted inputs) or :class:`Sharded` ones, and returns
    :class:`Sharded` state and output so that a loop keeps its blocks
    resident (``mesh.join`` puts one back together).  ``internal=True``
    takes and gives the G-last layout, sharded on the trailing axis."""
    if len(mesh.axis_names) != 1:
        raise ValueError("groups mesh must be one-dimensional")
    G = state.term.shape[0]
    if G % mesh.size or inbox.mtype.shape[-1 if internal else 0] != G:
        raise ValueError(f"G={G} must divide over {mesh.size} devices and "
                         "match the inbox")
    fn = step_internal if internal else step

    def step_fn(st, ib) -> Tuple[Sharded, Sharded]:
        st = mesh.shard(st, internal)
        ib = mesh.shard(ib, internal)
        res = [fn(s, i, out_capacity) for s, i in zip(st.parts, ib.parts)]
        return (Sharded(tuple(r[0] for r in res), internal),
                Sharded(tuple(r[1] for r in res), internal))

    return step_fn
