"""The raft step (``step``, ``step_routed``, ``step_internal``, sharded).

Port of ``dragonboat_tpu/ops/kernel.py`` ``step`` (:1652, external
``[G, ...]`` layout in and out), ``step_internal`` (:1674, the internal
G-last layout: state peer/ring arrays ``[P, G]`` / ``[W, G]``, inbox
``[M, G]`` / ``[M, E, G]``, ``out.buf`` ``[O, N_FIELDS, G]``, see
``convert.py``), ``state_to_internal`` / ``inbox_to_internal`` (:1692,
:1700) and ``make_step_sharded`` (:1707).  On CUDA tensors ``step`` and
``step_internal`` launch the hand-written kernels of ``csrc/raft_step.cu``
(``raft_step_kernel`` and ``raft_step_internal_kernel``: one thread per
row, blocks of ``rows_per_block`` rows whose arrays are staged in shared
memory, one row logic for both layouts) and nothing else —
``step_internal`` does not transpose around the external kernel; on CPU
tensors they run the plain PyTorch versions in ``kernel_ref.py``.  Any
other device raises.  ``step_routed`` is ``step`` for a caller that reads
only the emitted messages, their count and the escalation word (the
routed round): on CUDA its instantiation of ``raft_step_kernel`` writes
no other output.

Escalation contract (unchanged from the reference): if a row needs
anything the device cannot resolve (a log term outside the W-ring, an
outbox overflow, a cold message type) its ESC bit is set in
``out.escalate``; the host replays that row's inbox on the scalar
oracle from the pre-step snapshot and discards every device-side effect
for the row.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Tuple

import torch

from .. import profiling
from . import _native
from . import convert
from . import kernel_ref
from .placement import GroupsMesh, Sharded
from .types import N_FIELDS, DeviceOut, DeviceState, Inbox

state_to_internal = convert.state_to_internal
inbox_to_internal = convert.inbox_to_internal

# largest peer-slot count the CUDA kernel takes (its voter bit mask)
PMAX = 16
# the H100's streaming multiprocessors, and the shared memory one block
# can use (232,448 of the SM's 256 KB; NVIDIA's Hopper tuning guide)
N_SM = 132
SMEM_MAX = 232_448
# rows a block of the CUDA kernel may step, one thread each
ROWS_PER_BLOCK = (32, 64, 128)
# outbox messages a row the kernel stages in shared memory at most
STAGED_MAX = 8


def staged_messages(O: int) -> int:
    """Outbox messages a row whose words the kernel stages in its tile
    (the rest are written straight to device memory)."""
    return min(O, STAGED_MAX)


def smem_bytes(R: int, P: int, W: int, M: int, E: int, O: int,
               internal: bool = False, staged: int = -1) -> int:
    """Dynamic shared memory of a block of R rows: the tile of the 8
    peer and 2 ring arrays (8P + 2W words a row) and the staged outbox
    messages (``staged``, default ``staged_messages(O)``, N_FIELDS words
    each) at a stride of R words (G-last) or R + 1 (external: the
    transposes hit distinct banks), then one word a row for its first
    occupied inbox slot.  M and E do not count."""
    K = staged_messages(O) if staged < 0 else staged
    S = R if internal else R + 1
    return 4 * (S * (8 * P + 2 * W + K * N_FIELDS) + R)


def rows_for_every_sm(G: int, choices: tuple) -> int:
    """The largest of ``choices`` (ascending rows a block) whose blocks
    still give every SM one, else the smallest (a small G)."""
    for R in reversed(choices):
        if -(-G // R) >= N_SM:
            return R
    return choices[0]


def rows_per_block(G: int, P: int, W: int, M: int, E: int, O: int,
                   internal: bool = False) -> int:
    """Rows a block of the CUDA kernel steps: ``rows_for_every_sm`` of
    the ``ROWS_PER_BLOCK`` whose tile fits.  Raises ``ValueError`` when
    even 32 rows' tile does not fit."""
    fit = tuple(R for R in ROWS_PER_BLOCK
                if smem_bytes(R, P, W, M, E, O, internal) <= SMEM_MAX)
    if not fit:
        R = ROWS_PER_BLOCK[0]
        raise ValueError(
            f"raft_step: {R} rows of P={P}, W={W} with "
            f"{staged_messages(O)} staged outbox messages need "
            f"{smem_bytes(R, P, W, M, E, O, internal)} bytes of shared "
            f"memory, over the {SMEM_MAX} a block can use")
    return rows_for_every_sm(G, fit)


def check_peers_and_window(name: str, P: int, W: int) -> None:
    """The kernels' widths: P peer slots in [1, PMAX] (the voter bit
    mask), a ring of W a power of two (its index is a mask)."""
    if not 1 <= P <= PMAX:
        raise ValueError(f"{name}: P={P} outside [1, {PMAX}]")
    if W < 1 or W & (W - 1):
        raise ValueError(f"{name}: W={W} must be a power of two")


def step(
    state: DeviceState, inbox: Inbox, out_capacity: int = 32
) -> Tuple[DeviceState, DeviceOut]:
    """Advance every row through its inbox; returns (state', out)."""
    if _native.on_cpu(state.term, "step"):
        return kernel_ref.step(state, inbox, out_capacity)
    return _step_cuda(state, inbox, out_capacity)


class RoutedOut(NamedTuple):
    """``step_routed``'s outputs, ``DeviceOut``'s first three fields: on
    CUDA only ``buf[g, :count[g]]`` of ``buf`` is written."""

    buf: torch.Tensor       # [G, O, N_FIELDS]
    count: torch.Tensor     # [G] messages emitted
    escalate: torch.Tensor  # [G] ESC_* bitmask


def step_routed(
    state: DeviceState, inbox: Inbox, out_capacity: int = 32
) -> Tuple[DeviceState, RoutedOut]:
    """``step`` writing only what a routed round reads: the new state,
    ``count``, ``escalate`` and each row's messages below its count (the
    other words of ``buf`` are left as allocated).  On CPU tensors the
    plain step's outputs."""
    if _native.on_cpu(state.term, "step_routed"):
        new, out = kernel_ref.step(state, inbox, out_capacity)
        return new, RoutedOut(out.buf, out.count, out.escalate)
    return _step_cuda(state, inbox, out_capacity, routed=True)


def step_internal(
    state: DeviceState, inbox: Inbox, out_capacity: int = 32
) -> Tuple[DeviceState, DeviceOut]:
    """``step`` with every operand and result in the internal (G-last)
    layout; a device-resident loop keeps its state in that layout across
    launches (``state_to_internal`` / ``inbox_to_internal``)."""
    if _native.on_cpu(state.term, "step_internal"):
        new, out = kernel_ref.step_internal(state, inbox, out_capacity)
        return (DeviceState(*(t.contiguous() for t in new)),
                DeviceOut(*(t.contiguous() for t in out)))
    return _step_cuda(state, inbox, out_capacity, internal=True)


# a checked step's launch geometry in the binding's order: rows, peers, ring,
# inbox slots, entries, outbox, rows a block, staged outbox messages
StepGeometry = collections.namedtuple("StepGeometry", "G P W M E O R K")


def check_step(name: str, state: DeviceState, inbox: Inbox, O: int,
               internal: bool = False) -> StepGeometry:
    """The entry point ``name``'s checks of the operands of either layout;
    returns their launch geometry.  Raises ``ValueError``."""
    G = state.term.shape[0]
    P = state.peer_id.shape[0 if internal else 1]
    W = state.ring_term.shape[0 if internal else 1]
    M = inbox.mtype.shape[0 if internal else 1]
    E = inbox.ent_term.shape[1 if internal else 2]
    check_peers_and_window(name, P, W)
    if O < 1:
        raise ValueError(f"{name}: out_capacity={O} must be >= 1")
    K = staged_messages(O)
    R = rows_per_block(G, P, W, M, E, O, internal)

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
    return StepGeometry(G, P, W, M, E, O, R, K)


def launch_step(name: str, state: DeviceState, inbox: Inbox,
                g: StepGeometry, internal: bool = False, routed: bool = False):
    """Allocate the outputs of checked operands (geometry ``g``; the span
    ``<name>.alloc``) and launch the kernel of either layout (``routed``:
    the external one, ``RoutedOut`` only; ``launch.<name>``)."""
    t0 = profiling.begin()
    dev = state.term.device
    new = DeviceState(*_native.alloc_views(
        tuple(tuple(x.shape) for x in state), dev)[1])
    per_row = ((g.O, N_FIELDS), (), (), (g.P,), (g.M,), (g.M,), (g.M, g.E),
               (), (), ())
    kind = RoutedOut if routed else DeviceOut  # RoutedOut: the first three
    out = kind(*_native.alloc_views(tuple(
        (*d, g.G) if internal else (g.G, *d)
        for d in per_row[:len(kind._fields)]), dev)[1])
    profiling.end(_SPANS[name][1], t0)
    if g.G:
        _native.launch(name, list(state), list(new), list(inbox), list(out),
                       *g)
    return new, out


# the step's recorder spans, by entry point: (check, alloc)
_SPANS = {e: (e + ".check", e + ".alloc")
          for e in ("raft_step", "raft_step_routed", "raft_step_internal")}


def _step_cuda(state: DeviceState, inbox: Inbox, O: int,
               internal: bool = False, routed: bool = False):
    """``check_step`` (the span ``<entry>.check``), then ``launch_step``."""
    name = ("raft_step_internal" if internal
            else "raft_step_routed" if routed else "raft_step")
    t0 = profiling.begin()
    g = check_step(name, state, inbox, O, internal)
    profiling.end(_SPANS[name][0], t0)
    return launch_step(name, state, inbox, g, internal, routed)


def make_step_sharded(  # mesh-hot
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
