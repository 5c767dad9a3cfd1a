"""The raft step: ``step``, ``step_internal`` and ``make_step_sharded``.

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
other device raises.

Escalation contract (unchanged from the reference): if a row needs
anything the device cannot resolve (a log term outside the W-ring, an
outbox overflow, a cold message type) its ESC bit is set in
``out.escalate``; the host replays that row's inbox on the scalar
oracle from the pre-step snapshot and discards every device-side effect
for the row.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

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


def rows_per_block(G: int, P: int, W: int, M: int, E: int, O: int,
                   internal: bool = False) -> int:
    """Rows a block of the CUDA kernel steps: the largest of
    ``ROWS_PER_BLOCK`` whose tile fits and which still gives every SM a
    block; where none does (a small G), the smallest that fits.  Raises
    ``ValueError`` when even 32 rows' tile does not fit."""
    fit = [R for R in ROWS_PER_BLOCK
           if smem_bytes(R, P, W, M, E, O, internal) <= SMEM_MAX]
    if not fit:
        R = ROWS_PER_BLOCK[0]
        raise ValueError(
            f"raft_step: {R} rows of P={P}, W={W} with "
            f"{staged_messages(O)} staged outbox messages need "
            f"{smem_bytes(R, P, W, M, E, O, internal)} bytes of shared "
            f"memory, over the {SMEM_MAX} a block can use")
    for R in reversed(fit):
        if -(-G // R) >= N_SM:
            return R
    return fit[0]


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


def _views(shapes: tuple, dev) -> list:
    """One int32 allocation cut into contiguous views of ``shapes``, each
    starting on a 16-byte boundary."""
    return _alloc_views(shapes, dev)[1]


def _alloc_views(shapes: tuple, dev):
    """``_views`` with the allocation itself and each view's word offset
    in it: (flat, views, offsets)."""
    sizes, total, cut, offs = _view_plan(shapes)
    flat = torch.empty(total, dtype=torch.int32, device=dev)
    views = []
    for p, s, n in zip(flat.split(sizes), shapes, cut):
        if n:
            p = p[:n]
        views.append(p if len(s) == 1 else p.view(s))
    return flat, views, offs


@functools.lru_cache(maxsize=256)
def _view_plan(shapes: tuple):
    """(each view's words rounded up to 4, their sum, each view's words
    where it was rounded up, else 0, each view's first word)"""
    sizes, cut, offs = [], [], []
    total = 0
    for s in shapes:
        n = math.prod(s)
        offs.append(total)
        sizes.append(n + -n % 4)
        cut.append(n if n % 4 else 0)
        total += sizes[-1]
    return tuple(sizes), total, tuple(cut), tuple(offs)


def _step_cuda(state: DeviceState, inbox: Inbox, O: int,
               internal: bool = False):
    """Check the operands, allocate the outputs and launch the kernel of
    either layout."""
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
    dev = state.term.device
    new = DeviceState(*_views(tuple(tuple(t.shape) for t in state), dev))
    out = DeviceOut(*_views((
        shape(O, N_FIELDS), (G,), (G,), shape(P), shape(M), shape(M),
        shape(M, E), (G,), (G,), (G,)), dev))
    if G == 0:
        return new, out
    _native.launch(name, list(state), list(new), list(inbox), list(out), G,
                   P, W, M, E, O, R, K)
    return new, out


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
