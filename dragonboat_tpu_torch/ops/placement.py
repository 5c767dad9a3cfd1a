"""Device placement for the port's ops plane.

* :func:`default_device` — the engine's home card:
  ``cuda:<DRAGONBOAT_TPU_DEVICE or 0>``.  It raises when no CUDA card
  is visible: a caller that wants the CPU says ``device="cpu"``.
* :func:`device_of_row` / :func:`rows_per_device` — the row-block
  placement contract: device ``d`` owns the contiguous row block
  ``[d*Gl, (d+1)*Gl)``.
* :class:`GroupsMesh` / :func:`groups_mesh` — the 1-D ``"groups"`` mesh
  of the sharded device plane.  The reference holds a
  ``jax.sharding.Mesh`` in one process and lets ``shard_map`` cut every
  ``[G, ...]`` leaf into per-device row blocks; the port is
  single-controller in the same way: one process holds a
  ``GroupsMesh`` of devices, and :meth:`GroupsMesh.shard` /
  :meth:`GroupsMesh.join` cut a pytree into per-device blocks
  (:class:`Sharded`) and put it back together.  A mesh may repeat a
  device (``["cpu"] * 4``, ``[cuda:0] * 4``): the counterpart of the
  reference's forced host devices, one block per entry.
* :class:`RowBlocks` — the engines' per-block map over a mesh: global
  row indexes to (block, local) and back (:meth:`RowBlocks.split_rows`
  keeps the caller's order, so a join restores it), numpy row arrays
  cut into per-block tensors, and the reference's striped free-row
  order.  A one-device mesh is one block holding every row: the
  single-device engine.
"""
from __future__ import annotations

import os
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


def default_device() -> torch.device:
    """``cuda:<i>`` with ``i`` from ``DRAGONBOAT_TPU_DEVICE`` (default 0);
    raises when CUDA is unavailable or ``i`` is out of range."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    idx = int(os.environ.get("DRAGONBOAT_TPU_DEVICE", "0") or 0)
    n = torch.cuda.device_count()
    if not 0 <= idx < n:
        raise ValueError(
            f"DRAGONBOAT_TPU_DEVICE={idx} out of range: {n} device(s) visible"
        )
    return torch.device("cuda", idx)


def resolve_device(device=None) -> torch.device:
    """An explicit device as given (``"cpu"``, ``"cuda"``, ``"cuda:1"``,
    a ``torch.device``), or :func:`default_device` for None.  A CUDA
    device without CUDA raises; nothing falls back to the CPU."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = default_device()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def rows_per_device(capacity: int, n_devices: int) -> int:
    """Block size of the row-block placement; capacity must divide."""
    if n_devices <= 0 or capacity % n_devices:
        raise ValueError(
            f"capacity {capacity} must divide over {n_devices} devices"
        )
    return capacity // n_devices


def device_of_row(g: int, capacity: int, n_devices: int) -> int:
    """Device coordinate hosting row ``g`` under the block contract."""
    return g // rows_per_device(capacity, n_devices)


# ---------------------------------------------------------------------------
# the groups mesh
# ---------------------------------------------------------------------------
class Sharded(NamedTuple):
    """A pytree cut into per-device row blocks: ``parts[d]`` is device
    ``d``'s block (same structure as the global tree, on
    ``mesh.devices[d]``).  ``internal`` says the row axis is the LAST
    axis of every leaf (the G-last layout) instead of the first."""

    parts: Tuple[Any, ...]
    internal: bool = False


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map(fn, x) for x in tree))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _leaves(x)]


def _rows(t: torch.Tensor, internal: bool) -> int:
    return t.shape[-1] if internal else t.shape[0]


class GroupsMesh:
    """A 1-D mesh over the groups axis: device ``d`` owns row block
    ``[d*Gl, (d+1)*Gl)`` of every ``[G, ...]`` array (or ``[..., G]``
    in the internal layout).  The counterpart of the reference's
    ``Mesh(devices, ("groups",))`` with ``.size``, ``.axis_names`` and
    ``.devices``.  A CUDA device without CUDA raises."""

    def __init__(self, devices, axis_name: str = "groups"):
        devs = tuple(_mesh_device(d) for d in devices)
        if not devs:
            raise ValueError("a groups mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError("a groups mesh is all CPU or all CUDA")
        self.devices = devs
        self.axis_names = (axis_name,)
        self.size = len(devs)

    def __repr__(self) -> str:
        return f"GroupsMesh({[str(d) for d in self.devices]})"

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def shard(self, tree, internal: bool = False) -> Sharded:
        """``tree`` (a tensor or a NamedTuple of them) as per-device
        contiguous row blocks, block ``d`` on ``devices[d]``; the row
        axis is the first (``internal=False``) or the last, and the row
        count must divide.  An already-sharded tree of this mesh is
        returned as it is (as ``jit`` keeps committed inputs)."""
        if isinstance(tree, Sharded):
            if len(tree.parts) != self.size or tree.internal != internal:
                raise ValueError("sharded input does not fit this mesh")
            return tree
        G = _rows(_leaves(tree)[0], internal)
        gl = rows_per_device(G, self.size)

        def block(d):
            def cut(t):
                if _rows(t, internal) != G:
                    raise ValueError("mesh.shard: leaves disagree on the "
                                     "row count")
                lo, hi = d * gl, (d + 1) * gl
                b = t[..., lo:hi] if internal else t[lo:hi]
                return b.to(self.devices[d]).contiguous()
            return _map(cut, tree)

        return Sharded(tuple(block(d) for d in range(self.size)), internal)

    def join(self, tree, device=None):
        """The global tree of a :class:`Sharded` one, its blocks
        concatenated on ``device`` (default: the mesh's first device); a
        global tree passes through."""
        if not isinstance(tree, Sharded):
            return tree
        device = device or self.devices[0]
        flat = [_leaves(p) for p in tree.parts]
        joined = iter([
            torch.cat([f[i].to(device) for f in flat],
                      dim=-1 if tree.internal else 0)
            for i in range(len(flat[0]))
        ])
        return _map(lambda _t: next(joined), tree.parts[0])


def _mesh_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev} requested but CUDA is "
                               "unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {dev}: only "
                             f"{torch.cuda.device_count()} visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}")
    return dev


def groups_mesh(n_devices: Optional[int] = None) -> Optional[GroupsMesh]:
    """A mesh over the first ``n_devices`` CUDA cards, or None for
    single-device mode.  ``n_devices`` defaults to
    ``DRAGONBOAT_TPU_MESH_DEVICES``; unset, 0 or 1 gives None.  Raises
    when fewer cards are visible."""
    if n_devices is None:
        n_devices = int(
            os.environ.get("DRAGONBOAT_TPU_MESH_DEVICES", "0") or 0
        )
    if n_devices <= 1:
        return None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < n_devices:
        raise ValueError(
            f"mesh wants {n_devices} devices, only {n} visible"
        )
    return GroupsMesh([torch.device("cuda", i) for i in range(n_devices)])


# ---------------------------------------------------------------------------
# the engines' per-block map
# ---------------------------------------------------------------------------
class RowBlocks:
    """The row blocks of an engine's ``capacity`` rows over ``mesh``:
    block ``d`` lives on ``mesh.devices[d]`` and holds the global rows
    ``[d*per, (d+1)*per)``.  Every full-width row array of the engine is
    a :class:`Sharded` of this map (:meth:`put`), every device program
    runs once per block on that block's tensors, and readbacks are
    joined on the host in global row order (or the caller's order:
    :meth:`split_rows`)."""

    def __init__(self, mesh: GroupsMesh, capacity: int):
        if len(mesh.axis_names) != 1:
            raise ValueError("engine mesh must be one-dimensional")
        self.mesh = mesh
        self.capacity = capacity
        self.D = mesh.size
        self.per = rows_per_device(capacity, mesh.size)
        self.devices = mesh.devices

    def span(self, d: int) -> Tuple[int, int]:
        """Block ``d``'s global rows ``[lo, hi)``."""
        return d * self.per, (d + 1) * self.per

    def block_of(self, g: int) -> int:
        return g // self.per

    def split_rows(self, idx) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """``[(d, local, order)]`` for every block the global rows ``idx``
        touch, in block order: ``local`` (int32) are the block-local
        indexes of ``idx[order]``, in the caller's order, so ``out[order]
        = block_result`` puts a block's per-row results back in place."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        d_of = idx // self.per
        parts = []
        for d in np.unique(d_of).tolist():
            order = np.nonzero(d_of == d)[0]
            parts.append((int(d), (idx[order] - d * self.per).astype(
                np.int32), order))
        return parts

    def striped_free(self) -> List[int]:
        """The reference's free-row order (engine.py:726-739): consecutive
        attaches land on distinct blocks (pops come from the END of the
        list, so the stripe is built reversed); one block: every row,
        lowest popped first."""
        order = [b * self.per + i for i in range(self.per)
                 for b in range(self.D)]
        return list(reversed(order))

    def put(self, x) -> Sharded:
        """A full-width row array (numpy, tensor, or a NamedTuple of
        them) as per-block tensors on the blocks' devices.  When every
        block shares one device the tree moves there once and the blocks
        are row views of it (a host-to-device copy from pageable memory
        waits for the device's queued work: one a field, not one a
        field and a block)."""
        t = _tensor_tree(x)
        if any(v.shape[0] != self.capacity for v in _leaves(t)):
            raise ValueError(f"RowBlocks.put: every leaf must have "
                             f"{self.capacity} rows")
        if len(set(self.devices)) > 1:
            return self.mesh.shard(t)
        whole = _map(lambda v: v.to(self.devices[0]), t)
        return Sharded(tuple(
            _map(lambda v, d=d: v[d * self.per:(d + 1) * self.per], whole)
            for d in range(self.D)))

    def put_each(self, x) -> Tuple[Any, ...]:
        """A small array (indexes, a sub-state, the launch's combo) on
        every block's device — the counterpart of the reference's
        replicated puts; blocks that share a device share the copy."""
        t = _tensor_tree(x)
        on = {dv: _map(lambda v, dv=dv: v.to(dv), t)
              for dv in dict.fromkeys(self.devices)}
        return tuple(on[dv] for dv in self.devices)

    def numpy(self, parts) -> np.ndarray:
        """Per-block [per, ...] tensors joined on the host in global row
        order: one copy to the host when the blocks share a device."""
        if len({p.device for p in parts}) == 1:
            return torch.cat([p.detach() for p in parts]).cpu().numpy()
        return np.concatenate([p.detach().cpu().numpy() for p in parts])


def _tensor_tree(x):
    """numpy leaves as int32 tensors (bool masks too: the kernels' words)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tensor_tree(t) for t in x))
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    return x
