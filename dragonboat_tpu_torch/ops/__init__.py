"""The port's device plane: the kernels and their host glue.

  types.py      — DeviceState / Inbox / DeviceOut as int32 torch tensors
  convert.py    — numpy <-> tensor carry-over of those layouts
  kernel.py     — ``step`` / ``step_internal`` (external and G-last
                  layout): CUDA ``raft_step`` on the card, plain torch
                  (kernel_ref.py) on the CPU; ``make_step_sharded``
  placement.py  — the home device, the row-block contract, the
                  ``GroupsMesh`` of the sharded plane
  plumbing.py   — the launch plumbing kernels (flags, readback pack, row
                  movers) with their plain versions in engine_ref.py
  sync.py       — oracle <-> row conversion and message staging
  hostplane.py  — array-at-once host-plane machinery (numpy only)
  engine.py     — TorchStepEngine: the device-backed IStepEngine
  route.py      — the device router (CUDA ``route``; route_ref.py), the
                  routed rounds built on it, and the sharded round with
                  its cross-device lane (CUDA ``xlane_pack`` /
                  ``xlane_scatter``)
  colocated.py  — ColocatedEngineGroup: one device state for every
                  NodeHost of a colocated cluster, its programs (CUDA
                  ``inbox``, ``select_and_blob``; colocated_ref.py)
"""
from .types import DeviceOut, DeviceState, Inbox, make_inbox, make_out, make_state
from .kernel import step
from .engine import TorchStepEngine, torch_step_engine_factory

__all__ = [
    "DeviceOut",
    "DeviceState",
    "Inbox",
    "make_inbox",
    "make_out",
    "make_state",
    "step",
    "TorchStepEngine",
    "torch_step_engine_factory",
]
