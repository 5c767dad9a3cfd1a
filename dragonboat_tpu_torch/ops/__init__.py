"""The port's device plane: the raft step kernel and its host glue.

  types.py      — DeviceState / Inbox / DeviceOut as int32 torch tensors
  convert.py    — numpy <-> tensor carry-over of those layouts
  kernel.py     — ``step``: CUDA ``raft_step`` on the card, plain torch
                  (kernel_ref.py) on the CPU
  plumbing.py   — the launch plumbing kernels (flags, readback pack, row
                  movers) with their plain versions in engine_ref.py
  sync.py       — oracle <-> row conversion and message staging
  hostplane.py  — array-at-once host-plane machinery (numpy only)
  engine.py     — TorchStepEngine: the device-backed IStepEngine
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
