"""Device placement for the port's ops plane.

* :func:`default_device` — the engine's home card:
  ``cuda:<DRAGONBOAT_TPU_DEVICE or 0>``.  It raises when no CUDA card
  is visible: a caller that wants the CPU says ``device="cpu"``.
* :func:`device_of_row` / :func:`rows_per_device` — the row-block
  placement contract: device ``d`` owns the contiguous row block
  ``[d*Gl, (d+1)*Gl)``.  The mesh helpers of the reference belong to
  the multi-device slice and are not carried yet.
"""
from __future__ import annotations

import os

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
