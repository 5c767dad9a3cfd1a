"""Big-state plane: on-disk state machines, streaming snapshot
delivery, and disaster-recovery export/import (docs/BIGSTATE.md).

Submodules (imported lazily — the transport layer pulls ``pacing`` at
module load and must not drag the storage/rsm stack in with it):

* :mod:`.pacing`  — ``TokenBucket`` (the shared snapshot-stream
  bandwidth cap) and ``CapFeedback`` (the LatencyBudget-style loop that
  shrinks the cap when the commit path degrades).
* :mod:`.ondisk`  — ``OnDiskKV``, the reference ``IOnDiskStateMachine``
  over ``storage/vfs`` (WAL + checkpoint, applied-index persistence,
  crash-consistent tail replay).
* :mod:`.dr`      — portable snapshot archives with a self-describing
  manifest; the ``NodeHost.export_snapshot``/``import_snapshot`` core.
"""
from __future__ import annotations

import os

from .pacing import CapFeedback, TokenBucket

__all__ = ["CapFeedback", "TokenBucket", "gb_tier"]


def gb_tier() -> bool:
    """True when the operator armed the GB-scale big-state tier
    (``DRAGONBOAT_BIGSTATE_GB=1``): the slow catch-up tests and the
    full production-day soak (docs/SCENARIO.md) then size their on-disk
    shard near a gigabyte and keep streams capped; everything else
    stays at the MB-scale default."""
    return os.environ.get("DRAGONBOAT_BIGSTATE_GB", "0") not in ("", "0")


def __getattr__(name):
    # lazy: `from dragonboat_tpu.bigstate import ondisk / dr` works
    # without making transport -> pacing imports pull the full stack
    if name in ("ondisk", "dr"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
