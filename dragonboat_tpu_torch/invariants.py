"""Env-gated internal invariant assertions.

reference: internal/invariants [U] — build-tag-gated checks that run in
race/monkeytest CI builds and compile away in production.  Python has
no build tags; the switch is the ``DRAGONBOAT_TPU_INVARIANTS`` env var
(the test suite turns it on in conftest.py, production defaults off so
the hot path pays one module-level bool).

Usage:
    from .invariants import check
    check(new_commit >= old_commit, "commit moved backwards: %d -> %d",
          old_commit, new_commit)
"""
from __future__ import annotations

import os

ENABLED = os.environ.get("DRAGONBOAT_TPU_INVARIANTS", "0") not in ("", "0")


class InvariantViolation(AssertionError):
    """An internal consistency check failed — always a bug, never an
    environmental condition; fail loudly."""


def check(cond: bool, msg: str, *args) -> None:
    if ENABLED and not cond:
        raise InvariantViolation(msg % args if args else msg)


def enable(on: bool = True) -> None:
    """Programmatic switch (tests)."""
    global ENABLED
    ENABLED = on
