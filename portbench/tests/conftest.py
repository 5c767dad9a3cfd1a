"""Tests of the benchmark harness.  They run on the CPU at small sizes;
the cases marked ``card`` need an NVIDIA card and skip without one (the
fixture decides, never the module's import).  Run from the repo root:

    python -m pytest portbench/tests -q
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tiny(name: str):
    """The cell ``name`` cut to a CPU test's size: 9 groups (3 each of
    3, 5 and 7 replicas where the configuration is ragged) and short
    timeouts, so elections end within a few launches."""
    from portbench.harness import manifest

    cell = manifest.cell(name)
    cfg = cell.config
    per = 9 // len(cfg["memberships"])
    mem = {k: per for k in cfg["memberships"]}
    cfg.update(groups=sum(mem.values()), memberships=mem,
               election_timeout=5, heartbeat_timeout=1)
    return cell


@pytest.fixture
def tiny():
    return _tiny


@pytest.fixture
def small_bench(monkeypatch):
    """``harness.bench`` with set-up's launch counts cut for tiny cells."""
    from portbench.harness import bench

    monkeypatch.setattr(bench, "START_GROUPS", 4)
    monkeypatch.setattr(bench, "START_LAUNCHES", 6)
    monkeypatch.setattr(bench, "STEADY_LAUNCHES", 4)
    monkeypatch.setattr(bench, "ELECT_EVERY", 2)
    return bench
