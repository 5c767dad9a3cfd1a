"""The port's wire-compat audit against the reference's goldens.

``analysis/wire_registry.py`` and ``analysis/wirecheck.py`` are carried
with their codec-module relpaths pointed at the port
(``tests/test_torch_isolation.py`` ``REWRITES``), so the audit encodes
and decodes with the port's ``pb``, ``transport/wire`` and friends.  The
goldens it reads are the reference's, ``tests/wire_goldens/``: the
port's codecs must produce the reference's bytes.  The port's CLI
refuses ``--update-goldens``, and the goldens stay as they are.
"""
from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

import pytest

from dragonboat_tpu.analysis import wire_registry as ref_registry
from dragonboat_tpu_torch.analysis import wire_registry, wirecheck

ROOT = Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "tests" / "wire_goldens"
WIRE_BASELINE = (ROOT / "dragonboat_tpu_torch" / "analysis"
                 / "wire_baseline.txt")


def _digest() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(GOLDENS.iterdir())}


def test_audit_is_clean_against_the_references_goldens():
    assert Path(wirecheck.GOLDENS_DIR) == GOLDENS
    assert wirecheck.audit(fuzz_n=40) == []


def test_audit_scans_the_ports_codec_modules():
    assert all(m.startswith("dragonboat_tpu_torch/")
               for m in wire_registry.SCAN_MODULES)
    assert wire_registry.wire.__name__ == "dragonboat_tpu_torch.transport.wire"


@pytest.mark.parametrize("name", [e.name for e in ref_registry.REGISTRY])
def test_port_codec_samples_are_the_references_bytes(name):
    got = wire_registry.entry(name)
    want = ref_registry.entry(name)
    assert sorted(got.samples) == sorted(want.samples)
    for label, build in got.samples.items():
        assert build() == want.samples[label](), (name, label)
        assert build() == (GOLDENS / wirecheck.golden_name(
            name, label)).read_bytes(), (name, label)


def test_update_goldens_is_refused_and_goldens_unchanged():
    before = _digest()
    res = subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.analysis", "--wire",
         "--update-goldens"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert res.returncode == 2, res.stdout + res.stderr
    assert "reference's goldens" in res.stderr
    assert _digest() == before


def test_cli_wire_gate_with_the_empty_baseline():
    assert WIRE_BASELINE.read_text() == ""
    res = subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.analysis", "--wire",
         "--fuzz", "40", "--baseline", str(WIRE_BASELINE)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "wirecheck: clean over" in res.stdout
