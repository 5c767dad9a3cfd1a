"""Import rule and drift guard of the PyTorch port.

* ``import dragonboat_tpu_torch`` plus its ``nodehost``, ``ops.engine``,
  ``ops.kernel``, ``ops.placement``, ``ops.route``, ``ops.colocated``
  and ``storage.tan`` loads no ``jax*`` and no ``dragonboat_tpu`` module
  (in a fresh interpreter);
* no file under ``dragonboat_tpu_torch/`` imports ``jax`` or anything of
  ``dragonboat_tpu``;
* every host-plane module the port carries is byte-identical to its
  ``dragonboat_tpu/`` original, apart from the per-file allow-list of
  edited lines below (empty), and so is every carried non-Python file
  (the tan WAL's native writer source): a later fix to the reference
  host plane then shows up here instead of drifting silently.
"""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dragonboat_tpu_torch"
REF = ROOT / "dragonboat_tpu"

CARRIED = (
    "pb", "settings", "logger", "raftio", "config", "client", "id",
    "invariants", "events", "metrics", "statemachine", "request", "env",
    "node", "nodehost",
    "obs/trace", "obs/recorder", "obs/slo", "obs/fleetscope", "obs/__init__",
    "readplane/consistency", "readplane/router", "readplane/__init__",
    "engine/execengine", "engine/__init__",
    "utils/stopper", "utils/__init__",
    "raft/log", "raft/peer", "raft/quiesce", "raft/raft", "raft/read_index",
    "raft/remote", "raft/__init__",
    "rsm/managed", "rsm/membership", "rsm/session", "rsm/statemachine",
    "rsm/__init__",
    "storage/logdb", "storage/snapshotio", "storage/snapshotter",
    "storage/tan", "storage/journal", "storage/vfs", "storage/__init__",
    "transport/inproc", "transport/registry", "transport/transport",
    "transport/chunk", "transport/wire", "transport/tcp", "transport/gossip",
    "transport/__init__",
    "bigstate/pacing", "bigstate/dr", "bigstate/__init__", "tools",
    "ops/hostplane",
    "native/__init__",
)

# carried files that are not Python modules (byte for byte)
CARRIED_FILES = ("native/walwriter.cpp",)

# file -> line numbers (1-based, in the port's copy) allowed to differ
ALLOWED_EDITS: dict = {}


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import dragonboat_tpu_torch, dragonboat_tpu_torch.nodehost\n"
        "import dragonboat_tpu_torch.ops.engine\n"
        "import dragonboat_tpu_torch.ops.kernel\n"
        "import dragonboat_tpu_torch.ops.placement\n"
        "import dragonboat_tpu_torch.ops.route\n"
        "import dragonboat_tpu_torch.ops.colocated\n"
        "import dragonboat_tpu_torch.storage.tan\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'dragonboat_tpu' or m.startswith('dragonboat_tpu.'))\n"
        "print(repr(bad))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 45
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "dragonboat_tpu"), (
                f"{f.relative_to(ROOT)} imports {name}"
            )


@pytest.mark.parametrize("mod", CARRIED)
def test_carried_module_is_byte_identical(mod):
    ref = (REF / f"{mod}.py").read_bytes().splitlines()
    got = (PORT / f"{mod}.py").read_bytes().splitlines()
    allowed = ALLOWED_EDITS.get(mod, ())
    if not allowed:
        assert got == ref, f"{mod}.py drifted from the reference"
        return
    assert len(got) == len(ref), f"{mod}.py: line count drifted"
    for i, (a, b) in enumerate(zip(ref, got), start=1):
        if i not in allowed:
            assert a == b, f"{mod}.py:{i} drifted from the reference"


@pytest.mark.parametrize("path", CARRIED_FILES)
def test_carried_file_is_byte_identical(path):
    assert (PORT / path).read_bytes() == (REF / path).read_bytes(), (
        f"{path} drifted from the reference"
    )
