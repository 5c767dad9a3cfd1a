"""Import rule and drift guard of the PyTorch port.

* ``import dragonboat_tpu_torch`` plus its ``nodehost``, ``ops.engine``,
  ``ops.kernel``, ``ops.placement``, ``ops.route``, ``ops.colocated``,
  ``storage.tan``, ``faults``, ``audit``, ``balance``, ``gateway``,
  ``gateway.rpc``, ``scenario``, ``scenario.procworker`` and
  ``ops.registry`` loads no ``jax*`` and no ``dragonboat_tpu`` module
  (in a fresh interpreter);
* no file under ``dragonboat_tpu_torch/`` imports ``jax`` or anything of
  ``dragonboat_tpu``;
* every host-plane module the port carries is byte-identical to its
  ``dragonboat_tpu/`` original, apart from the per-file allow-list of
  edited lines below (the day's worker process and its spawn line), and
  so is every carried non-Python file
  (the tan WAL's native writer source): a later fix to the reference
  host plane then shows up here instead of drifting silently;
* the carried analysis modules whose scopes name the package
  (``REWRITES``) equal the reference's after exactly the listed
  substitutions, and nothing else;
* no port test writes a fixed ``/tmp`` path: every ``"/tmp/...`` literal
  in ``tests/test_torch_*.py`` is the old side of a rewrite (a
  ``replace=`` pair of ``load_on_port`` or a ``str.replace``), so a
  checkout's own ``TMPDIR`` holds everything its tests write;
* the loader of the reference's test modules (``tests/port_loader.py``)
  rewrites every sibling import, ``from test_x import`` and ``import
  test_x [as y]`` at any indent, refuses a ``dragonboat_tpu`` import it
  cannot rewrite, and its namespace scan finds a reference name left in
  a loaded module.
"""
from __future__ import annotations

import ast
import re
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
    "storage/tan", "storage/journal", "storage/vfs", "storage/kvstore",
    "storage/kvlogdb", "storage/__init__",
    "transport/inproc", "transport/registry", "transport/transport",
    "transport/chunk", "transport/wire", "transport/tcp", "transport/gossip",
    "transport/__init__",
    "bigstate/pacing", "bigstate/dr", "bigstate/ondisk", "bigstate/__init__",
    "tools",
    "ops/hostplane",
    "native/__init__",
    "faults",
    "audit/model", "audit/history", "audit/checker", "audit/__init__",
    "balance/view", "balance/planner", "balance/executor", "balance/balancer",
    "balance/__init__",
    "gateway/admission", "gateway/routing", "gateway/gateway", "gateway/rpc",
    "gateway/__init__",
    "scenario/plan", "scenario/report", "scenario/fleet", "scenario/runner",
    "scenario/multiproc", "scenario/procworker", "scenario/__init__",
    "analysis/lockcheck",
)

# carried files that are not Python modules (byte for byte)
CARRIED_FILES = ("native/walwriter.cpp",)

# carried files that differ from the reference only by these
# substitutions, made in order over the whole file: the rule scopes and
# default paths name the port's package (raftlint) and the codec
# modules' relpaths (the wire registry and audit)
REWRITES = (("dragonboat_tpu/", "dragonboat_tpu_torch/"),
            ('"dragonboat_tpu"', '"dragonboat_tpu_torch"'))
REWRITTEN = ("analysis/raftlint", "analysis/wire_registry",
             "analysis/wirecheck")

# file -> line numbers (1-based, in the port's copy) allowed to differ:
# the day's child process loads no jax and imports the port's package
# (procworker.py), and the parent spawns the port's worker (multiproc.py)
ALLOWED_EDITS: dict = {
    "scenario/procworker": (51, 52, 53, 54, 55, 56, 58, 66, 67, 68, 69),
    "scenario/multiproc": (101,),
}


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
        "import dragonboat_tpu_torch.faults, dragonboat_tpu_torch.audit\n"
        "import dragonboat_tpu_torch.balance, dragonboat_tpu_torch.gateway\n"
        "import dragonboat_tpu_torch.gateway.rpc\n"
        "import dragonboat_tpu_torch.scenario\n"
        "import dragonboat_tpu_torch.scenario.procworker\n"
        "import dragonboat_tpu_torch.ops.registry\n"
        "import dragonboat_tpu_torch.analysis\n"
        "import dragonboat_tpu_torch.analysis.torchsync\n"
        "import dragonboat_tpu_torch.analysis.devicecheck\n"
        "import dragonboat_tpu_torch.analysis.wirecheck\n"
        "import dragonboat_tpu_torch.graft_entry\n"
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


@pytest.mark.parametrize("mod", REWRITTEN)
def test_rewritten_module_equals_reference_under_rewrites(mod):
    ref = (REF / f"{mod}.py").read_text()
    got = (PORT / f"{mod}.py").read_text()
    for old, new in REWRITES:
        ref = ref.replace(old, new)
    assert got.splitlines() == ref.splitlines(), (
        f"{mod}.py differs from the reference beyond REWRITES")


_TMP_LITERAL = re.compile(r"""(^|["'])/tmp/""")


def _rewrite_olds(tree) -> set:
    """ids of the string nodes that are the old side of a rewrite: the
    first element of a tuple in a ``replace=`` argument, or the first
    argument of a ``.replace(...)`` call."""
    olds = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "replace" and node.args:
            olds.add(id(node.args[0]))
        for kw in node.keywords:
            if kw.arg == "replace" and isinstance(kw.value,
                                                  (ast.List, ast.Tuple)):
                for pair in kw.value.elts:
                    if isinstance(pair, ast.Tuple) and pair.elts:
                        olds.add(id(pair.elts[0]))
    return olds


def _tmp_literals(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    olds = _rewrite_olds(tree)
    # an f-string's literal parts are read through the f-string itself
    olds |= {id(v) for n in ast.walk(tree) if isinstance(n, ast.JoinedStr)
             for v in n.values}
    found = []
    for node in ast.walk(tree):
        if id(node) in olds:
            continue
        if isinstance(node, ast.JoinedStr):
            parts = [v.value for v in node.values
                     if isinstance(v, ast.Constant)][:1]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            parts = [node.value]
        else:
            continue
        if any(_TMP_LITERAL.search(p) for p in parts) and (
                not isinstance(node, ast.Constant)
                or not _is_docstring(tree, node)):
            found.append(node.lineno)
    return found


def _is_docstring(tree, node) -> bool:
    for n in ast.walk(tree):
        if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef,
                          ast.AsyncFunctionDef)) and n.body:
            first = n.body[0]
            if isinstance(first, ast.Expr) and first.value is node:
                return True
    return False


def test_port_tests_write_no_fixed_tmp_path():
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) > 25
    bad = {f.name: ln for f in files if (ln := _tmp_literals(f))}
    assert not bad, f"fixed /tmp literals outside a rewrite: {bad}"


def test_fixed_tmp_scan_catches_a_literal(tmp_path):
    f = tmp_path / "test_torch_x.py"
    src = ('d = "@T/nh-x-1"\nsrc = s.replace("@T/nh-", d)\n'
           'm = load(replace=[(\'"@T/a"\', "b", 1)])\n'
           'e = f"@T/nh-{k}"\n')
    f.write_text(src.replace("@T", "/" + "tmp"))
    assert _tmp_literals(f) == [1, 4]


def test_loader_rewrites_sibling_imports_at_any_indent():
    from port_loader import port_source

    loaded = []
    src = ("import test_chaos_colocated as tcc\n"
           "def f():\n"
           "    import test_nodehost\n"
           "    import raft_harness as rh\n"
           "    from test_nodehost import set_cmd\n"
           "    from dragonboat_tpu import Fault\n"
           "    import test_nodehost_x, os\n")
    got = port_source(src, tag="zz",
                      load_sibling=lambda f, n: loaded.append((f, n)))
    assert got.splitlines() == [
        "import zz_test_chaos_colocated as tcc",
        "def f():",
        "    import zz_test_nodehost as test_nodehost",
        "    import zz_raft_harness as rh",
        "    from zz_test_nodehost import set_cmd",
        "    from dragonboat_tpu_torch import Fault",
        "    import test_nodehost_x, os",
    ]
    assert ("test_chaos_colocated.py", "zz_test_chaos_colocated") in loaded
    assert ("raft_harness.py", "zz_raft_harness") in loaded
    # without a tag, siblings are left to the ordinary import system
    assert "import test_chaos_colocated as tcc" in port_source(src)


@pytest.mark.parametrize("line", [
    "    import os, dragonboat_tpu.ops.hostplane as hp",
    "import json, dragonboat_tpu as ref",
])
def test_loader_refuses_a_reference_import_it_cannot_rewrite(line):
    from port_loader import port_source

    with pytest.raises(AssertionError):
        port_source(f"def f():\n{line}\n", "t.py")


def test_port_only_scan_catches_a_reference_name():
    import types

    from dragonboat_tpu.ops import hostplane as ref_hp
    from port_loader import assert_port_only

    mod = types.ModuleType("zz_loaded")
    exec("from dragonboat_tpu_torch.ops import hostplane as hp\n"
         "import numpy as np\n", mod.__dict__)
    assert_port_only(mod)
    mod.hp2 = ref_hp
    with pytest.raises(AssertionError):
        assert_port_only(mod)
    del mod.hp2
    mod.Plan = ref_hp.UpdateSyncPlan
    with pytest.raises(AssertionError):
        assert_port_only(mod)
