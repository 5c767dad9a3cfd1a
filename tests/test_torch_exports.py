"""The port's package exports match the reference's.

``dragonboat_tpu_torch.__all__`` holds the same names as
``dragonboat_tpu.__all__`` (read from the reference's source by AST, so
the reference package is not imported), each name imports from the
port, and so does every other name the reference's ``__init__`` pulls
in at top level (``FaultController``, ``Fault``, ...).
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

import dragonboat_tpu_torch

REF_INIT = Path(__file__).resolve().parent.parent / "dragonboat_tpu" / "__init__.py"


def _ref_tree():
    return ast.parse(REF_INIT.read_text(), filename=str(REF_INIT))


def _ref_all():
    for node in _ref_tree().body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError("reference __init__ has no __all__")


def _ref_imported():
    return sorted(
        a.asname or a.name
        for node in _ref_tree().body
        if isinstance(node, ast.ImportFrom) and node.level == 1
        for a in node.names
    )


def test_all_equals_reference():
    ref = _ref_all()
    assert len(ref) == 47
    assert len(dragonboat_tpu_torch.__all__) == len(set(dragonboat_tpu_torch.__all__))
    assert set(dragonboat_tpu_torch.__all__) == set(ref)


@pytest.mark.parametrize("name", _ref_imported())
def test_reference_name_imports_from_port(name):
    obj = getattr(dragonboat_tpu_torch, name)
    mod = getattr(obj, "__module__", None)
    if mod is not None:
        assert mod.split(".")[0] == "dragonboat_tpu_torch", (name, mod)
