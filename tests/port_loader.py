"""The reference's test modules executed on the port.

``load_on_port`` runs a module of the reference's suite from its source
with every ``dragonboat_tpu`` import taken from ``dragonboat_tpu_torch``,
so its cases, helpers and clusters are the port's.  The port's tests use
it (through ``test_torch_storage``), and so does ``chip_smoke.py``'s
``pipeline`` phase, which runs the reference's scripted pipeline cases on
the card: this module imports nothing but the standard library.
"""
from __future__ import annotations

import re
import sys
import tempfile
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent


_SIBLING = re.compile(r"^(\s*)from (test_\w+|raft_harness) import", re.M)
_SIBLING_IMPORT = re.compile(
    r"^(\s*)import (test_\w+|raft_harness)(?: as (\w+))?[ \t]*$", re.M)


def port_source(src: str, filename: str = "<src>", *, port: bool = True,
                tag: str = "", load_sibling=None) -> str:
    """``src`` rewritten as ``load_on_port`` executes it: with ``port``,
    every ``dragonboat_tpu`` import names the port (an import the rewrite
    cannot reach fails here); with a ``tag``, ``/tmp/nh-`` directories
    move under ``<tmp>/nh-<tag>-`` and every sibling test module, whether
    by ``from test_x import ...`` or ``import test_x [as y]``, at any
    indent, becomes ``<tag>_test_x`` (``load_sibling(file, name)``
    loads it first)."""
    if port:
        src = re.sub(r"\b(from|import) dragonboat_tpu\b",
                     r"\1 dragonboat_tpu_torch", src)
        assert not re.search(r"^\s*(from|import)\s.*\bdragonboat_tpu\b"
                             r"(?!_torch)", src, re.M), filename
    if tag:
        src = src.replace("/tmp/nh-", f"{tempfile.gettempdir()}/nh-{tag}-")

        def dep(mod):
            name = f"{tag}_{mod}"
            if load_sibling is not None:
                load_sibling(f"{mod}.py", name)
            return name

        src = _SIBLING.sub(
            lambda m: f"{m.group(1)}from {dep(m.group(2))} import", src)
        src = _SIBLING_IMPORT.sub(
            lambda m: f"{m.group(1)}import {dep(m.group(2))} as "
                      f"{m.group(3) or m.group(2)}", src)
    return src


def load_on_port(filename: str, name: str, *, port: bool = True,
                 tag: str = "", replace=()) -> types.ModuleType:
    """A module of the reference's suite, executed from its source with
    every ``dragonboat_tpu`` import taken from the port (``port=False``
    keeps the reference's, for a side-by-side run of the same source).

    ``replace`` holds ``(old, new, count)`` edits made first, each of
    which must occur exactly ``count`` times.  With a ``tag``, the
    module's ``/tmp/nh-`` directories become ``<tmp>/nh-<tag>-``, under
    ``tempfile.gettempdir()`` (so a
    run never shares a directory with the reference's own test, which
    may run at the same time in another worker), and every sibling
    module it imports (``test_*``, ``raft_harness``) is loaded the same
    way as ``<tag>_<module>`` (``port_source``); a sibling loaded
    earlier under that name, with edits of its own, is the one used."""
    if name in sys.modules:
        return sys.modules[name]
    src = (TESTS / filename).read_text()
    for old, new, count in replace:
        assert src.count(old) == count, (filename, old, src.count(old))
        src = src.replace(old, new)
    src = port_source(
        src, filename, port=port, tag=tag,
        load_sibling=lambda f, n: load_on_port(f, n, port=port, tag=tag))
    mod = types.ModuleType(name)
    mod.__file__ = str(TESTS / filename)
    sys.modules[name] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def assert_port_only(mod: types.ModuleType) -> None:
    """Nothing in a loaded module's namespace comes from the reference:
    no module, class or function of ``dragonboat_tpu`` (the port's
    ``dragonboat_tpu_torch`` is a different name)."""
    def ref(qual):
        return qual == "dragonboat_tpu" or qual.startswith("dragonboat_tpu.")

    for key, val in vars(mod).items():
        qual = val.__name__ if isinstance(val, types.ModuleType) else \
            getattr(val, "__module__", None)
        assert not (isinstance(qual, str) and ref(qual)), (
            mod.__name__, key, qual)


def load_colocated_siblings(tag: str, device: str, edits=None) -> dict:
    """The reference's colocated helper modules loaded on the port as
    ``<tag>_test_*`` with their engines on ``device``, before a module
    that imports them (``test_pipeline.py``, ``test_updatelanes.py``,
    ``test_lifecycle.py``).  The edits: ``test_colocated.py``'s ``GEOM``
    (the geometry its clusters and ``test_pipeline.py``'s build from) and
    ``test_chaos_colocated.py``'s ``ColocatedEngineGroup`` call gain
    ``device=``; ``test_vector_engine.py`` imports the port's
    ``torch_step_engine_factory`` under the reference factory's name.
    ``edits`` maps a module (``"test_colocated"``) to more ``replace``
    pairs of its own."""
    dev = f'device="{device}"'
    edits = edits or {}
    return {
        "test_vector_engine": load_on_port(
            "test_vector_engine.py", f"{tag}_test_vector_engine", tag=tag,
            replace=[("from dragonboat_tpu.ops.engine import "
                      "vector_step_engine_factory",
                      "from dragonboat_tpu.ops.engine import "
                      "torch_step_engine_factory as "
                      "vector_step_engine_factory", 1),
                     *edits.get("test_vector_engine", ())]),
        "test_colocated": load_on_port(
            "test_colocated.py", f"{tag}_test_colocated", tag=tag,
            replace=[("GEOM = dict(capacity=16, P=5, W=32, M=8, E=4, O=32, "
                      "budget=4)",
                      "GEOM = dict(capacity=16, P=5, W=32, M=8, E=4, O=32, "
                      f"budget=4, {dev})", 1),
                     *edits.get("test_colocated", ())]),
        "test_chaos_colocated": load_on_port(
            "test_chaos_colocated.py", f"{tag}_test_chaos_colocated",
            tag=tag,
            replace=[("ColocatedEngineGroup(**GEOM)",
                      f"ColocatedEngineGroup(**GEOM, {dev})", 1),
                     *edits.get("test_chaos_colocated", ())]),
    }


def leader_off_first_row(wait_for_leader, shard_id: int = 1,
                         timeout: float = 10.0):
    """``wait_for_leader`` for ``test_pipeline.py``'s escalation-hold
    case, which holds the LOWEST resident row of its colocated core
    (``alive[0]``).  When that row is the leader's, the hold steps the
    leader and its proposals on the host, no generation carries routable
    work, and the case's ``fused_fences`` cannot rise (the engine counts
    a fence only where routable work was kept single-round): the case
    then fails on its election's outcome, in the reference as on the
    port.  This wait moves such a leadership to the replica on the
    highest resident row before the case goes on."""
    import time

    def wait(nhs, *a, **kw):
        lead = wait_for_leader(nhs, *a, **kw)
        core = nhs[lead].engine.step_engine.core
        with core._lock:
            alive = core._lanes.alive_mask()
            rows = sorted((g, m.node.replica_id)
                          for g, m in core._meta.items() if alive[g])
        if not rows or rows[0][1] != lead:
            return lead
        target = rows[-1][1]
        nhs[lead].request_leader_transfer(shard_id, target)
        end = time.time() + timeout
        while time.time() < end and not nhs[target].is_leader_of(shard_id):
            time.sleep(0.02)
        return wait_for_leader(nhs, *a, **kw)

    return wait
