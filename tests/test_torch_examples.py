"""The three examples on the port, each run to its end in a subprocess.

``examples/torch_helloworld.py``, ``torch_kv_gateway.py`` and
``torch_multigroup.py`` are ``helloworld.py``, ``kv_gateway.py`` and
``multigroup.py`` with the port's imports and nothing else changed (the
first check below holds them so); each must exit 0 with its closing
line, loading neither ``jax`` nor anything of ``dragonboat_tpu``.  The
examples keep their NodeHost and state machine directories under a fixed
``/tmp``; each runs here as a copy whose ``/tmp`` is the case's own
``tmp_path``, so it never meets another run's directories.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = {"helloworld": "done", "kv_gateway": "ok", "multigroup": "ok"}

RUN = (
    "import runpy, sys\n"
    "sys.argv = [{path!r}]\n"
    "runpy.run_path({path!r}, run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'dragonboat_tpu'))\n"
    "print('LOADED', bad)\n"
)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_is_the_reference_with_the_port_imports(name):
    ref = (ROOT / "examples" / f"{name}.py").read_text().splitlines()
    port = (ROOT / "examples" / f"torch_{name}.py").read_text().splitlines()
    assert len(port) == len(ref)
    changed = [(a, b) for a, b in zip(ref, port) if a != b]
    assert changed
    for a, b in changed:
        assert re.sub(r"\bdragonboat_tpu\b", "dragonboat_tpu_torch", a) == b
        assert re.match(r"\s*(from|import) dragonboat_tpu_torch\b", b), b


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_port(name, tmp_path):
    src = (ROOT / "examples" / f"torch_{name}.py").read_text()
    assert "/tmp" in src
    work = tmp_path / "tmp"
    work.mkdir()
    path = str(tmp_path / f"torch_{name}.py")
    Path(path).write_text(src.replace("/tmp", str(work)))
    res = subprocess.run(
        [sys.executable, "-c", RUN.format(path=path)], cwd=str(ROOT),
        capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "LOADED []", lines[-1]
    assert lines[-2] == EXAMPLES[name], lines[-5:]
