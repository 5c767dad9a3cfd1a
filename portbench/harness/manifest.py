"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the configuration's
``file`` holds its sizes (``configs/<name>.json``), the mix is
``traffic/<mix>.json``, a per-layer metric's reader is
``metrics/<name>.py`` and a kernel's byte count ``roofline/<kernel>.py``.
A later cell, configuration, mix or metric is new files and new entries,
never an edit of this module.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def proposes(self) -> bool:
        return bool(self.traffic["propose_leaders"])


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest at ``root``, with its
    configuration and mix read and its metrics filtered to it.  Raises
    ``KeyError`` for a name the manifest does not hold."""
    man = load_manifest(root)
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[name]
    cfgs = {c["name"]: c for c in man["configs"]}
    config = json.loads((root / cfgs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / BENCH_DIR.name / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: a module with ``read(ctx)`` returning the
    metric's value, or None where the run gave it nothing to read.
    Loaded from its file, since a metric's name may hold dots."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline_modules() -> dict:
    """{kernel: module} of every ``roofline/<kernel>.py``: each has
    ``KERNELS`` (the device kernel names it times) and
    ``round_bytes(rec)`` (the least bytes one round needs)."""
    return {p.stem: importlib.import_module(f"portbench.roofline.{p.stem}")
            for p in sorted((BENCH_DIR / "roofline").glob("*.py"))
            if not p.stem.startswith("_")}
