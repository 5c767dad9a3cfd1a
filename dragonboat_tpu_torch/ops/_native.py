"""Build, load and launch the port's CUDA kernels.

``csrc/*.cu`` (the kernels and their launchers, plain CUDA C++ for
``sm_90a``) and ``csrc/bindings.cpp`` (the one file with PyTorch's
headers) are compiled by ``torch.utils.cpp_extension.load`` into one
extension module under ``dragonboat_tpu_torch/_build/``.  ``load``
rebuilds whatever source or header changed and reuses the rest.
Building happens at first use — never at import.

The build's compiler output goes to ``_build/build.log``; each compiled
source's part of it (its ptxas register and spill report) is also kept
in ``_build/ptxas/<source>.log``, so the report of the loaded module
survives a later ``load`` that compiles nothing (``build_log``).

``LAUNCHES`` counts, per kernel, the launches its wrappers made, and
``ENTRY_LAUNCHES`` the same per bound entry point (a kernel such as
``inbox`` has several, ``ENTRIES``); a run resets both to show which
kernels its path went through.  While a profiler runs, each launch is
also the span ``launch.<entry>`` of the port's recorder
(``profiling.py``), whose count is the same launch count.  ``BUILDS``
counts the times this process built or loaded the module (the
post-warm-up sentry, ``analysis/jitcheck.py``, watches it).  Every
wrapper asks ``on_cpu`` which version runs and lays its outputs out with
``alloc_views``.
"""
from __future__ import annotations

import functools
import math
import os
import re
import sys
import threading
from pathlib import Path

import torch

from .. import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
MODULE = "dragonboat_tpu_torch_kernels"

# kernel -> its source; bindings.cpp binds each kernel's entry points
# (raft_step.cu holds both layouts' kernels around one row logic;
# place_rows.cu the row moves and the in-place escalation merge)
KERNELS = {
    "raft_step": "raft_step.cu",
    "raft_step_internal": "raft_step.cu",
    "summarize_flags": "flags.cu",
    "gather_pack": "gather_pack.cu",
    "place_rows": "place_rows.cu",
    "merge_escalated": "place_rows.cu",
    "route": "route.cu",
    "inbox": "inbox.cu",
    "select_and_blob": "select_blob.cu",
    "xlane_pack": "xlane.cu",
    "xlane_scatter": "xlane.cu",
}

# bound entry point (an m.def of bindings.cpp) -> the kernel whose
# launch it counts as
ENTRIES = {
    "raft_step": "raft_step",
    "raft_step_routed": "raft_step",
    "raft_step_internal": "raft_step_internal",
    "summarize_flags": "summarize_flags",
    "gather_pack": "gather_pack",
    "place_rows": "place_rows",
    "set_remote_snapshot": "place_rows",
    "merge_escalated": "merge_escalated",
    "route": "route",
    "assemble_inbox": "inbox",
    "host_inbox_from_ticks": "inbox",
    "zero_inbox_rows": "inbox",
    "select_and_blob": "select_and_blob",
    "xlane_pack": "xlane_pack",
    "xlane_scatter": "xlane_scatter",
}

CUDA_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-Xptxas=-v",
)

# each entry point's recorder span
SPANS = {e: "launch." + e for e in ENTRIES}

LAUNCHES = {k: 0 for k in KERNELS}
ENTRY_LAUNCHES: dict = {}
# entry point -> the resident blocks an SM of its last launch, for the
# entry points whose launcher reports them (the routed step's, from the
# occupancy API)
RESIDENT_BLOCKS: dict = {}
BUILDS = 0

_module = None
_lock = threading.Lock()


def on_cpu(t: torch.Tensor, name: str) -> bool:
    """True on the CPU (the plain version runs), False on CUDA (the
    kernel runs); the entry point ``name`` raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cpu"


@functools.lru_cache(maxsize=256)
def view_plan(shapes: tuple):
    """``alloc_views``'s layout: (its words, each view's (shape, strides,
    first word), the first words); each view starts on a 16-byte boundary
    (``csrc/inbox.cu`` and ``csrc/place_rows.cu`` rely on it)."""
    total, planes = 0, []
    for s in shapes:
        strides = tuple(math.prod(s[i + 1:]) for i in range(len(s)))
        planes.append((tuple(s), strides, total))
        n = math.prod(s)
        total += n + -n % 4
    return total, tuple(planes), tuple(p[2] for p in planes)


def alloc_views(shapes: tuple, dev):
    """One int32 allocation cut into contiguous views of ``shapes``:
    (flat, views, each view's first word)."""
    total, planes, offs = view_plan(shapes)
    flat = torch.empty(total, dtype=torch.int32, device=dev)
    cut = flat.as_strided
    return flat, [cut(s, st, o) for s, st, o in planes], offs


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ENTRY_LAUNCHES.clear()


def _sources() -> list:
    return list(dict.fromkeys(KERNELS.values()))


def compiled_sections(log: str) -> dict:
    """{source file name: its part of a build's output} for every source
    the build compiled.  ninja prints each finished command (the whole
    command line, verbose) on a ``[k/n]`` line, then that command's own
    output; a ``.cu`` compile's output is its ptxas report."""
    out, cur = {}, None
    for ln in log.splitlines(keepends=True):
        if re.match(r"\[\d+/\d+\] ", ln):
            m = re.search(r"\s-c\s+(\S+)", ln)
            cur = os.path.basename(m.group(1)) if m else None
            if cur:
                out[cur] = ""
            continue
        if cur:
            out[cur] += ln
    return out


def _keep_sections(log: str) -> None:
    keep = BUILD / "ptxas"
    keep.mkdir(parents=True, exist_ok=True)
    for src, text in compiled_sections(log).items():
        (keep / f"{src}.log").write_text(text)


def build_log() -> str:
    """The ptxas register and spill report of the built module: for each
    kernel source, the output of the build that last compiled it (empty
    for a source no build here has compiled)."""
    keep = BUILD / "ptxas"
    parts = [keep / f"{src}.log" for src in _sources()]
    return "".join(p.read_text() for p in parts if p.exists())


def module():
    """The extension module, built on first use.  The compiler's output
    goes to ``_build/build.log`` instead of standard output, and each
    compiled source's part of it to ``_build/ptxas/``."""
    global _module, BUILDS
    with _lock:
        if _module is not None:
            return _module
        from torch.utils.cpp_extension import load

        BUILD.mkdir(parents=True, exist_ok=True)
        sources = [str(CSRC / f) for f in _sources()]
        sources.append(str(CSRC / "bindings.cpp"))
        sys.stdout.flush()
        saved = os.dup(1)
        try:
            with open(BUILD / "build.log", "w") as log:
                os.dup2(log.fileno(), 1)
                try:
                    _module = load(
                        name=MODULE,
                        sources=sources,
                        extra_include_paths=[str(CSRC)],
                        extra_cuda_cflags=list(CUDA_FLAGS),
                        build_directory=str(BUILD),
                        verbose=True,
                    )
                finally:
                    sys.stdout.flush()
        except Exception as exc:
            raise RuntimeError(
                "kernel build failed:\n"
                + (BUILD / "build.log").read_text()[-6000:]
            ) from exc
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        _keep_sections((BUILD / "build.log").read_text())
        BUILDS += 1
        return _module


def launch(entry: str, *args) -> None:
    """Call the bound entry point ``entry`` with ``args``, counting one
    launch of it and of its kernel (``ENTRIES``).  The binding checks the
    tensors and the launch and raises on either.  The span
    ``launch.<entry>`` covers the module lookup, the binding's argument
    conversion and checks, and the launch."""
    t0 = profiling.begin()
    res = getattr(module(), entry)(*args)
    profiling.end(SPANS[entry], t0)
    LAUNCHES[ENTRIES[entry]] += 1
    ENTRY_LAUNCHES[entry] = ENTRY_LAUNCHES.get(entry, 0) + 1
    if res is not None:
        RESIDENT_BLOCKS[entry] = res
