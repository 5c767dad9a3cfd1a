"""Build, load and launch the port's CUDA kernels.

``csrc/*.cu`` (the kernels and their launchers, plain CUDA C++ for
``sm_90a``) and ``csrc/bindings.cpp`` (the one file with PyTorch's
headers) are compiled by ``torch.utils.cpp_extension.load`` into one
extension module under ``dragonboat_tpu_torch/_build/``.  ``load``
rebuilds whatever source or header changed and reuses the rest.
Building happens at first use — never at import.

``LAUNCHES`` counts, per kernel, the launches its wrappers made, and
``ENTRY_LAUNCHES`` the same per bound entry point (a kernel source such
as ``inbox.cu`` has several); a run resets both to show which kernels
its path went through.
"""
from __future__ import annotations

import os
import sys
import threading
from pathlib import Path

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

CUDA_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-Xptxas=-v",
)

LAUNCHES = {k: 0 for k in KERNELS}
ENTRY_LAUNCHES: dict = {}

_module = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ENTRY_LAUNCHES.clear()


def build_log() -> str:
    """The last build's compiler output (ptxas register and spill
    report included)."""
    p = BUILD / "build.log"
    return p.read_text() if p.exists() else ""


def module():
    """The extension module, built on first use.  The compiler's output
    goes to ``_build/build.log`` instead of standard output."""
    global _module
    with _lock:
        if _module is not None:
            return _module
        from torch.utils.cpp_extension import load

        BUILD.mkdir(parents=True, exist_ok=True)
        sources = [str(CSRC / f) for f in dict.fromkeys(KERNELS.values())]
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
                "kernel build failed:\n" + build_log()[-6000:]
            ) from exc
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        return _module


def launch(kernel: str, *args, entry: str = "") -> None:
    """Call the bound entry point ``entry`` (default: ``kernel``) with
    ``args``, counting one launch of ``kernel``.  The binding checks the
    tensors and the launch and raises on either."""
    getattr(module(), entry or kernel)(*args)
    LAUNCHES[kernel] += 1
    name = entry or kernel
    ENTRY_LAUNCHES[name] = ENTRY_LAUNCHES.get(name, 0) + 1
