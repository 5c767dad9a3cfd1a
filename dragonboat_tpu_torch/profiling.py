"""Kernel tracing hooks for the port.

``annotate(name)`` names a region in a ``torch.profiler`` trace
(``torch.profiler.record_function``); ``trace(log_dir)`` captures a
trace of CPU and CUDA activity into ``log_dir`` as a Chrome trace.

    from dragonboat_tpu_torch.profiling import annotate, trace

    with trace("/tmp/raft-trace"):
        ... run a workload ...

    with annotate("device-step"):
        ... kernel launch ...
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile CPU and (when present) CUDA activity into ``log_dir``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region for the profiler trace (cheap when not profiling)."""
    import torch

    return torch.profiler.record_function(name)
