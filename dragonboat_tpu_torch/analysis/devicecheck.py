"""devicecheck: the device-plane policies of the reference's program
auditor, for the port's registry and its CUDA kernels.

The reference's ``jaxcheck`` traces each jitted program and reads its
jaxpr.  The port runs eagerly and launches hand-written kernels, so this
auditor runs each entry of ``ops/registry.py`` (``all_entry_points()``
plus the two mesh entries over ``GroupsMesh([dev] * 2)``) and reads what
comes back, the kernels' sources and the build's ptxas report:

``dtype``
    Every input and output leaf of every entry, on its canonical and its
    ``live(1)`` inputs, is ``int32``, ``uint32`` or ``bool`` (the
    bindings reject anything else at launch; the plain versions do not).

``transfer``
    Static: raftlint's ``host-sync`` rule and the torch-sync pass over
    ``ops/kernel.py`` and ``ops/route.py``.  On the card (``cuda=True``):
    each entry whose operands are all device tensors (the programs the
    reference compiles as one pure program; an entry taking a host mask
    uploads it by contract) runs under
    ``torch.cuda.set_sync_debug_mode("error")``, and a synchronizing
    call is a finding.

``donation``
    For each operand the reference donates (``EntryPoint.donate``), the
    leaves that have an output of the same shape and dtype (a maximal
    matching, as the reference counts it) come back in the operand's own
    storage: same ``untyped_storage().data_ptr()`` and offset.  A fresh
    allocation there is the heap-growth class the reference's donation
    exists to remove.

``g-last``
    ``step_internal``'s state and inbox keep G as the trailing axis of
    every leaf, in and out (every output leaf too).  This is weaker than
    the reference's rule, which checks every intermediate of the traced
    program: a kernel's intermediates live in registers and shared
    memory, out of this check's sight.

``unregistered-kernel``
    ``registry.unregistered_kernels()`` is empty: every binding and every
    ``__global__`` under ``csrc/`` is reached by a registered program.

``spill``
    Every ``__global__`` in the build's ptxas report has a 0-byte stack
    frame and 0 bytes of spill stores and loads (card only: the report
    comes from ``nvcc``).

Findings are ``raftlint.Finding`` rows keyed by entry (or file, or
kernel) and rule, gated by ``raftlint.gate`` against
``analysis/device_baseline.txt``:
``python -m dragonboat_tpu_torch.analysis --device [--cuda]``.
"""
from __future__ import annotations

import re
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from . import torchsync
from .raftlint import Finding

PKG = Path(__file__).resolve().parent.parent
BASELINE = Path(__file__).resolve().parent / "device_baseline.txt"

RULES = ("dtype", "transfer", "donation", "g-last", "unregistered-kernel",
         "spill")
_OK_TORCH = {torch.int32, torch.uint32, torch.bool}
_OK_NUMPY = {np.dtype(np.int32), np.dtype(np.uint32), np.dtype(np.bool_)}
# the pure-device modules the static transfer rule lints
TRANSFER_MODULES = ("ops/kernel.py", "ops/route.py")


def _registry():
    from ..ops import registry

    return registry


def _leaves(tree) -> list:
    """Tensors and numpy arrays of an operand or a result, in order
    (a registry ``Host`` operand gives its array)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, _registry().Host):
        return [tree.value]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return []


def _dtype_ok(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype in _OK_TORCH
    return leaf.dtype in _OK_NUMPY


def _inputs(ep, device, seed=None):
    args, kw = ep.build() if seed is None else ep.live(seed)
    return _registry().materialize(args, device), kw


# -- dtype ---------------------------------------------------------------
def check_dtype(ep, device="cpu") -> List[Finding]:
    out: List[Finding] = []
    for seed in (None, 1):
        ins, kw = _inputs(ep, device, seed)
        where = "canonical" if seed is None else f"live({seed})"
        bad = [f"input leaf {i} {leaf.dtype}"
               for i, leaf in enumerate(_leaves(ins)) if not _dtype_ok(leaf)]
        res = _leaves(ep.fn(*ins, **kw))
        bad += [f"output leaf {i} {leaf.dtype}"
                for i, leaf in enumerate(res) if not _dtype_ok(leaf)]
        out += [Finding(ep.name, 0, "dtype",
                        f"{b} on {where} inputs (the device plane is "
                        "int32 / uint32 / bool)") for b in bad]
    return out


# -- donation ------------------------------------------------------------
def _key(t: torch.Tensor):
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), t.dtype)


def check_donation(ep, device="cpu") -> List[Finding]:
    if not ep.donate:
        return []
    ins, kw = _inputs(ep, device)
    donated = [leaf for i in ep.donate for leaf in _leaves(ins[i])
               if isinstance(leaf, torch.Tensor)]
    want = Counter((tuple(t.shape), t.dtype) for t in donated)
    keys = Counter(_key(t) for t in donated)
    res = [t for t in _leaves(ep.fn(*ins, **kw))
           if isinstance(t, torch.Tensor)]
    outs = Counter((tuple(t.shape), t.dtype) for t in res)
    expected = sum(min(n, outs.get(k, 0)) for k, n in want.items())
    actual = 0
    for t in res:
        k = _key(t)
        if keys[k] > 0:
            keys[k] -= 1
            actual += 1
    if actual >= expected:
        return []
    return [Finding(ep.name, 0, "donation",
                    f"only {actual}/{expected} shape-matched donated leaves "
                    "come back in their operand's storage — a fresh "
                    "allocation where the reference aliases (heap growth)")]


# -- G-last ----------------------------------------------------------------
def check_g_last(ep, device="cpu") -> List[Finding]:
    if not ep.g_last:
        return []
    G = _registry().CANON["G"]
    ins, kw = _inputs(ep, device)
    res = ep.fn(*ins, **kw)
    out: List[Finding] = []
    for what, tree in (("state in", ins[0]), ("inbox in", ins[1]),
                       ("result", res)):
        for i, t in enumerate(_leaves(tree)):
            shape = tuple(t.shape)
            if shape and G in shape and shape[-1] != G:
                out.append(Finding(
                    ep.name, 0, "g-last",
                    f"{what} leaf {i} is G-major {shape} in an internal-"
                    "layout program — G must trail"))
    return out


# -- transfer ------------------------------------------------------------
def check_transfer_static(pkg: Path = PKG) -> List[Finding]:
    out: List[Finding] = []
    for rel in TRANSFER_MODULES:
        path = pkg / rel
        relpath = f"{pkg.name}/{rel}"
        out += [f for f in torchsync.lint_source(path.read_text(), relpath)
                if f.rule == "host-sync"]
    return [Finding(f.path, f.line, "transfer", f.message) for f in out]


def _on_device_only(ep) -> bool:
    args, _kw = ep.build()
    return not any(isinstance(a, _registry().Host) for a in args)


def check_transfer_cuda(entries: Iterable) -> List[Finding]:
    """Each all-device entry once to warm, then once under
    ``set_sync_debug_mode("error")`` (restored afterwards)."""
    out: List[Finding] = []
    for ep in entries:
        if not _on_device_only(ep):
            continue
        ins, kw = _inputs(ep, "cuda")
        ep.fn(*_inputs(ep, "cuda")[0], **kw)
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ep.fn(*ins, **kw)
        except RuntimeError as exc:
            out.append(Finding(ep.name, 0, "transfer",
                               "synchronizing call in a device program: "
                               + str(exc).splitlines()[0]))
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
    return out


# -- unregistered kernels --------------------------------------------------
def check_unregistered(csrc: Optional[Path] = None) -> List[Finding]:
    reg = _registry()
    found = reg.unregistered_kernels(csrc or reg.CSRC)
    return [Finding("csrc", 0, "unregistered-kernel", f) for f in found]


# -- spills ------------------------------------------------------------------
def ptxas_table(log: str, kernels: Optional[Sequence[str]] = None
                ) -> List[dict]:
    """One row per entry function of the build's ptxas report: the
    ``__global__`` it instantiates (``kernels``, default every name of
    ``registry.GLOBALS``; the mangled name where none matches),
    registers, stack frame, spill stores and loads, static shared
    memory (None where the report has no such line)."""
    if kernels is None:
        kernels = sorted({g for gs in _registry().GLOBALS.values()
                          for g in gs}, key=len, reverse=True)
    rows: List[dict] = []
    cur = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            name = next((k for k in kernels if k in mangled), mangled)
            cur = dict(kernel=name, mangled=mangled, regs=None, stack=None,
                       spill_stores=None, spill_loads=None, static_smem=0)
            rows.append(cur)
            continue
        if cur is None:
            continue
        for key, pat in (("regs", r"Used (\d+) registers"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("static_smem", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                cur[key] = int(m.group(1))
    return rows


def check_spill(log: str) -> List[Finding]:
    """A finding for each ``__global__`` of the report with a stack frame
    or spills, and for each registered one (``registry.GLOBALS``) the
    report does not name: an empty report checks nothing, so it fails."""
    table = ptxas_table(log)
    seen = {r["kernel"] for r in table}
    out: List[Finding] = [
        Finding(g, 0, "spill", "no entry in the build's ptxas report")
        for g in sorted({g for gs in _registry().GLOBALS.values()
                         for g in gs} - seen)]
    for r in table:
        bad = {k: r[k] for k in ("stack", "spill_stores", "spill_loads")
               if r[k]}
        if bad or r["regs"] is None:
            out.append(Finding(
                r["kernel"], 0, "spill",
                f"{r['mangled']}: " + (", ".join(
                    f"{v} bytes {k.replace('_', ' ')}" for k, v in bad.items())
                    or "no register line in the ptxas report")))
    return out


# -- the audit -------------------------------------------------------------
def audit(entries=None, *, cuda: bool = False,
          build_log: Optional[str] = None) -> List[Finding]:
    """Every rule over ``entries`` (default: the whole registry, with
    the mesh entries over ``GroupsMesh([dev] * 2)``, plus the static
    transfer lint and the source scan), on the CPU or (``cuda=True``) on
    the card with the sync-debug transfer check; ``build_log`` (the
    build's ptxas report) adds the spill rule."""
    reg = _registry()
    whole = entries is None
    if whole:
        from ..ops.placement import GroupsMesh

        entries = reg.all_entry_points(
            GroupsMesh(["cuda:0" if cuda else "cpu"] * 2))
    dev = "cuda" if cuda else "cpu"
    findings: List[Finding] = []
    for ep in entries:
        findings += check_dtype(ep, dev)
        findings += check_donation(ep, dev)
        findings += check_g_last(ep, dev)
    if cuda:
        findings += check_transfer_cuda(entries)
    if whole:
        findings += check_transfer_static()
        findings += check_unregistered()
    if build_log is not None:
        findings += check_spill(build_log)
    return findings


def main(argv=None) -> int:
    import argparse
    import sys

    from .raftlint import gate, load_baseline, write_baseline

    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.analysis --device",
        description=__doc__.splitlines()[0])
    ap.add_argument("--cuda", action="store_true",
                    help="run the entries on the card, with the sync "
                         "debug transfer check and the spill rule")
    ap.add_argument("--baseline", default=None,
                    help="baseline file to gate against")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the findings, exit 0")
    args = ap.parse_args(argv)
    log = None
    if args.cuda:
        from ..ops import _native

        _native.module()
        log = _native.build_log()
    findings = audit(cuda=args.cuda, build_log=log)
    if args.update_baseline:
        if not args.baseline:
            ap.error("--update-baseline requires --baseline")
        write_baseline(args.baseline, findings)
        print(f"devicecheck: baseline written ({len(findings)} findings)")
        return 0
    baseline = load_baseline(args.baseline) if args.baseline else {}
    new, stale = gate(findings, baseline)
    for f in new:
        print(f.render())
    for path, rule, allowed, now in stale:
        print(f"devicecheck: note: baseline for {path} {rule} is {allowed}, "
              f"tree has {now} — ratchet it down", file=sys.stderr)
    n = len(_registry().ENTRY_POINTS) + 2
    if new:
        print(f"devicecheck: {len(new)} unbaselined finding(s) over {n} "
              f"entries ({len(findings)} total)", file=sys.stderr)
        return 1
    print(f"devicecheck: clean over {n} entries"
          + (" on the card" if args.cuda else "")
          + (f" ({len(findings)} finding(s), all baselined)"
             if findings else ""))
    return 0
