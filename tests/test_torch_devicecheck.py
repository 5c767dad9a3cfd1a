"""The port's device-plane auditor (``analysis/devicecheck.py``).

Each rule catches a seeded violation: an entry returning ``int64``
(``dtype``), a donated leaf returned in fresh storage (``donation``), an
internal-layout leaf with G not last (``g-last``), a ``.cpu()`` in a
scratch copy of ``ops/kernel.py`` (``transfer``, the static half), an
unregistered ``__global__`` in a scratch copy of ``csrc/``
(``unregistered-kernel``), and a stack frame in a ptxas report or a
registered ``__global__`` missing from it (``spill``).  Then the real registry, its 19 entries and the two mesh
entries on a CPU mesh, audits clean against ``device_baseline.txt``.
The card's halves (the sync-debug transfer check, the build's ptxas
report) run in ``chip_smoke.py``'s analysis phase.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch.analysis import devicecheck as D
from dragonboat_tpu_torch.analysis.raftlint import gate, load_baseline
from dragonboat_tpu_torch.ops import registry as REG

ROOT = Path(__file__).resolve().parent.parent
G = REG.CANON["G"]


def _entry(name, fn, build, **kw):
    return REG.EntryPoint(name, fn, fn, build, (), lambda seed: build(),
                          **kw)


def _b_pair():
    return (np.arange(G, dtype=np.int32), np.ones((G, 3), np.int32)), {}


def test_dtype_catches_an_int64_output():
    ep = _entry("x.widen", lambda a, b: (a.to(torch.int64), b), _b_pair)
    fs = D.check_dtype(ep)
    assert {f.rule for f in fs} == {"dtype"}
    assert len(fs) == 2 and all("int64" in f.message for f in fs), fs
    assert all(f.path == "x.widen" for f in fs)
    ok = _entry("x.same", lambda a, b: (a, b), _b_pair)
    assert D.check_dtype(ok) == []


def test_dtype_catches_a_float_input():
    def build():
        return (np.zeros((G,), np.float32), np.ones((G, 3), np.int32)), {}

    fs = D.check_dtype(_entry("x.float_in", lambda a, b: b, build))
    assert len(fs) == 2 and all("input leaf 0" in f.message for f in fs)


def test_donation_catches_a_fresh_allocation():
    def in_place(a, b):
        b.add_(1)
        return a.sum(), b

    def fresh(a, b):
        return a.sum(), b + 1

    ok = _entry("x.in_place", in_place, _b_pair, donate=(1,))
    assert D.check_donation(ok) == []
    bad = _entry("x.fresh", fresh, _b_pair, donate=(1,))
    fs = D.check_donation(bad)
    assert [f.rule for f in fs] == ["donation"]
    assert "0/1" in fs[0].message
    # a donated operand with no shape-matched output is no finding
    # (donation for early free, as the reference's assemble_and_step)
    none = _entry("x.no_match", lambda a, b: a.sum(), _b_pair, donate=(1,))
    assert D.check_donation(none) == []


def test_donation_counts_each_donated_leaf_once():
    """Two donated leaves of one shape are two buffers: returning the
    first twice aliases one of them, not two."""
    def pair_build():
        return ((np.zeros((G,), np.int32), np.zeros((G,), np.int32)), {})

    ep = _entry("x.twice", lambda a, b: (a, a), pair_build, donate=(0, 1))
    fs = D.check_donation(ep)
    assert len(fs) == 1 and "1/2" in fs[0].message
    assert D.check_donation(
        _entry("x.split", lambda a, b: (a, b), pair_build,
               donate=(0, 1))) == []


def test_g_last_catches_a_g_major_leaf():
    def build():
        return (np.zeros((3, G), np.int32), np.zeros((5, G), np.int32)), {}

    good = _entry("x.glast", lambda s, i: (s + 1, i), build, g_last=True)
    assert D.check_g_last(good) == []
    bad = _entry("x.gmajor", lambda s, i: (s.t().contiguous(), i), build,
                 g_last=True)
    fs = D.check_g_last(bad)
    assert [f.rule for f in fs] == ["g-last"] and "(64, 3)" in fs[0].message
    # not declared: not checked
    assert D.check_g_last(bad._replace(g_last=False)) == []


def test_transfer_static_catches_a_seeded_sync(tmp_path):
    pkg = tmp_path / "dragonboat_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    for rel in D.TRANSFER_MODULES:
        shutil.copy(ROOT / "dragonboat_tpu_torch" / rel, pkg / rel)
    assert D.check_transfer_static(pkg) == []
    k = pkg / "ops" / "kernel.py"
    src = k.read_text()
    needle = "    return new, out\n"
    assert needle in src
    k.write_text(src.replace(needle,
                             "    junk = new.term.cpu()\n" + needle, 1))
    fs = D.check_transfer_static(pkg)
    assert [f.rule for f in fs] == ["transfer"]
    assert fs[0].path == "dragonboat_tpu_torch/ops/kernel.py"


def test_unregistered_kernel_in_a_scratch_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(REG.CSRC, csrc)
    assert D.check_unregistered(csrc) == []
    (csrc / "rogue.cu").write_text(
        '#include "common.cuh"\n'
        "__global__ void rogue_kernel(int* x) { x[0] = 1; }\n")
    fs = D.check_unregistered(csrc)
    assert [f.rule for f in fs] == ["unregistered-kernel"]
    assert "rogue_kernel" in fs[0].message


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z16route_walk_kernelPKiS0_' for 'sm_90a'
ptxas info    : Function properties for _Z16route_walk_kernelPKiS0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, 4096 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15raft_step_kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z15raft_step_kernelILi128EEvv
    24 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""


GLOBALS = sorted({g for gs in REG.GLOBALS.values() for g in gs})


def _clean_entry(name):
    m = f"_Z{len(name)}{name}Pi"
    return (f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {m}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n"
            "ptxas info    : Used 40 registers, 400 bytes cmem[0]\n")


# a report naming every registered __global__, raft_step_kernel spilling
FULL_LOG = PTXAS_LOG + "".join(
    _clean_entry(g) for g in GLOBALS
    if g not in ("route_walk_kernel", "raft_step_kernel"))


def test_spill_catches_a_stack_frame():
    rows = D.ptxas_table(PTXAS_LOG)
    assert [r["kernel"] for r in rows] == ["route_walk_kernel",
                                           "raft_step_kernel"]
    assert rows[0] == dict(kernel="route_walk_kernel",
                           mangled="_Z16route_walk_kernelPKiS0_", regs=63,
                           stack=0, spill_stores=0, spill_loads=0,
                           static_smem=4096)
    fs = D.check_spill(FULL_LOG)
    assert [(f.path, f.rule) for f in fs] == [("raft_step_kernel", "spill")]
    assert "24 bytes stack" in fs[0].message
    assert "8 bytes spill stores" in fs[0].message
    spilling = PTXAS_LOG[PTXAS_LOG.index("ptxas info    : Compiling entry "
                                         "function '_Z15"):]
    assert D.check_spill(FULL_LOG.replace(
        spilling, _clean_entry("raft_step_kernel"))) == []


def test_spill_report_without_a_kernel_is_a_finding():
    """An empty report (a build that compiled nothing) checks nothing,
    so every registered ``__global__`` is a finding; a report missing
    one names that one."""
    fs = D.check_spill("")
    assert [f.path for f in fs] == GLOBALS
    assert {f.rule for f in fs} == {"spill"}
    assert all("no entry" in f.message for f in fs)
    clean = "".join(_clean_entry(g) for g in GLOBALS)
    assert D.check_spill(clean) == []
    fs = D.check_spill(clean.replace(_clean_entry("inbox_fill_kernel"), ""))
    assert [f.path for f in fs] == ["inbox_fill_kernel"]


def _ninja_log(*compiled):
    """A verbose ninja build's output: each compiled source's command
    line, then its ptxas report; the link line last."""
    out = []
    for k, (src, report) in enumerate(compiled, 1):
        out.append(f"[{k}/{len(compiled) + 1}] /usr/local/cuda/bin/nvcc "
                   f"--generate-dependencies-with-compile --dependency-output "
                   f"{src}.o.d -DTORCH_EXTENSION_NAME=m -c /x/csrc/{src} "
                   f"-o {src}.o -O3 -Xptxas=-v\n{report}")
    n = len(compiled) + 1
    out.append(f"[{n}/{n}] c++ a.o -shared -o m.so\n")
    return "".join(out)


def test_native_keeps_each_sources_report(tmp_path, monkeypatch):
    """The ptxas report outlives the build that wrote it: a later load
    that recompiles one source replaces that source's part only, and one
    that compiles nothing leaves the report whole."""
    from dragonboat_tpu_torch.ops import _native

    monkeypatch.setattr(_native, "BUILD", tmp_path)
    route = _clean_entry("route_walk_kernel")
    step = _clean_entry("raft_step_kernel")
    first = _ninja_log(("route.cu", route), ("raft_step.cu", step))
    assert _native.compiled_sections(first) == {"route.cu": route,
                                                "raft_step.cu": step}
    _native._keep_sections(first)
    assert _native.build_log() == step + route  # in KERNELS' source order
    spilled = route.replace("0 bytes stack frame", "16 bytes stack frame")
    _native._keep_sections(_ninja_log(("route.cu", spilled)))
    assert _native.build_log() == step + spilled
    _native._keep_sections("ninja: no work to do.\n")
    assert [r["kernel"] for r in D.ptxas_table(_native.build_log())] == [
        "raft_step_kernel", "route_walk_kernel"]
    assert [f.path for f in D.check_spill(_native.build_log())
            if "stack" in f.message] == ["route_walk_kernel"]


def test_registry_declarations_are_the_references():
    """``donate`` and ``g_last`` value for value (the reference's
    ``ops/registry.py`` ENTRY_POINTS)."""
    from dragonboat_tpu.ops import registry as ref

    want = {ep.name: (ep.donate, ep.g_last) for ep in ref.ENTRY_POINTS}
    got = {ep.name: (ep.donate, ep.g_last) for ep in REG.ENTRY_POINTS}
    assert got == want


def test_real_registry_audits_clean_against_the_baseline():
    findings = D.audit()
    new, _stale = gate(findings, load_baseline(str(D.BASELINE)))
    assert new == [], "\n".join(f.render() for f in new)


def test_cli_device_gate():
    res = subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.analysis", "--device",
         "--baseline", str(D.BASELINE)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "devicecheck: clean over 21 entries" in res.stdout


def test_cuda_audit_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs this half")
    with pytest.raises(RuntimeError):
        D.audit(cuda=True)
