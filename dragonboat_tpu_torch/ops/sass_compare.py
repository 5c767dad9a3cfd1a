"""Compare the machine code of one kernel source between two trees.

    python3 -m dragonboat_tpu_torch.ops.sass_compare OTHER_CSRC \\
        [--source raft_step.cu] [--other-source NAME] [--diff-dir DIR]

compiles ``csrc/<source>`` of this package and ``<other-source>``
(default: the same name) of ``OTHER_CSRC`` (for
example the ``csrc`` of an earlier commit unpacked with ``git
archive``) to a cubin with ``nvcc`` (the extension build's flags,
``_native.CUDA_FLAGS``, in C++17 as the build compiles), disassembles
both with ``cuobjdump -sass`` and prints one JSON object: for every
kernel of either tree its SASS instruction count, registers and stack
bytes (``cuobjdump -res-usage``) and its loads and stores by kind, and
for each kernel of this tree the kernels of the other tree whose
machine code is the same, word for word
(each instruction's encoding and its scheduling word; the kernel's name
is not part of it, so a renamed kernel still matches).  Kernels of the
same base name that differ get a unified diff of their instructions in
``--diff-dir``.
Needs the CUDA toolkit; runs no kernel.
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import tempfile
from pathlib import Path

from . import _native

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;\s*/\* (0x[0-9a-f]+) \*/")
_CTRL = re.compile(r"^\s*/\* (0x[0-9a-f]+) \*/\s*$")
_RES = re.compile(r"Function (\S+):\s*REG:(\d+)\s+STACK:(\d+)")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = Path(home) / "bin" / "nvcc"
    return str(exe) if exe.exists() else "nvcc"


def _tool(name: str) -> str:
    return str(Path(_nvcc()).with_name(name)) if "/" in _nvcc() else name


def compile_cubin(csrc: Path, source: str, out: Path) -> None:
    subprocess.run(
        [_nvcc(), "-std=c++17", *_native.CUDA_FLAGS, "-cubin",
         "-I", str(csrc), "-o", str(out), str(csrc / source)],
        check=True, capture_output=True, text=True)


def kernels(cubin: Path) -> dict:
    """kernel name -> {"sass": [instruction, ...], "code": [its two
    encoding words, ...], "regs", "stack"}"""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    found: dict = {}
    name = None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            found[name] = {"sass": [], "code": []}
            continue
        if name is None:
            continue
        m = _INSN.match(line)
        if m:
            found[name]["sass"].append(m.group(1))
            found[name]["code"].append(m.group(2))
            continue
        m = _CTRL.match(line)
        if m and found[name]["code"]:
            found[name]["code"][-1] += " " + m.group(1)
    res = subprocess.run([_tool("cuobjdump"), "-res-usage", str(cubin)],
                         check=True, capture_output=True, text=True).stdout
    for m in _RES.finditer(res):
        if m.group(1) in found:
            found[m.group(1)].update(regs=int(m.group(2)),
                                     stack=int(m.group(3)))
    return found


_MEM_OPS = ("LDS", "STS", "LDG", "STG", "LD", "ST", "LDL", "STL", "LDGSTS",
            "LDC")


def memory_ops(sass: list) -> dict:
    """How many of a kernel's instructions are each kind of load and
    store (LDS/STS shared, LDG/STG global, LD/ST generic, LDL/STL the
    stack, LDGSTS cp.async, LDC constants)."""
    n = dict.fromkeys(_MEM_OPS, 0)
    for ins in sass:
        op = ins.split()
        op = op[1] if op and op[0].startswith("@") and len(op) > 1 else (
            op[0] if op else "")
        op = op.split(".")[0]
        if op in n:
            n[op] += 1
    return n


def base_name(mangled: str) -> str:
    """``_Z16raft_step_kernel...`` -> ``raft_step_kernel``"""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def _diff(a: list, b: list, name_a: str, name_b: str) -> list:
    """Unified diff of two instruction lists: GNU diff where there is
    one (linear in practice), else difflib."""
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = Path(tmp) / "a", Path(tmp) / "b"
        fa.write_text("\n".join(a) + "\n")
        fb.write_text("\n".join(b) + "\n")
        try:
            out = subprocess.run(
                ["diff", "-U2", "--label", name_a, "--label", name_b,
                 str(fa), str(fb)], capture_output=True, text=True).stdout
            return out.splitlines()
        except FileNotFoundError:
            return list(difflib.unified_diff(a, b, name_a, name_b,
                                             lineterm="", n=2))


def compare(other_csrc: Path, source: str, diff_dir=None,
            other_source: str = "") -> dict:
    other_source = other_source or source
    with tempfile.TemporaryDirectory() as tmp:
        here, there = Path(tmp) / "here.cubin", Path(tmp) / "other.cubin"
        compile_cubin(_native.CSRC, source, here)
        compile_cubin(other_csrc, other_source, there)
        mine, theirs = kernels(here), kernels(there)
    report = {"source": source, "other_source": other_source,
              "flags": list(_native.CUDA_FLAGS),
              "kernels": {}, "other_kernels": {}, "memory_ops": {},
              "other_memory_ops": {}}
    for name, k in theirs.items():
        report["other_kernels"][name] = dict(
            instructions=len(k["sass"]), regs=k.get("regs"),
            stack=k.get("stack"))
        report["other_memory_ops"][name] = memory_ops(k["sass"])
    for name, k in mine.items():
        same = [o for o, ko in theirs.items() if ko["code"] == k["code"]]
        report["kernels"][name] = dict(
            instructions=len(k["sass"]), regs=k.get("regs"),
            stack=k.get("stack"), identical_to=same)
        report["memory_ops"][name] = memory_ops(k["sass"])
        if same or diff_dir is None:
            continue
        for o, ko in theirs.items():
            if base_name(o) != base_name(name):
                continue
            diff = _diff(ko["sass"], k["sass"], o, name)
            Path(diff_dir).mkdir(parents=True, exist_ok=True)
            (Path(diff_dir) / f"{name}__vs__{o}.diff").write_text(
                "\n".join(diff) + "\n")
            report["kernels"][name].setdefault("diff_lines", {})[o] = sum(
                1 for d in diff if d[:1] in "+-"
                and not d.startswith(("+++", "---")))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--source", default="raft_step.cu")
    ap.add_argument("--other-source", default="")
    ap.add_argument("--diff-dir", default=None)
    args = ap.parse_args(argv)
    print(json.dumps(compare(args.other_csrc, args.source, args.diff_dir,
                             args.other_source)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
