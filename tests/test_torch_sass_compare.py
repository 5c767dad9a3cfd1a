"""``ops/sass_compare.py``: parsing of ``cuobjdump`` output and matching.

The tool compiles a kernel source of two trees with ``nvcc`` and holds
their machine code against each other; ``nvcc`` and ``cuobjdump`` run
only where the CUDA toolkit is.  Here their output is given as text
(the layout ``cuobjdump -sass`` / ``-res-usage`` print for ``sm_90a``),
so the parsing, the word-for-word match and the diff are checked
without the toolkit.
"""
from __future__ import annotations

from pathlib import Path

import pytest

from dragonboat_tpu_torch.ops import sass_compare as S

OLD = "_Z16raft_step_kernelN3dbt8StepArgsE"
EXT = "_Z16raft_step_kernelILb0EEvN3dbt8StepArgsE"
GL = "_Z16raft_step_kernelILb1EEvN3dbt8StepArgsE"


def _insn(addr: int, text: str, enc: str, ctrl: str) -> str:
    return (f"        /*{addr:04x}*/                   {text} ;"
            f"                 /* {enc} */\n"
            f"                                                      "
            f"/* {ctrl} */\n")


def _function(name: str, body) -> str:
    out = (f"\t\tFunction : {name}\n"
           '\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_SM90"\n')
    for i, (text, enc, ctrl) in enumerate(body):
        out += _insn(16 * i, text, enc, ctrl)
    return out + "\t\t..........\n\n"


BODY = [
    ("LDC R1, c[0x0][0x28]", "0x00000a00ff017b82", "0x000fe40000000800"),
    ("@P0 EXIT", "0x000000000000094d", "0x000fea0003800000"),
    ("STG.E desc[UR4][R2.64], R5", "0x0000000502007986", "0x000fe2000c101904"),
]
# the same instructions, one scheduling word different
BODY_CTRL = [BODY[0], BODY[1],
             (BODY[2][0], BODY[2][1], "0x000fe4000c101904")]
BODY_OTHER = [BODY[0], ("MOV R5, 0x1", "0x0000000100057802",
                        "0x000fe20000000f00"), BODY[2]]


def _res(items) -> str:
    return "".join(
        f"Resource usage:\n Common:\n  GLOBAL:0\n Function {n}:\n"
        f"  REG:{r} STACK:{s} SHARED:0 LOCAL:0 CONSTANT[0]:1200\n"
        for n, r, s in items)


def _fake_tools(monkeypatch, listings):
    """``cuobjdump`` prints the listing of whichever cubin it is given;
    ``nvcc`` writes the tree's name into the cubin."""
    class Done:
        def __init__(self, stdout=""):
            self.stdout = stdout

    real_run = S.subprocess.run

    def run(cmd, **kw):
        if cmd[0].endswith("nvcc"):
            Path(cmd[cmd.index("-o") + 1]).write_text(
                Path(cmd[-1]).parent.name)
            return Done()
        if cmd[0].endswith("cuobjdump"):
            sass, res = listings[Path(cmd[-1]).read_text()]
            return Done(sass if cmd[1] == "-sass" else res)
        return real_run(cmd, **kw)

    monkeypatch.setattr(S.subprocess, "run", run)


def test_kernels_parses_instructions_encodings_and_resources(
        monkeypatch, tmp_path):
    cubin = tmp_path / "k.cubin"
    cubin.write_text("t")
    listing = _function(OLD, BODY) + _function(GL, BODY_OTHER)
    _fake_tools(monkeypatch, {"t": (
        listing, _res([(OLD, 78, 64), (GL, 48, 384)]))})
    k = S.kernels(cubin)
    assert list(k) == [OLD, GL]
    assert k[OLD]["sass"] == [b[0] for b in BODY]
    assert k[OLD]["code"] == [f"{b[1]} {b[2]}" for b in BODY]
    assert (k[OLD]["regs"], k[OLD]["stack"]) == (78, 64)
    assert (k[GL]["regs"], k[GL]["stack"]) == (48, 384)


@pytest.mark.parametrize("mangled,base", [
    (OLD, "raft_step_kernel"),
    (EXT, "raft_step_kernel"),
    ("_Z18xlane_write_kernelN3dbt9XPackArgsE", "xlane_write_kernel"),
    ("plain_name", "plain_name"),
])
def test_base_name(mangled, base):
    assert S.base_name(mangled) == base


@pytest.mark.parametrize("ext_body,identical", [
    (BODY, True),
    (BODY_CTRL, False),   # a scheduling word differs: not the same code
    (BODY_OTHER, False),
])
def test_compare_matches_word_for_word_across_names(
        monkeypatch, tmp_path, ext_body, identical):
    here, other = tmp_path / "here", tmp_path / "other"
    for d in (here, other):
        d.mkdir()
        (d / "raft_step.cu").write_text("")
    monkeypatch.setattr(S._native, "CSRC", here)
    _fake_tools(monkeypatch, {
        "here": (_function(EXT, ext_body) + _function(GL, BODY_OTHER),
                 _res([(EXT, 78, 64), (GL, 48, 384)])),
        "other": (_function(OLD, BODY), _res([(OLD, 78, 64)])),
    })
    diff_dir = tmp_path / "diffs"
    r = S.compare(other, "raft_step.cu", diff_dir)
    assert r["other_kernels"][OLD] == dict(instructions=3, regs=78, stack=64)
    ext = r["kernels"][EXT]
    assert ext["identical_to"] == ([OLD] if identical else [])
    assert r["kernels"][GL]["identical_to"] == []
    # a kernel with no identical counterpart gets a diff against every
    # kernel of its base name; the GL body differs in one instruction
    assert r["kernels"][GL]["diff_lines"] == {OLD: 2}
    assert (diff_dir / f"{GL}__vs__{OLD}.diff").exists()
    if identical:
        assert "diff_lines" not in ext
    elif ext_body is BODY_CTRL:
        # the instruction text is the same: the diff has no changed line
        assert ext["diff_lines"] == {OLD: 0}


def test_memory_ops_counts_loads_and_stores_by_kind():
    sass = ["LDS.U R1, [R2]", "@P0 STG.E [R2.64], R3", "IMAD R1, R2, R3",
            "@!P1 LDGSTS.E [R1], [R2.64]", "LD.E R1, [R2.64]",
            "STS.128 [R1], R4", "LDL R1, [R1]"]
    n = S.memory_ops(sass)
    assert {k: v for k, v in n.items() if v} == dict(
        LDS=1, STG=1, LDGSTS=1, LD=1, STS=1, LDL=1)
