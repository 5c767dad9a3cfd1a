"""wirecheck — the wire-plane compat auditor (docs/ANALYSIS.md).

Four checks over the codec registry (``analysis/wire_registry.py``),
following the raftlint/jaxcheck discipline (per-(path,rule) findings,
baseline ratchet, ``python -m dragonboat_tpu.analysis --wire``):

``golden-drift`` / ``golden-missing``
    The checked-in byte corpus (``tests/wire_goldens/``) must equal the
    registry's canonical sample bytes for every codec x layout.  Any
    accidental layout change is a red gate NAMING the frame; deliberate
    changes regenerate the corpus via ``--update-goldens`` (and show up
    in the diff as golden-file churn, which review can then interrogate
    as a compat break).

``skew-matrix``
    The CURRENT decoder must read every stored golden (old bytes keep
    decoding), must REJECT a future-layout frame with the codec's own
    narrow error type (never a silent field shift), and flag-gated
    extensions (trace byte, stats read-path trailer, empty obs query)
    must decode as v0 when unstamped — the registry's ``checks``.

``fuzz-escape`` / ``fuzz-alloc``
    A seeded structure-aware mutator (truncation, bit flips,
    length-field inflation, 32-bit field corruption, version bumps,
    byte insert/delete) drives N mutations per registered decoder.
    Every escape must be the codec's narrow error type — no bare
    struct.error, KeyError or MemoryError surfacing to the transport
    loop — and per-decode allocation must stay bounded (tracemalloc
    peak <= a proportional allowance + the entry's declared slack),
    which is what catches decompression bombs.

``unregistered-codec`` / ``decode-bound``
    AST rot guards: any ``encode_*``/``decode_*`` def or
    ``KIND_*``/``K_*``/``*_BIN_VER``/``*_VERSION`` constant in a
    covered module that no registry entry claims is a finding (the
    jaxcheck unregistered-jit discipline), and every registered
    decoder's source must bound its length-prefixed reads — parse
    through the bounded ``_R`` reader, reference an explicit ``MAX_*``
    cap or a ``len()`` guard, and never call bare ``zlib.decompress``.
"""
from __future__ import annotations

import argparse
import ast
import os
import random
import re
import struct
import sys
import tracemalloc
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import wire_registry
from .raftlint import Finding, gate, load_baseline, write_baseline
from .wire_registry import REGISTRY, SCAN_MODULES, CodecEntry

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
GOLDENS_DIR = os.path.join(REPO_ROOT, "tests", "wire_goldens")
GOLDENS_REL = "tests/wire_goldens"

FUZZ_SEED = 0xD1A60  # deterministic: same corpus -> same verdict
DEFAULT_FUZZ_N = 500

# names the rot guard treats as codec surface when defined in a scanned
# module (assignment targets for constants, def names for functions)
_FN_PAT = re.compile(r"^(encode|decode)_[A-Za-z0-9_]+$")
_CONST_PAT = re.compile(
    r"(^KIND_[A-Z0-9_]+$|^K_[A-Z][A-Z0-9_]*$|_BIN_VER$|_VERSION$|^VERSION$)"
)

# decode-bound: calls that read attacker-sized data, and the bound
# references that license them
_RAW_READ_ATTRS = {"take", "read", "unpack", "unpack_from", "from_bytes",
                   "decompress", "ljust", "zfill"}
_BOUND_HINT = re.compile(r"MAX|_MAX|BOUND")


def golden_name(entry_name: str, label: str) -> str:
    return f"{entry_name}__{label}.bin"


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------
def check_goldens(
    entries: Sequence[CodecEntry],
    goldens_dir: str,
    update: bool = False,
) -> List[Finding]:
    findings: List[Finding] = []
    if update:
        os.makedirs(goldens_dir, exist_ok=True)
    for e in entries:
        for label, builder in e.samples.items():
            built = builder()
            fname = golden_name(e.name, label)
            path = os.path.join(goldens_dir, fname)
            rel = f"{GOLDENS_REL}/{fname}"
            if update:
                with open(path, "wb") as f:
                    f.write(built)
                continue
            if not os.path.exists(path):
                findings.append(Finding(
                    rel, 1, "golden-missing",
                    f"codec {e.name} layout {label} has no golden "
                    f"(regenerate via --update-goldens)",
                ))
                continue
            with open(path, "rb") as f:
                stored = f.read()
            if stored != built:
                findings.append(Finding(
                    rel, 1, "golden-drift",
                    f"codec {e.name} layout {label}: encoder output no "
                    f"longer matches the checked-in golden "
                    f"({len(built)}B built vs {len(stored)}B stored) — "
                    f"a wire-layout change; if deliberate, regenerate "
                    f"via --update-goldens and call it out as a compat "
                    f"break",
                ))
    return findings


def _golden_bytes(e: CodecEntry, label: str, goldens_dir: str) -> bytes:
    """The stored golden when present (the corpus is the source of
    truth), else the builder output (first run / --update-goldens)."""
    path = os.path.join(goldens_dir, golden_name(e.name, label))
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    return e.samples[label]()


# ---------------------------------------------------------------------------
# skew matrix
# ---------------------------------------------------------------------------
def check_skew(
    entries: Sequence[CodecEntry], goldens_dir: str
) -> List[Finding]:
    findings: List[Finding] = []
    for e in entries:
        # old-bytes-decode: every stored layout must still decode
        for label in e.samples:
            data = _golden_bytes(e, label, goldens_dir)
            try:
                out = e.decode(data)
            except Exception as ex:  # noqa: BLE001 - audit boundary
                findings.append(Finding(
                    e.module, 1, "skew-matrix",
                    f"codec {e.name}: current decoder failed on the "
                    f"{label} golden: {type(ex).__name__}: {ex}",
                ))
                continue
            if e.none_on_error and out is None:
                findings.append(Finding(
                    e.module, 1, "skew-matrix",
                    f"codec {e.name}: decoder returned None for the "
                    f"well-formed {label} golden",
                ))
        # future-version-reject: the narrow type, never a field shift
        if e.future is not None:
            data = e.future()
            try:
                out = e.decode(data)
            except Exception as ex:  # noqa: BLE001 - audit boundary
                if not isinstance(ex, e.errors):
                    findings.append(Finding(
                        e.module, 1, "skew-matrix",
                        f"codec {e.name}: future-layout frame raised "
                        f"{type(ex).__name__} instead of the codec's "
                        f"narrow error type",
                    ))
            else:
                if not (e.none_on_error and out is None):
                    findings.append(Finding(
                        e.module, 1, "skew-matrix",
                        f"codec {e.name}: future-layout frame DECODED "
                        f"instead of being rejected — silent field "
                        f"shift hazard",
                    ))
        # flag-gated extension invariants
        for check in e.checks:
            msg = check()
            if msg:
                findings.append(Finding(
                    e.module, 1, "skew-matrix", f"codec {e.name}: {msg}"
                ))
    return findings


# ---------------------------------------------------------------------------
# deterministic structure-aware fuzz
# ---------------------------------------------------------------------------
def _mutate(rng: random.Random, base: bytes) -> bytes:
    b = bytearray(base)
    op = rng.randrange(6)
    if op == 0 and b:  # truncation
        return bytes(b[: rng.randrange(len(b))])
    if op == 1 and b:  # bit flip
        i = rng.randrange(len(b))
        b[i] ^= 1 << rng.randrange(8)
        return bytes(b)
    if op == 2 and len(b) >= 4:  # length-field inflation
        i = rng.randrange(len(b) - 3)
        struct.pack_into(
            "<I", b, i, rng.choice((0xFFFFFFFF, 0x7FFFFFFF, 1 << 24))
        )
        return bytes(b)
    if op == 3 and len(b) >= 4:  # 32-bit field corruption (crc, counts)
        i = rng.randrange(len(b) - 3)
        struct.pack_into("<I", b, i, rng.getrandbits(32))
        return bytes(b)
    if op == 4 and len(b) >= 4:  # version bump at the frame head
        struct.pack_into("<I", b, 0, rng.randrange(2, 1 << 16))
        return bytes(b)
    # byte insert/delete (framing shift)
    i = rng.randrange(len(b) + 1)
    if rng.random() < 0.5 and b:
        del b[min(i, len(b) - 1)]
    else:
        b.insert(i, rng.getrandbits(8))
    return bytes(b)


def check_fuzz(
    entries: Sequence[CodecEntry],
    goldens_dir: str,
    n: int = DEFAULT_FUZZ_N,
) -> List[Finding]:
    """N seeded mutations per registered decoder.  Verdicts:

    * decode succeeds, raises one of ``entry.errors``, or (for
      none_on_error codecs) returns None — fine;
    * anything else escapes -> ``fuzz-escape`` naming the exception;
    * tracemalloc peak past the proportional allowance + declared
      slack -> ``fuzz-alloc`` (decompression-bomb class).
    """
    if n <= 0:
        return []
    findings: List[Finding] = []
    started_tracing = not tracemalloc.is_tracing()
    if started_tracing:
        tracemalloc.start()
    try:
        for e in entries:
            # crc32, not hash(): str hashing is process-salted and would
            # break run-to-run fuzz determinism
            rng = random.Random(FUZZ_SEED ^ zlib.crc32(e.name.encode()))
            bases = [
                _golden_bytes(e, label, goldens_dir) for label in e.samples
            ]
            bad_escape = bad_alloc = None
            for i in range(n):
                data = _mutate(rng, bases[i % len(bases)])
                allowed = e.alloc_slack + 64 * len(data) + (1 << 20)
                tracemalloc.reset_peak()
                try:
                    e.decode(data)
                except e.errors:
                    pass
                except Exception as ex:  # noqa: BLE001 - audit boundary
                    if bad_escape is None:
                        bad_escape = (i, ex)
                _, peak = tracemalloc.get_traced_memory()
                if peak > allowed and bad_alloc is None:
                    bad_alloc = (i, peak, allowed)
            if bad_escape is not None:
                i, ex = bad_escape
                t = type(ex)
                tname = t.__name__
                if t.__module__ not in ("builtins", "exceptions"):
                    tname = f"{t.__module__}.{tname}"  # e.g. struct.error
                findings.append(Finding(
                    e.module, 1, "fuzz-escape",
                    f"codec {e.name}: mutation #{i} escaped the narrow "
                    f"error contract with {tname}: {ex}",
                ))
            if bad_alloc is not None:
                i, peak, allowed = bad_alloc
                findings.append(Finding(
                    e.module, 1, "fuzz-alloc",
                    f"codec {e.name}: mutation #{i} allocated {peak}B "
                    f"(allowed {allowed}B) — unbounded decode "
                    f"allocation",
                ))
    finally:
        if started_tracing:
            tracemalloc.stop()
    return findings


# ---------------------------------------------------------------------------
# rot guards (AST)
# ---------------------------------------------------------------------------
def scan_module_source(
    source: str, relpath: str, claimed: Iterable[str]
) -> List[Finding]:
    """Flag codec-surface names in `source` the registry doesn't claim:
    top-level ``encode_*``/``decode_*`` defs and
    ``KIND_*``/``K_*``/``*_BIN_VER``/``*_VERSION`` constants."""
    claimed = set(claimed)
    findings: List[Finding] = []
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(relpath, e.lineno or 1, "unregistered-codec",
                        f"unparseable module: {e.msg}")]
    for node in tree.body:
        names: List[Tuple[str, int]] = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _FN_PAT.match(node.name):
                names.append((node.name, node.lineno))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and _CONST_PAT.search(t.id):
                    names.append((t.id, node.lineno))
        elif isinstance(node, ast.AnnAssign):
            t = node.target
            if isinstance(t, ast.Name) and _CONST_PAT.search(t.id):
                names.append((t.id, node.lineno))
        for name, lineno in names:
            if name not in claimed:
                findings.append(Finding(
                    relpath, lineno, "unregistered-codec",
                    f"codec surface `{name}` has no wire_registry entry "
                    f"(register it with samples + a narrow error "
                    f"contract, or claim it from an existing entry)",
                ))
    return findings


def check_registry_complete(root: str = REPO_ROOT) -> List[Finding]:
    findings: List[Finding] = []
    for rel in SCAN_MODULES:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            findings.append(Finding(
                rel, 1, "unregistered-codec",
                "scanned module vanished — update wire_registry."
                "SCAN_MODULES",
            ))
            continue
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        findings.extend(
            scan_module_source(source, rel, wire_registry.claimed_names(rel))
        )
    return findings


def _find_function(tree: ast.Module, qualname: str) -> Optional[ast.AST]:
    parts = qualname.split(".")
    body = tree.body
    node: Optional[ast.AST] = None
    for part in parts:
        node = None
        for n in body:
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ) and n.name == part:
                node = n
                break
        if node is None:
            return None
        body = getattr(node, "body", [])
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return node
    return None


def check_decode_bounds_source(
    source: str, relpath: str, fn_names: Sequence[str]
) -> List[Finding]:
    """The decode-bound rule over one module's source (testable on
    fixture strings).  A registered decoder passes when its body either
    parses through the bounded ``_R`` reader, references an explicit
    ``MAX``/``BOUND`` cap, guards with ``len()``, or performs no raw
    length-prefixed reads at all.  Bare ``zlib.decompress`` always
    fails (use ``bounded_decompress`` / a capped decompressobj)."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(relpath, e.lineno or 1, "decode-bound",
                        f"unparseable module: {e.msg}")]
    for qualname in fn_names:
        fn = _find_function(tree, qualname)
        if fn is None:
            findings.append(Finding(
                relpath, 1, "decode-bound",
                f"registered decoder `{qualname}` not found "
                f"(update wire_registry bound_fns)",
            ))
            continue
        has_bound = False
        raw_read_line = None
        bare_zlib_line = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Name):
                if _BOUND_HINT.search(node.id) or node.id == "_R":
                    has_bound = True
            elif isinstance(node, ast.Attribute):
                if _BOUND_HINT.search(node.attr):
                    has_bound = True
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name):
                    if f.id in ("len", "bounded_decompress"):
                        has_bound = True
                elif isinstance(f, ast.Attribute):
                    if f.attr == "bounded_decompress":
                        has_bound = True
                    if (
                        f.attr == "decompress"
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "zlib"
                    ):
                        bare_zlib_line = node.lineno
                    elif f.attr in _RAW_READ_ATTRS and node.args:
                        raw_read_line = raw_read_line or node.lineno
        if bare_zlib_line is not None:
            findings.append(Finding(
                relpath, bare_zlib_line, "decode-bound",
                f"decoder `{qualname}` calls bare zlib.decompress — "
                f"unbounded allocation on a crafted stream; use "
                f"bounded_decompress / a capped decompressobj",
            ))
        if raw_read_line is not None and not has_bound:
            findings.append(Finding(
                relpath, raw_read_line, "decode-bound",
                f"decoder `{qualname}` performs length-prefixed reads "
                f"with no explicit cap (no _R reader, MAX_* bound or "
                f"len() guard in scope)",
            ))
    return findings


def check_decode_bounds(
    entries: Sequence[CodecEntry], root: str = REPO_ROOT
) -> List[Finding]:
    by_module: Dict[str, List[str]] = {}
    for e in entries:
        if e.bound_fns:
            by_module.setdefault(e.module, []).extend(e.bound_fns)
    findings: List[Finding] = []
    for rel, fns in sorted(by_module.items()):
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            findings.append(Finding(rel, 1, "decode-bound",
                                    "registered module vanished"))
            continue
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        findings.extend(
            check_decode_bounds_source(source, rel, sorted(set(fns)))
        )
    return findings


# ---------------------------------------------------------------------------
# audit + CLI
# ---------------------------------------------------------------------------
def audit(
    names: Optional[Sequence[str]] = None,
    goldens_dir: Optional[str] = None,
    fuzz_n: int = DEFAULT_FUZZ_N,
    update_goldens: bool = False,
) -> List[Finding]:
    """Run the four checks; `names` narrows to specific codec entries
    (the whole-tree rot guards only run on a FULL audit, mirroring
    jaxcheck's registry-completeness rule)."""
    entries = [
        e for e in REGISTRY if names is None or e.name in names
    ]
    gdir = goldens_dir or GOLDENS_DIR
    findings = check_goldens(entries, gdir, update=update_goldens)
    findings += check_skew(entries, gdir)
    findings += check_fuzz(entries, gdir, fuzz_n)
    findings += check_decode_bounds(entries)
    if names is None:
        findings += check_registry_complete()
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu.analysis --wire",
        description="wire-compat auditor (golden corpus, skew matrix, "
                    "decoder fuzz, registry rot guards)",
    )
    p.add_argument("--baseline", help="baseline file (the ratchet)")
    p.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current findings",
    )
    p.add_argument(
        "--update-goldens", action="store_true",
        help="regenerate tests/wire_goldens/ from the registry's "
             "canonical samples (a deliberate wire-layout change)",
    )
    p.add_argument(
        "--fuzz", type=int, default=DEFAULT_FUZZ_N, metavar="N",
        help=f"mutations per registered decoder "
             f"(default {DEFAULT_FUZZ_N})",
    )
    args = p.parse_args(argv)
    if args.update_baseline and not args.baseline:
        p.error("--update-baseline requires --baseline")

    if args.update_goldens:
        check_goldens(list(REGISTRY), GOLDENS_DIR, update=True)
        count = sum(len(e.samples) for e in REGISTRY)
        print(f"wirecheck: regenerated {count} goldens in {GOLDENS_REL}/")

    findings = audit(fuzz_n=args.fuzz)
    findings.sort(key=lambda f: (f.path, f.rule, f.line))

    if args.update_baseline:
        write_baseline(args.baseline, findings)
        print(f"wirecheck: baseline updated with {len(findings)} findings")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else {}
    new, stale = gate(findings, baseline)
    for f in new:
        print(f.render())
    for path, rule, allowed, got in stale:
        print(
            f"note: baseline allows {allowed} {rule} findings for "
            f"{path} but only {got} remain — ratchet it down",
            file=sys.stderr,
        )
    if not new:
        goldens = sum(len(e.samples) for e in REGISTRY)
        print(
            f"wirecheck: clean over {len(REGISTRY)} codecs "
            f"({goldens} goldens, {args.fuzz} mutations/decoder)"
        )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
