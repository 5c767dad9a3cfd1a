"""Time this tree's inbox kernels against another tree's, on one card.

    python3 scripts/inbox_ab.py OTHER_ROOT [--order otto] [--out FILE]
        [--phases kernels,colocated,nodehost]
    python3 scripts/inbox_ab.py --worker ROOT [--phases ...]

OTHER_ROOT is the root of another checkout of this repository, for
example the parent commit unpacked with ``git archive`` into the
git-ignored ``_chip_scratch/``.  Each tree runs in a process of its own
that imports that tree's ``dragonboat_tpu_torch`` (built into the tree's
own ``_build/``), in the order given: ``o`` the other tree, ``t`` this
one (default ``otto``: other, this, this, other).  Every process calls
the colocated engine's inbox programs through their wrappers
(``colocated._host_inbox_from_ticks``, ``_assemble_inbox``,
``_zero_inbox_rows``), holds each call's outputs against the plain
version (``colocated_ref``) and times it with chip_smoke.py's timers:
CUDA events around one call (median of 50), the profiler's device time
and its split kernel by kernel.  The cases:

* ``C30000/<entry>``: 30,000 rows (P*B = 20 routed slots, 8 host slots,
  E = 4, chip_smoke's colo_kernels geometry): from_ticks on a tick lane in
  [0, 4), assemble with 3% dead rows, zero_rows over the routed regions
  with 5% of the rows masked;
* ``C30000/assemble_dead<p>``: assemble with 0, 10 and 100% dead rows;
* ``odd/<entry>``: the same at 4,099 rows, P*B = 5, 3 host slots, E = 3
  (off the 16-byte path).

Each case also carries its bound (bytes over 3.35 TB/s) and, where there
is one, the library yardstick (from_ticks: ``zero_()`` over a buffer of
the same bytes; assemble: 12 ``torch.cat`` of the two regions).  Then
chip_smoke's ``colocated`` and ``nodehost`` phases give committed
proposals/s (colocated with the engine's launch counters and its wall
time by stage), as ``--phases`` says.  The inputs are made once by the first
process and shared through ``--inputs``.  Run without ``--worker``, the
script prints one JSON object: every process's numbers, in order, the
card (``nvidia-smi`` name and power limit), and the medians per tree.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
SEED = 20261022
# rows, routed slots (P*B), host slots, entry width
GEOMS = {"C30000": (30_000, 20, 8, 4), "odd": (4099, 5, 3, 3)}
N_INBOX = 12
PHASES = ("kernels", "colocated", "nodehost")


def _chip_smoke():
    """This tree's chip_smoke.py (its timers), whichever tree's package
    is imported."""
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _make_inputs() -> dict:
    """{name: numpy array} of every case's inputs."""
    flat = {}
    for name, (G, PB, _MH, E) in GEOMS.items():
        rng = np.random.default_rng([SEED, G])
        for f in range(N_INBOX):
            shape = (G, PB, E) if f >= 10 else (G, PB)
            flat[f"{name}/pending/{f}"] = rng.integers(-999, 999, shape)
        combo = np.zeros((G, 4), np.int64)
        combo[:, 0] = rng.random(G) < 0.97
        combo[:, 1:3] = rng.random((G, 2)) < (0.5, 0.1)
        combo[:, 3] = rng.integers(0, 4, G)
        flat[f"{name}/combo"] = combo
        flat[f"{name}/mask"] = rng.random(G) < 0.05
        for p in (0, 10, 100):
            flat[f"{name}/alive{p}"] = rng.random(G) >= p / 100
    return {k: np.ascontiguousarray(v, np.int32) for k, v in flat.items()}


def _inputs(cache: Path) -> dict:
    f = cache / "inbox_inputs.npz"
    if f.exists():
        z = np.load(f)
        return {k: z[k] for k in z.files}
    flat = _make_inputs()
    cache.mkdir(parents=True, exist_ok=True)
    np.savez(cache / "inbox_inputs.tmp.npz", **flat)
    os.replace(cache / "inbox_inputs.tmp.npz", f)
    return flat


def _calls(C, flat: dict, dev) -> dict:
    """{case: (the tree's call, the plain version's outputs, bound ms,
    the library yardstick or None)}."""
    import torch

    from dragonboat_tpu_torch.ops import colocated as PC
    from dragonboat_tpu_torch.ops import colocated_ref as CR
    from dragonboat_tpu_torch.ops import types as T

    def t(k):
        return torch.from_numpy(flat[k]).to(dev)

    calls = {}
    for name, (G, PB, MH, E) in GEOMS.items():
        combo = t(f"{name}/combo")
        pending = T.Inbox(*(t(f"{name}/pending/{f}") for f in range(N_INBOX)))
        host = CR.host_inbox_from_ticks(combo, M=MH, E=E)
        mask = t(f"{name}/mask")
        row_w = 10 + 2 * E
        zbuf = torch.empty(G * MH * row_w, dtype=torch.int32, device=dev)
        calls[f"{name}/from_ticks"] = (
            lambda combo=combo, MH=MH, E=E: list(
                PC._host_inbox_from_ticks(combo, M=MH, E=E)),
            list(host), C.bound_ms(4 * (G + G * MH * row_w)), zbuf.zero_)

        def cat(host=host, pending=pending):
            return [torch.cat([p, h], dim=1) for h, p in zip(host, pending)]

        cases = {"assemble": combo}
        if name == "C30000":
            for p in (0, 10, 100):
                c = combo.clone()
                c[:, 0] = t(f"{name}/alive{p}")
                cases[f"assemble_dead{p}"] = c
        for case, c in cases.items():
            calls[f"{name}/{case}"] = (
                lambda c=c, host=host, pending=pending: list(
                    PC._assemble_inbox(host, pending, c)),
                list(CR.assemble_inbox(host, pending, c)),
                C.inbox_copy_bound_ms(c[:, 0] != 0, PB + MH, E), cat)
        calls[f"{name}/zero_rows"] = (
            lambda pending=pending, mask=mask: list(
                PC._zero_inbox_rows(pending, mask)),
            list(CR.zero_inbox_rows(pending, mask)),
            C.inbox_copy_bound_ms(mask == 0, PB, E), None)
    return calls


def worker(root: Path, cache: Path, phases) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from dragonboat_tpu_torch.ops import _native, colocated

    assert Path(colocated.__file__).resolve().is_relative_to(root.resolve()), \
        colocated.__file__
    C = _chip_smoke()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _native.module()
    res = dict(root=str(root), build_s=time.perf_counter() - t0,
               card=C.nvidia_smi_line(),
               ptxas={k: v
                      for k, v in C.ptxas_by_kernel(_native.build_log()).items()
                      if k.startswith("inbox")})
    if "kernels" in phases:
        times = {}
        for name, (fn, want, bound, lib) in _calls(
                C, _inputs(cache), dev).items():
            times[name] = dict(
                max_abs_err=C._max_err(fn(), want), ms=C.time_ms(fn, 50),
                device_ms=C.device_ms(fn), split=C.kernel_split(fn),
                bound_ms=bound,
                library_ms=C.time_ms(lib, 50) if lib else None,
                library_device_ms=C.device_ms(lib) if lib else None)
        res["times"] = times
    work = root / "dragonboat_tpu_torch" / "_build"
    if "colocated" in phases:
        colo = C.colocated_phase(dev, str(work / f"ab-colo-{os.getpid()}"))
        res["colocated"] = {k: colo[k] for k in (
            "committed_proposals_per_s", "latency_ms", "gpu_utilization",
            "window_launches", "readback_missing", "kernel_launches",
            "entry_launches", "engine", "engine_ms")}
    if "nodehost" in phases:
        nh = C.nodehost_phase(dev, str(work / f"ab-nh-{os.getpid()}"))
        res["nodehost"] = {k: nh[k] for k in (
            "committed_proposals_per_s", "launches")}
    return res


def _median_by_tree(runs: list) -> dict:
    by = {}
    for r in runs:
        by.setdefault(r["tree"], []).append(r)

    def med(rs, get):
        return float(np.median([get(r) for r in rs]))

    out = {}
    for tree, rs in by.items():
        m = out[tree] = {}
        for k in rs[0].get("times", {}):
            m[k] = {q: med(rs, lambda r: r["times"][k][q])
                    for q in ("ms", "device_ms")}
        for p in ("colocated", "nodehost"):
            if p in rs[0]:
                m[f"{p}_per_s"] = med(
                    rs, lambda r: r[p]["committed_proposals_per_s"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", nargs="?", type=Path)
    ap.add_argument("--order", default="otto")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--inputs", type=Path,
                    default=HERE / "_chip_scratch" / "ab_inputs")
    ap.add_argument("--worker", type=Path, default=None)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated, of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = set(filter(None, args.phases.split(",")))
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.inputs.resolve(),
                                phases)), flush=True)
        return 0
    if args.other_root is None:
        ap.error("OTHER_ROOT is required")
    runs = []
    for tag in args.order:
        root = HERE if tag == "t" else args.other_root.resolve()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root), "--inputs", str(args.inputs.resolve()),
               "--phases", ",".join(sorted(phases))]
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if p.returncode:
            sys.stderr.write(p.stderr[-8000:])
            return p.returncode
        r = json.loads(p.stdout.strip().splitlines()[-1])
        r["tree"] = "this" if tag == "t" else "other"
        runs.append(r)
        print(f"inbox_ab: {r['tree']} done", file=sys.stderr, flush=True)
    report = dict(order=args.order, card=runs[0]["card"], runs=runs,
                  median=_median_by_tree(runs))
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
