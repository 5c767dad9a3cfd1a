"""Time this tree's row-move and readback kernels against another tree's, on one card.

    python3 scripts/place_ab.py OTHER_ROOT [--order otto] [--out FILE]
        [--phases kernels,multichip,colocated]
    python3 scripts/place_ab.py --worker ROOT [--phases ...]

OTHER_ROOT is the root of another checkout of this repository, for
example the parent commit unpacked with ``git archive`` into the
git-ignored ``_chip_scratch/``.  Each tree runs in a process of its own
that imports that tree's ``dragonboat_tpu_torch`` (built into the tree's
own ``_build/``), in the order given: ``o`` the other tree, ``t`` this
one (default ``otto``: other, this, this, other).  Every process times,
through the public wrappers, with CUDA events around one call (median of
50), the profiler's device time and its split kernel by kernel
(chip_smoke.py's ``time_ms``, ``device_ms`` and ``kernel_split``), and
holds each call's outputs against the plain version:

* ``place/<geometry>/<mode>`` at 30,000 rows (P=5, W=32) and at
  multichip leg 2's block (37,500 rows, P=3, W=16), state-shaped seeded
  fields: ``scatter`` (1,024 rows into the state through a pos map, as
  the engine uploads rows), ``gather`` (1,024 rows out, no dst),
  ``select`` (new where pos = g, else old), ``escsel`` (a tree's
  out-of-place ``select_escalated``, no row escalated, where the tree
  has one), ``merge0`` and ``merge10`` (the routed rounds' escalation
  merge with no row and with 10% of the rows escalated:
  ``merge_escalated`` in place where the tree has it, else
  ``select_escalated``, the call that tree's rounds make), ``snapshot``;
* ``select/<case>``: ``colocated._select_and_blob`` at the first
  capacity tier on 30,000 rows (P=5, W=32, O=32, 28 outbox slots, host
  columns from 20) with seeded flags and lanes at the routed cluster's
  selection rates, on a storm (every row selected in every section), and
  at the colocated engine's capacity (4,096 rows);

then runs chip_smoke's ``multichip`` phase (leg 2's rounds/s and device
ms a round) and ``colocated`` phase (committed proposals/s), as
``--phases`` says (default: all three), requiring the launches of the
tree's own merge kernel (``place_rows`` in a tree without
``merge_escalated``).  The inputs are made once by the
first process and shared through ``--inputs``.  Run without
``--worker``, the script prints one JSON object: every process's
numbers, in order, and the medians per tree.
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
SEED = 20261020
GEOMS = {"C30000": (30_000, 5, 32), "X37500": (37_500, 3, 16)}
# select_and_blob's cases: rows, P, W, outbox slots, host columns from
SEL_GEOMS = {"C30000": (30_000, 5, 32, 28, 20),
             "storm": (30_000, 5, 32, 28, 20),
             "G4096": (4096, 3, 16, 20, 12)}
SEL_O, SEL_E = 32, 4


def _chip_smoke():
    """This tree's chip_smoke.py (its timers), whichever tree's package
    is imported."""
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _state_shapes(G, P, W):
    """The DeviceState fields' shapes, in field order."""
    return [(G,)] * 21 + [(G, P)] * 8 + [(G, W)] * 2


def _make_inputs() -> dict:
    """{name: numpy array} of every case's inputs."""
    flat = {}
    for name, (G, P, W) in GEOMS.items():
        rng = np.random.default_rng([SEED, G])
        shapes = _state_shapes(G, P, W)
        for tag, n in (("old", G), ("new", G), ("sub", 1024)):
            for f, s in enumerate(shapes):
                flat[f"{name}/{tag}/{f}"] = rng.integers(
                    -999, 999, (n,) + s[1:]).astype(np.int32)
        pos = np.full(G, -1, np.int32)
        pos[np.sort(rng.choice(G, 1024, replace=False))] = np.arange(1024)
        flat[f"{name}/pos"] = pos
        flat[f"{name}/idx"] = rng.integers(0, G, 1024).astype(np.int32)
        flat[f"{name}/keep"] = np.where(rng.random(G) < 0.9, np.arange(G),
                                        -1).astype(np.int32)
        flat[f"{name}/esc0"] = np.zeros(G, np.int32)
        flat[f"{name}/esc10"] = np.where(rng.random(G) < 0.1, 4,
                                         0).astype(np.int32)
        flat[f"{name}/snap"] = np.stack([rng.choice(G, 3, replace=False),
                                         rng.integers(0, P, 3),
                                         rng.integers(1, 99, 3)]
                                        ).astype(np.int32)
    for name, (G, P, W, Mo, _h) in SEL_GEOMS.items():
        rng = np.random.default_rng([SEED, G, len(name)])
        flat[f"sel/{name}/ring_term"] = rng.integers(0, 99, (G, W))
        flat[f"sel/{name}/ring_cc"] = rng.integers(0, 2, (G, W))
        flat[f"sel/{name}/buf"] = rng.integers(0, 99, (G, SEL_O, 11))
        flat[f"sel/{name}/need_snapshot"] = rng.integers(0, 2, (G, P))
        for k in ("slot_base", "slot_term"):
            flat[f"sel/{name}/{k}"] = rng.integers(-3, 99, (G, Mo))
        flat[f"sel/{name}/ent_drop"] = rng.integers(0, 2, (G, Mo, SEL_E))
        for k in ("term", "vote", "committed", "leader_id", "role",
                  "last_index", "count", "append_lo", "barrier_idx",
                  "barrier_term"):
            flat[f"sel/{name}/{k}"] = rng.integers(0, 99, G)
        if name == "storm":
            flags = np.full(G, 15, np.int32)
            combo = np.ones((G, 4), np.int32)
        else:
            # the routed cluster's rates (chip_smoke's colocated kernels
            # phase): F_CHANGED, F_COUNT, F_APPEND, F_NEED_SS, F_ESC
            bits = rng.random((G, 5)) < (0.9, 0.04, 0.65, 0.0, 0.001)
            flags = (bits * (1, 2, 4, 8, 16)).sum(1).astype(np.int32)
            combo = np.concatenate(
                [rng.random((G, 3)) < (0.97, 0.5, 0.1),
                 rng.integers(0, 4, (G, 1))], axis=1)
        flat[f"sel/{name}/flags"] = flags
        flat[f"sel/{name}/combo"] = combo
        flat[f"sel/{name}/packed"] = rng.integers(-2**31, 2**31 - 1,
                                                  (G, 1))
        flat[f"sel/{name}/stats"] = rng.integers(0, 99, 6)
    return {k: np.ascontiguousarray(v, np.int32) for k, v in flat.items()}


def _inputs(cache: Path) -> dict:
    f = cache / "place_inputs.npz"
    if f.exists():
        z = np.load(f)
        return {k: z[k] for k in z.files}
    flat = _make_inputs()
    cache.mkdir(parents=True, exist_ok=True)
    np.savez(cache / "place_inputs.tmp.npz", **flat)
    os.replace(cache / "place_inputs.tmp.npz", f)
    return flat


def _place_calls(flat: dict, name: str, dev) -> dict:
    """{mode: (the tree's call, the plain version's outputs)} at one of
    ``GEOMS``."""
    import torch

    from dragonboat_tpu_torch.ops import engine_ref, plumbing
    from dragonboat_tpu_torch.ops import types as T

    def t(k):
        return torch.from_numpy(flat[k]).to(dev)

    n_f = len(T.DeviceState._fields)
    old, new, sub = ([t(f"{name}/{tag}/{f}") for f in range(n_f)]
                     for tag in ("old", "new", "sub"))
    pos, idx, keep = t(f"{name}/pos"), t(f"{name}/idx"), t(f"{name}/keep")
    esc0, esc10 = t(f"{name}/esc0"), t(f"{name}/esc10")
    gi, pi, si = t(f"{name}/snap").unbind(0)
    rs_i = T.DeviceState._fields.index("rstate")
    rs, sn = new[rs_i], new[rs_i + 1]
    scratch = [x.clone() for x in new]
    # the routed rounds' merge as the tree makes it
    merge = (plumbing.merge_escalated
             if hasattr(plumbing, "merge_escalated") else None)
    calls = {
        "scatter": (lambda: plumbing.place_rows(old, sub, pos),
                    engine_ref.place_rows(old, sub, pos)),
        "gather": (lambda: plumbing.place_rows(None, new, idx),
                   engine_ref.place_rows(None, new, idx)),
        "select": (lambda: plumbing.place_rows(old, new, keep),
                   engine_ref.place_rows(old, new, keep)),
        "snapshot": (
            lambda: list(plumbing.set_remote_snapshot(rs, sn, gi, pi, si)),
            list(engine_ref.set_remote_snapshot(rs, sn, gi, pi, si))),
    }
    if hasattr(plumbing, "select_escalated"):
        calls["escsel"] = (
            lambda: plumbing.select_escalated(esc0, old, new),
            engine_ref.select_escalated(esc0, old, new))
    for m, esc in (("merge0", esc0), ("merge10", esc10)):
        want = engine_ref.select_escalated(esc, old, new)
        if merge:
            calls[m] = (lambda esc=esc: merge(esc, old, scratch), want)
        else:
            calls[m] = (lambda esc=esc: plumbing.select_escalated(
                esc, old, new), want)
    return calls


def _select_call(flat: dict, name: str, dev):
    """(the tree's select_and_blob call at the first tier, the plain
    version's outputs) on one of ``SEL_GEOMS``."""
    import torch

    from dragonboat_tpu_torch.ops import colocated as PC
    from dragonboat_tpu_torch.ops import colocated_ref as CR
    from dragonboat_tpu_torch.ops import types as T

    G, P, W, _Mo, hoff = SEL_GEOMS[name]
    s = {k.split("/")[2]: torch.from_numpy(v).to(dev)
         for k, v in flat.items() if k.startswith(f"sel/{name}/")}
    st = T.make_state(G, P, W, device=dev)._replace(**{
        k: s[k] for k in ("ring_term", "ring_cc", "term", "vote",
                          "committed", "leader_id", "role", "last_index")})
    out = T.DeviceOut(
        **{k: s[k] for k in ("buf", "count", "need_snapshot", "slot_base",
                             "slot_term", "ent_drop", "append_lo",
                             "barrier_idx", "barrier_term")},
        escalate=torch.zeros(G, dtype=torch.int32, device=dev))
    args = (st, out, s["stats"], s["packed"], s["flags"], s["combo"])
    caps = {k: min(G, v) for k, v in PC._SEL_TIERS[0].items()}
    kw = dict(CAP_B=caps["b"], CAP_SL=caps["sl"], CAP_N=caps["n"],
              CAP_A=caps["a"], CAP_S=caps["s"], HOST_OFF=hoff)
    return (lambda: list(PC._select_and_blob(*args, **kw)),
            list(CR.select_and_blob(*args, **kw)))


def _calls(flat: dict, dev) -> dict:
    """{case: (the tree's call, the plain version's outputs)}."""
    calls = {}
    for name in GEOMS:
        for m, c in _place_calls(flat, name, dev).items():
            calls[f"place/{name}/{m}"] = c
    for name in SEL_GEOMS:
        calls[f"select/{name}"] = _select_call(flat, name, dev)
    return calls


def _times(C, fn) -> dict:
    return dict(ms=C.time_ms(fn, 50), device_ms=C.device_ms(fn),
                split=C.kernel_split(fn))


PHASES = ("kernels", "multichip", "colocated")


def _merge_kernel(C, kernel: str) -> tuple:
    """chip_smoke's (leg 2 path kernels, colocated parity kernels) with
    ``merge_escalated`` replaced by the tree's merge ``kernel``."""
    def sub(ks):
        return tuple(kernel if k == "merge_escalated" else k for k in ks)

    return sub(C.X_PATH_KERNELS), sub(C.COLO_PARITY_KERNELS)


def worker(root: Path, cache: Path, phases) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from dragonboat_tpu_torch.ops import _native, plumbing

    assert Path(plumbing.__file__).resolve().is_relative_to(root.resolve()), \
        plumbing.__file__
    C = _chip_smoke()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _native.module()
    res = dict(root=str(root), build_s=time.perf_counter() - t0,
               card=C.nvidia_smi_line(),
               ptxas={k: v
                      for k, v in C.ptxas_by_kernel(_native.build_log()).items()
                      if k.startswith(("place", "merge", "select", "blob"))})
    if "kernels" in phases:
        calls = _calls(_inputs(cache), dev)
        res["times"] = {
            name: dict(_times(C, fn), max_abs_err=C._max_err(fn(), want))
            for name, (fn, want) in calls.items()}
    x_kernels, colo_kernels = _merge_kernel(
        C, "merge_escalated" if "merge_escalated" in _native.KERNELS
        else "place_rows")
    if "multichip" in phases:
        mc = C.multichip_phase(dev, [dev] * C.X_DEVICES,
                               path_kernels=x_kernels)
        res["leg2"] = {k: mc["leg2"][k] for k in (
            "rounds_per_s", "single_device_rounds_per_s",
            "device_ms_per_round", "single_device_device_ms_per_round",
            "wave_rounds_per_s", "parity_rounds_ok", "parity_waves_ok",
            "cross_delivered", "cross_dropped_xlane", "kernel_launches")}
    if "colocated" in phases:
        work = root / "dragonboat_tpu_torch" / "_build"
        colo = C.colocated_phase(dev, str(work / f"ab-colo-{os.getpid()}"),
                                 parity_kernels=colo_kernels)
        res["colocated"] = {k: colo[k] for k in (
            "committed_proposals_per_s", "latency_ms", "gpu_utilization",
            "window_launches", "readback_missing", "kernel_launches")}
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
        if "leg2" in rs[0]:
            m["leg2"] = {q: med(rs, lambda r: r["leg2"][q]) for q in (
                "rounds_per_s", "device_ms_per_round",
                "single_device_rounds_per_s",
                "single_device_device_ms_per_round")}
        if "colocated" in rs[0]:
            m["colocated_per_s"] = med(
                rs, lambda r: r["colocated"]["committed_proposals_per_s"])
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
        print(f"place_ab: {r['tree']} done", file=sys.stderr, flush=True)
    report = dict(order=args.order, runs=runs, median=_median_by_tree(runs))
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
