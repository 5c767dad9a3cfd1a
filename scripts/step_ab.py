"""Time the raft step's kernels of this tree against another tree's, on one card.

    python3 scripts/step_ab.py OTHER_ROOT [--order otto] [--out FILE] [--sweep]
    python3 scripts/step_ab.py --worker ROOT [--sweep]   # one tree, one JSON line

OTHER_ROOT is the root of another checkout of this repository, for
example the parent commit unpacked with ``git archive`` into the
git-ignored ``_chip_scratch/``.  Each tree runs in a process of its own
that imports that tree's ``dragonboat_tpu_torch`` (built into the tree's
own ``_build/``), in the order given: ``o`` the other tree, ``t`` this
one (default ``otto``: other, this, this, other).
Every process times, through the public ``step`` / ``step_internal``,
both kernels at each geometry below with CUDA events around one call
(median of 20) and the profiler's device time (chip_smoke.py's
``time_ms`` / ``device_ms``):

* ``G30000``: 10k groups x 3 (P=5, W=32, M=8, E=4, O=32), the last of
  40 routed steps and a fuzz inbox (chip_smoke's kernels phase);
* ``G300000``: bench phase A's 100k groups x 3 (P=3, W=8, M=12, E=1,
  O=8), its tick inbox after 3 launches and a fuzz inbox;
* ``G512``: the NodeHost engine's capacity at the same widths as
  ``G30000``, 16 routed steps and a fuzz inbox;
* ``G4096``: the colocated engine's capacity (P=3, W=16, assembled
  M=20, E=4, O=32), likewise.

The external cases also time the routed round's step (``step_routed``).
The inputs are made once from chip_smoke's seeded generators (the
routed steps advanced by the first process's kernels, which are
bit-exact with the plain versions) and shared through ``--inputs``.

Every process also times ``step_routed`` alone on the benchmark's two
geometries, ``routed/<C4|NS>_<write|idle>``: ``c4-100k-ragged`` (499,998
ragged 3/5/7 rows at P=7, W=16, M=58, E=2, O=32) and ``ns-100k-x3``
(300,000 rows at P=3, W=32, M=14, E=4, O=16), their rows elected by the
tree's ``fused_rounds`` and then 24 launches of write traffic (every
leader proposing) or idle (ticks and heartbeats): the step's inputs of
the next round (``scripts/route_ab.py`` ``bench_rows``; made in every
process, too large to share).

``--sweep`` (this tree's wrapper only) also times every block shape the
full step takes at each geometry (rows a block; none, the default number
or all of the outbox messages staged in shared memory), and every shape
of the routed step at the routed cases (rows a block), and checks each
against the default shape's outputs (the routed step's: the state,
``count``, ``escalate`` and the messages below the count).  Run without
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

GEOMS = {
    "G30000": dict(G=30_000, P=5, W=32, M=8, E=4, O=32, routed=40),
    "G512": dict(G=512, P=5, W=32, M=8, E=4, O=32, routed=16),
    "G4096": dict(G=4096, P=3, W=16, M=20, E=4, O=32, routed=16),
}


def _chip_smoke():
    """This tree's chip_smoke.py (its generators and timers), whichever
    tree's package is imported."""
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _route_ab():
    """This tree's scripts/route_ab.py (``bench_rows``)."""
    spec = importlib.util.spec_from_file_location(
        "ab_route_ab", HERE / "scripts" / "route_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the benchmark's configurations whose routed step is timed
ROUTED_CONFIGS = (("C4", "c4-100k-ragged"), ("NS", "ns-100k-x3"))


def routed_cases(dev):
    """Yields (case, state, inbox, O) of the routed step at each
    benchmark geometry under write and idle traffic (one case alive at a
    time: a C4 case holds about 2 GB)."""
    ra = _route_ab()
    for name, config in ROUTED_CONFIGS:
        for traffic in ("write", "idle"):
            st, ib, _d, _r, cfg = ra.bench_rows(dev, config,
                                                propose=traffic == "write")
            yield f"routed/{name}_{traffic}", st, ib, int(cfg["O"])


def _inputs(C, dev, cache: Path) -> dict:
    """{case: (state, inbox, O, E)} in the external layout, on ``dev``;
    made once and kept in ``cache`` as numpy."""
    from dragonboat_tpu_torch.ops import convert
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import types as T

    cases = {}
    f = cache / "inputs.npz"
    if f.exists():
        z = np.load(f)
        names = sorted({k.split("/")[0] for k in z.files})
        for c in names:
            st = {k.split("/")[2]: z[k] for k in z.files
                  if k.startswith(c + "/st/")}
            ib = {k.split("/")[2]: z[k] for k in z.files
                  if k.startswith(c + "/ib/")}
            O_, E_ = (int(v) for v in z[c + "/oe/x"])
            cases[c] = (convert.state_from_numpy(st, dev),
                        convert.inbox_from_numpy(ib, dev), O_, E_)
        return cases
    rng = np.random.default_rng(C.SEED + 11)
    for name, g in GEOMS.items():
        G, P, W, M, E, O = (g[k] for k in "GPWMEO")
        st_np = C.padded_cluster_np(G, P, W, C.SEED + G)
        out_np = {"buf": np.zeros((G, O, T.N_FIELDS), np.int32),
                  "count": np.zeros((G,), np.int32)}
        for k in range(g["routed"]):
            ib_np = C.route_np(st_np, out_np, rng, M, E)
            if k == g["routed"] - 1:
                cases[name + "_routed"] = (st_np, ib_np, O, E)
            st = convert.state_from_numpy(st_np, dev)
            new, out = K.step(st, convert.inbox_from_numpy(ib_np, dev), O)
            st_np, out_np = convert.to_numpy(new), convert.to_numpy(out)
        cases[name + "_fuzz"] = (st_np, C.fuzz_inbox_np(st_np, rng, M, E),
                                 O, E)
    st, tick = C.phase_a_inputs(dev)
    for _ in range(3):
        st, _out = K.step_internal(st, tick, C.A_O)
    ext = convert.to_numpy(convert.state_from_internal(st))
    cases["G300000_tick"] = (
        ext, convert.to_numpy(convert.inbox_from_internal(tick)), C.A_O,
        C.A_E)
    cases["G300000_fuzz"] = (ext, C.fuzz_inbox_np(ext, rng, C.A_M, C.A_E),
                             C.A_O, C.A_E)
    cache.mkdir(parents=True, exist_ok=True)
    flat = {}
    for c, (s, i, O_, E_) in cases.items():
        flat.update({f"{c}/st/{k}": v for k, v in s.items()})
        flat.update({f"{c}/ib/{k}": v for k, v in i.items()})
        flat[f"{c}/oe/x"] = np.array([O_, E_], np.int32)
    np.savez(cache / "inputs.tmp.npz", **flat)
    os.replace(cache / "inputs.tmp.npz", f)
    return {c: (convert.state_from_numpy(s, dev),
                convert.inbox_from_numpy(i, dev), O_, E_)
            for c, (s, i, O_, E_) in cases.items()}


def _alloc41(st, ib, O, dev):
    """The output allocation of a wrapper with one torch.empty a field:
    31 state fields and 10 outputs (the host-side yardstick of the
    two-allocation wrapper)."""
    import torch

    G, P, M, E = (st.term.shape[0], st.peer_id.shape[1], ib.mtype.shape[1],
                  ib.ent_term.shape[2])
    new = [torch.empty_like(t) for t in st]

    def e(*s):
        return torch.empty(s, dtype=torch.int32, device=dev)

    return new + [e(G, O, 11), e(G), e(G), e(G, P), e(G, M), e(G, M),
                  e(G, M, E), e(G), e(G), e(G)]


def worker(root: Path, cache: Path, sweep: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from dragonboat_tpu_torch.ops import _native, convert, kernel_ref
    from dragonboat_tpu_torch.ops import kernel as K

    assert Path(K.__file__).resolve().is_relative_to(root.resolve()), K.__file__
    C = _chip_smoke()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _native.module()
    res = dict(root=str(root), build_s=time.perf_counter() - t0,
               card=C.nvidia_smi_line(),
               ptxas=C.ptxas_by_kernel(_native.build_log()))
    cases = _inputs(C, dev, cache)
    times = {}
    for c, (st, ib, O, E) in cases.items():
        ist = convert.state_to_internal(st)
        iib = convert.inbox_to_internal(ib)
        for kern, fn in (("raft_step", lambda: K.step(st, ib, O)),
                         ("raft_step_internal",
                          lambda: K.step_internal(ist, iib, O)),
                         ("raft_step_routed",
                          lambda: K.step_routed(st, ib, O))):
            new, out = fn()
            times[f"{c}/{kern}"] = dict(
                ms=C.time_ms(fn, 20), device_ms=C.device_ms(fn),
                bound_ms=(C.step_bound_ms(st, ib, out, E)
                          if isinstance(out, K.DeviceOut) else None))
    res["resident_blocks"] = {}
    routed_sweep = {}
    for c, st, ib, O in routed_cases(dev):
        fn = lambda: K.step_routed(st, ib, O)
        fn()
        times[c] = dict(ms=C.time_ms(fn, 20), device_ms=C.device_ms(fn))
        res["resident_blocks"][c] = getattr(
            _native, "RESIDENT_BLOCKS", {}).get("raft_step_routed")
        if sweep:
            routed_sweep.update(_routed_sweep(C, K, _native, c, st, ib, O))
        del st, ib
        torch.cuda.empty_cache()
    res["times"] = times
    # the host's side of a launch: the output allocations alone
    st, ib, O, _E = cases["G300000_tick"]
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        _alloc41(st, ib, O, dev)
    res["alloc41_us"] = (time.perf_counter() - t0) / reps * 1e6
    if hasattr(_native, "alloc_views"):
        G, P, M = st.term.shape[0], st.peer_id.shape[1], ib.mtype.shape[1]
        E = ib.ent_term.shape[2]
        shapes = ((G, O, 11), (G,), (G,), (G, P), (G, M), (G, M),
                  (G, M, E), (G,), (G,), (G,))
        st_shapes = tuple(tuple(t.shape) for t in st)
        t0 = time.perf_counter()
        for _ in range(reps):
            _native.alloc_views(st_shapes, dev)
            _native.alloc_views(shapes, dev)
        res["alloc2_us"] = (time.perf_counter() - t0) / reps * 1e6
    res["phase_a_parts"] = _phase_a_parts(C, K, convert, cases)
    if sweep:
        res["sweep"] = _sweep(C, K, kernel_ref, convert, cases)
        res["routed_sweep"] = routed_sweep
    return res


def _routed_out(st, out):
    """What the routed round reads of a routed step: the state, count,
    escalate and each row's messages below its count."""
    import torch

    O = out.buf.shape[1]
    live = torch.arange(O, device=out.buf.device)[None, :] < \
        out.count[:, None]
    return list(st) + [out.count, out.escalate, out.buf[live]]


def _routed_sweep(C, K, _native, case, st, ib, O) -> dict:
    """device ms of the routed step at every rows-a-block of one routed
    case, each held against the default shape's outputs, with the resident
    blocks an SM its launch reported; the shape is set by replacing the
    wrapper's block rule."""
    policy = K.rows_per_block
    out = {}
    try:
        ref = _routed_out(*K.step_routed(st, ib, O))
        for R in K.ROWS_PER_BLOCK:
            K.rows_per_block = lambda *_a, R=R: R

            def fn():
                return K.step_routed(st, ib, O)

            err = C._max_err(_routed_out(*fn()), ref)
            out[f"{case}/R{R}"] = dict(
                device_ms=C.device_ms(fn), err=err,
                resident_blocks=_native.RESIDENT_BLOCKS.get(
                    "raft_step_routed"))
    finally:
        K.rows_per_block = policy
    return out


def _phase_a_parts(C, K, convert, cases) -> dict:
    """Where phase A's launch goes, from inputs that cut parts of the
    work: device ms of step_internal on its tick inbox with every slot
    empty (the load, prefill and store phases and the row's scalars),
    with no election timer firing (the slot loop's ticks alone), and as
    it is (with the elections and their messages)."""
    import torch

    st, ib, O, _E = cases["G300000_tick"]
    ist = convert.state_to_internal(st)
    iib = convert.inbox_to_internal(ib)
    empty = type(iib)(*(torch.zeros_like(t) for t in iib))
    big = torch.full_like(ist.election_timeout, 1 << 30)
    calm = ist._replace(election_timeout=big, rand_timeout=big)
    return {name: C.device_ms(lambda s=s, i=i: K.step_internal(s, i, O))
            for name, s, i in (("empty", ist, empty), ("ticks", calm, iib),
                               ("elections", ist, iib))}


def _sweep(C, K, kernel_ref, convert, cases) -> dict:
    """device ms of every block shape at every case, each held against
    the default shape's outputs (and once against the plain version);
    the shape is set by replacing the wrapper's two policy functions."""
    policy = (K.rows_per_block, K.staged_messages)
    try:
        return _sweep_shapes(C, K, kernel_ref, convert, cases, *policy)
    finally:
        K.rows_per_block, K.staged_messages = policy


def _sweep_shapes(C, K, kernel_ref, convert, cases, rows_per_block,
                  staged_messages) -> dict:
    out = {}
    for c, (st, ib, O, E) in cases.items():
        G, P, W = st.term.shape[0], st.peer_id.shape[1], st.ring_term.shape[1]
        M = ib.mtype.shape[1]
        ist = convert.state_to_internal(st)
        iib = convert.inbox_to_internal(ib)
        for internal, s_, i_ in ((False, st, ib), (True, ist, iib)):
            K.rows_per_block = rows_per_block
            K.staged_messages = staged_messages
            ref = K._step_cuda(s_, i_, O, internal)
            plain = (kernel_ref.step_internal if internal
                     else kernel_ref.step)(s_, i_, O)
            err0 = C._max_err(list(ref[0]) + list(ref[1]),
                              list(plain[0]) + list(plain[1]))
            for R in K.ROWS_PER_BLOCK:
                for n in sorted({0, staged_messages(O), O}):
                    if K.smem_bytes(R, P, W, M, E, O, internal, n) > \
                            K.SMEM_MAX:
                        continue
                    K.rows_per_block = lambda *_a, R=R: R
                    K.staged_messages = lambda _o, n=n: n

                    def fn():
                        return K._step_cuda(s_, i_, O, internal)

                    got = fn()
                    err = C._max_err(list(got[0]) + list(got[1]),
                                     list(ref[0]) + list(ref[1]))
                    key = f"{c}/{'gl' if internal else 'ext'}/R{R}/K{n}"
                    out[key] = dict(device_ms=C.device_ms(fn), err=err,
                                    err_default_vs_plain=err0)
    return out


def _median_by_tree(runs: list) -> dict:
    by = {}
    for r in runs:
        by.setdefault(r["tree"], []).append(r)
    med = {}
    for tree, rs in by.items():
        keys = rs[0]["times"].keys()
        med[tree] = {k: {m: float(np.median([r["times"][k][m] for r in rs]))
                         for m in ("ms", "device_ms")}
                     for k in keys if all(k in r["times"] for r in rs)}
    return med


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", nargs="?", type=Path)
    ap.add_argument("--order", default="otto")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--inputs", type=Path,
                    default=HERE / "_chip_scratch" / "ab_inputs")
    ap.add_argument("--worker", type=Path, default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.inputs.resolve(),
                                args.sweep)),
              flush=True)
        return 0
    if args.other_root is None:
        ap.error("OTHER_ROOT is required")
    runs = []
    for tag in args.order:
        root = HERE if tag == "t" else args.other_root.resolve()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root), "--inputs", str(args.inputs.resolve())]
        if args.sweep and tag == "t" and not any(
                r["tree"] == "this" and "sweep" in r for r in runs):
            cmd.append("--sweep")
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if p.returncode:
            sys.stderr.write(p.stderr[-8000:])
            return p.returncode
        r = json.loads(p.stdout.strip().splitlines()[-1])
        r["tree"] = "this" if tag == "t" else "other"
        runs.append(r)
        print(f"step_ab: {r['tree']} done", file=sys.stderr, flush=True)
    report = dict(order=args.order, runs=runs, median=_median_by_tree(runs))
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
