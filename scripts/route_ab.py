"""Time the router and lane-pack kernels of this tree against another tree's, on one card.

    python3 scripts/route_ab.py OTHER_ROOT [--order otto] [--out FILE] [--e2e]
        [--phases kernels,multichip,colocated,nodehost] [--sweep]
    python3 scripts/route_ab.py --worker ROOT [--phases ...] [--sweep]

OTHER_ROOT is the root of another checkout of this repository, for
example the parent commit unpacked with ``git archive`` into the
git-ignored ``_chip_scratch/``.  Each tree runs in a process of its own
that imports that tree's ``dragonboat_tpu_torch`` (built into the tree's
own ``_build/``), in the order given: ``o`` the other tree, ``t`` this
one (default ``otto``: other, this, this, other).  Every process times,
through the public ``route_cuda`` and ``xlane_pack``, with CUDA events
around one call (median of 50), the profiler's device time and the
profiler's device time kernel by kernel (chip_smoke.py's ``time_ms``,
``device_ms`` and ``kernel_split``), and holds each call's outputs
against the plain version:

* ``route/C30000``: chip_smoke's colocated route call at 10k groups x 3
  (P=5, W=32, E=4, O=32, budget 4, M = 20, base 0, the alive lane at a
  stride of 4, packed bits and undelivered word);
* ``route/G4096``: the same call at the colocated engine's capacity
  (P=3, W=16, M = 12);
* ``route/X37500``: multichip leg 2's first block as its sharded round
  routes it (P=3, W=16, E=2, O=16, budget 4, M = 14, base 2, the local
  view of the tables, the tick and propose prefill, escalated rows
  suppressed);
* ``route/C4`` and ``route/NS``: the benchmark's two geometries as its
  routed round routes them (``portbench/configs``: ``c4-100k-ragged``,
  499,998 ragged 3/5/7 rows at P=7, W=16, E=2, O=32, budget 8, M = 58;
  ``ns-100k-x3``, 300,000 rows at P=3, W=32, E=4, O=16, budget 4,
  M = 14; base 2): the configuration's rows elected and stepped by the
  tree's ``fused_rounds`` with every leader proposing, then one routed
  step and its escalation merge; the tick and propose prefill,
  escalated rows suppressed;
* ``lane/sized`` and ``lane/undersized``: ``xlane_pack`` on that block
  at leg 2's lane budget and at half the fullest edge's messages (the
  lane then drops some);

then runs chip_smoke's ``multichip`` phase (leg 2's rounds/s and device
ms a round) and, with ``--e2e``, its ``colocated`` and ``nodehost``
phases (the end-to-end paths); ``--phases`` names the parts
to run (``kernels`` being the timings above).  The inputs
are made once from chip_smoke's seeded generators by the first process
and shared through ``--inputs``.  ``--sweep`` (this tree only) also
times the lane pack in blocks of 32, 64 and 128 rows at each lane case,
each held against the default's outputs.  Run without
``--worker``, the script prints one JSON object: every process's
numbers, in order, and the medians per tree.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """This tree's chip_smoke.py (its generators and timers), whichever
    tree's package is imported."""
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the benchmark's configurations routed as ``route/<name>``
BENCH_CASES = (("C4", "c4-100k-ragged"), ("NS", "ns-100k-x3"))
BENCH_SEED = 20261020


def bench_rows(dev, config: str, propose: bool = True):
    """The benchmark configuration ``config``'s rows on ``dev``:
    portbench's layout of its rows for ``BENCH_SEED``, elected by the
    tree's ``fused_rounds`` with every leader proposing until every group
    leads, then 24 launches more, every leader proposing or (``propose``
    false) none.  Returns (state, the next round's inbox, dest_row,
    rank_in_dest, the configuration)."""
    import torch

    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import types as T
    from portbench.harness import layout

    cfg = json.loads((HERE / "portbench" / "configs" / f"{config}.json")
                     .read_text())
    lay = layout.build(cfg, BENCH_SEED)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    st = T.DeviceState(*(put(lay.state[f]) for f in T.DeviceState._fields))
    ib = T.Inbox(*(put(lay.inbox[f]) for f in T.Inbox._fields))
    dest, rank = put(lay.dest_row), put(lay.rank_in_dest)
    gid = put(lay.group.astype(np.int64))
    kw = dict(rounds=int(cfg["rounds_per_launch"]), out_capacity=int(cfg["O"]),
              budget=int(cfg["budget"]), base=int(cfg["base"]),
              propose_leaders=True)
    for n in range(1, 601):
        st, ib, _s, _e = R.fused_rounds(st, ib, dest, rank, **kw)
        if n % 8 == 0:
            led = torch.zeros(lay.groups, dtype=torch.int32, device=dev)
            led.index_add_(0, gid, (st.role == T.ROLE_LEADER).int())
            if bool((led > 0).all()):
                break
    kw["propose_leaders"] = propose
    for _ in range(24):
        st, ib, _s, _e = R.fused_rounds(st, ib, dest, rank, **kw)
    return st, ib, dest, rank, cfg


def bench_route_case(dev, config: str) -> dict:
    """A routed round's route inputs at the geometry of the benchmark's
    configuration ``config``: ``bench_rows`` under writes, then one
    ``kernel.step_routed`` and its escalation merge.  Returns the merged
    state, the step's ``RoutedOut``, the tables and the geometry."""
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import plumbing
    from dragonboat_tpu_torch.ops import types as T

    st, ib, dest, rank, cfg = bench_rows(dev, config)
    new, out = K.step_routed(st, ib, out_capacity=int(cfg["O"]))
    merged = T.DeviceState(*plumbing.merge_escalated(
        out.escalate, list(st), list(new)))
    return dict(merged=merged, out=out, dest=dest, rank=rank,
                M=ib.mtype.shape[1], E=ib.ent_term.shape[2],
                B=int(cfg["budget"]), base=int(cfg["base"]), P=int(cfg["P"]))


def _make_inputs(C, dev) -> dict:
    """{name: numpy array} of every case's inputs."""
    from dragonboat_tpu_torch.ops import convert

    flat = {}

    def put(prefix, tree):
        for k, v in convert.to_numpy(tree).items():
            flat[f"{prefix}/{k}"] = v

    for name, (G, P_, W_) in (("C30000", (30_000, 5, 32)),
                              ("G4096", (4096, 3, 16))):
        c = C.colo_route_case(dev, G, P_, W_)
        put(f"{name}/st", c["merged"])
        put(f"{name}/out", c["out"])
        for k in ("dest", "rank", "combo"):
            flat[f"{name}/{k}"] = c[k].cpu().numpy()
    lc = C.leg2_lane_case(dev)
    put("leg2/st", lc["st_b"][0])
    put("leg2/out", lc["out_b"][0])
    for k, t in zip(("dest_local", "dest_dev", "rank"), lc["tab_b"][0]):
        flat[f"leg2/{k}"] = t.cpu().numpy()
    flat["leg2/xbudget"] = np.array([lc["xbudget"]], np.int32)
    for name, config in BENCH_CASES:
        c = bench_route_case(dev, config)
        put(f"{name}/st", c["merged"])
        put(f"{name}/out", c["out"])
        for k in ("dest", "rank"):
            flat[f"{name}/{k}"] = c[k].cpu().numpy()
        flat[f"{name}/geom"] = np.array(
            [c[k] for k in ("M", "E", "B", "base", "P")], np.int32)
    return flat


def _inputs(C, dev, cache: Path) -> dict:
    """The cases as tensors on ``dev``: made once, kept in ``cache``."""
    from dragonboat_tpu_torch.ops import convert

    f = cache / "route_inputs.npz"
    if f.exists():
        z = np.load(f)
        flat = {k: z[k] for k in z.files}
    else:
        flat = _make_inputs(C, dev)
        cache.mkdir(parents=True, exist_ok=True)
        np.savez(cache / "route_inputs.tmp.npz", **flat)
        os.replace(cache / "route_inputs.tmp.npz", f)

    def tree(prefix, maker):
        return maker({k.split("/")[2]: v for k, v in flat.items()
                      if k.startswith(prefix + "/")}, dev)

    def t(k):
        return convert.torch.from_numpy(flat[k]).to(dev)

    cases = {}
    for name in ("C30000", "G4096", "leg2"):
        cases[name] = dict(st=tree(f"{name}/st", convert.state_from_numpy),
                           out=tree(f"{name}/out", convert.out_from_numpy))
    for name in ("C30000", "G4096"):
        cases[name].update(dest=t(f"{name}/dest"), rank=t(f"{name}/rank"),
                           combo=t(f"{name}/combo"))
    cases["leg2"].update(tabs=[t(f"leg2/{k}") for k in (
        "dest_local", "dest_dev", "rank")],
        xbudget=int(flat["leg2/xbudget"][0]))
    from dragonboat_tpu_torch.ops import kernel as K

    for name, _config in BENCH_CASES:
        M, E, B, base, P = (int(v) for v in flat[f"{name}/geom"])
        cases[name] = dict(
            st=tree(f"{name}/st", convert.state_from_numpy),
            out=tree(f"{name}/out", lambda f, d: K.RoutedOut(*(
                convert.torch.from_numpy(f[k]).to(d)
                for k in K.RoutedOut._fields))),
            dest=t(f"{name}/dest"), rank=t(f"{name}/rank"),
            M=M, E=E, B=B, base=base, P=P)
    return cases


def _calls(C, cases) -> dict:
    """{case: (the tree's call, the plain version's outputs, its bound)}:
    the calls as the paths make them."""
    import torch

    from dragonboat_tpu_torch.ops import colocated_ref as CR
    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import route_ref

    calls = {}
    for name in ("C30000", "G4096"):
        c = cases[name]
        st, out, combo = c["st"], c["out"], c["combo"]
        G, O = out.buf.shape[:2]
        P = st.peer_id.shape[1]
        PB = P * C.BUDGET_K
        pk = torch.empty((G, (O + 31) // 32), dtype=torch.int32,
                         device=combo.device)
        und = torch.empty((G,), dtype=torch.int32, device=combo.device)

        def fn(st=st, out=out, c=c, PB=PB, pk=pk, und=und):
            res = R.route_cuda(
                st, out, c["dest"], c["rank"], M=PB, E=C.E,
                budget=C.BUDGET_K, base=0, suppress=out.escalate,
                alive=c["combo"], alive_stride=4, packed=pk, undeliv=und)
            return list(res[0]) + [res[1], pk, und]

        ib, stats, deliv = route_ref.route(
            st, out, c["dest"], c["rank"], M=PB, E=C.E, budget=C.BUDGET_K,
            base=0, suppress=out.escalate != 0, dest_alive=combo[:, 0] != 0)
        valid = torch.arange(O, device=combo.device)[None, :] < \
            out.count[:, None]
        want = list(ib) + [
            torch.cat([stats, (out.escalate != 0).sum(
                dtype=torch.int32).view(1)]),
            CR.pack_delivered(deliv),
            (valid & ~deliv).any(dim=1).to(torch.int32)]
        calls[f"route/{name}"] = (fn, want, C.route_bound_ms(
            out, deliv, P, PB, C.E, bits=True))
    x = cases["leg2"]
    st, out = x["st"], x["out"]
    dl, dd, rk = x["tabs"]
    local = torch.where(dd == 0, dl, -1).to(torch.int32)
    xkw = dict(M=C.X_M, E=C.X_E, budget=C.X_BUD, base=C.X_BASE)

    def x_route():
        res = R.route_cuda(st, out, local, rk, **xkw, suppress=out.escalate,
                           prefill=(True, True, 1))
        return list(res[0]) + [res[1]]

    ib, stats, deliv = route_ref.route(
        st, out, local, rk, **xkw, suppress=out.escalate != 0,
        base_inbox=route_ref.make_prefill(st, C.X_M, C.X_E,
                                          propose_leaders=True))
    calls["route/X37500"] = (x_route, list(ib) + [torch.cat([
        stats, (out.escalate != 0).sum(dtype=torch.int32).view(1)])],
        C.route_bound_ms(out, deliv, C.X_P, C.X_M, C.X_E, bits=False))
    for name, _config in BENCH_CASES:
        c = cases[name]
        bkw = dict(M=c["M"], E=c["E"], budget=c["B"], base=c["base"])

        def b_route(c=c, bkw=bkw):
            res = R.route_cuda(c["st"], c["out"], c["dest"], c["rank"],
                               **bkw, suppress=c["out"].escalate,
                               prefill=(True, True, 1))
            return list(res[0]) + [res[1]]

        ib, stats, deliv = route_ref.route(
            c["st"], c["out"], c["dest"], c["rank"], **bkw,
            suppress=c["out"].escalate != 0,
            base_inbox=route_ref.make_prefill(c["st"], c["M"], c["E"],
                                              propose_leaders=True))
        calls[f"route/{name}"] = (b_route, list(ib) + [torch.cat([
            stats, (c["out"].escalate != 0).sum(dtype=torch.int32).view(1)])],
            C.route_bound_ms(c["out"], deliv, c["P"], c["M"], c["E"],
                             bits=False))
        del ib, deliv
    lkw = dict(me=0, n_dev=C.X_DEVICES, E=C.X_E, budget=C.X_BUD,
               suppress=out.escalate)
    sized = route_ref.lane_pack(st, out, dl, dd, rk, xbudget=x["xbudget"],
                                **lkw)
    small = max(1, int(sized[0][:, :, route_ref.XI_FOUND].sum(1).max()) // 2)
    for name, xb in (("sized", x["xbudget"]), ("undersized", small)):
        want = (sized if name == "sized" else route_ref.lane_pack(
            st, out, dl, dd, rk, xbudget=xb, **lkw))
        calls[f"lane/{name}"] = (
            lambda xb=xb: list(R.xlane_pack(st, out, dl, dd, rk, xbudget=xb,
                                            **lkw)),
            list(want), C.lane_pack_bound_ms(out, want[0], C.X_P))
    return calls


def _ptxas(log: str) -> dict:
    """Registers, stack and spills of every route and lane kernel the
    tree's build compiled, whatever their names."""
    from dragonboat_tpu_torch.analysis import devicecheck

    names = sorted(set(re.findall(r"(?:route|xlane)_[a-z_]*?kernel", log)),
                   key=len, reverse=True)
    keys = ("regs", "stack", "spill_stores", "spill_loads", "static_smem")
    return {r["kernel"]: {k: r[k] for k in keys}
            for r in devicecheck.ptxas_table(log, names)
            if r["kernel"] in names}


def _times(C, fn) -> dict:
    return dict(ms=C.time_ms(fn, 50), device_ms=C.device_ms(fn),
                split=C.kernel_split(fn))


PHASES = ("kernels", "multichip", "colocated", "nodehost")
E2E = ("colocated", "nodehost")


def worker(root: Path, cache: Path, phases, sweep: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from dragonboat_tpu_torch.ops import _native
    from dragonboat_tpu_torch.ops import route as R

    assert Path(R.__file__).resolve().is_relative_to(root.resolve()), \
        R.__file__
    C = _chip_smoke()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _native.module()
    res = dict(root=str(root), build_s=time.perf_counter() - t0,
               card=C.nvidia_smi_line(),
               ptxas=_ptxas(_native.build_log()))
    if "kernels" in phases or sweep:
        calls = _calls(C, _inputs(C, dev, cache))
        res["times"] = {
            name: dict(_times(C, fn), bound_ms=bound,
                       max_abs_err=C._max_err(fn(), want))
            for name, (fn, want, bound) in calls.items()}
    if "multichip" in phases:
        mc = C.multichip_phase(dev, [dev] * C.X_DEVICES)
        res["leg2"] = {k: mc["leg2"][k] for k in (
            "rounds_per_s", "single_device_rounds_per_s",
            "device_ms_per_round", "single_device_device_ms_per_round",
            "wave_rounds_per_s", "parity_rounds_ok", "parity_waves_ok",
            "cross_delivered", "cross_dropped_xlane")}
    work = root / "dragonboat_tpu_torch" / "_build"
    if "colocated" in phases:
        colo = C.colocated_phase(dev, str(work / f"ab-colo-{os.getpid()}"))
        res["colocated"] = {k: colo[k] for k in (
            "committed_proposals_per_s", "latency_ms", "gpu_utilization",
            "window_launches", "readback_missing")}
    if "nodehost" in phases:
        nh = C.nodehost_phase(dev, str(work / f"ab-nh-{os.getpid()}"))
        res["nodehost"] = {k: nh[k] for k in (
            "committed_proposals_per_s", "propose_latency_ms",
            "readback_missing")}
    if sweep:
        res["sweep"] = _sweep(C, R, calls)
    return res


def _sweep(C, R, calls) -> dict:
    """Device ms of the lane pack in blocks of each of ``LANE_ROWS`` rows
    at every lane case, each held against the default's outputs; the
    block is set by replacing the wrapper's policy function."""
    policy = R.lane_rows_per_block
    out = {}
    try:
        for name, (fn, want, _bound) in calls.items():
            if not name.startswith("lane/"):
                continue
            for Rb in R.LANE_ROWS:
                R.lane_rows_per_block = lambda *_a, Rb=Rb: Rb
                out[f"{name}/R{Rb}"] = dict(
                    device_ms=C.device_ms(fn), split=C.kernel_split(fn),
                    err=C._max_err(fn(), want))
    finally:
        R.lane_rows_per_block = policy
    return out


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
        for ph in ("colocated", "nodehost"):
            if ph in rs[0]:
                m[f"{ph}_per_s"] = med(
                    rs, lambda r: r[ph]["committed_proposals_per_s"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", nargs="?", type=Path)
    ap.add_argument("--order", default="otto")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--inputs", type=Path,
                    default=HERE / "_chip_scratch" / "ab_inputs")
    ap.add_argument("--worker", type=Path, default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--phases", default="kernels,multichip",
                    help=f"comma-separated, of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = set(filter(None, args.phases.split(",")))
    if args.e2e:
        phases |= set(E2E)
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.inputs.resolve(),
                                phases, args.sweep)), flush=True)
        return 0
    if args.other_root is None:
        ap.error("OTHER_ROOT is required")
    runs = []
    for tag in args.order:
        root = HERE if tag == "t" else args.other_root.resolve()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root), "--inputs", str(args.inputs.resolve()),
               "--phases", ",".join(sorted(phases))]
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
        print(f"route_ab: {r['tree']} done", file=sys.stderr, flush=True)
    report = dict(order=args.order, runs=runs, median=_median_by_tree(runs))
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
