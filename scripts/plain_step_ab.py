"""Time copies of the plain raft step (``ops/kernel_ref.py``) on one device.

    python3 scripts/plain_step_ab.py A.py [B.py ...] [--steps 120]
                                     [--reps 5] [--rows 1024] [--live 3]
                                     [--device cpu]

Each argument is a copy of ``dragonboat_tpu_torch/ops/kernel_ref.py``
(this tree's, the parent commit's from ``git show``, or one with a
change taken out), loaded as a module of this tree's
``dragonboat_tpu_torch.ops``.  The workload is the NodeHost engine's at
``torch_step_engine_factory``'s defaults (``--rows`` 1,024, P=5, W=32,
M=8, E=4, O=32) holding one three-replica shard in rows 0-2
(``--live`` 3) and nothing in the rest, as a three-host cluster's
engine steps it (``--rows 30000 --live 30000`` is the chip smoke
test's kernels phase, 10k shards): ``--steps`` seeded steps, each
inbox made from the previous step's outboxes (``ops/fuzz.route_np``,
its ticks and proposals on the live rows only), recorded once through
the first copy.  Every copy must return what the
first returned on every step (states and outboxes, bit for bit); then
the copies step the recorded inputs ``--reps`` times in turns (A B ...
A B ...).  One JSON line a copy: the median and every rep's
milliseconds a step, on one CPU thread.  With ``--device cuda`` the steps run on the card
(the plain version as the engines' parity checks run it there), each
rep timed to a ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dragonboat_tpu_torch.ops import types as T  # noqa: E402
from dragonboat_tpu_torch.ops.fuzz import cluster_state_np, route_np  # noqa: E402

P, W, M, E, O = 5, 32, 8, 4, 32
SEED = 3


def load(path: str, i: int):
    name = f"dragonboat_tpu_torch.ops._plain_step_copy{i}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def tensors(cols: dict, cls, device):
    return cls(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in cols.items()})


def numpy_cols(tree) -> dict:
    return {k: v.cpu().numpy() for k, v in tree._asdict().items()}


def record(mod, steps: int, seed: int, G: int, live_rows: int, device):
    """(state, inbox) before every step, and each step's result."""
    live = cluster_state_np(live_rows, P, W, seed)
    n = G - live_rows
    empty = T.make_state_np(n, P, W, shard_ids=np.zeros(n),
                            replica_ids=np.zeros(n),
                            peer_ids=np.zeros((n, P), np.int32))
    st = tensors({k: np.concatenate([live[k], empty[k]]) for k in live},
                 T.DeviceState, device)
    out = T.make_out(G, P, M, E, O, device=device)
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(steps):
        ib = route_np(numpy_cols(st), numpy_cols(out), rng, M, E)
        for v in ib.values():
            v[live_rows:] = 0
        ib = tensors(ib, T.Inbox, device)
        new, out = mod.step(st, ib, O)
        cases.append((st, ib, new, out))
        st = new
    return cases


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("copies", nargs="+")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--live", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mods = [load(p, i) for i, p in enumerate(args.copies)]
    cases = record(mods[0], args.steps, SEED, args.rows, args.live, dev)
    for path, mod in zip(args.copies, mods):
        for st, ib, new, out in cases:
            got_st, got_out = mod.step(st, ib, O)
            if not (same(got_st, new) and same(got_out, out)):
                print(f"{path}: differs from {args.copies[0]}",
                      file=sys.stderr)
                return 1
    ms = {p: [] for p in args.copies}
    for _ in range(args.reps):
        for path, mod in zip(args.copies, mods):
            sync()
            t0 = time.perf_counter()
            for st, ib, _new, _out in cases:
                mod.step(st, ib, O)
            sync()
            ms[path].append((time.perf_counter() - t0) * 1e3 / len(cases))
    leaders = int((cases[-1][2].role[:args.live] == T.ROLE_LEADER).sum())
    for path in args.copies:
        print(json.dumps(dict(copy=path, median_ms=statistics.median(
            ms[path]), ms=ms[path], steps=len(cases), rows=args.rows,
            live_rows=args.live, leaders_at_end=leaders,
            device=str(dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
