"""Run one cell of the benchmark of ``dragonboat_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell's configuration, traffic mix and metric readers are found
by the names in ``BENCHMARK.json``.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``); the numbers that
decide ``correct`` close standard error, each beside its limit, and are
the last key of that object.  Without a CUDA card the run fails and
prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level modules that must never be loaded in a run: the JAX stack and
# the reference package (compared by whole name: the port's name starts
# with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "dragonboat_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line(query: str = "name,power.limit") -> str:
    """The card's ``query`` fields, as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi unreadable)"


def result_line(res: dict, trace: bool, count: int, kind: str) -> dict:
    """The result's JSON object from ``bench.run``'s fields: the result
    keys, then ``checks`` (each compared number and its limit) last."""
    device = dict(platform="gpu", kind=kind, count=count,
                  memory_peak_bytes=res["peak"])
    out = dict(correct=res["correct"], attempted=res["attempted"],
               failed=res["failed"], metrics=res["metrics"], device=device)
    tr = res["trace"]
    if trace and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        gaps = sorted(tr["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = dict(device_ops=tr["device_ops"],
                                idle_gaps=[[k, v] for k, v in gaps])
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in res["checks"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import manifest

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; this benchmark measures the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from portbench.harness import bench

    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    res = bench.run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                    after_window=lambda: card_line(
                        "clocks.sm,power.draw,temperature.gpu"))
    missing = [m["name"] for m in cell.end_to_end
               if m["name"] not in res["metrics"]]
    if missing and not args.trace:
        print(f"portbench: nothing measured for {missing}", file=sys.stderr)
        return 5
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    out = result_line(res, bool(args.trace), cell.chips,
                      torch.cuda.get_device_name(torch.device("cuda")))
    tr = res["trace"]
    info = dict(cell=cell.name, seed=args.seed, window_s=res["window_s"],
                launches=res["launches"], rounds=res["rounds"],
                setup_launches=res["setup_launches"], entries=res["entries"],
                leaders=res["leaders"], totals=res["totals"],
                sentry=[list(g) for g in res["grown"]],
                memory_peak_bytes=res["peak"], check_s=res["check_s"],
                setup_phases=res["setup_phases"],
                check_parts=res["check_parts"],
                card_after_window=res["after_window"],
                clock_skew_ns=(tr or {}).get("clock_skew_ns"),
                wall_s=time.perf_counter() - T_START)
    print("run: " + json.dumps(info), file=sys.stderr)
    for k, (v, lim) in res["checks"].items():
        print(f"check {k} = {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
