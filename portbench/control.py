"""Read the control and the planted faults at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 1

For each seed, one sound run and one run for each of ``faults.VARIANTS``
(the controls, then the faults), all in this process: set-up runs the
program, the timed window runs the variant, and the run's checks decide
``correct`` as in ``run.py``.  Prints one JSON line a run with every
compared number; a variant that no number catches is reported as such
(``caught``: false; the exit code is then 1).  A cell needs one control
caught, not each: a control breaks a path that the cell's traffic may
not take.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--variants", default=None,
                    help="comma-separated; default: sound, then every "
                         "variant of faults.py")
    args = ap.parse_args(argv)

    import torch

    from portbench import faults
    from portbench.harness import bench, manifest
    from portbench.harness.loop import program_rounds

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = manifest.cell(args.workload)
    fns = dict(faults.VARIANTS, sound=program_rounds)
    names = (args.variants.split(",") if args.variants
             else ["sound", *faults.VARIANTS])
    uncaught = 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        for name in names:
            t = time.perf_counter()
            res = bench.run(cell, seed, args.seconds, False, t,
                            rounds_fn=fns[name])
            caught = not res["correct"]
            if (name == "sound") == caught:
                uncaught += 1
            print(json.dumps(dict(
                cell=cell.name, seed=seed, variant=name,
                correct=res["correct"], caught=caught,
                launches=res["launches"],
                checks={k: v for k, (v, _lim) in res["checks"].items()},
                wall_s=time.perf_counter() - t)), flush=True)
    return 1 if uncaught else 0


if __name__ == "__main__":
    sys.exit(main())
