"""CLI of the port's analysis plane.

``python -m dragonboat_tpu_torch.analysis [--baseline F] [paths...]``
    raftlint plus the torch-sync pass (default path:
    ``dragonboat_tpu_torch``);
``python -m dragonboat_tpu_torch.analysis --device [--cuda] [--baseline F]``
    the device-plane policies (``devicecheck``; ``--cuda`` on the card);
``python -m dragonboat_tpu_torch.analysis --wire [--baseline F]``
    the wire-compat audit against the reference's goldens.

There is no recompile sentry (the reference's ``jitcheck``): the port's
kernels are built ahead of time and keyed on no shape, so nothing
compiles after warm-up until the mesh round becomes a CUDA graph.
"""
import argparse
import sys

from . import raftlint, torchsync


def lint_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.analysis",
        description="raftlint and the torch-sync pass over the port")
    ap.add_argument("paths", nargs="*", default=["dragonboat_tpu_torch"])
    ap.add_argument("--baseline", default=None,
                    help="baseline file to gate against")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the findings, exit 0")
    args = ap.parse_args(argv)
    findings = torchsync.lint_paths(args.paths or ["dragonboat_tpu_torch"])
    if args.update_baseline:
        if not args.baseline:
            ap.error("--update-baseline requires --baseline")
        raftlint.write_baseline(args.baseline, findings)
        print(f"raftlint: baseline written ({len(findings)} findings)")
        return 0
    baseline = raftlint.load_baseline(args.baseline) if args.baseline else {}
    new, stale = raftlint.gate(findings, baseline)
    for f in new:
        print(f.render())
    for path, rule, allowed, now in stale:
        print(f"raftlint: note: baseline for {path} {rule} is {allowed}, "
              f"tree has {now} — ratchet it down", file=sys.stderr)
    if new:
        print(f"raftlint: {len(new)} unbaselined finding(s) "
              f"({len(findings)} total, baseline covers "
              f"{sum(baseline.values())})", file=sys.stderr)
        return 1
    print(f"raftlint: clean ({len(findings)} finding(s), all baselined)"
          if findings else "raftlint: clean")
    return 0


def main(argv) -> int:
    argv = list(argv)
    if "--device" in argv:
        argv.remove("--device")
        from .devicecheck import main as device_main

        return device_main(argv)
    if "--wire" in argv:
        argv.remove("--wire")
        if "--update-goldens" in argv:
            print("wirecheck: --update-goldens refused: tests/wire_goldens/ "
                  "holds the reference's goldens, which the port's codecs "
                  "must reproduce; regenerate them from the reference "
                  "(python -m dragonboat_tpu.analysis --wire "
                  "--update-goldens)", file=sys.stderr)
            return 2
        from .wirecheck import main as wire_main

        return wire_main(argv)
    return lint_main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
