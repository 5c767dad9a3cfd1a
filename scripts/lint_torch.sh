#!/usr/bin/env bash
# The port's static-analysis gates and the analyzers' self-tests, the
# counterpart of scripts/lint.sh (which stays the reference's): raftlint
# plus the torch-sync pass over the port and chip_smoke.py, the
# device-plane audit on the CPU (the card's half runs in chip_smoke.py's
# analysis phase) and the wire-compat audit against the reference's
# goldens each fail on any finding not covered by their checked-in
# baselines; then the analyzers' tests prove every rule still catches its
# seeded violation and the lock-order witness still finds no cycle in a
# live port cluster.
cd "$(dirname "$0")/.." || exit 1
set -o pipefail
rc=0
timeout -k 5 120 python -m dragonboat_tpu_torch.analysis \
    --baseline dragonboat_tpu_torch/analysis/baseline.txt \
    dragonboat_tpu_torch chip_smoke.py || rc=1
timeout -k 5 120 python -m dragonboat_tpu_torch.analysis --device \
    --baseline dragonboat_tpu_torch/analysis/device_baseline.txt || rc=1
timeout -k 5 120 python -m dragonboat_tpu_torch.analysis --wire \
    --baseline dragonboat_tpu_torch/analysis/wire_baseline.txt || rc=1
timeout -k 5 300 env JAX_PLATFORMS=cpu python -m pytest \
    tests/test_torch_analysis.py tests/test_torch_devicecheck.py \
    tests/test_torch_wirecheck.py \
    -q -p no:cacheprovider -p no:xdist -p no:randomly || rc=1
exit $rc
