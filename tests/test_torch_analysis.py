"""The port's analysis plane against the reference's cases.

* ``test_analysis.py`` runs on the port's copies (``load_on_port``):
  every raftlint rule's seeded fixtures, the baseline and ignore
  machinery, the lock-order witness and the wire-compat auditor, with
  the fixtures' relpaths, the real-tree reads and the tree gate sent to
  the port's tree (``dragonboat_tpu_torch/...``, ``chip_smoke.py`` and
  the port's ``analysis/baseline.txt``).  Every real-tree needle the
  reference's cases seed exists in the port's ``ops/``.
* The torch-sync pass (``analysis/torchsync.py``) catches each torch
  sync it names, one finding a call, in a ``# sync-hot`` function, in the
  pure-device modules and in a ``# mesh-hot`` function; its exemptions
  are raftlint's.
* The port's tree gate: raftlint plus the torch-sync pass over
  ``dragonboat_tpu_torch chip_smoke.py`` is clean against the baseline,
  whose only entries are the mesh modes' per-block dispatch (ROADMAP §1
  item 4), and the markers those entries come from are live.
* The lock-order witness over a live cluster: a fresh interpreter
  installs the port's witness BEFORE it imports the port (so locks made
  at import, such as ``ops/engine.py``'s ``_CPU_DEVICE_LOCK``, are
  tracked), runs three NodeHosts on ``TorchStepEngine(device="cpu")``
  at a 60 ms tick, proposes, stops the leader's host and proposes
  again, and finds no lock-order cycle.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dragonboat_tpu_torch.analysis import lockcheck as port_lockcheck
from dragonboat_tpu_torch.analysis import raftlint as port_raftlint
from dragonboat_tpu_torch.analysis import torchsync

from test_torch_storage import load_on_port

ROOT = Path(__file__).resolve().parent.parent
BASELINE = ROOT / "dragonboat_tpu_torch" / "analysis" / "baseline.txt"

_an = load_on_port(
    "test_analysis.py", "tan_analysis",
    replace=[
        ('"dragonboat_tpu/', '"dragonboat_tpu_torch/', 89),
        ('lint_paths(["dragonboat_tpu", "bench.py"])',
         'lint_paths(["dragonboat_tpu_torch", "chip_smoke.py"])', 1),
    ])

# the reference's cases and their fixture, collected from this module
globals().update({k: v for k, v in vars(_an).items()
                  if k.startswith(("test_", "Test")) or k == "witness"})


def test_cases_run_on_the_port():
    assert _an.raftlint is port_raftlint
    assert _an.lockcheck is port_lockcheck
    assert _an.wirecheck.__name__ == "dragonboat_tpu_torch.analysis.wirecheck"
    assert port_raftlint.HOST_SYNC_MODULES == (
        "dragonboat_tpu_torch/ops/kernel.py",
        "dragonboat_tpu_torch/ops/route.py")


# ---------------------------------------------------------------------------
# the torch-sync pass: seeded violations, one finding a call
# ---------------------------------------------------------------------------
TORCH_SYNC_SRC = '''
import numpy as np
import torch

def _complete(dev: torch.Tensor, ev, stream, host):  # sync-hot
    a = dev.cpu()                    # flagged
    b = dev.numpy()                  # flagged
    c = dev.tolist()                 # flagged
    d = dev.to("cpu")                # flagged
    torch.cuda.synchronize()         # flagged
    ev.synchronize()                 # flagged
    e = dev.to(torch.int32)          # a dtype cast: free
    f = dev.sum(dim=0)               # stays on the device: free
    g = (f[1:] + 1).tolist()         # flagged: built from a tensor
    h = torch.zeros(3).tolist()      # flagged: a torch result
    rows = np.nonzero(host)[0]
    i = rows.tolist()                # host numpy rows: free
    j = host.tolist()                # not shown to be a tensor: free
    st = DeviceState(*dev)
    k = st.term.numpy()              # flagged: a device container's field
    m = _step(st)[0].cpu()           # flagged: a device maker's result
    return a, b, c, d, e, f, g, h, i, j, k, m

def _step(st) -> Tuple[DeviceState, DeviceOut]:
    return st, st

def _unmarked(dev: torch.Tensor):
    return dev.cpu().numpy()         # unmarked functions may sync
'''

MESH_HOT_SRC = '''
import torch

def make_round(mesh, st, D, rounds):  # mesh-hot
    dev0 = mesh.devices[0]
    a = st.term.to(dev0)                       # flagged: device move
    b = st.term.to(device=dev0)                # flagged: device move
    st.term.copy_(a)                           # flagged: device move
    for d in range(D):                         # flagged: per-block loop
        pass
    parts = [p.sum() for p in st.parts]        # flagged: per-block loop
    for d in range(mesh.size):                 # flagged: per-block loop
        pass
    for dv in mesh.devices:                    # raftlint's, not twice
        pass
    c = st.term.to(I32)                        # a dtype cast: free
    for k in range(rounds):                    # rounds, not blocks: free
        pass
    return a, b, c, parts

def helper(st, dev0):
    return st.term.to(dev0)                    # unmarked: free
'''


def _flagged_lines(src, fs):
    return [src.splitlines()[f.line - 1] for f in fs]


def test_torch_sync_budget_catches_each_torch_sync():
    fs = torchsync.torch_findings(
        TORCH_SYNC_SRC, "dragonboat_tpu_torch/ops/colocated.py")
    assert {f.rule for f in fs} == {"sync-budget"} and len(fs) == 10, fs
    lines = _flagged_lines(TORCH_SYNC_SRC, fs)
    assert all("# flagged" in ln for ln in lines), lines
    # raftlint alone sees none of them
    assert port_raftlint.lint_source(
        TORCH_SYNC_SRC, "dragonboat_tpu_torch/ops/colocated.py") == []


def test_torch_sync_scoped_like_raftlint():
    # another module: no sync-budget scope, and no host-sync scope
    assert torchsync.torch_findings(
        TORCH_SYNC_SRC, "dragonboat_tpu_torch/obs/trace.py") == []
    # the reference's tree is not the port's scope
    assert torchsync.torch_findings(
        TORCH_SYNC_SRC, "dragonboat_tpu/ops/colocated.py") == []
    unmarked = TORCH_SYNC_SRC.replace("  # sync-hot", "")
    assert torchsync.torch_findings(
        unmarked, "dragonboat_tpu_torch/ops/engine.py") == []


def test_torch_sync_host_sync_in_device_modules():
    """In ops/kernel.py and ops/route.py every function is held to no
    host sync: the ten calls plus the unmarked function's two."""
    fs = torchsync.torch_findings(
        TORCH_SYNC_SRC, "dragonboat_tpu_torch/ops/kernel.py")
    rules = sorted(f.rule for f in fs)
    assert rules.count("host-sync") == 12 and rules.count("sync-budget") == 0


def test_torch_sync_ignores_are_raftlints():
    # a point ignore on the line, and the ignore-next-line form
    src = TORCH_SYNC_SRC.replace(
        "    a = dev.cpu()                    # flagged",
        "    a = dev.cpu()  # raftlint: ignore[sync-budget] the blob collect",
    ).replace(
        "    torch.cuda.synchronize()         # flagged",
        "    # raftlint: ignore[sync-budget] the sanctioned wait\n"
        "    torch.cuda.synchronize()",
    )
    fs = torchsync.torch_findings(src, "dragonboat_tpu_torch/ops/colocated.py")
    assert len(fs) == 8, fs
    # a def-line ignore exempts the whole function (_func_exempt)
    src = TORCH_SYNC_SRC.replace(
        "def _unmarked(dev: torch.Tensor):",
        "def _unmarked(dev: torch.Tensor):  # raftlint: ignore[host-sync] "
        "host helper",
    ).replace("  # sync-hot", "  # sync-hot  # raftlint: ignore[host-sync] x")
    fs = torchsync.torch_findings(src, "dragonboat_tpu_torch/ops/route.py")
    assert [f for f in fs if f.rule == "host-sync"] == [], fs


def test_mesh_hot_catches_device_moves_and_block_loops():
    rel = "dragonboat_tpu_torch/ops/route.py"
    fs = torchsync.torch_findings(MESH_HOT_SRC, rel)
    assert {f.rule for f in fs} == {"mesh-loop"} and len(fs) == 6, fs
    lines = _flagged_lines(MESH_HOT_SRC, fs)
    assert all("# flagged" in ln for ln in lines), lines
    # raftlint reports the loop over mesh.devices; the two passes
    # together report each once
    both = torchsync.lint_source(MESH_HOT_SRC, rel)
    assert len([f for f in both if f.rule == "mesh-loop"]) == 7
    # unmarked, nothing; out of the mesh modules, nothing
    assert torchsync.torch_findings(
        MESH_HOT_SRC.replace("  # mesh-hot", ""), rel) == []
    assert torchsync.torch_findings(
        MESH_HOT_SRC, "dragonboat_tpu_torch/ops/hostplane.py") == []


def test_mesh_hot_def_line_ignore_exempts():
    src = MESH_HOT_SRC.replace(
        "def make_round(mesh, st, D, rounds):  # mesh-hot",
        "def make_round(mesh, st, D, rounds):  # mesh-hot  "
        "# raftlint: ignore[mesh-loop] a documented exception")
    assert torchsync.lint_source(
        src, "dragonboat_tpu_torch/ops/kernel.py") == []


# ---------------------------------------------------------------------------
# the port's tree gate and its live markers
# ---------------------------------------------------------------------------
def test_port_tree_gate_raftlint_and_torch_sync():
    """THE gate of scripts/lint_torch.sh: zero unbaselined findings of
    both passes over the port and chip_smoke.py; the baseline holds only
    mesh-loop debt, and all of it is still there (a ratchet)."""
    old = os.getcwd()
    os.chdir(ROOT)
    try:
        findings = torchsync.lint_paths(["dragonboat_tpu_torch",
                                         "chip_smoke.py"])
    finally:
        os.chdir(old)
    baseline = port_raftlint.load_baseline(str(BASELINE))
    assert {rule for _path, rule in baseline} == {"mesh-loop"}
    new, stale = port_raftlint.gate(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [], stale


@pytest.mark.parametrize("rel,marker", [
    ("ops/kernel.py", "def make_step_sharded(  # mesh-hot"),
    ("ops/route.py", "def make_sharded_round(  # mesh-hot"),
])
def test_mesh_hot_markers_are_live(rel, marker):
    """The reference's two mesh-hot programs' counterparts carry the
    marker; stripping it takes their per-block findings away."""
    path = ROOT / "dragonboat_tpu_torch" / rel
    src = path.read_text()
    assert marker in src
    relpath = f"dragonboat_tpu_torch/{rel}"
    marked = torchsync.torch_findings(src, relpath)
    stripped = torchsync.torch_findings(
        src.replace(marker, marker.replace("  # mesh-hot", "")), relpath)
    assert len(stripped) < len(marked)


def test_colocated_launch_path_holds_no_torch_sync():
    """The colocated launch path's ``# sync-hot`` functions read back
    through their blob helpers only: the pass finds no torch sync there
    (their many ``.tolist()`` calls are of host numpy rows), and a tensor
    readback seeded into one is caught."""
    rel = "dragonboat_tpu_torch/ops/colocated.py"
    src = (ROOT / rel).read_text()
    assert [f for f in torchsync.torch_findings(src, rel)
            if f.rule == "sync-budget"] == []
    marker = ("    def _complete_generation(self, rec: _InFlightGen) -> "
              "List[Tuple]:  # sync-hot\n")
    assert marker in src
    seeded = src.replace(marker, marker + "        _probe = torch.zeros("
                         "1, device=self.device).tolist()\n", 1)
    fs = [f for f in torchsync.torch_findings(seeded, rel)
          if f.rule == "sync-budget"]
    assert len(fs) == 1 and ".tolist()" in fs[0].message, fs


def test_cli_gates_the_tree():
    res = subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.analysis",
         "--baseline", str(BASELINE), "dragonboat_tpu_torch",
         "chip_smoke.py"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "raftlint: clean" in res.stdout


# ---------------------------------------------------------------------------
# the lock-order witness over a live port cluster (always on)
# ---------------------------------------------------------------------------
WITNESS_SCRIPT = r'''
import json, sys, time
sys.path.insert(0, ROOT)
from dragonboat_tpu_torch.analysis import lockcheck
w = lockcheck.install()
import dragonboat_tpu_torch as pt
from dragonboat_tpu_torch.ops import engine as E
from dragonboat_tpu_torch.ops.engine import torch_step_engine_factory
from dragonboat_tpu_torch.storage.logdb import in_mem_logdb_factory
from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

ADDRS = {1: "tlw-1", 2: "tlw-2", 3: "tlw-3"}
GEOM = dict(capacity=16, P=5, W=32, M=8, E=4, O=32)


class KV(pt.IStateMachine):
    def __init__(self, shard_id, replica_id):
        self.data = {}

    def update(self, entry):
        k, v = entry.cmd.split(b"=", 1)
        self.data[k] = v
        return pt.Result(value=len(self.data))

    def lookup(self, query):
        return self.data.get(query)

    def save_snapshot(self, w, files, done):
        w.write(repr(self.data).encode())

    def recover_from_snapshot(self, r, files, done):
        pass


def host(rid):
    return pt.NodeHost(pt.NodeHostConfig(
        nodehost_dir=f"{WORKDIR}/nh-{rid}", rtt_millisecond=60,
        raft_address=ADDRS[rid],
        expert=pt.ExpertConfig(
            engine=pt.EngineConfig(exec_shards=1, apply_shards=2),
            logdb_factory=in_mem_logdb_factory,
            step_engine_factory=torch_step_engine_factory(
                **GEOM, device="cpu"))))


def leader(nhs, timeout=60.0):
    end = time.time() + timeout
    while time.time() < end:
        seen = set()
        for nh in nhs.values():
            lid, ok = nh.get_leader_id(1)
            if not ok:
                break
            seen.add(lid)
        else:
            if len(seen) == 1:
                lid = seen.pop()
                if lid in nhs:
                    return lid
        time.sleep(0.05)
    raise AssertionError("no leader")


def propose(nh, i, timeout=60.0):
    s = nh.get_noop_session(1)
    end = time.time() + timeout
    while True:
        try:
            return nh.sync_propose(s, f"k{i}=v{i}".encode(), timeout=3.0)
        except Exception:
            if time.time() > end:
                raise
            time.sleep(0.05)


reset_inproc_network()
nhs = {rid: host(rid) for rid in ADDRS}
try:
    for rid, nh in nhs.items():
        nh.start_replica(ADDRS, False, KV, pt.Config(
            replica_id=rid, shard_id=1, election_rtt=20, heartbeat_rtt=2))
    lid = leader(nhs)
    for i in range(6):
        propose(nhs[lid], i)
    nhs.pop(lid).close()  # the leader's host goes away
    lid2 = leader(nhs)
    for i in range(6, 12):
        propose(nhs[lid2], i)
finally:
    for nh in nhs.values():
        nh.close()
lockcheck.uninstall()
rep = w.report()
print(json.dumps(dict(
    cycles=len(rep["cycles"]), formatted=w.format_cycles(),
    tracked=rep["tracked_locks"], acquires=rep["acquires"],
    edges=rep["edges"], leaders=[lid, lid2],
    cpu_lock=repr(E._CPU_DEVICE_LOCK),
    cpu_lock_tracked=isinstance(E._CPU_DEVICE_LOCK, lockcheck._TrackedLock),
)))
'''


def test_witness_over_a_port_cluster_finds_no_cycle(tmp_path):
    script = (f"ROOT = {str(ROOT)!r}\nWORKDIR = {str(tmp_path)!r}\n"
              + WITNESS_SCRIPT)
    res = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    assert rep["cycles"] == 0, rep["formatted"]
    assert rep["leaders"][0] != rep["leaders"][1]
    # the lock made at import time is the witness's
    assert rep["cpu_lock_tracked"], rep["cpu_lock"]
    assert "dragonboat_tpu_torch/ops/engine.py:" in rep["cpu_lock"]
    assert rep["tracked"] > 20 and rep["acquires"] > 1000 and rep["edges"] > 0


def test_witness_tracks_the_port_only():
    """The port's witness wraps locks made under ``dragonboat_tpu_torch/``
    and leaves the reference's alone (its root is its own package's
    parent; the reference's is a string prefix of it, which is why the
    two are never armed in one process)."""
    from dragonboat_tpu import metrics as ref_metrics
    from dragonboat_tpu_torch import metrics as port_metrics

    w = port_lockcheck.install()
    try:
        port = port_metrics.MetricsRegistry()
        ref = ref_metrics.MetricsRegistry()
    finally:
        port_lockcheck.uninstall()
    assert w.root.endswith("dragonboat_tpu_torch")
    tracked = [v for v in vars(port).values()
               if isinstance(v, port_lockcheck._TrackedLock)]
    assert tracked, vars(port)
    assert not [v for v in vars(ref).values()
                if type(v).__name__ == "_TrackedLock"]
