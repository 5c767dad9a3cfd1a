"""Chip smoke for the PyTorch/CUDA port (dragonboat_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero without
    python3 chip_smoke.py --only colo_kernels,colocated   # some phases, no result
    python3 chip_smoke.py --only mesh_kernels,phase_a,multichip
    python3 chip_smoke.py --only mesh_engines
    python3 chip_smoke.py --only audit
    python3 chip_smoke.py --only registry,day
    python3 chip_smoke.py --only graft,analysis
    python3 chip_smoke.py --only pipeline
    python3 chip_smoke.py --only scale [--scale-shards 10000]

Phases, each printing one JSON line:

1. device    — the card's name and power limit (nvidia-smi), and the time
               to build every CUDA kernel from the sources in this checkout
               (with the ptxas register and spill report).
2. kernels   — raft_step, summarize_flags, gather_pack and place_rows held
               bit-exact against their plain PyTorch versions on the card
               at G = 30,000 rows (10k groups x 3 replicas; P=5, W=32, M=8,
               E=4, O=32), on states advanced through a seeded routed
               sequence of steps plus seeded fuzz inboxes over every hot
               message type; then each kernel's time per launch at that
               size (CUDA events per call, and the profiler's device time).
               raft_step also at the engines' small grids: G = 512 (the
               NodeHost engine's capacity, the same widths) and G = 4096
               (the colocated engine's; P=3, W=16, assembled M=20, E=4,
               O=32), bit-exact and timed the same way.  place_rows in
               every mode (scatter with a dst, gather without one,
               select, the escalation select as a select, the snapshot
               store) and the in-place escalation merge (merge_escalated,
               at 0, 3 and about 10% escalated rows) bit-exact at 30,000,
               512 and multichip leg 2's block of 37,500 rows, each mode
               timed with its device split and its bound.
3. colo_kernels — route, the three inbox entry points (assemble,
               from_ticks, zero_rows) and select_and_blob, bit-exact
               against their plain versions at G = 30,000 rows (P=5, W=32,
               E=4, O=32, budget 4, assembled M = P*4 + 8, the fixed
               capacity tiers) on states advanced by the port's own
               fused_rounds over build_route_tables of the 10k x 3 layout;
               then timed the same way; route also at the colocated
               engine's capacity (G = 4096, P=3, W=16), each with its
               kernels' device split (the profiler's time by kernel);
               select_and_blob also on a storm (every row selected in
               every section, the counts past the first tiers' caps) and
               at G = 4096, at every tier, with its count / scan / write
               split.  The three inbox entry points also at a geometry
               off the 16-byte path (odd P*B = 5, 3 host slots, E = 3,
               4,099 rows: a ragged last tile), with sources at aligned
               and unaligned addresses; assemble at 0, about 10 and 100%
               dead rows and on the fused wave's all-zero combo; each
               beside a library yardstick (from_ticks: one zero_() over a
               buffer of the same bytes; assemble: 12 torch.cat of the
               two regions).
4. mesh_kernels — raft_step_internal (raft_step.cu's G-last kernel)
               bit-exact against its plain version at bench phase A's
               geometry, G = 300,000 rows (100k groups x 3;
               P=3, W=8, M=12, E=1, O=8) on states advanced by the tick
               loop and under seeded fuzz inboxes; xlane_pack and
               xlane_scatter bit-exact against theirs at multichip leg
               2's geometry (150,000 rows on a mesh of 4 blocks), the
               pack also at an undersized lane budget (so that the lane
               drops), and route on leg 2's first block as its sharded
               round runs it (local tables, tick and propose prefill);
               each timed, the pack and route with their kernels'
               device split, with the external raft_step at the same
               300,000 rows beside raft_step_internal.
5. phase_a   — the reference bench's phase A loop on step_internal: the
               300,000 rows stay on the card in the G-last layout, 12
               slots of 32 fused ticks per launch; group ticks per second
               with escalated rows subtracted, every window closed by
               torch.cuda.synchronize(), one launch per window re-checked
               against the plain version.
6. multichip — the reference's phase_multichip legs 1 and 2 on
               GroupsMesh([cuda:0] * 4) (and on 4 distinct cards when 4
               are visible): leg 1 make_step_sharded(internal=True) against
               step_internal at 300,000 rows; leg 2 make_sharded_round at
               50k groups x 3 replicas, replica-major, 40 rounds against
               routed_round and 8 waves of 3 against fused_rounds, state
               and inbox bit-exact; the reference's gates (cross traffic
               delivered, no lane drop, every group committing, per-device
               balance <= 1.1).  On one card the lane's copies never
               leave the card: it measures the mechanism, not a
               multi-chip number.
7. nodehost  — the base engine's path: three NodeHosts in one process on
               the in-proc transport, each stepping its shards through
               ``torch_step_engine_factory(device="cuda")``; 300 shards x
               3 replicas elect leaders, take 4 writes each through
               ``sync_propose``, and every acknowledged write is read back
               linearizably and from each replica's state machine.
8. colocated — the product path, the reference bench's phase C shape:
               1,000 shards x 3 replicas on three NodeHosts sharing ONE
               ``ColocatedEngineGroup(device="cuda")`` with the tan WAL;
               8 workers keep 8 proposals in flight per shard through the
               asynchronous ``propose`` future for 30 s, after 5 s of the
               same drive as warm-up traffic; every acknowledged write is
               read back from all three replicas.  The post-warm-up
               sentry (``analysis/jitcheck.py``) is marked after the
               warm-up: the window must build nothing and make no
               allocator retry, device allocation or pinned allocation.
8b. pipeline — the launch pipeline's contracts (tests/test_pipeline.py:
               F1 fence, F2 parity, F3 exactly-once, W1 one readback window
               a generation) on the colocated path at the engine's default
               depth 2 and fused waves of 3, the sync floor off: (a) the
               colocated phase's layout (1,000 shards x 3, capacity 4,096,
               tan WAL) with ``AuditKV``, 8 workers x 8 in-flight proposals a
               shard for 20 s, the hostplane parity oracle armed and the
               reference's fence probe on the core; every acknowledged key
               applied exactly once on every replica, fused waves, overlap,
               lane rows, a clean close, every kernel of the path launched;
               (b) the reference's scripted cases on the card at their own
               geometry (depth 1 serial, the escalation hold, the
               stop_shard/detach fence, the depth-2 escalation), the probe
               on every core; ``tests/port_loader.py`` executes
               ``tests/test_pipeline.py`` with the port's modules.
8c. scale    — the reference's scale path (tests/test_scale.py's
               ``run_scale``, executed on the port by
               ``tests/port_loader.py``) on ONE
               ``ColocatedEngineGroup(device="cuda")``, on-disk state
               machines, capacity = pow2(rows), W=16, M=8, E=2, O=32,
               budget 8, rtt 50 ms, parity self-check every 20th launch:
               (a) BASELINE config 3, 2,000 shards x 5 replicas on 5
               NodeHosts (P = 5, capacity 16,384; ``--scale-shards N``
               sets the count, 10,000 is the config's own), 100 sampled
               proposals, 5 leader kills, cold where the shard parks;
               (b) config 4's ragged 3/5/7 memberships, 1,050 shards on 7
               NodeHosts (P = 7, capacity 8,192), 2 kills.  The
               reference's gates (coverage >= 98%, committed >= 90%,
               every kill re-elected, no leaked future) and the port's
               (no divergence halt, every parity check passed, every
               path kernel launched, no engine error).  Leg (a) arms the
               post-warm-up sentry (``analysis/jitcheck.py``): marked
               when the propose window opens, after the election storm;
               no build or allocator retry after the mark, no device or
               pinned allocation in the propose window; the storm's and
               the churn's counts are reported.
9. mesh_engines — both engines' ``mesh=`` modes on ``GroupsMesh([cuda:0]
               * 4)``: (a) the colocated phase's drive for 10 s; (b) the
               same engine at 1,365 shards x 3 = 4,095 rows for 5 s, shards
               straddling the blocks, with the lane's gates (sent and
               delivered above 0, no lane drop); (c) the nodehost layout on
               ``torch_step_engine_factory(mesh=...)``, the writes begun in
               10 s; (d) the lane pack with the colocated operands (alive
               lane, delivered bits, undelivered word) bit-exact against its
               plain version at leg 2's geometry, timed beside the pack
               without them (``--only mesh_pack`` runs (d) alone).  On four
               visible cards (a) runs again, a block a card.
10. audit    — the reference's audited churn round (tests/test_audit.py:560,
               docs/AUDIT.md) on the colocated path: 256 shards x 3
               replicas on three NodeHosts sharing ONE
               ``ColocatedEngineGroup(device="cuda")`` (capacity 1,024,
               the colocated phase's geometry, tan WAL, ``AuditKV``); the
               nemesis churns a seeded sample of 6 shards (leader kills, a
               leadership transfer, a membership cycle, one ``Balancer``
               move onto a fourth host, a 4 s window of forced kernel
               escalations at p=0.08) under two ``AuditClient``s a shard
               for 30 s; every sampled history linearizable, sessions
               exactly-once, every churn event inside its recovery SLA,
               journals settled, no leaked future.  Then a ``Gateway``
               drives one sampled shard (lease reads recorded as stale
               ops), its leader's host is killed, and no stale read, a new
               leader and a write after the kill are required.
11. registry — every entry of the port's program registry
               (dragonboat_tpu_torch/ops/registry.py, the reference's 21
               program names) at its canonical geometry, held bit-exact on
               the card against its plain version; the mesh pair on
               ``GroupsMesh([cuda:0] * 4)``; each entry launches exactly the
               bindings it names, and no binding or ``__global__`` under
               csrc/ is left unreached.
12. day      — the reference's tier-1 production day
               (tests/test_scenario.py:455-517) on the port:
               ``ScenarioRunner(DayPlan.mini(11), colocated=True)``, six
               hosts, an on-disk and an in-memory shard, a witness, a
               non-voting laggard, every disturbance class, the DR cycle and
               the elastic loop, with host h2's replicas stepping on ONE
               ``ColocatedEngineGroup(**COLO_GEOM)`` on the card (parity
               self-check every 20th launch); the reference's gates, the
               colocated path's every kernel launched (read from the
               registry); then that member's whole-host kill and restart
               onto the live group (seed 5) and ``run_rpc_smoke(n=2)``
               through the port's worker processes; a line with the day's
               ledger and the card's name and power limit.
13. graft    — the port's graft entry (dragonboat_tpu_torch/graft_entry.py,
               the reference's __graft_entry__.py): ``entry()``'s step on
               the card bit-exact against the plain path on the CPU, then
               ``dryrun_multichip(4)`` on ``GroupsMesh([cuda:0] * 4)``: the
               sharded step (32 rows), 64 routed rounds (32 groups x 3,
               P=3, W=16, E=2, O=16, budget 4) and three NodeHosts on one
               mesh ``ColocatedEngineGroup`` (capacity 16, 5 shards
               reaching the last block), every postcondition of the
               reference's; a line with each kernel's launches and the
               card's name and power limit.
14. analysis — ``analysis/devicecheck.py`` on the card: every registry
               entry's dtype, donation and G-last on CUDA tensors, each
               all-device entry under ``set_sync_debug_mode("error")``,
               and the spill rule over the loaded module's ptxas report
               (kept per source under ``_build/ptxas/``, so a re-run on a
               built checkout reads it too; a line with every
               ``__global__``'s registers, stack, spills and static
               shared memory); a finding beyond
               ``analysis/device_baseline.txt`` fails the run.
Each path's kernel launch counts are reset just before it and read just
after; every kernel of the path must have run.  The engines re-run some
launches (and every row move) through the plain versions: every such
check begun must have passed, and the engines' workers must have logged
no error.

Then a line with every kernel's numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero and prints no result line.
"""
from __future__ import annotations

import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np

# kernel-phase geometry: the engine's defaults at 10k groups x 3 replicas
G_KERNELS = 30_000
P, W, M, E, O = 5, 32, 8, 4, 32
SEED = 20260917


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


try:
    # the seeded kernel-phase inputs (main() says so where the port is
    # not importable)
    from dragonboat_tpu_torch.ops.fuzz import (
        cluster_state_np, fuzz_inbox_np, padded_cluster_np, route_np,
    )
except ImportError:
    pass


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

KERNEL_INFO = {
    "raft_step": dict(
        source="dragonboat_tpu_torch/csrc/raft_step.cu",
        replaces="dragonboat_tpu/ops/kernel.py:1652",
        also_replaces=["dragonboat_tpu/ops/kernel.py:1574",
                       "dragonboat_tpu/ops/kernel.py:1340"],
    ),
    "summarize_flags": dict(
        source="dragonboat_tpu_torch/csrc/flags.cu",
        replaces="dragonboat_tpu/ops/engine.py:194",
        also_replaces=[],
    ),
    "gather_pack": dict(
        source="dragonboat_tpu_torch/csrc/gather_pack.cu",
        replaces="dragonboat_tpu/ops/engine.py:273",
        also_replaces=["dragonboat_tpu/ops/engine.py:248",
                       "dragonboat_tpu/ops/engine.py:315"],
    ),
    "place_rows": dict(
        source="dragonboat_tpu_torch/csrc/place_rows.cu",
        replaces="dragonboat_tpu/ops/engine.py:163",
        also_replaces=["dragonboat_tpu/ops/engine.py:180",
                       "dragonboat_tpu/ops/engine.py:189",
                       "dragonboat_tpu/ops/engine.py:400",
                       "dragonboat_tpu/ops/colocated.py:441"],
    ),
}

# the in-place escalation merge (csrc/place_rows.cu): the jnp.where of
# the colocated and routed rounds' tails
MERGE_INFO = dict(
    source="dragonboat_tpu_torch/csrc/place_rows.cu",
    replaces="dragonboat_tpu/ops/colocated.py:215",
    also_replaces=["dragonboat_tpu/ops/route.py:431"],
)

# the colocated path's kernels (csrc/inbox.cu has three entry points;
# its row in the result line is the per-round work of the main path,
# from_ticks + assemble, with each entry's numbers beside it)
COLO_KERNEL_INFO = {
    "route": dict(
        entries=("route",),
        source="dragonboat_tpu_torch/csrc/route.cu",
        replaces="dragonboat_tpu/ops/route.py:131",
        also_replaces=["dragonboat_tpu/ops/route.py:395",
                       "dragonboat_tpu/ops/route.py:431",
                       "dragonboat_tpu/ops/route.py:475",
                       "dragonboat_tpu/ops/route.py:500",
                       "dragonboat_tpu/ops/colocated.py:215"],
    ),
    "inbox": dict(
        entries=("host_inbox_from_ticks", "assemble_inbox"),
        source="dragonboat_tpu_torch/csrc/inbox.cu",
        replaces="dragonboat_tpu/ops/colocated.py:175",
        also_replaces=["dragonboat_tpu/ops/colocated.py:199",
                       "dragonboat_tpu/ops/colocated.py:411",
                       "dragonboat_tpu/ops/colocated.py:399"],
    ),
    "select_and_blob": dict(
        entries=("select_and_blob",),
        source="dragonboat_tpu_torch/csrc/select_blob.cu",
        replaces="dragonboat_tpu/ops/colocated.py:285",
        also_replaces=[],
    ),
}
# the entry points the colocated kernels phase holds and times
COLO_ENTRIES = ("route", "assemble_inbox", "host_inbox_from_ticks",
                "zero_inbox_rows", "select_and_blob")


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median per-call device time of ``fn`` in ms (CUDA events around
    each call, after ``warm`` untimed calls)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 20):
    """Device time per call of ``fn`` in ms: the sum of the CUDA kernel,
    memset and copy durations that ``torch.profiler`` records over
    ``reps`` calls, divided by ``reps`` — the kernels alone, without the
    host's enqueue gaps that CUDA events around one short launch also
    see.  None when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def ptxas_by_kernel(log: str) -> dict:
    """{kernel: registers, stack frame, spill stores and loads, static
    shared memory} of each ``__global__`` in the build's ptxas report
    (``devicecheck.ptxas_table``, which takes the names from the
    registry)."""
    from dragonboat_tpu_torch.analysis import devicecheck

    keys = ("regs", "stack", "spill_stores", "spill_loads", "static_smem")
    return {r["kernel"]: {k: r[k] for k in keys}
            for r in devicecheck.ptxas_table(log)}


def kernel_split(fn, reps: int = 20) -> dict:
    """Device ms per call of ``fn``, kernel by kernel: the profiler's
    CUDA kernel, memset and copy durations over ``reps`` calls, summed by
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"\w+_kernel", e.name)
        name = m.group(0) if m else e.name
        us[name] = us.get(name, 0.0) + e.time_range.elapsed_us()
    return {k: v / reps / 1e3 for k, v in sorted(us.items())}


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def lane_pack_work(out, xbuf) -> dict:
    """What ``xlane_pack`` must read of this run's inputs: the valid
    outbox slots of the unsuppressed rows, the rows holding one, and the
    ring words (term, cc) of the entries the packed REPLICATEs carry,
    read from the packed rows of ``xbuf`` [D, XB, KT]."""
    import torch

    from dragonboat_tpu_torch.ops import route_ref
    from dragonboat_tpu_torch.ops import types as T

    KT = xbuf.shape[2]
    n_valid = torch.where(out.escalate == 0,
                          out.count.clamp(0, out.buf.shape[1]),
                          torch.zeros_like(out.count))
    packed = xbuf.reshape(-1, KT)
    carried = ((packed[:, route_ref.XI_FOUND] != 0)
               & (packed[:, 0] == T.MT_REPLICATE))
    E_ = (KT - route_ref.X_KF) // 2
    return dict(pack_valid_slots=int(n_valid.sum()),
                pack_live_rows=int((n_valid > 0).sum()),
                pack_ring_words=2 * int(packed[carried, 8].clamp(0, E_).sum()))


def lane_pack_bound_ms(out, xbuf, P_: int) -> float:
    """``xlane_pack``'s bound at this run's inputs, the least it must
    move: ``lane_pack_work``'s valid slots (11 words each) and ring
    words; every row's count and suppress words; the peer ids, the three
    tables and the three row scalars of each row with a valid slot; and
    the D-1 blocks of ``xbuf`` that the ring shifts send (the own block
    is never sent)."""
    from dragonboat_tpu_torch.ops import types as T

    D, XB, KT = xbuf.shape
    w = lane_pack_work(out, xbuf)
    return bound_ms(4 * (
        w["pack_valid_slots"] * T.N_FIELDS + 2 * out.count.numel()
        + w["pack_live_rows"] * (4 * P_ + 3) + w["pack_ring_words"]
        + (D - 1) * XB * KT))


def route_bound_ms(out, delivered, P_: int, M_: int, E_: int, *,
                   bits: bool) -> float:
    """``route``'s bound at this run's inputs: the valid messages (11
    words each); each row's count, suppress word, alive word and four
    row scalars; the peer ids and the two tables; the ring words (term,
    cc) of the REPLICATE entries delivered; the inbox it writes
    (G*M*(10+2E) words) and, with ``bits``, the packed delivered bits
    and the undelivered word."""
    import torch

    from dragonboat_tpu_torch.ops import types as T

    G, O_ = out.buf.shape[:2]
    n_msgs = int(out.count.clamp(0, O_).sum())
    repl_ents = int(torch.where(
        delivered & (out.buf[:, :, T.F_MTYPE] == T.MT_REPLICATE),
        out.buf[:, :, T.F_N_ENTRIES].clamp(0, E_), 0).sum())
    words = (n_msgs * T.N_FIELDS + G * (1 + 4 + 2) + G * P_ * 3
             + 2 * repl_ents + G * M_ * (10 + 2 * E_))
    if bits:
        words += G * ((O_ + 31) // 32) + G
    return bound_ms(4 * words)


def step_bound_ms(st, ib, out, E_: int) -> float:
    """The raft step's bound at this run's inputs: the state in and out,
    the slot types, the other words of the occupied slots (9 + 2E each)
    and every output, once each, over the card's memory rate."""
    occ = int((ib.mtype != 0).sum())
    words = (sum(t.numel() for t in st) * 2 + ib.mtype.numel()
             + occ * (9 + 2 * E_) + sum(t.numel() for t in out))
    return bound_ms(4 * words)


def _max_err(got, want) -> int:
    """Largest |kernel - plain| over tensors (0 when bit-equal); a shape
    or dtype mismatch raises."""
    err = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype differ: {a.shape} {b.shape}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version at G = 30,000
# ---------------------------------------------------------------------------
def kernels_phase(dev, G: int = G_KERNELS, n_routed: int = 40,
                  n_fuzz: int = 10) -> dict:
    import torch

    from dragonboat_tpu_torch.ops import convert, engine_ref, kernel_ref
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import plumbing
    from dragonboat_tpu_torch.ops import types as T
    from dragonboat_tpu_torch.ops.engine import (
        _build_idx4, _pad_idx, _pos_map,
    )

    rng = np.random.default_rng(SEED)
    errs = {k: 0 for k in KERNEL_INFO}
    checks = {k: 0 for k in KERNEL_INFO}

    def check(name, got, want):
        errs[name] = max(errs[name], _max_err(got, want))
        checks[name] += 1

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def plumbing_checks(old, new, out, ib_np):
        flags = plumbing.summarize_flags(old, new, out)
        check("summarize_flags", [flags],
              [engine_ref.summarize_flags(old, new, out)])
        f = flags.cpu().numpy()
        live = np.nonzero(f & T.F_ESC == 0)[0]
        buf_rows = [g for g in live if f[g] & T.F_COUNT]
        app_rows = [g for g in live if f[g] & T.F_APPEND]
        need_rows = [g for g in live if f[g] & T.F_NEED_SS]
        slot_rows = [g for g in live
                     if (ib_np["mtype"][g] == T.MT_PROPOSE).any()]
        sum_rows = [g for g in live if f[g] & T.F_ANY_LIVE]
        idx4 = _build_idx4(buf_rows, slot_rows, need_rows, app_rows)
        i4 = None if idx4 is None else put(idx4)
        isum = put(_pad_idx(sum_rows)) if sum_rows else None
        for a, b in ((i4, isum), (i4, None), (None, isum)):
            if a is None and b is None:
                continue
            check("gather_pack", [plumbing.gather_pack(new, out, a, b)],
                  [engine_ref.gather_pack(new, out, a, b)])
        # rows: gather a padded sub-batch, scatter it back, select
        gs = sorted(rng.choice(G, size=min(G, 1024), replace=False).tolist())
        idx = put(_pad_idx(gs))
        sub = plumbing.place_rows(None, list(new), idx)
        check("place_rows", sub, engine_ref.place_rows(None, list(new), idx))
        pos = put(_pos_map(G, gs))
        check("place_rows", plumbing.place_rows(list(old), sub, pos),
              engine_ref.place_rows(list(old), sub, pos))
        keep = put(np.where(f & T.F_ESC == 0, np.arange(G), -1))
        check("place_rows", plumbing.place_rows(list(old), list(new), keep),
              engine_ref.place_rows(list(old), list(new), keep))
        pairs = rng.choice(G, size=3, replace=False).tolist()
        gi = put(_pad_idx(pairs))
        pi = put(_pad_idx(rng.integers(0, P, 3).tolist()))
        si = put(_pad_idx(rng.integers(1, 99, 3).tolist()))
        check("place_rows",
              plumbing.set_remote_snapshot(new.rstate, new.snap_index,
                                           gi, pi, si),
              engine_ref.set_remote_snapshot(new.rstate, new.snap_index,
                                             gi, pi, si))
        return dict(idx4=i4, isum=isum, sub=sub, pos=pos)

    st_np = cluster_state_np(G, P, W, SEED)
    st = convert.state_from_numpy(st_np, dev)
    out_np = {"buf": np.zeros((G, O, T.N_FIELDS), np.int32),
              "count": np.zeros((G,), np.int32)}
    escalations = 0
    for _ in range(n_routed):
        ib_np = route_np(st_np, out_np, rng, M, E)
        ib = convert.inbox_from_numpy(ib_np, dev)
        new, out = K.step(st, ib, O)
        rnew, rout = kernel_ref.step(st, ib, O)
        check("raft_step", list(new) + list(out), list(rnew) + list(rout))
        last = (st, ib, ib_np, new, out)
        plumbing_checks(st, new, out, ib_np)
        st = new
        st_np, out_np = convert.to_numpy(new), convert.to_numpy(out)
        escalations += int((out_np["escalate"] != 0).sum())
    routed = dict(
        groups=G // 3,
        leaders=int((st_np["role"] == T.ROLE_LEADER).sum()),
        rows_committed=int((st_np["committed"] >= 1).sum()),
        max_committed=int(st_np["committed"].max()),
        escalations=escalations,
    )
    fuzz_esc = 0
    for _ in range(n_fuzz):
        ib_np = fuzz_inbox_np(st_np, rng, M, E)
        ib = convert.inbox_from_numpy(ib_np, dev)
        new, out = K.step(st, ib, O)
        rnew, rout = kernel_ref.step(st, ib, O)
        check("raft_step", list(new) + list(out), list(rnew) + list(rout))
        plumbing_checks(st, new, out, ib_np)
        fuzz_esc += int((out.escalate != 0).sum())
    small = {k: small_grid_step(dev, **g) for k, g in SMALL_GRIDS.items()}
    for v in small.values():
        errs["raft_step"] = max(errs["raft_step"], v["max_abs_err"])
        checks["raft_step"] += v["checks"]
    place = place_rows_modes(dev)
    errs["place_rows"] = max(errs["place_rows"],
                             place["max_abs_err"]["place_rows"])
    checks["place_rows"] += place["checks"]["place_rows"]
    errs["merge_escalated"] = place["max_abs_err"]["merge_escalated"]
    checks["merge_escalated"] = place["checks"]["merge_escalated"]
    result = dict(routed_steps=n_routed, fuzz_steps=n_fuzz, rows=G,
                  routed=routed, fuzz_escalations=fuzz_esc,
                  checks=checks, max_abs_err=errs,
                  rows_per_block=K.rows_per_block(G, P, W, M, E, O),
                  small_grids=small, place_modes=place["timed"])
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    # the seeded cluster must really have elected and committed (a few
    # groups may still be mid-election after n_routed steps)
    if routed["leaders"] < 0.95 * (G // 3) or routed["rows_committed"] < 0.9 * G:
        raise AssertionError(f"routed cluster did not converge: {routed}")

    # ---- time each kernel on the last routed step's inputs -------------
    st0, ib, ib_np, new, out = last
    sets = plumbing_checks(st0, new, out, ib_np)
    i4, isum, sub, pos = sets["idx4"], sets["isum"], sets["sub"], sets["pos"]
    ms, plain_ms, bound, lib_ms = {}, {}, {}, {}
    ms["raft_step"] = time_ms(lambda: K.step(st0, ib, O), 20)
    plain_ms["raft_step"] = time_ms(lambda: kernel_ref.step(st0, ib, O), 3, 1)
    bound["raft_step"] = step_bound_ms(st0, ib, out, E)
    lib_ms["raft_step"] = None

    ms["summarize_flags"] = time_ms(
        lambda: plumbing.summarize_flags(st0, new, out), 50)
    plain_ms["summarize_flags"] = time_ms(
        lambda: engine_ref.summarize_flags(st0, new, out), 5)
    words = G * (12 + 2 + 3 + 5 * P + 1)
    bound["summarize_flags"] = bound_ms(4 * words)
    lib_ms["summarize_flags"] = None

    ms["gather_pack"] = time_ms(
        lambda: plumbing.gather_pack(new, out, i4, isum), 50)
    plain_ms["gather_pack"] = time_ms(
        lambda: engine_ref.gather_pack(new, out, i4, isum), 5)
    b = 0 if i4 is None else i4.shape[1]
    b2 = 0 if isum is None else isum.shape[0]
    K_ = O * T.N_FIELDS + 2 * M + M * E + P + 2 * W
    bound["gather_pack"] = bound_ms(4 * (2 * (b * K_ + b2 * T.N_VALS)
                                         + 4 * b + b2))
    lib_ms["gather_pack"] = None

    ms["place_rows"] = time_ms(
        lambda: plumbing.place_rows(list(st0), sub, pos), 50)
    plain_ms["place_rows"] = time_ms(
        lambda: engine_ref.place_rows(list(st0), sub, pos), 5)
    width = sum(int(np.prod(t.shape[1:])) for t in st0)
    bound["place_rows"] = bound_ms(4 * (2 * G * width + G))
    # the library yardstick: one out-of-place index_copy per field (no
    # single call covers the 31 fields); pos maps the sorted rows gidx to
    # sub rows 0..n-1
    gidx = torch.nonzero(pos >= 0)[:, 0]
    n = gidx.numel()
    lib_ms["place_rows"] = time_ms(
        lambda: [d.index_copy(0, gidx, s[:n]) for d, s in zip(st0, sub)], 20)
    dev_ms = {
        "raft_step": device_ms(lambda: K.step(st0, ib, O)),
        "summarize_flags": device_ms(
            lambda: plumbing.summarize_flags(st0, new, out)),
        "gather_pack": device_ms(
            lambda: plumbing.gather_pack(new, out, i4, isum)),
        "place_rows": device_ms(
            lambda: plumbing.place_rows(list(st0), sub, pos)),
    }
    place_split = kernel_split(
        lambda: plumbing.place_rows(list(st0), sub, pos))
    result.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                  library_ms=lib_ms, gather_rows=[b, b2], scatter_rows=n,
                  place_rows_split=place_split)
    return result


# place_rows' modes and the in-place merge: the kernels phase's 30,000
# rows, the NodeHost engine's capacity, and multichip leg 2's block
# (150,000 rows on 4 blocks)
PLACE_GEOMS = {
    "C30000": (30_000, 5, 32),
    "G512": (512, 5, 32),
    "X37500": (37_500, 3, 16),
}


def place_rows_modes(dev) -> dict:
    """Every mode of ``place_rows`` and the in-place escalation merge
    bit-exact against the plain versions on seeded state-shaped fields
    at each of ``PLACE_GEOMS``: scatter with a dst, gather without one,
    select, the escalation select (rows mode keeping old where escalate
    is nonzero), the in-place merge at 0, 3 and about 10% escalated rows,
    and the snapshot store.  Then, at
    30,000 rows and at leg 2's block, each mode timed (CUDA events, the
    profiler's device time and split by kernel) beside its bound."""
    import torch

    from dragonboat_tpu_torch.ops import engine_ref, plumbing
    from dragonboat_tpu_torch.ops import types as T

    err = {"place_rows": 0, "merge_escalated": 0}
    checks = {"place_rows": 0, "merge_escalated": 0}

    def check(name, got, want):
        err[name] = max(err[name], _max_err(got, want))
        checks[name] += 1

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    timed = {}
    for gname, (G, P_, W_) in PLACE_GEOMS.items():
        rng = np.random.default_rng([SEED, G, 6])
        shapes = [tuple(t.shape)
                  for t in T.make_state(G, P_, W_, device="cpu")]

        def fields(n):
            return [put(rng.integers(-999, 999, (n,) + s[1:]))
                    for s in shapes]

        old, new = fields(G), fields(G)
        width = sum(int(np.prod(s[1:])) for s in shapes)
        n_sub = min(G, 1024)
        sub = fields(n_sub)
        rows = rng.choice(G, size=n_sub, replace=False)
        pos_np = np.full(G, -1, np.int32)
        pos_np[np.sort(rows)] = np.arange(n_sub)
        pos = put(pos_np)
        check("place_rows", plumbing.place_rows(old, sub, pos),
              engine_ref.place_rows(old, sub, pos))
        idx = put(rng.integers(0, G + 2, n_sub))
        check("place_rows", plumbing.place_rows(None, new, idx),
              engine_ref.place_rows(None, new, idx))
        keep = put(np.where(rng.random(G) < 0.9, np.arange(G), -1))
        check("place_rows", plumbing.place_rows(old, new, keep),
              engine_ref.place_rows(old, new, keep))
        escs = {}
        for ename, frac in (("0", 0.0), ("3", None), ("10pct", 0.1)):
            e = np.where(rng.random(G) < (frac or 0.0),
                         rng.integers(1, 16, G), 0)
            if frac is None:
                e[rng.choice(G, size=3, replace=False)] = 4
            escs[ename] = put(e)
        for ename, esc in escs.items():
            # the escalation select in rows mode: old where escalate != 0
            esc_pos = torch.where(esc != 0, -1, torch.arange(
                G, dtype=torch.int32, device=dev))
            check("place_rows", plumbing.place_rows(old, new, esc_pos),
                  engine_ref.select_escalated(esc, old, new))
            merged = [t.clone() for t in new]
            got = plumbing.merge_escalated(esc, old, merged)
            check("merge_escalated", got,
                  engine_ref.select_escalated(esc, old, new))
        pairs = rng.choice(G, size=3, replace=False).tolist()
        gi, pi = put(pairs), put(rng.integers(0, P_, 3))
        si = put(rng.integers(1, 99, 3))
        rstate = new[T.DeviceState._fields.index("rstate")]
        snap_index = new[T.DeviceState._fields.index("snap_index")]
        check("place_rows",
              plumbing.set_remote_snapshot(rstate, snap_index, gi, pi, si),
              engine_ref.set_remote_snapshot(rstate, snap_index, gi, pi, si))
        if gname == "G512":
            continue
        # the modes timed: rows mode as the engine scatters a sub-batch,
        # gathers and selects, and the in-place merge (on a scratch
        # copy of new: a merge leaves it merged, and the next call finds
        # the same escalated rows to copy)
        scratch = [t.clone() for t in new]
        modes = {
            "scatter": (lambda: plumbing.place_rows(old, sub, pos),
                        4 * (2 * G * width + G)),
            "gather": (lambda: plumbing.place_rows(None, new, idx),
                       4 * (2 * n_sub * width + n_sub)),
            "select": (lambda: plumbing.place_rows(old, new, keep),
                       4 * (2 * G * width + G)),
        }
        for ename, esc in escs.items():
            n_esc = int((esc != 0).sum())
            modes[f"merge_{ename}"] = (
                lambda esc=esc: plumbing.merge_escalated(esc, old, scratch),
                4 * (G + 2 * n_esc * width))
        res = {}
        for mname, (fn, nbytes) in modes.items():
            res[mname] = dict(
                ms=time_ms(fn, 50), device_ms=device_ms(fn),
                split=kernel_split(fn), bound_ms=bound_ms(nbytes))
        res["merge_0"]["plain_ms"] = time_ms(
            lambda: engine_ref.merge_escalated(escs["0"], old, scratch), 5)
        res["scatter"]["plain_ms"] = time_ms(
            lambda: engine_ref.place_rows(old, sub, pos), 5)
        timed[gname] = dict(rows=G, P=P_, W=W_, row_words=width,
                            n_sub=n_sub,
                            escalated={k: int((v != 0).sum())
                                       for k, v in escs.items()},
                            modes=res)
    return dict(max_abs_err=err, checks=checks, timed=timed)


# the engines' small grids: the NodeHost engine's capacity at its widths,
# and the colocated engine's (P=3, W=16, assembled M = 3 * 4 + 8)
SMALL_GRIDS = {
    "G512": dict(G=512, P=5, W=32, M=8, E=4, O=32),
    "G4096": dict(G=4096, P=3, W=16, M=20, E=4, O=32),
}


def small_grid_step(dev, G, P, W, M, E, O, n_routed: int = 16,
                    n_fuzz: int = 4) -> dict:
    """``raft_step`` bit-exact against its plain version at a small grid
    (a padded seeded cluster through routed steps, then fuzz inboxes),
    then timed on the last routed step's inputs and on a fuzz inbox."""
    from dragonboat_tpu_torch.ops import convert, kernel_ref
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import types as T

    rng = np.random.default_rng(SEED + G)
    st_np = padded_cluster_np(G, P, W, SEED + G)
    st = convert.state_from_numpy(st_np, dev)
    out_np = {"buf": np.zeros((G, O, T.N_FIELDS), np.int32),
              "count": np.zeros((G,), np.int32)}
    err = checks = 0
    for k in range(n_routed + n_fuzz):
        ib_np = (route_np(st_np, out_np, rng, M, E) if k < n_routed
                 else fuzz_inbox_np(st_np, rng, M, E))
        ib = convert.inbox_from_numpy(ib_np, dev)
        new, out = K.step(st, ib, O)
        rnew, rout = kernel_ref.step(st, ib, O)
        err = max(err, _max_err(list(new) + list(out),
                                list(rnew) + list(rout)))
        checks += 1
        if k == n_routed - 1:
            routed = (st, ib, out)
        if k < n_routed:
            st = new
            st_np, out_np = convert.to_numpy(new), convert.to_numpy(out)
    fuzz = (st, ib, out)
    res = dict(rows=G, P=P, W=W, M=M, E=E, O=O, checks=checks,
               max_abs_err=err,
               rows_per_block=K.rows_per_block(G, P, W, M, E, O),
               leaders=int((st_np["role"] == T.ROLE_LEADER).sum()))
    for name, (s0, i0, o0) in (("routed", routed), ("fuzz", fuzz)):
        res[name] = dict(
            ms=time_ms(lambda: K.step(s0, i0, O), 20),
            device_ms=device_ms(lambda: K.step(s0, i0, O)),
            plain_ms=time_ms(lambda: kernel_ref.step(s0, i0, O), 3, 1),
            bound_ms=step_bound_ms(s0, i0, o0, E),
            occupied_slots=int((i0.mtype != 0).sum()))
    return res


# ---------------------------------------------------------------------------
# phase 2b: the colocated path's kernels against their plain versions
# ---------------------------------------------------------------------------
BUDGET_K = 4   # route budget of the kernel phase
M_HOST_K = 8   # host slots of the assembled inbox (M = P*B + 8)


def colocated_kernels_phase(dev, G: int = G_KERNELS, waves: int = 12) -> dict:
    """``route``, the three ``inbox`` entry points and ``select_and_blob``
    at G = 30,000 rows (P=5, W=32, E=4, O=32, budget 4, assembled inbox
    M = P*B + 8, the fixed capacity tiers), each bit-exact against its
    plain version on states advanced by the port's own ``fused_rounds``
    over ``build_route_tables`` of the 10k x 3 layout; then each timed
    per launch with CUDA events."""
    import torch

    from dragonboat_tpu_torch.ops import colocated as C
    from dragonboat_tpu_torch.ops import colocated_ref as CR
    from dragonboat_tpu_torch.ops import convert
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import route_ref
    from dragonboat_tpu_torch.ops import types as T

    B, MH = BUDGET_K, M_HOST_K
    PB = P * B
    rng = np.random.default_rng(SEED + 2)
    names = list(COLO_ENTRIES) + ["fused_rounds", "route_step"]
    errs = {k: 0 for k in names}
    checks = {k: 0 for k in names}

    def check(name, got, want):
        errs[name] = max(errs[name], _max_err(got, want))
        checks[name] += 1

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    st_np = cluster_state_np(G, P, W, SEED + 1)
    shard = np.arange(G) // 3 + 1
    rid = np.arange(G) % 3 + 1
    dest_np, rank_np = R.build_route_tables(shard, rid, st_np["peer_id"])
    dest, rank = put(dest_np), put(rank_np)
    st = convert.state_from_numpy(st_np, dev)
    inbox = route_ref.make_prefill(st, MH + PB, E)
    delivered = 0
    for w in range(waves):
        kw = dict(rounds=3, out_capacity=O, budget=B, base=MH,
                  propose_leaders=w >= waves // 2)
        new_st, new_ib, stats, n_esc = R.fused_rounds(
            st, inbox, dest, rank, **kw)
        if w in (0, waves - 1):
            r = route_ref.fused_rounds(st, inbox, dest, rank, **kw)
            check("fused_rounds", list(new_st) + list(new_ib) + [stats, n_esc],
                  list(r[0]) + list(r[1]) + [r[2], r[3]])
        delivered += int(stats[:, 0].sum())
        st, inbox = new_st, new_ib
    st_fin = convert.to_numpy(st)
    cluster = dict(
        groups=G // 3, waves=waves, rounds=3 * waves,
        routed_delivered=delivered,
        leaders=int((st_fin["role"] == T.ROLE_LEADER).sum()),
        rows_committed=int((st_fin["committed"] >= 1).sum()),
        max_committed=int(st_fin["committed"].max()),
    )

    # one colocated launch on those states: combo, host region, assemble,
    # step, the route tail, the readback blobs, an eviction's zeroing
    combo_np = np.zeros((G, 4), np.int32)
    combo_np[:, C._C_ALIVE] = rng.random(G) < 0.97
    combo_np[:, C._C_BATCH] = rng.random(G) < 0.5
    combo_np[:, C._C_PROP] = rng.random(G) < 0.1
    combo_np[:, C._C_TICKS] = rng.integers(0, 4, G)
    combo = put(combo_np)
    pending = T.Inbox(*(f[:, MH:].contiguous() for f in inbox))
    host = C._host_inbox_from_ticks(combo, M=MH, E=E)
    check("host_inbox_from_ticks", list(host),
          list(CR.host_inbox_from_ticks(combo, M=MH, E=E)))
    full = C._assemble_inbox(host, pending, combo)
    check("assemble_inbox", list(full),
          list(CR.assemble_inbox(host, pending, combo)))
    new, out = K.step(st, full, O)
    # _route_step consumes new (the in-place merge): the plain version
    # gets a copy
    new_ref = T.DeviceState(*(t.clone() for t in new))
    tail = C._route_step(st, new, out, dest, rank, combo, PB=PB, E=E,
                         budget=B)
    want = CR.route_step(st, new_ref, out, dest, rank, combo, PB=PB, E=E,
                         budget=B)
    check("route_step", C._tensors(tail), C._tensors(want))
    merged, regions, stats6, packed, flags = tail
    esc = out.escalate != 0
    alive = combo[:, C._C_ALIVE] != 0
    got = R.route(merged, out, dest, rank, M=PB, E=E, budget=B, base=0,
                  suppress=esc, dest_alive=alive)
    ref = route_ref.route(merged, out, dest, rank, M=PB, E=E, budget=B,
                          base=0, suppress=esc, dest_alive=alive)
    check("route", list(got[0]) + [torch.stack(list(got[1])), got[2]],
          list(ref[0]) + [ref[1], ref[2]])
    route_deliv = got[2]
    sel_counts = {}
    for t in range(len(C._SEL_TIERS)):
        caps = {k: min(G, v) for k, v in C._SEL_TIERS[t].items()}
        kw = dict(CAP_B=caps["b"], CAP_SL=caps["sl"], CAP_N=caps["n"],
                  CAP_A=caps["a"], CAP_S=caps["s"], HOST_OFF=PB)
        got = C._select_and_blob(merged, out, stats6, packed, flags, combo,
                                 **kw)
        check("select_and_blob", list(got),
              list(CR.select_and_blob(merged, out, stats6, packed, flags,
                                      combo, **kw)))
        if t == 0:
            nw = (O + 31) // 32
            sel_counts = dict(zip(
                ("buf", "slot", "need", "append", "sum"),
                got[0][G + G * nw + 6:G + G * nw + 11].tolist()))
    # a storm: every row live and selected in every section, so that the
    # counts exceed the first tiers' capacities; and the colocated
    # engine's capacity (G = 4,096, P=3, W=16) on random flags and lanes
    storm_flags = torch.full_like(flags, T.F_ANY_LIVE)
    storm_combo = combo.clone()
    storm_combo[:, :3] = 1
    sel_cases = {"storm": (merged, out, stats6, packed, storm_flags,
                           storm_combo, PB)}
    c4s = colo_route_case(dev, 4096, 3, 16)
    r4 = np.random.default_rng(SEED + 4)
    G4 = 4096
    sel_cases["G4096"] = (
        c4s["merged"], c4s["out"], put(r4.integers(-99, 99, 6)),
        put(r4.integers(-2**31, 2**31 - 1, (G4, (O + 31) // 32))),
        put(r4.integers(0, 128, G4)),
        put(np.concatenate([r4.random((G4, 3)) < (0.9, 0.4, 0.15),
                            r4.integers(0, 4, (G4, 1))], axis=1)),
        c4s["PB"])
    for cname, (m_, o_, s_, p_, f_, c_, hoff) in sel_cases.items():
        Gc = f_.shape[0]
        for t in range(len(C._SEL_TIERS)):
            caps = {k: min(Gc, v) for k, v in C._SEL_TIERS[t].items()}
            kw = dict(CAP_B=caps["b"], CAP_SL=caps["sl"], CAP_N=caps["n"],
                      CAP_A=caps["a"], CAP_S=caps["s"], HOST_OFF=hoff)
            check("select_and_blob",
                  list(C._select_and_blob(m_, o_, s_, p_, f_, c_, **kw)),
                  list(CR.select_and_blob(m_, o_, s_, p_, f_, c_, **kw)))
    storm_counts = C._select_and_blob(
        *sel_cases["storm"][:6], CAP_B=16, CAP_SL=64, CAP_N=8, CAP_A=64,
        CAP_S=1024, HOST_OFF=PB)[0][G + G * ((O + 31) // 32) + 6:
                                     G + G * ((O + 31) // 32) + 11].tolist()
    mask = put(rng.random(G) < 0.05)
    check("zero_inbox_rows", list(C._zero_inbox_rows(regions, mask)),
          list(CR.zero_inbox_rows(regions, mask)))
    inbox_cases = inbox_geometry_checks(dev, check, host, pending, combo, rng)
    result = dict(rows=G, budget=B, assembled_M=PB + MH, cluster=cluster,
                  selected=sel_counts, storm_selected=storm_counts,
                  checks=checks, max_abs_err=errs)
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(
            f"colocated kernels disagree with their plain versions: {bad}")
    if cluster["leaders"] < 0.95 * (G // 3) or cluster["routed_delivered"] < 1:
        raise AssertionError(f"routed cluster did not converge: {cluster}")

    # ---- time each kernel at these inputs -----------------------------
    ms, plain_ms, bound, lib_ms = {}, {}, {}, {}
    row_w = 10 + 2 * E  # int32 words of one inbox slot
    count = out.count.clamp(0, O)
    n_msgs = int(count.sum())
    und = torch.empty((G,), dtype=torch.int32, device=dev)
    pk = torch.empty_like(packed)
    ms["route"] = time_ms(lambda: R.route_cuda(
        merged, out, dest, rank, M=PB, E=E, budget=B, base=0,
        suppress=out.escalate, alive=combo, alive_stride=4, packed=pk,
        undeliv=und), 50)
    plain_ms["route"] = time_ms(lambda: route_ref.route(
        merged, out, dest, rank, M=PB, E=E, budget=B, base=0,
        suppress=esc, dest_alive=alive), 5)
    bound["route"] = route_bound_ms(out, route_deliv, P, PB, E, bits=True)
    lib_ms["route"] = None
    ms["assemble_inbox"] = time_ms(
        lambda: C._assemble_inbox(host, pending, combo), 50)
    plain_ms["assemble_inbox"] = time_ms(
        lambda: CR.assemble_inbox(host, pending, combo), 5)
    bound["assemble_inbox"] = inbox_copy_bound_ms(combo[:, C._C_ALIVE] != 0,
                                                  PB + MH, E)
    # yardstick: the 12 concatenations without the dead rows' zeroing
    lib_ms["assemble_inbox"] = time_ms(lambda: [
        torch.cat([p, h], dim=1) for h, p in zip(host, pending)], 50)
    ms["host_inbox_from_ticks"] = time_ms(
        lambda: C._host_inbox_from_ticks(combo, M=MH, E=E), 50)
    plain_ms["host_inbox_from_ticks"] = time_ms(
        lambda: CR.host_inbox_from_ticks(combo, M=MH, E=E), 5)
    bound["host_inbox_from_ticks"] = bound_ms(4 * (G + G * MH * row_w))
    # yardstick: one zero_() over a buffer of the same bytes
    zbuf = torch.empty(G * MH * row_w, dtype=torch.int32, device=dev)
    lib_ms["host_inbox_from_ticks"] = time_ms(zbuf.zero_, 50)
    ms["zero_inbox_rows"] = time_ms(
        lambda: C._zero_inbox_rows(regions, mask), 50)
    plain_ms["zero_inbox_rows"] = time_ms(
        lambda: CR.zero_inbox_rows(regions, mask), 5)
    bound["zero_inbox_rows"] = inbox_copy_bound_ms(mask == 0, PB, E)
    lib_ms["zero_inbox_rows"] = None
    caps = {k: min(G, v) for k, v in C._SEL_TIERS[0].items()}
    kw = dict(CAP_B=caps["b"], CAP_SL=caps["sl"], CAP_N=caps["n"],
              CAP_A=caps["a"], CAP_S=caps["s"], HOST_OFF=PB)
    ms["select_and_blob"] = time_ms(lambda: C._select_and_blob(
        merged, out, stats6, packed, flags, combo, **kw), 50)
    plain_ms["select_and_blob"] = time_ms(lambda: CR.select_and_blob(
        merged, out, stats6, packed, flags, combo, **kw), 5)
    n_head, n_detail = C._blob_sizes(
        G, O, out.slot_base.shape[1], E, P, W,
        (caps["b"], caps["sl"], caps["n"], caps["a"], caps["s"]), PB)
    # flags, combo lanes, bits and stats in; the head and detail out (the
    # detail's gathered rows are read once and written once); the
    # scratch: a mask byte a row written and read, the block totals
    # written and read twice, the block offsets written and read
    nb = -(-G // C._SEL_BLOCK_ROWS)
    bound["select_and_blob"] = bound_ms(4 * (
        G * (1 + 3 + (O + 31) // 32) + 6 + n_head + 2 * n_detail
        + caps["s"] * T.N_VALS) + 2 * G + 4 * 5 * nb * 5)
    lib_ms["select_and_blob"] = None

    def sel_call(case, tier=0):
        m_, o_, s_, p_, f_, c_, hoff = sel_cases[case] if case else (
            merged, out, stats6, packed, flags, combo, PB)
        cp = {k: min(f_.shape[0], v) for k, v in C._SEL_TIERS[tier].items()}
        return lambda: C._select_and_blob(
            m_, o_, s_, p_, f_, c_, CAP_B=cp["b"], CAP_SL=cp["sl"],
            CAP_N=cp["n"], CAP_A=cp["a"], CAP_S=cp["s"], HOST_OFF=hoff)

    sel_geoms = {"C30000": dict(split=kernel_split(sel_call(None)))}
    for cname in sel_cases:
        fn = sel_call(cname)
        sel_geoms[cname] = dict(ms=time_ms(fn, 50), device_ms=device_ms(fn),
                                split=kernel_split(fn))
    for t in range(1, len(C._SEL_TIERS)):
        sel_geoms[f"C30000_tier{t}"] = dict(device_ms=device_ms(
            sel_call(None, t)))
    dev_ms = {
        "route": device_ms(lambda: R.route_cuda(
            merged, out, dest, rank, M=PB, E=E, budget=B, base=0,
            suppress=out.escalate, alive=combo, alive_stride=4, packed=pk,
            undeliv=und)),
        "assemble_inbox": device_ms(
            lambda: C._assemble_inbox(host, pending, combo)),
        "host_inbox_from_ticks": device_ms(
            lambda: C._host_inbox_from_ticks(combo, M=MH, E=E)),
        "zero_inbox_rows": device_ms(
            lambda: C._zero_inbox_rows(regions, mask)),
        "select_and_blob": device_ms(lambda: C._select_and_blob(
            merged, out, stats6, packed, flags, combo, **kw)),
    }
    # the inbox entry points: each entry's kernel split, each case's device
    # time and bound, the yardsticks' device time
    for e, fn in (("host_inbox_from_ticks",
                   lambda: C._host_inbox_from_ticks(combo, M=MH, E=E)),
                  ("assemble_inbox",
                   lambda: C._assemble_inbox(host, pending, combo)),
                  ("zero_inbox_rows",
                   lambda: C._zero_inbox_rows(regions, mask))):
        inbox_cases[e] = dict(split=kernel_split(fn))
    inbox_cases["library_device_ms"] = dict(
        host_inbox_from_ticks=device_ms(zbuf.zero_),
        assemble_inbox=device_ms(lambda: [
            torch.cat([p, h], dim=1) for h, p in zip(host, pending)]))
    for case in inbox_cases["timed"]:
        fn = case.pop("fn")
        case.update(ms=time_ms(fn, 50), device_ms=device_ms(fn))
    # route at the colocated engine's capacity beside these 30,000 rows,
    # each with its kernels' device split
    geoms = {"C30000": dict(
        rows=G, P=P, O=O, M=PB, base=0, ms=ms["route"],
        device_ms=dev_ms["route"], bound_ms=bound["route"],
        split=kernel_split(lambda: R.route_cuda(
            merged, out, dest, rank, M=PB, E=E, budget=B, base=0,
            suppress=out.escalate, alive=combo, alive_stride=4, packed=pk,
            undeliv=und)))}
    c4 = colo_route_case(dev, 4096, 3, 16)
    c4_fn, c4_err, c4_bound = colo_route_check(c4)
    errs["route"] = max(errs["route"], c4_err)
    checks["route"] += 1
    geoms["G4096"] = dict(
        rows=4096, P=3, O=O, M=c4["PB"], base=0, max_abs_err=c4_err,
        ms=time_ms(c4_fn, 50), device_ms=device_ms(c4_fn),
        bound_ms=c4_bound, split=kernel_split(c4_fn))
    if c4_err:
        raise AssertionError(f"route at G = 4096 disagrees: {c4_err}")
    result.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                  library_ms=lib_ms, timed_messages=n_msgs, timed_tier=0,
                  route_geometries=geoms, select_geometries=sel_geoms,
                  inbox_cases=inbox_cases, max_abs_err=errs, checks=checks)
    return result


def inbox_copy_bound_ms(alive, M_: int, E_: int) -> float:
    """The bound of an inbox copy (assemble, zero_rows) at this run's rows:
    every output word written, the live rows' words read, one lane word a
    row read."""
    G_ = alive.numel()
    words_row = M_ * (10 + 2 * E_)
    return bound_ms(4 * ((G_ + int(alive.sum())) * words_row + G_))


INBOX_ODD = dict(G=4099, PB=5, MH=3, E=3)


def inbox_geometry_checks(dev, check, host, pending, combo, rng) -> dict:
    """The three inbox entry points off the 16-byte path (``INBOX_ODD``:
    odd P*B, 3 host slots, E = 3, a row count that leaves a ragged last
    tile) with their sources at aligned and at unaligned addresses, and
    assemble at 30,000 rows with 0, about 10 and 100% dead rows and on
    the fused wave's all-zero combo, each against its plain version
    through ``check``.  Returns the cases to time: {"timed": [{case,
    rows, alive_rows, bound_ms, fn}, ...]}."""
    import torch

    from dragonboat_tpu_torch.ops import colocated as C
    from dragonboat_tpu_torch.ops import colocated_ref as CR
    from dragonboat_tpu_torch.ops import types as T

    r = np.random.default_rng(SEED + 5)
    Go, PBo, MHo, Eo = (INBOX_ODD[k] for k in ("G", "PB", "MH", "E"))

    def plane(shape, unaligned):
        vals = torch.from_numpy(
            r.integers(-999, 999, shape).astype(np.int32)).to(dev)
        if not unaligned:
            return vals
        n = vals.numel()
        buf = torch.empty(n + 4, dtype=torch.int32, device=dev)
        buf[1:n + 1].copy_(vals.reshape(-1))
        return buf[1:n + 1].view(shape)

    def inbox(S, unaligned=False):
        return T.Inbox(*(plane((Go, S) + ((Eo,) if f >= 10 else ()),
                               unaligned) for f in range(12)))

    lanes = np.concatenate([r.random((Go, 1)) < 0.9, r.random((Go, 2)) < 0.5,
                            r.integers(0, 4, (Go, 1))], axis=1)
    combo_o = torch.from_numpy(lanes.astype(np.int32)).to(dev)
    host_o = C._host_inbox_from_ticks(combo_o, M=MHo, E=Eo)
    check("host_inbox_from_ticks", list(host_o),
          list(CR.host_inbox_from_ticks(combo_o, M=MHo, E=Eo)))
    mask_o = torch.from_numpy(
        (r.random(Go) < 0.1).astype(np.int32)).to(dev)
    for unaligned in (False, True):
        for h in (host_o, inbox(MHo, unaligned)):
            pend = inbox(PBo, unaligned)
            check("assemble_inbox", list(C._assemble_inbox(h, pend, combo_o)),
                  list(CR.assemble_inbox(h, pend, combo_o)))
        full = inbox(PBo + MHo, unaligned)
        check("zero_inbox_rows", list(C._zero_inbox_rows(full, mask_o)),
              list(CR.zero_inbox_rows(full, mask_o)))
    G, M_ = combo.shape[0], pending.mtype.shape[1] + host.mtype.shape[1]
    E_ = host.ent_term.shape[2]
    timed = []
    for case, share in (("dead0", 0.0), ("dead10", 0.1), ("dead100", 1.0),
                        ("zero_combo", None)):
        c = combo.clone()
        if share is None:
            c.zero_()
        else:
            c[:, 0] = torch.from_numpy(
                (r.random(G) >= share).astype(np.int32)).to(dev)
        check("assemble_inbox", list(C._assemble_inbox(host, pending, c)),
              list(CR.assemble_inbox(host, pending, c)))
        alive = c[:, 0] != 0
        timed.append(dict(
            case=case, rows=G, alive_rows=int(alive.sum()),
            bound_ms=inbox_copy_bound_ms(alive, M_, E_),
            fn=lambda c=c: C._assemble_inbox(host, pending, c)))
    return dict(odd_geometry=INBOX_ODD, timed=timed)


def colo_route_case(dev, G: int, P_: int, W_: int, waves: int = 6) -> dict:
    """A colocated route call's inputs at G rows of P_ peer slots (the
    kernels phase's widths otherwise): a padded seeded cluster advanced
    by ``waves`` waves of 3 fused rounds over ``build_route_tables``, then
    one step; the merged state, its outbox, the tables and a [G, 4] combo
    whose alive lane drops 3% of the rows."""
    import torch

    from dragonboat_tpu_torch.ops import colocated as C
    from dragonboat_tpu_torch.ops import convert, plumbing
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import route_ref
    from dragonboat_tpu_torch.ops import types as T

    B, MH = BUDGET_K, M_HOST_K
    PB = P_ * B
    st_np = padded_cluster_np(G, P_, W_, SEED + G)
    dest_np, rank_np = R.build_route_tables(
        st_np["shard_id"], st_np["replica_id"], st_np["peer_id"])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    dest, rank = put(dest_np), put(rank_np)
    st = convert.state_from_numpy(st_np, dev)
    inbox = route_ref.make_prefill(st, MH + PB, E)
    for w in range(waves):
        st, inbox, _s, _n = R.fused_rounds(
            st, inbox, dest, rank, rounds=3, out_capacity=O, budget=B,
            base=MH, propose_leaders=w >= waves // 2)
    new, out = K.step(st, inbox, O)
    merged = T.DeviceState(*plumbing.merge_escalated(
        out.escalate, list(st), list(new)))
    rng = np.random.default_rng(SEED + G + 5)
    combo = np.zeros((G, 4), np.int32)
    combo[:, C._C_ALIVE] = rng.random(G) < 0.97
    return dict(merged=merged, out=out, dest=dest, rank=rank,
                combo=put(combo), P=P_, PB=PB, B=B)


def colo_route_check(c: dict):
    """The colocated route call on case ``c`` (``colo_route_case``):
    (the call, its max abs error against the plain version on every
    output, its bound)."""
    import torch

    from dragonboat_tpu_torch.ops import colocated as C
    from dragonboat_tpu_torch.ops import colocated_ref as CR
    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import route_ref

    merged, out, dest, rank, combo = (c[k] for k in (
        "merged", "out", "dest", "rank", "combo"))
    G, O_ = out.buf.shape[:2]
    pk = torch.empty((G, (O_ + 31) // 32), dtype=torch.int32,
                     device=combo.device)
    und = torch.empty((G,), dtype=torch.int32, device=combo.device)

    def fn():
        return R.route_cuda(
            merged, out, dest, rank, M=c["PB"], E=E, budget=c["B"], base=0,
            suppress=out.escalate, alive=combo, alive_stride=4, packed=pk,
            undeliv=und)

    got_ib, got_st, _ = fn()
    ib, st, deliv = route_ref.route(
        merged, out, dest, rank, M=c["PB"], E=E, budget=c["B"], base=0,
        suppress=out.escalate != 0, dest_alive=combo[:, C._C_ALIVE] != 0)
    valid = (torch.arange(O_, device=combo.device)[None, :]
             < out.count[:, None])
    want_und = (valid & ~deliv).any(dim=1).to(torch.int32)
    n_sup = (out.escalate != 0).sum(dtype=torch.int32).view(1)
    err = _max_err(
        list(got_ib) + [got_st, pk, und],
        list(ib) + [torch.cat([st, n_sup]), CR.pack_delivered(deliv),
                    want_und])
    return fn, err, route_bound_ms(out, deliv, c["P"], c["PB"], E,
                                   bits=True)


# ---------------------------------------------------------------------------
# the G-last step and the sharded device plane
# ---------------------------------------------------------------------------
# bench phase A's geometry (bench.py:48-140): 100k groups x 3 replicas
A_GROUPS = 100_000
A_P, A_W, A_M, A_E, A_O = 3, 8, 12, 1, 8
A_TPL = 32  # ticks per slot; election_timeout 2 * A_TPL
# multichip leg 2 (bench.py:2780-2880): BASELINE config 5's group count
X_GROUPS = 50_000
X_P, X_W, X_E, X_O, X_BUD, X_BASE = 3, 16, 2, 16, 4, 2
X_M = X_BASE + X_P * X_BUD
X_DEVICES = 4
# 40 single rounds and 8 waves of 3: the reference bench's 64 rounds
# (BENCH_MULTICHIP_ROUNDS).  The reference's election jitter hashes
# shard_id << 24, so shards equal mod 256 share their timeouts; the
# slowest of those classes elects only by round ~54 (195 of 50k groups
# had no leader after 48 rounds)
X_ROUNDS, X_WAVES, X_WAVE_ROUNDS = 40, 8, 3
# the kernels of leg 2's sharded round
X_PATH_KERNELS = ("raft_step", "merge_escalated", "route", "xlane_pack",
                  "xlane_scatter")

MESH_KERNEL_INFO = {
    "raft_step_internal": dict(
        source="dragonboat_tpu_torch/csrc/raft_step.cu",
        replaces="dragonboat_tpu/ops/kernel.py:1674",
        also_replaces=["dragonboat_tpu/ops/kernel.py:1707"],
    ),
    "xlane_pack": dict(
        source="dragonboat_tpu_torch/csrc/xlane.cu",
        replaces="dragonboat_tpu/ops/route.py:652",
        also_replaces=["dragonboat_tpu/ops/route.py:850"],
    ),
    "xlane_scatter": dict(
        source="dragonboat_tpu_torch/csrc/xlane.cu",
        replaces="dragonboat_tpu/ops/route.py:652",
        also_replaces=["dragonboat_tpu/ops/route.py:850"],
    ),
}


def phase_a_inputs(dev, groups: int = A_GROUPS):
    """Bench phase A's state and fused-tick inbox, internal (G-last)
    layout, on ``dev``: group i's replicas at rows 3i, 3i+1, 3i+2."""
    import torch

    from dragonboat_tpu_torch.ops import convert
    from dragonboat_tpu_torch.ops import types as T

    G = groups * 3
    cols = T.make_state_np(
        G, A_P, A_W,
        shard_ids=np.repeat(np.arange(1, groups + 1, dtype=np.int32), 3),
        replica_ids=np.tile(np.arange(1, 4, dtype=np.int32), groups),
        peer_ids=np.broadcast_to(np.arange(1, 4, dtype=np.int32),
                                 (G, A_P)).copy(),
        election_timeout=2 * A_TPL, heartbeat_timeout=2,
    )
    st = convert.state_to_internal(convert.state_from_numpy(cols, dev))

    def full(v, *shape):
        return torch.full(shape, v, dtype=torch.int32, device=dev)

    ib = T.Inbox(
        mtype=full(T.MT_TICK, A_M, G), from_id=full(0, A_M, G),
        term=full(0, A_M, G), log_term=full(0, A_M, G),
        log_index=full(A_TPL, A_M, G), commit=full(0, A_M, G),
        reject=full(0, A_M, G), hint=full(0, A_M, G),
        hint_high=full(0, A_M, G), n_entries=full(0, A_M, G),
        ent_term=full(0, A_M, A_E, G), ent_cc=full(0, A_M, A_E, G),
    )
    return st, ib


def leg2_inputs(dev, groups: int = X_GROUPS, n_dev: int = X_DEVICES):
    """Multichip leg 2's replica-major layout (group i's replicas at rows
    {i, groups+i, 2*groups+i}: every group straddles device blocks), its
    mesh and single-device tables, the lane budget, state and prefill."""
    import torch

    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import route_ref
    from dragonboat_tpu_torch.ops import types as T

    G = groups * 3
    sh = np.tile(np.arange(1, groups + 1, dtype=np.int32), 3)
    rp = np.repeat(np.arange(1, 4, dtype=np.int32), groups)
    pe = np.broadcast_to(np.arange(1, 4, dtype=np.int32), (G, X_P)).copy()
    tabs = R.build_route_tables_mesh(sh, rp, pe, n_dev)
    xb = R.xbudget_for(tabs, X_BUD, n_dev)
    dest, rank = R.build_route_tables(sh, rp, pe)
    st = T.make_state(G, X_P, X_W, shard_ids=sh, replica_ids=rp,
                      peer_ids=pe, election_timeout=10, heartbeat_timeout=2,
                      device=dev)
    ib = route_ref.make_prefill(st, X_M, X_E)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return dict(G=G, tabs=[put(t) for t in tabs], xbudget=xb,
                dest=put(dest), rank=put(rank), state=st, inbox=ib)


def leg2_lane_case(dev, warm_rounds: int = 20) -> dict:
    """Leg 2's rows after ``warm_rounds`` routed rounds on the card (mid
    election and commit), stepped once more and merged: the merged state,
    its outbox, the mesh tables and a fresh prefill, each cut into the
    4 devices' blocks (``st_b``, ``out_b``, ``tab_b`` = (dest_local,
    dest_dev, rank) a block, ``ib_b``), the mesh and the lane budget."""
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import plumbing
    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import route_ref
    from dragonboat_tpu_torch.ops import types as T
    from dragonboat_tpu_torch.ops.placement import GroupsMesh

    x = leg2_inputs(dev)
    xs, xi = x["state"], x["inbox"]
    for _ in range(warm_rounds):
        xs, xi, _s, _n = R.routed_round(
            xs, xi, x["dest"], x["rank"], out_capacity=X_O, budget=X_BUD,
            base=X_BASE, propose_leaders=True)
    new, out = K.step(xs, xi, X_O)
    merged = T.DeviceState(*plumbing.merge_escalated(
        out.escalate, list(xs), list(new)))
    mesh = GroupsMesh([dev] * X_DEVICES)
    return dict(
        G=x["G"], xbudget=x["xbudget"], mesh=mesh,
        st_b=mesh.shard(merged).parts, out_b=mesh.shard(out).parts,
        tab_b=list(zip(*(mesh.shard(t).parts for t in x["tabs"]))),
        ib_b=mesh.shard(route_ref.make_prefill(merged, X_M, X_E)).parts)


def mesh_kernels_phase(dev, n_ticks: int = 3, n_fuzz: int = 2,
                       warm_rounds: int = 20) -> dict:
    """``raft_step_internal`` bit-exact against its plain version at bench
    phase A's geometry (300,000 rows) on states advanced by the tick loop
    and under seeded fuzz inboxes over every hot message type;
    ``xlane_pack`` / ``xlane_scatter`` bit-exact against theirs at leg
    2's geometry (150,000 rows on a mesh of 4 blocks) on a routed
    cluster mid-election and mid-commit; then each timed (CUDA events,
    the profiler's device time) beside its bound, with the external
    ``raft_step`` at the same 300,000 rows."""
    import torch

    from dragonboat_tpu_torch.ops import convert, kernel_ref
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import route_ref
    from dragonboat_tpu_torch.ops import types as T

    rng = np.random.default_rng(SEED + 3)
    errs = {k: 0 for k in (*MESH_KERNEL_INFO, "route")}
    checks = {k: 0 for k in (*MESH_KERNEL_INFO, "route")}

    def check(name, got, want):
        errs[name] = max(errs[name], _max_err(got, want))
        checks[name] += 1

    # ---- raft_step_internal at 300,000 rows -----------------------------
    st, tick_ib = phase_a_inputs(dev)
    G = st.term.shape[0]
    esc = 0
    for k in range(n_ticks + n_fuzz):
        if k < n_ticks:
            ib = tick_ib
        else:
            ext = convert.to_numpy(convert.state_from_internal(st))
            ib = convert.inbox_to_internal(convert.inbox_from_numpy(
                fuzz_inbox_np(ext, rng, A_M, A_E), dev))
        new, step_out = K.step_internal(st, ib, A_O)
        rnew, rout = kernel_ref.step_internal(st, ib, A_O)
        check("raft_step_internal", list(new) + list(step_out),
              list(rnew) + list(rout))
        esc += int((step_out.escalate != 0).sum())
        if k < n_ticks:
            st = new
    fuzz_ib = ib
    step_rows = dict(rows=G, tick_launches=n_ticks, fuzz_launches=n_fuzz,
                     escalations=esc)

    # ---- the lane at leg 2's geometry ------------------------------------
    lc = leg2_lane_case(dev, warm_rounds)
    Gx, xb = lc["G"], lc["xbudget"]
    st_b, out_b, tab_b, ib_b = (lc[k] for k in ("st_b", "out_b", "tab_b",
                                                "ib_b"))
    mesh = lc["mesh"]
    xbufs, lane = [], []
    for d in range(X_DEVICES):
        kw = dict(me=d, n_dev=X_DEVICES, E=X_E, budget=X_BUD, xbudget=xb,
                  suppress=out_b[d].escalate)
        got = R.xlane_pack(st_b[d], out_b[d], *tab_b[d], **kw)
        want = route_ref.lane_pack(st_b[d], out_b[d], *tab_b[d], **kw)
        check("xlane_pack", list(got), list(want))
        xbufs.append(got[0])
        lane.append(got[1])
    recv = R.ring_shift(mesh, xbufs)
    for d in range(X_DEVICES):
        got_ib = T.Inbox(*(t.clone() for t in ib_b[d]))
        want_ib = T.Inbox(*(t.clone() for t in ib_b[d]))
        stats = lane[d].clone()
        R.xlane_scatter(got_ib, recv[d], budget=X_BUD, base=X_BASE,
                        stats=stats)
        _w, n = route_ref.lane_scatter(want_ib, recv[d], budget=X_BUD,
                                       base=X_BASE)
        check("xlane_scatter", list(got_ib) + [stats[1:2]],
              list(want_ib) + [n.view(1)])
        lane[d] = stats
    lane_np = torch.stack(lane).cpu().numpy()
    # the same block with an undersized lane: half the fullest edge's
    # messages, so that the lane drops some
    d0 = 0
    xb_small = max(1, int(xbufs[d0][:, :, route_ref.XI_FOUND].sum(1).max())
                   // 2)
    kw_small = dict(me=d0, n_dev=X_DEVICES, E=X_E, budget=X_BUD,
                    xbudget=xb_small, suppress=out_b[d0].escalate)
    got = R.xlane_pack(st_b[d0], out_b[d0], *tab_b[d0], **kw_small)
    check("xlane_pack", list(got),
          list(route_ref.lane_pack(st_b[d0], out_b[d0], *tab_b[d0],
                                   **kw_small)))
    small_dropped = int(got[1][3])
    xbuf_small = got[0]
    # route on the same block as the sharded round runs it: the local
    # view of the tables, the tick and propose prefill, escalated rows
    # suppressed (merge_and_route)
    local = torch.where(tab_b[d0][1] == d0, tab_b[d0][0], -1).to(torch.int32)
    x_args = (st_b[d0], out_b[d0], local, tab_b[d0][2])
    x_kw = dict(M=X_M, E=X_E, budget=X_BUD, base=X_BASE)

    def x_route(delivered=False):
        return R.route_cuda(*x_args, **x_kw, suppress=out_b[d0].escalate,
                            prefill=(True, True, 1), delivered=delivered)

    got_ib, got_st, got_deliv = x_route(True)
    want_ib, want_st, want_deliv = route_ref.route(
        *x_args, **x_kw, suppress=out_b[d0].escalate != 0,
        base_inbox=route_ref.make_prefill(st_b[d0], X_M, X_E,
                                          propose_leaders=True))
    n_sup = (out_b[d0].escalate != 0).sum(dtype=torch.int32).view(1)
    check("route", list(got_ib) + [got_st, got_deliv],
          list(want_ib) + [torch.cat([want_st, n_sup]), want_deliv])
    lane_rows = dict(rows=Gx, devices=X_DEVICES, xbudget=xb,
                     warm_rounds=warm_rounds,
                     per_device_lane=lane_np.tolist(),
                     undersized=dict(xbudget=xb_small,
                                     dropped_xlane=small_dropped))
    result = dict(step=step_rows, lane=lane_rows, checks=checks,
                  max_abs_err=errs,
                  rows_per_block=K.rows_per_block(G, A_P, A_W, A_M, A_E,
                                                  A_O, internal=True))
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"mesh kernels disagree with their plain "
                             f"versions: {bad}")
    if lane_np[:, 1].sum() < 1:
        raise AssertionError("no message crossed the lane")
    if small_dropped < 1:
        raise AssertionError("the undersized lane dropped nothing")

    # ---- timing ------------------------------------------------------------
    ms, dev_ms, plain_ms, bound, lib_ms = {}, {}, {}, {}, {}
    occ = int((fuzz_ib.mtype != 0).sum())
    ms["raft_step_internal"] = time_ms(
        lambda: K.step_internal(st, fuzz_ib, A_O), 20)
    dev_ms["raft_step_internal"] = device_ms(
        lambda: K.step_internal(st, fuzz_ib, A_O))
    plain_ms["raft_step_internal"] = time_ms(
        lambda: kernel_ref.step_internal(st, fuzz_ib, A_O), 2, 1)
    bound["raft_step_internal"] = step_bound_ms(st, fuzz_ib, step_out, A_E)
    lib_ms["raft_step_internal"] = None
    # the external kernel on the same rows, for the two layouts side by side
    st_ext = convert.state_from_internal(st)
    ib_ext = convert.inbox_from_internal(fuzz_ib)
    external = dict(
        ms=time_ms(lambda: K.step(st_ext, ib_ext, A_O), 20),
        device_ms=device_ms(lambda: K.step(st_ext, ib_ext, A_O)),
        bound_ms=bound["raft_step_internal"],
    )
    kw = dict(me=d0, n_dev=X_DEVICES, E=X_E, budget=X_BUD, xbudget=xb,
              suppress=out_b[d0].escalate)
    ms["xlane_pack"] = time_ms(
        lambda: R.xlane_pack(st_b[d0], out_b[d0], *tab_b[d0], **kw), 50)
    dev_ms["xlane_pack"] = device_ms(
        lambda: R.xlane_pack(st_b[d0], out_b[d0], *tab_b[d0], **kw))
    lane_split = kernel_split(
        lambda: R.xlane_pack(st_b[d0], out_b[d0], *tab_b[d0], **kw))
    small = dict(
        xbudget=xb_small, dropped_xlane=small_dropped,
        ms=time_ms(lambda: R.xlane_pack(
            st_b[d0], out_b[d0], *tab_b[d0], **kw_small), 50),
        device_ms=device_ms(lambda: R.xlane_pack(
            st_b[d0], out_b[d0], *tab_b[d0], **kw_small)),
        split=kernel_split(lambda: R.xlane_pack(
            st_b[d0], out_b[d0], *tab_b[d0], **kw_small)))
    route_x = dict(
        rows=int(local.shape[0]), P=X_P, O=X_O, M=X_M, base=X_BASE,
        ms=time_ms(x_route, 50), device_ms=device_ms(x_route),
        bound_ms=route_bound_ms(out_b[d0], want_deliv, X_P, X_M, X_E,
                                bits=False),
        split=kernel_split(x_route))
    plain_ms["xlane_pack"] = time_ms(
        lambda: route_ref.lane_pack(st_b[d0], out_b[d0], *tab_b[d0], **kw),
        5)
    kt = route_ref.X_KF + 2 * X_E
    sent = int(lane_np[d0, 0])
    bound["xlane_pack"] = lane_pack_bound_ms(out_b[d0], xbufs[d0], X_P)
    lib_ms["xlane_pack"] = None
    scratch_ib = T.Inbox(*(t.clone() for t in ib_b[d0]))
    ms["xlane_scatter"] = time_ms(lambda: R.xlane_scatter(
        scratch_ib, recv[d0], budget=X_BUD, base=X_BASE), 50)
    dev_ms["xlane_scatter"] = device_ms(lambda: R.xlane_scatter(
        scratch_ib, recv[d0], budget=X_BUD, base=X_BASE))
    plain_ms["xlane_scatter"] = time_ms(lambda: route_ref.lane_scatter(
        scratch_ib, recv[d0], budget=X_BUD, base=X_BASE), 5)
    delivered = int(lane_np[d0, 1])
    # The least the scatter must move: one 32-byte sector (its found
    # word) for each empty received row, every word of each row that
    # carries a message, and each in-range delivered slot's inbox words
    # read and written once.
    rv, gl = recv[d0], ib_b[d0].mtype.shape[0]
    found = rv[:, route_ref.XI_FOUND] != 0
    slot = X_BASE + rv[:, route_ref.XI_RANK] * X_BUD + rv[:, route_ref.XI_B]
    in_range = (found & (rv[:, route_ref.XI_LOC] >= 0)
                & (rv[:, route_ref.XI_LOC] < gl) & (slot >= 0) & (slot < X_M))
    n_found = int(found.sum())
    bound["xlane_scatter"] = bound_ms(
        32 * (rv.shape[0] - n_found) + 4 * (
            n_found * kt + 2 * int(in_range.sum()) * (10 + 2 * X_E)))
    lib_ms["xlane_scatter"] = None
    small["bound_ms"] = lane_pack_bound_ms(out_b[d0], xbuf_small, X_P)
    result.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                  bound_ms=bound, library_ms=lib_ms,
                  xlane_pack_split=lane_split, xlane_pack_undersized=small,
                  route_X37500=route_x,
                  raft_step_external_300k=external,
                  timed=dict(step_occupied_slots=occ, lane_device=d0,
                             sent=sent, delivered=delivered,
                             **lane_pack_work(out_b[d0], xbufs[d0]),
                             scatter_rows=int(rv.shape[0]),
                             scatter_found=n_found))
    return result


def mesh_pack_case(dev, warm_rounds: int = 20,
                   dead_share: float = 0.05) -> dict:
    """The colocated pack (``xlane_pack`` with ``dest_alive``, ``packed``
    and ``undeliv``, as a mesh-mode colocated route step runs it) at leg
    2's geometry: each block's route on its local tables with the alive
    lane of a seeded combo that kills about ``dead_share`` of the rows
    gives the delivered bits and undelivered words, then the pack holds
    every cross-block message to its receiver's alive word, sets the
    bits of what it carried and rewrites the undelivered words; bit-exact
    against the plain version on every block, then block 0 timed beside
    the pack without the new operands on the same rows."""
    import torch

    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import route_ref

    lc = leg2_lane_case(dev, warm_rounds)
    Gx, xb = lc["G"], lc["xbudget"]
    st_b, out_b, tab_b = lc["st_b"], lc["out_b"], lc["tab_b"]
    gl = Gx // X_DEVICES
    rng = np.random.default_rng(SEED + 8)
    combo_np = np.zeros((Gx, 4), np.int32)
    combo_np[:, 0] = rng.random(Gx) >= dead_share
    combo = torch.from_numpy(combo_np).to(dev)
    PB, nw = X_P * X_BUD, (X_O + 31) // 32
    err, refused, carried, routed = 0, 0, 0, []
    for d in range(X_DEVICES):
        local = torch.where(tab_b[d][1] == d, tab_b[d][0], -1).to(
            torch.int32)
        packed = torch.empty((gl, nw), dtype=torch.int32, device=dev)
        und = torch.empty((gl,), dtype=torch.int32, device=dev)
        R.route_cuda(st_b[d], out_b[d], local, tab_b[d][2], M=PB, E=X_E,
                     budget=X_BUD, base=0, suppress=out_b[d].escalate,
                     alive=combo[d * gl:(d + 1) * gl], alive_stride=4,
                     packed=packed, undeliv=und)
        kw = dict(me=d, n_dev=X_DEVICES, E=X_E, budget=X_BUD, xbudget=xb,
                  suppress=out_b[d].escalate, dest_alive=combo,
                  alive_stride=4)
        gp, gu, wp, wu = (packed.clone(), und.clone(), packed.clone(),
                          und.clone())
        got = R.xlane_pack(st_b[d], out_b[d], *tab_b[d], **kw, packed=gp,
                           undeliv=gu)
        want = route_ref.lane_pack(st_b[d], out_b[d], *tab_b[d], **kw,
                                   packed=wp, undeliv=wu)
        err = max(err, _max_err(list(got) + [gp, gu],
                                list(want) + [wp, wu]))
        refused += int(got[1][7])
        carried += int(got[1][0])
        routed.append((local, packed, und))
    if err:
        raise AssertionError(f"the colocated pack disagrees with its plain "
                             f"version: max abs error {err}")
    if refused < 1 or carried < 1:
        raise AssertionError(f"the colocated pack refused {refused} and "
                             f"carried {carried} messages: the case does "
                             f"not exercise it")
    d0 = 0
    _local, packed, und = routed[d0]
    kw = dict(me=d0, n_dev=X_DEVICES, E=X_E, budget=X_BUD, xbudget=xb,
              suppress=out_b[d0].escalate)
    work = (packed.clone(), und.clone())

    def colo():
        return R.xlane_pack(st_b[d0], out_b[d0], *tab_b[d0], **kw,
                            dest_alive=combo, alive_stride=4,
                            packed=work[0], undeliv=work[1])

    def parent():
        return R.xlane_pack(st_b[d0], out_b[d0], *tab_b[d0], **kw)

    xbuf = colo()[0]
    # the bound: the pack's (lane_pack_bound_ms) and, with the colocated
    # operands, each live row's delivered words read and written and its
    # undelivered word written, and each cross-block message's receiver
    # alive word read
    live = int(((out_b[d0].escalate == 0) & (out_b[d0].count > 0)).sum())
    remote = int(xbuf[:, :, route_ref.XI_FOUND].sum()) + int(
        colo()[1][7]) + int(colo()[1][2]) + int(colo()[1][4])
    extra = bound_ms(4 * (live * (2 * nw + 1) + remote))
    return dict(
        rows=Gx, blocks=X_DEVICES, xbudget=xb, dead_share=dead_share,
        dead_rows=int((combo_np[:, 0] == 0).sum()), refused=refused,
        carried=carried, max_abs_err=err,
        ms=time_ms(colo, 50), device_ms=device_ms(colo),
        split=kernel_split(colo),
        plain_ms=time_ms(lambda: route_ref.lane_pack(
            st_b[d0], out_b[d0], *tab_b[d0], **kw, dest_alive=combo,
            alive_stride=4, packed=packed.clone(), undeliv=und.clone()), 5),
        bound_ms=lane_pack_bound_ms(out_b[d0], xbuf, X_P) + extra,
        without_operands=dict(
            ms=time_ms(parent, 50), device_ms=device_ms(parent),
            bound_ms=lane_pack_bound_ms(out_b[d0], parent()[0], X_P)),
        library_ms=None)


def phase_a_phase(dev, iters: int = 100, windows: int = 3) -> dict:
    """Bench phase A on ``step_internal``: 100k groups x 3 replicas stay
    on the card in the G-last layout; every launch advances 12 slots of
    32 fused ticks.  Best of ``windows`` timed windows of ``iters``
    launches, each closed by ``torch.cuda.synchronize()``; escalated rows
    are subtracted from the group ticks (the reference's honesty guard);
    after each window one launch is re-checked against the plain
    version."""
    import torch

    from dragonboat_tpu_torch.ops import _native, kernel_ref
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import types as T

    st, ib = phase_a_inputs(dev)
    G = st.term.shape[0]
    for _ in range(10):  # warm-up: settle into election churn
        st, _out = K.step_internal(st, ib, A_O)
    torch.cuda.synchronize()
    ticks = A_TPL * A_M
    best_dt, best_esc, err, checks = float("inf"), 0, 0, 0
    _native.reset_launch_counts()
    for _ in range(windows):
        # escalated rows accumulate on the card, as the reference's
        # jitted loop does (keeping every launch's escalate word alive
        # instead would pin a fresh allocation per launch)
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            st, out = K.step_internal(st, ib, A_O)
            acc += torch.count_nonzero(out.escalate)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_esc = int(acc)
        if dt < best_dt:
            best_dt, best_esc = dt, n_esc
        new, out = K.step_internal(st, ib, A_O)
        want = kernel_ref.step_internal(st, ib, A_O)
        err = max(err, _max_err(list(new) + list(out),
                                list(want[0]) + list(want[1])))
        checks += 1
        st = new
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    # the device's share of a launch: the profiler's kernel time
    dev_launch = device_ms(lambda: K.step_internal(st, ib, A_O))
    groups = G // 3
    group_ticks = max(0.0, (groups * iters - best_esc / 3) * ticks)
    res = dict(groups=groups, rows=G, launches_per_window=iters,
               windows=windows, ticks_per_launch=ticks, window_s=best_dt,
               ms_per_launch=best_dt / iters * 1e3,
               device_ms_per_launch=dev_launch,
               escalated_rows=best_esc,
               group_ticks_per_s=group_ticks / best_dt,
               checked_launches=checks, max_abs_err=err,
               kernel_launches=launches,
               leaders=int((st.role == T.ROLE_LEADER).sum()),
               terms_max=int(st.term.max()))
    if err:
        raise AssertionError(f"raft_step_internal disagrees with its plain "
                             f"version in phase A: {err}")
    if launches["raft_step_internal"] < 1:
        raise AssertionError("phase A never launched raft_step_internal")
    return res


def _equal(a, b) -> bool:
    """Every tensor of ``a`` equals its partner in ``b`` (shape and
    values)."""
    return all(x.shape == y.shape and bool((x == y).all())
               for x, y in zip(a, b, strict=True))


def multichip_phase(dev, devices, launches: int = 12,
                    path_kernels: tuple = X_PATH_KERNELS) -> dict:
    """The reference's phase_multichip legs 1 and 2 (bench.py:2735-2880)
    on ``GroupsMesh(devices)``.  Leg 1: ``make_step_sharded(internal=True)``
    over phase A's state at 300,000 rows against ``step_internal``, bit-
    exact after the same launches.  Leg 2: ``make_sharded_round`` at
    50k groups x 3 replicas, replica-major, 40 single rounds against the
    single-device ``routed_round`` and 8 waves of 3 rounds against
    ``fused_rounds``, state and inbox bit-exact.  The sharded runs come
    first, with the launch counts reset before them and read after; the
    single-device runs are timed the same way beside them.  Every kernel
    of ``path_kernels`` must have launched on leg 2."""
    import torch

    from dragonboat_tpu_torch.ops import _native
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import route as R
    from dragonboat_tpu_torch.ops import types as T
    from dragonboat_tpu_torch.ops.placement import GroupsMesh

    mesh = GroupsMesh(devices)
    D = mesh.size
    res = dict(devices=[str(d) for d in mesh.devices],
               one_card=len(set(mesh.devices)) == 1)

    # ---- leg 1: the sharded G-last step ---------------------------------
    st0, ib0 = phase_a_inputs(dev)
    G = st0.term.shape[0]
    step_shard = K.make_step_sharded(mesh, st0, ib0, out_capacity=A_O,
                                     internal=True)
    _native.reset_launch_counts()
    ibs = mesh.shard(ib0, internal=True)
    # the escalations per device, launch by launch (untimed)
    sb = mesh.shard(st0, internal=True)
    esc_dev = np.zeros((D,), np.int64)
    for _ in range(launches):
        sb, ob = step_shard(sb, ibs)
        esc_dev += np.array([int((o.escalate != 0).sum()) for o in ob.parts])
    # the same launches timed (the first one outside the window)
    sb, _ob = step_shard(mesh.shard(st0, internal=True), ibs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches - 1):
        sb, _ob = step_shard(sb, ibs)
    torch.cuda.synchronize()
    dt1 = time.perf_counter() - t0
    launches_leg1 = dict(_native.LAUNCHES)
    sa, _oa = K.step_internal(st0, ib0, A_O)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches - 1):
        sa, _oa = K.step_internal(sa, ib0, A_O)
    torch.cuda.synchronize()
    dt1_single = time.perf_counter() - t0
    a_ok = _equal(list(sa), list(mesh.join(sb)))
    gl = G // D
    ticks_dev = ((gl // 3) * launches * A_M * A_TPL
                 - esc_dev // 3 * A_M * A_TPL)
    res["leg1"] = dict(
        rows=G, launches=launches, parity_ok=a_ok,
        group_ticks_per_s=(G // 3) * (launches - 1) * A_M * A_TPL / dt1,
        single_device_group_ticks_per_s=(
            (G // 3) * (launches - 1) * A_M * A_TPL / dt1_single),
        per_device_group_ticks=[int(v) for v in ticks_dev],
        balance_ratio=float(ticks_dev.max() / max(1, ticks_dev.min())),
        kernel_launches=launches_leg1,
    )

    # ---- leg 2: the sharded round with the cross-device lane ------------
    x = leg2_inputs(dev, n_dev=D)
    groups = x["G"] // 3
    kw = dict(M=X_M, E=X_E, out_capacity=X_O, budget=X_BUD,
              xbudget=x["xbudget"], base=X_BASE, propose_leaders=True)
    round_shard = R.make_sharded_round(mesh, **kw)
    wave_shard = R.make_sharded_round(mesh, rounds=X_WAVE_ROUNDS, **kw)
    tabs = [mesh.shard(t) for t in x["tabs"]]
    _native.reset_launch_counts()
    ss, si = mesh.shard(x["state"]), mesh.shard(x["inbox"])
    lane_dev = np.zeros((D, 7), np.int64)
    route_tot = np.zeros((6,), np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = []
    for _ in range(X_ROUNDS):
        ss, si, rstats, lane = round_shard(ss, si, *tabs)
        lanes.append((rstats, lane))
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t0
    after_rounds = (mesh.join(ss), mesh.join(si))
    t0 = time.perf_counter()
    for _ in range(X_WAVES):
        ss, si, rstats, lane = wave_shard(ss, si, *tabs)
        lanes.append((rstats, lane))
    torch.cuda.synchronize()
    dt_w = time.perf_counter() - t0
    launches_leg2 = dict(_native.LAUNCHES)
    # the device's share of a round (the profiler's kernel, memset and
    # copy time), sharded and single-device, on the state reached
    dev_round = device_ms(lambda: round_shard(ss, si, *tabs), reps=5)
    for rstats, lane in lanes:
        ln = lane.cpu().numpy().astype(np.int64)
        lane_dev += ln.reshape(D, -1, 7).sum(1)
        route_tot += rstats.cpu().numpy().astype(np.int64).sum(0)
    after_waves = (mesh.join(ss), mesh.join(si))
    # the single-device kernels on the same global rows
    sr, ir = x["state"], x["inbox"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(X_ROUNDS):
        sr, ir, _s, _n = R.routed_round(
            sr, ir, x["dest"], x["rank"], out_capacity=X_O, budget=X_BUD,
            base=X_BASE, propose_leaders=True)
    torch.cuda.synchronize()
    dt2_single = time.perf_counter() - t0
    r_ok = _equal(list(sr) + list(ir),
                  list(after_rounds[0]) + list(after_rounds[1]))
    for _ in range(X_WAVES):
        sr, ir, _s, _n = R.fused_rounds(
            sr, ir, x["dest"], x["rank"], rounds=X_WAVE_ROUNDS,
            out_capacity=X_O, budget=X_BUD, base=X_BASE,
            propose_leaders=True)
    w_ok = _equal(list(sr) + list(ir),
                  list(after_waves[0]) + list(after_waves[1]))
    dev_round_single = device_ms(lambda: R.routed_round(
        sr, ir, x["dest"], x["rank"], out_capacity=X_O, budget=X_BUD,
        base=X_BASE, propose_leaders=True), reps=5)
    st_fin = after_waves[0]
    committed = st_fin.committed.cpu().numpy()
    commits = committed.reshape(3, groups).max(0)
    rows_live = lane_dev[:, 6]
    res["leg2"] = dict(
        groups=groups, rows=x["G"], xbudget=x["xbudget"],
        rounds=X_ROUNDS, waves=X_WAVES, wave_rounds=X_WAVE_ROUNDS,
        parity_rounds_ok=r_ok, parity_waves_ok=w_ok,
        rounds_per_s=X_ROUNDS / dt2,
        single_device_rounds_per_s=X_ROUNDS / dt2_single,
        device_ms_per_round=dev_round,
        single_device_device_ms_per_round=dev_round_single,
        wave_rounds_per_s=X_WAVES * X_WAVE_ROUNDS / dt_w,
        leaders=int((st_fin.role == T.ROLE_LEADER).sum()),
        groups_committing=int((commits > 0).sum()),
        cross_sent=int(lane_dev[:, 0].sum()),
        cross_delivered=int(lane_dev[:, 1].sum()),
        cross_dropped_budget=int(lane_dev[:, 2].sum()),
        cross_dropped_xlane=int(lane_dev[:, 3].sum()),
        cross_dropped_ring=int(lane_dev[:, 4].sum()),
        escalations=int(lane_dev[:, 5].sum()),
        local_route=dict(zip(("delivered", "dropped_off_device",
                              "dropped_budget", "dropped_ring",
                              "suppressed", "host_carried"),
                             route_tot.tolist())),
        per_device_lane=lane_dev.tolist(),
        per_device_commit_sum=[int(v) for v in
                               committed.reshape(D, -1).sum(1)],
        per_device_rows_live=[int(v) for v in rows_live],
        balance_ratio=float(rows_live.max() / max(1, rows_live.min())),
        kernel_launches=launches_leg2,
    )
    leg1, leg2 = res["leg1"], res["leg2"]
    fails = []
    if not leg1["parity_ok"]:
        fails.append("leg 1: the sharded step differs from step_internal")
    if not (leg2["parity_rounds_ok"] and leg2["parity_waves_ok"]):
        fails.append("leg 2: the sharded round differs from the "
                     "single-device round")
    if leg1["balance_ratio"] > 1.1 or leg2["balance_ratio"] > 1.1:
        fails.append("per-device balance above 1.1")
    if leg2["cross_dropped_xlane"] != 0:
        fails.append("lane drops at the sized xbudget")
    if D > 1 and leg2["cross_delivered"] < 1:
        fails.append("no message crossed the lane")
    if leg2["groups_committing"] != groups:
        fails.append(f"{groups - leg2['groups_committing']} groups never "
                     "committed")
    idle = [k for k in ("raft_step_internal",) if launches_leg1[k] < 1]
    idle += [k for k in path_kernels if launches_leg2[k] < 1]
    if idle:
        fails.append(f"kernels never launched on the sharded path: {idle}")
    if fails:
        raise AssertionError(f"multichip ({res['devices']}): {fails}; "
                             f"{json.dumps(res)[:3000]}")
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path — a NodeHost cluster on the card
# ---------------------------------------------------------------------------
# 300 shards (1,000 before the colocated phase joined the script): the
# base engine's host plane steps ~2.5 launches/s, and the script's
# time limit is shared with the colocated phase
SHARDS = 300
WRITES_PER_SHARD = 4
VALUE_BYTES = 16
# dragonboat's helloworld timing (RTTMillisecond 200, ElectionRTT 10,
# HeartbeatRTT 1): a 2 s election timeout and 200 ms heartbeats.  With a
# 1 s election timeout the base engine's Python host plane (~0.3-0.4 s
# per step at 1,000 rows) let leaders miss CheckQuorum windows.
RTT_MS, ELECTION_RTT, HEARTBEAT_RTT = 200, 10, 1
PARITY_EVERY = 50
CLIENT_THREADS = 64
PARITY_STATS = ("parity_step_attempts", "parity_checked_launches",
                "parity_row_attempts", "parity_checked_row_moves",
                "parity_failures")


class ErrorRecords(logging.Handler):
    """Keeps the records of a logger at ``level`` and above (ERROR by
    default).  The exec engine's step and apply workers log what
    ``step_shards`` or an apply raises and carry on, so a failed launch
    or parity check shows only here and in the engine's counters."""

    def __init__(self, level=logging.ERROR):
        super().__init__(level)
        self.lines = []

    def emit(self, record):
        exc = record.exc_info[1] if record.exc_info else None
        self.lines.append(record.getMessage()
                          + (f": {exc!r}" if exc is not None else ""))


def nodehost_phase(dev, workdir: str, shards: int = SHARDS,
                   writes: int = WRITES_PER_SHARD, mesh=None,
                   window_s: float = 0.0) -> dict:
    """300 shards x 3 replicas on three NodeHosts, each stepping its
    replicas through ``torch_step_engine_factory`` on ``dev`` (or, with
    ``mesh``, on the mesh's row blocks); every shard takes ``writes``
    writes through ``sync_propose`` from 64 client threads (with
    ``window_s``: the writes begun in that many seconds), and every
    acknowledged write is read back linearizably and from each
    replica."""
    import pickle
    import shutil
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from dragonboat_tpu_torch import (
        Config, EngineConfig, ExpertConfig, IStateMachine, NodeHost,
        NodeHostConfig, Result,
    )
    from dragonboat_tpu_torch.logger import get_logger
    from dragonboat_tpu_torch.nodehost import RequestDropped, TimeoutError_
    from dragonboat_tpu_torch.ops import _native
    from dragonboat_tpu_torch.ops.engine import torch_step_engine_factory
    from dragonboat_tpu_torch.request import SystemBusy
    from dragonboat_tpu_torch.storage.logdb import in_mem_logdb_factory
    from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

    class KV(IStateMachine):
        def __init__(self, shard_id, replica_id):
            self.data = {}

        def update(self, entry):
            k, v = pickle.loads(entry.cmd)
            self.data[k] = v
            return Result(value=len(self.data))

        def lookup(self, query):
            return dict(self.data) if query == "__all__" else self.data.get(query)

        def save_snapshot(self, w, files, done):
            w.write(pickle.dumps(self.data))

        def recover_from_snapshot(self, r, files, done):
            self.data = pickle.loads(r.read())

    cap = 1
    while cap < shards:
        cap <<= 1
    addrs = {r: f"smoke-nh-{r}" for r in (1, 2, 3)}
    reset_inproc_network()
    shutil.rmtree(workdir, ignore_errors=True)
    nhs = {}
    errors_logged = ErrorRecords()
    engine_log = get_logger("engine")
    engine_log.addHandler(errors_logged)
    res = dict(shards=shards, replicas=3, writes_per_shard=writes,
               window_s=window_s or None,
               value_bytes=VALUE_BYTES, capacity=cap, rtt_ms=RTT_MS,
               election_rtt=ELECTION_RTT, heartbeat_rtt=HEARTBEAT_RTT,
               parity_every=PARITY_EVERY,
               mesh=None if mesh is None else [str(d) for d in mesh.devices],
               reduced=[f"shards 1000 -> {shards}"] if shards < 1000 else [])
    where = dict(device=dev) if mesh is None else dict(mesh=mesh)
    try:
        for rid, addr in addrs.items():
            nhs[rid] = NodeHost(NodeHostConfig(
                nodehost_dir=os.path.join(workdir, f"nh-{rid}"),
                rtt_millisecond=RTT_MS,
                raft_address=addr,
                expert=ExpertConfig(
                    engine=EngineConfig(exec_shards=1, apply_shards=4),
                    logdb_factory=in_mem_logdb_factory,
                    step_engine_factory=torch_step_engine_factory(
                        capacity=cap, parity_every=PARITY_EVERY, **where,
                    ),
                ),
            ))
        # the main path's kernel launches are counted from here on
        _native.reset_launch_counts()
        t0 = time.perf_counter()
        for nh in nhs.values():
            nh.pause_ticks()
        for s in range(1, shards + 1):
            for rid, nh in nhs.items():
                nh.start_replica(addrs, False, KV, Config(
                    replica_id=rid, shard_id=s, election_rtt=ELECTION_RTT,
                    heartbeat_rtt=HEARTBEAT_RTT, check_quorum=True,
                    pre_vote=True, snapshot_entries=0,
                ))
        for nh in nhs.values():
            nh.resume_ticks()
        res["boot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        deadline = t0 + 300.0
        while True:
            covered = sum(
                1 for s in range(1, shards + 1)
                if nhs[1]._nodes[s].peer.raft.log.committed >= 1
                and nhs[1].get_leader_id(s)[1]
            )
            if covered == shards:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"leaders on {covered}/{shards} shards")
            time.sleep(0.25)
        res["election_s"] = time.perf_counter() - t0

        rng = np.random.default_rng(SEED)
        vals = rng.integers(0, 256, (shards, writes, VALUE_BYTES),
                            dtype=np.uint8)
        acked = {}
        lat = []
        errors = [0]
        lock = threading.Lock()

        t_stop = float("inf")  # with window_s: the window's end

        def write(job):
            s, i = job
            if time.perf_counter() > t_stop:
                return  # past the window: not begun
            key = f"k{i}"
            cmd = pickle.dumps((key, bytes(vals[s - 1, i])))
            t_first = time.perf_counter()
            end = t_first + 120.0
            while True:
                lid, ok = nhs[1].get_leader_id(s)
                nh = nhs[lid] if ok and lid in nhs else nhs[1 + (s % 3)]
                try:
                    nh.sync_propose(nh.get_noop_session(s), cmd, timeout=10.0)
                    break
                except (TimeoutError_, RequestDropped, SystemBusy):
                    with lock:
                        errors[0] += 1
                    if time.perf_counter() > end:
                        raise
                    time.sleep(0.05)
            with lock:
                acked[(s, key)] = bytes(vals[s - 1, i])
                lat.append(time.perf_counter() - t_first)

        jobs = [(s, i) for i in range(writes) for s in range(1, shards + 1)]
        t0 = time.perf_counter()
        if window_s:
            t_stop = t0 + window_s
        with StackSampler() as stacks, \
                ThreadPoolExecutor(CLIENT_THREADS) as ex:
            list(ex.map(write, jobs))
        dt = time.perf_counter() - t0
        # where the host threads spent the writes (the step workers'
        # frames: the engine's launch stages)
        res["host_stacks"] = stacks.summary()
        res["propose_s"] = dt
        res["committed_proposals"] = len(acked)
        res["committed_proposals_per_s"] = len(acked) / dt
        res["propose_latency_ms"] = dict(
            p50=float(np.percentile(lat, 50)) * 1e3,
            p99=float(np.percentile(lat, 99)) * 1e3,
            n=len(lat),
        )
        res["propose_retries"] = errors[0]

        # every acknowledged write, read back: once linearizably through
        # the shard's leader (sync_read), and from each of the three
        # replicas' own state machines (stale_read, polled until the
        # replica has applied them all)
        acked_by_shard = {s: {} for s in range(1, shards + 1)}
        for (s, k), v in acked.items():
            acked_by_shard[s][k] = v

        def missing_in(got, s):
            return [k for k, v in acked_by_shard[s].items()
                    if got.get(k) != v]

        def read_leader(s):
            end = time.perf_counter() + 120.0
            while True:
                lid, ok = nhs[1].get_leader_id(s)
                nh = nhs[lid] if ok and lid in nhs else nhs[1]
                try:
                    return missing_in(
                        nh.sync_read(s, "__all__", timeout=10.0), s)
                except (TimeoutError_, RequestDropped, SystemBusy):
                    if time.perf_counter() > end:
                        raise
                    time.sleep(0.05)

        def read_replica(job):
            s, rid = job
            end = time.perf_counter() + 120.0
            while True:
                miss = missing_in(nhs[rid].stale_read(s, "__all__"), s)
                if not miss or time.perf_counter() > end:
                    return miss
                time.sleep(0.1)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(CLIENT_THREADS) as ex:
            lin = list(ex.map(read_leader, range(1, shards + 1)))
        res["linearizable_read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CLIENT_THREADS) as ex:
            rep = list(ex.map(
                read_replica,
                [(s, rid) for s in range(1, shards + 1) for rid in nhs],
            ))
        res["replica_read_s"] = time.perf_counter() - t0
        res["linearizable_reads"] = len(lin)
        res["replica_reads"] = len(rep)
        res["readback_missing"] = sum(len(m) for m in lin + rep)
        if res["readback_missing"]:
            raise AssertionError(
                f"{res['readback_missing']} acknowledged writes missing "
                "on read-back"
            )
        launches = dict(_native.LAUNCHES)
        engines = [nh.engine.step_engine for nh in nhs.values()]
        st = [e.stats_snapshot() for e in engines]
        parity_failure = next(
            (e.parity_failure for e in engines if e.parity_failure), None)
        engine_errors = list(errors_logged.lines)
    finally:
        engine_log.removeHandler(errors_logged)
        for nh in nhs.values():
            nh.close()
        shutil.rmtree(workdir, ignore_errors=True)
    for k in ("device_steps", "device_rows_stepped", "host_rows_stepped",
              "escalations", "divergence_halts") + PARITY_STATS:
        res[k] = sum(x[k] for x in st)
    # the engines' cumulative wall-time breakdown of a launch (ms)
    res["engine_ms"] = {k: sum(x.get(k, 0) for x in st) for k in sorted(
        {k for x in st for k in x if k.startswith("t_")})}
    res["launches"] = launches
    res["engine_errors"] = len(engine_errors)
    if parity_failure is not None or res["parity_failures"]:
        raise AssertionError(
            f"{res['parity_failures']} parity failures; first: "
            f"{parity_failure}")
    if engine_errors:
        raise AssertionError(
            f"the engine's workers logged {len(engine_errors)} errors; "
            f"first: {engine_errors[0]}")
    if res["divergence_halts"] != 0:
        raise AssertionError(f"divergence halts: {res['divergence_halts']}")
    # every parity check begun on the main path must have passed, and
    # both the step launches and the row moves must have been checked
    for begun, passed in (("parity_step_attempts", "parity_checked_launches"),
                          ("parity_row_attempts", "parity_checked_row_moves")):
        if res[passed] < 1 or res[passed] != res[begun]:
            raise AssertionError(
                f"parity: {res[passed]} of {res[begun]} {begun} passed")
    idle = [k for k in nodehost_path_kernels() if launches[k] < 1]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    if len(acked) < 1 or (not window_s and len(acked) != shards * writes):
        raise AssertionError(f"acked {len(acked)} of {shards * writes}")
    return res


# ---------------------------------------------------------------------------
# phase 4: the colocated product path — the reference bench's phase C shape
# ---------------------------------------------------------------------------
COLO_SHARDS = 1000
COLO_WINDOW_S = 30.0   # phase C's timed window is 60 s
COLO_WORKERS = 8
COLO_INFLIGHT = 8
# phase C's timing (bench.py:374-395): rtt 20 ms, election_rtt 20,
# heartbeat_rtt 2
COLO_RTT_MS, COLO_ELECTION_RTT, COLO_HEARTBEAT_RTT = 20, 20, 2
COLO_PARITY_EVERY = 20
# the post-warm-up sentry (analysis/jitcheck.py): the colocated window's
# warm-up traffic, and the counters whose growth after the mark fails a
# gated window (cuda.sync_all_streams is reported only)
COLO_SENTRY_WARM_S = 5.0
SENTRY_GATED = ("native.builds", "cuda.alloc_retries", "cuda.device_alloc",
                "cuda.host_alloc")


def sentry_stalls(rows, gated) -> list:
    """The sentry's (name, at mark, now) rows of the ``gated`` counters."""
    return [r for r in rows if r[0] in gated]
COLO_PARITY_KERNELS = ("raft_step", "summarize_flags", "gather_pack",
                       "merge_escalated", "route", "inbox",
                       "select_and_blob")



class UtilizationSampler:
    """Samples the card's ``utilization.gpu`` (the share of the last
    sample period in which a kernel was running, as nvidia-smi reports
    it) every ``period`` seconds on a thread, until stopped."""

    def __init__(self, period: float = 0.5):
        import threading

        self.samples = []
        self._period = period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="smoke-util-sampler", daemon=True)

    def _run(self):
        while not self._stop.is_set():
            res = subprocess.run(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30,
            )
            if res.returncode == 0 and res.stdout.strip():
                self.samples.append(float(res.stdout.split()[0]))
            self._stop.wait(self._period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        s = self.samples
        return dict(n=len(s), mean_pct=float(np.mean(s)) if s else None,
                    max_pct=float(np.max(s)) if s else None)


class StackSampler:
    """Every ``period`` seconds, records for each other thread of the
    process the innermost frame that lies in the port's package (or
    its own innermost frame), marked "(waiting)" when that thread is
    blocked in ``threading``/``queue`` — where the host's threads spend
    the window.  Threads are grouped by name with digits replaced by
    N."""

    def __init__(self, period: float = 0.05):
        import threading

        self.counts = {}
        self.ticks = 0
        self._period = period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="smoke-stack-sampler", daemon=True)

    def _run(self):
        import threading

        me = threading.get_ident()
        while not self._stop.wait(self._period):
            names = {t.ident: t.name for t in threading.enumerate()}
            self.ticks += 1
            for tid, fr in sys._current_frames().items():
                if tid == me:
                    continue
                role = re.sub(r"\d+", "N", names.get(tid, "?"))
                where, f = None, fr
                while f is not None:
                    fn = f.f_code.co_filename
                    if "dragonboat_tpu_torch" in fn:
                        where = (f"{os.path.basename(fn)}:"
                                 f"{f.f_code.co_name}")
                        break
                    f = f.f_back
                if where is None:
                    where = (f"{os.path.basename(fr.f_code.co_filename)}:"
                             f"{fr.f_code.co_name}")
                if os.path.basename(fr.f_code.co_filename) in (
                        "threading.py", "queue.py", "selectors.py"):
                    where += " (waiting)"
                key = (role, where)
                self.counts[key] = self.counts.get(key, 0) + 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self, top: int = 12, group: str = "tpu-raft-step-N") -> dict:
        """The ``top`` (thread group, frame) pairs, each with the mean
        number of the group's threads found there; then the same for
        the frames of ``group`` (the engines' step workers) alone."""
        rows = sorted(self.counts.items(), key=lambda kv: -kv[1])

        def fmt(rs):
            return [dict(thread=r, frame=w, threads=n / max(1, self.ticks))
                    for (r, w), n in rs]

        return dict(samples=self.ticks, period_s=self._period,
                    top=fmt(rows[:top]),
                    top_of_group=fmt([kv for kv in rows
                                      if kv[0][0] == group][:top]))


def device_busy_share(seconds: float) -> dict:
    """Device activity over ``seconds`` of wall time: the union of the
    intervals of every CUDA kernel, memset and copy ``torch.profiler``
    records (from every thread of the process; overlapping operations
    count once), its share of the wall time, and the five kernels with
    the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dragonboat_tpu_torch.profiling import interval_union

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(seconds)
    wall = time.perf_counter() - t0
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
            spans.append((e.time_range.start, e.time_range.end))
    busy_s = interval_union(spans) / 1e6  # the ranges are in microseconds
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_s=wall, busy_s=busy_s,
                busy_share=busy_s / wall if wall > 0 else None,
                idle_share=1 - busy_s / wall if wall > 0 else None,
                top_ms={k[:60]: v / 1e3 for k, v in top})


def start_colo_cluster(group, workdir: str, addrs: dict, shards: int,
                       sm_cls, nhs: dict) -> dict:
    """NodeHosts at ``addrs`` (the in-proc transport, the tan WAL, the
    colocated phase's clocks) stepping on ``group``, put into ``nhs`` as
    they are made, each starting ``shards`` shards of ``sm_cls``; returns
    once every shard has a leader and a commit.  The kernel launch counts
    are reset after the NodeHosts are made, before the first replica
    starts."""
    from dragonboat_tpu_torch import (
        Config, EngineConfig, ExpertConfig, NodeHost, NodeHostConfig,
    )
    from dragonboat_tpu_torch.native import load_walwriter
    from dragonboat_tpu_torch.ops import _native
    from dragonboat_tpu_torch.storage.tan import tan_logdb_factory

    t0 = time.perf_counter()
    for rid, addr in addrs.items():
        nhs[rid] = NodeHost(NodeHostConfig(
            nodehost_dir=os.path.join(workdir, f"nh-{rid}"),
            rtt_millisecond=COLO_RTT_MS,
            raft_address=addr,
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=4),
                step_engine_factory=group.factory,
                logdb_factory=tan_logdb_factory,
            ),
        ))
    out = dict(wal_writer="native" if load_walwriter() is not None
               else "python")
    # the colocated path's kernel launches are counted from here on
    _native.reset_launch_counts()
    for nh in nhs.values():
        nh.pause_ticks()
    for s in range(1, shards + 1):
        for rid, nh in nhs.items():
            nh.start_replica(addrs, False, sm_cls, Config(
                replica_id=rid, shard_id=s,
                election_rtt=COLO_ELECTION_RTT,
                heartbeat_rtt=COLO_HEARTBEAT_RTT, pre_vote=True,
                check_quorum=True, snapshot_entries=0,
            ))
    for nh in nhs.values():
        nh.resume_ticks()
    out["boot_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deadline = t0 + 240.0
    while True:
        covered = sum(
            1 for s in range(1, shards + 1)
            if nhs[1]._nodes[s].peer.raft.log.committed >= 1
            and nhs[1].get_leader_id(s)[1]
        )
        if covered == shards:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"leaders on {covered}/{shards} shards")
        time.sleep(0.25)
    out["election_s"] = time.perf_counter() - t0
    return out


def colocated_phase(dev, workdir: str, shards: int = COLO_SHARDS,
                    window_s: float = COLO_WINDOW_S,
                    profile_s: float = 0.0,
                    parity_kernels: tuple = COLO_PARITY_KERNELS,
                    mesh=None, need_lane: bool = False,
                    sentry: bool = False) -> dict:
    """1,000 shards x 3 replicas on three NodeHosts in one process (the
    in-proc transport), all stepped by ONE ``ColocatedEngineGroup`` on
    the card with the tan WAL; phase C's drive: ``COLO_WORKERS`` workers
    keep ``COLO_INFLIGHT`` proposals in flight per shard through the
    asynchronous ``propose`` future for ``window_s`` seconds, and a
    prober issues serial ``sync_propose`` calls.  Every acknowledged
    write is then read back from all three replicas' state machines.
    The card's utilization is sampled through the window, and so are
    the host threads' stacks; ``profile_s`` > 0 also records the
    device's activity with torch.profiler for that many seconds.

    ``mesh`` (a ``GroupsMesh``) runs the engine in mesh mode: its rows
    cut into the mesh's blocks, cross-block traffic on the lane (whose
    two kernels join the parity and launch checks); ``need_lane``
    requires that the lane carried messages and dropped none.

    ``sentry`` arms the post-warm-up sentry (``analysis/jitcheck.py``):
    after the election, the window's drive runs ``COLO_SENTRY_WARM_S``
    seconds as warm-up traffic (its writes are read back too), the
    sentry is marked, and the window must then build nothing and make
    no allocator retry, device allocation or pinned host allocation."""
    import pickle
    import shutil
    import threading

    from dragonboat_tpu_torch import IStateMachine, Result
    from dragonboat_tpu_torch.analysis import jitcheck
    from dragonboat_tpu_torch.logger import get_logger
    from dragonboat_tpu_torch.ops import _native
    from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup
    from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

    class KV(IStateMachine):
        def __init__(self, shard_id, replica_id):
            self.data = {}

        def update(self, entry):
            k, v = pickle.loads(entry.cmd)
            self.data[k] = v
            return Result(value=len(self.data))

        def lookup(self, query):
            return dict(self.data) if query == "__all__" else self.data.get(query)

        def save_snapshot(self, w, files, done):
            w.write(pickle.dumps(self.data))

        def recover_from_snapshot(self, r, files, done):
            self.data = pickle.loads(r.read())

    replicas = 3
    cap = 1
    while cap < shards * replicas:
        cap <<= 1
    addrs = {r: f"colo-nh-{r}" for r in range(1, replicas + 1)}
    reset_inproc_network()
    shutil.rmtree(workdir, ignore_errors=True)
    geom = dict(capacity=cap, P=3, W=16, M=8, E=4, O=32, budget=4)
    if mesh is not None:
        parity_kernels = parity_kernels + ("xlane_pack", "xlane_scatter")
    sentry_was = jitcheck.ENABLED
    jitcheck.enable(sentry or sentry_was)
    group = ColocatedEngineGroup(
        **geom, parity_every=COLO_PARITY_EVERY,
        **(dict(device=dev) if mesh is None else dict(mesh=mesh)))
    errors_logged = ErrorRecords()
    engine_log = get_logger("engine")
    engine_log.addHandler(errors_logged)
    res = dict(shards=shards, replicas=replicas, wal="tan",
               geometry=geom, rtt_ms=COLO_RTT_MS,
               election_rtt=COLO_ELECTION_RTT,
               heartbeat_rtt=COLO_HEARTBEAT_RTT, workers=COLO_WORKERS,
               inflight_per_shard=COLO_INFLIGHT, window_s=window_s,
               parity_every=COLO_PARITY_EVERY,
               mesh=None if mesh is None else [str(d) for d in mesh.devices],
               reduced=[f"timed window 60 s -> {window_s:g} s"])
    nhs = {}
    try:
        res.update(start_colo_cluster(group, workdir, addrs, shards, KV,
                                      nhs))

        def terms():
            return [nhs[1]._nodes[s].peer.raft.term
                    for s in range(1, shards + 1)]

        stop = 0.0  # set when the window starts
        win = dict(acked=[dict() for _ in range(COLO_WORKERS)],
                   lat=[[] for _ in range(COLO_WORKERS)],
                   errors=[0] * COLO_WORKERS)
        acked, lat_ms, errors = win["acked"], win["lat"], win["errors"]
        probe_ms = []
        probe_acked = {}

        def worker(w):
            drive(w, stop, win, "w")

        def drive(w, stop, sink, prefix):
            acked, lat_ms, errors = sink["acked"], sink["lat"], sink["errors"]
            my = list(range(1 + w, shards + 1, COLO_WORKERS))
            nh = nhs[1 + (w % replicas)]
            sessions = {s: nh.get_noop_session(s) for s in my}
            pending = []  # (request, t_submit, shard, key, value)
            seq = 0

            def reap():
                nonlocal pending
                still = []
                for rs, t_sub, s, k, v in pending:
                    if rs._event.is_set():
                        if rs.code == 1:  # COMPLETED
                            acked[w][(s, k)] = v
                            lat_ms[w].append(
                                (time.perf_counter() - t_sub) * 1e3)
                        else:
                            errors[w] += 1
                    else:
                        still.append((rs, t_sub, s, k, v))
                pending = still

            while time.perf_counter() < stop:
                reap()
                by_shard = {}
                for p_ in pending:
                    by_shard[p_[2]] = by_shard.get(p_[2], 0) + 1
                for s in my:
                    while by_shard.get(s, 0) < COLO_INFLIGHT:
                        seq += 1
                        k = f"{prefix}{w}-{seq}"
                        v = seq.to_bytes(8, "little") * 2
                        try:
                            rs = nh.propose(sessions[s], pickle.dumps((k, v)),
                                            30.0)
                        except Exception:  # noqa: BLE001 — counted
                            errors[w] += 1
                            break
                        pending.append((rs, time.perf_counter(), s, k, v))
                        by_shard[s] = by_shard.get(s, 0) + 1
                time.sleep(0.001)
            # the in-flight tail: late commits count, the rest are errors
            drain_end = time.perf_counter() + 20.0
            while pending and time.perf_counter() < drain_end:
                reap()
                time.sleep(0.01)
            errors[w] += len(pending)

        def prober():
            nh = nhs[1]
            targets = [1, max(1, shards // 2), shards]
            sess = {s: nh.get_noop_session(s) for s in targets}
            i = 0
            while time.perf_counter() < stop:
                s = targets[i % len(targets)]
                i += 1
                k = f"probe-{i}"
                t1 = time.perf_counter()
                try:
                    nh.sync_propose(sess[s], pickle.dumps((k, b"p")),
                                    timeout=30.0)
                except Exception:  # noqa: BLE001 — a lost probe sample
                    continue
                probe_ms.append((time.perf_counter() - t1) * 1e3)
                probe_acked[(s, k)] = b"p"

        warm_acked = {}
        if sentry:
            # warm-up traffic: the window's own drive, before the mark
            t0 = time.perf_counter()
            warm = dict(acked=[dict() for _ in range(COLO_WORKERS)],
                        lat=[[] for _ in range(COLO_WORKERS)],
                        errors=[0] * COLO_WORKERS)
            warm_stop = t0 + COLO_SENTRY_WARM_S
            threads = [threading.Thread(
                target=drive, args=(w, warm_stop, warm, "warm"),
                name=f"smoke-colo-warm-{w}", daemon=True)
                for w in range(COLO_WORKERS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=COLO_SENTRY_WARM_S + 90.0)
            for a in warm["acked"]:
                warm_acked.update(a)
            st = group.core.stats_snapshot()
            res["sentry"] = dict(
                warm_s=time.perf_counter() - t0,
                warm_acked=len(warm_acked),
                warm_launches=st["launches"],
                warm_fused_waves=st["fused_waves"],
                warm_parity_checks=st["parity_checks_raft_step"],
                since_engine_warm=jitcheck.retraces())
            if st["parity_checks_raft_step"] < 1 or st["fused_waves"] < 1:
                raise AssertionError(
                    f"the sentry's warm-up ran no parity check or no fused "
                    f"wave: {res['sentry']}")
            jitcheck.mark_warm()
            res["sentry"]["at_mark"] = jitcheck._DEFAULT.snapshot()
        term0 = terms()
        stats0 = group.core.stats_snapshot()
        stop = time.perf_counter() + window_s
        threads = [threading.Thread(target=worker, args=(w,),
                                    name=f"smoke-colo-writer-{w}", daemon=True)
                   for w in range(COLO_WORKERS)]
        threads.append(threading.Thread(target=prober, name="smoke-colo-probe",
                                        daemon=True))
        t0 = time.perf_counter()
        with UtilizationSampler() as util, StackSampler() as stacks:
            for t in threads:
                t.start()
            if profile_s:
                # the device's busy share over a slice of the window, from
                # torch.profiler (its CPU tracing slows the process: the
                # window's own numbers are then not comparable)
                time.sleep(window_s / 3)
                res["device_busy"] = device_busy_share(profile_s)
            for t in threads:
                t.join(timeout=window_s + 90.0)
        dt = time.perf_counter() - t0
        if sentry:
            res["sentry"]["window"] = jitcheck.retraces()
        res["gpu_utilization"] = util.summary()
        res["host_stacks"] = stacks.summary()
        stats1 = group.core.stats_snapshot()
        term1 = terms()
        all_acked = dict(probe_acked)
        for a in acked:
            all_acked.update(a)
        lat = sorted(x for ls in lat_ms for x in ls)

        def pct(arr, p):
            return float(arr[min(len(arr) - 1, int(len(arr) * p))]) if arr else None

        probe_ms.sort()
        res.update(
            timed_s=dt,
            committed=len(all_acked),
            committed_proposals_per_s=len(all_acked) / dt,
            errors=sum(errors),
            latency_ms=dict(p50=pct(lat, 0.50), p99=pct(lat, 0.99),
                            n=len(lat)),
            probe_latency_ms=dict(p50=pct(probe_ms, 0.50),
                                  p99=pct(probe_ms, 0.99), n=len(probe_ms)),
            shards_with_new_term=sum(a != b for a, b in zip(term0, term1)),
            window_launches=stats1["launches"] - stats0["launches"],
        )

        # every acknowledged write, read back from all three replicas'
        # state machines (polled until each replica has applied it)
        by_shard = {}
        for (s, k), v in list(all_acked.items()) + list(warm_acked.items()):
            by_shard.setdefault(s, {})[k] = v
        t0 = time.perf_counter()
        missing = 0
        for s, want in by_shard.items():
            for rid in nhs:
                end = time.perf_counter() + 60.0
                while True:
                    got = nhs[rid].stale_read(s, "__all__")
                    miss = [k for k, v in want.items() if got.get(k) != v]
                    if not miss or time.perf_counter() > end:
                        break
                    time.sleep(0.05)
                missing += len(miss)
        res["readback_s"] = time.perf_counter() - t0
        res["readback_missing"] = missing
        res["readback_replica_reads"] = len(by_shard) * replicas
        launches = dict(_native.LAUNCHES)
        entry_launches = dict(_native.ENTRY_LAUNCHES)
        st = group.core.stats_snapshot()
        parity_failure = group.core.parity_failure
        engine_errors = list(errors_logged.lines)
        if mesh is not None:
            # where the rows sit: the shards whose replicas span blocks
            core = group.core
            res["straddling_shards"] = sum(
                len({core.device_coordinate(s, r) for r in nhs}) > 1
                for s in range(1, shards + 1))
    finally:
        jitcheck.enable(sentry_was)
        engine_log.removeHandler(errors_logged)
        for nh in nhs.values():
            nh.pause_ticks()
        for nh in nhs.values():
            nh.close()
        shutil.rmtree(workdir, ignore_errors=True)
    keys = ("launches", "device_steps", "device_rows_stepped",
            "host_rows_stepped", "escalations", "divergence_halts",
            "fused_waves", "fused_rounds_stepped", "fused_fences",
            "routed_delivered", "routed_host_carried", "routed_dropped",
            "routed_dropped_off_device", "routed_dropped_budget",
            "routed_dropped_ring", "sel_fallbacks", "pipeline_overlap_s",
            "pipeline_fences", "early_completions", "readback_windows",
            "parity_failures", "parity_row_attempts",
            "parity_checked_row_moves", "lane_sent", "lane_delivered",
            "lane_dropped_xlane")
    res["engine"] = {k: st.get(k, 0) for k in keys}
    # the engine's cumulative wall-time breakdown of the launch path (ms)
    res["engine_ms"] = {k: v for k, v in sorted(st.items())
                        if k.startswith("t_")}
    res["parity"] = {
        k: [st[f"parity_attempts_{k}"], st[f"parity_checks_{k}"]]
        for k in parity_kernels
    }
    res["kernel_launches"] = launches
    res["entry_launches"] = entry_launches
    res["engine_errors"] = len(engine_errors)
    if res["readback_missing"]:
        raise AssertionError(
            f"{res['readback_missing']} acknowledged writes missing on "
            "read-back")
    if res["committed"] < 1:
        raise AssertionError("no proposal was acknowledged")
    if parity_failure is not None or st["parity_failures"]:
        raise AssertionError(
            f"{st['parity_failures']} parity failures; first: "
            f"{parity_failure}")
    if engine_errors:
        raise AssertionError(
            f"the engine's workers logged {len(engine_errors)} errors; "
            f"first: {engine_errors[0]}")
    if st["divergence_halts"] != 0:
        raise AssertionError(f"divergence halts: {st['divergence_halts']}")
    for k, (begun, passed) in res["parity"].items():
        if passed < 1 or passed != begun:
            raise AssertionError(
                f"parity of {k}: {passed} of {begun} checks passed")
    idle = [k for k in parity_kernels if launches[k] < 1]
    if idle:
        raise AssertionError(
            f"kernels never launched on the colocated path: {idle}")
    if st["routed_delivered"] < 1:
        raise AssertionError("no message was routed on the card")
    if need_lane and (st["lane_sent"] < 1 or st["lane_delivered"] < 1
                      or st["lane_dropped_xlane"] != 0):
        raise AssertionError(
            f"the lane carried {st['lane_sent']}, delivered "
            f"{st['lane_delivered']} and dropped "
            f"{st['lane_dropped_xlane']} messages")
    if sentry:
        stalls = sentry_stalls(res["sentry"]["window"], SENTRY_GATED)
        if stalls:
            print(json.dumps(dict(phase="colocated", sentry=res["sentry"])),
                  file=sys.stderr, flush=True)
            raise AssertionError(
                "post-warm-up stalls in the colocated window:\n"
                + jitcheck.format_retraces(stalls))
    return res


# ---------------------------------------------------------------------------
# phase 8b: the launch pipeline's contracts on the colocated path
# ---------------------------------------------------------------------------
# tests/test_pipeline.py's contracts (F1 fence, F2 parity, F3
# exactly-once, W1 one readback window a generation) at the engine's
# default pipeline (depth 2, fused waves of 3 rounds: ops/colocated.py
# :156-174) with the sync floor off, so every generation in flight is in
# flight on the card
PIPE_DEPTH, PIPE_ROUNDS = 2, 3
PIPE_WINDOW_S = 20.0
PIPE_DRAIN_S = 10.0
PIPE_MIN_WAVES = 50  # fewer fused waves are reported, the width kept
PIPE_THREAD_WAIT_S = 10.0
PIPE_TAG = "cpl"
# leg (b): the reference's scripted cases at their own geometry, the
# depth-2 escalation last (ROADMAP §3)
PIPE_CASES = (
    ("depth1_serial", "TestPipelineKnobs", "test_depth1_is_serial"),
    ("escalation_hold", "TestFusedWaves",
     "test_escalation_hold_fences_to_single_round"),
    ("stop_detach_fence", "TestPipelineFences",
     "test_stop_shard_and_detach_fence_exactly_once"),
    ("escalation_depth2", "TestPipelineFences", "test_escalation_at_depth2"),
)
PIPE_STATS = ("launches", "fused_waves", "fused_rounds_stepped",
              "fused_fences", "pipeline_fences", "pipeline_overlap_s",
              "readback_windows", "sel_fallbacks", "evict_escalation",
              "divergence_halts", "lane_rows", "early_completions")


def reference_pipeline(dev, tmp: str):
    """``tests/test_pipeline.py`` executed on the port
    (``tests/port_loader.py``), its engines on ``dev`` and its
    directories under ``tmp``: the module, and its colocated siblings."""
    import tempfile

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from port_loader import load_colocated_siblings, load_on_port

    saved, tempfile.tempdir = tempfile.tempdir, tmp
    try:
        sib = load_colocated_siblings(PIPE_TAG, str(dev))
        pipe = load_on_port("test_pipeline.py", f"{PIPE_TAG}_pipeline",
                            tag=PIPE_TAG)
    finally:
        tempfile.tempdir = saved
    return pipe, sib


def raft_threads() -> set:
    import threading

    return {t for t in threading.enumerate()
            if t.name.startswith("tpu-raft-") and t.is_alive()}


def pipeline_full_width(dev, workdir: str, pipe,
                        shards: int = COLO_SHARDS,
                        window_s: float = PIPE_WINDOW_S) -> dict:
    """(a) The colocated phase's layout (1,000 shards x 3 on three
    NodeHosts sharing ONE ``ColocatedEngineGroup`` on the card, the tan
    WAL) at depth 2 and fused waves of 3 with the sync floor off,
    ``AuditKV`` as the state machine; ``COLO_WORKERS`` workers keep
    ``COLO_INFLIGHT`` proposals in flight a shard for ``window_s``
    seconds with the hostplane parity oracle armed and the reference's
    fence probe (``arm_fence_probe``) on the core from before the first
    replica starts.  Returns the gates' figures and a list of the gates
    that failed."""
    import shutil
    import threading

    from dragonboat_tpu_torch.audit import AuditKV, audit_set_cmd
    from dragonboat_tpu_torch.logger import get_logger
    from dragonboat_tpu_torch.ops import _native, hostplane
    from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup
    from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

    replicas = 3
    cap = 1 << (shards * replicas - 1).bit_length()
    geom = dict(capacity=cap, P=3, W=16, M=8, E=4, O=32, budget=4,
                pipeline_depth=PIPE_DEPTH, fused_rounds=PIPE_ROUNDS,
                sync_floor_ms=0.0)
    addrs = {r: f"pipe-nh-{r}" for r in range(1, replicas + 1)}
    reset_inproc_network()
    shutil.rmtree(workdir, ignore_errors=True)
    group = ColocatedEngineGroup(**geom, parity_every=COLO_PARITY_EVERY,
                                 device=dev)
    group.factory(None)
    core = group.core
    violations = pipe.arm_fence_probe(core)
    errors_logged = ErrorRecords()
    engine_log = get_logger("engine")
    engine_log.addHandler(errors_logged)
    res = dict(shards=shards, replicas=replicas, wal="tan",
               state_machine="AuditKV", geometry=geom,
               rtt_ms=COLO_RTT_MS, election_rtt=COLO_ELECTION_RTT,
               heartbeat_rtt=COLO_HEARTBEAT_RTT, workers=COLO_WORKERS,
               inflight_per_shard=COLO_INFLIGHT, window_s=window_s,
               parity_every=COLO_PARITY_EVERY, hostplane_parity=True,
               reduced=[f"timed window 60 s -> {window_s:g} s"])
    threads0 = raft_threads()
    saved_parity = hostplane.PARITY
    hostplane.PARITY = True
    parity0 = hostplane.PARITY_FAILURE_COUNT
    nhs = {}
    try:
        res.update(start_colo_cluster(group, workdir, addrs, shards,
                                      AuditKV, nhs))
        stop = time.perf_counter() + window_s
        acked = [dict() for _ in range(COLO_WORKERS)]  # shard -> keys
        errors = [0] * COLO_WORKERS

        def worker(w):
            my = list(range(1 + w, shards + 1, COLO_WORKERS))
            nh = nhs[1 + (w % replicas)]
            sessions = {s: nh.get_noop_session(s) for s in my}
            pending = []  # (request, shard, key)
            seq = 0

            def reap():
                nonlocal pending
                still = []
                for rs, s, k in pending:
                    if not rs._event.is_set():
                        still.append((rs, s, k))
                    elif rs.code == 1:  # COMPLETED
                        acked[w].setdefault(s, set()).add(k)
                    else:
                        errors[w] += 1
                pending = still

            while time.perf_counter() < stop:
                reap()
                by_shard = {}
                for p_ in pending:
                    by_shard[p_[1]] = by_shard.get(p_[1], 0) + 1
                for s in my:
                    while by_shard.get(s, 0) < COLO_INFLIGHT:
                        seq += 1
                        k = f"w{w}-{seq}"
                        try:
                            rs = nh.propose(sessions[s],
                                            audit_set_cmd(k, seq), 30.0)
                        except Exception:  # noqa: BLE001 — counted
                            errors[w] += 1
                            break
                        pending.append((rs, s, k))
                        by_shard[s] = by_shard.get(s, 0) + 1
                time.sleep(0.001)
            drain_end = time.perf_counter() + PIPE_DRAIN_S
            while pending and time.perf_counter() < drain_end:
                reap()
                time.sleep(0.01)
            errors[w] += len(pending)

        threads = [threading.Thread(target=worker, args=(w,),
                                    name=f"smoke-pipe-writer-{w}",
                                    daemon=True)
                   for w in range(COLO_WORKERS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=window_s + PIPE_DRAIN_S + 60.0)
        res["timed_s"] = time.perf_counter() - t0
        launches = dict(_native.LAUNCHES)
        keys = {}
        for a in acked:
            for s, ks in a.items():
                keys.setdefault(s, set()).update(ks)
        res.update(committed=sum(len(ks) for ks in keys.values()),
                   errors=sum(errors))
        res["committed_per_s"] = res["committed"] / res["timed_s"]
        # F3: every acknowledged key applied exactly once on every
        # replica (test_pipeline.py's settle_journals, then its count)
        t0 = time.perf_counter()
        end = t0 + 60.0
        lost = dup = unsettled = 0
        for s, ks in keys.items():
            try:
                journals = pipe.settle_journals(
                    nhs, s, ks, timeout=max(0.5, end - time.perf_counter()))
            except AssertionError:
                unsettled += 1
                continue
            if len(journals) != replicas:
                unsettled += 1
            for j in journals.values():
                applied = [k for _, k, _ in j if k in ks]
                dup += max(0, len(applied) - len(ks))
                lost += len(ks - set(applied))
        res["journals"] = dict(shards=len(keys), unsettled=unsettled,
                               lost=lost, duplicated=dup,
                               settle_s=time.perf_counter() - t0)
        # W1: one readback window a generation, read under the core lock
        with core._lock:
            st = dict(core.stats)
            inflight = len(core._inflight)
        res["w1"] = dict(readback_windows=st["readback_windows"],
                         inflight=inflight, launches=st["launches"],
                         sel_fallbacks=st.get("sel_fallbacks", 0))
        engine_errors = list(errors_logged.lines)
    finally:
        hostplane.PARITY = saved_parity
        engine_log.removeHandler(errors_logged)
        for nh in nhs.values():
            nh.pause_ticks()
        for nh in nhs.values():
            nh.close()
        shutil.rmtree(workdir, ignore_errors=True)
    res["closed"] = dict(inflight=len(core._inflight),
                         deferred=len(core._deferred))
    end = time.perf_counter() + PIPE_THREAD_WAIT_S
    while (left := raft_threads() - threads0) and time.perf_counter() < end:
        time.sleep(0.2)
    res["closed"]["threads_left"] = sorted(t.name for t in left)
    res["engine"] = {k: st.get(k, 0) for k in PIPE_STATS}
    res["probe_violations"] = violations[:3]
    res["parity_failure_count"] = hostplane.PARITY_FAILURE_COUNT - parity0
    res["parity"] = {
        k: [st[f"parity_attempts_{k}"], st[f"parity_checks_{k}"]]
        for k in COLO_PARITY_KERNELS
    }
    res["kernel_launches"] = launches
    res["engine_errors"] = engine_errors[:3]
    e, w1 = res["engine"], res["w1"]
    if e["fused_waves"] < PIPE_MIN_WAVES:
        res["fewer_waves_than"] = PIPE_MIN_WAVES
    gates = [
        ("F1 fence probe", not violations),
        ("F2 hostplane parity", res["parity_failure_count"] == 0
         and e["divergence_halts"] == 0),
        ("F3 exactly-once", res["committed"] > 0 and not (
            lost or dup or unsettled)),
        ("W1 one readback window a generation",
         w1["readback_windows"] + w1["inflight"]
         == w1["launches"] + w1["sel_fallbacks"]),
        ("fused waves", e["fused_waves"] > 0
         and e["fused_rounds_stepped"] >= PIPE_ROUNDS * e["fused_waves"]),
        ("pipeline overlap", e["pipeline_overlap_s"] > 0),
        ("lane rows", e["lane_rows"] > 0),
        ("clean close", not res["closed"]["inflight"]
         and not res["closed"]["deferred"]
         and not res["closed"]["threads_left"]),
        ("path kernels launched",
         all(launches.get(k, 0) > 0 for k in colo_path_kernels())),
        ("parity self-check", st["parity_failures"] == 0
         and all(0 < b == a for a, b in res["parity"].values())),
        ("engine errors", not engine_errors),
    ]
    res["failed"] = [name for name, ok in gates if not ok]
    return res


def pipeline_scripted(pipe, sib) -> dict:
    """(b) The reference's scripted cases (``PIPE_CASES``) on the card at
    their own geometry, with the hostplane parity oracle armed and the
    reference's fence probe on every core from its first launch (a group
    class that arms it; at depth 1 it also counts the generations left
    in flight after each step).  A case's own assertions raise."""
    from dragonboat_tpu_torch.ops import hostplane

    groups = []
    base = pipe.ColocatedEngineGroup

    class ProbedGroup(base):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.violations = None
            self.steps = self.left_inflight = 0
            groups.append(self)

        def factory(self, nodehost):
            facade = super().factory(nodehost)
            with self._lock:
                if self.violations is None:
                    core = self._core
                    self.violations = pipe.arm_fence_probe(core)
                    step = core._step_colocated

                    def counted(nodes, worker_id):
                        step(nodes, worker_id)
                        self.steps += 1
                        self.left_inflight += bool(core._inflight)

                    core._step_colocated = counted
            return facade

    from port_loader import leader_off_first_row

    tcc = sib["test_chaos_colocated"]
    wait = pipe.wait_for_leader
    saved_parity = hostplane.PARITY
    hostplane.PARITY = True
    pipe.ColocatedEngineGroup = tcc.ColocatedEngineGroup = ProbedGroup
    res = {}
    try:
        for name, cls, meth in PIPE_CASES:
            del groups[:]
            before = hostplane.PARITY_FAILURE_COUNT
            t0 = time.perf_counter()
            # the hold case's leader kept off the row it holds, as the
            # CPU test keeps it (tests/port_loader.py)
            pipe.wait_for_leader = (leader_off_first_row(wait) if
                                    name == "escalation_hold" else wait)
            getattr(getattr(pipe, cls)(), meth)()
            cores = [g.core for g in groups if g.core is not None]
            row = dict(s=time.perf_counter() - t0,
                       depth=[c._pipeline_depth for c in cores],
                       parity_failure_count=(
                           hostplane.PARITY_FAILURE_COUNT - before),
                       probe_violations=[v for g in groups
                                         for v in g.violations or ()][:3],
                       steps=sum(g.steps for g in groups),
                       steps_left_inflight=sum(g.left_inflight
                                               for g in groups))
            row.update({k: sum(c.stats.get(k, 0) for c in cores)
                        for k in PIPE_STATS})
            res[name] = row
            if row["probe_violations"] or row["parity_failure_count"]:
                raise AssertionError(f"pipeline {name}: {row}")
            if name == "depth1_serial" and (
                    row["steps"] < 1 or row["steps_left_inflight"]):
                raise AssertionError(f"pipeline {name}: {row}")
    finally:
        hostplane.PARITY = saved_parity
        pipe.ColocatedEngineGroup = tcc.ColocatedEngineGroup = base
        pipe.wait_for_leader = wait
    return res


def pipeline_phase(dev, workdir: str) -> dict:
    """(a) ``pipeline_full_width`` then (b) ``pipeline_scripted``; every
    gate of (a) is checked after (b) has run too, and a failed gate
    prints the phase's numbers to stderr as one JSON line before the
    exception."""
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    tmp = os.path.join(workdir, "tmp")
    os.makedirs(tmp)
    res = {}
    try:
        pipe, sib = reference_pipeline(dev, tmp)
        t0 = time.perf_counter()
        res["full_width"] = pipeline_full_width(
            dev, os.path.join(workdir, "full"), pipe)
        res["full_width_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["scripted"] = pipeline_scripted(pipe, sib)
        res["scripted_s"] = time.perf_counter() - t0
        res["reference_loaded"] = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith(("jax.", "jaxlib"))
            or m == "dragonboat_tpu" or m.startswith("dragonboat_tpu."))
        failed = res["full_width"]["failed"]
        if res["reference_loaded"]:
            failed = failed + ["imports the reference"]
        if failed:
            raise AssertionError(f"pipeline gates failed: {failed}")
    except BaseException:
        print(json.dumps(dict(phase="pipeline", failed=True, **res),
                         default=str), file=sys.stderr, flush=True)
        raise
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    res["kernel_launches"] = res["full_width"]["kernel_launches"]
    return res


# ---------------------------------------------------------------------------
# phase 8c: the scale path (BASELINE configs 3 and 4)
# ---------------------------------------------------------------------------
# tests/test_scale.py's run_scale on the port: every replica of every
# shard on ONE ColocatedEngineGroup, on-disk state machines, capacity =
# pow2(rows), W=16, M=8, E=2, O=32, budget 8, rtt 50 ms, sampled
# proposals, then leader kills that prefer a cold (quiesce-parked) shard
SCALE_TAG = "csc"
SCALE_SHARDS_A = 2000     # config 3's 10,000 shards x 5, cut
SCALE_SHARDS_B = 1050     # config 4's 100k ragged shards, cut
SCALE_PROPOSALS = 100
SCALE_CHURN_A, SCALE_CHURN_B = 5, 2
SCALE_PARITY_EVERY = 20
# run_scale waits for full leader coverage up to max(300 s, 0.3 s a
# shard); the phase caps that wait (the gate is 98% coverage)
SCALE_ELECTION_WAIT_S = 120.0
SCALE_STATS = ("launches", "device_steps", "device_rows_stepped",
               "host_rows_stepped", "escalations", "divergence_halts",
               "fused_waves", "routed_delivered", "routed_dropped",
               "routed_dropped_budget", "routed_dropped_ring",
               "routed_host_carried", "sel_fallbacks", "evict_host_plan",
               "parity_failures", "t_device_ms", "t_updates_ms")


def reference_scale(tmp: str, mixed: bool):
    """``tests/test_scale.py`` executed on the port (``port_loader``), its
    directories under ``tmp``, with ``SCALE_MIXED`` set for config 4.
    The edits: the on-disk state machines' ``/tmp/scale-sm`` under
    ``tmp``; the import of the reference's vector engine factory naming
    the port's; the election wait capped by ``SCALE_ELECTION_WAIT_S``
    (a module global the phase sets)."""
    import tempfile

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from port_loader import load_on_port

    tag = f"{SCALE_TAG}{4 if mixed else 3}"
    saved, tempfile.tempdir = tempfile.tempdir, tmp
    saved_env = os.environ.get("SCALE_MIXED")
    os.environ["SCALE_MIXED"] = "1" if mixed else "0"
    try:
        mod = load_on_port(
            "test_scale.py", f"{tag}_scale", tag=tag,
            replace=[
                ("/tmp/scale-sm", os.path.join(tmp, "scale-sm"), 2),
                ("from dragonboat_tpu.ops.engine import "
                 "vector_step_engine_factory",
                 "from dragonboat_tpu.ops.engine import "
                 "torch_step_engine_factory as vector_step_engine_factory",
                 1),
                ("deadline = time.time() + max(300.0, shards * 0.3)",
                 "deadline = time.time() + min(SCALE_ELECTION_WAIT_S, "
                 "max(300.0, shards * 0.3))", 1),
            ])
    finally:
        tempfile.tempdir = saved
        if saved_env is None:
            os.environ.pop("SCALE_MIXED", None)
        else:
            os.environ["SCALE_MIXED"] = saved_env
    return mod


def scale_leg(dev, mod, shards: int, churn: int, sentry: bool,
              election_wait_s: float) -> dict:
    """One ``run_scale`` of ``mod`` on ``ColocatedEngineGroup(device=dev,
    parity_every=SCALE_PARITY_EVERY)``; returns the reference's report
    (its engine stats cut to ``SCALE_STATS``), the port's figures and a
    list of the gates that failed.  ``sentry`` arms the post-warm-up
    sentry: the election storm is the warm-up traffic, the mark is the
    start of the propose window (the first ``LatencyBudget``), the
    window ends with the last proposal, and the churn follows."""
    import contextlib
    import threading

    from dragonboat_tpu_torch.analysis import jitcheck
    from dragonboat_tpu_torch.logger import get_logger
    from dragonboat_tpu_torch.ops import _native

    groups = []
    base = mod.ColocatedEngineGroup

    class ScaleGroup(base):
        def __init__(self, **kw):
            super().__init__(device=dev, parity_every=SCALE_PARITY_EVERY,
                             **kw)
            groups.append((self, dict(kw)))

    tiers = {}
    stop = threading.Event()

    def watch_tiers():
        while not stop.wait(0.05):
            if groups and groups[0][0].core is not None:
                t = groups[0][0].core._sel_tier
                tiers[t] = tiers.get(t, 0) + 1

    sent = dict(window=None, proposals=0)
    sentry_lock = threading.Lock()
    win = jitcheck.Sentry()
    budget_cls = mod.LatencyBudget
    propose = mod.propose_with_retry

    def budget_at_window(*a, **kw):
        # the propose window starts: the storm's growth, then the mark
        sent["storm"] = jitcheck.retraces()
        win.mark()
        sent["at_mark"] = dict(win._snap)
        return budget_cls(*a, **kw)

    def propose_read(*a, **kw):
        try:
            return propose(*a, **kw)
        finally:
            snap = win.snapshot()
            with sentry_lock:
                sent["window"] = snap
                sent["proposals"] += 1

    errors_logged = ErrorRecords()
    engine_log = get_logger("engine")
    engine_log.addHandler(errors_logged)
    sentry_was = jitcheck.ENABLED
    jitcheck.enable(sentry or sentry_was)
    mod.ColocatedEngineGroup = ScaleGroup
    mod.SCALE_ELECTION_WAIT_S = election_wait_s
    if sentry:
        mod.LatencyBudget = budget_at_window
        mod.propose_with_retry = propose_read
    watcher = threading.Thread(target=watch_tiers, name="smoke-scale-tiers",
                               daemon=True)
    _native.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        watcher.start()
        with UtilizationSampler() as util, \
                contextlib.redirect_stdout(sys.stderr):
            report = mod.run_scale(shards, engine="colocated",
                                   proposals=SCALE_PROPOSALS,
                                   churn_kills=churn)
        end_snap = win.snapshot() if sentry else None
    finally:
        stop.set()
        watcher.join()
        jitcheck.enable(sentry_was)
        engine_log.removeHandler(errors_logged)
        mod.ColocatedEngineGroup = base
        mod.LatencyBudget = budget_cls
        mod.propose_with_retry = propose
    launches = dict(_native.LAUNCHES)
    [(group, kw)] = groups
    st = dict(group.core.stats)
    res = {k: v for k, v in report.items() if k != "engine_stats"}
    res.update(
        run_s=time.perf_counter() - t0,
        geometry=dict(kw, device=str(dev), parity_every=SCALE_PARITY_EVERY),
        engine={k: st.get(k, 0) for k in SCALE_STATS},
        parity={k: [st[f"parity_attempts_{k}"], st[f"parity_checks_{k}"]]
                for k in COLO_PARITY_KERNELS},
        tiers_sampled=dict(sorted(tiers.items())),
        gpu_utilization=util.summary(),
        kernel_launches=launches,
        engine_errors=errors_logged.lines[:3])
    gates = [
        ("leader coverage >= 98%",
         report["leader_coverage"] >= shards * 0.98),
        ("committed >= 90% of attempted",
         report["proposals_committed"]
         >= report["proposals_attempted"] * 0.9),
        ("device rows stepped", st["device_rows_stepped"] > 0),
        ("divergence halts", st["divergence_halts"] == 0),
        ("parity self-check", st["parity_failures"] == 0
         and group.core.parity_failure is None
         and all(0 < b == a for a, b in res["parity"].values())),
        ("path kernels launched",
         all(launches.get(k, 0) > 0 for k in colo_path_kernels())),
        ("engine errors", not errors_logged.lines),
    ]
    if churn:
        ch = report["churn"]
        gates += [
            ("re-elected every kill",
             ch["reelected"] == ch["kills"] >= max(1, churn - 1)),
            ("leaked futures", ch["leaked_futures"] == 0),
        ]
    if sentry:
        def growth(a, b):
            return [(k, a[k], b[k]) for k in a if b[k] > a[k]]

        at_mark = sent.get("at_mark")
        window = sent["window"] or at_mark
        res["sentry"] = dict(
            storm=sent.get("storm"), proposals_read=sent["proposals"],
            window=growth(at_mark, window) if at_mark else None,
            churn=growth(window, end_snap) if at_mark else None,
            after_mark=growth(at_mark, end_snap) if at_mark else None)
        after = res["sentry"]["after_mark"] or []
        gates += [
            ("sentry marked at the propose window", at_mark is not None),
            ("no build or allocator retry after the mark",
             not sentry_stalls(after, ("native.builds",
                                       "cuda.alloc_retries"))),
            ("no device or pinned allocation in the propose window",
             not sentry_stalls(res["sentry"]["window"] or [],
                               ("cuda.device_alloc", "cuda.host_alloc"))),
        ]
    res["failed"] = [name for name, ok in gates if not ok]
    return res


def scale_phase(dev, workdir: str, shards_a: int = SCALE_SHARDS_A,
                shards_b: int = SCALE_SHARDS_B) -> dict:
    """(a) config 3: ``shards_a`` shards x 5 on 5 NodeHosts, P = 5, 5
    leader kills, the post-warm-up sentry armed; (b) config 4's ragged
    3/5/7 memberships: ``shards_b`` shards on 7 NodeHosts, P = 7, 2
    leader kills.  Every gate of both legs is checked after both ran;
    a failed gate prints the phase's numbers to stderr as one JSON line
    before the exception."""
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    res = {}
    try:
        for leg, mixed, shards, churn in (("a", False, shards_a,
                                           SCALE_CHURN_A),
                                          ("b", True, shards_b,
                                           SCALE_CHURN_B)):
            tmp = os.path.join(workdir, leg)
            os.makedirs(tmp)
            mod = reference_scale(tmp, mixed)
            wait = max(SCALE_ELECTION_WAIT_S, shards * 0.03)
            res[leg] = scale_leg(dev, mod, shards, churn,
                                 sentry=not mixed, election_wait_s=wait)
            shutil.rmtree(tmp, ignore_errors=True)
        res["reference_loaded"] = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith(("jax.", "jaxlib"))
            or m == "dragonboat_tpu" or m.startswith("dragonboat_tpu."))
        failed = [f"{leg}: {g}" for leg in ("a", "b")
                  for g in res[leg]["failed"]]
        if res["reference_loaded"]:
            failed.append("imports the reference")
        if failed:
            raise AssertionError(f"scale gates failed: {failed}")
    except BaseException:
        print(json.dumps(dict(phase="scale", failed=True, **res),
                         default=str), file=sys.stderr, flush=True)
        raise
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    res["kernel_launches"] = {
        k: res["a"]["kernel_launches"].get(k, 0)
        + res["b"]["kernel_launches"].get(k, 0)
        for k in set(res["a"]["kernel_launches"])
        | set(res["b"]["kernel_launches"])}
    return res


# ---------------------------------------------------------------------------
# phase 10: an audited churn round behind a gateway on the colocated path
# ---------------------------------------------------------------------------
# the reference's acceptance round (tests/test_audit.py:560, docs/AUDIT.md)
AUDIT_SHARDS = 256
AUDIT_SAMPLE = 6
AUDIT_SEED = 1  # the reference's default DRAGONBOAT_TPU_SEED
AUDIT_CAPACITY = 1024  # 768 rows, and a fourth host's after the balance move
AUDIT_RTT_MS = 40  # the reference's: 768 rows' boot storm inside the window
AUDIT_WORKLOAD_S = 30.0
# test_chaos_colocated.py's forced-escalation window (:160, :181)
AUDIT_ESCALATE_P, AUDIT_ESCALATE_S = 0.08, 4.0


def audit_phase(dev, workdir: str, shards: int = AUDIT_SHARDS,
                seed: int = AUDIT_SEED,
                workload_s: float = AUDIT_WORKLOAD_S) -> dict:
    """(a) The reference's audited churn round on the product path: 256
    shards x 3 replicas on three NodeHosts sharing ONE
    ``ColocatedEngineGroup`` on ``dev`` (the colocated phase's geometry,
    the tan WAL, ``AuditKV``); a ``Random(seed)`` sample of 6 shards is
    churned by the nemesis (leader kills, a forced leadership transfer, a
    membership cycle, one ``Balancer`` move onto a fourth host racing
    them, and one window of nemesis-forced kernel escalations at p=0.08)
    while two ``AuditClient``s a sampled shard write and read through
    exactly-once sessions for ``workload_s``; every sampled shard's
    history must be linearizable and its sessions exactly-once.
    (b) Then a ``Gateway`` over the live hosts drives one sampled shard
    with a writer on ``gw.connect`` handles and lease reads recorded as
    stale ops, kills the shard leader's host mid-traffic, and requires
    no stale read, a re-elected leader and a write after the kill."""
    import random
    import shutil
    import threading

    from dragonboat_tpu_torch import (
        Balancer, Config, EngineConfig, ExpertConfig, Fault,
        FaultController, FaultPlan, Gateway, GatewayConfig, LatencyBudget,
        NodeHost, NodeHostConfig, RECOVERY_STATS,
    )
    from dragonboat_tpu_torch.audit import (
        AuditClient, AuditKV, HistoryRecorder, audit_set_cmd,
        check_stale_reads, run_audit, settle_journals,
    )
    from dragonboat_tpu_torch.audit.history import run_workload
    from dragonboat_tpu_torch.logger import get_logger
    from dragonboat_tpu_torch.ops import _native
    from dragonboat_tpu_torch.ops.colocated import ColocatedEngineGroup
    from dragonboat_tpu_torch.storage.tan import tan_logdb_factory
    from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

    tag = "aud"
    addr = {r: f"{tag}-{r}" for r in (1, 2, 3, 4)}
    addrs = {r: addr[r] for r in (1, 2, 3)}
    geom = dict(capacity=AUDIT_CAPACITY, P=3, W=16, M=8, E=4, O=32,
                budget=4)
    reset_inproc_network()
    shutil.rmtree(workdir, ignore_errors=True)
    group = ColocatedEngineGroup(**geom, device=dev,
                                 parity_every=COLO_PARITY_EVERY)

    def make_nh(rid):
        return NodeHost(NodeHostConfig(
            nodehost_dir=os.path.join(workdir, f"nh-{rid}"),
            rtt_millisecond=AUDIT_RTT_MS,
            raft_address=addr[rid],
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=2),
                step_engine_factory=group.factory,
                logdb_factory=tan_logdb_factory,
            ),
        ))

    def cfg(rid, shard):
        return Config(replica_id=rid, shard_id=shard, election_rtt=20,
                      heartbeat_rtt=2, pre_vote=True, check_quorum=True,
                      quiesce=True)

    def leader_of(hosts, shard, timeout):
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            for k, nh in list(hosts.items()):
                try:
                    if nh.is_leader_of(shard):
                        return k
                except Exception:  # noqa: BLE001 — a host closing
                    pass
            time.sleep(0.02)
        raise AssertionError(f"no leader for shard {shard} in {timeout} s")

    errors_logged = ErrorRecords()
    engine_log = get_logger("engine")
    engine_log.addHandler(errors_logged)
    res = dict(shards=shards, replicas=3, sample_size=AUDIT_SAMPLE,
               seed=seed, wal="tan", geometry=geom, rtt_ms=AUDIT_RTT_MS,
               election_rtt=20, heartbeat_rtt=2, workload_s=workload_s,
               parity_every=COLO_PARITY_EVERY,
               escalate=dict(p=AUDIT_ESCALATE_P, window_s=AUDIT_ESCALATE_S),
               reduced=[])
    nhs = {}
    nemesis = FaultController(seed=seed)
    balancer = gw = None
    stop = threading.Event()
    rec = HistoryRecorder()
    try:
        t0 = time.perf_counter()
        for rid in addrs:
            nhs[rid] = make_nh(rid)
        # the colocated path's kernel launches are counted from here on
        _native.reset_launch_counts()
        RECOVERY_STATS.reset()
        for nh in nhs.values():
            nh.pause_ticks()
        for shard in range(1, shards + 1):
            for rid in addrs:
                nhs[rid].start_replica(addrs, False, AuditKV, cfg(rid, shard))
        for nh in nhs.values():
            nh.resume_ticks()
        sample = sorted(random.Random(seed).sample(range(1, shards + 1),
                                                   AUDIT_SAMPLE))
        for s_ in sample:
            leader_of(nhs, s_, 240.0)
        res["sample"] = sample
        res["boot_s"] = time.perf_counter() - t0

        # (a) ---------------------------------------------------------
        # per-shard replica kill/restart, each restart with the victim's
        # real replica id and membership (test_audit.py:600-622)
        killed = {}

        def kill(host_key, shard_id):
            node = nhs[host_key]._nodes.get(shard_id)
            if node is not None:
                killed[(host_key, shard_id)] = (
                    node.replica_id, dict(node.get_membership().addresses))
            nhs[host_key].stop_shard(shard_id)

        def restart(host_key, shard_id):
            rid, members = killed.pop((host_key, shard_id),
                                      (host_key, dict(addrs)))
            nhs[host_key].start_replica(members, False, AuditKV,
                                        cfg(rid, shard_id))

        sla_seq = [0]

        def sla_cmd():
            sla_seq[0] += 1
            return audit_set_cmd("_sla", f"sla-{seed}-{sla_seq[0]}")

        balancer = Balancer(
            AuditKV, lambda shard_id, replica_id: cfg(replica_id, shard_id),
            hosts={addr[r]: nh for r, nh in nhs.items()},
            replication_factor=3, seed=seed)
        nemesis.install_churn(lambda: nhs, shards=sample, balancer=balancer,
                              kill_fn=kill, restart_fn=restart,
                              sla_ticks=8_000, sla_cmd=sla_cmd)
        nemesis.install_engine(group.core)
        rng = random.Random(seed ^ 0x5EED)
        nemesis.plan = FaultPlan([
            Fault("leader_kill", at=1.0, duration=1.5,
                  targets=(rng.choice(sample),)),
            Fault("escalate", at=2.0, duration=AUDIT_ESCALATE_S,
                  targets=tuple(sample), p=AUDIT_ESCALATE_P),
            Fault("leader_transfer", at=4.5, targets=(rng.choice(sample),)),
            Fault("member_cycle", at=6.0, duration=1.5,
                  targets=(rng.choice(sample),)),
            Fault("balance_move", at=8.0, duration=2.0),
            Fault("leader_kill", at=11.0, duration=1.5,
                  targets=(rng.choice(sample),)),
        ])
        res["plan"] = nemesis.plan.describe()
        budget = LatencyBudget(election_window=0.8, bootstrap=1.0,
                               floor=2.0, cap=60.0)
        clients = [AuditClient(lambda: nhs, s_, rec, seed=seed, budget=budget)
                   for s_ in sample for _ in range(2)]
        for c in clients:
            if not c.register():
                raise AssertionError("an audit client failed to register")
        # the fourth host joins before the clients' threads iterate the
        # hosts dict; the scheduled balance_move races a move onto it
        nhs[4] = make_nh(4)
        balancer.join(addr[4], nhs[4])
        threads = run_workload(clients, [f"k{i}" for i in range(4)], stop,
                               pace=0.01)
        t_churn = time.perf_counter()
        t_churn_m = time.monotonic()  # the recorder's clock
        with UtilizationSampler() as util:
            nemesis.start()
            if not nemesis.wait(timeout=300.0):
                raise AssertionError("the nemesis overran its plan")
            churn_s = time.perf_counter() - t_churn
            time.sleep(max(0.0, t_churn + workload_s - time.perf_counter()))
            stop.set()
            for t in threads:
                t.join(timeout=30.0)
        for c in clients:
            c.close()
        res["workload_s_run"] = time.perf_counter() - t_churn
        res["gpu_utilization"] = util.summary()
        ops = rec.ops()
        res["ops_by_status"] = rec.counts()
        acked_w = [o for o in ops if o.kind == "w" and o.status == "ok"
                   and t_churn_m <= o.ret <= t_churn_m + churn_s]
        res["churn_s"] = churn_s
        res["writes_acked_per_s_churn"] = len(acked_w) / churn_s
        res["churn_log"] = [list(e) for e in nemesis.churn_log]
        res["churn_violations"] = list(nemesis.churn_violations)
        res["recovery_sla"] = RECOVERY_STATS.snapshot()
        res["nemesis"] = dict(nemesis.stats)
        audits = {}
        for s_ in sample:
            shard_ops = [o for o in ops if any(
                c.shard_id == s_ and c.client == o.client for c in clients)]
            journals = settle_journals(nhs, s_, timeout=60.0)
            report = run_audit(shard_ops, journals)
            audits[s_] = dict(ok=report.ok, ops=len(shard_ops),
                              acked_sessions=report.sessions.acked,
                              describe=report.describe()[:400])
            leaks = {k: nh.pending_request_counts(s_)
                     for k, nh in nhs.items() if s_ in nh._nodes}
            audits[s_]["pending_requests"] = sum(
                sum(c.values()) for c in leaks.values())
        res["audit"] = audits

        # (b) ---------------------------------------------------------
        target = sample[0]
        live = {addr[k]: nh for k, nh in nhs.items()}
        gw = Gateway(live, GatewayConfig(default_timeout=8.0))
        grec = HistoryRecorder()
        wc, rc_ = grec.new_client(), grec.new_client()
        gstop = threading.Event()
        seq = [0]

        def writer():
            h = gw.connect(target, timeout=10.0)
            while not gstop.is_set():
                seq[0] += 1
                val = f"w-{seq[0]}"
                op = grec.invoke(wc, "w", "gk", val)
                try:
                    h.sync_propose(audit_set_cmd("gk", val))
                    grec.ok(op)
                except Exception:  # noqa: BLE001 — may have committed
                    grec.ambiguous(op)
                time.sleep(0.005)

        def reader():
            while not gstop.is_set():
                op = grec.invoke(rc_, "stale", "gk")
                try:
                    grec.ok(op, gw.read(target, "gk", timeout=5.0))
                except Exception:  # noqa: BLE001 — a failed read
                    grec.fail(op)
                time.sleep(0.003)

        leader = leader_of(live, target, 30.0)
        gthreads = [threading.Thread(target=writer, name="smoke-gw-writer",
                                     daemon=True),
                    threading.Thread(target=reader, name="smoke-gw-reader",
                                     daemon=True)]
        for t in gthreads:
            t.start()
        time.sleep(1.5)
        t_kill = time.monotonic()
        gw.remove_host(leader)
        killed_key = next(k for k in nhs if addr[k] == leader)
        nhs.pop(killed_key).close()
        survivors = {a: nh for a, nh in live.items() if a != leader}
        t1 = time.perf_counter()
        new_leader = leader_of(survivors, target, 30.0)
        res_b = dict(shard=target, killed_host=leader, new_leader=new_leader,
                     reelection_s=time.perf_counter() - t1)
        time.sleep(2.0)
        gstop.set()
        for t in gthreads:
            t.join(timeout=15.0)
        # a write through a fresh handle once the survivors lead
        after = grec.new_client()
        end = time.perf_counter() + 30.0
        while True:
            op = grec.invoke(after, "w", "gk", "after-kill")
            try:
                h = gw.connect(target, timeout=5.0)
                h.sync_propose(audit_set_cmd("gk", "after-kill"), timeout=5.0)
                grec.ok(op)
                break
            except Exception:  # noqa: BLE001 — may have committed; retry
                grec.ambiguous(op)
                if time.perf_counter() > end:
                    break
                time.sleep(0.2)
        res_b["write_after_kill_s"] = time.perf_counter() - t1
        gops = grec.ops()
        res_b["ops_by_status"] = grec.counts()
        res_b["reads_ok"] = sum(1 for o in gops if o.kind == "stale"
                                and o.status == "ok")
        res_b["writes_ok_after_kill"] = sum(
            1 for o in gops if o.kind == "w" and o.status == "ok"
            and o.invoke > t_kill)
        res_b["stale_violations"] = [v.describe()
                                     for v in check_stale_reads(gops)]
        res_b["gateway"] = {k: v for k, v in gw.stats().items()
                            if isinstance(v, (int, float))}
        res["gateway_leg"] = res_b
        launches = dict(_native.LAUNCHES)
        entry_launches = dict(_native.ENTRY_LAUNCHES)
        st = group.core.stats_snapshot()
        parity_failure = group.core.parity_failure
        engine_errors = list(errors_logged.lines)
    finally:
        stop.set()
        engine_log.removeHandler(errors_logged)
        nemesis.stop()
        if balancer is not None:
            balancer.stop()
        if gw is not None:
            gw.close()
        for nh in nhs.values():
            nh.pause_ticks()
        for nh in nhs.values():
            nh.close()
        shutil.rmtree(workdir, ignore_errors=True)
    keys = ("launches", "device_steps", "device_rows_stepped",
            "host_rows_stepped", "escalations", "divergence_halts",
            "routed_delivered", "routed_host_carried", "routed_dropped",
            "parity_failures")
    res["engine"] = {k: st.get(k, 0) for k in keys}
    res["rows_off_card"] = {k: st[k] for k in sorted(st)
                            if k.startswith("evict_")}
    res["parity"] = {
        k: [st[f"parity_attempts_{k}"], st[f"parity_checks_{k}"]]
        for k in COLO_PARITY_KERNELS
    }
    res["kernel_launches"] = launches
    res["entry_launches"] = entry_launches
    res["engine_errors"] = len(engine_errors)
    # the gates, every one fatal; the phase's numbers go to stderr first
    kinds = {e[1] for e in nemesis.churn_log}
    failed = [msg for bad, msg in (
        ([s_ for s_, a in audits.items() if not a["ok"]],
         "the audit failed on a sampled shard"),
        (not any(a["acked_sessions"] > 0 for a in audits.values()),
         "no session proposal was acknowledged"),
        (res["churn_violations"], "churn events missed their recovery SLA"),
        ({"leader_kill", "leader_transfer", "member_cycle",
          "balance_move"} - kinds, "a churn kind never ran"),
        (nemesis.stats.get("engine_escalations", 0) < 1,
         "no kernel escalation was forced"),
        (st["divergence_halts"], "divergence halts"),
        ([s_ for s_, a in audits.items() if a["pending_requests"]],
         "pending request futures leaked"),
        (res_b["stale_violations"], "the gateway served a stale read"),
        (res_b["reads_ok"] <= 20, "too few gateway reads succeeded"),
        (res_b["gateway"].get("lease_reads", 0) < 1,
         "no gateway read took the lease path"),
        (res_b["writes_ok_after_kill"] < 1,
         "no write committed after the leader's host was killed"),
        (parity_failure is not None or st["parity_failures"],
         f"parity failures; first: {parity_failure}"),
        (engine_errors, f"the engine's workers logged errors: "
                        f"{engine_errors[:1]}"),
        ([k for k, (begun, passed) in res["parity"].items()
          if passed < 1 or passed != begun], "a parity check did not pass"),
        ([k for k in colo_path_kernels() if launches.get(k, 0) < 1],
         "a kernel never launched on the audited path"),
    ) if bad]
    if failed:
        print(json.dumps(dict(phase="audit", failed=failed, **res),
                         default=str), file=sys.stderr, flush=True)
        raise AssertionError(f"audit phase: {failed}")
    return res


# ---------------------------------------------------------------------------
# phase 9: the engines' mesh modes
# ---------------------------------------------------------------------------
MESH_BLOCKS = 4
MESH_COLO_WINDOW_S = 10.0
MESH_LANE_SHARDS = 1365  # 4,095 rows: a block of 1,024 holds <= 341 shards
MESH_LANE_WINDOW_S = 5.0
MESH_NH_WINDOW_S = 10.0
MESH_NH_WRITES = 64  # a shard's writes the 10 s window can begin


def mesh_engines_phase(dev, workdir: str) -> dict:
    """Both engines in mesh mode on ``GroupsMesh([dev] * 4)``, each path's
    kernel launches counted from zero: (a) the colocated phase's drive
    (1,000 shards x 3, BASELINE config 2, tan WAL) for a 10 s window;
    (b) the same engine at 1,365 shards x 3 = 4,095 rows for 5 s, so
    that shards straddle the blocks and their traffic rides the lane;
    (c) the nodehost phase's layout (300 shards, capacity 512) on
    ``torch_step_engine_factory(mesh=...)``, the writes begun in a 10 s
    window; (d) the colocated pack
    bit-exact against its plain version at leg 2's geometry and timed
    beside the pack without the new operands.  Every path holds the
    parity self-check, every acknowledged write read back from all three
    replicas and no divergence halt; on four visible cards (a) runs again
    with one block a card.  On one card this measures the mechanism, not
    a multi-card rate."""
    import torch

    from dragonboat_tpu_torch.ops.placement import GroupsMesh

    mesh = GroupsMesh([dev] * MESH_BLOCKS)
    res = dict(blocks=MESH_BLOCKS, devices=[str(d) for d in mesh.devices])
    res["colocated"] = colocated_phase(
        dev, os.path.join(workdir, "a"), window_s=MESH_COLO_WINDOW_S,
        mesh=mesh)
    res["colocated_lane"] = colocated_phase(
        dev, os.path.join(workdir, "b"), shards=MESH_LANE_SHARDS,
        window_s=MESH_LANE_WINDOW_S, mesh=mesh, need_lane=True)
    res["nodehost"] = nodehost_phase(
        dev, os.path.join(workdir, "c"), mesh=mesh, window_s=MESH_NH_WINDOW_S,
        writes=MESH_NH_WRITES)
    res["pack"] = mesh_pack_case(dev)
    if torch.cuda.device_count() >= MESH_BLOCKS:
        res["colocated_cards"] = colocated_phase(
            dev, os.path.join(workdir, "a4"), window_s=MESH_COLO_WINDOW_S,
            mesh=GroupsMesh([torch.device("cuda", i)
                             for i in range(MESH_BLOCKS)]))
    return res


# ---------------------------------------------------------------------------
# phase 11: the program registry
# ---------------------------------------------------------------------------
REGISTRY_SEED = 7


def registry_phase(dev) -> dict:
    """Every entry of the port's program registry (``ops/registry.py``:
    the reference's 21 program names) on ``dev``, the two mesh entries on
    ``GroupsMesh([dev] * 4)``.  On the canonical inputs (fresh rows,
    empty inboxes: little arithmetic runs) each entry must launch every
    binding it names and no other, bit-exact with its plain version, and
    the source scan must find no binding or ``__global__`` that no entry
    reaches: reachability and the launch mapping.  On the seeded live
    inputs (``registry.live_world(REGISTRY_SEED)``: every group led,
    logs past the ring window, every hot message type, dead rows) each
    entry is held bit-exact against its plain version: parity."""
    import torch

    from dragonboat_tpu_torch.ops import _native, registry
    from dragonboat_tpu_torch.ops.placement import GroupsMesh

    mesh = GroupsMesh([dev] * MESH_BLOCKS)
    entries, failed = {}, []
    launches = {k: 0 for k in _native.KERNELS}
    for ep in registry.all_entry_points(mesh):
        _native.reset_launch_counts()
        got = registry.run(ep, dev)
        torch.cuda.synchronize()
        bound = dict(_native.ENTRY_LAUNCHES)
        for k, v in _native.LAUNCHES.items():
            launches[k] += v
        want = registry.run(ep, dev, plain=True)
        try:
            err = _max_err(got, want)
        except (AssertionError, ValueError) as exc:  # shape, dtype, count
            err = None
            failed.append(f"{ep.name}: {exc}")
        got = registry.run(ep, dev, seed=REGISTRY_SEED)
        torch.cuda.synchronize()
        want = registry.run(ep, dev, plain=True, seed=REGISTRY_SEED)
        try:
            err_live = _max_err(got, want)
        except (AssertionError, ValueError) as exc:
            err_live = None
            failed.append(f"{ep.name} live: {exc}")
        entries[ep.name] = dict(max_abs_err=err, live_max_abs_err=err_live,
                                outputs=len(got), bindings=bound)
        if err:
            failed.append(f"{ep.name}: max abs err {err}")
        if err_live:
            failed.append(f"{ep.name} live: max abs err {err_live}")
        if set(bound) != set(ep.bindings):
            failed.append(f"{ep.name}: launched {sorted(bound)}, registered "
                          f"{sorted(ep.bindings)}")
    failed += registry.unregistered_kernels()
    res = dict(entries=entries, n_entries=len(entries), launches=launches,
               kernels=list(registry.kernels()), canon=registry.CANON,
               mesh_blocks=MESH_BLOCKS, live_seed=REGISTRY_SEED)
    if len(entries) != 21:
        failed.append(f"{len(entries)} registry entries, not 21")
    if set(res["kernels"]) != set(_native.KERNELS):
        failed.append("the registry's kernels are not the build's")
    if failed:
        print(json.dumps(dict(phase="registry", failed=failed, **res),
                         default=str), file=sys.stderr, flush=True)
        raise AssertionError(f"registry phase: {failed}")
    return res


# ---------------------------------------------------------------------------
# phase 12: the production day
# ---------------------------------------------------------------------------
DAY_SEED = 11  # the reference's tier-1 mini day (tests/test_scenario.py:468)
DAY_COLO_SEED = 5  # TestColocatedFleetMember's fleet (:539)
DAY_RPC_BASE_PORT = 31350
# a failed day runs once more only when nothing of it points at the
# colocated member (day_colo_suspect)
DAY_TRIES = 2
# the colocated member's programs (registry names): its kernels are the
# ones the day must have launched
COLO_PATH_ENTRIES = ("colocated._assemble_and_step", "colocated._route_step",
                     "colocated._select_and_blob",
                     "colocated._host_inbox_from_ticks",
                     "colocated._scatter_inbox_rows")


# the base engine's programs (a step, the flag word, the readback, the
# row moves)
NODEHOST_PATH_ENTRIES = ("kernel.step", "engine._summarize_flags",
                         "engine._gather_detail_vals", "engine._scatter_rows")


def colo_path_kernels() -> tuple:
    """The colocated path's kernels, read from the program registry."""
    from dragonboat_tpu_torch.ops import registry

    return registry.kernels_of(COLO_PATH_ENTRIES)


def nodehost_path_kernels() -> tuple:
    """The base engine's kernels, read from the program registry."""
    from dragonboat_tpu_torch.ops import registry

    return registry.kernels_of(NODEHOST_PATH_ENTRIES)


def day_gates(r, classes) -> list:
    """The reference's mini-day gates (tests/test_scenario.py:468-517)
    and the runner's device checks, each a message where it fails."""
    names = [p["name"] for p in r.phases]
    ph = {p["name"]: p for p in r.phases}
    sc, rh = ph.get("stream_chaos", {}), ph.get("read_hot", {})
    wh, di, el = (ph.get("write_hot", {}), ph.get("diurnal", {}),
                  ph.get("elastic", {}))
    paths = rh.get("read_paths", {})
    try:
        rt = json.loads(r.to_json())["ok"] is True
    except Exception:  # noqa: BLE001 — a report that does not round-trip
        rt = False
    return [msg for bad, msg in (
        (not r.ok, f"the day failed: {r.aborted} {r.violations[:3]}"),
        (set(r.disturbances_fired) != set(classes)
         or not all(n >= 1 for n in r.disturbances_fired.values()),
         "a disturbance class never fired"),
        (not r.audit.get("ok") or r.audit.get("ops", {}).get("ok", 0) <= 200,
         "the audit is not green over > 200 ok ops"),
        (not r.recovery or any(c["violations"] for c in r.recovery.values()),
         "a recovery missed its SLA"),
        (not {"rolling_restart", "dr_cycle", "drain", "stream_chaos"}
         <= set(r.recovery), "a recovery class is missing"),
        (set(r.fault_dips) != set(classes)
         or not all(0 < d for d in r.fault_dips.values()),
         "a dip entry is missing"),
        (r.baseline_committed_per_s <= 10, "baseline under 10 committed/s"),
        (not names or names[0] != "warmup" or names[-1] != "cooldown",
         "the phases do not run warmup to cooldown"),
        (sc.get("stream_kills") and sc.get("stream_resumes", 0) < 1,
         "a killed stream never resumed"),
        (paths.get("follower", 0) < 1 or paths.get("bounded", 0) < 1
         or rh.get("reads", 0) < paths.get("follower", 0)
         or rh.get("hot_key_reads", 0) < 1, "the read-hot storm"),
        (wh.get("writes", 0) < 1 or wh.get("hot_key_writes", 0) < 1,
         "the write-hot storm"),
        (di.get("writes", 0) < 1 or di.get("peak_committed_per_s", 0)
         < di.get("trough_committed_per_s", 0), "the diurnal swing"),
        (el.get("events", 0) < 1 or not el.get("moves")
         or el.get("quiet_moves", 1) != 0
         or not el.get("p99_after_s", 1) < el.get("p99_storm_s", 0)
         or el.get("writes", 0) < 1, "the elastic loop's move"),
        (not rt or "comm/s" not in r.format_table(), "the report's emit"),
        (not r.colocated.get("device_rows_stepped", 0),
         "the colocated member never stepped on the device path"),
        (r.colocated.get("divergence_halts", 0), "divergence halts"),
    ) if bad]


def day_colo_state(runner) -> tuple:
    """(the day's colocated groups, the first parity failure, the first
    group's counters), read once the fleet has closed, under the core's
    lock (the report's copy is read mid-run, where a check can sit
    between its attempt and its pass)."""
    groups = [g for g in runner.fleet._colo_groups.values()
              if g.core is not None]
    failure = next((g.core.parity_failure for g in groups
                    if g.core.parity_failure), None)
    pst = groups[0].core.stats_snapshot() if groups else {}
    return groups, failure, pst


def day_colo_suspect(runner, r, warnings) -> list:
    """What in a failed day points at the colocated member: its host
    (address or NodeHost ID) in the abort, the violations, the elastic
    phase's record or the balancer's warnings (a move from or onto it
    that failed), a parity failure, or a divergence halt.  Such a day is
    not run again."""
    from dragonboat_tpu_torch.scenario import fleet as F

    addr = runner.fleet.addrs[F.COLO_SLOT]
    nh = runner.fleet.hosts.get(addr)
    keys = {addr} | ({nh.nodehost_id} if getattr(nh, "nodehost_id", None)
                     else set())
    elastic = next((p for p in r.phases if p.get("name") == "elastic"), {})
    found = []
    for what, text in (("aborted", r.aborted), ("violations", r.violations),
                       ("elastic", elastic), ("balancer", warnings)):
        blob = json.dumps(text, default=str)
        found += [f"{k} in the {what}" for k in sorted(keys) if k in blob]
    _groups, failure, pst = day_colo_state(runner)
    if failure is not None or pst.get("parity_failures", 0):
        found.append(f"a parity failure: {failure}")
    if r.colocated.get("divergence_halts", 0):
        found.append("a divergence halt")
    return found


def day_phase(dev, workdir: str) -> dict:
    """(a) The reference's tier-1 production day on the port:
    ``ScenarioRunner(DayPlan.mini(11), colocated=True)`` — six hosts, an
    on-disk and an in-memory shard, a witness, a non-voting laggard, the
    gateway's live traffic, every disturbance class, the DR boundary and
    the elastic loop — with the colocated member (host h2, both shards)
    stepping on ONE ``ColocatedEngineGroup(**COLO_GEOM)`` on the card
    (the fleet's geometry, the parity self-check armed every 20th
    launch); the reference's gates (tests/test_scenario.py:468-517), the
    runner's device checks, every kernel of the colocated path launched
    and every parity check begun passed.  (b) The colocated member's
    whole-host kill and restart (``TestColocatedFleetMember``, seed 5):
    the restarted host re-attaches to the live group, the SLA holds,
    writes after the restart are read back through the gateway.  (c)
    ``run_rpc_smoke(n=2)`` through the port's worker processes."""
    import gc
    import shutil

    from dragonboat_tpu_torch import RECOVERY_STATS, assert_recovery_sla
    from dragonboat_tpu_torch.audit import audit_set_cmd
    from dragonboat_tpu_torch.logger import get_logger
    from dragonboat_tpu_torch.ops import _native
    from dragonboat_tpu_torch.scenario import (
        DISTURBANCE_CLASSES, DayPlan, ScenarioRunner,
    )
    from dragonboat_tpu_torch.scenario import fleet as F
    from dragonboat_tpu_torch.scenario.multiproc import run_rpc_smoke
    from dragonboat_tpu_torch.scenario.plan import SH_MEM

    kernels = colo_path_kernels()
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    errors_logged = ErrorRecords()
    engine_log = get_logger("engine")
    engine_log.addHandler(errors_logged)
    balance_warned = ErrorRecords(logging.WARNING)
    balance_log = get_logger("balance")
    balance_log.addHandler(balance_warned)
    saved_geom = dict(F.COLO_GEOM)
    F.COLO_GEOM["parity_every"] = COLO_PARITY_EVERY
    res = dict(seed=DAY_SEED, geometry=saved_geom,
               parity_every=COLO_PARITY_EVERY, colo_slot=F.COLO_SLOT,
               path_kernels=list(kernels), reduced=[])
    failed = []
    try:
        # (a) ---------------------------------------------------------
        # a failed day runs once more after the process settles, as the
        # reference's tier-1 gate does (tests/conftest.py,
        # flaky_isolated), unless something of it points at the
        # colocated member; the gates hold the last day, every day is
        # reported (on the day_report line too)
        res["attempts"] = []
        for attempt in range(DAY_TRIES):
            RECOVERY_STATS.reset()
            del balance_warned.lines[:]
            runner = ScenarioRunner(DayPlan.mini(DAY_SEED),
                                    tag=f"chipday{attempt}",
                                    workdir=workdir, colocated=True)
            _native.reset_launch_counts()
            t0 = time.perf_counter()
            with UtilizationSampler() as util:
                r = runner.run()
            gates = day_gates(r, DISTURBANCE_CLASSES)
            suspect = (day_colo_suspect(runner, r, balance_warned.lines)
                       if gates else [])
            res["attempts"].append(dict(
                gates_failed=gates, colo_suspect=suspect, aborted=r.aborted,
                violations=r.violations[:3],
                balancer_warnings=balance_warned.lines[:5],
                day_s=time.perf_counter() - t0))
            if not gates or suspect:
                break
            gc.collect()
            time.sleep(1.5)
        res["day_s"] = res["attempts"][-1]["day_s"]
        launches = dict(_native.LAUNCHES)
        res["kernel_launches"] = launches
        res["entry_launches"] = dict(_native.ENTRY_LAUNCHES)
        groups, parity_failure, pst = day_colo_state(runner)
        st = r.colocated
        res["parity"] = {
            k: [pst.get(f"parity_attempts_{k}", 0),
                pst.get(f"parity_checks_{k}", 0)]
            for k in COLO_PARITY_KERNELS}
        res["utilization"] = util.summary()
        res["report"] = json.loads(r.to_json())
        res["report"].pop("timeline", None)
        failed += gates
        failed += [f"the colocated member is suspect: {a['colo_suspect']}"
                   for a in res["attempts"] if a["colo_suspect"]]
        failed += [msg for bad, msg in (
            (len(groups) != 1, f"{len(groups)} colocated groups, not 1"),
            ([k for k in kernels if launches.get(k, 0) < 1],
             "a kernel of the colocated path never launched"),
            ([k for k, (begun, passed) in res["parity"].items()
              if passed != begun], "a parity check did not pass"),
            (sum(b for b, _ in res["parity"].values()) < 1,
             "no parity check was begun"),
            (parity_failure is not None or pst.get("parity_failures", 0),
             f"parity failures; first: {parity_failure}"),
        ) if bad]
        res["ledger"] = dict(
            baseline_committed_per_s=r.baseline_committed_per_s,
            fault_dips=r.fault_dips,
            worst_recovery_s={c: v["worst_s"]
                              for c, v in sorted(r.recovery.items())},
            audit=dict(ok=r.audit.get("ok"), ops=r.audit.get("ops")),
            device_rows_stepped=st.get("device_rows_stepped", 0),
            host_rows_stepped=st.get("host_rows_stepped", 0),
            utilization_gpu_mean_pct=res["utilization"]["mean_pct"],
            day_s=res["day_s"],
            attempts=[dict(gates_failed=a["gates_failed"],
                           colo_suspect=a["colo_suspect"])
                      for a in res["attempts"]])

        # (b) ---------------------------------------------------------
        RECOVERY_STATS.reset()
        _native.reset_launch_counts()
        fleet = F.DayFleet(seed=DAY_COLO_SEED, tag="chipcolo",
                           colocated=True, workdir=workdir)
        kill = {}
        try:
            t0 = time.perf_counter()
            fleet.build()
            gw = fleet.gateway
            h = gw.connect(SH_MEM, timeout=20.0)
            for i in range(10):
                h.sync_propose(audit_set_cmd(f"c{i}", str(i)), timeout=5.0)
            addr = fleet.addrs[F.COLO_SLOT]
            group = fleet._colo_group(F.COLO_SLOT)
            fleet.kill(addr)
            assert_recovery_sla(
                fleet.hosts_holding(SH_MEM), SH_MEM, sla_ticks=15_000,
                cmd=fleet.sla_cmd(), fault_class="colo_kill")
            fleet.restart(addr)
            deadline = time.time() + 30.0
            while time.time() < deadline:
                if fleet.hosts[addr]._nodes.get(SH_MEM) is not None:
                    break
                time.sleep(0.2)
            kill["rejoined"] = fleet.hosts[addr]._nodes.get(SH_MEM) is not None
            kill["same_group"] = fleet._colo_group(F.COLO_SLOT) is group
            core = group.core
            with core._lock:
                kill["restarted_rows_on_group"] = sorted(
                    k for k, g in core._row_of.items()
                    if k[0] == SH_MEM and core._meta.get(g) is not None)
                rows_at_restart = core.stats["device_rows_stepped"]
            for i in range(10, 20):
                h.sync_propose(audit_set_cmd(f"c{i}", str(i)), timeout=5.0)
            kill["read_back"] = gw.read(SH_MEM, "c19", timeout=5.0)
            st_b = fleet.colo_stats()
            kill["rows_after_restart"] = (core.stats[
                "device_rows_stepped"] - rows_at_restart)
            kill["device_rows_stepped"] = st_b.get("device_rows_stepped", 0)
            kill["divergence_halts"] = st_b.get("divergence_halts", 0)
            kill["recovery"] = RECOVERY_STATS.snapshot()
            kill["kernel_launches"] = dict(_native.LAUNCHES)
            kill["s"] = time.perf_counter() - t0
        finally:
            fleet.close()
        res["colo_kill"] = kill
        failed += [msg for bad, msg in (
            (not kill["rejoined"], "the restarted host never rejoined"),
            (not kill["same_group"], "the restarted host left the group"),
            (not kill["restarted_rows_on_group"],
             "no replica of the restarted host is attached to the group"),
            (kill["read_back"] != "19", "a write after the restart was lost"),
            (kill["rows_after_restart"] < 1,
             "the group stepped no row after the restart"),
            (kill["divergence_halts"], "divergence halts after the restart"),
        ) if bad]

        # (c) ---------------------------------------------------------
        t0 = time.perf_counter()
        out = run_rpc_smoke(n=2, workdir=os.path.join(workdir, "rpc"),
                            base_port=DAY_RPC_BASE_PORT)
        res["rpc_smoke"] = dict(out, s=time.perf_counter() - t0)
        if out["committed"] != 8 or not out["rerouted"]:
            failed.append(f"the rpc smoke: {out}")
        res["engine_errors"] = list(errors_logged.lines)[:5]
        if errors_logged.lines:
            failed.append(f"the engine's workers logged errors: "
                          f"{errors_logged.lines[:1]}")
    finally:
        engine_log.removeHandler(errors_logged)
        balance_log.removeHandler(balance_warned)
        F.COLO_GEOM.clear()
        F.COLO_GEOM.update(saved_geom)
        RECOVERY_STATS.reset()
        shutil.rmtree(workdir, ignore_errors=True)
    if failed:
        print(json.dumps(dict(phase="day", failed=failed, **res),
                         default=str), file=sys.stderr, flush=True)
        raise AssertionError(f"day phase: {failed}")
    return res


# ---------------------------------------------------------------------------
# phase 13: the graft entry (dragonboat_tpu_torch/graft_entry.py)
# ---------------------------------------------------------------------------
GRAFT_DEVICES = 4
# the programs the dry run reaches: the sharded round (parts 1-2) and
# the colocated path on the mesh (part 3); its kernels must all launch
GRAFT_PATH_ENTRIES = ("kernel.step_sharded", "route.sharded_round",
                      *COLO_PATH_ENTRIES)


def graft_phase(dev, workdir: str) -> dict:
    """The port's graft entry on the card.  ``entry()``'s forward on
    ``cuda`` bit-exact against the same example rows through the plain
    path on the CPU; then ``dryrun_multichip(4)`` on
    ``GroupsMesh([cuda:0] * 4)``: the sharded step, 64 routed rounds and
    three NodeHosts on one mesh ``ColocatedEngineGroup``, every
    postcondition of the reference's (a failed one raises).  Launch
    counts are reset just before the dry run and read just after; every
    kernel of its path must have run, and the engine's workers must have
    logged no error."""
    import shutil

    import torch

    from dragonboat_tpu_torch import graft_entry as GE
    from dragonboat_tpu_torch.logger import get_logger
    from dragonboat_tpu_torch.ops import _native, registry

    failed = []
    fn, (st, ib) = GE.entry()
    _native.reset_launch_counts()
    got = fn(st, ib)
    torch.cuda.synchronize()
    entry_launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    want = fn(*GE.example_batch(64, device="cpu"))
    err = _max_err([t.cpu() for t in registry.leaves(got)],
                   registry.leaves(want))
    if err:
        failed.append(f"entry(): max abs err {err} against the plain path")
    if entry_launches != {"raft_step": 1}:
        failed.append(f"entry() launched {entry_launches}")

    errors_logged = ErrorRecords()
    engine_log = get_logger("engine")
    engine_log.addHandler(errors_logged)
    try:
        _native.reset_launch_counts()
        t0 = time.perf_counter()
        res = GE.dryrun_multichip(GRAFT_DEVICES, devices=[dev] * GRAFT_DEVICES,
                                  workdir=workdir)
        torch.cuda.synchronize()
        dry_s = time.perf_counter() - t0
        launches = dict(_native.LAUNCHES)
    finally:
        engine_log.removeHandler(errors_logged)
        shutil.rmtree(workdir, ignore_errors=True)
    path = registry.kernels_of(GRAFT_PATH_ENTRIES)
    missing = [k for k in path if not launches.get(k)]
    if missing:
        failed.append(f"the dry run launched no {missing}")
    if errors_logged.lines:
        failed.append(f"the engine's workers logged errors: "
                      f"{errors_logged.lines[:1]}")
    rst, _rib = res["routed"]
    groups = GE.GROUPS_PER_DEV * GRAFT_DEVICES
    stats = res["engine"]
    out = dict(
        devices=GRAFT_DEVICES, entry_max_abs_err=err,
        entry_launches=entry_launches, dryrun_s=dry_s,
        kernel_launches=launches, path_kernels=list(path),
        routed=dict(groups=groups, rounds=GE.ROUNDS,
                    committed_min=int(rst.committed.min()),
                    leaders=int((rst.role == GE.ROLE_LEADER).sum())),
        engine={k: stats[k] for k in ("launches", "routed_delivered",
                                      "divergence_halts") if k in stats})
    if failed:
        print(json.dumps(dict(phase="graft", failed=failed, **out),
                         default=str), file=sys.stderr, flush=True)
        raise AssertionError(f"graft phase: {failed}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the device-plane audit (analysis/devicecheck.py) on the card
# ---------------------------------------------------------------------------
def analysis_phase(dev) -> dict:
    """``devicecheck`` on the card over every registry entry (dtype,
    donation and G-last on CUDA tensors, each all-device entry once under
    ``torch.cuda.set_sync_debug_mode("error")``, restored afterwards),
    the static transfer lint, the source scan, and the spill rule over
    this build's ptxas report, whose per-``__global__`` registers, stack,
    spills and static shared memory go on a line of their own first.
    Any finding beyond ``analysis/device_baseline.txt`` fails the run."""
    import torch

    from dragonboat_tpu_torch.analysis import devicecheck, raftlint
    from dragonboat_tpu_torch.ops import _native, registry

    log = _native.build_log()
    table = devicecheck.ptxas_table(log)
    emit(dict(phase="ptxas", card=nvidia_smi_line(), kernels=table))
    mode = torch.cuda.get_sync_debug_mode()
    findings = devicecheck.audit(cuda=True, build_log=log)
    if torch.cuda.get_sync_debug_mode() != mode:
        raise AssertionError("analysis phase: sync debug mode not restored")
    baseline = raftlint.load_baseline(str(devicecheck.BASELINE))
    new, stale = raftlint.gate(findings, baseline)
    out = dict(findings=[f.render() for f in findings],
               unbaselined=[f.render() for f in new],
               stale=[list(s) for s in stale],
               entries=len(registry.ENTRY_POINTS) + 2,
               globals=len(table),
               spill_free=sum(1 for r in table if not (
                   r["stack"] or r["spill_stores"] or r["spill_loads"])))
    if new:
        print(json.dumps(dict(phase="analysis", **out)), file=sys.stderr,
              flush=True)
        raise AssertionError(f"analysis phase: {len(new)} finding(s) "
                             f"beyond the baseline: {out['unbaselined']}")
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--profile-colocated", type=float, default=0.0, metavar="S",
        help="record the device's activity with torch.profiler for S "
             "seconds of the colocated window (slows the host)",
    )
    ap.add_argument(
        "--scale-shards", type=int, default=SCALE_SHARDS_A, metavar="N",
        help="shards of the scale phase's leg (a), BASELINE config 3 "
             f"(default {SCALE_SHARDS_A}; its full size is 10000)",
    )
    ap.add_argument(
        "--only", default="",
        help="comma-separated phases to run (kernels, colo_kernels, "
             "mesh_kernels, mesh_pack, phase_a, multichip, nodehost, "
             "colocated, pipeline, scale, mesh_engines, audit, registry, "
             "day, graft, analysis) without the "
             "result lines; "
             "default: "
             "all",
    )
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from dragonboat_tpu_torch.ops import _native
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(here, "dragonboat_tpu_torch", "_build")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    def want(phase):
        return not only or phase in only

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    _native.module()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_by_kernel(_native.build_log())
    emit(dict(phase="device", name=name, nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              build_s=build_s, ptxas=ptxas))

    phase_s = {}

    def run(name, fn, *a, **kw):
        t = time.perf_counter()
        res = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t
        emit(dict(phase=name, card=smi, phase_s=phase_s[name], **res))
        return res

    if want("kernels"):
        kern = run("kernels", kernels_phase, dev)
    if want("colo_kernels"):
        ckern = run("colocated_kernels", colocated_kernels_phase, dev)
    if want("mesh_kernels"):
        mkern = run("mesh_kernels", mesh_kernels_phase, dev)
    if want("mesh_pack") and only:
        run("mesh_pack", mesh_pack_case, dev)
    if want("phase_a"):
        pa = run("phase_a", phase_a_phase, dev)
    if want("multichip"):
        mc = run("multichip", multichip_phase, dev, [dev] * X_DEVICES)
        if torch.cuda.device_count() >= X_DEVICES:
            run("multichip_cards", multichip_phase, dev,
                [torch.device("cuda", i) for i in range(X_DEVICES)])
    if want("nodehost"):
        nh = run("nodehost", nodehost_phase, dev,
                 os.path.join(scratch, f"smoke-{os.getpid()}"))
    if want("colocated"):
        colo = run("colocated", colocated_phase, dev,
                   os.path.join(scratch, f"colo-{os.getpid()}"),
                   profile_s=args.profile_colocated, sentry=True)
    if want("pipeline"):
        pipe = run("pipeline", pipeline_phase, dev,
                   os.path.join(scratch, f"pipe-{os.getpid()}"))
    if want("scale"):
        scale = run("scale", scale_phase, dev,
                    os.path.join(scratch, f"scale-{os.getpid()}"),
                    shards_a=args.scale_shards)
    if want("mesh_engines"):
        mesh = run("mesh_engines", mesh_engines_phase, dev,
                   os.path.join(scratch, f"mesh-{os.getpid()}"))
    if want("audit"):
        aud = run("audit", audit_phase, dev,
                  os.path.join(scratch, f"audit-{os.getpid()}"))
    if want("registry"):
        reg = run("registry", registry_phase, dev)
    if want("day"):
        day = run("day", day_phase, dev,
                  os.path.join(scratch, f"day-{os.getpid()}"))
        emit(dict(day_report=day["ledger"], card=smi))
    if want("graft"):
        graft = run("graft", graft_phase, dev,
                    os.path.join(scratch, f"graft-{os.getpid()}"))
    if want("analysis"):
        run("analysis", analysis_phase, dev)
    if only:
        print(f"chip_smoke: ran {sorted(only)} in "
              f"{time.perf_counter() - t_all:.1f} s {phase_s}",
              file=sys.stderr)
        return 0

    from dragonboat_tpu_torch.ops import kernel as K

    def block(kernel, R, geom, internal):
        """a raft-step kernel's block: rows, staged outbox messages a row,
        shared memory, ptxas"""
        return dict(rows_per_block=R, staged_messages=K.staged_messages(
                        geom[-1]),
                    dynamic_smem=K.smem_bytes(R, *geom, internal=internal),
                    **ptxas[kernel])

    rows = []
    for k, info in KERNEL_INFO.items():
        rows.append(dict(
            name=k, route="cuda", source=info["source"],
            replaces=info["replaces"], also_replaces=info["also_replaces"],
            launches=nh["launches"][k],
            launches_colocated=colo["kernel_launches"][k],
            max_abs_err=kern["max_abs_err"][k],
            ms=kern["ms"][k], device_ms=kern["device_ms"][k],
            plain_ms=kern["plain_ms"][k],
            bound_ms=kern["bound_ms"][k], bound_by="bytes",
            library_ms=kern["library_ms"][k],
        ))
        if k == "place_rows":
            rows[-1].update(
                launches_multichip=mc["leg2"]["kernel_launches"][k],
                split=kern["place_rows_split"], modes=kern["place_modes"],
                ptxas={n: v for n, v in ptxas.items()
                       if n in ("place_rows_kernel",
                                "place_snapshot_kernel")})
        if k == "raft_step":
            rows[-1]["block"] = block("raft_step_kernel",
                                      kern["rows_per_block"],
                                      (P, W, M, E, O), False)
            rows[-1]["small_grids"] = {
                g: dict(v["routed"], rows_per_block=v["rows_per_block"],
                        fuzz_device_ms=v["fuzz"]["device_ms"])
                for g, v in kern["small_grids"].items()}
    # the in-place escalation merge of the routed rounds: its numbers at
    # 30,000 rows with no escalated row (the main paths' usual round)
    m0 = kern["place_modes"]["C30000"]["modes"]["merge_0"]
    rows.append(dict(
        name="merge_escalated", route="cuda", source=MERGE_INFO["source"],
        replaces=MERGE_INFO["replaces"],
        also_replaces=MERGE_INFO["also_replaces"],
        launches=colo["kernel_launches"]["merge_escalated"],
        launches_multichip=mc["leg2"]["kernel_launches"]["merge_escalated"],
        max_abs_err=kern["max_abs_err"]["merge_escalated"],
        ms=m0["ms"], device_ms=m0["device_ms"], plain_ms=m0["plain_ms"],
        bound_ms=m0["bound_ms"], bound_by="bytes", library_ms=None,
        geometries={g: {m: v["modes"][m] for m in v["modes"]
                        if m.startswith("merge_")}
                    for g, v in kern["place_modes"].items()},
        ptxas=ptxas["merge_escalated_kernel"],
    ))
    for k, info in COLO_KERNEL_INFO.items():
        ents = info["entries"]

        def total(key, ents=ents):
            vals = [ckern[key][e] for e in ents]
            return None if any(v is None for v in vals) else sum(vals)

        row = dict(
            name=k, route="cuda", source=info["source"],
            replaces=info["replaces"], also_replaces=info["also_replaces"],
            launches=colo["kernel_launches"][k],
            max_abs_err=max(ckern["max_abs_err"][e] for e in ents),
            ms=total("ms"), device_ms=total("device_ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes", library_ms=total("library_ms"),
        )
        if k == "route":
            row["max_abs_err"] = max(row["max_abs_err"],
                                     mkern["max_abs_err"]["route"])
            row["geometries"] = dict(ckern["route_geometries"],
                                     X37500=mkern["route_X37500"])
            row["ptxas"] = {n: v for n, v in ptxas.items()
                            if n.startswith("route_")}
        if k == "select_and_blob":
            row["geometries"] = ckern["select_geometries"]
            row["ptxas"] = {n: v for n, v in ptxas.items()
                            if n.startswith("select_")}
        if k == "inbox":
            row["entries"] = {
                e: dict(launches=colo["entry_launches"].get(e, 0),
                        max_abs_err=ckern["max_abs_err"][e],
                        ms=ckern["ms"][e], device_ms=ckern["device_ms"][e],
                        plain_ms=ckern["plain_ms"][e],
                        bound_ms=ckern["bound_ms"][e],
                        library_ms=ckern["library_ms"][e])
                for e in ("host_inbox_from_ticks", "assemble_inbox",
                          "zero_inbox_rows")
            }
            row["max_abs_err"] = max(ckern["max_abs_err"][e]
                                     for e in row["entries"])
            row["cases"] = ckern["inbox_cases"]
            row["ptxas"] = {n: v for n, v in ptxas.items()
                            if n.startswith("inbox_")}
        rows.append(row)
    for k, info in MESH_KERNEL_INFO.items():
        step = k == "raft_step_internal"
        rows.append(dict(
            name=k, route="cuda", source=info["source"],
            replaces=info["replaces"], also_replaces=info["also_replaces"],
            launches=(pa if step else mc["leg2"])["kernel_launches"][k],
            launches_multichip=(mc["leg1"] if step else mc["leg2"])[
                "kernel_launches"][k],
            max_abs_err=mkern["max_abs_err"][k],
            ms=mkern["ms"][k], device_ms=mkern["device_ms"][k],
            plain_ms=mkern["plain_ms"][k], bound_ms=mkern["bound_ms"][k],
            bound_by="bytes", library_ms=mkern["library_ms"][k],
        ))
        if step:
            rows[-1]["block"] = block("raft_step_internal_kernel",
                                      mkern["rows_per_block"],
                                      (A_P, A_W, A_M, A_E, A_O), True)
        if k == "xlane_pack":
            rows[-1].update(
                split=mkern["xlane_pack_split"],
                undersized=mkern["xlane_pack_undersized"],
                ptxas={n: v for n, v in ptxas.items()
                       if n.startswith("xlane_") and "scatter" not in n})
    # the mesh modes' paths: every kernel's launches there, and the
    # colocated pack (the lane pack with its new operands) as a case of
    # its row
    m_colo = mesh["colocated"]["kernel_launches"]
    m_nh = mesh["nodehost"]["launches"]
    for row in rows:
        row["launches_mesh_colocated"] = m_colo.get(row["name"], 0)
        row["launches_mesh_nodehost"] = m_nh.get(row["name"], 0)
        row["launches_audit"] = aud["kernel_launches"].get(row["name"], 0)
        row["launches_day"] = day["kernel_launches"].get(row["name"], 0)
        row["launches_pipeline"] = pipe["kernel_launches"].get(
            row["name"], 0)
        row["launches_scale"] = scale["kernel_launches"].get(row["name"], 0)
        row["launches_registry"] = reg["launches"].get(row["name"], 0)
        row["launches_graft"] = graft["kernel_launches"].get(row["name"], 0)
        if row["name"] == "xlane_pack":
            pk = mesh["pack"]
            row["colocated_operands"] = dict(
                launches=m_colo["xlane_pack"],
                launches_lane_path=mesh["colocated_lane"][
                    "kernel_launches"]["xlane_pack"],
                max_abs_err=pk["max_abs_err"], ms=pk["ms"],
                device_ms=pk["device_ms"], plain_ms=pk["plain_ms"],
                bound_ms=pk["bound_ms"], bound_by="bytes",
                library_ms=pk["library_ms"], split=pk["split"],
                without_operands=pk["without_operands"])
            row["max_abs_err"] = max(row["max_abs_err"], pk["max_abs_err"])
    # the line lists the registry's kernels, each once
    if sorted(r_["name"] for r_ in rows) != sorted(reg["kernels"]):
        print("chip_smoke: the kernels line is not the registry's: "
              f"{[r_['name'] for r_ in rows]} {reg['kernels']}",
              file=sys.stderr)
        return 1
    emit({"kernels": rows, "phase_s": phase_s})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
