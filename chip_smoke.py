"""Chip smoke for the PyTorch/CUDA port (dragonboat_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero without

Phases, each printing one JSON line:

1. device   — the card's name and power limit (nvidia-smi), and the time
              to build every CUDA kernel from the sources in this checkout.
2. kernels  — each kernel held bit-exact against its plain PyTorch
              version on the card at G = 30,000 rows (10k groups x 3
              replicas; P=5, W=32, M=8, E=4, O=32), on states advanced
              through a seeded routed sequence of steps plus seeded fuzz
              inboxes over every hot message type; then each kernel's
              median time per launch at that size.
3. nodehost — the main path: three NodeHosts in one process on the
              in-proc transport, each stepping its shards through
              ``torch_step_engine_factory(device="cuda")``; 1,000 shards x
              3 replicas elect leaders, take >= 4 writes each through
              ``sync_propose``, and every acknowledged write is read back
              linearizably through its shard's leader and from each of
              the three replicas' state machines.  Kernel launch counts
              are reset just before and read just after; every kernel
              must have run.  The engines re-run every 50th launch and
              every row move through the plain versions: every such
              check begun must have passed, and the engines' workers
              must have logged no error.

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


# ---------------------------------------------------------------------------
# kernel-phase inputs: a seeded 3-replica cluster per group of rows
# ---------------------------------------------------------------------------
def cluster_state_np(G: int, P_: int, W_: int, seed: int) -> dict:
    """Rows 3s, 3s+1, 3s+2 are replicas 1, 2, 3 of shard s+1; a third of
    the shards run pre-vote, a third check-quorum."""
    from dragonboat_tpu_torch.ops import types as T

    if G % 3:
        raise ValueError("G must be a multiple of 3")
    shard = np.arange(G) // 3 + 1
    rid = np.arange(G) % 3 + 1
    peers = np.zeros((G, P_), np.int32)
    peers[:, :3] = [1, 2, 3]
    cols = T.make_state_np(
        G, P_, W_, shard_ids=shard, replica_ids=rid, peer_ids=peers,
        election_timeout=10, heartbeat_timeout=2,
    )
    rng = np.random.default_rng(seed)
    cols["pre_vote"] = (shard % 3 == 1).astype(np.int32)
    cols["check_quorum"] = (shard % 3 == 2).astype(np.int32)
    # spread the first elections out
    cols["election_tick"] = rng.integers(0, 10, G).astype(np.int32)
    return cols


def route_np(st: dict, out: dict, rng, M_: int, E_: int, *,
             tick_p: float = 0.6, prop_p: float = 0.1) -> dict:
    """Turn one step's outboxes into the next step's inboxes: every
    message goes to its destination replica's row in the same group, in
    source order, after an optional tick in slot 0; the last slot may
    carry a fresh proposal.  REPLICATE entries carry the sender's ring
    terms."""
    from dragonboat_tpu_torch.ops import types as T

    buf, count = out["buf"], out["count"]
    G, O_, _ = buf.shape
    W_ = st["ring_term"].shape[1]
    rid = np.arange(G) % 3 + 1
    to = buf[..., T.F_TO]
    mt = buf[..., T.F_MTYPE]
    live = np.arange(O_)[None, :] < count[:, None]
    self_resp = (mt == T.MT_READ_INDEX_RESP) & (to == rid[:, None])
    ok = live & ~self_resp & (to >= 1) & (to <= 3)
    sg, sk = np.nonzero(ok)
    dest = 3 * (sg // 3) + to[sg, sk] - 1
    order = np.argsort(dest, kind="stable")
    sg, sk, dest = sg[order], sk[order], dest[order]
    ib = {f: np.zeros((G, M_), np.int32) for f in (
        "mtype", "from_id", "term", "log_term", "log_index", "commit",
        "reject", "hint", "hint_high", "n_entries")}
    ib["ent_term"] = np.zeros((G, M_, E_), np.int32)
    ib["ent_cc"] = np.zeros((G, M_, E_), np.int32)
    tick = rng.random(G) < tick_p
    ib["mtype"][tick, 0] = T.MT_TICK
    ib["log_index"][tick, 0] = 1
    first = tick.astype(np.int64)
    start = np.searchsorted(dest, dest, side="left")
    slot = first[dest] + (np.arange(dest.size) - start)
    keep = slot < M_ - 1
    sg, sk, dest, slot = sg[keep], sk[keep], dest[keep], slot[keep]
    rec = buf[sg, sk]
    for f, col in (("mtype", T.F_MTYPE), ("term", T.F_TERM),
                   ("log_term", T.F_LOG_TERM), ("log_index", T.F_LOG_INDEX),
                   ("commit", T.F_COMMIT), ("reject", T.F_REJECT),
                   ("hint", T.F_HINT), ("hint_high", T.F_HINT_HIGH),
                   ("n_entries", T.F_N_ENTRIES)):
        ib[f][dest, slot] = rec[:, col]
    ib["from_id"][dest, slot] = rid[sg]
    rep = rec[:, T.F_MTYPE] == T.MT_REPLICATE
    for j in range(E_):
        has = rep & (rec[:, T.F_N_ENTRIES] > j)
        pos = (rec[:, T.F_LOG_INDEX] + 1 + j) & (W_ - 1)
        ib["ent_term"][dest[has], slot[has], j] = st["ring_term"][sg[has], pos[has]]
        ib["ent_cc"][dest[has], slot[has], j] = st["ring_cc"][sg[has], pos[has]]
    prop = rng.random(G) < prop_p
    ib["mtype"][prop, M_ - 1] = T.MT_PROPOSE
    ib["n_entries"][prop, M_ - 1] = rng.integers(1, E_ + 1, int(prop.sum()))
    ib["ent_cc"][prop, M_ - 1] = (rng.random((int(prop.sum()), E_)) < 0.05)
    return ib


def fuzz_inbox_np(st: dict, rng, M_: int, E_: int) -> dict:
    """Seeded inboxes over every hot message type, with fields near each
    row's own state (terms, indexes) so every handler branch is reached."""
    from dragonboat_tpu_torch.ops import types as T

    G = st["term"].shape[0]
    hot = np.asarray(T.HOT_TYPES, np.int32)
    occ = rng.random((G, M_)) < 0.6
    ib = {}
    ib["mtype"] = np.where(occ, hot[rng.integers(0, hot.size, (G, M_))], 0)
    # a few cold types: the row must escalate
    cold = occ & (rng.random((G, M_)) < 0.02)
    ib["mtype"][cold] = T.MT_INSTALL_SNAPSHOT
    ib["mtype"] = ib["mtype"].astype(np.int32)

    def near(base, lo, hi):
        return (base[:, None] + rng.integers(lo, hi + 1, (G, M_))).astype(np.int32)

    ib["from_id"] = rng.integers(0, 4, (G, M_)).astype(np.int32)
    ib["term"] = np.maximum(near(st["term"], -1, 1), 0)
    ib["term"][rng.random((G, M_)) < 0.15] = 0
    ib["log_term"] = np.maximum(near(st["term"], -1, 1), 0)
    ib["log_index"] = np.maximum(near(st["last_index"], -3, 2), 0)
    # some reach below the W-entry ring window
    far = rng.random((G, M_)) < 0.1
    ib["log_index"][far] = np.maximum(near(st["last_index"], -2 * W, -W)[far], 0)
    ib["commit"] = np.maximum(near(st["committed"], -1, 3), 0)
    ib["reject"] = (rng.random((G, M_)) < 0.3).astype(np.int32)
    ib["hint"] = np.where(rng.random((G, M_)) < 0.5, 0,
                          near(st["last_index"], -2, 2)).astype(np.int32)
    ib["hint_high"] = (rng.random((G, M_)) < 0.2).astype(np.int32)
    ib["n_entries"] = rng.integers(0, E_ + 1, (G, M_)).astype(np.int32)
    tick = ib["mtype"] == T.MT_TICK
    ib["log_index"][tick] = rng.integers(0, 4, int(tick.sum()))
    ib["ent_term"] = np.maximum(
        st["term"][:, None, None] + rng.integers(-1, 2, (G, M_, E_)), 1
    ).astype(np.int32)
    ib["ent_cc"] = (rng.random((G, M_, E_)) < 0.1).astype(np.int32)
    return {k: np.ascontiguousarray(v, dtype=np.int32) for k, v in ib.items()}


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
                       "dragonboat_tpu/ops/engine.py:400"],
    ),
}


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


def ptxas_report(log: str) -> dict:
    """Register and spill lines of each kernel from the build's ptxas
    report."""
    names = ("raft_step_kernel", "summarize_flags_kernel",
             "gather_pack_kernel", "place_rows_kernel",
             "place_snapshot_kernel")
    rep, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = next((n for n in names if n in m.group(1)), None)
        elif cur and ("registers" in ln or "spill" in ln):
            rep.setdefault(cur, []).append(ln.strip())
    return rep


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


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
    result = dict(routed_steps=n_routed, fuzz_steps=n_fuzz, rows=G,
                  routed=routed, fuzz_escalations=fuzz_esc,
                  checks=checks, max_abs_err=errs)
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
    occ = int((ib_np["mtype"] != 0).sum())
    words = (sum(t.numel() for t in st0) * 2  # state in and out
             + ib.mtype.numel() + occ * (9 + 2 * E)  # occupied slots only
             + sum(t.numel() for t in out))
    bound["raft_step"] = bound_ms(4 * words)
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
    result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, library_ms=lib_ms,
                  gather_rows=[b, b2], scatter_rows=n)
    return result


# ---------------------------------------------------------------------------
# phase 3: the main path — a NodeHost cluster on the card
# ---------------------------------------------------------------------------
SHARDS = 1000
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
    """Keeps the ERROR records of a logger.  The exec engine's step and
    apply workers log what ``step_shards`` or an apply raises and carry
    on, so a failed launch or parity check shows only here and in the
    engine's counters."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.lines = []

    def emit(self, record):
        exc = record.exc_info[1] if record.exc_info else None
        self.lines.append(record.getMessage()
                          + (f": {exc!r}" if exc is not None else ""))


def nodehost_phase(dev, workdir: str, shards: int = SHARDS,
                   writes: int = WRITES_PER_SHARD) -> dict:
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
               value_bytes=VALUE_BYTES, capacity=cap, rtt_ms=RTT_MS,
               election_rtt=ELECTION_RTT, heartbeat_rtt=HEARTBEAT_RTT,
               parity_every=PARITY_EVERY, reduced=[])
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
                        capacity=cap, device=dev, parity_every=PARITY_EVERY,
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

        def write(job):
            s, i = job
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
        with ThreadPoolExecutor(CLIENT_THREADS) as ex:
            list(ex.map(write, jobs))
        dt = time.perf_counter() - t0
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
    idle = [k for k, v in launches.items() if v < 1]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    if len(acked) != shards * writes:
        raise AssertionError(f"acked {len(acked)} of {shards * writes}")
    return res


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
def main() -> int:
    import torch

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
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    t0 = time.perf_counter()
    _native.module()
    build_s = time.perf_counter() - t0
    emit(dict(phase="device", name=name, nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              build_s=build_s, ptxas=ptxas_report(_native.build_log())))

    kern = kernels_phase(dev)
    emit(dict(phase="kernels", card=smi, **kern))

    nh = nodehost_phase(
        dev, os.path.join(here, "dragonboat_tpu_torch", "_build",
                          f"smoke-{os.getpid()}"),
    )
    emit(dict(phase="nodehost", card=smi, **nh))

    rows = []
    for k, info in KERNEL_INFO.items():
        rows.append(dict(
            name=k, route="cuda", source=info["source"],
            replaces=info["replaces"], also_replaces=info["also_replaces"],
            launches=nh["launches"][k],
            max_abs_err=kern["max_abs_err"][k],
            ms=kern["ms"][k], plain_ms=kern["plain_ms"][k],
            bound_ms=kern["bound_ms"][k], bound_by="bytes",
            library_ms=kern["library_ms"][k],
        ))
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
