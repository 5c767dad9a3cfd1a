"""The port's colocated device programs against the reference's.

Each program of ``dragonboat_tpu/ops/colocated.py`` (:174-448) —
``_host_inbox_from_ticks``, ``_scatter_inbox_rows``, ``_assemble_inbox``,
``_assemble_and_step``, ``_route_step``, ``_select_and_blob`` (every
tier of ``_SEL_TIERS`` clamped to a small G, and capacities below the
row counts) and ``_zero_inbox_rows`` — runs on the same int32 inputs
through the JAX program (CPU backend) and through the port's program on
CPU tensors (its plain PyTorch version), round after round of a routed
cluster; every output must be bit-equal.  The same rounds run at the
scale path's geometries (``tests/test_scale.py``: W=16, E=2, O=32,
budget 8, 8 host slots) on about 64 shards: BASELINE config 3's 5
replicas a shard at P=5, and config 4's ragged 3/5/7 memberships at P=7
(a short membership's unused peer slots masked).

Then capture and replay: a port colocated cluster (``device="cpu"``)
runs for a few dozen launches with the real inputs and outputs of every
``_assemble_and_step``, ``_route_step``, ``_select_and_blob`` and
``_scatter_inbox_rows`` call recorded; each call is replayed through the
reference's jitted program and must give the recorded outputs bit for
bit.  Tolerance: zero.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import test_route as TR
from dragonboat_tpu.ops import colocated as JC
from dragonboat_tpu.ops import route as JR
from dragonboat_tpu.ops import sync as JS
from dragonboat_tpu.ops import types as JT
from dragonboat_tpu_torch.ops import colocated as PC
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import types as PT
from dragonboat_tpu.raft.raft import Raft

P, W, E, O = 5, 32, 4, 32
B = 4
PB = P * B
MH = 8
SEED = 20261018
SCALE_ROUNDS = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: faster here,
    and it leaves the other cores to the suite's parallel workers."""
    n = convert.torch.get_num_threads()
    convert.torch.set_num_threads(1)
    yield
    convert.torch.set_num_threads(n)


# --------------------------------------------------------------------------
# numpy <-> each package
# --------------------------------------------------------------------------
_JTYPES = {"DeviceState": JT.DeviceState, "Inbox": JT.Inbox,
           "DeviceOut": JT.DeviceOut}
_PTYPES = {"DeviceState": PT.DeviceState, "Inbox": PT.Inbox,
           "DeviceOut": PT.DeviceOut}


def to_np(x):
    """Any program argument or output, as numpy: NamedTuples keep their
    type name, tuples stay tuples (a tree already converted is kept)."""
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str):
        return x
    if hasattr(x, "_fields"):
        return (type(x).__name__,
                {k: to_np(getattr(x, k)) for k in x._fields})
    if isinstance(x, (tuple, list)):
        return tuple(to_np(y) for y in x)
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x).copy()


def to_jax(x):
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str):
        name, fields = x
        return _JTYPES[name](**{k: to_jax(v) for k, v in fields.items()})
    if isinstance(x, tuple):
        return tuple(to_jax(y) for y in x)
    return jnp.asarray(x)


def to_port(x):
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str):
        name, fields = x
        return _PTYPES[name](**{k: to_port(v) for k, v in fields.items()})
    if isinstance(x, tuple):
        return tuple(to_port(y) for y in x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)  # the delivered bits, as the port holds them
    return convert.torch.from_numpy(np.ascontiguousarray(x))


def flat(x):
    """Leaves of a to_np tree, in order, as numpy arrays."""
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str):
        return [a for k in sorted(x[1]) for a in flat(x[1][k])]
    if isinstance(x, tuple):
        return [a for y in x for a in flat(y)]
    return [np.asarray(x)]


def assert_same(want, got, what):
    """want: the reference's output; got: the port's.  uint32 words of
    the reference (the delivered bits) compare to the port's int32 words
    as bit patterns."""
    w, g = flat(to_np(want)), flat(to_np(got))
    assert len(w) == len(g), what
    for i, (a, b) in enumerate(zip(w, g)):
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), f"{what}: output leaf {i} differs"


def both(jfn, pfn, args, kw=None, what=""):
    """Run the reference program and the port's on the same numpy
    inputs (fresh arrays each: the reference donates some); returns the
    reference's output."""
    kw = kw or {}
    want = jfn(*to_jax(args), **kw)
    got = pfn(*to_port(args), **kw)
    assert_same(want, got, what)
    return want


# --------------------------------------------------------------------------
# program by program, on a routed cluster
# --------------------------------------------------------------------------
def _cluster():
    rafts, _rows = TR.make_cluster_rafts(
        {1: [1, 2, 3], 2: [1, 2, 3], 3: [1, 2, 3, 4, 5], 4: [1, 2, 3]}
    )
    st = JS.state_from_rafts(rafts, P, W)
    dest, rank = TR.tables_for(rafts)
    return to_np(st), np.asarray(dest), np.asarray(rank)


def _scale_cluster(sizes, P_: int, W_: int, E_: int):
    """One routed cluster of the reference's rafts, shard s (from 1) of
    ``sizes[s - 1]`` replicas, packed at P_ / W_ with its route tables
    (a short membership's unused peer slots hold id 0, masked)."""
    rafts = []
    for shard, k in enumerate(sizes, start=1):
        voters = {r: f"a{r}" for r in range(1, k + 1)}
        for rid in range(1, k + 1):
            rafts.append(Raft(shard_id=shard, replica_id=rid,
                              peers=dict(voters), election_timeout=10,
                              heartbeat_timeout=2,
                              max_entries_per_replicate=E_))
    st = JS.state_from_rafts(rafts, P_, W_)
    peer_ids = np.zeros((len(rafts), P_), np.int32)
    for g, r in enumerate(rafts):
        for slot, (pid, _kind) in enumerate(JS.peer_layout(r)):
            peer_ids[g, slot] = pid
    dest, rank = JR.build_route_tables(
        np.array([r.shard_id for r in rafts], np.int32),
        np.array([r.replica_id for r in rafts], np.int32), peer_ids)
    return to_np(st), np.asarray(dest), np.asarray(rank)


def _programs_round_by_round(cluster, *, P_: int, E_: int, O_: int,
                             B_: int, MH_: int, rounds: int, seed: int):
    """Every colocated program, the reference's and the port's, on the
    same inputs round after round of ``cluster`` (state, dest, rank):
    from_ticks, a host-slot scatter, assemble, the fused step, the route
    step, the select at every tier of ``_SEL_TIERS`` clamped to G (and
    at capacities below the row counts), then zero rows.  Returns what
    the rounds exercised."""
    st, dest, rank = cluster
    G = dest.shape[0]
    PB_ = P_ * B_
    rng = np.random.default_rng(seed)
    pending = to_np(JT.make_inbox(G, PB_, E_))
    tiers = [{k: min(G, v) for k, v in t.items()} for t in JC._SEL_TIERS]
    tiers.append({"b": 2, "sl": 3, "n": 1, "a": 2, "s": 5})
    seen = {"delivered": 0, "esc": 0, "sel": np.zeros(5, np.int64)}
    for rnd in range(rounds):
        combo = np.zeros((G, 4), np.int32)
        combo[:, JC._C_ALIVE] = rng.random(G) < 0.92
        combo[:, JC._C_BATCH] = rng.random(G) < 0.5
        combo[:, JC._C_PROP] = rng.random(G) < 0.2
        combo[:, JC._C_TICKS] = rng.integers(0, 4, G)
        host = both(JC._host_inbox_from_ticks, PC._host_inbox_from_ticks,
                    (combo,), dict(M=MH_, E=E_), f"from_ticks {rnd}")
        # a few rows with real host slots: a one-entry PROPOSE in slot 1
        rows = sorted(rng.choice(G, size=3, replace=False).tolist())
        sub = {k: np.asarray(getattr(host, k))[rows].copy()
               for k in JT.Inbox._fields}
        sub["mtype"][:, 1] = JT.MT_PROPOSE
        sub["n_entries"][:, 1] = 1
        sub["ent_cc"][:, 1, 0] = rng.integers(0, 2, 3)
        pos = np.full((G,), -1, np.int32)
        pos[rows] = np.arange(3)
        host = both(JC._scatter_inbox_rows, PC._scatter_inbox_rows,
                    (to_np(host), pos, ("Inbox", sub)), None,
                    f"scatter {rnd}")
        host_np = to_np(host)
        # the reference takes the alive lane as a bool mask, the port
        # the combo word it comes from
        want = JC._assemble_inbox(*to_jax((host_np, pending)),
                                  jnp.asarray(combo[:, JC._C_ALIVE] != 0))
        got = PC._assemble_inbox(*to_port((host_np, pending, combo)))
        assert_same(want, got, f"assemble {rnd}")
        new_st, out = both(JC._assemble_and_step, PC._assemble_and_step,
                           (st, host_np, pending, combo),
                           dict(out_capacity=O_), f"assemble_and_step {rnd}")
        new_np, out_np = to_np(new_st), to_np(out)
        merged, regions, stats, packed, flags = both(
            JC._route_step, PC._route_step,
            (st, new_np, out_np, dest, rank, combo),
            dict(PB=PB_, E=E_, budget=B_), f"route_step {rnd}")
        seen["delivered"] += int(stats[0])
        seen["esc"] += int((np.asarray(out.escalate) != 0).sum())
        m_np, s_np = to_np(merged), to_np(stats)
        p_np, f_np = to_np(packed), to_np(flags)
        for t, caps in enumerate(tiers):
            head, _detail = both(
                JC._select_and_blob, PC._select_and_blob,
                (m_np, out_np, s_np, p_np, f_np, combo),
                dict(CAP_B=caps["b"], CAP_SL=caps["sl"], CAP_N=caps["n"],
                     CAP_A=caps["a"], CAP_S=caps["s"], HOST_OFF=PB_),
                f"select_and_blob tier {t} round {rnd}")
            if t == 0:
                nw = (O_ + 31) // 32
                seen["sel"] += np.asarray(head)[G + G * nw + 6:
                                                G + G * nw + 11]
        regions_np = to_np(regions)
        mask = rng.random(G) < 0.2
        pending = to_np(both(JC._zero_inbox_rows, PC._zero_inbox_rows,
                             (regions_np, mask), None, f"zero rows {rnd}"))
        st = m_np
    return seen


def test_programs_match_reference_round_by_round():
    seen = _programs_round_by_round(_cluster(), P_=P, E_=E, O_=O, B_=B,
                                    MH_=MH, rounds=28, seed=SEED)
    # the rounds exercised routing and every selected section
    assert seen["delivered"] > 0
    assert (seen["sel"][[0, 1, 3, 4]] > 0).all(), seen


# the scale path's geometries (tests/test_scale.py:160-178): W=16, E=2,
# O=32, budget 8, 8 host slots; (a) BASELINE config 3, 5 replicas a
# shard, P=5; (b) config 4's ragged 3/5/7 memberships, P=7
SCALE_GEOMETRIES = {
    "config3_p5_b8": dict(sizes=[5] * 64, P_=5),
    "config4_p7_ragged_b8": dict(sizes=[3, 5, 7] * 21, P_=7),
}


@pytest.mark.parametrize("name", sorted(SCALE_GEOMETRIES))
def test_programs_match_reference_at_scale_geometry(name):
    """Every colocated program bit-exact against the reference's at the
    scale path's geometries (about 64 shards), with every select tier."""
    g = SCALE_GEOMETRIES[name]
    cluster = _scale_cluster(g["sizes"], g["P_"], 16, 2)
    seen = _programs_round_by_round(cluster, P_=g["P_"], E_=2, O_=32, B_=8,
                                    MH_=8, rounds=SCALE_ROUNDS,
                                    seed=SEED + len(name))
    assert seen["delivered"] > 0
    assert (seen["sel"][[0, 1, 3, 4]] > 0).all(), seen


def test_route_step_in_place_matches_reference_with_escalated_rows():
    """The port's ``_route_step`` consumes new_state (the reference
    donates it): the escalated rows are merged into it in place and
    merged is that tree.  With a seeded quarter of the rows marked
    escalated in the step's outbox, every output equals the reference's
    ``_route_step`` on the same inputs, round after round (tolerance:
    zero)."""
    st, dest, rank = _cluster()
    G = dest.shape[0]
    rng = np.random.default_rng(SEED + 3)
    pending = to_np(JT.make_inbox(G, PB, E))
    n_esc = 0
    for rnd in range(12):
        combo = np.zeros((G, 4), np.int32)
        combo[:, JC._C_ALIVE] = rng.random(G) < 0.92
        combo[:, JC._C_TICKS] = rng.integers(0, 4, G)
        host = to_np(JC._host_inbox_from_ticks(jnp.asarray(combo), M=MH, E=E))
        new_st, out = JC._assemble_and_step(
            *to_jax((st, host, pending, combo)), out_capacity=O)
        new_np, out_np = to_np(new_st), to_np(out)
        esc = np.where(rng.random(G) < 0.25, rng.integers(1, 16, G), 0)
        out_np[1]["escalate"] = esc.astype(np.int32)
        n_esc += int((esc != 0).sum())
        args = (st, new_np, out_np, dest, rank, combo)
        kw = dict(PB=PB, E=E, budget=B)
        want = JC._route_step(*to_jax(args), **kw)
        p_args = to_port(args)
        got = PC._route_step(*p_args, **kw)
        assert all(a is b for a, b in zip(got[0], p_args[1]))  # in place
        assert_same(want, got, f"route_step round {rnd}")
        st = to_np(want[0])
        pending = to_np(want[1])
    assert n_esc > 0


# --------------------------------------------------------------------------
# capture and replay: a port colocated cluster's real program calls
# --------------------------------------------------------------------------
_CAPTURED = ("_assemble_and_step", "_route_step", "_select_and_blob",
             "_scatter_inbox_rows")


def test_capture_and_replay_through_reference(tmp_path, monkeypatch):
    from test_torch_colocated import make_colocated_cluster, start_shards
    from test_torch_engine import propose_r, set_cmd, wait_for_leader

    calls = {name: [] for name in _CAPTURED}
    seen = {name: 0 for name in _CAPTURED}
    for name in _CAPTURED:
        fn = getattr(PC, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            out = _fn(*args, **kw)
            seen[_name] += 1
            # the first calls, then every 4th: the election and the
            # proposals' routed traffic both land in the record
            n = seen[_name]
            if len(calls[_name]) < 48 and (n <= 16 or n % 4 == 0):
                calls[_name].append((to_np(args), dict(kw), to_np(out)))
            return out

        monkeypatch.setattr(PC, name, rec)
    group, nhs = make_colocated_cluster(tmp_path)
    try:
        start_shards(nhs, shards=(1, 2))
        for s in (1, 2):
            wait_for_leader(nhs, s)
        for i in range(6):
            for s in (1, 2):
                nh = nhs[1]
                propose_r(nh, nh.get_noop_session(s),
                          set_cmd(f"c{i}", str(i).encode()))
    finally:
        for nh in nhs.values():
            nh.close()
    for name in _CAPTURED:
        assert len(calls[name]) >= 8, (name, len(calls[name]))
    delivered = [int(out[2][0]) for _a, _k, out in calls["_route_step"]]
    assert sum(delivered) > 0, (seen, delivered)
    for name in _CAPTURED:
        jfn = getattr(JC, name)
        for i, (args, kw, out) in enumerate(calls[name]):
            assert_same(jfn(*to_jax(args), **kw), out,
                        f"replay {name} call {i}")
