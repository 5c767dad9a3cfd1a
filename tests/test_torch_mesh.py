"""The port's G-last step and sharded device plane against the reference.

* ``step_internal`` (plain PyTorch version, CPU tensors) equals
  ``dragonboat_tpu.ops.kernel.step_internal`` on bench phase A's fused
  tick inbox over several launches, and on seeded fuzz inboxes over
  every hot message type.
* ``make_step_sharded`` (external and internal layout) on a
  ``GroupsMesh(["cpu"] * D)`` at D = 1, 2 and 4 equals the reference's
  single-device ``step`` / ``step_internal`` over the election script of
  ``tests/test_multichip.py``.
* ``build_route_tables_mesh`` / ``xbudget_for`` equal the reference's,
  divisibility error included.
* ``make_sharded_round`` at D = 2, 4 and 8 (replica-major layout: every
  group straddles device blocks) and across a membership-change fence
  equals the reference's single-device ``routed_round`` round by round;
  ``rounds=3`` waves equal the reference's ``fused_rounds`` and the
  port's own serial sharded rounds.
* ``cross_exchange`` on seeded fuzz outboxes (repeated peer ids,
  forwarded PROPOSE, below-ring markers, more messages than the budget,
  an ``xbudget`` below ``xbudget_for``) equals the reference's
  ``cross_exchange`` run under a ``jax.shard_map`` this file builds over
  2 and 4 of the forced host devices: inbox and all five CrossStats.

The reference's own sharded programs do not run under this jax (they
pass ``check_rep``), so the sharded port is held against the
single-device reference on the same global rows, as
``tests/test_multichip.py`` states its contract.  The reference
trajectories do not depend on D and are computed once per module.
Inputs are int32 numpy arrays handed to both packages; tolerance: zero
(bit-exact).  JAX runs on its CPU backend.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as PS

import chip_smoke
from dragonboat_tpu.ops import kernel as JK
from dragonboat_tpu.ops import route as JR
from dragonboat_tpu.ops import types as JT
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import kernel as PK
from dragonboat_tpu_torch.ops import placement as PP
from dragonboat_tpu_torch.ops import route as PRt

torch = convert.torch
SEED = 20261017
REPL = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: faster here,
    and it leaves the other cores to the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(nt) -> dict:
    return {k: np.asarray(getattr(nt, k)) for k in nt._fields}


def _jax(cls, fields: dict):
    return cls(**{k: jnp.asarray(v) for k, v in fields.items()})


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def assert_fields_equal(want: dict, got: dict, what: str) -> None:
    assert set(want) == set(got), what
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        assert np.array_equal(g, w), (
            f"{what}: field {k} differs at {np.argwhere(g != w)[:5].tolist()}")


def _cpu_mesh(n: int) -> PP.GroupsMesh:
    return PP.GroupsMesh(["cpu"] * n)


def _joined(mesh, tree) -> dict:
    return convert.to_numpy(mesh.join(tree))


# --------------------------------------------------------------------------
# step_internal
# --------------------------------------------------------------------------
_jax_step_internal = jax.jit(JK.step_internal, static_argnames=("out_capacity",))


def _phase_a_inputs(groups: int):
    """Bench phase A (bench.py:48-140) at ``groups`` groups: internal
    layout, every slot a fused tick of 32."""
    P, W, M, E, tpl = 3, 8, 12, 1, 32
    G = groups * REPL
    cols = JT.make_state_np(
        G, P, W,
        shard_ids=np.repeat(np.arange(1, groups + 1, dtype=np.int32), REPL),
        replica_ids=np.tile(np.arange(1, REPL + 1, dtype=np.int32), groups),
        peer_ids=np.broadcast_to(
            np.arange(1, REPL + 1, dtype=np.int32), (G, P)).copy(),
        election_timeout=2 * tpl, heartbeat_timeout=2,
    )
    st = {k: np.ascontiguousarray(v) for k, v in
          JK.state_to_internal(JT.DeviceState(**cols))._asdict().items()}
    zm = np.zeros((M, G), np.int32)
    ib = dict(
        mtype=np.full((M, G), JT.MT_TICK, np.int32), from_id=zm, term=zm,
        log_term=zm, log_index=np.full((M, G), tpl, np.int32), commit=zm,
        reject=zm, hint=zm, hint_high=zm, n_entries=zm,
        ent_term=np.zeros((M, E, G), np.int32),
        ent_cc=np.zeros((M, E, G), np.int32),
    )
    return st, ib


def _check_step_internal(st: dict, ib: dict, O: int, what: str):
    j_st, j_out = _jax_step_internal(
        _jax(JT.DeviceState, st), _jax(JT.Inbox, ib), out_capacity=O)
    p_st, p_out = PK.step_internal(
        convert.state_from_numpy(st, "cpu"),
        convert.inbox_from_numpy(ib, "cpu"), O)
    assert_fields_equal(_np(j_st), convert.to_numpy(p_st), f"state {what}")
    assert_fields_equal(_np(j_out), convert.to_numpy(p_out), f"out {what}")
    return convert.to_numpy(p_st), convert.to_numpy(p_out)


def test_step_internal_phase_a_ticks():
    """Six launches of phase A's tick loop: campaigns, pre-votes and the
    outbox overflow escalation, state carried launch to launch."""
    st, ib = _phase_a_inputs(12)
    esc = 0
    for launch in range(6):
        st, out = _check_step_internal(st, ib, 8, f"launch {launch}")
        esc += int((out["escalate"] != 0).sum())
    assert (st["term"] > 0).all()
    assert esc > 0


@pytest.mark.parametrize("seed", range(3))
def test_step_internal_fuzz_matches_reference(seed):
    """Seeded fuzz inboxes over every hot message type (and a few cold
    ones) on a 3-replica cluster state, four steps in a row."""
    rng = np.random.default_rng(SEED + seed)
    P, W, M, E, O = 5, 32, 8, 4, 32
    G = 36
    ext = chip_smoke.cluster_state_np(G, P, W, SEED + seed)
    ext["role"] = rng.integers(0, 4, G).astype(np.int32)
    ext["term"] = rng.integers(1, 5, G).astype(np.int32)
    ext["last_index"] = rng.integers(0, 40, G).astype(np.int32)
    ext["committed"] = np.minimum(ext["last_index"],
                                  rng.integers(0, 40, G)).astype(np.int32)
    ext["ring_term"] = np.minimum(
        rng.integers(1, 5, (G, W)), ext["term"][:, None]).astype(np.int32)
    ext["match"] = rng.integers(0, 40, (G, P)).astype(np.int32)
    ext["next_idx"] = (ext["match"] + 1).astype(np.int32)
    ext["rstate"] = rng.integers(0, 4, (G, P)).astype(np.int32)
    st = convert.to_numpy(PK.state_to_internal(
        convert.state_from_numpy(ext, "cpu")))
    for k in range(4):
        ib_ext = chip_smoke.fuzz_inbox_np(ext, rng, M, E)
        ib = convert.to_numpy(PK.inbox_to_internal(
            convert.inbox_from_numpy(ib_ext, "cpu")))
        st, _out = _check_step_internal(st, ib, O, f"seed {seed} step {k}")
        ext = convert.to_numpy(convert.state_from_internal(
            convert.state_from_numpy(st, "cpu")))


# --------------------------------------------------------------------------
# make_step_sharded (tests/test_multichip.py:74-104)
# --------------------------------------------------------------------------
STEP_G, STEP_P, STEP_W, STEP_M, STEP_E, STEP_O = 32, 3, 8, 4, 1, 8
_jax_step = jax.jit(JK.step, static_argnames=("out_capacity",))


def _election_script():
    G, P = STEP_G, STEP_P
    peer_ids = np.zeros((G, P), np.int32)
    peer_ids[: G // 2, 0] = 1
    peer_ids[G // 2:, :3] = np.array([1, 2, 3], np.int32)
    st = JT.make_state_np(
        G, P, STEP_W, shard_ids=np.arange(1, G + 1, dtype=np.int32),
        replica_ids=np.ones((G,), np.int32), peer_ids=peer_ids,
        election_timeout=6, heartbeat_timeout=2,
    )
    ib = {k: np.asarray(v) for k, v in
          JT.make_inbox(G, STEP_M, STEP_E)._asdict().items()}
    ib["mtype"] = np.full((G, STEP_M), JT.MT_TICK, np.int32)
    ib["log_index"] = np.full((G, STEP_M), 3, np.int32)  # fused count 3
    return st, ib


@pytest.fixture(scope="module")
def step_reference():
    """The reference's four single-device launches, external and
    internal: {internal: (inputs, [(state, out) per launch])}."""
    st, ib = _election_script()
    ref = {}
    for internal in (False, True):
        if internal:
            s = _np(JK.state_to_internal(_jax(JT.DeviceState, st)))
            i = _np(JK.inbox_to_internal(_jax(JT.Inbox, ib)))
            fn = _jax_step_internal
        else:
            s, i, fn = st, ib, _jax_step
        js, ji = _jax(JT.DeviceState, s), _jax(JT.Inbox, i)
        traj = []
        for _ in range(4):
            js, jo = fn(js, ji, out_capacity=STEP_O)
            traj.append((_np(js), _np(jo)))
        ref[internal] = ((s, i), traj)
    return ref


@pytest.mark.parametrize("internal", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_step_matches_reference(step_reference, n_dev, internal):
    (st, ib), traj = step_reference[internal]
    mesh = _cpu_mesh(n_dev)
    p_st = convert.state_from_numpy(st, "cpu")
    p_ib = convert.inbox_from_numpy(ib, "cpu")
    step_fn = PK.make_step_sharded(mesh, p_st, p_ib, out_capacity=STEP_O,
                                   internal=internal)
    s = p_st
    for k, (want_st, want_out) in enumerate(traj):
        s, out = step_fn(s, p_ib)
        assert isinstance(s, PP.Sharded) and len(s.parts) == n_dev
        assert_fields_equal(want_st, _joined(mesh, s), f"state launch {k}")
        assert_fields_equal(want_out, _joined(mesh, out), f"out launch {k}")
    # the script elects: single-voter rows all lead
    assert (traj[-1][0]["role"][: STEP_G // 2] == JT.ROLE_LEADER).all()


# --------------------------------------------------------------------------
# mesh tables
# --------------------------------------------------------------------------
def _replica_major(groups: int, P: int):
    """Group i's replicas at rows {i, groups+i, 2*groups+i}: at any mesh
    size > 1 every group straddles device blocks."""
    G = groups * REPL
    shard_ids = np.tile(np.arange(1, groups + 1, dtype=np.int32), REPL)
    replica_ids = np.repeat(np.arange(1, REPL + 1, dtype=np.int32), groups)
    peer_ids = np.zeros((G, P), np.int32)
    peer_ids[:, :REPL] = np.arange(1, REPL + 1, dtype=np.int32)
    return G, shard_ids, replica_ids, peer_ids


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_mesh_tables_and_xbudget_match_reference(n_dev):
    layouts = [_replica_major(8, 3)[1:]]
    rng = np.random.default_rng(SEED + 40)
    sh, rp, pe = _replica_major(8, 4)[1:]
    pe[:, 3] = np.where(rng.random(len(sh)) < 0.3, rng.integers(1, 4, len(sh)),
                        0)  # repeated peer ids
    pe[rng.random(len(sh)) < 0.2, 2] = 0  # replicas missing from tables
    layouts.append((sh, rp, pe))
    for sh, rp, pe in layouts:
        want = JR.build_route_tables_mesh(sh, rp, pe, n_dev)
        got = PRt.build_route_tables_mesh(sh, rp, pe, n_dev)
        for w, g in zip(want, got):
            assert g.dtype == np.int32 and np.array_equal(g, w)
        for budget in (1, 4):
            assert (PRt.xbudget_for(got, budget, n_dev)
                    == JR.xbudget_for(want, budget, n_dev))
    with pytest.raises(ValueError, match="divide"):
        PRt.build_route_tables_mesh(sh, rp, pe, 5)


# --------------------------------------------------------------------------
# make_sharded_round (tests/test_multichip.py:108-189)
# --------------------------------------------------------------------------
RP, RW, RE, RO, RBUD, RBASE = 3, 16, 2, 16, 4, 2
RM = RBASE + RP * RBUD
_jax_round = jax.jit(
    JR.routed_round,
    static_argnames=("out_capacity", "budget", "base", "propose_leaders",
                     "propose_n"),
)


def _round_setup(groups: int):
    G, sh, rp, pe = _replica_major(groups, RP)
    st = JT.make_state_np(G, RP, RW, shard_ids=sh, replica_ids=rp,
                          peer_ids=pe, election_timeout=10,
                          heartbeat_timeout=2)
    ib = _np(JR.make_prefill(_jax(JT.DeviceState, st), RM, RE))
    return sh, rp, pe, st, ib


def _drop_replica_3_of_group_1(sh, pe, st):
    """The fence of test_multichip.py:150-170: group 1 drops replica 3
    (peer slot cleared on every row); the tables are rebuilt."""
    pe = pe.copy()
    pe[sh == 1, 2] = 0
    st = dict(st)
    st["peer_id"] = st["peer_id"].copy()
    st["peer_id"][sh == 1, 2] = 0
    return pe, st


@functools.lru_cache(maxsize=None)
def _round_reference(groups: int, rounds: int, mutate_at):
    """The reference's single-device trajectory: per round, the state
    and inbox after it (numpy), and the tables each round used."""
    sh, rp, pe, st, ib = _round_setup(groups)
    traj, pes = [], []
    for i in range(rounds):
        if mutate_at is not None and i == mutate_at:
            pe, st = _drop_replica_3_of_group_1(sh, pe, st)
        dest, rank = JR.build_route_tables(sh, rp, pe)
        js, ji, _s, _n = _jax_round(
            _jax(JT.DeviceState, st), _jax(JT.Inbox, ib), jnp.asarray(dest),
            jnp.asarray(rank), out_capacity=RO, budget=RBUD, base=RBASE,
            propose_leaders=True)
        st, ib = _np(js), _np(ji)
        traj.append((st, ib))
        pes.append(pe)
    return traj, pes


def _run_sharded(n_dev: int, groups: int = 8, rounds: int = 24,
                 mutate_at=None):
    traj, pes = _round_reference(groups, rounds, mutate_at)
    sh, rp, pe, st, ib = _round_setup(groups)
    mesh = _cpu_mesh(n_dev)
    tabs = PRt.build_route_tables_mesh(sh, rp, pe, n_dev)
    XB = PRt.xbudget_for(tabs, RBUD, n_dev)
    round_fn = PRt.make_sharded_round(
        mesh, M=RM, E=RE, out_capacity=RO, budget=RBUD, xbudget=XB,
        base=RBASE, propose_leaders=True)
    s = convert.state_from_numpy(st, "cpu")
    i = convert.inbox_from_numpy(ib, "cpu")
    args = [_t(t) for t in tabs]
    lane_tot = np.zeros((7,), np.int64)
    for r in range(rounds):
        if mutate_at is not None and r == mutate_at:
            _pe, st_np = _drop_replica_3_of_group_1(
                sh, pe, _joined(mesh, s))
            s = convert.state_from_numpy(st_np, "cpu")
            args = [_t(t) for t in PRt.build_route_tables_mesh(
                sh, rp, pes[r], n_dev)]
        s, i, rstats, lane = round_fn(s, i, *args)
        assert tuple(rstats.shape) == (n_dev, 6)
        assert tuple(lane.shape) == (n_dev, 7)
        want_st, want_ib = traj[r]
        assert_fields_equal(want_st, _joined(mesh, s), f"state round {r}")
        assert_fields_equal(want_ib, _joined(mesh, i), f"inbox round {r}")
        lane_tot += lane.numpy().astype(np.int64).sum(0)
    return _joined(mesh, s), lane_tot, groups


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_round_matches_reference(n_dev):
    st, lane, groups = _run_sharded(n_dev)
    assert lane[1] > 0, "no cross-device traffic reached the lane"
    assert lane[3] == 0, f"xlane drops at sized budget: {lane}"
    assert lane[6] + lane[5] == 24 * groups * REPL  # every row, every round
    commits = st["committed"].reshape(REPL, groups).max(0)
    assert (st["role"] == JT.ROLE_LEADER).sum() >= groups - 2
    assert (commits > 0).sum() >= groups - 2


def test_sharded_round_membership_change_fence():
    st, lane, groups = _run_sharded(4, rounds=30, mutate_at=12)
    assert lane[1] > 0 and lane[3] == 0
    commits = st["committed"].reshape(REPL, groups).max(0)
    assert commits[0] > 0  # the fenced group still commits
    assert (st["role"] == JT.ROLE_LEADER).sum() >= groups - 2
    assert (commits > 0).sum() >= groups - 2


_jax_fused = jax.jit(
    JR.fused_rounds,
    static_argnames=("rounds", "out_capacity", "budget", "base",
                     "propose_leaders", "propose_n"),
)


def test_sharded_fused_waves_match_reference():
    """tests/test_pipeline.py:512: rounds=3 waves on two devices equal
    the reference's fused_rounds and the port's three serial sharded
    rounds; the lane fires between fused rounds."""
    K_, groups, n_dev = 3, 4, 2
    sh, rp, pe, st, ib = _round_setup(groups)
    mesh = _cpu_mesh(n_dev)
    tabs = PRt.build_route_tables_mesh(sh, rp, pe, n_dev)
    XB = PRt.xbudget_for(tabs, RBUD, n_dev)
    dest, rank = JR.build_route_tables(sh, rp, pe)
    kw = dict(M=RM, E=RE, out_capacity=RO, budget=RBUD, xbudget=XB,
              base=RBASE, propose_leaders=True)
    round_fn = PRt.make_sharded_round(mesh, **kw)
    wave_fn = PRt.make_sharded_round(mesh, rounds=K_, **kw)
    args = [_t(t) for t in tabs]
    s_serial = s_wave = convert.state_from_numpy(st, "cpu")
    i_serial = i_wave = convert.inbox_from_numpy(ib, "cpu")
    js, ji = _jax(JT.DeviceState, st), _jax(JT.Inbox, ib)
    lane_tot = np.zeros((7,), np.int64)
    for w in range(8):
        serial_lane = []
        for _ in range(K_):
            s_serial, i_serial, _r, ln = round_fn(s_serial, i_serial, *args)
            serial_lane.append(ln.numpy())
        s_wave, i_wave, rstats, lane = wave_fn(s_wave, i_wave, *args)
        assert tuple(lane.shape) == (n_dev * K_, 7)
        assert tuple(rstats.shape) == (n_dev * K_, 6)
        # device-major rows: device d's K rounds, then device d+1's
        want_lane = np.stack(serial_lane, 1).reshape(n_dev * K_, 7)
        assert np.array_equal(lane.numpy(), want_lane), f"wave {w} lane"
        lane_tot += lane.numpy().astype(np.int64).sum(0)
        js, ji, _st, _esc = _jax_fused(
            js, ji, jnp.asarray(dest), jnp.asarray(rank), rounds=K_,
            out_capacity=RO, budget=RBUD, base=RBASE, propose_leaders=True)
        for tree, want in ((s_wave, _np(js)), (s_serial, _np(js)),
                           (i_wave, _np(ji)), (i_serial, _np(ji))):
            assert_fields_equal(want, _joined(mesh, tree), f"wave {w}")
    assert lane_tot[1] > 0 and lane_tot[3] == 0
    assert int((np.asarray(js.role) == JT.ROLE_LEADER).sum()) == groups


# --------------------------------------------------------------------------
# cross_exchange against the reference's lane under a jax.shard_map
# --------------------------------------------------------------------------
def lane_fuzz_inputs(rng, n_dev: int, groups: int = 8, P: int = 4,
                     W: int = 8, E: int = 2, O: int = 12, B: int = 2,
                     base: int = 1):
    """A replica-major layout whose peer tables sometimes repeat an id
    and sometimes drop a replica, post-step-like states, and outboxes
    that hit every lane case: forwarded PROPOSE, ring-stale and
    below-ring REPLICATE, unknown destinations, more messages toward one
    peer than the budget.  Returns numpy (state, out, inbox, tables,
    suppress) and the layout constants."""
    G, sh, rp, pe = _replica_major(groups, P)
    pe[:, 3] = np.where(rng.random(G) < 0.3, rng.integers(1, 4, G), 0)
    pe[rng.random(G) < 0.1, 1] = 0
    tabs = PRt.build_route_tables_mesh(sh, rp, pe, n_dev)
    st = JT.make_state_np(G, P, W, shard_ids=sh, replica_ids=rp,
                          peer_ids=pe)
    last = rng.integers(0, 60, G).astype(np.int32)
    st["last_index"] = last
    st["first_index"] = np.maximum(1, last - rng.integers(0, 3 * W, G)).astype(
        np.int32)
    st["ring_term"] = rng.integers(1, 9, (G, W)).astype(np.int32)
    st["ring_cc"] = rng.integers(0, 2, (G, W)).astype(np.int32)
    types = np.array([
        JT.MT_REPLICATE, JT.MT_REPLICATE, JT.MT_REPLICATE,
        JT.MT_REPLICATE_RESP, JT.MT_HEARTBEAT, JT.MT_HEARTBEAT_RESP,
        JT.MT_REQUEST_VOTE, JT.MT_REQUEST_VOTE_RESP, JT.MT_PROPOSE,
        JT.MT_READ_INDEX_RESP,
    ], np.int32)
    buf = np.zeros((G, O, JT.N_FIELDS), np.int32)
    for g in range(G):
        ids = [int(x) for x in pe[g] if x]
        lo = max(int(st["first_index"][g]), int(last[g]) - (W - 1))
        for o in range(O):
            mt = int(rng.choice(types))
            r = rng.random()
            to = (int(rng.choice(ids)) if r < 0.85 and ids
                  else 0 if r < 0.93 else 9)
            n = int(rng.integers(0, E + 1)) if mt in (
                JT.MT_REPLICATE, JT.MT_PROPOSE) else 0
            li = int(rng.integers(-3, 65))
            if mt == JT.MT_REPLICATE and rng.random() < 0.4:
                li = lo - 1 + int(rng.integers(-2, 2))  # the window's edge
            lt = 0 if rng.random() < 0.2 else int(rng.integers(1, 9))
            buf[g, o] = [mt, to, int(rng.integers(1, 9)), lt, li,
                         int(rng.integers(0, 60)), int(rng.integers(0, 2)),
                         int(rng.integers(0, 99)), int(rng.integers(0, 3)), n,
                         int(rng.integers(0, 4))]
    out = {k: np.asarray(v) for k, v in
           JT.make_out(G, P, base + P * B, E, O)._asdict().items()}
    out["buf"] = buf
    out["count"] = rng.integers(0, O + 1, G).astype(np.int32)
    M = base + P * B
    ib = {k: rng.integers(0, 4, (G, M) + ((E,) if k.startswith("ent_")
                                          else ())).astype(np.int32)
          for k in JT.Inbox._fields}
    sup = rng.random(G) < 0.15
    return st, out, ib, tabs, sup, dict(G=G, P=P, W=W, E=E, O=O, B=B,
                                        base=base, M=M)


@functools.lru_cache(maxsize=None)
def _jax_lane(n_dev: int, budget: int, xbudget: int, base: int):
    mesh = Mesh(np.asarray(jax.devices("cpu")[:n_dev]), ("groups",))

    def local(st, out, ib, dl, dd, rk, sup):
        ib2, xs = JR.cross_exchange(
            st, out, ib, dl, dd, rk, axis="groups", n_dev=n_dev,
            budget=budget, xbudget=xbudget, base=base, suppress=sup)
        return ib2, jnp.stack(list(xs))[None]

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(PS("groups"),) * 7,
        out_specs=(PS("groups"), PS("groups")), check_vma=False))


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("seed", range(2))
def test_cross_exchange_fuzz_matches_reference(n_dev, seed):
    if len(jax.devices("cpu")) < n_dev:
        pytest.skip(f"needs {n_dev} forced host devices")
    rng = np.random.default_rng(SEED + 60 + seed)
    st, out, ib, tabs, sup, c = lane_fuzz_inputs(rng, n_dev)
    sized = PRt.xbudget_for(tabs, c["B"], n_dev)
    mesh = _cpu_mesh(n_dev)
    hit = np.zeros((5,), np.int64)
    for xb in (sized, max(1, sized // 8), 1):
        j_ib, j_stats = _jax_lane(n_dev, c["B"], xb, c["base"])(
            _jax(JT.DeviceState, st), _jax(JT.DeviceOut, out),
            _jax(JT.Inbox, ib), *(jnp.asarray(t) for t in tabs),
            jnp.asarray(sup))
        p_ib, p_stats = PRt.cross_exchange(
            mesh, convert.state_from_numpy(st, "cpu"),
            convert.out_from_numpy(out, "cpu"),
            convert.inbox_from_numpy(ib, "cpu"), *(_t(t) for t in tabs),
            budget=c["B"], xbudget=xb, base=c["base"],
            suppress=torch.from_numpy(sup))
        assert_fields_equal(_np(j_ib), _joined(mesh, p_ib),
                            f"lane inbox xbudget={xb}")
        got = torch.stack(list(p_stats), 1).numpy()
        assert np.array_equal(got, np.asarray(j_stats)), (xb, got, j_stats)
        hit += got.astype(np.int64).sum(0)
    # every counter was reached, the lane drops included (a repeated peer
    # id sums dest_dev past the mesh, a lane drop at any budget)
    assert (hit > 0).all(), hit


def test_cross_exchange_one_device_is_a_no_op():
    rng = np.random.default_rng(SEED + 70)
    st, out, ib, tabs, sup, c = lane_fuzz_inputs(rng, 1)
    mesh = _cpu_mesh(1)
    p_ib, p_stats = PRt.cross_exchange(
        mesh, convert.state_from_numpy(st, "cpu"),
        convert.out_from_numpy(out, "cpu"),
        convert.inbox_from_numpy(ib, "cpu"), *(_t(t) for t in tabs),
        budget=c["B"], xbudget=4, base=c["base"])
    assert_fields_equal(ib, _joined(mesh, p_ib), "one-device lane")
    assert all(int(s.sum()) == 0 for s in p_stats)


def test_groups_mesh_contract(monkeypatch):
    mesh = _cpu_mesh(4)
    assert mesh.size == 4 and mesh.axis_names == ("groups",)
    assert all(d.type == "cpu" for d in mesh.devices)
    st, ib = _election_script()
    p = convert.state_from_numpy(st, "cpu")
    sh = mesh.shard(p)
    assert [int(b.term.shape[0]) for b in sh.parts] == [8] * 4
    assert mesh.shard(sh) is sh
    assert_fields_equal(st, _joined(mesh, sh), "join(shard(x))")
    internal = PK.state_to_internal(p)
    shi = mesh.shard(internal, internal=True)
    assert tuple(shi.parts[0].peer_id.shape) == (STEP_P, 8)
    assert_fields_equal(convert.to_numpy(internal), _joined(mesh, shi),
                        "internal join(shard(x))")
    with pytest.raises(ValueError, match="divide"):
        _cpu_mesh(5).shard(p)
    monkeypatch.delenv("DRAGONBOAT_TPU_MESH_DEVICES", raising=False)
    assert PP.groups_mesh() is None
    assert PP.groups_mesh(1) is None
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="visible"):
            PP.groups_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            PP.GroupsMesh(["cuda:0"] * 2)
