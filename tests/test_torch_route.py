"""The port's device router against the reference JAX router.

* ``build_route_tables`` (host numpy, carried) gives the reference's
  tables on the ``test_route.py`` layouts and on seeded fuzz layouts
  with repeated peer ids and replicas missing from their peers' tables.
* ``route`` (the port's plain PyTorch version, CPU tensors) equals
  ``dragonboat_tpu.ops.route.route`` on every Inbox field, the six stats
  and the delivered mask: on the states and outboxes of the
  ``test_route.py`` RoutedSim clusters, and on seeded fuzz that covers
  suppress, dest_alive, budget overflow, ring-stale REPLICATE, the
  below-ring marker, forwarded PROPOSE, self-addressed READ_INDEX_RESP
  and a repeated peer id.
* ``routed_round`` and ``fused_rounds(rounds=3)`` equal the reference on
  those clusters, and the port's ``fused_rounds(K)`` equals K
  ``routed_round`` calls.

Inputs are int32 numpy arrays handed to both packages; tolerance: zero
(bit-exact).  JAX runs on its CPU backend.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_route as TR
from dragonboat_tpu.ops import route as JR
from dragonboat_tpu.ops import sync as JS
from dragonboat_tpu.ops import types as JT
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import route as PRoute
from dragonboat_tpu_torch.ops import types as PT

P, W, M, E, O = TR.P, TR.W, TR.M, TR.E, TR.O
BUDGET, BASE = TR.BUDGET, TR.BASE
SEED = 20261017


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: faster here,
    and it leaves the other cores to the suite's parallel workers."""
    n = convert.torch.get_num_threads()
    convert.torch.set_num_threads(1)
    yield
    convert.torch.set_num_threads(n)


def _np(nt) -> dict:
    return {k: np.asarray(getattr(nt, k)) for k in nt._fields}


def assert_fields_equal(want: dict, got: dict, what: str) -> None:
    assert set(want) == set(got), what
    for k in want:
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        assert np.array_equal(g, w), f"{what}: field {k} differs"


# --------------------------------------------------------------------------
# build_route_tables
# --------------------------------------------------------------------------
def _fuzz_layout(rng, shards: int, P_: int):
    shard_ids, replica_ids, peers = [], [], []
    for s in range(1, shards + 1):
        n = int(rng.integers(1, P_ + 1))
        members = list(range(1, n + 1))
        for rid in members:
            if rng.random() < 0.15:
                continue  # a replica hosted elsewhere
            row = np.zeros((P_,), np.int32)
            ids = list(members)
            if rng.random() < 0.2 and len(ids) > 1:
                ids.remove(int(rng.choice([i for i in ids if i != rid])))
            if rng.random() < 0.2 and len(ids) < P_:
                ids.append(int(rng.choice(ids)))  # a repeated peer id
            rng.shuffle(ids)
            row[:len(ids)] = ids
            shard_ids.append(s)
            replica_ids.append(rid)
            peers.append(row)
    return (np.array(shard_ids, np.int32), np.array(replica_ids, np.int32),
            np.stack(peers).astype(np.int32))


@pytest.mark.parametrize("layout", ["uniform", "off_device", "fuzz0", "fuzz1"])
def test_build_route_tables_matches_reference(layout):
    if layout == "uniform":
        shard_ids = np.repeat(np.arange(1, 5), 3).astype(np.int32)
        replica_ids = np.tile(np.arange(1, 4), 4).astype(np.int32)
        peer_ids = np.broadcast_to(
            np.arange(1, 4, dtype=np.int32), (12, 3)
        ).copy()
    elif layout == "off_device":
        shard_ids = np.array([7, 7], np.int32)
        replica_ids = np.array([1, 2], np.int32)
        peer_ids = np.zeros((2, P), np.int32)
        peer_ids[:, :3] = [1, 2, 3]
    else:
        rng = np.random.default_rng(SEED + int(layout[-1]))
        shard_ids, replica_ids, peer_ids = _fuzz_layout(rng, 12, P)
    want = JR.build_route_tables(shard_ids, replica_ids, peer_ids)
    got = PRoute.build_route_tables(shard_ids, replica_ids, peer_ids)
    for w, g in zip(want, got):
        assert g.dtype == np.int32 and np.array_equal(g, w)


# --------------------------------------------------------------------------
# route: the reference (jitted) and the port side by side
# --------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("M_", "E_", "B_", "base"))
def _jax_route(state, out, dest, rank, base_inbox, suppress, dest_alive, *,
               M_, E_, B_, base):
    inbox, stats, delivered = JR.route(
        state, out, dest, rank, M=M_, E=E_, budget=B_, base=base,
        base_inbox=base_inbox, suppress=suppress, dest_alive=dest_alive,
    )
    return inbox, jnp.stack(list(stats)), delivered


def check_route(st_np, out_np, dest, rank, *, M_, E_, B_, base,
                base_inbox_np=None, suppress=None, dest_alive=None,
                what=""):
    """Run both routers on the same arrays; require bit equality."""
    jst = JT.DeviceState(**{k: jnp.asarray(v) for k, v in st_np.items()})
    jout = JT.DeviceOut(**{k: jnp.asarray(v) for k, v in out_np.items()})
    jbase = (None if base_inbox_np is None else
             JT.Inbox(**{k: jnp.asarray(v) for k, v in base_inbox_np.items()}))
    j_inbox, j_stats, j_deliv = _jax_route(
        jst, jout, jnp.asarray(dest), jnp.asarray(rank), jbase,
        None if suppress is None else jnp.asarray(suppress),
        None if dest_alive is None else jnp.asarray(dest_alive),
        M_=M_, E_=E_, B_=B_, base=base,
    )
    p_inbox, p_stats, p_deliv = PRoute.route(
        convert.state_from_numpy(st_np, "cpu"),
        convert.out_from_numpy(out_np, "cpu"),
        convert.torch.from_numpy(np.ascontiguousarray(dest, np.int32)),
        convert.torch.from_numpy(np.ascontiguousarray(rank, np.int32)),
        M=M_, E=E_, budget=B_, base=base,
        base_inbox=(None if base_inbox_np is None
                    else convert.inbox_from_numpy(base_inbox_np, "cpu")),
        suppress=(None if suppress is None
                  else convert.torch.from_numpy(suppress)),
        dest_alive=(None if dest_alive is None
                    else convert.torch.from_numpy(dest_alive)),
    )
    assert_fields_equal(_np(j_inbox), convert.to_numpy(p_inbox),
                        f"route inbox {what}")
    got_stats = np.array([int(s) for s in p_stats], np.int32)
    assert np.array_equal(got_stats, np.asarray(j_stats)), (
        what, got_stats, np.asarray(j_stats))
    assert p_deliv.dtype == PT.torch.bool
    assert np.array_equal(p_deliv.numpy(), np.asarray(j_deliv)), what
    return got_stats


def _fuzz_route_inputs(rng, G_shards: int, P_: int, W_: int, E_: int,
                       O_: int):
    """A seeded layout plus post-step-like states and outboxes that hit
    every routing case: repeated peer ids, self-addressed and unknown
    destinations, forwarded PROPOSE, ring-stale and below-ring
    REPLICATE, and more messages per peer than any budget."""
    shard_ids, replica_ids, peer_ids = _fuzz_layout(rng, G_shards, P_)
    G = len(shard_ids)
    dest, rank = JR.build_route_tables(shard_ids, replica_ids, peer_ids)
    # cut a few routes and point a few at the sender itself
    cut = rng.random(dest.shape) < 0.1
    dest = np.where(cut, -1, dest).astype(np.int32)
    selfp = (rng.random(dest.shape) < 0.05) & (peer_ids != 0)
    dest = np.where(selfp, np.arange(G)[:, None], dest).astype(np.int32)
    st = JT.make_state_np(G, P_, W_, shard_ids=shard_ids,
                          replica_ids=replica_ids, peer_ids=peer_ids)
    last = rng.integers(0, 200, G).astype(np.int32)
    first = np.maximum(1, last - rng.integers(0, 3 * W_, G)).astype(np.int32)
    st["last_index"] = last
    st["first_index"] = first
    st["role"] = rng.integers(0, 4, G).astype(np.int32)
    st["ring_term"] = rng.integers(1, 9, (G, W_)).astype(np.int32)
    st["ring_cc"] = rng.integers(0, 2, (G, W_)).astype(np.int32)
    out = {k: np.asarray(v) for k, v in
           JT.make_out(G, P_, M, E_, O_)._asdict().items()}
    buf = np.zeros((G, O_, JT.N_FIELDS), np.int32)
    types = np.array([
        JT.MT_REPLICATE, JT.MT_REPLICATE, JT.MT_REPLICATE_RESP,
        JT.MT_HEARTBEAT, JT.MT_HEARTBEAT_RESP, JT.MT_REQUEST_VOTE,
        JT.MT_REQUEST_VOTE_RESP, JT.MT_PROPOSE, JT.MT_READ_INDEX_RESP,
        JT.MT_REQUEST_PREVOTE,
    ], np.int32)
    for g in range(G):
        ids = [int(x) for x in peer_ids[g] if x]
        for o in range(O_):
            mt = int(rng.choice(types))
            r = rng.random()
            if mt == JT.MT_READ_INDEX_RESP and r < 0.5:
                to = int(replica_ids[g])  # self-addressed coordination
            elif r < 0.85 and ids:
                to = int(rng.choice(ids))
            elif r < 0.93:
                to = 0
            else:
                to = 9  # nobody's id
            n = int(rng.integers(0, E_ + 1)) if mt in (
                JT.MT_REPLICATE, JT.MT_PROPOSE) else 0
            li = int(rng.integers(-3, 205))
            if mt == JT.MT_REPLICATE and rng.random() < 0.3:
                # straddle the ring window's lower edge
                lo = max(int(first[g]), int(last[g]) - (W_ - 1))
                li = lo - 1 + int(rng.integers(-2, 2))
            lt = 0 if rng.random() < 0.2 else int(rng.integers(1, 9))
            buf[g, o] = [mt, to, int(rng.integers(1, 9)), lt, li,
                         int(rng.integers(0, 200)), int(rng.integers(0, 2)),
                         int(rng.integers(0, 99)), int(rng.integers(0, 3)), n,
                         int(rng.integers(0, M))]
    out["buf"] = buf
    out["count"] = rng.integers(0, O_ + 1, G).astype(np.int32)
    return st, out, dest, rank.astype(np.int32), G


@pytest.mark.parametrize("seed", range(4))
def test_route_fuzz_matches_reference(seed):
    rng = np.random.default_rng(SEED + 100 + seed)
    Wf, Ef, Of = 8, 3, 12
    st, out, dest, rank, G = _fuzz_route_inputs(rng, 10, P, Wf, Ef, Of)
    hit = np.zeros((6,), np.int64)
    for B_, base in ((1, 0), (2, 2), (3, 1)):
        M_ = base + P * B_
        base_inbox = {
            k: rng.integers(-5, 50, (G, M_ + 1) + ((Ef,) if k.startswith(
                "ent_") else ())).astype(np.int32)
            for k in JT.Inbox._fields
        }
        suppress = rng.random(G) < 0.2
        alive = rng.random(G) < 0.8
        for kw in (
            {},
            {"suppress": suppress},
            {"dest_alive": alive},
            {"suppress": suppress, "dest_alive": alive,
             "base_inbox_np": base_inbox},
        ):
            hit += check_route(st, out, dest, rank, M_=M_, E_=Ef, B_=B_,
                               base=base, what=f"B={B_} {sorted(kw)}", **kw)
    # the fuzz must exercise every counted outcome
    assert (hit > 0).all(), hit


# --------------------------------------------------------------------------
# routed_round / fused_rounds on the RoutedSim clusters
# --------------------------------------------------------------------------
_jax_round = jax.jit(
    JR.routed_round,
    static_argnames=("out_capacity", "budget", "base", "propose_leaders",
                     "propose_n"),
)
_jax_fused = jax.jit(
    JR.fused_rounds,
    static_argnames=("rounds", "out_capacity", "budget", "base",
                     "propose_leaders", "propose_n"),
)


def _port(st_np, ib_np):
    return (convert.state_from_numpy(st_np, "cpu"),
            convert.inbox_from_numpy(ib_np, "cpu"))


def _t(a):
    return convert.torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _cluster(groups):
    rafts, _rows = TR.make_cluster_rafts(groups)
    st = JS.state_from_rafts(rafts, P, W)
    dest, rank = TR.tables_for(rafts)
    inbox = JR.make_prefill(st, M, E)
    return st, inbox, np.asarray(dest), np.asarray(rank)


def test_routed_round_matches_reference_on_routed_cluster():
    """Elections then proposals on the test_route.py cluster: every
    round, the port's routed_round (and, on that round's post-step
    state and outbox, its route with suppress / dest_alive) equals the
    reference's, field for field."""
    st, inbox, dest, rank = _cluster({1: [1, 2, 3], 2: [1, 2, 3],
                                      3: [1, 2, 3, 4, 5]})
    G = len(dest)
    rng = np.random.default_rng(SEED + 7)
    delivered_total = 0
    for rnd in range(36):
        propose = rnd >= 24
        st_np, ib_np = _np(st), _np(inbox)
        j_st, j_ib, j_stats, j_esc = _jax_round(
            st, inbox, jnp.asarray(dest), jnp.asarray(rank),
            out_capacity=O, budget=BUDGET, base=BASE,
            propose_leaders=propose,
        )
        p_st, p_ib, p_stats, p_esc = PRoute.routed_round(
            *_port(st_np, ib_np), _t(dest), _t(rank),
            out_capacity=O, budget=BUDGET, base=BASE,
            propose_leaders=propose,
        )
        assert_fields_equal(_np(j_st), convert.to_numpy(p_st),
                            f"state round {rnd}")
        assert_fields_equal(_np(j_ib), convert.to_numpy(p_ib),
                            f"inbox round {rnd}")
        assert [int(x) for x in p_stats] == [int(x) for x in j_stats]
        assert int(p_esc) == int(j_esc)
        delivered_total += int(p_stats.delivered)
        if rnd % 6 == 5:
            # the router alone on this round's post-step state/outbox
            from dragonboat_tpu.ops import kernel as JK

            new, out = JK.step(st, inbox, out_capacity=O)
            check_route(
                _np(new), _np(out), dest, rank, M_=M, E_=E, B_=BUDGET,
                base=BASE, base_inbox_np=_np(inbox),
                suppress=rng.random(G) < 0.3,
                dest_alive=rng.random(G) < 0.7, what=f"round {rnd}",
            )
        st, inbox = j_st, j_ib
    assert delivered_total > 0
    assert int((np.asarray(st.role) == JT.ROLE_LEADER).sum()) == 3


def test_merge_and_route_in_place_matches_reference_with_escalated_rows():
    """merge_and_route on the port consumes new_state: the escalated rows
    are merged into it in place (engine_ref.merge_escalated) and state'
    is that tree.  On every round of the routed cluster, with a seeded
    fifth of the rows marked escalated in the outbox both packages get,
    state', inbox', the stats and the escalated count equal the
    reference's ``route.merge_and_route`` (tolerance: zero), and the
    plain in-place merge equals the reference's select."""
    from dragonboat_tpu.ops import kernel as JK

    st, inbox, dest, rank = _cluster({1: [1, 2, 3], 2: [1, 2, 3],
                                      3: [1, 2, 3, 4, 5]})
    G = len(dest)
    rng = np.random.default_rng(SEED + 11)
    n_esc = 0
    for rnd in range(24):
        new, out = JK.step(st, inbox, out_capacity=O)
        out_np = _np(out)
        esc = np.where(rng.random(G) < 0.2, rng.integers(1, 16, G), 0)
        out_np["escalate"] = esc.astype(np.int32)
        n_esc += int((esc != 0).sum())
        out_j = JT.DeviceOut(**{k: jnp.asarray(v) for k, v in out_np.items()})
        propose = rnd >= 12
        j_st, j_ib, j_stats, j_esc = JR.merge_and_route(
            st, new, out_j, jnp.asarray(dest), jnp.asarray(rank), M=M, E=E,
            budget=BUDGET, base=BASE, propose_leaders=propose)
        p_old = convert.state_from_numpy(_np(st), "cpu")
        p_new = convert.state_from_numpy(_np(new), "cpu")
        p_out = convert.out_from_numpy(out_np, "cpu")
        p_st, p_ib, p_stats, p_esc = PRoute.merge_and_route(
            p_old, p_new, p_out, _t(dest), _t(rank), M=M, E=E,
            budget=BUDGET, base=BASE, propose_leaders=propose)
        assert all(a is b for a, b in zip(p_st, p_new))  # merged in place
        assert_fields_equal(_np(j_st), convert.to_numpy(p_st),
                            f"state round {rnd}")
        assert_fields_equal(_np(j_ib), convert.to_numpy(p_ib),
                            f"inbox round {rnd}")
        assert [int(x) for x in p_stats] == [int(x) for x in j_stats]
        assert int(p_esc) == int(j_esc)
        st, inbox = j_st, j_ib
    assert n_esc > 0


def test_fused_rounds_matches_reference_and_serial_rounds():
    """fused_rounds(3) equals the reference's, and equals three of the
    port's own routed_round calls, on a drop-forcing budget=1 layout."""
    st, inbox, dest, rank = _cluster({1: [1, 2, 3], 2: [1, 2, 3, 4, 5]})
    m_small = BASE + P * 1
    inbox = JR.make_prefill(st, m_small, E)
    for wave in range(8):
        st_np, ib_np = _np(st), _np(inbox)
        j_st, j_ib, j_stats, j_esc = _jax_fused(
            st, inbox, jnp.asarray(dest), jnp.asarray(rank), rounds=3,
            out_capacity=O, budget=1, base=BASE, propose_leaders=True,
        )
        p_st, p_ib, p_stats, p_esc = PRoute.fused_rounds(
            *_port(st_np, ib_np), _t(dest), _t(rank), rounds=3,
            out_capacity=O, budget=1, base=BASE, propose_leaders=True,
        )
        assert_fields_equal(_np(j_st), convert.to_numpy(p_st),
                            f"fused state wave {wave}")
        assert_fields_equal(_np(j_ib), convert.to_numpy(p_ib),
                            f"fused inbox wave {wave}")
        assert np.array_equal(p_stats.numpy(), np.asarray(j_stats))
        assert np.array_equal(p_esc.numpy(), np.asarray(j_esc))
        # the port's fused wave is its own serial rounds
        s_st, s_ib = _port(st_np, ib_np)
        rows = []
        for _ in range(3):
            s_st, s_ib, s_stats, _e = PRoute.routed_round(
                s_st, s_ib, _t(dest), _t(rank), out_capacity=O, budget=1,
                base=BASE, propose_leaders=True,
            )
            rows.append([int(x) for x in s_stats])
        assert_fields_equal(convert.to_numpy(p_st), convert.to_numpy(s_st),
                            "fused vs serial state")
        assert_fields_equal(convert.to_numpy(p_ib), convert.to_numpy(s_ib),
                            "fused vs serial inbox")
        assert p_stats.tolist() == rows
        st, inbox = j_st, j_ib
    assert int(np.asarray(st.committed).max()) > 0


def test_route_refuses_a_bad_layout():
    st, inbox, dest, rank = _cluster({1: [1, 2, 3]})
    from dragonboat_tpu.ops import kernel as JK

    new, out = JK.step(st, inbox, out_capacity=O)
    with pytest.raises(ValueError, match="inbox layout"):
        PRoute.route(convert.state_from_numpy(_np(new), "cpu"),
                 convert.out_from_numpy(_np(out), "cpu"), _t(dest), _t(rank),
                 M=M + 1, E=E, budget=BUDGET, base=BASE)
