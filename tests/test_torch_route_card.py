"""The routed round's step and the route's receive on the card.

``routed_round`` (and so ``fused_rounds``) steps with the routed
instantiation of ``raft_step_kernel``, which writes of the step's outputs
only the messages below each row's count, ``count`` and ``escalate``.
At the ``c4-100k-ragged`` cell's geometry (groups of 3, 5 and 7 replicas
at P = 7, W 16, E 2, O 32, budget 8, M 58) on a few hundred groups whose
leaders propose every round, a three-round ``fused_rounds`` on the card
equals, state and inbox, three serial ``routed_round`` calls on the card
and the plain ``route_ref.fused_rounds`` on the CPU; it launches the
routed entry once a round and never the full one, and a colocated-engine
step on the same card launches the full entry and never the routed one.

The receive (``route_recv_kernel``) at both benchmark geometries (c4:
ragged 3/5/7 rows at P = 7, M 58, E 2, budget 8; ns: rows of 3 at P = 3,
W 32, M 14, E 4, budget 4; a few thousand rows, leaders proposing):
``route_cuda`` writes every word of an inbox that the caching allocator
hands back from a block filled with a poison word, equal with the stats
to the plain ``route_ref.route``, and ``fused_rounds`` equals three
``routed_round`` calls.

Needs a CUDA card (the ``card`` marker; skipped without one) and imports
no JAX, so it runs on the card's machine:

    python3 -m pytest tests/test_torch_route_card.py -m card

Tolerance: zero (bit-exact).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import plumbing
from dragonboat_tpu_torch.ops import registry
from dragonboat_tpu_torch.ops import route as PRoute
from dragonboat_tpu_torch.ops import route_ref
from dragonboat_tpu_torch.ops import types as PT

# the c4 cell's geometry
P, W, E, O, BUDGET, BASE = 7, 16, 2, 32, 8, 2
M = BASE + P * BUDGET
SIZES = (3, 5, 7)
GROUPS = 240
ROUNDS = 3


def c4_rows(groups: int, sizes=SIZES, P=P, W=W, M=M, E=E):
    """Groups of ``sizes`` replicas in turn (c4's 3, 5 and 7 by default),
    each group's rows side by side, pre-vote and check-quorum on: (state,
    inbox, dest_row, rank_in_dest) as numpy."""
    sizes = np.resize(np.asarray(sizes, np.int32), groups)
    shard = np.repeat(np.arange(1, groups + 1, dtype=np.int32), sizes)
    rid = np.concatenate([np.arange(1, n + 1, dtype=np.int32) for n in sizes])
    peers = np.zeros((shard.size, P), np.int32)
    for g, n in enumerate(np.repeat(sizes, sizes)):
        peers[g, :n] = np.arange(1, n + 1)
    st = PT.make_state_np(shard.size, P, W, shard_ids=shard, replica_ids=rid,
                          peer_ids=peers, election_timeout=10,
                          heartbeat_timeout=2, check_quorum=True,
                          pre_vote=True)
    ib = convert.to_numpy(PT.make_inbox(shard.size, M, E, device="cpu"))
    dest, rank = PRoute.build_route_tables(shard, rid, peers)
    return st, ib, dest, rank


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(tree, dev):
    return type(tree)(*(t.to(dev) for t in tree))


def _assert_equal(want, got, what):
    for f, a, b in zip(want._fields, want, got):
        assert torch.equal(a.cpu(), b.cpu()), f"{what}: field {f} differs"


@pytest.mark.card
def test_routed_round_on_the_card_matches_plain_and_serial_rounds(card):
    st_np, ib_np, dest_np, rank_np = c4_rows(GROUPS)
    kw = dict(out_capacity=O, budget=BUDGET, base=BASE, propose_leaders=True)
    dest = torch.from_numpy(dest_np).to(card)
    rank = torch.from_numpy(rank_np).to(card)
    st = convert.state_from_numpy(st_np, card)
    ib = convert.inbox_from_numpy(ib_np, card)
    # elections, then leaders proposing and committing
    for _ in range(20):
        st, ib, _stats, _n_esc = PRoute.fused_rounds(
            st, ib, dest, rank, rounds=ROUNDS, **kw)
    leaders = int((st.role == PT.ROLE_LEADER).sum())
    assert leaders == GROUPS, leaders
    start = (_on(st, "cpu"), _on(ib, "cpu"))
    committed0 = start[0].committed.clone()

    _native.reset_launch_counts()
    got_st, got_ib, got_stats, got_esc = PRoute.fused_rounds(
        st, ib, dest, rank, rounds=ROUNDS, **kw)
    torch.cuda.synchronize()
    assert _native.ENTRY_LAUNCHES == {
        "raft_step_routed": ROUNDS, "merge_escalated": ROUNDS,
        "route": ROUNDS}

    s_st, s_ib = _on(start[0], card), _on(start[1], card)
    for _ in range(ROUNDS):
        s_st, s_ib, _stats, _n_esc = PRoute.routed_round(
            s_st, s_ib, dest, rank, **kw)
    _assert_equal(s_st, got_st, "serial rounds' state")
    _assert_equal(s_ib, got_ib, "serial rounds' inbox")

    w_st, w_ib, w_stats, w_esc = route_ref.fused_rounds(
        *start, torch.from_numpy(dest_np), torch.from_numpy(rank_np),
        rounds=ROUNDS, **kw)
    _assert_equal(w_st, got_st, "plain state")
    _assert_equal(w_ib, got_ib, "plain inbox")
    assert torch.equal(w_stats, got_stats.cpu())
    assert torch.equal(w_esc, got_esc.cpu())
    # every leader's proposal of each round commits
    adv = got_st.committed.cpu() - committed0
    assert int(adv.min()) >= 1, adv


@pytest.mark.card
def test_colocated_step_launches_the_full_entry(card):
    ep = registry.entry("colocated._assemble_and_step")
    _native.reset_launch_counts()
    got = registry.run(ep, card, seed=1)
    torch.cuda.synchronize()
    assert _native.ENTRY_LAUNCHES.get("raft_step") == 1
    assert "raft_step_routed" not in _native.ENTRY_LAUNCHES
    want = registry.run(ep, "cpu", plain=True, seed=1)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())


# (sizes, P, W, E, O, budget, groups): the benchmark's two geometries
# (portbench/configs c4-100k-ragged and ns-100k-x3), base 2
GEOMETRIES = {"c4": ((3, 5, 7), 7, 16, 2, 32, 8, 1200),
              "ns": ((3,), 3, 32, 4, 16, 4, 2000)}
POISON = -0x5EED


@pytest.mark.card
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_receive_writes_every_inbox_word_at_the_bench_geometries(card,
                                                                 geometry):
    sizes, P_, W_, E_, O_, B_, groups = GEOMETRIES[geometry]
    M_ = BASE + P_ * B_
    st_np, ib_np, dest_np, rank_np = c4_rows(groups, sizes, P_, W_, M_, E_)
    kw = dict(out_capacity=O_, budget=B_, base=BASE, propose_leaders=True)
    dest = torch.from_numpy(dest_np).to(card)
    rank = torch.from_numpy(rank_np).to(card)
    st = convert.state_from_numpy(st_np, card)
    ib = convert.inbox_from_numpy(ib_np, card)
    for _ in range(60):
        st, ib, _stats, _n_esc = PRoute.fused_rounds(
            st, ib, dest, rank, rounds=ROUNDS, **kw)
        if int((st.role == PT.ROLE_LEADER).sum()) == groups:
            break
    assert int((st.role == PT.ROLE_LEADER).sum()) >= 0.95 * groups

    # one routed round's route, into a block the allocator last held poison
    new, out = K.step_routed(st, ib, out_capacity=O_)
    merged = PT.DeviceState(*plumbing.merge_escalated(
        out.escalate, list(st), list(new)))
    G = merged.term.shape[0]
    words = _native.view_plan(((G, M_),) * 10 + ((G, M_, E_),) * 2)[0]
    poison = torch.full((words,), POISON, dtype=torch.int32, device=card)
    at = poison.data_ptr()
    del poison
    got, got_stats, _ = PRoute.route_cuda(
        merged, out, dest, rank, M=M_, E=E_, budget=B_, base=BASE,
        suppress=out.escalate, prefill=(True, True, 1))
    torch.cuda.synchronize()
    assert got.mtype.data_ptr() == at, "the poisoned block was not reused"
    want, want_stats, _ = route_ref.route(
        merged, out, dest, rank, M=M_, E=E_, budget=B_, base=BASE,
        suppress=out.escalate != 0,
        base_inbox=route_ref.make_prefill(merged, M_, E_,
                                          propose_leaders=True))
    _assert_equal(want, got, f"{geometry} inbox")
    n_sup = (out.escalate != 0).sum(dtype=torch.int32).view(1)
    assert torch.equal(torch.cat([want_stats, n_sup]).cpu(), got_stats.cpu())
    assert int(got_stats[0]) > 0

    # the fused wave against three routed rounds
    f_st, f_ib, _s, _e = PRoute.fused_rounds(st, ib, dest, rank,
                                             rounds=ROUNDS, **kw)
    s_st, s_ib = st, ib
    for _ in range(ROUNDS):
        s_st, s_ib, _s, _e = PRoute.routed_round(s_st, s_ib, dest, rank,
                                                 **kw)
    _assert_equal(s_st, f_st, f"{geometry} serial rounds' state")
    _assert_equal(s_ib, f_ib, f"{geometry} serial rounds' inbox")
