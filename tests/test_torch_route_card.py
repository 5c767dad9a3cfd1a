"""The routed round's step on the card: ``kernel.step_routed``.

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


def c4_rows(groups: int):
    """Groups of 3, 5 and 7 replicas in turn, each group's rows side by
    side, pre-vote and check-quorum on: (state, inbox, dest_row,
    rank_in_dest) as numpy."""
    sizes = np.resize(np.asarray(SIZES, np.int32), groups)
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
