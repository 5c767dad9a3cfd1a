"""The port's raft step against the reference JAX step and the oracle.

Every scenario of ``test_kernel_parity.py`` (fuzz seeds included) and
the four of ``test_raft_protocol3.py``'s ``TestKernelFlowParity`` run
on ``kernel_harness.Cluster`` with the harness's device step replaced by
a dual step: at each harness step the same int32 state and inbox go
through ``dragonboat_tpu.ops.kernel.step`` (JAX, CPU backend) and
through the port's ``step`` on CPU tensors (its plain PyTorch version),
and every ``DeviceState`` and ``DeviceOut`` field must be bit-equal.
The harness then compares the PORT's result with the scalar oracle
(state bit-exact, messages as multisets).  Tolerance: zero.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

import kernel_harness
import test_kernel_parity as TKP
import test_raft_protocol3 as TRP3
from dragonboat_tpu.ops import kernel as JK
from dragonboat_tpu.ops import sync as JS
from dragonboat_tpu.ops import types as JT
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import kernel as PK
from dragonboat_tpu_torch.ops import kernel_ref as PR
from dragonboat_tpu_torch.ops import types as PT

_SCENARIOS = [
    "test_single_voter_becomes_leader_and_commits",
    "test_three_replica_election_and_heartbeats",
    "test_replication_and_commit_three_replicas",
    "test_follower_forwards_proposal",
    "test_five_replicas_with_churn",
    "test_prevote_and_check_quorum_cluster",
    "test_many_groups_mixed_sizes",
    "test_witness_and_nonvoting_members",
    "test_leader_transfer_timeout_now",
    "test_partition_and_rejoin_log_repair",
    "test_read_index_hot_path_leader",
    "test_read_index_before_term_commit_is_dropped",
]


def _np_fields(nt) -> dict:
    return {k: np.asarray(getattr(nt, k)) for k in nt._fields}


def port_step_np(st_np: dict, ib_np: dict, out_capacity: int):
    """The port's step on CPU tensors, numpy in and out."""
    st = convert.state_from_numpy(st_np, "cpu")
    ib = convert.inbox_from_numpy(ib_np, "cpu")
    new, out = PK.step(st, ib, out_capacity)
    return convert.to_numpy(new), convert.to_numpy(out)


def assert_same(want: dict, got: dict, what: str):
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == np.int32, (what, k, got[k].dtype)
        np.testing.assert_array_equal(
            got[k], want[k], err_msg=f"{what} field {k!r} differs"
        )


class DualStep:
    """Stands in for the harness's kernel module: runs both steps,
    requires bit equality, and hands the PORT's result back."""

    def __init__(self):
        self.calls = 0

    def step(self, state, inbox, out_capacity):
        ref_st, ref_out = JK.step(state, inbox, out_capacity=out_capacity)
        st_np, out_np = port_step_np(
            _np_fields(state), _np_fields(inbox), out_capacity
        )
        assert_same(_np_fields(ref_st), st_np, "state")
        assert_same(_np_fields(ref_out), out_np, "out")
        self.calls += 1
        return (
            JT.DeviceState(**{k: jnp.asarray(v) for k, v in st_np.items()}),
            JT.DeviceOut(**{k: jnp.asarray(v) for k, v in out_np.items()}),
        )


@pytest.fixture
def dual(monkeypatch):
    d = DualStep()
    monkeypatch.setattr(kernel_harness, "K", d)
    return d


@pytest.mark.parametrize("name", _SCENARIOS)
def test_scenario_matches_reference_and_oracle(dual, name):
    getattr(TKP, name)()
    assert dual.calls > 0


@pytest.mark.parametrize("seed", range(6))
def test_randomized_fuzz_matches_reference_and_oracle(dual, seed):
    TKP.test_randomized_fuzz(seed)
    assert dual.calls > 0


# test_raft_protocol3.py's kernel-parity section (:429-500): the remote
# flow-state scenarios (probe pause and resume, duplicated and reordered
# acks, the unreachable hint, two groups in one batch)
_FLOW = sorted(n for n in vars(TRP3.TestKernelFlowParity)
               if n.startswith("test_"))


@pytest.mark.parametrize("name", _FLOW)
def test_flow_scenario_matches_reference_and_oracle(dual, name):
    getattr(TRP3.TestKernelFlowParity(), name)()
    assert dual.calls > 0


def test_flow_scenarios_are_the_four_of_the_reference():
    assert _FLOW == ["test_duplicate_and_reordered_acks_parity",
                     "test_mixed_groups_progress_independently",
                     "test_probe_pause_resume_parity",
                     "test_unreachable_hint_parity"]


class GappedDualStep(DualStep):
    """DualStep that also holds both steps equal on the same inbox with
    each row's messages spread over its slots, in their order (the
    stable compaction path; the packed inbox skips it).  The harness
    gets the packed inbox's result, whose slot numbers it reads."""

    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.default_rng(seed)
        self.gapped = 0

    def step(self, state, inbox, out_capacity):
        ib = _np_fields(inbox)
        occ = ib["mtype"] != 0
        spread = {k: np.zeros_like(v) for k, v in ib.items()}
        for g in range(occ.shape[0]):
            src = np.flatnonzero(occ[g])
            dst = np.sort(self.rng.choice(occ.shape[1], src.size,
                                          replace=False))
            self.gapped += int(np.any(dst != np.arange(src.size)))
            for k in ib:
                spread[k][g, dst] = ib[k][g, src]
        jib = JT.Inbox(**{k: jnp.asarray(v) for k, v in spread.items()})
        ref_st, ref_out = JK.step(state, jib, out_capacity=out_capacity)
        st_np, out_np = port_step_np(_np_fields(state), spread, out_capacity)
        assert_same(_np_fields(ref_st), st_np, "state (gapped inbox)")
        assert_same(_np_fields(ref_out), out_np, "out (gapped inbox)")
        return super().step(state, inbox, out_capacity)


@pytest.mark.parametrize("seed", range(2))
def test_gapped_inbox_matches_reference(monkeypatch, seed):
    d = GappedDualStep(seed)
    monkeypatch.setattr(kernel_harness, "K", d)
    TKP.test_randomized_fuzz(seed)
    assert d.calls > 0 and d.gapped > 0


def test_fused_multi_tick_slot():
    """Multi-tick fusion on the port, field-for-field against JAX."""
    G, P, W, M_, E_, O = 2, 3, 8, 2, 1, 16
    peer_ids = np.zeros((G, P), np.int32)
    peer_ids[0, 0] = 1
    peer_ids[1, :3] = [1, 2, 3]
    st = JT.make_state_np(
        G, P, W,
        shard_ids=np.arange(1, G + 1),
        replica_ids=np.ones(G),
        peer_ids=peer_ids,
        election_timeout=10,
        heartbeat_timeout=2,
    )
    zero = {k: np.zeros((G, M_), np.int32) for k in JS.INBOX_FIELDS}
    ib = dict(zero, ent_term=np.zeros((G, M_, E_), np.int32),
              ent_cc=np.zeros((G, M_, E_), np.int32))
    ib["mtype"][:, 0] = PT.MT_TICK
    ib["log_index"][:, 0] = 20

    def both(st_np, ib_np):
        jst = JT.DeviceState(**{k: jnp.asarray(v) for k, v in st_np.items()})
        jib = JT.Inbox(**{k: jnp.asarray(v) for k, v in ib_np.items()})
        rs, ro = JK.step(jst, jib, out_capacity=O)
        ps, po = port_step_np(st_np, ib_np, O)
        assert_same(_np_fields(rs), ps, "state")
        assert_same(_np_fields(ro), po, "out")
        return ps, po

    new, out = both(st, ib)
    assert new["role"][0] == PT.ROLE_LEADER
    assert out["count"][1] > 0
    st3 = dict(new)
    st3["role"] = new["role"].copy()
    st3["role"][1] = PT.ROLE_LEADER
    st3["leader_id"] = new["leader_id"].copy()
    st3["leader_id"][1] = 1
    st3["heartbeat_tick"] = np.zeros_like(new["heartbeat_tick"])
    st3["election_tick"] = np.zeros_like(new["election_tick"])
    ib2 = {k: v.copy() for k, v in ib.items()}
    ib2["log_index"][:, 0] = 6
    _, out3 = both(st3, ib2)
    buf3 = out3["buf"][1]
    hb = sorted(
        int(buf3[k][PT.F_TO]) for k in range(int(out3["count"][1]))
        if buf3[k][PT.F_MTYPE] == PT.MT_HEARTBEAT
    )
    assert hb == [2, 3]


def test_forced_gates_equal_masked_false(monkeypatch):
    """The handler no-op invariant on the port: forcing every handler
    gate open (each handler then also runs under an all-false mask) must
    be bit-identical to the gated step."""
    c = kernel_harness.Cluster({1: [1, 2, 3]}, pre_vote=True, check_quorum=True)
    O = kernel_harness.O

    def assert_parity(batches):
        ordered = [list(batches.get(k, ())) for k in c.rows]
        inbox, overflow = JS.encode_inbox(ordered, kernel_harness.M,
                                          kernel_harness.E)
        assert not overflow
        st_np, ib_np = _np_fields(c.state), _np_fields(inbox)
        base = port_step_np(st_np, ib_np, O)
        monkeypatch.setattr(PR, "_FORCE_GATES", True)
        try:
            forced = port_step_np(st_np, ib_np, O)
        finally:
            monkeypatch.setattr(PR, "_FORCE_GATES", False)
        assert_same(base[0], forced[0], "state (forced gates)")
        assert_same(base[1], forced[1], "out (forced gates)")

    for _ in range(12):
        b = c.deliver_batches(tick=True)
        assert_parity(b)
        c.step(b)
    lid = c.elect(1)
    key = (1, lid)
    b = c.deliver_batches(tick=False, extra={key: [c.propose(1, lid, [b"a"])]})
    assert_parity(b)
    c.step(b)
    for _ in range(4):
        b = c.deliver_batches(tick=False)
        assert_parity(b)
        c.step(b)
    follower = next(r for r in (1, 2, 3) if r != lid)
    from dragonboat_tpu.pb import Message, MessageType

    for m in (
        Message(type=MessageType.READ_INDEX, hint=7, hint_high=9),
        Message(type=MessageType.UNREACHABLE, from_=follower),
        Message(type=MessageType.SNAPSHOT_STATUS, from_=follower, reject=True),
    ):
        b = {key: [m]}
        assert_parity(b)
        c.step(b)
        b = c.deliver_batches(tick=False)
        if b:
            assert_parity(b)
            c.step(b)
    assert_parity({(1, follower): [Message(
        type=MessageType.TIMEOUT_NOW, from_=lid, to=follower,
        term=c.rafts[key].term,
    )]})
    assert_parity({})

