"""The port's graft entry (``dragonboat_tpu_torch/graft_entry.py``)
against the reference's ``__graft_entry__.py``.

* ``entry(device="cpu")``: the same 64 example rows, and the forward
  step bit-exact against the reference's ``entry()`` forward on JAX's
  CPU backend, every ``DeviceState`` and ``DeviceOut`` leaf;
* ``dryrun_multichip(2)`` and ``(4)`` on a CPU mesh meet the
  reference's postconditions (the engine stack, part 3, with a 60 ms
  tick: a CPU mesh launch takes 80-350 ms);
* part 2's final state and inbox are bit-exact against the reference's
  single-device ``route.routed_round`` over the same 64 rounds on the
  same global rows (the reference's own ``shard_map`` program passes
  ``check_rep``, which this jax refuses);
* without a card, a CUDA request raises.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu.ops import route as JR
from dragonboat_tpu.ops import types as JT
from dragonboat_tpu_torch import graft_entry as GE
from dragonboat_tpu_torch.ops import convert

import __graft_entry__ as REF

RTT_MS = 60


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(nt) -> dict:
    return {k: np.asarray(getattr(nt, k)) for k in nt._fields}


def assert_fields_equal(want: dict, got: dict, what: str) -> None:
    assert list(want) == list(got), what
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        assert np.array_equal(g, w), (
            f"{what}: field {k} differs at {np.argwhere(g != w)[:5].tolist()}")


def test_entry_forward_matches_reference():
    fn, (st, ib) = GE.entry(device="cpu")
    rfn, (rst, rib) = REF.entry()
    assert_fields_equal(_np(rst), convert.to_numpy(st), "example state")
    assert_fields_equal(_np(rib), convert.to_numpy(ib), "example inbox")
    new, out = fn(st, ib)
    rnew, rout = jax.jit(rfn)(rst, rib)
    assert_fields_equal(_np(rnew), convert.to_numpy(new), "state")
    assert_fields_equal(_np(rout), convert.to_numpy(out), "out")
    assert st.term.device.type == "cpu"


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py's graft phase")
    with pytest.raises(RuntimeError):
        GE.entry()
    with pytest.raises(RuntimeError):
        GE.dryrun_multichip(2)


@functools.lru_cache(maxsize=None)
def _dryrun(n: int):
    return GE.dryrun_multichip(n, device="cpu", rtt_ms=RTT_MS)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_meets_the_postconditions(n):
    res = _dryrun(n)
    st, out = res["step"]
    assert tuple(st.term.shape) == (8 * n,)
    rst, rib = res["routed"]
    assert tuple(rst.term.shape) == (GE.GROUPS_PER_DEV * n * GE.REPL,)
    stats = res["engine"]
    assert stats["routed_delivered"] > 0
    assert stats["divergence_halts"] == 0
    assert stats["launches"] > 0


_jax_round = jax.jit(
    JR.routed_round,
    static_argnames=("out_capacity", "budget", "base", "propose_leaders"))


@pytest.mark.parametrize("n", [2, 4])
def test_routed_part_matches_single_device_reference(n):
    """The reference's single-device round over the same 64 rounds on
    the same global rows: state and inbox bit-exact at the end."""
    sh, rp, pe = GE.routed_layout(n)
    st = JT.make_state(sh.shape[0], GE.P2, GE.W2, shard_ids=sh,
                       replica_ids=rp, peer_ids=pe, election_timeout=10,
                       heartbeat_timeout=2)
    ib = JR.make_prefill(st, GE.M2, GE.E2)
    dest, rank = JR.build_route_tables(sh, rp, pe)
    dest, rank = jnp.asarray(dest), jnp.asarray(rank)
    for _ in range(GE.ROUNDS):
        st, ib, _s, _n = _jax_round(
            st, ib, dest, rank, out_capacity=GE.O2, budget=GE.BUDGET,
            base=GE.BASE, propose_leaders=True)
    got_st, got_ib = _dryrun(n)["routed"]
    assert_fields_equal(_np(st), convert.to_numpy(got_st), "routed state")
    assert_fields_equal(_np(ib), convert.to_numpy(got_ib), "routed inbox")
