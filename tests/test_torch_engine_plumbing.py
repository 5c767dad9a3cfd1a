"""The engine's launch plumbing: port vs the reference JAX programs.

``_summarize_flags``, ``_gather_detail`` / ``_gather_vals`` /
``_gather_detail_vals`` (with ``_split_detail``), ``_scatter_rows``,
``_select_rows``, ``_gather_rows`` and ``_set_remote_snapshot`` run on
the same seeded int32 states, outputs and index sets — padded index
sets repeat their last row, as the engine pads them — through the JAX
program of ``dragonboat_tpu.ops.engine`` and through the port's
function on CPU tensors (the plain versions of the CUDA kernels).
Every result must be bit-equal.  Tolerance: zero.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu.ops import engine as JE
from dragonboat_tpu.ops import types as JT
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import engine as PE
from dragonboat_tpu_torch.ops import types as PT

G, P, W, M, E, O = 64, 5, 16, 6, 3, 8
SEEDS = range(4)


def rand_state(rng) -> dict:
    """A seeded state whose fields hit every flag-word branch."""
    st = JT.make_state_np(G, P, W)
    out = {}
    for k, v in st.items():
        out[k] = rng.integers(0, 6, v.shape).astype(np.int32)
    out["role"] = rng.integers(0, 6, G).astype(np.int32)
    out["self_slot"] = rng.integers(0, P, G).astype(np.int32)
    out["peer_id"] = np.where(rng.random((G, P)) < 0.7,
                              rng.integers(1, 6, (G, P)), 0).astype(np.int32)
    out["peer_kind"] = rng.integers(0, 3, (G, P)).astype(np.int32)
    out["active"] = rng.integers(0, 2, (G, P)).astype(np.int32)
    out["check_quorum"] = rng.integers(0, 2, G).astype(np.int32)
    out["last_index"] = rng.integers(0, 9, G).astype(np.int32)
    out["match"] = rng.integers(0, 9, (G, P)).astype(np.int32)
    out["ring_term"] = rng.integers(0, 50, (G, W)).astype(np.int32)
    # a few healthy CheckQuorum leaders of 3 voters (F_QUORUM_ACTIVE)
    q = slice(0, 4)
    out["role"][q] = PT.ROLE_LEADER
    out["check_quorum"][q] = 1
    out["self_slot"][q] = 0
    out["peer_id"][q] = [1, 2, 3, 0, 0]
    out["peer_kind"][q] = PT.KIND_VOTER
    out["active"][q] = 1
    return out


def perturb(rng, st: dict) -> dict:
    new = {k: v.copy() for k, v in st.items()}
    for k in ("term", "vote", "committed", "leader_id", "role", "last_index"):
        flip = rng.random(G) < 0.2
        new[k][flip] += 1
    return new


def rand_out(rng) -> dict:
    return dict(
        buf=rng.integers(-3, 40, (G, O, PT.N_FIELDS)).astype(np.int32),
        count=np.where(rng.random(G) < 0.5, 0, rng.integers(1, O + 1, G))
        .astype(np.int32),
        escalate=np.where(rng.random(G) < 0.2, rng.integers(1, 16, G), 0)
        .astype(np.int32),
        need_snapshot=(rng.random((G, P)) < 0.1).astype(np.int32),
        slot_base=rng.integers(-3, 30, (G, M)).astype(np.int32),
        slot_term=rng.integers(0, 9, (G, M)).astype(np.int32),
        ent_drop=rng.integers(0, 2, (G, M, E)).astype(np.int32),
        append_lo=np.where(rng.random(G) < 0.5, PT.APPEND_LO_NONE,
                           rng.integers(0, 30, G)).astype(np.int32),
        barrier_idx=rng.integers(-1, 20, G).astype(np.int32),
        barrier_term=rng.integers(0, 9, G).astype(np.int32),
    )


def jax_nt(cls, d):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def port_state(d):
    return convert.state_from_numpy(d, "cpu")


def port_out(d):
    return convert.out_from_numpy(d, "cpu")


def np_of(nt) -> dict:
    return {k: np.asarray(getattr(nt, k)) for k in nt._fields}


def rows(rng, n) -> list:
    return sorted(rng.choice(G, size=n, replace=False).tolist())


def assert_fields_equal(want, got):
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.int32, k


@pytest.mark.parametrize("seed", SEEDS)
def test_summarize_flags(seed):
    rng = np.random.default_rng(seed)
    old, out = rand_state(rng), rand_out(rng)
    new = perturb(rng, old)
    want = np.asarray(JE._summarize_flags(
        jax_nt(JT.DeviceState, old), jax_nt(JT.DeviceState, new),
        jax_nt(JT.DeviceOut, out),
    ))
    got = PE._summarize_flags(port_state(old), port_state(new), port_out(out))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    # every bit shows up somewhere in the seeded batch
    assert np.bitwise_or.reduce(want) == 127


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_detail_vals_and_split(seed):
    rng = np.random.default_rng(100 + seed)
    st, out = rand_state(rng), rand_out(rng)
    jst, jout = jax_nt(JT.DeviceState, st), jax_nt(JT.DeviceOut, out)
    pst, pout = port_state(st), port_out(out)
    buf_rows, slot_rows = rows(rng, 5), rows(rng, 3)
    need_rows, append_rows = rows(rng, 1), rows(rng, 7)
    idx4 = JE._build_idx4(buf_rows, slot_rows, need_rows, append_rows)
    assert idx4.shape == (4, 8)  # padded by repeating the last row
    sum_rows = rows(rng, 11)
    isum = JE._pad_idx(sum_rows, 16)
    K = JE._detail_width(O, M, E, P, W)
    assert PE._detail_width(O, M, E, P, W) == K

    want = np.asarray(JE._gather_detail(jst, jout, jnp.asarray(idx4)))
    got = PE._gather_detail(pst, pout, torch.from_numpy(idx4)).numpy()
    np.testing.assert_array_equal(got, want)
    for a, b in zip(JE._split_detail(want, O, M, E, P, W),
                    PE._split_detail(got, O, M, E, P, W)):
        np.testing.assert_array_equal(b, a)

    want = np.asarray(JE._gather_vals(jst, jout, jnp.asarray(isum)))
    got = PE._gather_vals(pst, pout, torch.from_numpy(isum)).numpy()
    np.testing.assert_array_equal(got, want)

    want = np.asarray(JE._gather_detail_vals(
        jst, jout, jnp.asarray(idx4), jnp.asarray(isum)
    ))
    got = PE._gather_detail_vals(
        pst, pout, torch.from_numpy(idx4), torch.from_numpy(isum)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8 * K + 16 * PT.N_VALS,)

    # the engine's own fetch helper (fused and separate paths)
    def put_j(a):
        return jnp.asarray(a)

    def put_p(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    for fused in (True, False):
        wd, wv = JE._fetch_detail_vals(jst, jout, idx4, sum_rows, put_j,
                                       O, M, E, P, W, allow_fused=fused)
        gd, gv = PE._fetch_detail_vals(pst, pout, idx4, sum_rows, put_p,
                                       O, M, E, P, W, allow_fused=fused)
        np.testing.assert_array_equal(gv, wv)
        for a, b in zip(wd, gd):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("seed", SEEDS)
def test_scatter_select_gather_rows(seed):
    rng = np.random.default_rng(200 + seed)
    st = rand_state(rng)
    jst, pst = jax_nt(JT.DeviceState, st), port_state(st)
    # scatter: a padded sub-batch (last row repeated) placed by pos map
    gs = rows(rng, 5)
    sub = rand_state(rng)
    sub = {k: v[:8] for k, v in sub.items()}
    pos = JE._pos_map(G, gs)
    want = JE._scatter_rows(jst, jnp.asarray(pos), jax_nt(JT.DeviceState, sub))
    got = PE._scatter_rows(pst, torch.from_numpy(pos), port_state(sub))
    assert_fields_equal(np_of(want), convert.to_numpy(got))
    # select: keep the new row except where escalated
    new = perturb(rng, st)
    keep = rng.random(G) < 0.7
    want = JE._select_rows(jnp.asarray(keep), jst, jax_nt(JT.DeviceState, new))
    got = PE._select_rows(keep, pst, port_state(new))
    assert_fields_equal(np_of(want), convert.to_numpy(got))
    # gather: padded index set with duplicates
    idx = JE._pad_idx(rows(rng, 6))
    want = JE._gather_rows(jst, jnp.asarray(idx))
    got = PE._gather_rows(pst, torch.from_numpy(idx))
    assert_fields_equal(np_of(want), convert.to_numpy(got))


@pytest.mark.parametrize("seed", SEEDS)
def test_set_remote_snapshot(seed):
    rng = np.random.default_rng(300 + seed)
    st = rand_state(rng)
    lanes = [(int(g), int(rng.integers(0, P)), int(rng.integers(1, 99)))
             for g in rows(rng, 3)]
    gi = JE._pad_idx([t[0] for t in lanes])
    pi = JE._pad_idx([t[1] for t in lanes])
    si = JE._pad_idx([t[2] for t in lanes])
    want = JE._set_remote_snapshot(
        jax_nt(JT.DeviceState, st), jnp.asarray(gi), jnp.asarray(pi),
        jnp.asarray(si),
    )
    got = PE._set_remote_snapshot(
        port_state(st), torch.from_numpy(gi), torch.from_numpy(pi),
        torch.from_numpy(si),
    )
    assert_fields_equal(np_of(want), convert.to_numpy(got))


def test_unsupported_device_raises():
    """A wrapper runs its kernel for CUDA tensors and its plain version
    for CPU tensors only; anything else is refused, never rerouted."""
    from dragonboat_tpu_torch.ops import kernel as PK
    from dragonboat_tpu_torch.ops import plumbing

    st = PT.make_state(4, P, W, device="meta")
    ib = PT.make_inbox(4, M, E, device="meta")
    out = PT.make_out(4, P, M, E, O, device="meta")
    with pytest.raises(ValueError):
        PK.step(st, ib, O)
    with pytest.raises(ValueError):
        plumbing.summarize_flags(st, st, out)
    with pytest.raises(ValueError):
        plumbing.place_rows(None, list(st), st.term)
    with pytest.raises(ValueError):
        plumbing.gather_pack(st, out, None, st.term)


@pytest.mark.parametrize("with_dst", [True, False])
def test_place_rows_from_an_empty_source_raises(with_dst):
    """Placing rows from a sub-batch with no rows: the reference's
    gather refuses to trace, and the port raises too (the CUDA wrapper
    makes the same check before it allocates or launches)."""
    rng = np.random.default_rng(400)
    st = rand_state(rng)
    empty = {k: v[:0] for k, v in st.items()}
    pos = np.full((G,), -1, np.int32)
    pos[3] = 0
    with pytest.raises(TypeError):
        JE._scatter_rows(jax_nt(JT.DeviceState, st), jnp.asarray(pos),
                         jax_nt(JT.DeviceState, empty))
    from dragonboat_tpu_torch.ops import plumbing

    dst = list(port_state(st)) if with_dst else None
    with pytest.raises(ValueError, match="no rows"):
        plumbing.place_rows(dst, list(port_state(empty)),
                            torch.from_numpy(pos))
    # no rows to place: nothing to read, an empty result
    got = plumbing.place_rows(None, list(port_state(empty)),
                              torch.empty((0,), dtype=torch.int32))
    assert all(t.shape[0] == 0 for t in got)
