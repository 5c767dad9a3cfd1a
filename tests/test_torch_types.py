"""The port's layouts and constants against the reference's.

* every public constant of ``dragonboat_tpu_torch.ops.types`` equals the
  reference's, and so does every ``constexpr int`` of the CUDA kernels'
  shared header (``csrc/common.cuh``);
* ``make_state_np`` returns identical arrays (constructor jitter
  included) for a seeded spread of shard and replica ids;
* ``state_from_numpy`` / ``inbox_from_numpy`` / ``out_from_numpy`` and
  ``to_numpy`` round-trip bit for bit.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dragonboat_tpu.ops import types as JT
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import types as PT

HEADER = (
    Path(__file__).resolve().parent.parent
    / "dragonboat_tpu_torch" / "csrc" / "common.cuh"
)


def _public_constants(mod) -> dict:
    return {
        k: getattr(mod, k)
        for k in dir(mod)
        if k.isupper() and isinstance(getattr(mod, k), (int, tuple))
    }


def test_constants_match_reference():
    want = _public_constants(JT)
    got = _public_constants(PT)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == v, k
    assert PT.I32 == torch.int32


def test_cuda_header_constants_match():
    text = HEADER.read_text()
    pairs = re.findall(r"constexpr int (\w+) = (-?\d+);", text)
    assert len(pairs) > 60
    for name, value in pairs:
        assert getattr(PT, name) == int(value), name


def test_layout_fields_match():
    assert PT.DeviceState._fields == JT.DeviceState._fields
    assert PT.Inbox._fields == JT.Inbox._fields
    assert PT.DeviceOut._fields == JT.DeviceOut._fields


@pytest.mark.parametrize("seed", range(5))
def test_make_state_np_identical(seed):
    rng = np.random.default_rng(seed)
    G, P, W = 37, 5, 16
    peers = np.zeros((G, P), np.int32)
    rid = rng.integers(1, 2**31 - 1, G)
    peers[:, 0] = rid
    peers[:, 1:3] = rng.integers(1, 1000, (G, 2))
    kinds = rng.integers(0, 3, (G, P))
    kw = dict(
        shard_ids=rng.integers(0, 2**31 - 1, G),
        replica_ids=rid,
        peer_ids=peers,
        peer_kinds=kinds,
        election_timeout=int(rng.integers(3, 40)),
        heartbeat_timeout=int(rng.integers(1, 4)),
        check_quorum=bool(seed % 2),
        pre_vote=bool(seed % 3),
    )
    want = JT.make_state_np(G, P, W, **kw)
    got = PT.make_state_np(G, P, W, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype == np.int32
    st = PT.make_state(G, P, W, device="cpu", **kw)
    for k in want:
        np.testing.assert_array_equal(getattr(st, k).numpy(), want[k])


def test_make_inbox_and_out_defaults_match():
    G, P, M, E, O = 3, 4, 5, 2, 6
    ji, pi = JT.make_inbox(G, M, E), PT.make_inbox(G, M, E, device="cpu")
    jo, po = JT.make_out(G, P, M, E, O), PT.make_out(G, P, M, E, O, device="cpu")
    for j, p in ((ji, pi), (jo, po)):
        for k in j._fields:
            np.testing.assert_array_equal(getattr(p, k).numpy(),
                                          np.asarray(getattr(j, k)), err_msg=k)
            assert getattr(p, k).dtype == torch.int32


@pytest.mark.parametrize("seed", range(3))
def test_convert_round_trip(seed):
    rng = np.random.default_rng(seed)
    G, P, W, M, E, O = 9, 5, 8, 4, 3, 5
    st = {
        k: rng.integers(-2**31, 2**31 - 1, v.shape, dtype=np.int64)
        .astype(np.int32)
        for k, v in JT.make_state_np(G, P, W).items()
    }
    back = convert.to_numpy(convert.state_from_numpy(st, "cpu"))
    for k in st:
        np.testing.assert_array_equal(back[k], st[k])
    ib = {k: rng.integers(-5, 5, np.asarray(v).shape).astype(np.int32)
          for k, v in JT.make_inbox(G, M, E)._asdict().items()}
    back = convert.to_numpy(convert.inbox_from_numpy(ib, "cpu"))
    for k in ib:
        np.testing.assert_array_equal(back[k], ib[k])
    out = {k: rng.integers(-5, 5, np.asarray(v).shape).astype(np.int32)
           for k, v in JT.make_out(G, P, M, E, O)._asdict().items()}
    back = convert.to_numpy(convert.out_from_numpy(out, "cpu"))
    for k in out:
        np.testing.assert_array_equal(back[k], out[k])
    with pytest.raises(KeyError):
        convert.state_from_numpy({"term": st["term"]}, "cpu")
