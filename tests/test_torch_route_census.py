"""The route's election census (``profiling.census``): the pre-vote and
vote requests and the granted pre-vote and vote responses the route takes
from the outboxes, delivered or dropped.

* The plain path (``route_ref.census_counts``, through ``route_ref.route``)
  against a count made message by message from the outboxes, on seeded
  random outboxes that hold every election message type, rejects
  included, suppressed rows and cut peer tables.
* The walk's own census step (``csrc/route.cu`` ``route_lane_census``),
  built as host C++ as ``test_torch_host_route.py`` builds the walk,
  against the plain path on the same outboxes.
* Census on against census off: every state, inbox, stats and ``n_esc``
  word the same, through elections on the CPU; the recorder's census
  (on while a profiler runs) equals the one passed by hand, and
  ``reset()`` zeroes it.
* The wave's CUDA path hands the census to the route's binding (stubbed)
  only while it counts.
* The benchmark's readers (``campaign_msgs_per_round``,
  ``vote_grants_per_round``) on known totals, and None where the program
  has no census or the recorder saw no wave.
* On the card (``card``, skipped without one): CUDA's census equals the
  plain path's on the same inputs, and census on leaves every word as
  census off.

Imports no JAX (the card case runs on the card's machine).  Tolerance:
zero (counts).
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_route_card as RC
from dragonboat_tpu_torch import profiling
from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import route as PRoute
from dragonboat_tpu_torch.ops import route_ref
from dragonboat_tpu_torch.ops import types as PT
from portbench.harness import manifest

ELECTION = (PT.MT_REQUEST_PREVOTE, PT.MT_REQUEST_VOTE,
            PT.MT_REQUEST_PREVOTE_RESP, PT.MT_REQUEST_VOTE_RESP)
OTHER = (PT.MT_REPLICATE, PT.MT_REPLICATE_RESP, PT.MT_HEARTBEAT,
         PT.MT_HEARTBEAT_RESP, PT.MT_PROPOSE, PT.MT_NOOP)
KW = dict(out_capacity=RC.O, budget=RC.BUDGET, base=RC.BASE)


@pytest.fixture
def recorder():
    profiling.reset()
    yield profiling
    profiling.reset()


def _random_round(seed: int, groups: int = 21):
    """c4 rows (3/5/7 replicas at P 7) with a random outbox: messages of
    every election type and some others, to random peers, reject 0 or 1,
    counts 0..O; some rows suppressed, some peer entries cut (-1).
    Returns (state, out, dest, rank, suppress) as torch CPU tensors."""
    rng = np.random.default_rng(seed)
    st_np, _ib, dest, rank = RC.c4_rows(groups)
    G, O = dest.shape[0], RC.O
    buf = rng.integers(0, 50, size=(G, O, PT.N_FIELDS)).astype(np.int32)
    kinds = np.array(ELECTION * 3 + OTHER, np.int32)
    buf[:, :, PT.F_MTYPE] = rng.choice(kinds, size=(G, O))
    buf[:, :, PT.F_REJECT] = rng.integers(0, 2, size=(G, O))
    peers = st_np["peer_id"]
    pick = rng.integers(0, RC.P, size=(G, O))
    buf[:, :, PT.F_TO] = np.take_along_axis(peers, pick, axis=1)
    buf[:, :, PT.F_N_ENTRIES] = rng.integers(0, 3, size=(G, O))
    count = rng.integers(0, O + 1, size=G).astype(np.int32)
    suppress = (rng.random(G) < 0.15).astype(np.int32)
    cut = rng.random(dest.shape) < 0.2
    dest = np.where(cut, -1, dest).astype(np.int32)
    state = convert.state_from_numpy(st_np, "cpu")
    out = K.RoutedOut(torch.from_numpy(buf), torch.from_numpy(count),
                      torch.zeros(G, dtype=torch.int32))
    return (state, out, torch.from_numpy(dest), torch.from_numpy(rank),
            torch.from_numpy(suppress))


def _count_by_hand(out, suppress) -> list:
    """The census message by message: rows not suppressed, o < count."""
    buf, count = out.buf.numpy(), out.count.numpy()
    want = [0, 0, 0, 0]
    for g in range(buf.shape[0]):
        if suppress[g]:
            continue
        for o in range(min(int(count[g]), buf.shape[1])):
            mt, rej = int(buf[g, o, PT.F_MTYPE]), int(buf[g, o, PT.F_REJECT])
            if mt == PT.MT_REQUEST_PREVOTE:
                want[0] += 1
            elif mt == PT.MT_REQUEST_VOTE:
                want[1] += 1
            elif mt == PT.MT_REQUEST_PREVOTE_RESP and rej == 0:
                want[2] += 1
            elif mt == PT.MT_REQUEST_VOTE_RESP and rej == 0:
                want[3] += 1
    return want


@pytest.mark.parametrize("seed", [1, 2, 3, 2**33 + 5])
def test_plain_census_counts_the_outboxes(seed):
    state, out, dest, rank, sup = _random_round(seed)
    M = RC.BASE + RC.P * RC.BUDGET
    census = torch.tensor([3, 0, 0, 1], dtype=torch.int64)
    inbox, stats, _ = route_ref.route(
        state, out, dest, rank, M=M, E=RC.E, budget=RC.BUDGET, base=RC.BASE,
        suppress=sup, census=census)
    want = _count_by_hand(out, sup.numpy())
    # added to, not overwritten
    assert census.tolist() == [want[0] + 3, want[1], want[2], want[3] + 1]
    assert min(want) > 0, want
    # the census changes nothing the route returns
    inbox0, stats0, _ = route_ref.route(
        state, out, dest, rank, M=M, E=RC.E, budget=RC.BUDGET, base=RC.BASE,
        suppress=sup)
    assert torch.equal(stats, stats0)
    for a, b in zip(inbox, inbox0):
        assert torch.equal(a, b)


# -- the walk's census step, as host C++ ------------------------------------
SHIM = r"""
#include <cstdint>

#include "route.cu"

extern "C" {

// the walk's facts and census of every (row, message), summed
void host_census(const int* const* st, const int* buf, const int* count,
                 const int* dest_row, const int* suppress, int G, int P,
                 int W, int O, long long* census) {
  dbt::RouteArgs a{};
  a.peer_id = st[0]; a.replica_id = st[1]; a.first_index = st[2];
  a.last_index = st[3]; a.role = st[4]; a.ring_term = st[5];
  a.ring_cc = st[6];
  a.buf = buf; a.count = count; a.dest_row = dest_row;
  a.suppress = suppress;
  a.G = G; a.P = P; a.W = W; a.O = O;
  for (int g = 0; g < G; ++g) {
    dbt::RouteRow r;
    dbt::route_row_scalars(a, g, r);
    dbt::LaneWords pid;
    for (int p = 0; p < P; ++p) {
      const dbt::RouteSlot sl = dbt::route_slot(a, g, p);
      pid.v[p] = sl.pid;
      r.dge0 |= (sl.ge0 ? 1u : 0u) << p;
      r.dns |= (sl.ns ? 1u : 0u) << p;
      r.alv |= (sl.alive ? 1u : 0u) << p;
    }
    for (int o = 0; o < O; ++o) {
      dbt::RouteMsg f;
      dbt::route_lane_facts(a, r, o, pid, f);
      int e[dbt::N_ROUTE_CENSUS] = {0, 0, 0, 0};
      dbt::route_lane_census(a, r, f, o, e);
      for (int i = 0; i < dbt::N_ROUTE_CENSUS; ++i) census[i] += e[i];
    }
  }
}

}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    d = tmp_path_factory.mktemp("host_census")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_native.CSRC),
         "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    so.host_census.restype = None
    return so


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("seed", [11, 12, 2**40 + 3])
def test_walk_census_step_matches_plain(shim, seed):
    state, out, dest, _rank, sup = _random_round(seed)
    srcs = [np.ascontiguousarray(getattr(state, f).numpy()) for f in (
        "peer_id", "replica_id", "first_index", "last_index", "role",
        "ring_term", "ring_cc")]
    ptrs = (ctypes.c_void_p * len(srcs))(*[a.ctypes.data for a in srcs])
    buf = np.ascontiguousarray(out.buf.numpy())
    count = np.ascontiguousarray(out.count.numpy())
    dest_np = np.ascontiguousarray(dest.numpy())
    sup_np = np.ascontiguousarray(sup.numpy())
    got = np.zeros(4, np.int64)
    G, O = count.shape[0], buf.shape[1]
    shim.host_census(ptrs, _ptr(buf), _ptr(count), _ptr(dest_np),
                     _ptr(sup_np), ctypes.c_int(G), ctypes.c_int(RC.P),
                     ctypes.c_int(RC.W), ctypes.c_int(O), _ptr(got))
    valid = ((torch.arange(O)[None, :] < out.count[:, None])
             & (sup == 0)[:, None])
    want = route_ref.census_counts(out, valid)
    assert got.tolist() == want.tolist()
    assert got.tolist() == _count_by_hand(out, sup_np)


# -- census on against census off, through elections ----------------------
def _fresh_rows(groups: int = 12):
    """(state, inbox, dest, rank) of ``groups`` c4 groups before their
    elections, on the CPU."""
    st_np, ib_np, dest_np, rank_np = RC.c4_rows(groups)
    return (convert.state_from_numpy(st_np, "cpu"),
            convert.inbox_from_numpy(ib_np, "cpu"),
            torch.from_numpy(dest_np), torch.from_numpy(rank_np))


def _waves(st, ib, dest, rank, waves, **extra):
    outs = []
    for _ in range(waves):
        st, ib, stats, n_esc = PRoute.fused_rounds(
            st, ib, dest, rank, rounds=RC.ROUNDS, **KW, **extra)
        outs.append((st, ib, stats, n_esc))
    return outs


def _assert_same_waves(want, got):
    for (s0, i0, t0, e0), (s1, i1, t1, e1) in zip(want, got):
        for a, b in zip(list(s0) + list(i0), list(s1) + list(i1)):
            assert torch.equal(a, b)
        assert torch.equal(t0, t1) and torch.equal(e0, e1)


def test_census_changes_no_word_and_follows_the_recorder(recorder):
    st, ib, dest, rank = _fresh_rows()
    waves = 8  # 24 rounds: past the 10-tick election timeouts
    off = _waves(st, ib, dest, rank, waves)
    assert profiling.census() == dict.fromkeys(profiling.CENSUS, 0)
    by_hand = torch.zeros(4, dtype=torch.int64)
    on = _waves(st, ib, dest, rank, waves, census=by_hand)
    _assert_same_waves(off, on)
    # the elections ran: every kind was counted
    assert min(by_hand.tolist()) > 0, by_hand
    assert profiling.census_buffer("cpu") is None
    # the recorder's census: on while a profiler runs, the same counts
    with profile(activities=[ProfilerActivity.CPU]):
        rec = _waves(st, ib, dest, rank, waves)
    _assert_same_waves(off, rec)
    got = profiling.census()
    assert [got[k] for k in profiling.CENSUS] == by_hand.tolist()
    profiling.reset()
    assert profiling.census() == dict.fromkeys(profiling.CENSUS, 0)


def test_plain_census_adds_up_over_the_rounds():
    # the wave's census is the sum of its rounds' routes
    st, ib, dest, rank = _fresh_rows()
    for _ in range(3):
        st, ib, _s, _e = PRoute.fused_rounds(st, ib, dest, rank,
                                             rounds=RC.ROUNDS, **KW)
    wave = torch.zeros(4, dtype=torch.int64)
    PRoute.fused_rounds(st, ib, dest, rank, rounds=4, census=wave, **KW)
    rounds = torch.zeros(4, dtype=torch.int64)
    for _ in range(4):
        st, ib, _s, _e = route_ref.routed_round(st, ib, dest, rank,
                                                census=rounds, **KW)
    assert wave.tolist() == rounds.tolist()
    assert sum(wave.tolist()) > 0, wave


# -- the CUDA path's wiring, with the bindings stubbed out -----------------
class _Recording:
    def __init__(self):
        self.route_census = []

    def __getattr__(self, entry):
        def call(*args):
            if entry == "route":
                self.route_census.append(args[-1])
        return call


@pytest.mark.parametrize("on", [False, True])
def test_wave_hands_the_census_to_the_route_binding(monkeypatch, recorder, on):
    fake = _Recording()
    monkeypatch.setattr(_native, "_module", fake)
    monkeypatch.setattr(_native, "on_cpu", lambda t, name: False)
    st, ib, dest, rank = _fresh_rows(groups=3)
    if on:
        with profile(activities=[ProfilerActivity.CPU]):
            PRoute.fused_rounds(st, ib, dest, rank, rounds=3, **KW)
        assert len(fake.route_census) == 3
        assert all(c is fake.route_census[0] for c in fake.route_census)
        c = fake.route_census[0]
        assert c.dtype == torch.int64 and tuple(c.shape) == (4,)
        # the profiler has stopped
        assert profiling.census_buffer("cpu") is None
    else:
        PRoute.fused_rounds(st, ib, dest, rank, rounds=3, **KW)
        assert fake.route_census == [None, None, None]


# -- the benchmark's readers ------------------------------------------------
_CENSUS = dict(prevote_requests=900, vote_requests=300, prevote_grants=240,
               vote_grants=120)


@pytest.mark.parametrize("name, want", [
    ("campaign_msgs_per_round", 200.0),
    ("vote_grants_per_round", 60.0),
])
def test_census_readers_read_known_totals(monkeypatch, name, want):
    monkeypatch.setattr(profiling, "census", lambda: dict(_CENSUS))
    monkeypatch.setattr(profiling, "totals",
                        lambda: {"fused_rounds": (2, 1_000_000)})
    reader = manifest.metric_reader(name)
    assert reader.read(dict(rounds=6)) == pytest.approx(want)
    assert reader.read(dict(rounds=0)) is None
    # the recorder saw no fused wave
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert reader.read(dict(rounds=6)) is None
    # a program from before the census reads nothing
    monkeypatch.setattr(profiling, "totals",
                        lambda: {"fused_rounds": (2, 1_000_000)})
    monkeypatch.delattr(profiling, "census")
    assert reader.read(dict(rounds=6)) is None


def test_census_metrics_are_read_in_the_churn_cell_only():
    man = manifest.load_manifest()
    names = {"campaign_msgs_per_round", "vote_grants_per_round"}
    for m in man["per_layer"]:
        if m["name"] in names:
            assert m["workloads"] == ["c4-100k-churn.idle"]
            assert m["moves"] == "group_rounds_per_s"
    cell = manifest.cell("c4-100k-churn.idle")
    assert names <= {m["name"] for m in cell.per_layer}
    assert not names & {m["name"] for m in
                        manifest.cell("c4-100k-ragged.idle").per_layer}


# -- on the card -------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_census_matches_plain(card):
    st_np, ib_np, dest_np, rank_np = RC.c4_rows(RC.GROUPS)
    # some peers cut, so elections run while messages drop
    dest_np = dest_np.copy()
    replica = st_np["replica_id"]
    cut = replica == 2
    names_cut = (dest_np >= 0) & cut[np.clip(dest_np, 0, None)]
    dest_cut = np.where(cut[:, None] | names_cut, -1, dest_np).astype(np.int32)
    st = convert.state_from_numpy(st_np, card)
    ib = convert.inbox_from_numpy(ib_np, card)
    tables = [(torch.from_numpy(d).to(card), torch.from_numpy(d))
              for d in (dest_np, dest_cut)]
    rank, rank_cpu = torch.from_numpy(rank_np).to(card), torch.from_numpy(rank_np)
    total = torch.zeros(4, dtype=torch.int64)
    for wave in range(24):
        dest, dest_cpu = tables[(wave // 8) % 2]
        start = (RC._on(st, "cpu"), RC._on(ib, "cpu"))
        census = torch.zeros(4, dtype=torch.int64, device=card)
        off = PRoute.fused_rounds(st, ib, dest, rank, rounds=RC.ROUNDS, **KW)
        on = PRoute.fused_rounds(st, ib, dest, rank, rounds=RC.ROUNDS,
                                 census=census, **KW)
        want = torch.zeros(4, dtype=torch.int64)
        plain = route_ref.fused_rounds(*start, dest_cpu, rank_cpu,
                                       rounds=RC.ROUNDS, census=want, **KW)
        torch.cuda.synchronize()
        for a, b, c in zip(list(off[0]) + list(off[1]),
                           list(on[0]) + list(on[1]),
                           list(plain[0]) + list(plain[1])):
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)
        for a, b, c in zip(off[2:], on[2:], plain[2:]):
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)
        assert census.cpu().tolist() == want.tolist(), wave
        total += want
        st, ib = on[0], on[1]
    assert min(total.tolist()) > 0, total
