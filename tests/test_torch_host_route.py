"""The router kernel's walk and receiver, built as host C++, against the plain version.

``csrc/route.cu`` compiles as plain C++ when there is no CUDA compiler:
then its per-slot, per-row and per-message steps (``dbt::route_slot``,
``route_row_scalars``, ``route_lane_facts``, ``lane_rank``,
``route_lane_emit``, ``route_recv_slot``) are host functions.  This file
builds an ``extern "C"`` shim around them with g++ into a temporary
directory and runs them in the kernels' order: the walk row by row, each
row's sub-warp lane by lane in chunks of 8 messages (one a lane): every
lane's facts, then each peer slot's mask made from the lanes'
predicates (``dbt::host_lane_ranks``, where the card takes a ballot),
then every lane's emit; then the receiver slot by slot.  Every output starts poisoned, so a
word the kernels leave unwritten shows.  It is held against
``route_ref.route`` in the three modes the port launches it in:

* the colocated call (``colocated._route_step``): base 0, the alive
  lane read at a stride of 4, suppressed rows, the packed delivered bits
  and the undelivered-row word;
* ``route()``: ``dest_alive``, the delivered mask and a ``base_inbox``
  prefix;
* ``merge_and_route``: the tick and propose_leaders prefill generated in
  the receiver;

at O = 8, 16, 32 and 40 (an outbox wider than the sub-warp is walked in
chunks, the packed words put together across them), budgets 1 to 4 and
P up to 16, on tables as
``build_route_tables`` gives them and on fuzzed ones (cut routes,
``dest_row == g``, asymmetric ``rank_in_dest`` that reach other rows
through the reference's clamped gather, repeated peer ids).

Skips only when g++ is absent.  Tolerance: zero (bit-exact).
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

import test_torch_route as TRt
from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import colocated_ref
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import route as PRt
from dragonboat_tpu_torch.ops import route_ref
from dragonboat_tpu_torch.ops import types as PT

torch = convert.torch
SEED = 20261019
POISON = -0x5EED

SHIM = r"""
#include <cstdint>

#include "route.cu"

extern "C" {

// route_launch's memset, walk and receiver, in order, on the host
void host_route(const int* const* st, const int* buf, const int* count,
                const int* dest_row, const int* rank, const int* suppress,
                const int* alive, int alive_stride,
                const int* const* base_inbox, int M_base, int* const* inbox,
                int* stats, int* packed, int* undeliv,
                unsigned char* delivered, int* scratch, int* cnt, int G,
                int P, int W, int O, int M, int E, int B, int base, int tick,
                int propose_leaders, int propose_n) {
  constexpr int L = dbt::WALK_LANES;
  dbt::RouteArgs a;
  a.peer_id = st[0]; a.replica_id = st[1]; a.first_index = st[2];
  a.last_index = st[3]; a.role = st[4]; a.ring_term = st[5];
  a.ring_cc = st[6];
  a.buf = buf; a.count = count; a.dest_row = dest_row; a.rank = rank;
  a.suppress = suppress; a.alive = alive; a.alive_stride = alive_stride;
  for (int i = 0; i < dbt::N_INBOX; ++i) {
    a.base_inbox[i] = base_inbox ? base_inbox[i] : nullptr;
    a.inbox[i] = inbox[i];
  }
  a.M_base = M_base; a.stats = stats; a.packed = packed;
  a.undeliv = undeliv; a.delivered = delivered; a.scratch = scratch;
  a.cnt = cnt;
  a.G = G; a.P = P; a.W = W; a.O = O; a.M = M; a.E = E; a.B = B;
  a.base = base; a.tick = tick; a.propose_leaders = propose_leaders;
  a.propose_n = propose_n;
  for (int i = 0; i < dbt::N_ROUTE_STATS; ++i) stats[i] = 0;
  const int nw = (O + 31) / 32;
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
    int s[7] = {0, 0, 0, 0, 0, 0, 0};
    dbt::LaneWords carry;
    bool und = false;
    uint32_t word = 0;
    for (int c = 0; c * L < O; ++c) {
      dbt::RouteMsg f[L];
      uint32_t in[L];
      int b[L];
      for (int l = 0; l < L; ++l) {
        dbt::route_lane_facts(a, r, c * L + l, pid, f[l]);
        in[l] = f[l].deliverable ? f[l].hits : 0u;
      }
      dbt::host_lane_ranks(P, in, carry, b);
      for (int l = 0; l < L; ++l) {
        const int o = c * L + l;
        const bool deliv = dbt::route_lane_emit(a, r, f[l], o, b[l], s);
        if (deliv) word |= 1u << ((c * L + l) & 31);
        und = und || (f[l].v_raw && !deliv);
        if (delivered && o < O) delivered[(long long)g * O + o] = deliv;
      }
      const bool flush = (((c + 1) * L) & 31) == 0 || (c + 1) * L >= O;
      if (packed && flush) packed[(long long)g * nw + ((c * L) >> 5)] = (int)word;
      if (flush) word = 0;
    }
    if (undeliv) undeliv[g] = und ? 1 : 0;
    for (int p = 0; p < P; ++p)
      cnt[(long long)g * P + p] = dbt::imin(carry.held(p), B);
    if (r.sup) s[6] += 1;
    for (int i = 1; i < 7; ++i) stats[i] += s[i];
  }
  for (int t = 0; t < G * M; ++t)
    stats[0] += dbt::route_recv_slot(a, t / M, t % M);
}

}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    d = tmp_path_factory.mktemp("host_route")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_native.CSRC),
         "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    so.host_route.restype = None
    return so


def _ptr(a):
    assert a.flags.c_contiguous
    return ctypes.c_void_p(a.ctypes.data)


def _ptrs(arrays):
    for a in arrays:
        assert a.dtype == np.int32 and a.flags.c_contiguous
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def host_route(so, st, out, dest, rank, *, M, E, B, base, suppress=None,
               alive=None, alive_stride=1, base_inbox=None,
               prefill=(0, 0, 1)):
    """The shim's route: (inbox fields, stats [7], packed, undeliv,
    delivered), every output poisoned first."""
    G, O, _ = out["buf"].shape
    P, W = st["peer_id"].shape[1], st["ring_term"].shape[1]
    srcs = [np.ascontiguousarray(st[f]) for f in (
        "peer_id", "replica_id", "first_index", "last_index", "role",
        "ring_term", "ring_cc")]
    inbox = [np.full((G, M) + ((E,) if f.startswith("ent_") else ()),
                     POISON, np.int32) for f in PT.Inbox._fields]
    stats = np.full((7,), POISON, np.int32)
    packed = np.full((G, (O + 31) // 32), POISON, np.int32)
    undeliv = np.full((G,), POISON, np.int32)
    delivered = np.full((G, O), 7, np.uint8)
    scratch = np.full((G * P * B,), POISON, np.int32)
    cnt = np.full((G * P,), POISON, np.int32)
    opt = [None if x is None else np.ascontiguousarray(x, np.int32)
           for x in (suppress, alive)]
    bi, m_base = None, 0
    if base_inbox is not None:
        bi = [np.ascontiguousarray(base_inbox[f]) for f in PT.Inbox._fields]
        m_base = bi[0].shape[1]
    so.host_route(
        _ptrs(srcs), _ptr(out["buf"]), _ptr(out["count"]),
        _ptr(np.ascontiguousarray(dest, np.int32)),
        _ptr(np.ascontiguousarray(rank, np.int32)),
        *[None if x is None else _ptr(x) for x in opt],
        ctypes.c_int(alive_stride), None if bi is None else _ptrs(bi),
        ctypes.c_int(m_base), _ptrs(inbox), _ptr(stats), _ptr(packed),
        _ptr(undeliv), _ptr(delivered), _ptr(scratch), _ptr(cnt),
        *[ctypes.c_int(int(v)) for v in (
            G, P, W, O, M, E, B, base, *prefill)])
    return dict(zip(PT.Inbox._fields, inbox)), stats, packed, undeliv, \
        delivered


def _inputs(rng, shards, P, W, E, O, tables):
    """Seeded fuzz state and outbox (``test_torch_route``'s generator:
    repeated peer ids, self-addressed, unknown and off-device
    destinations, forwarded PROPOSE, ring-stale and below-ring REPLICATE,
    more messages toward a peer than any budget), with the tables as
    ``build_route_tables`` gives them ("built") or fuzzed further
    ("fuzzed": that generator's cut routes and dest_row == g, plus
    rank_in_dest values that are not the destination's slot, some outside
    [0, P))."""
    st, out, dest, rank, G = TRt._fuzz_route_inputs(rng, shards, P, W, E, O)
    if tables == "built":
        dest, rank = PRt.build_route_tables(
            st["shard_id"], st["replica_id"], st["peer_id"])
    else:
        odd = rng.random(rank.shape) < 0.15
        rank = np.where(odd, rng.integers(-P - 2, 2 * P + 2, rank.shape),
                        rank).astype(np.int32)
    st = {k: np.ascontiguousarray(v) for k, v in st.items()}
    out = {k: np.ascontiguousarray(v) for k, v in out.items()}
    return st, out, np.ascontiguousarray(dest, np.int32), \
        np.ascontiguousarray(rank, np.int32), G


def _want(st, out, dest, rank, **kw):
    """route_ref.route's outputs, with the kernel's suppressed-row count,
    packed bits and undelivered word derived as the colocated tail does."""
    suppress = kw.get("suppress")
    inbox, stats, deliv = route_ref.route(
        convert.state_from_numpy(st, "cpu"), convert.out_from_numpy(out, "cpu"),
        torch.from_numpy(dest), torch.from_numpy(rank), **kw)
    n_sup = 0 if suppress is None else int(suppress.bool().sum())
    O = deliv.shape[1]
    valid = torch.arange(O)[None, :] < torch.from_numpy(out["count"])[:, None]
    undeliv = (valid & ~deliv).any(dim=1).to(torch.int32)
    return (convert.to_numpy(inbox), np.append(stats.numpy(), n_sup),
            colocated_ref.pack_delivered(deliv).numpy(), undeliv.numpy(),
            deliv.numpy())


def _check(got, want, what):
    g_ib, g_stats, g_packed, g_und, g_deliv = got
    w_ib, w_stats, w_packed, w_und, w_deliv = want
    for f in PT.Inbox._fields:
        assert np.array_equal(g_ib[f], w_ib[f]), f"{what}: inbox.{f}"
    assert np.array_equal(g_stats, w_stats), (what, g_stats, w_stats)
    assert np.array_equal(g_packed, w_packed), f"{what}: packed"
    assert np.array_equal(g_und, w_und), f"{what}: undeliv"
    assert np.array_equal(g_deliv, w_deliv.astype(np.uint8)), \
        f"{what}: delivered"
    return g_stats


# (P, O, W, E, shards): O = 8 is one chunk of the 8-lane sub-warp, 16 and
# 32 two and four, 40 five across two packed words; P = 16 at O = 8 puts
# 16 slots beside 8 lanes
CASES = [(5, 32, 16, 4, 6), (3, 16, 16, 2, 8), (16, 8, 8, 1, 4),
         (4, 40, 8, 3, 10)]


@pytest.mark.parametrize("tables", ["built", "fuzzed"])
@pytest.mark.parametrize("case", CASES,
                         ids=[f"P{c[0]}-O{c[1]}" for c in CASES])
def test_route_walk_matches_plain_version(shim, case, tables):
    P, O, W, E, shards = case
    rng = np.random.default_rng(SEED + P * 100 + O + (tables == "fuzzed"))
    st, out, dest, rank, G = _inputs(rng, shards, P, W, E, O, tables)
    hit = np.zeros((7,), np.int64)
    for B in (1, 2, 3, 4):
        sup = (rng.random(G) < 0.2).astype(np.int32)
        # the colocated call: base 0, the alive lane of a [G, 4] combo
        combo = rng.integers(0, 3, (G, 4)).astype(np.int32)
        combo[:, 0] = rng.random(G) < 0.8
        M = P * B
        got = host_route(shim, st, out, dest, rank, M=M, E=E, B=B, base=0,
                         suppress=sup, alive=combo, alive_stride=4)
        hit += _check(got, _want(st, out, dest, rank, M=M, E=E, budget=B,
                                 base=0, suppress=torch.from_numpy(sup) != 0,
                                 dest_alive=torch.from_numpy(combo[:, 0]) != 0),
                      f"colocated B={B}")
        # route(): dest_alive, the delivered mask, a base_inbox prefix
        base = B % 3 + 1
        M = base + P * B
        alive = (rng.random(G) < 0.8).astype(np.int32)
        binb = {f: rng.integers(-5, 50, (G, M + 1) + (
            (E,) if f.startswith("ent_") else ())).astype(np.int32)
            for f in PT.Inbox._fields}
        got = host_route(shim, st, out, dest, rank, M=M, E=E, B=B,
                         base=base, suppress=sup, alive=alive,
                         base_inbox=binb)
        hit += _check(got, _want(
            st, out, dest, rank, M=M, E=E, budget=B, base=base,
            suppress=torch.from_numpy(sup) != 0,
            dest_alive=torch.from_numpy(alive) != 0,
            base_inbox=convert.inbox_from_numpy(binb, "cpu")),
            f"route() B={B}")
        # merge_and_route: the tick and propose_leaders prefill
        base, n = 2 + B % 2, int(rng.integers(1, 4))
        M = base + P * B
        pre = route_ref.make_prefill(convert.state_from_numpy(st, "cpu"), M,
                                     E, tick=True, propose_leaders=True,
                                     propose_n=n)
        got = host_route(shim, st, out, dest, rank, M=M, E=E, B=B,
                         base=base, suppress=sup, prefill=(1, 1, n))
        hit += _check(got, _want(st, out, dest, rank, M=M, E=E, budget=B,
                                 base=base, base_inbox=pre,
                                 suppress=torch.from_numpy(sup) != 0),
                      f"prefill B={B}")
    # every counted outcome was reached
    assert (hit > 0).all(), hit
