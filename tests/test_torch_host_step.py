"""The CUDA kernels' block and row logic, built as host C++, against the plain versions.

``csrc/raft_step.cu`` and ``csrc/xlane.cu`` compile as plain C++ when
there is no CUDA compiler: then the raft step's block phases
(``dbt::step_load``, ``step_prefill``, ``step_rows``, ``step_store``, for
either layout) and the lane's per-slot, per-row and per-message steps
(``dbt::xlane_slot``, ``xlane_row_scalars``, ``xlane_lane_facts``,
``lane_rank``, ``xlane_lane_tally``, ``xlane_row_at``, ``xlane_pack_row``,
``xlane_finish_stats``, ``xlane_zero_range``, ``xlane_scatter_row``) are
host functions.
This file builds a small ``extern "C"`` shim around that logic with g++
into ``tmp_path``, calls it through ``ctypes`` and holds it against the
plain PyTorch versions on seeded inputs:

* the raft step in BOTH layouts, block by block as the kernel runs it
  (every thread's load, then every thread's prefill, then every row's
  logic, then every thread's store, on a poisoned tile): the external
  kernel against ``kernel_ref.step``, the G-last one against
  ``kernel_ref.step_internal`` on the same rows, on a seeded cluster
  state under seeded fuzz inboxes over every hot message type, at 32 and
  128 rows a block, with ragged last blocks, a G that is not a multiple
  of 4 and P up to 16;
* the routed step (``raft_step_kernel<true>``: no prefill, the routed row
  logic, only the emitted staged messages stored) against the full one
  on the same rows and inboxes: the same state, ``count``, ``escalate``
  and messages below the count, and every other outbox word still the
  poison, at 32 and 128 rows a block with ragged last blocks, P up to
  16, the benchmark cells' geometries, and rows that emit past the
  staged messages;
* the quorum index counted without an array against the insertion sort
  it replaces, exhaustively over small P;
* the lane's pack in its three passes, in the kernels' order (the count
  pass block by block, each row's sub-warp lane by lane with the masks
  made from the lanes' predicates (``dbt::host_lane_ranks``, where the
  card takes a ballot) and the block's row-order scan; the
  scan over the blocks; the zero fill and the write pass), against
  ``route_ref.lane_pack``, and its scatter against
  ``route_ref.lane_scatter``, on the lane fuzz of ``test_torch_mesh.py``
  at 2 to 16 devices, outboxes of 8 to 40 messages, blocks of 32 and 128
  rows with ragged last blocks, and a sized and an undersized
  ``xbudget``;
* the lane kernels' rows a block (``route.lane_rows_per_block``) at the
  main paths' shapes, and the route and lane wrappers'
  allocations (views of one buffer each, 16-byte aligned, disjoint).

It checks the arithmetic and the layouts' addressing the kernels share
with the card; the CUDA launch itself runs only on the card
(``chip_smoke.py``).  Skips only when g++ is absent.  Tolerance: zero
(bit-exact).
"""
from __future__ import annotations

import ctypes
import itertools
import shutil
import subprocess

import numpy as np
import pytest

import chip_smoke
import test_torch_mesh as TM
from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import kernel as PK
from dragonboat_tpu_torch.ops import kernel_ref
from dragonboat_tpu_torch.ops import route as PRt
from dragonboat_tpu_torch.ops import route_ref
from dragonboat_tpu_torch.ops import types as PT

torch = convert.torch
SEED = 20261018
POISON = -0x5EED

SHIM = r"""
#include <algorithm>
#include <cstddef>
#include <vector>

#include "raft_step.cu"
#include "xlane.cu"

template <bool GL>
static void run_blocks(dbt::StepArgs& a) {
  std::vector<int> tile((size_t)a.S * a.T() + a.R);
  const int blocks = (a.G + a.R - 1) / a.R;
  for (int b = 0; b < blocks; ++b) {
    std::fill(tile.begin(), tile.end(), -0x5EED);
    for (int t = 0; t < a.R; ++t) dbt::step_load<GL>(a, tile.data(), b, t);
    for (int t = 0; t < a.R; ++t) dbt::step_prefill<GL>(a, tile.data(), b, t);
    for (int t = 0; t < a.R; ++t) dbt::step_rows<GL>(a, tile.data(), b, t);
    for (int t = 0; t < a.R; ++t) dbt::step_store<GL>(a, tile.data(), b, t);
  }
}

// the routed step's phases in raft_step_kernel<true>'s order: no prefill;
// the tile's poison is not the outputs', so a store of a tile word no
// phase wrote shows
static void run_routed_blocks(dbt::StepArgs& a) {
  std::vector<int> tile((size_t)a.S * a.T() + a.R);
  const int blocks = (a.G + a.R - 1) / a.R;
  for (int b = 0; b < blocks; ++b) {
    std::fill(tile.begin(), tile.end(), -0x7EED);
    for (int t = 0; t < a.R; ++t)
      dbt::step_load<false, true>(a, tile.data(), b, t);
    for (int t = 0; t < a.R; ++t)
      dbt::step_rows<false, true>(a, tile.data(), b, t);
    for (int t = 0; t < a.R; ++t)
      dbt::step_store<false, true>(a, tile.data(), b, t);
  }
}

// the quorum index as the kernel computed it before: an insertion sort
static int quorum_sorted(const dbt::Row& r) {
  int s[16], n_voters = 0;
  for (int p = 0; p < r.P; ++p) {
    const int id = r.pa(dbt::PA_ID, p), kind = r.pa(dbt::PA_KIND, p);
    const bool voter = id != 0 && (kind == dbt::KIND_VOTER ||
                                   kind == dbt::KIND_WITNESS);
    n_voters += voter ? 1 : 0;
    int v = voter ? r.pa(dbt::PA_MATCH, p) : -1;
    int j = p;
    while (j > 0 && s[j - 1] > v) {
      s[j] = s[j - 1];
      --j;
    }
    s[j] = v;
  }
  int k = r.P - (n_voters / 2 + 1);
  return (k >= 0 && k < r.P) ? s[k] : 0;
}

extern "C" {

void host_step(const int* const* st_in, int* const* st_out,
               const int* const* ib, int* const* out, int G, int P, int W,
               int M, int E, int O, int internal, int R, int K) {
  dbt::StepArgs a;
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_in[f] = st_in[f];
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_out[f] = st_out[f];
  for (int f = 0; f < dbt::N_INBOX; ++f) a.ib[f] = ib[f];
  for (int f = 0; f < dbt::N_OUT; ++f) a.out[f] = out[f];
  dbt::step_args_init(a, G, P, W, M, E, O, internal, R, K);
  if (internal)
    run_blocks<true>(a);
  else
    run_blocks<false>(a);
}

// the routed step: out holds buf, count and escalate only (the other
// outputs are null, so a write to one faults)
void host_step_routed(const int* const* st_in, int* const* st_out,
                      const int* const* ib, int* const* out, int G, int P,
                      int W, int M, int E, int O, int R, int K) {
  dbt::StepArgs a;
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_in[f] = st_in[f];
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_out[f] = st_out[f];
  for (int f = 0; f < dbt::N_INBOX; ++f) a.ib[f] = ib[f];
  for (int f = 0; f < dbt::N_OUT; ++f)
    a.out[f] = f < dbt::N_ROUTED_OUT ? out[f] : nullptr;
  dbt::step_args_init(a, G, P, W, M, E, O, 0, R, K);
  run_routed_blocks(a);
}

// n cases of P slots each: out[2c] the counted index, out[2c+1] the sorted
void host_quorum(const int* peer_id, const int* kind, const int* match,
                 int P, int n, int* out) {
  std::vector<int> col(8 * P, 0);
  dbt::Row r;
  r.P = P;
  r.S = 1;
  r.tt = col.data();
  r.self_slot = 0;
  r.replica_id = 1;
  for (int c = 0; c < n; ++c) {
    for (int p = 0; p < P; ++p) {
      r.pa(dbt::PA_ID, p) = peer_id[c * P + p];
      r.pa(dbt::PA_KIND, p) = kind[c * P + p];
      r.pa(dbt::PA_MATCH, p) = match[c * P + p];
    }
    r.read_peers();
    out[2 * c] = r.quorum_index();
    out[2 * c + 1] = quorum_sorted(r);
  }
}

// xlane_pack's three passes on the host, in the kernels' order: the count
// pass block by block (each row's sub-warp lane by lane, the masks made
// from the lanes' predicates, then the block's row-order scan), the scan
// over the blocks, then the write pass and the zero fill
static bool lane_walk(const dbt::XPackArgs& a, const dbt::XRow& r, int blk,
                      bool write, int* s, dbt::LaneWords& dcnt, int* stage,
                      const int* seg) {
  bool und = false;
  constexpr int L = dbt::WALK_LANES;
  dbt::XSlots sl;
  for (int p = 0; p < a.P; ++p) {
    const dbt::XSlot x = dbt::xlane_slot(a, r.g, p);
    sl.pid.v[p] = x.pid; sl.dev.v[p] = x.dev; sl.loc.v[p] = x.loc;
    sl.rank.v[p] = x.rank;
  }
  dbt::LaneWords rowoff;
  for (int d = 0; write && d < a.D; ++d)
    rowoff.v[d] = a.rowoff[(long long)r.g * a.D + d];
  dbt::LaneWords carry;  // per peer slot
  for (int c = 0; c * L < a.O; ++c) {
    dbt::XMsg f[L];
    uint32_t in[L];
    int bx[L], q[L];
    bool ok[L];
    for (int l = 0; l < L; ++l) {
      dbt::xlane_lane_facts(a, r, c * L + l, sl, f[l]);
      in[l] = f[l].deliverable ? f[l].hits : 0u;
    }
    dbt::host_lane_ranks(a.P, in, carry, bx);
    for (int l = 0; l < L; ++l) {
      ok[l] = dbt::xlane_lane_tally(a, f[l], bx[l], s);
      in[l] = ok[l] ? 1u << f[l].xdev : 0u;
    }
    dbt::host_lane_ranks(a.D, in, dcnt, q);
    uint32_t bits = 0;
    for (int l = 0; write && l < L; ++l) {
      const int x = ok[l] ? f[l].xdev : 0;
      const int j = q[l] + rowoff.pick(x);
      bool carried = false;
      if (ok[l]) {
        int* row = dbt::xlane_row_at(a, blk, x, j, stage, seg);
        if (row) dbt::xlane_pack_row(a, r, f[l], row);
        carried = dbt::xlane_carried(a, blk, x, j);
      }
      if (!a.packed) continue;
      if (carried) bits |= 1u << l;
      und |= dbt::xlane_undelivered(a, r.g, c * L + l, f[l].v, carried);
    }
    if (write && a.packed) dbt::xlane_mark_carried(a, r.g, c, bits);
  }
  return und;
}

void host_xlane_pack(const int* const* st, const int* buf, const int* count,
                     const int* suppress, const int* dest_local,
                     const int* dest_dev, const int* rank, int* xbuf,
                     int* rowoff, int* btot, int* boff, int* part, int* tot,
                     int* stats, int G, int P, int W, int O, int E, int D,
                     int XB, int B, int me, int R, int stage_rows,
                     const int* alive, int alive_stride, int* packed,
                     int* undeliv, int n_stats) {
  dbt::XPackArgs a;
  a.peer_id = st[0]; a.replica_id = st[1]; a.first_index = st[2];
  a.last_index = st[3]; a.ring_term = st[4]; a.ring_cc = st[5];
  a.buf = buf; a.count = count; a.suppress = suppress;
  a.dest_local = dest_local; a.dest_dev = dest_dev; a.rank = rank;
  a.xbuf = xbuf; a.rowoff = rowoff; a.btot = btot; a.boff = boff;
  a.part = part; a.tot = tot; a.stats = stats;
  a.G = G; a.P = P; a.W = W; a.O = O; a.E = E; a.D = D; a.XB = XB;
  a.B = B; a.me = me; a.R = R; a.nblk = (G + R - 1) / R;
  a.stage_rows = stage_rows;
  a.alive = alive; a.alive_stride = alive_stride;
  a.packed = packed; a.undeliv = undeliv; a.nw = (O + 31) / 32;
  a.n_stats = n_stats;
  auto row = [&](int g, dbt::XRow& r) {
    if (g < G) dbt::xlane_row_scalars(a, g, r); else dbt::xlane_row_empty(r);
  };
  // count: per block, its rows' counts, then their row-order scan
  for (int k = 0; k < a.nblk; ++k) {
    std::vector<int> rc((size_t)R * D, 0);
    int s[dbt::XL_NPART] = {0, 0, 0, 0};
    for (int rr = 0; rr < R; ++rr) {
      dbt::XRow r;
      row(k * R + rr, r);
      dbt::LaneWords dcnt;
      lane_walk(a, r, k, false, s, dcnt, nullptr, nullptr);
      if (r.sup) s[3] += 1;
      for (int d = 0; d < D; ++d) rc[(size_t)rr * D + d] = dcnt.held(d);
    }
    for (int d = 0; d < D; ++d) {
      int run = 0;
      for (int rr = 0; rr < R; ++rr) {
        if (k * R + rr < G) rowoff[(long long)(k * R + rr) * D + d] = run;
        run += rc[(size_t)rr * D + d];
      }
      btot[k * D + d] = run;
    }
    for (int i = 0; i < dbt::XL_NPART; ++i) part[k * dbt::XL_NPART + i] = s[i];
  }
  // scan
  int st_sum[dbt::XL_NPART] = {0, 0, 0, 0};
  for (int d = 0; d < D; ++d) {
    int run = 0;
    for (int k = 0; k < a.nblk; ++k) {
      boff[k * D + d] = run;
      run += btot[k * D + d];
    }
    tot[d] = run;
  }
  for (int k = 0; k < a.nblk; ++k)
    for (int i = 0; i < dbt::XL_NPART; ++i)
      st_sum[i] += part[k * dbt::XL_NPART + i];
  dbt::xlane_finish_stats(a, tot, st_sum);
  // write: the zero fill, then each block's rows, staged when they fit
  for (int d = 0; d < D; ++d) {
    long long lo, hi;
    dbt::xlane_zero_range(a, d, tot[d], &lo, &hi);
    for (long long w = lo; w < hi; ++w) xbuf[w] = 0;
  }
  const int KT = dbt::X_KF + 2 * E;
  for (int k = 0; k < a.nblk; ++k) {
    int seg[dbt::XDMAX];
    const bool staged = dbt::xlane_block_segs(a, k, seg) <= stage_rows;
    std::vector<int> stage((size_t)stage_rows * KT + 1, -0x5EED);
    for (int rr = 0; rr < R; ++rr) {
      dbt::XRow r;
      row(k * R + rr, r);
      dbt::LaneWords dcnt;
      int s[dbt::XL_NPART];
      const bool und = lane_walk(a, r, k, true, s, dcnt,
                                 staged ? stage.data() : nullptr, seg);
      if (packed && k * R + rr < G && !r.sup) undeliv[k * R + rr] = und;
    }
    if (!staged) continue;
    for (int d = 0; d < D; ++d) {
      const int n = dbt::xlane_flush_rows(a, k, d) * KT;
      int* dst = xbuf + ((long long)d * XB + boff[k * D + d]) * KT;
      for (int w = 0; w < n; ++w) dst[w] = stage[(size_t)seg[d] * KT + w];
    }
  }
}

void host_xlane_scatter(int* const* inbox, const int* recv, int* stats,
                        int R, int G, int M, int E, int B, int base) {
  dbt::XScatArgs a;
  for (int i = 0; i < dbt::N_INBOX; ++i) a.inbox[i] = inbox[i];
  a.recv = recv; a.stats = stats;
  a.R = R; a.G = G; a.M = M; a.E = E; a.B = B; a.base = base;
  int n = 0;
  for (long long r = 0; r < R; ++r) n += dbt::xlane_scatter_row(a, r);
  stats[1] = n;
}

}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    d = tmp_path_factory.mktemp("host_step")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_native.CSRC),
         "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    so.host_step.restype = None
    so.host_step_routed.restype = None
    so.host_quorum.restype = None
    so.host_xlane_pack.restype = None
    so.host_xlane_scatter.restype = None
    return so


def _ptrs(arrays):
    """A C array of the (contiguous int32) numpy arrays' data pointers."""
    for a in arrays:
        assert a.dtype == np.int32 and a.flags.c_contiguous
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def _ints(*vals):
    return [ctypes.c_int(int(v)) for v in vals]


def host_step(so, st: dict, ib: dict, O: int, internal: bool, R: int = 32,
              K: int = 8):
    """The shim's step on numpy fields of either layout, blocks of R
    rows; every output starts poisoned, so a word the kernel leaves
    unwritten shows."""
    G = st["term"].shape[0]
    ax = 0 if internal else 1
    P, W = st["peer_id"].shape[ax], st["ring_term"].shape[ax]
    M = ib["mtype"].shape[ax]
    E = ib["ent_term"].shape[1 if internal else 2]
    st_in = [np.ascontiguousarray(st[f]) for f in PT.DeviceState._fields]
    ib_in = [np.ascontiguousarray(ib[f]) for f in PT.Inbox._fields]
    st_out = [np.full_like(a, POISON) for a in st_in]

    def shape(*dims):
        return (*dims, G) if internal else (G, *dims)

    out = {
        "buf": shape(O, PT.N_FIELDS), "count": (G,), "escalate": (G,),
        "need_snapshot": shape(P), "slot_base": shape(M),
        "slot_term": shape(M), "ent_drop": shape(M, E), "append_lo": (G,),
        "barrier_idx": (G,), "barrier_term": (G,),
    }
    outs = [np.full(out[f], POISON, np.int32) for f in PT.DeviceOut._fields]
    so.host_step(_ptrs(st_in), _ptrs(st_out), _ptrs(ib_in), _ptrs(outs),
                 *_ints(G, P, W, M, E, O, internal, R, K))
    return (dict(zip(PT.DeviceState._fields, st_out)),
            dict(zip(PT.DeviceOut._fields, outs)))


def host_step_routed(so, st: dict, ib: dict, O: int, R: int = 32,
                     K: int = 8):
    """The shim's routed step on numpy fields of the external layout,
    blocks of R rows: the new state and ``kernel.RoutedOut``'s fields,
    every output word poisoned first."""
    G = st["term"].shape[0]
    P, W = st["peer_id"].shape[1], st["ring_term"].shape[1]
    M, E = ib["mtype"].shape[1], ib["ent_term"].shape[2]
    st_in = [np.ascontiguousarray(st[f]) for f in PT.DeviceState._fields]
    ib_in = [np.ascontiguousarray(ib[f]) for f in PT.Inbox._fields]
    st_out = [np.full_like(a, POISON) for a in st_in]
    outs = [np.full(s, POISON, np.int32)
            for s in ((G, O, PT.N_FIELDS), (G,), (G,))]
    so.host_step_routed(_ptrs(st_in), _ptrs(st_out), _ptrs(ib_in),
                        _ptrs(outs), *_ints(G, P, W, M, E, O, R, K))
    return (dict(zip(PT.DeviceState._fields, st_out)),
            dict(zip(PK.RoutedOut._fields, outs)))


def _padded_cluster(G: int, P: int, W: int, seed: int) -> dict:
    """``chip_smoke.cluster_state_np`` on the first G - G % 3 rows, then
    empty rows (no peers), as an engine's unused capacity holds."""
    return chip_smoke.padded_cluster_np(G, P, W, seed)


def _run_steps(shim, seed, G, P, W, M, E, O, R, K, n_steps, n_routed):
    rng = np.random.default_rng(SEED + seed)
    ext = _padded_cluster(G, P, W, SEED + seed)
    out_np = {"buf": np.zeros((G, O, PT.N_FIELDS), np.int32),
              "count": np.zeros((G,), np.int32)}
    leaders = 0
    for k in range(n_steps):
        # routed steps first (elections and commits), then fuzz
        ib_ext = (chip_smoke.route_np(ext, out_np, rng, M, E)
                  if k < n_routed else chip_smoke.fuzz_inbox_np(ext, rng, M, E))
        st_t = convert.state_from_numpy(ext, "cpu")
        ib_t = convert.inbox_from_numpy(ib_ext, "cpu")
        want_st, want_out = kernel_ref.step(st_t, ib_t, O)
        got_st, got_out = host_step(shim, ext, ib_ext, O, False, R, K)
        TM.assert_fields_equal(convert.to_numpy(want_st), got_st,
                               f"external state step {k}")
        TM.assert_fields_equal(convert.to_numpy(want_out), got_out,
                               f"external out step {k}")
        ist = convert.to_numpy(convert.state_to_internal(st_t))
        iib = convert.to_numpy(convert.inbox_to_internal(ib_t))
        wi_st, wi_out = kernel_ref.step_internal(
            convert.state_from_numpy(ist, "cpu"),
            convert.inbox_from_numpy(iib, "cpu"), O)
        gi_st, gi_out = host_step(shim, ist, iib, O, True, R, K)
        TM.assert_fields_equal(convert.to_numpy(wi_st), gi_st,
                               f"internal state step {k}")
        TM.assert_fields_equal(convert.to_numpy(wi_out), gi_out,
                               f"internal out step {k}")
        ext, out_np = got_st, got_out
        if k == n_routed - 1:  # the routed steps elected leaders
            leaders = int((ext["role"] == PT.ROLE_LEADER).sum())
    return leaders


@pytest.mark.parametrize("seed", range(2))
def test_step_row_both_layouts_match_plain_versions(shim, seed):
    G = 48
    leaders = _run_steps(shim, seed, G, 5, 32, 8, 4, 32, R=32, K=8,
                         n_steps=16, n_routed=12)
    assert leaders >= G // 6, leaders


# (G, P, W, M, E, O, R, K staged messages): one ragged block of 128, no
# message staged; a G that is not a multiple of 4 (the G-last kernel's
# word copies) in a ragged second block, 3 staged; P = 16, every message
# staged; bench phase A's widths in blocks of 64
BLOCK_CASES = [
    (48, 5, 32, 8, 4, 32, 128, 0),
    (51, 5, 32, 8, 4, 32, 32, 3),
    (45, 16, 16, 6, 2, 8, 32, 8),
    (99, 3, 8, 12, 1, 8, 64, 8),
]


@pytest.mark.parametrize("case", BLOCK_CASES,
                         ids=[f"G{c[0]}-P{c[1]}-R{c[6]}-K{c[7]}"
                              for c in BLOCK_CASES])
def test_step_blocks_match_plain_versions(shim, case):
    G, P, W, M, E, O, R, K = case
    _run_steps(shim, 7, G, P, W, M, E, O, R=R, K=K, n_steps=10, n_routed=7)


# (G, P, W, M, E, O, R, K): one ragged block of 128; ragged blocks of 32
# with 3 staged, so most rows emit past the tile; P = 16 with outboxes
# that overflow; the c4 cell's geometry (ragged second block of 128); the
# ns cell's with nothing staged
ROUTED_CASES = [
    (48, 5, 32, 8, 4, 32, 128, 8),
    (51, 5, 32, 8, 4, 32, 32, 3),
    (45, 16, 16, 6, 2, 8, 32, 8),
    (150, 7, 16, 58, 2, 32, 128, 8),
    (40, 3, 32, 14, 4, 16, 32, 0),
]


@pytest.mark.parametrize("case", ROUTED_CASES,
                         ids=[f"G{c[0]}-P{c[1]}-M{c[3]}-R{c[6]}-K{c[7]}"
                              for c in ROUTED_CASES])
def test_routed_step_writes_only_what_the_round_reads(shim, case):
    G, P, W, M, E, O, R, K = case
    rng = np.random.default_rng(SEED + G)
    ext = _padded_cluster(G, P, W, SEED + G)
    out_np = {"buf": np.zeros((G, O, PT.N_FIELDS), np.int32),
              "count": np.zeros((G,), np.int32)}
    sent = past_k = escalated = 0
    for k in range(12):
        # routed steps first (elections and commits), then fuzz
        ib = (chip_smoke.route_np(ext, out_np, rng, M, E) if k < 8
              else chip_smoke.fuzz_inbox_np(ext, rng, M, E))
        want_st, want_out = host_step(shim, ext, ib, O, False, R, K)
        got_st, got_out = host_step_routed(shim, ext, ib, O, R, K)
        TM.assert_fields_equal(want_st, got_st, f"state step {k}")
        for f in ("count", "escalate"):
            assert np.array_equal(got_out[f], want_out[f]), (f, k)
        cnt = got_out["count"]
        live = np.arange(O)[None, :] < cnt[:, None]
        assert np.array_equal(got_out["buf"][live], want_out["buf"][live]), k
        assert (got_out["buf"][~live] == POISON).all(), k
        sent += int(live.sum())
        past_k += int((cnt > K).sum())
        escalated += int((got_out["escalate"] != 0).sum())
        ext, out_np = want_st, want_out
    assert sent > G and escalated > 0
    if K <= 3:  # these cases emit past the staged messages
        assert past_k > 0


def _quorum_cases(P: int):
    """Every mix of empty, voter, non-voting and witness slots with match
    values in {0, 1, 2}: (peer_id, kind, match), each [n, P]."""
    slot = [(0, PT.KIND_VOTER), (1, PT.KIND_VOTER),
            (1, PT.KIND_NON_VOTING), (1, PT.KIND_WITNESS)]
    kinds = np.array(list(itertools.product(range(4), repeat=P)), np.int32)
    match = np.array(list(itertools.product(range(3), repeat=P)), np.int32)
    ki = np.repeat(kinds, len(match), axis=0)
    mi = np.tile(match, (len(kinds), 1))
    pid = np.array([s[0] for s in slot], np.int32)[ki] * (
        np.arange(P, dtype=np.int32) + 1)
    kind = np.array([s[1] for s in slot], np.int32)[ki]
    return pid, kind, mi


@pytest.mark.parametrize("P", [1, 2, 3, 4, 5])
def test_quorum_count_matches_insertion_sort(shim, P):
    pid, kind, match = _quorum_cases(P)
    n = pid.shape[0]
    res = np.empty((n, 2), np.int32)
    arrays = [np.ascontiguousarray(a) for a in (pid, kind, match)]
    shim.host_quorum(*[ctypes.c_void_p(a.ctypes.data) for a in arrays],
                     *_ints(P, n), ctypes.c_void_p(res.ctypes.data))
    assert np.array_equal(res[:, 0], res[:, 1])
    # numpy's sort agrees with the insertion sort
    voter = (pid != 0) & ((kind == PT.KIND_VOTER) | (kind == PT.KIND_WITNESS))
    q = voter.sum(1) // 2 + 1
    s = np.sort(np.where(voter, match, -1), axis=1)
    assert np.array_equal(res[:, 1], s[np.arange(n), P - q])
    none = voter.sum(1) == 0  # no voter at all: -1, as the sort gives
    assert none.any() and (res[none, 0] == -1).all()
    assert (voter.sum(1) == P).any()


def test_quorum_count_matches_insertion_sort_wide(shim):
    rng = np.random.default_rng(SEED)
    P, n = 16, 20_000
    pid = np.where(rng.random((n, P)) < 0.2, 0,
                   np.arange(1, P + 1, dtype=np.int32)).astype(np.int32)
    kind = rng.integers(0, 3, (n, P)).astype(np.int32)
    match = rng.integers(-3, 6, (n, P)).astype(np.int32)
    res = np.empty((n, 2), np.int32)
    shim.host_quorum(*[ctypes.c_void_p(a.ctypes.data)
                       for a in (pid, kind, match)],
                     *_ints(P, n), ctypes.c_void_p(res.ctypes.data))
    assert np.array_equal(res[:, 0], res[:, 1])


# the geometries the main paths launch at: (G, P, W, M, E, O, internal)
# -> rows a block
GEOMETRIES = [
    ((30_000, 5, 32, 8, 4, 32, False), 128),   # the kernels phase
    ((300_000, 3, 8, 12, 1, 8, True), 128),    # bench phase A
    ((512, 5, 32, 8, 4, 32, False), 32),       # NodeHost's engine
    ((4096, 3, 16, 20, 4, 32, False), 32),     # the colocated engine
    ((37_500, 3, 16, 14, 2, 16, False), 128),  # multichip leg 2, a block
]


@pytest.mark.parametrize("geom,R", GEOMETRIES,
                         ids=[f"G{g[0][0]}" for g in GEOMETRIES])
def test_rows_per_block_at_the_main_paths(geom, R):
    assert PK.rows_per_block(*geom) == R
    assert PK.smem_bytes(R, *geom[1:]) <= PK.SMEM_MAX
    G = geom[0]
    assert -(-G // R) >= PK.N_SM or R == PK.ROWS_PER_BLOCK[0]


def test_rows_per_block_raises_above_the_limit():
    # P = 16, W = 1024: 32 rows need more shared memory than a block has
    with pytest.raises(ValueError, match=str(PK.SMEM_MAX)):
        PK.rows_per_block(10_000, 16, 1024, 8, 4, 32)
    # W = 512 at P = 16 still fits blocks of 32 rows, not of 64
    assert PK.rows_per_block(10_000, 16, 512, 8, 4, 32) == 32
    assert PK.smem_bytes(64, 16, 512, 8, 4, 32) > PK.SMEM_MAX


@pytest.mark.parametrize("G", [0, 1, 7, 48])
def test_output_views_are_aligned_and_disjoint(G):
    # the wrapper's outputs: one allocation, cut into contiguous views
    # that each start on a 16-byte boundary and overlap no other
    shapes = ((G, 32, PT.N_FIELDS), (G,), (G,), (G, 5), (G, 8), (G, 8),
              (G, 8, 4), (G,), (G,), (G,))
    views = _native.alloc_views(shapes, "cpu")[1]
    assert [tuple(v.shape) for v in views] == [tuple(s) for s in shapes]
    base = views[0].untyped_storage().data_ptr()
    spans = []
    for v in views:
        assert v.is_contiguous() and v.dtype == torch.int32
        assert v.untyped_storage().data_ptr() == base  # one allocation
        off = v.storage_offset()
        assert off % 4 == 0
        spans.append((off, off + v.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def host_lane_pack(so, st, out, tabs, sup, *, me, D, E, B, XB, R, stage,
                   alive=None, alive_stride=1, packed=None, undeliv=None):
    """The shim's three-pass lane pack in blocks of R rows, a block
    staging up to ``stage`` packed rows; xbuf and the workspace start
    poisoned, so a word the passes leave unwritten shows.  The colocated
    operands (int32 numpy arrays) are updated in place; with them the
    stats row has ``N_LANE_STATS_X`` words."""
    G, O, _ = out["buf"].shape
    P, W = st["peer_id"].shape[1], st["ring_term"].shape[1]
    srcs = [np.ascontiguousarray(st[f]) for f in (
        "peer_id", "replica_id", "first_index", "last_index", "ring_term",
        "ring_cc")]
    xbuf = np.full((D, XB, route_ref.X_KF + 2 * E), POISON, np.int32)
    work = [np.full(tuple(v.shape), POISON, np.int32)
            for v in PRt._lane_work(G, D, R, "cpu")]
    n_stats = (route_ref.N_LANE_STATS if packed is None
               else route_ref.N_LANE_STATS_X)
    stats = np.full((n_stats,), POISON, np.int32)
    supw = np.ascontiguousarray(sup, np.int32)

    def ptr(a):
        return ctypes.c_void_p(None if a is None else a.ctypes.data)
    tabs = [np.ascontiguousarray(t, np.int32) for t in tabs]
    so.host_xlane_pack(
        _ptrs(srcs), ctypes.c_void_p(out["buf"].ctypes.data),
        ctypes.c_void_p(out["count"].ctypes.data),
        ctypes.c_void_p(supw.ctypes.data),
        *[ctypes.c_void_p(t.ctypes.data) for t in tabs],
        ctypes.c_void_p(xbuf.ctypes.data),
        *[ctypes.c_void_p(w.ctypes.data) for w in work],
        ctypes.c_void_p(stats.ctypes.data),
        *_ints(G, P, W, O, E, D, XB, B, me, R, stage), ptr(alive),
        *_ints(alive_stride), ptr(packed), ptr(undeliv), *_ints(n_stats))
    return xbuf, stats


# (n_dev, groups, outbox capacity): the first two at the lane fuzz's own
# size (one ragged block of 12 or 6 rows); 75 rows a device in blocks of
# 32 (two full, one ragged) with O = 40, walked in five chunks of 8; 16
# devices of 33 rows with O = 8 (one chunk)
LANE_CASES = [(2, 8, 12), (4, 8, 12), (4, 100, 40), (16, 176, 8)]


@pytest.mark.parametrize("n_dev,groups,O", LANE_CASES,
                         ids=["2", "4", "4-G300-O40", "16-G528-O8"])
def test_lane_rows_match_plain_versions(shim, n_dev, groups, O):
    rng = np.random.default_rng(SEED + 10 + n_dev + groups - 8)
    st, out, ib, tabs, sup, c = TM.lane_fuzz_inputs(rng, n_dev, groups, O=O)
    G, E, B, base = c["G"], c["E"], c["B"], c["base"]
    gl = G // n_dev
    sized = PRt.xbudget_for(tabs, B, n_dev)
    hit = np.zeros((route_ref.N_LANE_STATS,), np.int64)
    # blocks of 32 and 128 rows; every block's rows staged, none, and
    # some blocks' (a stage of 8 rows)
    for xb, R, stage in ((sized, 32, 32 * O), (sized, 128, 0),
                         (max(1, sized // 8), 32, 8)):
        for me in range(n_dev):
            rows = slice(me * gl, (me + 1) * gl)
            st_d = {k: np.ascontiguousarray(v[rows]) for k, v in st.items()}
            out_d = {k: np.ascontiguousarray(v[rows]) for k, v in out.items()}
            tabs_d = [np.ascontiguousarray(t[rows]) for t in tabs]
            xbuf, stats = host_lane_pack(
                shim, st_d, out_d, tabs_d, sup[rows], me=me, D=n_dev, E=E,
                B=B, XB=xb, R=R, stage=stage)
            w_xbuf, w_stats = route_ref.lane_pack(
                convert.state_from_numpy(st_d, "cpu"),
                convert.out_from_numpy(out_d, "cpu"),
                *(TM._t(t) for t in tabs_d), me=me, n_dev=n_dev, E=E,
                budget=B, xbudget=xb, suppress=torch.from_numpy(sup[rows]))
            assert np.array_equal(xbuf, w_xbuf.numpy()), (me, xb, R, stage)
            assert np.array_equal(stats, w_stats.numpy()), (me, xb, R, stats,
                                                            w_stats)
            hit += stats
            # scatter what the other devices packed for ``me`` into its
            # inbox block: all of their rows for it, found or not
            recv = np.ascontiguousarray(np.concatenate(
                [xbuf[(me + s) % n_dev] for s in range(1, n_dev)]))
            ib_d = {k: np.ascontiguousarray(v[rows]) for k, v in ib.items()}
            w_ib, w_n = route_ref.lane_scatter(
                convert.inbox_from_numpy(ib_d, "cpu"), torch.from_numpy(recv),
                budget=B, base=base)
            g_ib = [np.ascontiguousarray(ib_d[f]) for f in PT.Inbox._fields]
            sst = np.zeros((route_ref.N_LANE_STATS,), np.int32)
            shim.host_xlane_scatter(
                _ptrs(g_ib), ctypes.c_void_p(recv.ctypes.data),
                ctypes.c_void_p(sst.ctypes.data),
                *_ints(recv.shape[0], gl, c["M"], E, B, base))
            TM.assert_fields_equal(convert.to_numpy(w_ib),
                                   dict(zip(PT.Inbox._fields, g_ib)),
                                   f"scatter me={me} xb={xb}")
            assert sst[1] == int(w_n)
            hit[1] += sst[1]
    # every counter was reached
    assert (hit > 0).all(), hit


# (G, n_dev) -> rows a block of the lane's passes: the geometries the
# main paths launch the lane kernels' walk at
LANE_GEOMETRIES = {
    "C30000": ((30_000, 1), 128),   # colocated kernels: route's inputs
    "G4096": ((4096, 1), 32),       # the colocated engine's capacity
    "X37500": ((37_500, 4), 128),   # multichip leg 2, a block of 4
    "G8448": ((8_448, 4), 64),      # 132 blocks of 64 rows exactly
    "G100000": ((100_000, 4), 128),  # phase A's rows on four devices
}


@pytest.mark.parametrize("geom,want", LANE_GEOMETRIES.values(),
                         ids=LANE_GEOMETRIES.keys())
def test_lane_geometry_at_the_main_paths(geom, want):
    G, D = geom
    assert PRt.lane_rows_per_block(G, D) == want
    assert want in PRt.LANE_ROWS
    # every SM gets a block, unless the smallest blocks cannot give it one
    assert -(-G // want) >= PK.N_SM or want == PRt.LANE_ROWS[0]


def test_lane_geometry_raises_at_the_limits():
    with pytest.raises(ValueError, match="at most 16 devices"):
        PRt.lane_rows_per_block(37_500, 17)
    with pytest.raises(ValueError, match="at most 16 devices"):
        PRt.lane_rows_per_block(37_500, 0)
    # a grid too small for every SM takes the smallest blocks
    assert PRt.lane_rows_per_block(1, 16) == PRt.LANE_ROWS[0]


def _assert_one_aligned_allocation(views):
    """Every view lies in one allocation, starts on a 16-byte boundary
    and overlaps no other."""
    base = views[0].untyped_storage().data_ptr()
    spans = []
    for v in views:
        assert v.is_contiguous()
        assert v.untyped_storage().data_ptr() == base
        off = v.storage_offset() * v.element_size()
        assert off % 16 == 0
        spans.append((off, off + v.numel() * v.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("G", [0, 1, 7, 48])
def test_route_and_lane_views_are_aligned_and_disjoint(G):
    P, O, M, E, B = 5, 33, 22, 3, 4
    _flat, inbox = PRt.new_inbox(G, M, E, "cpu")
    scratch, cnt, stats, deliv = PRt._route_buffers(G, P, O, B, "cpu", True,
                                                    True)
    assert [tuple(t.shape) for t in inbox] == [(G, M)] * 10 + [(G, M, E)] * 2
    assert all(t.dtype == torch.int32 for t in inbox)
    _assert_one_aligned_allocation(list(inbox))
    assert scratch.numel() == G * P * B
    assert tuple(cnt.shape) == (G * P,) and tuple(stats.shape) == (7,)
    assert tuple(deliv.shape) == (G, O) and deliv.dtype == torch.bool
    _assert_one_aligned_allocation([scratch, cnt, stats, deliv])
    # without the optional outputs: scratch and cnt alone
    rest = PRt._route_buffers(G, P, O, B, "cpu", False, False)
    assert rest[2] is None and rest[3] is None
    _assert_one_aligned_allocation([rest[0], rest[1]])
    for D, R in ((4, 32), (16, 128)):
        work = PRt._lane_work(G, D, R, "cpu")
        nblk = -(-G // R)
        assert [tuple(w.shape) for w in work] == [
            (G, D), (nblk, D), (nblk, D), (nblk, 5), (D,)]
        _assert_one_aligned_allocation(work)
