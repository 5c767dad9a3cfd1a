"""The CUDA kernels' row logic, built as host C++, against the plain versions.

``csrc/raft_step.cu`` and ``csrc/xlane.cu`` compile as plain C++ when
there is no CUDA compiler: then only their per-row logic is built
(``dbt::ext::step_row``, ``dbt::gl::step_row`` — the file included a
second time with ``DBT_STEP_GL`` — ``dbt::xlane_row``,
``dbt::xlane_scatter_row``).
This file builds a small ``extern "C"`` shim around that logic with g++
into ``tmp_path``, calls it through ``ctypes`` and holds it against the
plain PyTorch versions on seeded inputs:

* the raft step in BOTH layouts: the external row logic against
  ``kernel_ref.step``, the G-last one against ``kernel_ref.step_internal``
  on the same rows, on a seeded cluster state under seeded fuzz inboxes
  over every hot message type;
* the lane's pack (the count pass, the scan, the write pass and the
  zero fill, in the kernel's order) against ``route_ref.lane_pack`` and
  its scatter against ``route_ref.lane_scatter``, on the lane fuzz of
  ``test_torch_mesh.py`` with a sized and an undersized ``xbudget``.

It checks the arithmetic and the layouts' addressing the kernels share
with the card; the CUDA launch itself runs only on the card
(``chip_smoke.py``).  Skips only when g++ is absent.  Tolerance: zero
(bit-exact).
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

import chip_smoke
import test_torch_mesh as TM
from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import kernel_ref
from dragonboat_tpu_torch.ops import route as PRt
from dragonboat_tpu_torch.ops import route_ref
from dragonboat_tpu_torch.ops import types as PT

torch = convert.torch
SEED = 20261018

SHIM = r"""
#include "raft_step.cu"
#define DBT_STEP_GL 1
#include "raft_step.cu"
#include "xlane.cu"

extern "C" {

void host_step(const int* const* st_in, int* const* st_out,
               const int* const* ib, int* const* out, int G, int P, int W,
               int M, int E, int O, int internal) {
  dbt::StepArgs a;
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_in[f] = st_in[f];
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_out[f] = st_out[f];
  for (int f = 0; f < dbt::N_INBOX; ++f) a.ib[f] = ib[f];
  for (int f = 0; f < dbt::N_OUT; ++f) a.out[f] = out[f];
  a.G = G; a.P = P; a.W = W; a.M = M; a.E = E; a.O = O;
  for (int g = 0; g < G; ++g) {
    if (internal) dbt::gl::step_row(a, g);
    else dbt::ext::step_row(a, g);
  }
}

// xlane_pack_launch's four passes, in order, on the host
void host_xlane_pack(const int* const* st, const int* buf, const int* count,
                     const int* suppress, const int* dest_local,
                     const int* dest_dev, const int* rank, int* xbuf,
                     int* scan, int* stats, int G, int P, int W, int O,
                     int E, int D, int XB, int B, int me) {
  dbt::XPackArgs a;
  a.peer_id = st[0]; a.replica_id = st[1]; a.first_index = st[2];
  a.last_index = st[3]; a.ring_term = st[4]; a.ring_cc = st[5];
  a.buf = buf; a.count = count; a.suppress = suppress;
  a.dest_local = dest_local; a.dest_dev = dest_dev; a.rank = rank;
  a.xbuf = xbuf; a.scan = scan; a.stats = stats;
  a.G = G; a.P = P; a.W = W; a.O = O; a.E = E; a.D = D; a.XB = XB;
  a.B = B; a.me = me;
  for (int i = 0; i < dbt::N_LANE_STATS; ++i) stats[i] = 0;
  int s[4] = {0, 0, 0, 0};
  for (int g = 0; g < G; ++g) dbt::xlane_row(a, g, s, false);
  stats[2] = s[0];
  stats[4] = s[1];
  stats[3] = s[2];
  stats[5] = s[3];
  dbt::xlane_scan_host(a);
  for (int g = 0; g < G; ++g) dbt::xlane_row(a, g, s, true);
  const long long total = (long long)D * XB * (dbt::X_KF + 2 * E);
  for (long long t = 0; t < total; ++t) dbt::xlane_zero_word(a, t);
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


def host_step(so, st: dict, ib: dict, O: int, internal: bool):
    """The shim's step on numpy fields of either layout."""
    G = st["term"].shape[0]
    ax = 0 if internal else 1
    P, W = st["peer_id"].shape[ax], st["ring_term"].shape[ax]
    M = ib["mtype"].shape[ax]
    E = ib["ent_term"].shape[1 if internal else 2]
    st_in = [np.ascontiguousarray(st[f]) for f in PT.DeviceState._fields]
    ib_in = [np.ascontiguousarray(ib[f]) for f in PT.Inbox._fields]
    st_out = [np.empty_like(a) for a in st_in]

    def shape(*dims):
        return (*dims, G) if internal else (G, *dims)

    out = {
        "buf": shape(O, PT.N_FIELDS), "count": (G,), "escalate": (G,),
        "need_snapshot": shape(P), "slot_base": shape(M),
        "slot_term": shape(M), "ent_drop": shape(M, E), "append_lo": (G,),
        "barrier_idx": (G,), "barrier_term": (G,),
    }
    outs = [np.empty(out[f], np.int32) for f in PT.DeviceOut._fields]
    so.host_step(_ptrs(st_in), _ptrs(st_out), _ptrs(ib_in), _ptrs(outs),
                 *_ints(G, P, W, M, E, O, internal))
    return (dict(zip(PT.DeviceState._fields, st_out)),
            dict(zip(PT.DeviceOut._fields, outs)))


@pytest.mark.parametrize("seed", range(2))
def test_step_row_both_layouts_match_plain_versions(shim, seed):
    rng = np.random.default_rng(SEED + seed)
    P, W, M, E, O = 5, 32, 8, 4, 32
    G = 48
    ext = chip_smoke.cluster_state_np(G, P, W, SEED + seed)
    out_np = {"buf": np.zeros((G, O, PT.N_FIELDS), np.int32),
              "count": np.zeros((G,), np.int32)}
    for k in range(16):
        # routed steps first (elections and commits), then fuzz
        ib_ext = (chip_smoke.route_np(ext, out_np, rng, M, E) if k < 12
                  else chip_smoke.fuzz_inbox_np(ext, rng, M, E))
        st_t = convert.state_from_numpy(ext, "cpu")
        ib_t = convert.inbox_from_numpy(ib_ext, "cpu")
        want_st, want_out = kernel_ref.step(st_t, ib_t, O)
        got_st, got_out = host_step(shim, ext, ib_ext, O, internal=False)
        TM.assert_fields_equal(convert.to_numpy(want_st), got_st,
                               f"external state step {k}")
        TM.assert_fields_equal(convert.to_numpy(want_out), got_out,
                               f"external out step {k}")
        ist = convert.to_numpy(convert.state_to_internal(st_t))
        iib = convert.to_numpy(convert.inbox_to_internal(ib_t))
        wi_st, wi_out = kernel_ref.step_internal(
            convert.state_from_numpy(ist, "cpu"),
            convert.inbox_from_numpy(iib, "cpu"), O)
        gi_st, gi_out = host_step(shim, ist, iib, O, internal=True)
        TM.assert_fields_equal(convert.to_numpy(wi_st), gi_st,
                               f"internal state step {k}")
        TM.assert_fields_equal(convert.to_numpy(wi_out), gi_out,
                               f"internal out step {k}")
        ext, out_np = got_st, got_out
        if k == 11:  # the routed steps elected leaders
            leaders = int((ext["role"] == PT.ROLE_LEADER).sum())
    assert leaders >= G // 6, leaders


def host_lane_pack(so, st, out, tabs, sup, *, me, D, E, B, XB):
    G, O, _ = out["buf"].shape
    P, W = st["peer_id"].shape[1], st["ring_term"].shape[1]
    srcs = [np.ascontiguousarray(st[f]) for f in (
        "peer_id", "replica_id", "first_index", "last_index", "ring_term",
        "ring_cc")]
    xbuf = np.full((D, XB, route_ref.X_KF + 2 * E), -7, np.int32)
    scan = np.empty((G * D + D,), np.int32)
    stats = np.empty((route_ref.N_LANE_STATS,), np.int32)
    supw = np.ascontiguousarray(sup, np.int32)
    tabs = [np.ascontiguousarray(t, np.int32) for t in tabs]
    so.host_xlane_pack(
        _ptrs(srcs), ctypes.c_void_p(out["buf"].ctypes.data),
        ctypes.c_void_p(out["count"].ctypes.data),
        ctypes.c_void_p(supw.ctypes.data),
        *[ctypes.c_void_p(t.ctypes.data) for t in tabs],
        ctypes.c_void_p(xbuf.ctypes.data), ctypes.c_void_p(scan.ctypes.data),
        ctypes.c_void_p(stats.ctypes.data),
        *_ints(G, P, W, O, E, D, XB, B, me))
    return xbuf, stats


@pytest.mark.parametrize("n_dev", [2, 4])
def test_lane_rows_match_plain_versions(shim, n_dev):
    rng = np.random.default_rng(SEED + 10 + n_dev)
    st, out, ib, tabs, sup, c = TM.lane_fuzz_inputs(rng, n_dev)
    G, E, B, base = c["G"], c["E"], c["B"], c["base"]
    gl = G // n_dev
    sized = PRt.xbudget_for(tabs, B, n_dev)
    hit = np.zeros((route_ref.N_LANE_STATS,), np.int64)
    for xb in (sized, max(1, sized // 8)):
        for me in range(n_dev):
            rows = slice(me * gl, (me + 1) * gl)
            st_d = {k: np.ascontiguousarray(v[rows]) for k, v in st.items()}
            out_d = {k: np.ascontiguousarray(v[rows]) for k, v in out.items()}
            tabs_d = [np.ascontiguousarray(t[rows]) for t in tabs]
            xbuf, stats = host_lane_pack(
                shim, st_d, out_d, tabs_d, sup[rows], me=me, D=n_dev, E=E,
                B=B, XB=xb)
            w_xbuf, w_stats = route_ref.lane_pack(
                convert.state_from_numpy(st_d, "cpu"),
                convert.out_from_numpy(out_d, "cpu"),
                *(TM._t(t) for t in tabs_d), me=me, n_dev=n_dev, E=E,
                budget=B, xbudget=xb, suppress=torch.from_numpy(sup[rows]))
            assert np.array_equal(xbuf, w_xbuf.numpy()), (me, xb)
            assert np.array_equal(stats, w_stats.numpy()), (me, xb, stats,
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
