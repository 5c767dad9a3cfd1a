"""place_rows' and select_and_blob's block logic, as host C++, against the plain versions.

``csrc/place_rows.cu`` and ``csrc/select_blob.cu`` compile as plain C++
when there is no CUDA compiler: then their block logic (``place_args``,
``place_tile``, ``place_units``, ``place_pos``, ``place_load``,
``place_store``; ``merge_args``, ``merge_slot``, ``merge_load``,
``merge_store``; ``snap_word``; ``sel_args``, ``sel_mask``,
``prefix_word``, ``sel_rank``, ``det_load``, ``det_store``) is host code.
This file builds a small ``extern "C"`` shim around that logic with g++
into ``tmp_path``, calls it through ``ctypes`` and holds it against the
plain PyTorch versions on seeded inputs, every output starting poisoned:

* ``place_rows`` in rows mode (scatter with a dst, gather without one,
  select, the escalation select, a pos past the source's last row),
  block by block over the grid the launcher sizes (every group of
  folded fields, every row tile, ragged last tiles), with fields of
  widths 1, 3, 5, 32 and 352, sources and dsts at 16-byte aligned and
  at unaligned addresses, together and each alone; the words between
  the output views stay
  poisoned, and every 16-byte load and store lies on a 16-byte boundary
  (the host build counts those that do not: the card would fault);
* the in-place escalation merge at 0, a few and all rows escalated,
  the warps' ballots made from the rows' flags, against
  ``engine_ref.merge_escalated`` and ``select_escalated``;
* the snapshot store against ``engine_ref.set_remote_snapshot``;
* ``select_and_blob`` in its three passes (count, then scan, then
  write, block by block; the write pass's ballots made from the rows'
  mask bits) against ``colocated_ref.select_and_blob``: G not a multiple
  of the block, capacities below, at and above the counts, no row and
  every row selected, the buf and ring rows at aligned and unaligned
  addresses; the values block (gather_pack's) stays poisoned, and no
  16-byte access is misaligned;
* the FastDiv the kernels divide with, exhaustively at small n and at
  the top of its range;
* the wrappers' allocations: the outputs of a row move, and the head,
  detail and scratch of ``select_and_blob``, are views of one buffer,
  16-byte aligned and disjoint.

It checks the arithmetic and the addressing the kernels share with the
card; the CUDA launches themselves run only on the card
(``chip_smoke.py``).  Skips only when g++ is absent.  Tolerance: zero
(bit-exact).
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import colocated as PC
from dragonboat_tpu_torch.ops import colocated_ref as CR
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import engine_ref
from dragonboat_tpu_torch.ops import types as PT

torch = convert.torch
SEED = 20261019
POISON = -0x5EED

SHIM = r"""
#include <algorithm>
#include <utility>
#include <vector>

#include "place_rows.cu"
#include "select_blob.cu"

static const int POISON = -0x5EED;

extern "C" {

// place_rows, block by block over the launcher's grid; grid[0..1] =
// (tiles, groups)
int host_place(const int* pos, const int* const* dst, const int* const* src,
               int* out, const long long* off, const int* width, int n,
               int G_out, int G_src, int* grid) {
  dbt::PlaceArgs a;
  const int rc = dbt::place_args(a, pos, dst, src, out, off, width, n, G_out,
                                 G_src);
  if (rc) return rc;
  grid[0] = a.tiles;
  grid[1] = a.n_groups;
  std::vector<int> spos(dbt::PR_ROWS_MAX);
  int ubase[dbt::MAX_FIELDS + 1];
  for (int y = 0; y < a.n_groups; ++y) {
    for (int x = 0; x < a.tiles; ++x) {
      dbt::PlaceTile t;
      if (!dbt::place_tile(a, y, x, t)) continue;
      std::fill(spos.begin(), spos.end(), POISON);
      std::fill(ubase, ubase + dbt::MAX_FIELDS + 1, POISON);
      dbt::place_units(a, t, ubase);
      for (int r = 0; r < t.rows; ++r) spos[r] = dbt::place_pos(a, t.r0 + r);
      const int total = ubase[t.nf];
      // each thread's batch: PR_BATCH units loaded, then stored
      const int T = dbt::PR_THREADS, step = T * dbt::PR_BATCH;
      for (int j0 = 0; j0 < total; j0 += step) {
        for (int th = 0; th < T; ++th) {
          dbt::PlaceUnit u[dbt::PR_BATCH];
          for (int b = 0; b < dbt::PR_BATCH; ++b) {
            const int j = j0 + th + b * T;
            if (j < total) dbt::place_load(a, t, ubase, spos.data(), j, u[b]);
          }
          for (int b = 0; b < dbt::PR_BATCH; ++b)
            if (j0 + th + b * T < total) dbt::place_store(a, t, u[b]);
        }
      }
    }
  }
  return 0;
}

// the in-place merge, block by block: each warp's ballot of flagged
// rows, then the block's flattened copy; *copied = the rows copied
int host_merge(const int* esc, const int* const* old_, int* const* new_,
               const int* width, int n, int G, int* copied) {
  dbt::MergeArgs a;
  const int rc = dbt::merge_args(a, esc, old_, new_, width, n, G);
  if (rc) return rc;
  std::vector<int> rows(dbt::PM_ROWS);
  int col[dbt::MAX_FIELDS + 1];
  *copied = 0;
  const int T = dbt::PR_THREADS;
  for (unsigned b = 0; b < dbt::merge_blocks(a); ++b) {
    std::fill(rows.begin(), rows.end(), POISON);
    const int g0 = (int)b * dbt::PM_ROWS;
    int k = 0;
    for (int r0 = 0; r0 < dbt::PM_ROWS; r0 += T) {
      for (int w = 0; w < T / 32; ++w) {
        uint32_t m = 0;
        for (int l = 0; l < 32; ++l) {
          const int g = g0 + r0 + w * 32 + l;
          if (g < G && esc[g] != 0) m |= 1u << l;
        }
        if (!m) continue;
        const int base = k;
        k += __builtin_popcount(m);
        for (int l = 0; l < 32; ++l)
          if ((m >> l) & 1u)
            rows[dbt::merge_slot(m, l, base)] = g0 + r0 + w * 32 + l;
      }
    }
    if (!k) continue;
    for (int i = 0; i <= n; ++i) col[i] = a.col[i];
    const int total = k * a.rdiv.d;
    for (int j = 0; j < total; ++j) {
      dbt::MergeItem it;
      dbt::merge_load(a, rows.data(), col, j, it);
      dbt::merge_store(a, it);
    }
    *copied += k;
  }
  return 0;
}

void host_snapshot(const int* rstate, const int* snap_index,
                   const int* g_idx, const int* p_idx, const int* snap,
                   int* out_rstate, int* out_snap, int G, int P, int n) {
  dbt::SnapArgs s;
  s.rstate = rstate; s.snap_index = snap_index; s.g_idx = g_idx;
  s.p_idx = p_idx; s.snap = snap; s.out_rstate = out_rstate;
  s.out_snap = out_snap; s.G = G; s.P = P; s.n = n;
  for (int t = 0; t < G * P; ++t)
    dbt::snap_word(s, t / P, t % P, out_rstate + t, out_snap + t);
}

// select_and_blob's three passes, in the kernels' order, block by block
int host_select(const int* flags, const int* combo, const int* packed,
                const int* stats, const int* const* srcs, int* head,
                int* detail, unsigned char* mask, int* btot, int* boff,
                const int* caps, int G, int nw, int O, int Mo, int E, int P,
                int W, int host_off) {
  dbt::SelArgs a;
  const int rc = dbt::sel_args(a, flags, combo, packed, stats, srcs, head,
                               detail, mask, btot, boff, caps, G, nw, O, Mo,
                               E, P, W, host_off);
  if (rc) return rc;
  const int T = dbt::SB_THREADS, NK = dbt::SB_NK, NW = T / 32;
  // 1. count: a row a thread, the block totals; the head prefix
  for (int b = 0; b < a.nb; ++b) {
    int tot[dbt::SB_NK] = {0, 0, 0, 0, 0};
    for (int t = 0; t < T; ++t) {
      const int g = b * T + t;
      const int m = g < G ? dbt::sel_mask(a, g) : 0;
      if (g < G) mask[g] = (unsigned char)m;
      for (int k = 0; k < NK; ++k) tot[k] += (m >> k) & 1;
    }
    for (int k = 0; k < NK; ++k) btot[b * NK + k] = tot[k];
  }
  for (long long i = 0; i < dbt::prefix_words(a); ++i)
    head[i] = dbt::prefix_word(a, i);
  // 2. scan: the block offsets and the counts
  for (int k = 0; k < NK; ++k) {
    int run = 0;
    for (int b = 0; b < a.nb; ++b) {
      boff[b * NK + k] = run;
      run += btot[b * NK + k];
    }
    head[dbt::prefix_words(a) + k] = run;
  }
  // 3. write: each warp's ballot of its rows' bits, the warps' exclusive
  // counts, the ranks; then the listed rows' detail words
  for (int b = 0; b < a.nb; ++b) {
    uint32_t bal[NW][dbt::SB_NK];
    int wpre[NW][dbt::SB_NK];
    for (int w = 0; w < NW; ++w)
      for (int k = 0; k < NK; ++k) {
        bal[w][k] = 0;
        for (int l = 0; l < 32; ++l) {
          const int g = b * T + w * 32 + l;
          const int m = g < G ? mask[g] : 0;
          bal[w][k] |= (uint32_t)((m >> k) & 1) << l;
        }
      }
    for (int k = 0; k < NK; ++k) {
      int run = 0;
      for (int w = 0; w < NW; ++w) {
        wpre[w][k] = run;
        run += __builtin_popcount(bal[w][k]);
      }
    }
    std::vector<std::pair<int, int>> list[dbt::SB_ND];
    for (int t = 0; t < T; ++t) {
      const int g = b * T + t, w = t / 32, l = t % 32;
      const int m = g < G ? mask[g] : 0;
      for (int k = 0; k < NK; ++k) {
        const bool sel = (m >> k) & 1;
        const int before = boff[b * NK + k] + wpre[w][k] +
                           dbt::bits_below(bal[w][k], l);
        const int tot = head[dbt::prefix_words(a) + k];
        const int rank = g < G ? dbt::sel_rank(tot, g, sel, before) : 0;
        const bool keep = g < G && rank < a.cap[k];
        if (keep) head[dbt::head_rows_at(a, k) + rank] = g;
        if (keep && k < dbt::SB_ND) list[k].push_back({rank, g});
      }
    }
    int base[dbt::SB_ND + 1];
    int n = 0;
    for (int k = 0; k < dbt::SB_ND; ++k) {
      base[k] = n;
      n += (int)list[k].size() * a.ddiv[k].d;
    }
    base[dbt::SB_ND] = n;
    for (int j = 0; j < n; ++j) {
      int k, e, u;
      dbt::det_item(a, base, j, &k, &e, &u);
      long long at;
      dbt::Quad q;
      dbt::det_load(a, k, list[k][e].first, list[k][e].second, u, &q, &at);
      dbt::det_store(a, k, at, q);
    }
  }
  return 0;
}

// the host build's 16-byte loads and stores at a misaligned address
long long host_misaligned() { return dbt::misaligned_quads(); }

// n / d by the kernels' FastDiv for n in [0, n_max) and the 4096 values
// below 2^31; the number that differ from integer division
long long host_fdiv_errors(int d, int n_max) {
  const dbt::FastDiv f = dbt::fast_div(d);
  long long bad = 0;
  for (int n = 0; n < n_max; ++n) bad += dbt::fdiv(f, n) != n / d;
  for (int n = 2147483647; n > 2147483647 - 4096; --n)
    bad += dbt::fdiv(f, n) != n / d;
  return bad;
}

}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    d = tmp_path_factory.mktemp("host_place")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_native.CSRC),
         "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    for fn in ("host_place", "host_merge", "host_select"):
        getattr(so, fn).restype = ctypes.c_int
    so.host_snapshot.restype = None
    so.host_fdiv_errors.restype = ctypes.c_longlong
    so.host_misaligned.restype = ctypes.c_longlong
    return so


def _p(t: torch.Tensor):
    """A (contiguous int32 CPU) tensor's data pointer."""
    assert t.dtype == torch.int32 and t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(*vals):
    return [ctypes.c_int(int(v)) for v in vals]


def _rand(rng, shape, lo=-1000, hi=1000, unaligned=False):
    """Seeded int32 values as a CPU tensor; ``unaligned`` places it one
    word past a 16-byte boundary."""
    n = int(np.prod(shape))
    vals = torch.from_numpy(rng.integers(lo, hi, n, dtype=np.int32))
    if not unaligned:
        return vals.reshape(shape).clone()
    buf = torch.empty(n + 4, dtype=torch.int32)
    t = buf[1:n + 1]
    t.copy_(vals)
    assert t.data_ptr() % 16 != 0
    return t.view(shape)


def host_place(so, dst, src, pos):
    """The shim's row move into one poisoned allocation cut as the
    wrapper cuts it; returns (views, the allocation, the views' words)."""
    G_out = pos.shape[0]
    shapes = tuple((G_out,) + tuple(s.shape[1:]) for s in src)
    flat, views, offs = _native.alloc_views(shapes, "cpu")
    flat.fill_(POISON)
    width = [int(np.prod(s.shape[1:])) for s in src]
    n = len(src)
    grid = (ctypes.c_int * 2)()
    rc = so.host_place(
        _p(pos), _ptrs(dst) if dst is not None else None, _ptrs(src),
        _p(flat), (ctypes.c_longlong * n)(*offs), (ctypes.c_int * n)(*width),
        *_ints(n, G_out, src[0].shape[0]), grid)
    assert rc == 0
    # every 16-byte load and store lay where the card can make it
    assert so.host_misaligned() == 0
    used = torch.zeros(flat.numel(), dtype=torch.bool)
    for v, o in zip(views, offs):
        used[o:o + v.numel()] = True
    return views, flat, used, tuple(grid)


def _fields(rng, G, widths, unaligned=False):
    return [_rand(rng, (G,) if w == 1 else (G, w), unaligned=unaligned)
            for w in widths]


WIDTHS = {
    "state": [1] * 21 + [5] * 8 + [32] * 2,
    "mixed": [3, 1, 352, 5, 1, 32, 1, 3],
    "wide": [352],
    "ones": [1, 1, 1],
}


@pytest.mark.parametrize("G", [1, 7, 133, 1031])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("unaligned", [False, True])
def test_place_rows_blocks_match_plain_versions(shim, G, widths, unaligned):
    rng = np.random.default_rng([SEED, G, len(WIDTHS[widths]), unaligned])
    ws = WIDTHS[widths]
    old = _fields(rng, G, ws, unaligned)
    new = _fields(rng, G, ws, unaligned)
    cases = []
    # scatter: a few rows from a sub batch (a pos past its last row
    # reads the last row; any negative pos keeps dst)
    n_sub = max(1, G // 5)
    sub = _fields(rng, n_sub, ws, unaligned)
    pos = np.full(G, -1, np.int32)
    rows = rng.choice(G, size=min(G, n_sub + 2), replace=False)
    pos[rows] = rng.integers(0, n_sub + 3, rows.size)
    pos[rng.random(G) < 0.1] = -7
    cases.append((old, sub, torch.from_numpy(pos)))
    # select: keep new where pos = g
    keep = np.where(rng.random(G) < 0.8, np.arange(G), -1).astype(np.int32)
    cases.append((old, new, torch.from_numpy(keep)))
    # gather: no dst, an index set with repeats, past the last row
    idx = rng.integers(0, G + 3, max(1, G // 3)).astype(np.int32)
    cases.append((None, new, torch.from_numpy(idx)))
    for dst, src, p in cases:
        views, flat, used, grid = host_place(shim, dst, src, p)
        want = engine_ref.place_rows(dst, src, p)
        for f, (a, b) in enumerate(zip(views, want)):
            assert torch.equal(a, b), (widths, G, f)
        assert (flat[~used] == POISON).all()
        assert grid[1] >= 1 and grid[0] >= 1
    # the escalation select: rows mode keeping old where escalate != 0
    esc = torch.from_numpy(np.where(rng.random(G) < 0.3,
                                    rng.integers(1, 16, G), 0)
                           .astype(np.int32))
    views, flat, used, _g = host_place(shim, old, new, _esc_pos(esc))
    want = engine_ref.select_escalated(esc, old, new)
    for a, b in zip(views, want):
        assert torch.equal(a, b)
    assert (flat[~used] == POISON).all()


def _esc_pos(esc):
    """The rows-mode pos of the escalation select (dst old, src new):
    -1 (keep old) where ``esc`` is nonzero, else the row itself."""
    return torch.where(esc != 0, -1, torch.arange(esc.shape[0],
                                                  dtype=torch.int32))


@pytest.mark.parametrize("G", [7, 133, 1031])
@pytest.mark.parametrize("misaligned", ["dst", "src"])
def test_place_rows_mixed_alignment_matches_plain_versions(shim, G,
                                                            misaligned):
    # dst and src on different alignments: a unit whose rows keep dst
    # while dst cannot take 16-byte loads must not read src, and one that
    # reads src must not take 16-byte loads from a misaligned src
    rng = np.random.default_rng([SEED, G, len(misaligned)])
    ws = [32, 1, 5, 32]
    old = _fields(rng, G, ws, unaligned=misaligned == "dst")
    new = _fields(rng, G, ws, unaligned=misaligned == "src")
    sub = _fields(rng, max(1, G // 5), ws, unaligned=misaligned == "src")
    pos = np.full(G, -1, np.int32)
    rows = rng.choice(G, size=min(G, sub[0].shape[0]), replace=False)
    pos[rows] = rng.integers(0, sub[0].shape[0], rows.size)
    keep = np.where(rng.random(G) < 0.5, np.arange(G), -1).astype(np.int32)
    esc = torch.from_numpy(np.where(rng.random(G) < 0.3, 3, 0)
                           .astype(np.int32))
    cases = [(sub, torch.from_numpy(pos),
              engine_ref.place_rows(old, sub, torch.from_numpy(pos))),
             (new, torch.from_numpy(keep),
              engine_ref.place_rows(old, new, torch.from_numpy(keep))),
             (new, _esc_pos(esc), engine_ref.select_escalated(esc, old, new))]
    for src, p, want in cases:
        views, flat, used, _g = host_place(shim, old, src, p)
        for f, (a, b) in enumerate(zip(views, want)):
            assert torch.equal(a, b), (misaligned, G, f)
        assert (flat[~used] == POISON).all()


def test_place_rows_folds_fields_into_groups(shim):
    # the state's 21 [G] fields and 2 of its [G, 5] fields fold into one
    # group, six [G, 5] into the next, each ring its own: 4 groups whose
    # tiles hold about the same words
    rng = np.random.default_rng(SEED)
    G = 30_000
    ws = WIDTHS["state"]
    src = _fields(rng, 64, ws)
    pos = torch.from_numpy(rng.integers(-1, 64, G).astype(np.int32))
    views, _flat, _used, grid = host_place(shim, None, src, pos)
    assert grid == (235, 4)
    for a, b in zip(views, engine_ref.place_rows(None, src, pos)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("G", [5, 1024, 1500, 4099])
@pytest.mark.parametrize("frac", [0.0, "few", 0.1, 1.0])
def test_merge_in_place_matches_plain_versions(shim, G, frac):
    rng = np.random.default_rng([SEED, G, 7])
    ws = WIDTHS["mixed"]
    old = _fields(rng, G, ws)
    new = _fields(rng, G, ws)
    if frac == "few":
        esc = np.zeros(G, np.int32)
        esc[rng.choice(G, size=3, replace=False)] = rng.integers(1, 9, 3)
    else:
        esc = np.where(rng.random(G) < frac, rng.integers(1, 9, G), 0)
    esc = torch.from_numpy(esc.astype(np.int32))
    want_sel = engine_ref.select_escalated(esc, old, new)
    want_new = [t.clone() for t in new]
    engine_ref.merge_escalated(esc, old, want_new)
    copied = ctypes.c_int(-1)
    n = len(ws)
    rc = shim.host_merge(_p(esc), _ptrs(old), _ptrs(new),
                         (ctypes.c_int * n)(*ws), *_ints(n, G),
                         ctypes.byref(copied))
    assert rc == 0
    assert copied.value == int((esc != 0).sum())
    for a, b, c in zip(new, want_new, want_sel):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_snapshot_matches_plain_version(shim):
    rng = np.random.default_rng(SEED + 1)
    G, P = 37, 5
    rstate = _rand(rng, (G, P), 0, 4)
    snap_index = _rand(rng, (G, P))
    # repeated pairs (the last wins), negative indexes, pairs outside
    g_idx = torch.tensor([3, -1, 3, 40, 0, 5], dtype=torch.int32)
    p_idx = torch.tensor([1, -2, 1, 0, 7, 0], dtype=torch.int32)
    snap = torch.tensor([11, 12, 13, 14, 15, 16], dtype=torch.int32)
    rs = torch.full((G, P), POISON, dtype=torch.int32)
    sn = torch.full((G, P), POISON, dtype=torch.int32)
    shim.host_snapshot(_p(rstate), _p(snap_index), _p(g_idx), _p(p_idx),
                       _p(snap), _p(rs), _p(sn), *_ints(G, P, 6))
    want = engine_ref.set_remote_snapshot(rstate, snap_index, g_idx, p_idx,
                                          snap)
    assert torch.equal(rs, want[0]) and torch.equal(sn, want[1])


# ---------------------------------------------------------------------------
# select_and_blob
# ---------------------------------------------------------------------------
SP, SW, SE, SO, SMO, HOST_OFF = 5, 32, 4, 32, 28, 20


def _sel_inputs(rng, G, kind, unaligned=False):
    """Flags and the combo lanes (``kind``: "mixed", "none" selected,
    "all" selected), a random merged state and outbox, route stats and
    delivered bits; ``unaligned``: the buf and ring rows one word past a
    16-byte boundary (the write pass then moves them word by word)."""
    st = PT.DeviceState(*(
        _rand(rng, tuple(t.shape),
              unaligned=unaligned and f.startswith("ring"))
        for f, t in zip(PT.DeviceState._fields,
                        PT.make_state(G, SP, SW, device="cpu"))))
    shapes = dict(buf=(G, SO, PT.N_FIELDS), need_snapshot=(G, SP),
                  slot_base=(G, SMO), slot_term=(G, SMO),
                  ent_drop=(G, SMO, SE))
    out = PT.DeviceOut(*(_rand(rng, shapes.get(f, (G,)),
                               unaligned=unaligned and f == "buf")
                         for f in PT.DeviceOut._fields))
    combo = np.zeros((G, 4), np.int32)
    if kind == "mixed":
        flags = rng.integers(0, 128, G).astype(np.int32)
        combo[:, :3] = rng.random((G, 3)) < (0.9, 0.4, 0.15)
    elif kind == "none":
        flags = np.full(G, PT.F_ESC, np.int32)
    else:
        flags = np.full(G, PT.F_ANY_LIVE, np.int32)
        combo[:, :3] = 1
    combo[:, 3] = rng.integers(0, 4, G)
    nw = (SO + 31) // 32
    packed = _rand(rng, (G, nw), -2**31, 2**31 - 1)
    stats = _rand(rng, (6,))
    return (st, out, stats, packed, torch.from_numpy(flags),
            torch.from_numpy(combo))


def _host_select(so, st, out, stats, packed, flags, combo, caps):
    G = flags.shape[0]
    nw = packed.shape[1]
    n_head, n_detail = PC._blob_sizes(G, SO, SMO, SE, SP, SW, caps, HOST_OFF)
    _flat, (head, detail, scratch), _offs = _native.alloc_views(
        ((n_head,), (n_detail,), (PC._sel_scratch_words(G),)), "cpu")
    for t in (head, detail, scratch):
        t.fill_(POISON)
    nb = -(-G // PC._SEL_BLOCK_ROWS)
    srcs = [out.buf, out.slot_base, out.slot_term, out.ent_drop,
            out.need_snapshot, st.ring_term, st.ring_cc]
    mask = ctypes.c_void_p(scratch.data_ptr() + 4 * 10 * nb)
    rc = so.host_select(
        _p(flags), _p(combo), _p(packed), _p(stats), _ptrs(srcs), _p(head),
        _p(detail), mask, _p(scratch), ctypes.c_void_p(
            scratch.data_ptr() + 4 * 5 * nb),
        (ctypes.c_int * 5)(*caps), *_ints(G, nw, SO, SMO, SE, SP, SW,
                                          HOST_OFF))
    assert rc == 0
    assert so.host_misaligned() == 0
    return head, detail


@pytest.mark.parametrize("G", [1, 255, 257, 1000, 3001])
@pytest.mark.parametrize("kind", ["mixed", "none", "all", "unaligned"])
def test_select_and_blob_passes_match_plain_version(shim, G, kind):
    rng = np.random.default_rng([SEED, G, len(kind)])
    args = _sel_inputs(rng, G, "mixed" if kind == "unaligned" else kind,
                       unaligned=kind == "unaligned")
    counts = [int(s.sum()) for s in CR.selection_masks(args[4], args[5])]
    tiers = [tuple(min(G, t[k]) for k in ("b", "sl", "n", "a", "s"))
             for t in PC._SEL_TIERS]
    # capacities below, at and above the counts, and none at all
    tiers += [tuple(max(0, min(G, c - 1)) for c in counts),
              tuple(min(G, c) for c in counts),
              tuple(min(G, c + 2) for c in counts), (0, 0, 0, 0, 0)]
    nw = args[3].shape[1]
    for caps in tiers:
        head, detail = _host_select(shim, *args, caps)
        want_h, want_d = CR.select_and_blob(
            *args, CAP_B=caps[0], CAP_SL=caps[1], CAP_N=caps[2],
            CAP_A=caps[3], CAP_S=caps[4], HOST_OFF=HOST_OFF)
        off_vals = G + G * nw + 11 + sum(caps)
        assert torch.equal(head[:off_vals], want_h[:off_vals]), (G, kind, caps)
        assert (head[off_vals:] == POISON).all()  # gather_pack's block
        assert torch.equal(detail, want_d), (G, kind, caps)
        assert head[G + G * nw + 6:G + G * nw + 11].tolist() == counts


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 11, 32, 48, 125, 352, 4096,
                               65_537, 1_000_003, 2**31 - 1])
def test_fast_div_is_exact(shim, d):
    assert shim.host_fdiv_errors(ctypes.c_int(d), ctypes.c_int(200_000)) == 0


def _assert_one_aligned_allocation(views):
    """Every view lies in one allocation, starts on a 16-byte boundary
    and overlaps no other."""
    base = views[0].untyped_storage().data_ptr()
    spans = []
    for v in views:
        assert v.is_contiguous() and v.dtype == torch.int32
        assert v.untyped_storage().data_ptr() == base
        off = v.storage_offset() * v.element_size()
        assert off % 16 == 0
        spans.append((off, off + v.numel() * v.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("G", [0, 1, 7, 30_000])
def test_wrapper_allocations_are_one_aligned_buffer(G):
    # a row move's outputs: the state's fields
    shapes = tuple(tuple(t.shape) for t in PT.make_state(G, 5, 32,
                                                         device="cpu"))
    flat, views, offs = _native.alloc_views(shapes, "cpu")
    assert [tuple(v.shape) for v in views] == list(shapes)
    _assert_one_aligned_allocation(views)
    assert [v.storage_offset() for v in views] == list(offs)
    assert flat.untyped_storage().data_ptr() == \
        views[0].untyped_storage().data_ptr()
    # select_and_blob's head, detail and scratch
    caps = tuple(min(G, c) for c in (16, 64, 8, 64, 1024))
    n_head, n_detail = PC._blob_sizes(G, SO, SMO, SE, SP, SW, caps, HOST_OFF)
    parts = _native.alloc_views(
        ((n_head,), (n_detail,), (PC._sel_scratch_words(G),)), "cpu")[1]
    assert [p.numel() for p in parts] == [n_head, n_detail,
                                          PC._sel_scratch_words(G)]
    _assert_one_aligned_allocation(parts)


def test_row_move_shapes_are_checked():
    # the CUDA wrappers' shape checks (cached per shape list), reached
    # here directly since CPU tensors take the plain versions
    from dragonboat_tpu_torch.ops import plumbing as PP

    st = PT.make_state(7, 5, 32, device="cpu")
    shapes = PP._shapes(st)
    assert PP._row_shapes("t", 3, shapes, None, False) == tuple(
        (3,) + tuple(s[1:]) for s in shapes)
    assert PP._row_shapes("t", 7, shapes, shapes, True) == tuple(shapes)
    bad = [
        (3, shapes, shapes, False),          # dst rows differ from the output
        (3, shapes, None, True),             # a merge over other row counts
        (3, shapes[:1] + (torch.Size([6]),), None, False),  # source rows
        (3, (torch.Size([0]),), None, False),  # no source row to place
        (3, shapes + shapes[:2], None, False),  # more than 32 fields
        (7, shapes, shapes[:-1] + (torch.Size([7, 31]),), True),
    ]
    for G_out, src, dst, same in bad:
        with pytest.raises(ValueError):
            PP._row_shapes("t", G_out, src, dst, same)
