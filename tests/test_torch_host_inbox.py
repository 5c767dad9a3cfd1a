"""The inbox kernels' block logic, as host C++, against the plain versions.

``csrc/inbox.cu`` compiles as plain C++ when there is no CUDA compiler:
then its block logic (``fill_args``, ``fill_blocks``, ``fill_unit``,
``fill_store``; ``copy_args``, ``copy_tile``, ``copy_alive``,
``copy_load``, ``copy_store``) and ``inbox_layout`` (``csrc/launch.h``)
are host code.  This file builds a small ``extern "C"`` shim around that
logic with g++ into a temporary directory, calls it through ``ctypes``
and holds it against ``colocated_ref`` on seeded inputs, every output
starting poisoned:

* ``host_inbox_from_ticks`` (the fill), its grid-stride loop run block
  by block and thread by thread over the grid the launcher sizes;
* ``assemble_inbox`` with 0, some and all rows dead, and the
  fused wave's all-zero combo, and ``zero_inbox_rows``, block by block
  over the copy's 1-D (plane, row tile) grid;
* at aligned and unaligned geometries (PB, Mh, E in {1, 3, 4}, row
  counts that leave a ragged last tile), with the sources at 16-byte
  aligned and at unaligned addresses;
* no 16-byte load or store at a misaligned address (the host build
  counts those: the card would fault), and the words between the plane
  views stay poisoned;
* the inbox allocator (``route.new_inbox``, which the route and the
  inbox kernels' wrappers share): the 12 output planes are views of one
  16-byte aligned buffer, disjoint, at the offsets ``inbox_layout`` gives
  the kernels.

The CUDA launches themselves run only on the card (``chip_smoke.py``).
Skips only when g++ is absent.  Tolerance: zero (bit-exact).
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from dragonboat_tpu_torch.ops import _native
from dragonboat_tpu_torch.ops import colocated_ref as CR
from dragonboat_tpu_torch.ops import convert
from dragonboat_tpu_torch.ops import route as PRt
from dragonboat_tpu_torch.ops import types as PT

torch = convert.torch
SEED = 20261021
POISON = -0x5EED
N_INBOX = 12

SHIM = r"""
#include <algorithm>
#include <vector>

#include "inbox.cu"

extern "C" {

// the fill's grid-stride loop, block by block, thread by thread;
// grid[0] = its blocks
int host_fill(const int* combo, int* out, int G, int M, int E, int* grid) {
  dbt::FillArgs a;
  const int rc = dbt::fill_args(a, combo, out, G, M, E);
  if (rc) return rc;
  grid[0] = (int)dbt::fill_blocks(a);
  const int T = dbt::IB_THREADS, step = grid[0] * T;
  for (int b = 0; b < grid[0]; ++b)
    for (int t = 0; t < T; ++t)
      for (int j = b * T + t; j < a.units; j += step) {
        dbt::InboxUnit u;
        dbt::fill_unit(a, j, u);
        dbt::fill_store(a, u);
      }
  return 0;
}

// the copy, block by block over its 1-D grid: the tile's alive flags
// staged, then each thread's batch loaded and stored; grid[0] = blocks,
// grid[1..2] = rows a tile of the [G, M] and the [G, M, E] planes
int host_copy(const int* const* ra, const int* const* rb, const int* lane,
              int lane_stride, int alive_if, int* out, int G, int M, int E,
              int PA, int* grid) {
  dbt::CopyArgs a;
  const int rc = dbt::copy_args(a, ra, rb, lane, lane_stride, alive_if, out,
                                G, M, E, PA);
  if (rc) return rc;
  grid[0] = a.bpre[dbt::N_INBOX];
  grid[1] = a.rows[0];
  grid[2] = a.rows[1];
  std::vector<unsigned char> sal(dbt::IB_ROWS_MAX);
  const int T = dbt::IB_THREADS, step = T * dbt::IB_BATCH;
  for (int x = 0; x < grid[0]; ++x) {
    dbt::CopyTile t;
    dbt::copy_tile(a, x, t);
    std::fill(sal.begin(), sal.end(), (unsigned char)0x5E);
    for (int r = 0; r < t.rows; ++r) sal[r] = dbt::copy_alive(a, t.r0 + r);
    const int units = (t.n + 3) >> 2;
    for (int j0 = 0; j0 < units; j0 += step)
      for (int th = 0; th < T; ++th) {
        dbt::InboxUnit u[dbt::IB_BATCH];
        for (int b = 0; b < dbt::IB_BATCH; ++b) {
          const int j = j0 + th + b * T;
          if (j < units) dbt::copy_load(a, t, sal.data(), j, u[b]);
        }
        for (int b = 0; b < dbt::IB_BATCH; ++b)
          if (j0 + th + b * T < units) dbt::copy_store(a, t, u[b]);
      }
  }
  return 0;
}

long long host_layout(int G, int M, int E, long long* off) {
  return dbt::inbox_layout(G, M, E, off);
}

long long host_misaligned() { return dbt::misaligned_quads(); }

}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    d = tmp_path_factory.mktemp("host_inbox")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_native.CSRC),
         "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    so.host_fill.restype = ctypes.c_int
    so.host_copy.restype = ctypes.c_int
    so.host_layout.restype = ctypes.c_longlong
    so.host_misaligned.restype = ctypes.c_longlong
    return so


def _p(t: torch.Tensor):
    assert t.dtype == torch.int32 and t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(*vals):
    return [ctypes.c_int(int(v)) for v in vals]


def _rand_inbox(rng, G, S, E, unaligned=False):
    """A seeded [G, S(, E)] inbox; ``unaligned`` puts every plane one word
    past a 16-byte boundary."""
    planes = []
    for f in range(N_INBOX):
        shape = (G, S, E) if f >= 10 else (G, S)
        n = int(np.prod(shape))
        vals = torch.from_numpy(rng.integers(-999, 999, n, dtype=np.int32))
        if unaligned:
            buf = torch.empty(n + 4, dtype=torch.int32)
            t = buf[1:n + 1]
            t.copy_(vals)
            assert n == 0 or t.data_ptr() % 16 != 0
            planes.append(t.view(shape))
        else:
            planes.append(vals.reshape(shape).clone())
    return PT.Inbox(*planes)


def _out(G, M, E):
    """The inbox allocator's allocation (``route.new_inbox``: the route's
    and the inbox kernels' outputs), poisoned, its views and a mask of
    the words the views cover."""
    flat, views = PRt.new_inbox(G, M, E, "cpu")
    flat.fill_(POISON)
    used = torch.zeros(flat.numel(), dtype=torch.bool)
    for v in views:
        o = v.storage_offset()
        used[o:o + v.numel()] = True
    return flat, views, used


def _check(so, views, want, flat, used, tag):
    assert so.host_misaligned() == 0, tag
    for f, (a, b) in enumerate(zip(views, want)):
        assert torch.equal(a, b), (tag, PT.Inbox._fields[f])
    assert (flat[~used] == POISON).all(), tag


def host_fill(so, combo, M, E):
    G = combo.shape[0]
    flat, views, used = _out(G, M, E)
    grid = (ctypes.c_int * 1)()
    assert so.host_fill(_p(combo), _p(flat), *_ints(G, M, E), grid) == 0
    return flat, views, used, grid[0]


def host_copy(so, a, b, lane, stride, alive_if, M, E, PA):
    G = lane.numel() // stride
    flat, views, used = _out(G, M, E)
    grid = (ctypes.c_int * 3)()
    rc = so.host_copy(_ptrs(a) if a is not None else None, _ptrs(b),
                      _p(lane), *_ints(stride, alive_if), _p(flat),
                      *_ints(G, M, E, PA), grid)
    assert rc == 0
    return flat, views, used, tuple(grid)


def _combo(rng, G, dead):
    """A [G, 4] combo whose alive lane is 0 on a ``dead`` share of the
    rows; the tick lane in [0, 4)."""
    c = np.zeros((G, 4), np.int32)
    c[:, 0] = rng.random(G) >= dead
    c[:, 1:3] = rng.random((G, 2)) < 0.5
    c[:, 3] = rng.integers(0, 4, G)
    return torch.from_numpy(c)


WIDTHS = (1, 3, 4)


@pytest.mark.parametrize("G", [1, 7, 133, 1031])
@pytest.mark.parametrize("M", WIDTHS + (8,))
@pytest.mark.parametrize("E", WIDTHS)
def test_from_ticks_fill_matches_plain_version(shim, G, M, E):
    rng = np.random.default_rng([SEED, G, M, E])
    combo = _combo(rng, G, 0.1)
    flat, views, used, blocks = host_fill(shim, combo, M, E)
    want = CR.host_inbox_from_ticks(combo, M=M, E=E)
    _check(shim, views, want, flat, used, ("fill", G, M, E))
    assert 1 <= blocks <= 132 * 8


@pytest.mark.parametrize("G", [5, 133, 1031])
@pytest.mark.parametrize("PB", WIDTHS)
@pytest.mark.parametrize("Mh", WIDTHS)
@pytest.mark.parametrize("E", WIDTHS)
def test_assemble_blocks_match_plain_version(shim, G, PB, Mh, E):
    rng = np.random.default_rng([SEED, G, PB, Mh, E])
    for unaligned in (False, True):
        host = _rand_inbox(rng, G, Mh, E, unaligned)
        pending = _rand_inbox(rng, G, PB, E, unaligned)
        for dead in (0.0, 0.1, 1.0):
            combo = _combo(rng, G, dead)
            flat, views, used, _grid = host_copy(
                shim, pending, host, combo, 4, 1, PB + Mh, E, PB)
            want = CR.assemble_inbox(host, pending, combo)
            _check(shim, views, want, flat, used,
                   ("assemble", unaligned, dead))
        # the fused wave's all-zero combo (colocated.py's later rounds)
        combo = torch.zeros((G, 4), dtype=torch.int32)
        flat, views, used, _grid = host_copy(
            shim, pending, host, combo, 4, 1, PB + Mh, E, PB)
        _check(shim, views, CR.assemble_inbox(host, pending, combo), flat,
               used, ("assemble", unaligned, "zero combo"))
        assert all((v == 0).all() for v in views)


@pytest.mark.parametrize("G", [5, 133, 1031])
@pytest.mark.parametrize("M", WIDTHS + (20,))
@pytest.mark.parametrize("E", WIDTHS)
def test_zero_rows_blocks_match_plain_version(shim, G, M, E):
    rng = np.random.default_rng([SEED, G, M, E, 2])
    for unaligned in (False, True):
        inbox = _rand_inbox(rng, G, M, E, unaligned)
        for frac in (0.0, 0.05, 1.0):
            mask = torch.from_numpy(
                (rng.random(G) < frac).astype(np.int32)
                * rng.integers(1, 9, G).astype(np.int32))
            flat, views, used, _grid = host_copy(
                shim, None, inbox, mask, 1, 0, M, E, 0)
            _check(shim, views, CR.zero_inbox_rows(inbox, mask), flat, used,
                   ("zero_rows", unaligned, frac))


def test_smoke_geometry_grids(shim):
    # 30,000 rows, P*B = 20 routed slots, 8 host slots, E = 4 (chip_smoke's
    # geometry): the copy's tiles hold about 4,096 words (144 rows of the
    # [G, M] planes, 36 of the [G, M, E] ones); the fill gives every SM 8
    # blocks
    rng = np.random.default_rng(SEED)
    G, PB, Mh, E = 30_000, 20, 8, 4
    host = _rand_inbox(rng, G, Mh, E)
    pending = _rand_inbox(rng, G, PB, E)
    combo = _combo(rng, G, 0.03)
    flat, views, used, grid = host_copy(shim, pending, host, combo, 4, 1,
                                        PB + Mh, E, PB)
    _check(shim, views, CR.assemble_inbox(host, pending, combo), flat, used,
           "assemble 30k")
    assert grid == (10 * 209 + 2 * 834, 144, 36)
    flat, views, used, blocks = host_fill(shim, combo, Mh, E)
    _check(shim, views, CR.host_inbox_from_ticks(combo, M=Mh, E=E), flat,
           used, "fill 30k")
    assert blocks == 132 * 8


def test_small_grids_are_split_for_the_card(shim):
    # a small inbox is cut into tiles of at least 4 rows until the copy
    # has IB_MIN_BLOCKS (264) blocks, so that every SM gets work
    rng = np.random.default_rng(SEED + 1)
    G, PB, Mh, E = 1024, 12, 8, 4
    host = _rand_inbox(rng, G, Mh, E)
    pending = _rand_inbox(rng, G, PB, E)
    combo = _combo(rng, G, 0.1)
    flat, views, used, grid = host_copy(shim, pending, host, combo, 4, 1,
                                        PB + Mh, E, PB)
    _check(shim, views, CR.assemble_inbox(host, pending, combo), flat, used,
           "assemble 1024")
    assert grid[0] >= 264 and grid[1] % 4 == 0 and grid[2] % 4 == 0


@pytest.mark.parametrize("G", [0, 1, 7, 30_000])
@pytest.mark.parametrize("M,E", [(1, 1), (3, 3), (8, 4), (28, 4)])
def test_wrapper_allocation_is_one_aligned_buffer(shim, G, M, E):
    flat, views = PRt.new_inbox(G, M, E, "cpu")
    base = flat.untyped_storage().data_ptr()
    assert base % 16 == 0
    off = (ctypes.c_longlong * N_INBOX)()
    total = shim.host_layout(*_ints(G, M, E), off)
    assert total == flat.numel()
    spans = []
    for f, v in enumerate(views):
        want = (G, M, E) if f >= 10 else (G, M)
        assert tuple(v.shape) == want and v.is_contiguous()
        assert v.dtype == torch.int32
        assert v.untyped_storage().data_ptr() == base
        assert v.storage_offset() == off[f]
        assert (v.storage_offset() * 4) % 16 == 0
        spans.append((v.storage_offset(), v.storage_offset() + v.numel()))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= total
