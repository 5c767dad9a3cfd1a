// place_rows: row placement through a position map, the escalation merge
// in place, and the (g, p) remote-snapshot store.
//
// Replaces dragonboat_tpu/ops/engine.py `_scatter_rows` (engine.py:163),
// `_select_rows` (:180), `_gather_rows` (:189) and `_set_remote_snapshot`
// (:400), and the escalation merge of the colocated and routed rounds
// (colocated.py:223-229 `_route_step`, route.py:454-462
// `merge_and_route`).
//
// Rows mode: for every field f of a list, out_f[g] = src_f[pos[g]] where
// pos[g] >= 0 (a pos past the source's last row reads the last row),
// else dst_f[g] (0 when there is no dst, the gather case).  This covers
// scatter (pos = the upload map), select (pos = g where the new row is
// kept, else -1, with src = new) and gather (pos = the index set, no
// dst).  An out-of-place escalation select is rows mode with pos[g] =
// -1 where escalate[g] != 0, else g (dst = old, src = new).
//
// Bound: bytes.  Every output word is written once and read once from
// src or dst, plus pos: 4 * (2 * G * width + G) bytes.
//
// Design (rows mode): every output of a call is a view of ONE int32
// allocation (field f at out + off[f], 16-byte aligned).  The launcher
// folds consecutive fields into groups of up to PR_GROUP_WORDS words a
// row (a field wider than that is a group of its own), so that the 21
// [G] fields of the state move together and no block is mostly idle.
// The grid is 2-D: blockIdx.y is the group, blockIdx.x a tile of R rows
// (R a multiple of 4, about PR_TILE_WORDS / the group's width, fewer when
// the grid would have less than PR_MIN_BLOCKS blocks).  A block
// stages its tile's pos words in shared memory once, then moves the
// group's output as 16-byte units: unit J of the tile belongs to field
// seg_of(J) and covers four consecutive words of that field's rows
// [r0, r0 + rows), so row and column come from a 32-bit FastDiv by the
// field's width (no division on the device, no search per word).  A unit
// whose rows all keep dst (pos < 0) loads 16 bytes of dst at the same
// offset; one whose rows all map to themselves (select) 16 bytes of src
// at the same offset; one inside a single row that reads a source row, of
// a field whose width is a multiple of 4, 16 bytes of that row; any other
// unit word by word.  Each thread loads PR_BATCH
// units before it stores them, so its loads are in flight together.
//
// In-place merge (merge_escalated_kernel): new_f[g] = old_f[g] where
// escalate[g] != 0, for the callers whose new state is the step's fresh
// output that nothing reads after the merge.  A block looks at PM_ROWS
// rows: one coalesced pass over escalate, the flagged rows compacted into
// shared memory by warp ballots; only a block with a flagged row copies,
// every field of each of its flagged rows, flattened over (row, word) so
// that its threads' loads are in flight together.  Bound:
// 4 * (G + 2 * n_esc * width) bytes.  With no escalated row it is one
// read of the [G] word.
//
// Snapshot mode: out_rstate / out_snap are copies of rstate / snap_index
// with rstate = RS_SNAPSHOT and snap_index = snap[k] at every pair
// (g_idx[k], p_idx[k]); one thread per (g, p) word scans the pair list
// (it is a handful of pairs), the last pair naming a word wins.
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain C++:
// then `place_args`, `place_tile`, `place_units`, `place_pos`,
// `place_load`, `place_store`, `merge_args`, `merge_slot`, `merge_load`,
// `merge_store` and `snap_word` are host functions, which a host loop
// runs block by block and thread by thread to check the kernels' logic
// without a card.
#include "blocks.cuh"
#include "common.cuh"
#include "launch.h"

namespace dbt {

constexpr int PR_THREADS = 256;
// words a rows-mode block moves: its tile's rows times its group's width
constexpr int PR_TILE_WORDS = 4096;
// consecutive fields fold into one group up to this many words a row
constexpr int PR_GROUP_WORDS = 32;
// most rows a tile (its pos words are staged in shared memory)
constexpr int PR_ROWS_MAX = 1024;
// a grid of fewer rows is cut into smaller tiles, down to 4 rows, until
// it has this many blocks (two an SM): a small gather is latency-bound
constexpr int PR_MIN_BLOCKS = 264;
// 16-byte units a thread loads before it stores them
constexpr int PR_BATCH = 4;
// rows a block of the in-place merge looks at (a multiple of PR_THREADS):
// one a thread, so that escalated rows spread over many blocks' copies
constexpr int PM_ROWS = 256;

struct PlaceArgs {
  const int* pos;              // [G_out]
  const int* dst[MAX_FIELDS];  // null: zeros (a gather)
  const int* src[MAX_FIELDS];
  int* out;                    // one allocation: field f at out + off[f]
  long long off[MAX_FIELDS];
  int width[MAX_FIELDS];       // words a row
  FastDiv wdiv[MAX_FIELDS];    // by width (by 1 where the width is 0)
  unsigned char dst16[MAX_FIELDS];  // dst is null or 16-byte aligned
  unsigned char src16[MAX_FIELDS];  // src is 16-byte aligned
  int grp[MAX_FIELDS + 1];     // group y: fields [grp[y], grp[y + 1])
  int grp_rows[MAX_FIELDS];    // rows a tile of group y (a multiple of 4)
  int n_fields, n_groups, G_out, G_src;
  int tiles;  // gridDim.x: the most tiles of any group
};

// One block's tile: group y's rows [r0, r0 + rows), fields [f0, f0 + nf).
struct PlaceTile {
  int r0, rows, f0, nf;
};

// One 16-byte unit of a tile: field f, its first word u in the field's
// tile region, and the four words.
struct PlaceUnit {
  int f, u;
  Quad q;
};

struct MergeArgs {
  const int* esc;               // [G]
  const int* old_[MAX_FIELDS];
  int* new_[MAX_FIELDS];
  int col[MAX_FIELDS + 1];      // a row's words before field f; col[n] = all
  FastDiv rdiv;                 // by the row's words (col[n_fields])
  int n_fields, G;
};

struct MergeItem {
  int f;
  long long at;
  int v;
};

struct SnapArgs {
  const int* rstate;
  const int* snap_index;
  const int* g_idx;
  const int* p_idx;
  const int* snap;
  int* out_rstate;
  int* out_snap;
  int G, P, n;
};

// Host side: fold the fields into groups and size each group's tiles;
// returns false when a tile's words would not fit an int.
inline bool place_groups(PlaceArgs& a) {
  int y = 0, gw = 0;
  a.grp[0] = 0;
  for (int f = 0; f < a.n_fields; ++f) {
    if (f > a.grp[y] && gw + a.width[f] > PR_GROUP_WORDS) {
      a.grp[++y] = f;
      gw = 0;
    }
    gw += a.width[f];
  }
  a.grp[++y] = a.n_fields;
  a.n_groups = y;
  a.tiles = 0;
  // the rows a tile that gives the grid PR_MIN_BLOCKS blocks
  const long long per = (PR_MIN_BLOCKS + a.n_groups - 1) / a.n_groups;
  const long long R_min = ((a.G_out + per - 1) / per + 3) & ~3LL;
  for (int k = 0; k < a.n_groups; ++k) {
    long long w = 0;
    for (int f = a.grp[k]; f < a.grp[k + 1]; ++f) w += a.width[f];
    long long R = PR_TILE_WORDS / (w > 0 ? w : 1);
    R = R > PR_ROWS_MAX ? PR_ROWS_MAX : R;
    R = R > R_min ? R_min : R;
    R = R < 4 ? 4 : R & ~3LL;
    if (R * (w + 4) >= (1LL << 31)) return false;
    a.grp_rows[k] = (int)R;
    const int t = (int)((a.G_out + R - 1) / R);
    a.tiles = t > a.tiles ? t : a.tiles;
  }
  return true;
}

// Block (x, y)'s tile; false for a block past its group's last tile.
DBT_HD bool place_tile(const PlaceArgs& a, int y, int x, PlaceTile& t) {
  const int R = a.grp_rows[y];
  if ((long long)x * R >= a.G_out) return false;
  t.r0 = x * R;
  t.rows = imin(R, a.G_out - t.r0);
  t.f0 = a.grp[y];
  t.nf = a.grp[y + 1] - t.f0;
  return true;
}

// the tile's units before each of its fields: ubase[i] for field f0 + i,
// ubase[nf] = all
DBT_HD void place_units(const PlaceArgs& a, const PlaceTile& t, int* ubase) {
  int u = 0;
  for (int i = 0; i < t.nf; ++i) {
    ubase[i] = u;
    u += (t.rows * a.width[t.f0 + i] + 3) >> 2;
  }
  ubase[t.nf] = u;
}

// row g's source row, or -1 for dst
DBT_HD int place_pos(const PlaceArgs& a, int g) {
  const int p = a.pos[g];
  return p < 0 ? -1 : imin(p, a.G_src - 1);
}

// Load unit j of tile t (spos: the tile's place_pos values).
DBT_HD void place_load(const PlaceArgs& a, const PlaceTile& t,
                       const int* ubase, const int* spos, int j,
                       PlaceUnit& pu) {
  const int i = seg_of(ubase, t.nf, j);
  const int f = t.f0 + i;
  const int w = a.width[f];
  const int n = t.rows * w;  // words of the field's tile region
  const int k0 = (j - ubase[i]) * 4;
  const FastDiv& wd = a.wdiv[f];
  const long long base = (long long)t.r0 * w;
  const int* dst = a.dst[f];
  const int* src = a.src[f];
  pu.f = f;
  pu.u = k0;
  const int r_lo = fdiv(wd, k0);
  const int r_hi = fdiv(wd, imin(k0 + 3, n - 1));
  if (k0 + 4 <= n) {
    bool all_dst = true, all_same = true;
    for (int r = r_lo; r <= r_hi; ++r) {
      const int p = spos[r];
      all_dst = all_dst && p < 0;
      all_same = all_same && p == t.r0 + r;
    }
    if (all_dst && a.dst16[f]) {
      if (dst) {
        pu.q = load4(dst + base + k0);
      } else {
        for (int k = 0; k < 4; ++k) pu.q.v[k] = 0;
      }
      return;
    }
    if (all_same && a.src16[f]) {
      pu.q = load4(src + base + k0);
      return;
    }
    if (r_lo == r_hi && spos[r_lo] >= 0 && (w & 3) == 0 && a.src16[f]) {
      pu.q = load4(src + (long long)spos[r_lo] * w + (k0 - r_lo * w));
      return;
    }
  }
  for (int k = 0; k < 4; ++k) {
    const int kk = k0 + k;
    if (kk >= n) {
      pu.q.v[k] = 0;
      continue;
    }
    const int r = fdiv(wd, kk);
    const int p = spos[r];
    pu.q.v[k] = p >= 0 ? src[(long long)p * w + (kk - r * w)]
                       : (dst ? dst[base + kk] : 0);
  }
}

// Store unit pu of tile t; the output of a full unit is 16-byte aligned
// (off[f], r0 and u are multiples of 4 words; the launcher checks out).
DBT_HD void place_store(const PlaceArgs& a, const PlaceTile& t,
                        const PlaceUnit& pu) {
  const int w = a.width[pu.f];
  const int n = t.rows * w;
  int* o = a.out + a.off[pu.f] + (long long)t.r0 * w + pu.u;
  if (pu.u + 4 <= n) {
    store4(o, pu.q);
    return;
  }
  for (int k = 0; k < 4; ++k)
    if (pu.u + k < n) o[k] = pu.q.v[k];
}

// A warp's flagged rows in the merge: ballot m of the warp's rows, the
// warp's first slot in the block's list; the lane's slot.
DBT_HD int merge_slot(uint32_t m, int lane, int base) {
  return base + bits_below(m, lane);
}

// Item j of the flattened (flagged row, word) space of a merge block
// whose flagged rows are rows[0..], col: the field table in shared memory.
DBT_HD void merge_load(const MergeArgs& a, const int* rows, const int* col,
                       int j, MergeItem& it) {
  const int e = fdiv(a.rdiv, j);
  const int c = j - e * a.rdiv.d;
  const int f = seg_of(col, a.n_fields, c);
  const int w = col[f + 1] - col[f];
  it.f = f;
  it.at = (long long)rows[e] * w + (c - col[f]);
  it.v = a.old_[f][it.at];
}

DBT_HD void merge_store(const MergeArgs& a, const MergeItem& it) {
  a.new_[it.f][it.at] = it.v;
}

// Host side: the rows-mode arguments; returns 0, 1 (a misaligned output)
// or 2 (a tile too wide)
inline int place_args(PlaceArgs& a, const int* pos, const int* const* dst,
                      const int* const* src, int* out, const long long* off,
                      const int* width, int n_fields, int G_out, int G_src) {
  a.pos = pos;
  a.out = out;
  if (!is_aligned16(out)) return 1;
  for (int f = 0; f < n_fields; ++f) {
    if (off[f] & 3) return 1;
    a.dst[f] = dst ? dst[f] : nullptr;
    a.src[f] = src[f];
    a.off[f] = off[f];
    a.width[f] = width[f];
    a.wdiv[f] = fast_div(width[f] > 0 ? width[f] : 1);
    a.dst16[f] = a.dst[f] == nullptr || is_aligned16(a.dst[f]);
    a.src16[f] = is_aligned16(a.src[f]);
  }
  a.n_fields = n_fields;
  a.G_out = G_out;
  a.G_src = G_src;
  return place_groups(a) ? 0 : 2;
}

// Host side: the in-place merge's arguments; returns 0, or 2 (rows too
// wide for a block's int offsets)
inline int merge_args(MergeArgs& a, const int* escalate,
                      const int* const* old_, int* const* new_,
                      const int* width, int n_fields, int G) {
  a.esc = escalate;
  a.n_fields = n_fields;
  a.G = G;
  long long c = 0;
  for (int f = 0; f < n_fields; ++f) {
    a.old_[f] = old_[f];
    a.new_[f] = new_[f];
    a.col[f] = (int)c;
    c += width[f];
  }
  a.col[n_fields] = (int)c;
  if (c * PM_ROWS >= (1LL << 31)) return 2;
  a.rdiv = fast_div(c > 0 ? (int)c : 1);
  return 0;
}

inline unsigned merge_blocks(const MergeArgs& a) {
  return (unsigned)((a.G + PM_ROWS - 1) / PM_ROWS);
}

DBT_HD void snap_word(const SnapArgs& a, int g, int p, int* rs, int* sn) {
  *rs = a.rstate[(long long)g * a.P + p];
  *sn = a.snap_index[(long long)g * a.P + p];
  for (int k = 0; k < a.n; ++k) {
    int gk = a.g_idx[k], pk = a.p_idx[k];
    if (gk < 0) gk += a.G;
    if (pk < 0) pk += a.P;
    if (gk == g && pk == p) {
      *rs = RS_SNAPSHOT;
      *sn = a.snap[k];
    }
  }
}

}  // namespace dbt

#ifdef __CUDACC__
__global__ void __launch_bounds__(dbt::PR_THREADS)
    place_rows_kernel(const __grid_constant__ dbt::PlaceArgs a) {
  __shared__ int spos[dbt::PR_ROWS_MAX];
  __shared__ int ubase[dbt::MAX_FIELDS + 1];
  dbt::PlaceTile t;
  if (!dbt::place_tile(a, blockIdx.y, blockIdx.x, t)) return;
  if (threadIdx.x == 0) dbt::place_units(a, t, ubase);
  for (int r = threadIdx.x; r < t.rows; r += dbt::PR_THREADS)
    spos[r] = dbt::place_pos(a, t.r0 + r);
  __syncthreads();
  const int total = ubase[t.nf];
  constexpr int STEP = dbt::PR_THREADS * dbt::PR_BATCH;
  for (int j0 = threadIdx.x; j0 < total; j0 += STEP) {
    dbt::PlaceUnit u[dbt::PR_BATCH];
#pragma unroll
    for (int b = 0; b < dbt::PR_BATCH; ++b) {
      const int j = j0 + b * dbt::PR_THREADS;
      if (j < total) dbt::place_load(a, t, ubase, spos, j, u[b]);
    }
#pragma unroll
    for (int b = 0; b < dbt::PR_BATCH; ++b)
      if (j0 + b * dbt::PR_THREADS < total) dbt::place_store(a, t, u[b]);
  }
}

__global__ void __launch_bounds__(dbt::PR_THREADS)
    merge_escalated_kernel(const __grid_constant__ dbt::MergeArgs a) {
  __shared__ int rows[dbt::PM_ROWS];
  __shared__ int col[dbt::MAX_FIELDS + 1];
  __shared__ int n;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) n = 0;
  __syncthreads();
  const int g0 = blockIdx.x * dbt::PM_ROWS;
  for (int r = threadIdx.x; r < dbt::PM_ROWS; r += dbt::PR_THREADS) {
    const int g = g0 + r;
    const bool hit = g < a.G && a.esc[g] != 0;
    const unsigned m = __ballot_sync(full, hit);
    if (m == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(&n, __popc(m));
    base = __shfl_sync(full, base, 0);
    if (hit) rows[dbt::merge_slot(m, lane, base)] = g;
  }
  __syncthreads();
  const int k = n;
  if (k == 0) return;
  for (int i = threadIdx.x; i <= a.n_fields; i += dbt::PR_THREADS)
    col[i] = a.col[i];
  __syncthreads();
  const int total = k * a.rdiv.d;
  constexpr int STEP = dbt::PR_THREADS * dbt::PR_BATCH;
  for (int j0 = threadIdx.x; j0 < total; j0 += STEP) {
    dbt::MergeItem it[dbt::PR_BATCH];
#pragma unroll
    for (int b = 0; b < dbt::PR_BATCH; ++b) {
      const int j = j0 + b * dbt::PR_THREADS;
      if (j < total) dbt::merge_load(a, rows, col, j, it[b]);
    }
#pragma unroll
    for (int b = 0; b < dbt::PR_BATCH; ++b)
      if (j0 + b * dbt::PR_THREADS < total) dbt::merge_store(a, it[b]);
  }
}

__global__ void place_snapshot_kernel(const dbt::SnapArgs a) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.G * a.P) return;
  int rs, sn;
  dbt::snap_word(a, t / a.P, t % a.P, &rs, &sn);
  a.out_rstate[t] = rs;
  a.out_snap[t] = sn;
}

int dbt::place_rows_launch(const int* pos, const int* const* dst,
                           const int* const* src, int* out,
                           const long long* off, const int* width,
                           int n_fields, int G_out, int G_src, void* stream) {
  dbt::PlaceArgs a;
  const int rc = dbt::place_args(a, pos, dst, src, out, off, width, n_fields,
                                 G_out, G_src);
  if (rc || G_out == 0) return rc;
  const dim3 grid((unsigned)a.tiles, (unsigned)a.n_groups);
  place_rows_kernel<<<grid, dbt::PR_THREADS, 0, (cudaStream_t)stream>>>(a);
  return 0;
}

int dbt::merge_escalated_launch(const int* escalate, const int* const* old_,
                                int* const* new_, const int* width,
                                int n_fields, int G, void* stream) {
  dbt::MergeArgs a;
  const int rc = dbt::merge_args(a, escalate, old_, new_, width, n_fields, G);
  if (rc || G == 0 || a.col[n_fields] == 0) return rc;
  merge_escalated_kernel<<<dbt::merge_blocks(a), dbt::PR_THREADS, 0,
                           (cudaStream_t)stream>>>(a);
  return 0;
}

void dbt::set_remote_snapshot_launch(const int* rstate, const int* snap_index,
                                     const int* g_idx, const int* p_idx,
                                     const int* snap, int* out_rstate,
                                     int* out_snap, int G, int P, int n,
                                     void* stream) {
  dbt::SnapArgs s;
  s.rstate = rstate;
  s.snap_index = snap_index;
  s.g_idx = g_idx;
  s.p_idx = p_idx;
  s.snap = snap;
  s.out_rstate = out_rstate;
  s.out_snap = out_snap;
  s.G = G;
  s.P = P;
  s.n = n;
  const int threads = 256;
  const int words = G * P;
  if (words == 0) return;
  place_snapshot_kernel<<<(words + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(s);
}
#endif
