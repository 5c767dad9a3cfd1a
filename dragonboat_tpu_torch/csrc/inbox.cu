// inbox: the colocated engine's inbox builders.
//
// Replaces dragonboat_tpu/ops/colocated.py
//   `_assemble_inbox` (colocated.py:175; with raft_step it is
//     `_assemble_and_step`, :199): the routed regions ("pending", PA
//     slots a row) first, then the host slots; a row whose alive lane
//     combo[g, 0] is 0 is zeroed whole, entry axis included;
//   `_host_inbox_from_ticks` (:411): the host region built from the
//     fused tick counts combo[g, 3] — slot 0 is MT_TICK where the count
//     is above 0, and log_index[g, 0] is the count on every row;
//     every other word is 0;
//   `_zero_inbox_rows` (:399): rows with mask[g] != 0 zeroed.
// (`_scatter_inbox_rows`, :441, is place_rows over the 12 fields.)
//
// Bound: bytes.  Each input word is read once and each output word
// written once; there is no arithmetic to speak of.  from_ticks reads
// only the tick lane: 4 * (G + G * M * (10 + 2E)) bytes.
//
// Design.  Every output inbox is ONE int32 allocation: the 12 planes
// field-major, the ten [G, M] planes then the two [G, M, E] ones, each
// starting on a 16-byte boundary (inbox_layout, launch.h; the Python
// wrapper cuts the same views).  The kernels are handed its base and
// write it as 16-byte units.
//
// from_ticks (inbox_fill_kernel) is a fill: a grid-stride pass, sized to
// give every SM IB_FILL_PER_SM blocks, writes zero units over every
// plane.  Only the units of the mtype and log_index planes (f = 0, 4)
// look for slot 0 of a row (a FastDiv by M per word) and read that
// row's tick count.
//
// assemble and zero_rows (inbox_copy_kernel) copy rows.  An output row of
// plane f is PA * w words of region a (pending) then (M - PA) * w words
// of region b (host), w = 1 or E; zero_rows is region b alone with the
// mask as the lane.  The grid is 1-D over (plane, row tile): a tile is R
// rows of one plane, R about IB_TILE_WORDS over the plane's row width (a
// multiple of 4, fewer when the grid would have less than IB_MIN_BLOCKS
// blocks).  A block stages its rows' alive lanes in shared memory once,
// then moves the tile as 16-byte units: unit j covers four consecutive
// words of the tile; its row and column come from a FastDiv by the row
// width.  A unit inside one dead row, or over dead rows only, stores
// zeros and reads nothing; one inside one row and one region whose
// source address is 16-byte aligned loads 16 bytes; any other unit goes
// word by word (an unaligned geometry stays right and never faults).
// Each thread loads IB_BATCH units before it stores them.
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain C++:
// then `fill_args`, `fill_unit`, `copy_args`, `copy_tile`, `copy_alive`,
// `copy_load` and `copy_store` are host functions, which a host loop
// runs block by block and thread by thread to check the kernels' logic
// without a card.
#include "blocks.cuh"
#include "common.cuh"
#include "launch.h"

namespace dbt {

constexpr int IB_THREADS = 256;
// words a copy block moves: its tile's rows times the plane's row width
constexpr int IB_TILE_WORDS = 4096;
// most rows a tile (their alive lanes are staged in shared memory)
constexpr int IB_ROWS_MAX = 1024;
// a copy grid of fewer blocks gets smaller tiles, down to 4 rows
constexpr int IB_MIN_BLOCKS = 264;
// 16-byte units a thread loads before it stores them
constexpr int IB_BATCH = 4;
// fill blocks an SM (132 SMs on the H100)
constexpr int IB_FILL_PER_SM = 8;
constexpr int IB_SMS = 132;

struct FillArgs {
  const int* combo;  // [G, 4]
  int* out;          // inbox_layout(G, M, E)
  long long off[N_INBOX];
  int G, M, E;
  int n1, n2;        // words of a [G, M] and of a [G, M, E] plane
  int u1, u2;        // their 16-byte units
  int units;         // 10 * u1 + 2 * u2
  FastDiv mdiv;      // by M
  FastDiv u1div;     // by u1
};

// One 16-byte unit: its plane f (the fill's; a copy unit's is its
// tile's), its first word k in the plane (the fill) or the tile (a copy),
// the words
struct InboxUnit {
  int f, k;
  Quad q;
};

struct CopyArgs {
  const int* a[N_INBOX];  // region a (pending), [G, PA(, E)]; null if PA = 0
  const int* b[N_INBOX];  // region b (host), [G, M - PA(, E)]
  const int* lane;        // alive lane: lane[g * lane_stride]
  int lane_stride;
  int alive_if;           // 1: alive where the lane != 0; 0: where it is 0
  int* out;               // inbox_layout(G, M, E)
  long long off[N_INBOX];
  int G, M, E, PA;
  // by width class c (0: the [G, M] planes, 1: the [G, M, E] planes)
  int rw[2];              // words of an output row: M * w
  int aw[2];              // of its region a: PA * w
  FastDiv rdiv[2];        // by rw
  int rows[2];            // rows a tile (a multiple of 4)
  int bpre[N_INBOX + 1];  // the blocks before plane f; bpre[12] = all
};

// One block's tile: plane f, rows [r0, r0 + rows), n output words
struct CopyTile {
  int f, c, r0, rows, n;
};

// Host side: the fill's arguments; returns 0, 1 (a misaligned output)
// or 2 (planes too large for 32-bit word indexes)
inline int fill_args(FillArgs& a, const int* combo, int* out, int G, int M,
                     int E) {
  if (!is_aligned16(out)) return 1;
  const long long n2 = (long long)G * M * E;
  const long long n1 = (long long)G * M;
  if (n2 + 3 >= (1LL << 31) || n1 + 3 >= (1LL << 31) ||
      10 * ((n1 + 3) / 4) + 2 * ((n2 + 3) / 4) >= (1LL << 31))
    return 2;
  a.combo = combo;
  a.out = out;
  inbox_layout(G, M, E, a.off);
  a.G = G;
  a.M = M;
  a.E = E;
  a.n1 = (int)n1;
  a.n2 = (int)n2;
  a.u1 = (int)((n1 + 3) >> 2);
  a.u2 = (int)((n2 + 3) >> 2);
  a.units = 10 * a.u1 + 2 * a.u2;
  a.mdiv = fast_div(M > 0 ? M : 1);
  a.u1div = fast_div(a.u1 > 0 ? a.u1 : 1);
  return 0;
}

// host side: the fill grid, blocks that give every SM IB_FILL_PER_SM
inline unsigned fill_blocks(const FillArgs& a) {
  const long long want = ((long long)a.units + IB_THREADS - 1) / IB_THREADS;
  const long long most = (long long)IB_SMS * IB_FILL_PER_SM;
  return (unsigned)(want < most ? want : most);
}

// Unit j of the fill: zeros, but for slot 0 of every row in the mtype
// (f = 0) and log_index (f = 4) planes
DBT_HD void fill_unit(const FillArgs& a, int j, InboxUnit& u) {
  int n;
  if (j < 10 * a.u1) {
    u.f = fdiv(a.u1div, j);
    u.k = (j - u.f * a.u1) * 4;
    n = a.n1;
  } else {
    const int jj = j - 10 * a.u1;
    u.f = jj < a.u2 ? 10 : 11;
    u.k = (jj - (u.f - 10) * a.u2) * 4;
    n = a.n2;
  }
  for (int i = 0; i < 4; ++i) u.q.v[i] = 0;
  if (u.f != 0 && u.f != 4) return;
  for (int i = 0; i < 4; ++i) {
    const int k = u.k + i;
    if (k >= n) break;
    const int g = fdiv(a.mdiv, k);
    if (k != g * a.M) continue;
    const int t = a.combo[(long long)g * 4 + 3];
    u.q.v[i] = u.f == 0 ? (t > 0 ? MT_TICK : 0) : t;
  }
}

DBT_HD void fill_store(const FillArgs& a, const InboxUnit& u) {
  const int n = u.f < 10 ? a.n1 : a.n2;
  int* o = a.out + a.off[u.f] + u.k;
  if (u.k + 4 <= n) {
    store4(o, u.q);
    return;
  }
  for (int i = 0; i < 4 && u.k + i < n; ++i) o[i] = u.q.v[i];
}

// Host side: the copy's arguments and its grid; returns 0, 1 (a
// misaligned output) or 2 (rows too wide for a tile's int offsets)
inline int copy_args(CopyArgs& a, const int* const* ra, const int* const* rb,
                     const int* lane, int lane_stride, int alive_if, int* out,
                     int G, int M, int E, int PA) {
  if (!is_aligned16(out)) return 1;
  for (int f = 0; f < N_INBOX; ++f) {
    a.a[f] = ra ? ra[f] : nullptr;
    a.b[f] = rb[f];
  }
  a.lane = lane;
  a.lane_stride = lane_stride;
  a.alive_if = alive_if;
  a.out = out;
  inbox_layout(G, M, E, a.off);
  a.G = G;
  a.M = M;
  a.E = E;
  a.PA = PA;
  // the rows a tile that gives the grid IB_MIN_BLOCKS blocks
  const long long per = (IB_MIN_BLOCKS + N_INBOX - 1) / N_INBOX;
  const long long R_min = ((G + per - 1) / per + 3) & ~3LL;
  for (int c = 0; c < 2; ++c) {
    const long long w = c ? E : 1;
    const long long rw = (long long)M * w;
    long long R = IB_TILE_WORDS / (rw > 0 ? rw : 1);
    R = R > IB_ROWS_MAX ? IB_ROWS_MAX : R;
    R = R > R_min ? R_min : R;
    R = R < 4 ? 4 : R & ~3LL;
    if (R * rw + 3 >= (1LL << 31)) return 2;
    a.rw[c] = (int)rw;
    a.aw[c] = (int)(PA * w);
    a.rdiv[c] = fast_div(rw > 0 ? (int)rw : 1);
    a.rows[c] = (int)R;
  }
  a.bpre[0] = 0;
  for (int f = 0; f < N_INBOX; ++f) {
    const int R = a.rows[f >= 10];
    a.bpre[f + 1] = a.bpre[f] + (a.rw[f >= 10] > 0 ? (G + R - 1) / R : 0);
  }
  return 0;
}

// Block x's tile
DBT_HD void copy_tile(const CopyArgs& a, int x, CopyTile& t) {
  // the last plane whose blocks start at or before x (an [G, M, E]
  // plane has no block when E = 0)
  t.f = seg_of(a.bpre, N_INBOX, x);
  t.c = t.f >= 10;
  const int R = a.rows[t.c];
  t.r0 = (x - a.bpre[t.f]) * R;
  t.rows = imin(R, a.G - t.r0);
  t.n = t.rows * a.rw[t.c];
}

// whether output row g is kept (else it is zeroed)
DBT_HD bool copy_alive(const CopyArgs& a, int g) {
  return (a.lane[(long long)g * a.lane_stride] != 0) == (a.alive_if != 0);
}

// the source word of column col of row g (a live row) in plane f, class c
DBT_HD const int* copy_src(const CopyArgs& a, int f, int c, int g, int col) {
  const int aw = a.aw[c];
  if (col < aw) return a.a[f] + (long long)g * aw + col;
  const int bw = a.rw[c] - aw;
  return a.b[f] + (long long)g * bw + (col - aw);
}

// Load unit j of tile t (sal: the tile's alive flags).
DBT_HD void copy_load(const CopyArgs& a, const CopyTile& t,
                      const unsigned char* sal, int j, InboxUnit& u) {
  const FastDiv& rd = a.rdiv[t.c];
  const int rw = a.rw[t.c];
  const int aw = a.aw[t.c];
  u.k = j * 4;
  const int k0 = u.k;
  const int r_lo = fdiv(rd, k0);
  const int r_hi = fdiv(rd, imin(k0 + 3, t.n - 1));
  if (k0 + 4 <= t.n) {
    bool any = false;
    for (int r = r_lo; r <= r_hi; ++r) any = any || sal[r];
    if (!any) {
      for (int i = 0; i < 4; ++i) u.q.v[i] = 0;
      return;
    }
    const int c0 = k0 - r_lo * rw;
    if (r_lo == r_hi && (c0 + 4 <= aw || c0 >= aw)) {
      const int* s = copy_src(a, t.f, t.c, t.r0 + r_lo, c0);
      if (is_aligned16(s)) {
        u.q = load4(s);
        return;
      }
    }
  }
  // word by word: the row and column walk on from k0's
  int r = r_lo, col = k0 - r_lo * rw;
  for (int i = 0; i < 4; ++i, ++col) {
    if (col == rw) {
      ++r;
      col = 0;
    }
    u.q.v[i] = k0 + i < t.n && sal[r]
                   ? *copy_src(a, t.f, t.c, t.r0 + r, col)
                   : 0;
  }
}

// Store unit u of tile t; a full unit's output is 16-byte aligned
// (off[f], r0 * rw and k are multiples of 4 words)
DBT_HD void copy_store(const CopyArgs& a, const CopyTile& t,
                       const InboxUnit& u) {
  int* o = a.out + a.off[t.f] + (long long)t.r0 * a.rw[t.c] + u.k;
  if (u.k + 4 <= t.n) {
    store4(o, u.q);
    return;
  }
  for (int i = 0; i < 4 && u.k + i < t.n; ++i) o[i] = u.q.v[i];
}

}  // namespace dbt

#ifdef __CUDACC__
__global__ void __launch_bounds__(dbt::IB_THREADS)
    inbox_fill_kernel(const __grid_constant__ dbt::FillArgs a) {
  const int step = gridDim.x * dbt::IB_THREADS;
  for (int j = blockIdx.x * dbt::IB_THREADS + threadIdx.x; j < a.units;
       j += step) {
    dbt::InboxUnit u;
    dbt::fill_unit(a, j, u);
    dbt::fill_store(a, u);
  }
}

__global__ void __launch_bounds__(dbt::IB_THREADS)
    inbox_copy_kernel(const __grid_constant__ dbt::CopyArgs a) {
  __shared__ unsigned char sal[dbt::IB_ROWS_MAX];
  dbt::CopyTile t;
  dbt::copy_tile(a, blockIdx.x, t);
  for (int r = threadIdx.x; r < t.rows; r += dbt::IB_THREADS)
    sal[r] = dbt::copy_alive(a, t.r0 + r);
  __syncthreads();
  const int units = (t.n + 3) >> 2;
  constexpr int STEP = dbt::IB_THREADS * dbt::IB_BATCH;
  for (int j0 = threadIdx.x; j0 < units; j0 += STEP) {
    dbt::InboxUnit u[dbt::IB_BATCH];
#pragma unroll
    for (int b = 0; b < dbt::IB_BATCH; ++b) {
      const int j = j0 + b * dbt::IB_THREADS;
      if (j < units) dbt::copy_load(a, t, sal, j, u[b]);
    }
#pragma unroll
    for (int b = 0; b < dbt::IB_BATCH; ++b)
      if (j0 + b * dbt::IB_THREADS < units) dbt::copy_store(a, t, u[b]);
  }
}

int dbt::inbox_fill_launch(const int* combo, int* out, int G, int M, int E,
                           void* stream) {
  dbt::FillArgs a;
  const int rc = dbt::fill_args(a, combo, out, G, M, E);
  if (rc || a.units == 0) return rc;
  inbox_fill_kernel<<<dbt::fill_blocks(a), dbt::IB_THREADS, 0,
                      (cudaStream_t)stream>>>(a);
  return 0;
}

int dbt::inbox_copy_launch(const int* const* a_in, const int* const* b_in,
                           const int* lane, int lane_stride, int alive_if,
                           int* out, int G, int M, int E, int PA,
                           void* stream) {
  dbt::CopyArgs a;
  const int rc = dbt::copy_args(a, a_in, b_in, lane, lane_stride, alive_if,
                                out, G, M, E, PA);
  if (rc || a.bpre[dbt::N_INBOX] == 0) return rc;
  inbox_copy_kernel<<<(unsigned)a.bpre[dbt::N_INBOX], dbt::IB_THREADS, 0,
                      (cudaStream_t)stream>>>(a);
  return 0;
}
#endif
