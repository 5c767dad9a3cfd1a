// xlane: the cross-device lane of the sharded round — pack and scatter.
//
// Replaces dragonboat_tpu/ops/route.py `cross_exchange` (route.py:652),
// the lane `make_sharded_round` (:850) runs after each device's local
// route.  The reference packs, per shard, every message whose
// destination replica lives on another device into a fixed per-edge
// buffer xbuf [D, XB, KT] (KT = 14 + 2E), hands block d to device d
// with D-1 `ppermute` ring shifts, and adds the received rows into the
// inbox region slots base + rank*B + b.  Here the shifts are device
// copies (ops/route.py `ring_shift`) and the compute on either side is
// this file:
//
//   xlane_pack, four launches on one stream:
//     1. count, one thread per row g: walks the row's O outbox slots in
//        order (one counter per peer slot: the reference's k_excl) and
//        counts its sendable messages per destination device into
//        scan[g, d]; the drop counts go to the stats (warp sums, one
//        atomic each: integer sums do not depend on order).
//     2. scan, ONE block of 1024 threads: the exclusive scan of
//        scan[:, d] over the rows, in row order — so the lane slot q of
//        a message is the count of earlier sendable messages to the
//        same device in flat (g, o) order (route.py:742-747), the same
//        on every run (an atomic counter would not be).  It writes the
//        per-device totals, `sent` and `dropped_xlane`.
//     3. write, one thread per row: the same walk, each message with
//        q < XB written as its packed row at xbuf[d, q].
//     4. zero, one thread per xbuf word: rows past a device's total.
//   xlane_scatter, one launch: one thread per received row; a row with
//     found != 0 is counted in `delivered` and, when its row and slot
//     lie in [0, G) x [0, M), its fields are ADDED into the inbox with
//     atomicAdd (the reference's one-hot sum, exact even if two rows
//     met).
//
// Per-message arithmetic kept as the reference's: `hits` is every peer
// slot whose id matches, xdev / xloc / xrank are SUMS of the tables
// over the hits (at_pstar, :711) and b is the sum of k_excl over the
// hits (:737); deliverability uses the below-ring marker and the ring
// window max(first_index, last_index - (W-1)) (:719-729); a forwarded
// PROPOSE never rides the lane; payload word e is the sender's ring at
// max(log_index + 1 + e, 0) & (W-1) while e < n_entries.
//
// Bound: bytes.  The pack reads the outbox (G*O*11 words), the row's
// tables and ring words for carried entries, and writes xbuf (D*XB*KT
// words); the scatter reads (D-1)*XB*KT words and adds into the inbox
// words it delivers.  The one-block scan is latency-bound (G/1024
// chunks of D columns).
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain
// C++: then only the per-row logic (`xlane_row`, `xlane_scan_host`,
// `xlane_scatter_row`) is built.
#include "common.cuh"
#include "launch.h"

namespace dbt {

// packed lane row (route.py:638-649): 9 wire fields, sender replica id,
// destination local row, destination region rank, region slot b, found,
// then E entry terms and E entry cc bits
constexpr int XN_WIRE = 9;
constexpr int XI_FROM = XN_WIRE;
constexpr int XI_LOC = XN_WIRE + 1;
constexpr int XI_RANK = XN_WIRE + 2;
constexpr int XI_B = XN_WIRE + 3;
constexpr int XI_FOUND = XN_WIRE + 4;
constexpr int X_KF = XN_WIRE + 5;
// most devices and peer slots a row's counters hold
constexpr int XDMAX = 16;
constexpr int XPMAX = 16;

DBT_HD int xwire_col(int i) {
  const int cols[XN_WIRE] = {F_MTYPE,  F_TERM,  F_LOG_TERM,
                             F_LOG_INDEX, F_COMMIT, F_REJECT,
                             F_HINT,   F_HINT_HIGH, F_N_ENTRIES};
  return cols[i];
}

DBT_HD int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

struct XPackArgs {
  const int* peer_id;      // [G, P]
  const int* replica_id;   // [G]
  const int* first_index;  // [G]
  const int* last_index;   // [G]
  const int* ring_term;    // [G, W]
  const int* ring_cc;      // [G, W]
  const int* buf;          // [G, O, N_FIELDS]
  const int* count;        // [G]
  const int* suppress;     // [G] nonzero = suppressed row, or null
  const int* dest_local;   // [G, P]
  const int* dest_dev;     // [G, P]
  const int* rank;         // [G, P]
  int* xbuf;               // [D, XB, KT]
  int* scan;               // [G, D] counts -> offsets, then [D] totals
  int* stats;              // [7]
  int G, P, W, O, E, D, XB, B, me;
};

// Row g's walk.  Count mode (write = false): scan[g, d] = the row's
// sendable messages toward device d, and the row's dropped_budget,
// dropped_ring, sendable and suppressed counts added to s[0..3].  Write
// mode: each sendable message toward device d gets slot q = scan[g, d]
// (its exclusive offset) + the earlier ones of the row, and is packed
// at xbuf[d, q] when q < XB.
DBT_HD void xlane_row(const XPackArgs& a, int g, int* s, bool write) {
  const int P = a.P, O = a.O, B = a.B, E = a.E, W = a.W, D = a.D;
  const int KT = X_KF + 2 * E;
  int cnt[XPMAX], pid[XPMAX];
  int nd[XDMAX];
  const long long pb = (long long)g * P;
  for (int p = 0; p < P; ++p) {
    cnt[p] = 0;
    pid[p] = a.peer_id[pb + p];
  }
  for (int d = 0; d < D; ++d) nd[d] = write ? a.scan[(long long)g * D + d] : 0;
  const bool sup = a.suppress && a.suppress[g] != 0;
  const int count = a.count[g];
  const int last = a.last_index[g];
  const int win_lo = imax(a.first_index[g], wsub(last, W - 1));
  for (int o = 0; o < O; ++o) {
    const int* m = a.buf + ((long long)g * O + o) * N_FIELDS;
    const bool v = o < count && !sup;
    const int mt = m[F_MTYPE], to = m[F_TO], n_ent = m[F_N_ENTRIES];
    const int li = m[F_LOG_INDEX], lt = m[F_LOG_TERM];
    bool found = false;
    int xdev = 0, xloc = 0, xrank = 0, b = 0;
    for (int p = 0; p < P; ++p) {
      const bool h = pid[p] == to && to != 0 && pid[p] != 0;
      if (!h) continue;
      found = true;
      xdev = wadd(xdev, a.dest_dev[pb + p]);
      xloc = wadd(xloc, a.dest_local[pb + p]);
      xrank = wadd(xrank, a.rank[pb + p]);
      b += cnt[p];
    }
    const bool is_repl = mt == MT_REPLICATE;
    const bool carries = is_repl && n_ent > 0;
    const bool marker = is_repl && li > 0 && lt == 0;
    const bool ring_ok =
        !carries ||
        (wadd(li, 1) >= win_lo && wadd(li, n_ent) <= last && !marker);
    const bool remote = found && xdev >= 0 && xdev != a.me;
    const bool routable = v && remote && mt != MT_PROPOSE;
    const bool deliverable = routable && ring_ok;
    if (deliverable) {
      for (int p = 0; p < P; ++p)
        if (pid[p] == to && to != 0 && pid[p] != 0) ++cnt[p];
    }
    const bool in_b = b < B;
    const bool sendable = deliverable && in_b;
    if (!write) {
      if (deliverable && !in_b) s[0] += 1;
      if (routable && !ring_ok) s[1] += 1;
      if (sendable) s[2] += 1;
    }
    // a device outside [0, D) has no lane: counted as dropped_xlane
    if (!sendable || xdev >= D) continue;
    const int q = nd[xdev]++;
    if (!write || q >= a.XB) continue;
    int* row = a.xbuf + ((long long)xdev * a.XB + q) * KT;
    for (int i = 0; i < XN_WIRE; ++i) row[i] = m[xwire_col(i)];
    row[XI_FROM] = a.replica_id[g];
    row[XI_LOC] = xloc;
    row[XI_RANK] = xrank;
    row[XI_B] = b;
    row[XI_FOUND] = 1;
    for (int e = 0; e < E; ++e) {
      const bool has_e = carries && e < n_ent;
      const int pos = imax(wadd(wadd(li, 1), e), 0) & (W - 1);
      row[X_KF + e] = has_e ? a.ring_term[(long long)g * W + pos] : 0;
      row[X_KF + E + e] = has_e ? a.ring_cc[(long long)g * W + pos] : 0;
    }
  }
  if (!write) {
    for (int d = 0; d < D; ++d) a.scan[(long long)g * D + d] = nd[d];
    if (sup) s[3] += 1;
  }
}

// The stats row once the counts are in: stats[3] holds the sendable
// count and stats[5] the suppressed rows; tot[d] is device d's total.
DBT_HD void xlane_finish_stats(const XPackArgs& a, const int* tot) {
  int sent = 0;
  for (int d = 0; d < a.D; ++d) sent += imin(tot[d], a.XB);
  a.stats[0] = sent;
  a.stats[3] -= sent;
  a.stats[6] = a.G - a.stats[5];
}

// xbuf word t is zero when its row lies past its device's total
DBT_HD void xlane_zero_word(const XPackArgs& a, long long t) {
  const long long per = (long long)a.XB * (X_KF + 2 * a.E);
  const int d = (int)(t / per);
  const long long q = (t % per) / (X_KF + 2 * a.E);
  if (q >= a.scan[(long long)a.G * a.D + d]) a.xbuf[t] = 0;
}

// The scan on the host (plain C++ builds): counts -> exclusive offsets
// in row order, the totals after them.
DBT_HD void xlane_scan_host(const XPackArgs& a) {
  int tot[XDMAX];
  for (int d = 0; d < a.D; ++d) tot[d] = 0;
  for (int g = 0; g < a.G; ++g)
    for (int d = 0; d < a.D; ++d) {
      int* c = a.scan + (long long)g * a.D + d;
      const int n = *c;
      *c = tot[d];
      tot[d] += n;
    }
  for (int d = 0; d < a.D; ++d) a.scan[(long long)a.G * a.D + d] = tot[d];
  xlane_finish_stats(a, tot);
}

struct XScatArgs {
  int* inbox[N_INBOX];  // [G, M(, E)], added into
  const int* recv;      // [R, KT]
  int* stats;           // [7]: delivered at [1]
  int R, G, M, E, B, base;
};

DBT_HD void xadd(int* p, int v) {
  if (v == 0) return;
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p = wadd(*p, v);
#endif
}

// Received row r: returns 1 when it carries a message (found != 0).
DBT_HD int xlane_scatter_row(const XScatArgs& a, long long r) {
  const int E = a.E;
  const int* x = a.recv + r * (X_KF + 2 * E);
  if (x[XI_FOUND] == 0) return 0;
  const int row = x[XI_LOC];
  const int slot = wadd(wadd(a.base, wmul(x[XI_RANK], a.B)), x[XI_B]);
  if (row < 0 || row >= a.G || slot < 0 || slot >= a.M) return 1;
  const long long at = (long long)row * a.M + slot;
  // Inbox order: mtype, from_id, term .. n_entries, ent_term, ent_cc
  xadd(a.inbox[0] + at, x[0]);
  xadd(a.inbox[1] + at, x[XI_FROM]);
  for (int i = 1; i < XN_WIRE; ++i) xadd(a.inbox[i + 1] + at, x[i]);
  for (int e = 0; e < E; ++e) {
    xadd(a.inbox[10] + at * E + e, x[X_KF + e]);
    xadd(a.inbox[11] + at * E + e, x[X_KF + E + e]);
  }
  return 1;
}

}  // namespace dbt

#ifdef __CUDACC__
namespace {

constexpr int SCAN_THREADS = 1024;

__device__ void warp_add(int* dst, int v, bool active) {
  const int s = __reduce_add_sync(0xffffffffu, active ? v : 0);
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(dst, s);
}

__global__ void xlane_count_kernel(const dbt::XPackArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int s[4] = {0, 0, 0, 0};
  const bool active = g < a.G;
  if (active) dbt::xlane_row(a, g, s, false);
  warp_add(a.stats + 2, s[0], active);  // dropped_budget
  warp_add(a.stats + 4, s[1], active);  // dropped_ring
  warp_add(a.stats + 3, s[2], active);  // sendable (less sent: dropped_xlane)
  warp_add(a.stats + 5, s[3], active);  // suppressed rows
}

__global__ void __launch_bounds__(SCAN_THREADS)
xlane_scan_kernel(const dbt::XPackArgs a) {
  __shared__ int wsum[SCAN_THREADS / 32][dbt::XDMAX];
  __shared__ int carry[dbt::XDMAX];
  __shared__ int chunk[dbt::XDMAX];
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D;
  if (tid < D) carry[tid] = 0;
  __syncthreads();
  for (int base = 0; base < a.G; base += SCAN_THREADS) {
    const int g = base + tid;
    const bool in = g < a.G;
    int v[dbt::XDMAX], inc[dbt::XDMAX];
    for (int d = 0; d < D; ++d) {
      v[d] = in ? a.scan[(long long)g * D + d] : 0;
      int x = v[d];
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(full, x, off);
        if (lane >= off) x += n;
      }
      inc[d] = x;
      if (lane == 31) wsum[warp][d] = x;
    }
    __syncthreads();
    if (warp == 0) {
      for (int d = 0; d < D; ++d) {
        const int w = wsum[lane][d];
        int x = w;
        for (int off = 1; off < 32; off <<= 1) {
          const int n = __shfl_up_sync(full, x, off);
          if (lane >= off) x += n;
        }
        wsum[lane][d] = x - w;
        if (lane == 31) chunk[d] = x;
      }
    }
    __syncthreads();
    if (in)
      for (int d = 0; d < D; ++d)
        a.scan[(long long)g * D + d] = carry[d] + wsum[warp][d] + inc[d] - v[d];
    __syncthreads();
    if (tid < D) carry[tid] += chunk[tid];
    __syncthreads();
  }
  if (tid < D) a.scan[(long long)a.G * D + tid] = carry[tid];
  if (tid == 0) dbt::xlane_finish_stats(a, carry);
}

__global__ void xlane_write_kernel(const dbt::XPackArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int s[4];
  if (g < a.G) dbt::xlane_row(a, g, s, true);
}

__global__ void xlane_zero_kernel(const dbt::XPackArgs a, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) dbt::xlane_zero_word(a, t);
}

__global__ void xlane_scatter_kernel(const dbt::XScatArgs a) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = r < a.R;
  const int hit = active ? dbt::xlane_scatter_row(a, r) : 0;
  warp_add(a.stats + 1, hit, active);
}

}  // namespace

void dbt::xlane_pack_launch(const int* const* st, const int* buf,
                            const int* count, const int* suppress,
                            const int* dest_local, const int* dest_dev,
                            const int* rank, int* xbuf, int* scan,
                            int* stats, int G, int P, int W, int O, int E,
                            int D, int XB, int B, int me, void* stream) {
  dbt::XPackArgs a;
  a.peer_id = st[0];
  a.replica_id = st[1];
  a.first_index = st[2];
  a.last_index = st[3];
  a.ring_term = st[4];
  a.ring_cc = st[5];
  a.buf = buf;
  a.count = count;
  a.suppress = suppress;
  a.dest_local = dest_local;
  a.dest_dev = dest_dev;
  a.rank = rank;
  a.xbuf = xbuf;
  a.scan = scan;
  a.stats = stats;
  a.G = G;
  a.P = P;
  a.W = W;
  a.O = O;
  a.E = E;
  a.D = D;
  a.XB = XB;
  a.B = B;
  a.me = me;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(stats, 0, dbt::N_LANE_STATS * sizeof(int), s);
  const int threads = 256;
  const unsigned rows = (unsigned)((G + threads - 1) / threads);
  if (G > 0) xlane_count_kernel<<<rows, threads, 0, s>>>(a);
  xlane_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(a);
  if (G > 0) xlane_write_kernel<<<rows, threads, 0, s>>>(a);
  const long long total = (long long)D * XB * (dbt::X_KF + 2 * E);
  if (total > 0)
    xlane_zero_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, s>>>(a, total);
}

void dbt::xlane_scatter_launch(int* const* inbox, const int* recv,
                               int* stats, int R, int G, int M, int E, int B,
                               int base, void* stream) {
  dbt::XScatArgs a;
  for (int i = 0; i < dbt::N_INBOX; ++i) a.inbox[i] = inbox[i];
  a.recv = recv;
  a.stats = stats;
  a.R = R;
  a.G = G;
  a.M = M;
  a.E = E;
  a.B = B;
  a.base = base;
  if (R == 0) return;
  const int threads = 256;
  xlane_scatter_kernel<<<(unsigned)((R + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>(a);
}
#endif
