// select_and_blob: the colocated launch's readback — five stable row
// compactions with their counts, then the head and detail int32 blobs.
//
// Replaces dragonboat_tpu/ops/colocated.py `_select_and_blob`
// (colocated.py:285).  Per row, from the flag word and the fused host
// upload combo[g, 0..2] (alive, batch, prop):
//   live   = (batch | (alive & anylive)) & !esc
//   buf    = live & F_COUNT      slot = prop & !esc
//   need   = live & F_NEED_SS    append = live & F_APPEND
//   sum    = live & (anylive | slot)
// Each section's row list is the reference's `pick`: a STABLE argsort of
// where(sel, 0, 1) cut to its capacity — the selected rows in ascending
// order, then the unselected rows in ascending order (no padding; the
// capacities are clamped to G).
//
// Head:   flags [G] | delivered bits [G*nw] | route stats [6] | counts [5]
//         | rows buf [CB] | slot [CSL] | need [CN] | append [CA] | sum [CS]
//         | values [CS*10]
// Detail: buf rows [CB*O*11] | slot_base host cols [CSL*Mh]
//         | slot_term host cols [CSL*Mh] | ent_drop host cols [CSL*Mh*E]
//         | need_snapshot rows [CN*P] | ring_term rows [CA*W]
//         | ring_cc rows [CA*W]
// where Mh = Mo - HOST_OFF (the host columns of the Mo-slot outbox
// arrays).  The values block is written by gather_pack (its values mode,
// reading the head's sum rows), as the reference gathers it with
// `_gather_vals`.
//
// Design: kernel 1 is ONE block of 1024 threads looping over G — a
// totals pass (block reduction of the five masks), then a chunked
// block-wide exclusive scan (warp ballots + a scan of the warp sums)
// that places each row in its section's selected or unselected run.
// Kernel 2 is a grid, one thread per head-prefix or detail word, copying
// the flag word, bits and stats and gathering the detail rows.
// Bound: bytes (the detail gathers and the [G] reads); kernel 1's single
// block is latency-bound at G = 30k (30 chunks of 1024 rows).
#include "common.cuh"
#include "launch.h"

namespace dbt {

struct SelArgs {
  const int* flags;   // [G]
  const int* combo;   // [G, 4]
  const int* packed;  // [G, nw]
  const int* stats;   // [6]
  const int* buf;     // [G, O, N_FIELDS]
  const int* slot_base;      // [G, Mo]
  const int* slot_term;      // [G, Mo]
  const int* ent_drop;       // [G, Mo, E]
  const int* need_snapshot;  // [G, P]
  const int* ring_term;      // [G, W]
  const int* ring_cc;        // [G, W]
  int* head;
  int* detail;
  int cap[5];  // buf, slot, need, append, sum
  int G, nw, O, Mo, E, P, W, host_off;
};

// bit k of the result: row g selected in section k (buf, slot, need,
// append, sum)
DBT_HD int sel_mask(const SelArgs& a, int g) {
  const int fl = a.flags[g];
  const int* c = a.combo + (long long)g * 4;
  const bool alive = c[0] != 0, batch = c[1] != 0, prop = c[2] != 0;
  const bool esc = (fl & F_ESC) != 0;
  const bool anylive = (fl & F_ANY_LIVE) != 0;
  const bool live = (batch || (alive && anylive)) && !esc;
  const bool slot = prop && !esc;
  int m = 0;
  if (live && (fl & F_COUNT)) m |= 1;
  if (slot) m |= 2;
  if (live && (fl & F_NEED_SS)) m |= 4;
  if (live && (fl & F_APPEND)) m |= 8;
  if (live && (anylive || slot)) m |= 16;
  return m;
}

DBT_HD long long head_rows_at(const SelArgs& a, int k) {
  long long off = (long long)a.G + (long long)a.G * a.nw + 6 + 5;
  for (int i = 0; i < k; ++i) off += a.cap[i];
  return off;
}

DBT_HD long long prefix_words(const SelArgs& a) {
  return (long long)a.G + (long long)a.G * a.nw + 6;
}

DBT_HD long long detail_words(const SelArgs& a) {
  const long long Mh = a.Mo - a.host_off;
  return (long long)a.cap[0] * a.O * N_FIELDS + 2 * a.cap[1] * Mh +
         a.cap[1] * Mh * a.E + (long long)a.cap[2] * a.P +
         2LL * a.cap[3] * a.W;
}

// word t of [head prefix ++ detail]
DBT_HD void blob_word(const SelArgs& a, long long t) {
  const long long np = prefix_words(a);
  if (t < np) {
    const long long G = a.G, gb = G * a.nw;
    a.head[t] = t < G ? a.flags[t]
                      : (t < G + gb ? a.packed[t - G] : a.stats[t - G - gb]);
    return;
  }
  long long d = t - np;
  int* out = a.detail + d;
  const int* rows;
  long long w;
  // buf rows
  rows = a.head + head_rows_at(a, 0);
  w = (long long)a.O * N_FIELDS;
  if (d < a.cap[0] * w) {
    *out = a.buf[rows[d / w] * w + d % w];
    return;
  }
  d -= a.cap[0] * w;
  // slot sections: host columns only
  rows = a.head + head_rows_at(a, 1);
  const long long Mh = a.Mo - a.host_off;
  if (d < 2 * a.cap[1] * Mh) {
    const int* src = d < a.cap[1] * Mh ? a.slot_base : a.slot_term;
    const long long dd = d % (a.cap[1] * Mh);
    *out = src[rows[dd / Mh] * (long long)a.Mo + a.host_off + dd % Mh];
    return;
  }
  d -= 2 * a.cap[1] * Mh;
  w = Mh * a.E;
  if (d < a.cap[1] * w) {
    *out = a.ent_drop[(rows[d / w] * (long long)a.Mo + a.host_off) * a.E +
                      d % w];
    return;
  }
  d -= a.cap[1] * w;
  // need rows
  rows = a.head + head_rows_at(a, 2);
  if (d < (long long)a.cap[2] * a.P) {
    *out = a.need_snapshot[rows[d / a.P] * (long long)a.P + d % a.P];
    return;
  }
  d -= (long long)a.cap[2] * a.P;
  // ring rows
  rows = a.head + head_rows_at(a, 3);
  const long long cw = (long long)a.cap[3] * a.W;
  const int* src = d < cw ? a.ring_term : a.ring_cc;
  const long long dd = d % cw;
  *out = src[rows[dd / a.W] * (long long)a.W + dd % a.W];
}

}  // namespace dbt

#ifdef __CUDACC__
namespace {

constexpr int SEL_THREADS = 1024;

__global__ void __launch_bounds__(SEL_THREADS)
select_rows_kernel(const dbt::SelArgs a) {
  __shared__ int tot[5];
  __shared__ int carry[5];
  __shared__ int wsum[SEL_THREADS / 32][5];  // exclusive warp offsets
  __shared__ int chunk[5];
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = SEL_THREADS / 32;
  if (tid < 5) {
    tot[tid] = 0;
    carry[tid] = 0;
  }
  __syncthreads();
  int loc[5] = {0, 0, 0, 0, 0};
  for (int g = tid; g < a.G; g += SEL_THREADS) {
    const int m = dbt::sel_mask(a, g);
    for (int k = 0; k < 5; ++k) loc[k] += (m >> k) & 1;
  }
  for (int k = 0; k < 5; ++k) {
    const int v = __reduce_add_sync(full, loc[k]);
    if (lane == 0 && v) atomicAdd(&tot[k], v);
  }
  __syncthreads();
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int base = 0; base < a.G; base += SEL_THREADS) {
    const int g = base + tid;
    const bool in = g < a.G;
    const int m = in ? dbt::sel_mask(a, g) : 0;
    int pre[5];
    for (int k = 0; k < 5; ++k) {
      const unsigned bal = __ballot_sync(full, (m >> k) & 1);
      pre[k] = __popc(bal & lt_mask);
      if (lane == 0) wsum[warp][k] = __popc(bal);
    }
    __syncthreads();
    if (warp == 0) {
      for (int k = 0; k < 5; ++k) {
        const int v = lane < nwarp ? wsum[lane][k] : 0;
        int inc = v;
        for (int off = 1; off < 32; off <<= 1) {
          const int n = __shfl_up_sync(full, inc, off);
          if (lane >= off) inc += n;
        }
        if (lane < nwarp) wsum[lane][k] = inc - v;
        if (lane == nwarp - 1) chunk[k] = inc;
      }
    }
    __syncthreads();
    if (in) {
      for (int k = 0; k < 5; ++k) {
        const int before = carry[k] + wsum[warp][k] + pre[k];
        const bool s = (m >> k) & 1;
        const int pos = s ? before : tot[k] + g - before;
        if (pos < a.cap[k]) a.head[dbt::head_rows_at(a, k) + pos] = g;
      }
    }
    __syncthreads();
    if (tid < 5) carry[tid] += chunk[tid];
    __syncthreads();
  }
  if (tid < 5) a.head[dbt::prefix_words(a) + tid] = tot[tid];
}

__global__ void blob_kernel(const dbt::SelArgs a, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) dbt::blob_word(a, t);
}

}  // namespace

void dbt::select_blob_launch(const int* flags, const int* combo,
                             const int* packed, const int* stats,
                             const int* const* detail_srcs, int* head,
                             int* detail, const int* caps, int G, int nw,
                             int O, int Mo, int E, int P, int W, int host_off,
                             void* stream) {
  dbt::SelArgs a;
  a.flags = flags;
  a.combo = combo;
  a.packed = packed;
  a.stats = stats;
  a.buf = detail_srcs[0];
  a.slot_base = detail_srcs[1];
  a.slot_term = detail_srcs[2];
  a.ent_drop = detail_srcs[3];
  a.need_snapshot = detail_srcs[4];
  a.ring_term = detail_srcs[5];
  a.ring_cc = detail_srcs[6];
  a.head = head;
  a.detail = detail;
  for (int k = 0; k < 5; ++k) a.cap[k] = caps[k];
  a.G = G;
  a.nw = nw;
  a.O = O;
  a.Mo = Mo;
  a.E = E;
  a.P = P;
  a.W = W;
  a.host_off = host_off;
  cudaStream_t s = (cudaStream_t)stream;
  select_rows_kernel<<<1, SEL_THREADS, 0, s>>>(a);
  const long long total = dbt::prefix_words(a) + dbt::detail_words(a);
  const int threads = 256;
  blob_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      a, total);
}
#endif
