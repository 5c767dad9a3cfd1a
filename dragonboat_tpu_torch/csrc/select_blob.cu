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
// capacities are clamped to G).  The counts are reported even when they
// exceed the capacities.
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
// Bound: bytes — the [G] flag, combo and bits words read once, the head
// and the detail written once, the detail's rows read once, plus the
// scratch (a mask byte a row, written and read; the block totals).
//
// Design: a grid-wide count / scan / write on the pattern of xlane.cu's
// lane pack, blocks of SB_THREADS rows (one a thread):
//   1. count (select_count_kernel): each thread computes its row's five
//      selection bits once and stores them as one byte in the scratch
//      mask; the block writes its five totals (warp reductions).  The same
//      grid copies the head prefix (flags, delivered bits, route stats).
//   2. scan (select_scan_kernel): one block scans the nb x 5 block totals
//      into block offsets and writes the five counts into the head.
//   3. write (select_write_kernel): each block re-reads its mask bytes; a
//      ballot and a scan of the warps' counts give each row its rank in
//      its section's selected run (the rows selected before it), or in
//      the unselected run (count + g - before).  A row whose rank is below
//      the capacity writes its id into the head and joins the block's list
//      for that section; then the block gathers its listed rows' detail
//      words into detail slot `rank`, flattened over (section, row, unit)
//      and spread over SB_WRITE_THREADS threads (4 a row): the first
//      blocks hold the first tier's rows, so their gathers are the pass's
//      critical path, bound by the instructions an item costs on one SM.
//      The buf and ring rows move in 16-byte units where every address
//      is aligned, the slot and need rows word by word.  No kernel reads
//      a row id back from device memory, and only ranks below the
//      capacities cost more than the rank itself.
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain C++:
// then `sel_args`, `sel_mask`, `prefix_word`, `sel_rank`, `det_width`,
// `det_item`, `det_load` and `det_store` are host functions, which a host
// loop runs pass by pass, block by block, with the ballots made from the
// rows' bits, to check the kernels' logic without a card.
#include "blocks.cuh"
#include "common.cuh"
#include "launch.h"

namespace dbt {

// rows a block of the count and write passes (one a thread of the count
// pass, one a thread of the write pass's first SB_THREADS)
constexpr int SB_THREADS = 256;
constexpr int SB_SCAN_THREADS = 512;
// threads a block of the write pass: the first tier's listed rows lie in
// the first blocks, so their gathers are the pass's critical path, and
// all these threads share them
constexpr int SB_WRITE_THREADS = 1024;
constexpr int SB_NK = 5;  // sections: buf, slot, need, append, sum
constexpr int SB_ND = 4;  // sections with detail rows: buf .. append
// detail words a thread loads before it stores them
constexpr int SB_BATCH = 4;

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
  unsigned char* mask;  // [G] scratch: a row's selection bits
  int* btot;            // [nb, 5] scratch: a block's selected rows
  int* boff;            // [nb, 5] scratch: the selected rows before it
  int cap[SB_NK];       // buf, slot, need, append, sum
  long long dbase[SB_ND];  // where each detail section starts
  int quad[SB_ND];      // the section moves 16-byte units (else words)
  FastDiv ddiv[SB_ND];  // by each detail section's units a row
  int G, nw, O, Mo, E, P, W, host_off, nb;
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

DBT_HD long long prefix_words(const SelArgs& a) {
  return (long long)a.G + (long long)a.G * a.nw + 6;
}

DBT_HD long long head_rows_at(const SelArgs& a, int k) {
  long long off = prefix_words(a) + SB_NK;
  for (int i = 0; i < k; ++i) off += a.cap[i];
  return off;
}

// head word i < prefix_words: the flags, the delivered bits, the stats
DBT_HD int prefix_word(const SelArgs& a, long long i) {
  const long long G = a.G, gb = G * a.nw;
  return i < G ? a.flags[i]
               : (i < G + gb ? a.packed[i - G] : a.stats[i - G - gb]);
}

// row g's place in a section: its rank among the selected rows when it
// is selected (`before` = the selected rows before it), else the
// section's count `tot` plus its rank among the unselected rows
DBT_HD int sel_rank(int tot, int g, bool sel, int before) {
  return sel ? before : tot + (g - before);
}

DBT_HD int host_cols(const SelArgs& a) { return a.Mo - a.host_off; }

// detail words a row of section k
DBT_HD int det_width(const SelArgs& a, int k) {
  const int Mh = host_cols(a);
  return k == 0 ? a.O * N_FIELDS
                : (k == 1 ? Mh * (2 + a.E) : (k == 2 ? a.P : 2 * a.W));
}

// where section k starts in the detail blob
DBT_HD long long det_base(const SelArgs& a, int k) {
  long long off = 0;
  for (int i = 0; i < k; ++i) off += (long long)a.cap[i] * det_width(a, i);
  return off;
}

// Unit u of row g's detail in section k, for the row's slot `rank`: its
// words into *q (4 in a quad section, else 1 in q->v[0]) and their place
// in the detail blob (*at).  The buf and ring rows are contiguous in
// both, so those sections move 16-byte units where the launcher found
// every address aligned.
DBT_HD void det_load(const SelArgs& a, int k, int rank, int g, int u,
                     Quad* q, long long* at) {
  const long long base = a.dbase[k];
  if (k == 0) {
    const long long dw = (long long)a.O * N_FIELDS;
    const int w = a.quad[0] ? 4 * u : u;
    *at = base + rank * dw + w;
    if (a.quad[0])
      *q = load4(a.buf + g * dw + w);
    else
      q->v[0] = a.buf[g * dw + w];
    return;
  }
  if (k == 1) {
    const int Mh = host_cols(a);
    const long long cs = a.cap[1];
    const long long row = (long long)g * a.Mo + a.host_off;
    if (u < Mh) {
      *at = base + (long long)rank * Mh + u;
      q->v[0] = a.slot_base[row + u];
    } else if (u < 2 * Mh) {
      *at = base + cs * Mh + (long long)rank * Mh + (u - Mh);
      q->v[0] = a.slot_term[row + (u - Mh)];
    } else {
      const int x = u - 2 * Mh;
      *at = base + 2 * cs * Mh + (long long)rank * Mh * a.E + x;
      q->v[0] = a.ent_drop[row * a.E + x];
    }
    return;
  }
  if (k == 2) {
    *at = base + (long long)rank * a.P + u;
    q->v[0] = a.need_snapshot[(long long)g * a.P + u];
    return;
  }
  const int w = a.quad[3] ? 4 * u : u;
  const bool cc = w >= a.W;
  const int x = cc ? w - a.W : w;
  *at = base + (cc ? (long long)a.cap[3] * a.W : 0) +
        (long long)rank * a.W + x;
  const int* src = (cc ? a.ring_cc : a.ring_term) + (long long)g * a.W + x;
  if (a.quad[3])
    *q = load4(src);
  else
    q->v[0] = *src;
}

DBT_HD void det_store(const SelArgs& a, int k, long long at, const Quad& q) {
  if (a.quad[k])
    store4(a.detail + at, q);
  else
    a.detail[at] = q.v[0];
}

// Item j of a write block's gather, flattened over its four sections'
// listed rows and their units: base[i] is the items before section i
// (base[SB_ND] all); the item's section k, its entry e in the section's
// list and its unit w
DBT_HD void det_item(const SelArgs& a, const int* base, int j, int* k,
                     int* e, int* w) {
  const int s = seg_of(base, SB_ND, j);
  const int r = j - base[s];
  const int q = fdiv(a.ddiv[s], r);
  *k = s;
  *e = q;
  *w = r - q * a.ddiv[s].d;
}

// Host side: the arguments of one call; returns 0, or 2 (a block's detail
// rows too wide for int offsets)
inline int sel_args(SelArgs& a, const int* flags, const int* combo,
                    const int* packed, const int* stats,
                    const int* const* detail_srcs, int* head, int* detail,
                    unsigned char* mask, int* btot, int* boff,
                    const int* caps, int G, int nw, int O, int Mo, int E,
                    int P, int W, int host_off) {
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
  a.mask = mask;
  a.btot = btot;
  a.boff = boff;
  for (int k = 0; k < SB_NK; ++k) a.cap[k] = caps[k];
  a.G = G;
  a.nw = nw;
  a.O = O;
  a.Mo = Mo;
  a.E = E;
  a.P = P;
  a.W = W;
  a.host_off = host_off;
  a.nb = (G + SB_THREADS - 1) / SB_THREADS;
  const bool det16 = is_aligned16(detail);
  for (int k = 0; k < SB_ND; ++k) {
    const int dw = det_width(a, k);
    if ((long long)SB_THREADS * dw >= (1LL << 31)) return 2;
    a.dbase[k] = det_base(a, k);
    a.quad[k] = 0;
    if (k == 0)
      a.quad[k] = dw % 4 == 0 && det16 && is_aligned16(a.buf);
    if (k == 3)
      a.quad[k] = a.W % 4 == 0 && det16 && a.dbase[k] % 4 == 0 &&
                  is_aligned16(a.ring_term) && is_aligned16(a.ring_cc);
    const int du = a.quad[k] ? dw / 4 : dw;
    a.ddiv[k] = fast_div(du > 0 ? du : 1);
    a.ddiv[k].d = du;  // a section without detail words has no units
  }
  return 0;
}

}  // namespace dbt

#ifdef __CUDACC__
namespace {

constexpr int NWARP = dbt::SB_THREADS / 32;

// count: a row a thread; the block's totals; the head prefix, grid-stride
__global__ void __launch_bounds__(dbt::SB_THREADS)
    select_count_kernel(const __grid_constant__ dbt::SelArgs a) {
  __shared__ int wsum[NWARP][dbt::SB_NK];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * dbt::SB_THREADS + threadIdx.x;
  const int m = g < a.G ? dbt::sel_mask(a, g) : 0;
  if (g < a.G) a.mask[g] = (unsigned char)m;
#pragma unroll
  for (int k = 0; k < dbt::SB_NK; ++k) {
    const int v = __reduce_add_sync(full, (m >> k) & 1);
    if (lane == 0) wsum[warp][k] = v;
  }
  const long long np = dbt::prefix_words(a);
  const long long stride = (long long)gridDim.x * dbt::SB_THREADS;
  for (long long i = g; i < np; i += stride)
    a.head[i] = dbt::prefix_word(a, i);
  __syncthreads();
  if (threadIdx.x < dbt::SB_NK) {
    int t = 0;
    for (int w = 0; w < NWARP; ++w) t += wsum[w][threadIdx.x];
    a.btot[blockIdx.x * dbt::SB_NK + threadIdx.x] = t;
  }
}

// scan: one block; thread t sums `per` consecutive blocks' totals, a
// block-wide scan of those sums gives each block's offsets and the counts
__global__ void __launch_bounds__(dbt::SB_SCAN_THREADS)
    select_scan_kernel(const __grid_constant__ dbt::SelArgs a) {
  constexpr int NW = dbt::SB_SCAN_THREADS / 32;
  __shared__ int wsum[NW][dbt::SB_NK];
  __shared__ int total[dbt::SB_NK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = a.nb;
  const int per = (n + dbt::SB_SCAN_THREADS - 1) / dbt::SB_SCAN_THREADS;
  const int lo = dbt::imin((int)threadIdx.x * per, n);
  const int hi = dbt::imin(lo + per, n);
  int v[dbt::SB_NK], incl[dbt::SB_NK];
#pragma unroll
  for (int k = 0; k < dbt::SB_NK; ++k) v[k] = 0;
  for (int i = lo; i < hi; ++i) {
#pragma unroll
    for (int k = 0; k < dbt::SB_NK; ++k) v[k] += a.btot[i * dbt::SB_NK + k];
  }
#pragma unroll
  for (int k = 0; k < dbt::SB_NK; ++k) {
    incl[k] = dbt::warp_incl_scan(v[k]);
    if (lane == 31) wsum[warp][k] = incl[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < dbt::SB_NK; ++k) {
      const int x = lane < NW ? wsum[lane][k] : 0;
      const int xi = dbt::warp_incl_scan(x);
      if (lane < NW) wsum[lane][k] = xi - x;
      if (lane == 31) total[k] = xi;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < dbt::SB_NK; ++k) {
    int run = wsum[warp][k] + incl[k] - v[k];
    for (int i = lo; i < hi; ++i) {
      a.boff[i * dbt::SB_NK + k] = run;
      run += a.btot[i * dbt::SB_NK + k];
    }
  }
  if (threadIdx.x < dbt::SB_NK)
    a.head[dbt::prefix_words(a) + threadIdx.x] = total[threadIdx.x];
}

// write: ranks from ballots and the block offsets (the first SB_THREADS
// threads, a row each), the row ids below the capacities into the head,
// then the listed rows' detail words (every thread)
__global__ void __launch_bounds__(dbt::SB_WRITE_THREADS)
    select_write_kernel(const __grid_constant__ dbt::SelArgs a) {
  __shared__ int wpre[NWARP][dbt::SB_NK];
  __shared__ int2 list[dbt::SB_ND][dbt::SB_THREADS];  // (rank, g)
  __shared__ int nlist[dbt::SB_ND];
  __shared__ int base[dbt::SB_ND + 1];
  // the counts and the block's offsets, read once before any store
  __shared__ int tot[dbt::SB_NK], boff[dbt::SB_NK];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool ranker = warp < NWARP;
  const int g = blockIdx.x * dbt::SB_THREADS + threadIdx.x;
  if (threadIdx.x < dbt::SB_NK) {
    tot[threadIdx.x] = a.head[dbt::prefix_words(a) + threadIdx.x];
    boff[threadIdx.x] = a.boff[blockIdx.x * dbt::SB_NK + threadIdx.x];
  }
  if (threadIdx.x < dbt::SB_ND) nlist[threadIdx.x] = 0;
  int m = 0, pre[dbt::SB_NK];
  if (ranker) {
    m = g < a.G ? a.mask[g] : 0;
#pragma unroll
    for (int k = 0; k < dbt::SB_NK; ++k) {
      const unsigned bal = __ballot_sync(full, (m >> k) & 1);
      pre[k] = dbt::bits_below(bal, lane);
      if (lane == 0) wpre[warp][k] = __popc(bal);
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < dbt::SB_NK; ++k) {
      const int x = lane < NWARP ? wpre[lane][k] : 0;
      const int xi = dbt::warp_incl_scan(x);
      if (lane < NWARP) wpre[lane][k] = xi - x;
    }
  }
  __syncthreads();
  if (ranker) {
#pragma unroll
    for (int k = 0; k < dbt::SB_NK; ++k) {
      const bool sel = (m >> k) & 1;
      const int before = boff[k] + wpre[warp][k] + pre[k];
      const int rank = g < a.G ? dbt::sel_rank(tot[k], g, sel, before) : 0;
      const bool keep = g < a.G && rank < a.cap[k];
      if (keep) a.head[dbt::head_rows_at(a, k) + rank] = g;
      if (k < dbt::SB_ND) {
        const unsigned bal = __ballot_sync(full, keep);
        if (bal) {
          int b0 = 0;
          if (lane == 0) b0 = atomicAdd(&nlist[k], __popc(bal));
          b0 = __shfl_sync(full, b0, 0);
          if (keep)
            list[k][b0 + dbt::bits_below(bal, lane)] = make_int2(rank, g);
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int k = 0; k < dbt::SB_ND; ++k) {
      base[k] = n;
      n += nlist[k] * a.ddiv[k].d;
    }
    base[dbt::SB_ND] = n;
  }
  __syncthreads();
  const int total = base[dbt::SB_ND];
  constexpr int STEP = dbt::SB_WRITE_THREADS * dbt::SB_BATCH;
  for (int j0 = threadIdx.x; j0 < total; j0 += STEP) {
    dbt::Quad q[dbt::SB_BATCH];
    long long at[dbt::SB_BATCH];
    int ks[dbt::SB_BATCH];
#pragma unroll
    for (int b = 0; b < dbt::SB_BATCH; ++b) {
      const int j = j0 + b * dbt::SB_WRITE_THREADS;
      if (j < total) {
        int e, u;
        dbt::det_item(a, base, j, &ks[b], &e, &u);
        const int2 rg = list[ks[b]][e];
        dbt::det_load(a, ks[b], rg.x, rg.y, u, &q[b], &at[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < dbt::SB_BATCH; ++b)
      if (j0 + b * dbt::SB_WRITE_THREADS < total)
        dbt::det_store(a, ks[b], at[b], q[b]);
  }
}

}  // namespace

int dbt::select_blob_launch(const int* flags, const int* combo,
                            const int* packed, const int* stats,
                            const int* const* detail_srcs, int* head,
                            int* detail, unsigned char* mask, int* btot,
                            int* boff, const int* caps, int G, int nw, int O,
                            int Mo, int E, int P, int W, int host_off,
                            void* stream) {
  dbt::SelArgs a;
  const int rc = dbt::sel_args(a, flags, combo, packed, stats, detail_srcs,
                               head, detail, mask, btot, boff, caps, G, nw, O,
                               Mo, E, P, W, host_off);
  if (rc || G == 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  select_count_kernel<<<a.nb, dbt::SB_THREADS, 0, s>>>(a);
  select_scan_kernel<<<1, dbt::SB_SCAN_THREADS, 0, s>>>(a);
  select_write_kernel<<<a.nb, dbt::SB_WRITE_THREADS, 0, s>>>(a);
  return 0;
}
#endif
