// place_rows: row placement through a position map, and the (g, p)
// remote-snapshot store.
//
// Replaces dragonboat_tpu/ops/engine.py `_scatter_rows` (engine.py:163),
// `_select_rows` (:180), `_gather_rows` (:189) and `_set_remote_snapshot`
// (:400).
//
// Mode 0, rows: for every field f of a list, out_f[g] = src_f[pos[g]]
// where pos[g] >= 0, else dst_f[g] (0 when there is no dst, the gather
// case).  One thread per (row, word) of the concatenated fields.  This
// one mode covers scatter (pos = the upload map), select (pos = g where
// the new row is kept, else -1, with src = new) and gather (pos = the
// index set, no dst).
//
// Mode 0 also takes the escalation merge of the colocated and routed
// rounds (route.py:454-462, colocated.py:223-229): pos is then the
// step's escalate word, and a row keeps dst (the pre-step state) where
// it is nonzero, else takes src (the post-step state).
//
// Mode 1, snapshot: out_rstate / out_snap are copies of rstate /
// snap_index with rstate = RS_SNAPSHOT and snap_index = snap[k] at every
// pair (g_idx[k], p_idx[k]); one thread per (g, p) word scans the pair
// list (it is a handful of pairs), the last pair naming a word wins.
//
// Bound: bytes — every word is read once and written once.
#include "common.cuh"
#include "launch.h"

namespace dbt {

struct PlaceArgs {
  const int* pos;  // [G_out]
  const int* dst[MAX_FIELDS];
  const int* src[MAX_FIELDS];
  int* out[MAX_FIELDS];
  int width[MAX_FIELDS];
  int n_fields, G_out, G_src;
  int esc_mode;     // pos is an escalate word: pos[g] != 0 -> dst, else src[g]
  long long total;  // G_out * sum(width)
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

DBT_HD int place_word(const PlaceArgs& a, long long t, int** out_at) {
  int f = 0;
  long long off = t;
  while (f < a.n_fields - 1 && off >= (long long)a.G_out * a.width[f]) {
    off -= (long long)a.G_out * a.width[f];
    ++f;
  }
  const int w = a.width[f];
  const int g = (int)(off / w);
  const int j = (int)(off % w);
  *out_at = a.out[f] + off;
  int p = a.pos[g];
  if (a.esc_mode) p = p != 0 ? -1 : g;
  if (p >= 0) {
    if (p >= a.G_src) p = a.G_src - 1;
    return a.src[f][(long long)p * w + j];
  }
  return a.dst[f] ? a.dst[f][off] : 0;
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
__global__ void place_rows_kernel(const dbt::PlaceArgs a) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.total) return;
  int* at;
  int v = dbt::place_word(a, t, &at);
  *at = v;
}

__global__ void place_snapshot_kernel(const dbt::SnapArgs a) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.G * a.P) return;
  int rs, sn;
  dbt::snap_word(a, t / a.P, t % a.P, &rs, &sn);
  a.out_rstate[t] = rs;
  a.out_snap[t] = sn;
}

namespace {

void place_launch(const int* pos, const int* const* dst, const int* const* src,
                  int* const* out, const int* width, int n_fields, int G_out,
                  int G_src, int esc_mode, void* stream) {
  dbt::PlaceArgs a;
  a.pos = pos;
  long long per_row = 0;
  for (int f = 0; f < n_fields; ++f) {
    a.dst[f] = dst[f];
    a.src[f] = src[f];
    a.out[f] = out[f];
    a.width[f] = width[f];
    per_row += width[f];
  }
  a.n_fields = n_fields;
  a.G_out = G_out;
  a.G_src = G_src;
  a.esc_mode = esc_mode;
  a.total = (long long)G_out * per_row;
  if (a.total == 0) return;
  const int threads = 256;
  long long blocks = (a.total + threads - 1) / threads;
  place_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
}

}  // namespace

void dbt::place_rows_launch(const int* pos, const int* const* dst,
                            const int* const* src, int* const* out,
                            const int* width, int n_fields, int G_out,
                            int G_src, void* stream) {
  place_launch(pos, dst, src, out, width, n_fields, G_out, G_src, 0, stream);
}

void dbt::select_escalated_launch(const int* escalate, const int* const* old_,
                                  const int* const* new_, int* const* out,
                                  const int* width, int n_fields, int G,
                                  void* stream) {
  place_launch(escalate, old_, new_, out, width, n_fields, G, G, 1, stream);
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
