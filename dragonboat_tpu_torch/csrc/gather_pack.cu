// gather_pack: the post-step readback packer.
//
// Replaces dragonboat_tpu/ops/engine.py `_gather_detail` (engine.py:273),
// `_gather_vals` (:248) and `_gather_detail_vals` (:315): for the
// flagged rows it packs, into ONE flat int32 output,
//   detail: b rows of K = O*11 + M + M + M*E + P + W + W words
//           (buf[idx_buf], slot_base/slot_term/ent_drop[idx_slot],
//            need_snapshot[idx_need], ring_term/ring_cc[idx_ring]) —
//           the order `_split_detail` reads;
//   values: b2 rows of N_VALS words (R_* order) at idx_sum.
// Modes: detail only (b2 = 0), values only (b = 0), or both.
//
// One block per packed row, its threads striding over the row's words.
// Bound: bytes — each gathered word is read once and written once.
// A row index below 0 counts from the end and any index is then
// clamped into [0, G), as the reference's gathers do.
#include "common.cuh"
#include "launch.h"

namespace dbt {

struct PackArgs {
  const int* buf;            // [G, O, N_FIELDS]
  const int* slot_base;      // [G, M]
  const int* slot_term;      // [G, M]
  const int* ent_drop;       // [G, M, E]
  const int* need_snapshot;  // [G, P]
  const int* ring_term;      // [G, W]
  const int* ring_cc;        // [G, W]
  // values: term, vote, committed, leader_id, role, last_index, count,
  // append_lo, barrier_idx, barrier_term
  const int* vals[N_VALS];
  const int* idx4;           // [4, b]: buf, slot, need, ring row sets
  const int* idx_sum;        // [b2]
  int* flat;                 // [b*K + b2*N_VALS]
  int G, O, M, E, P, W, b, b2;
};

DBT_HD int fix_row(int i, int G) {
  if (i < 0) i += G;
  return i < 0 ? 0 : (i >= G ? G - 1 : i);
}

DBT_HD int detail_width(const PackArgs& a) {
  return a.O * N_FIELDS + 2 * a.M + a.M * a.E + a.P + 2 * a.W;
}

// word w of packed detail row r
DBT_HD int detail_word(const PackArgs& a, int r, int w) {
  int n = a.O * N_FIELDS;
  if (w < n) return a.buf[(long long)fix_row(a.idx4[r], a.G) * n + w];
  w -= n;
  int gs = fix_row(a.idx4[a.b + r], a.G);
  if (w < a.M) return a.slot_base[(long long)gs * a.M + w];
  w -= a.M;
  if (w < a.M) return a.slot_term[(long long)gs * a.M + w];
  w -= a.M;
  if (w < a.M * a.E) return a.ent_drop[(long long)gs * a.M * a.E + w];
  w -= a.M * a.E;
  if (w < a.P) {
    int gn = fix_row(a.idx4[2 * a.b + r], a.G);
    return a.need_snapshot[(long long)gn * a.P + w];
  }
  w -= a.P;
  int gr = fix_row(a.idx4[3 * a.b + r], a.G);
  if (w < a.W) return a.ring_term[(long long)gr * a.W + w];
  w -= a.W;
  return a.ring_cc[(long long)gr * a.W + w];
}

}  // namespace dbt

#ifdef __CUDACC__
__global__ void gather_pack_kernel(const dbt::PackArgs a) {
  const int K = dbt::detail_width(a);
  const int r = blockIdx.x;
  if (r < a.b) {
    int* dst = a.flat + (long long)r * K;
    for (int w = threadIdx.x; w < K; w += blockDim.x)
      dst[w] = dbt::detail_word(a, r, w);
    return;
  }
  const int v = r - a.b;
  if (v >= a.b2 || threadIdx.x >= dbt::N_VALS) return;
  const int g = dbt::fix_row(a.idx_sum[v], a.G);
  a.flat[(long long)a.b * K + (long long)v * dbt::N_VALS + threadIdx.x] =
      a.vals[threadIdx.x][g];
}

void dbt::gather_pack_launch(const int* const* detail,
                             const int* const* vals, const int* idx4,
                             const int* idx_sum, int* flat, int G, int O,
                             int M, int E, int P, int W, int b, int b2,
                             void* stream) {
  dbt::PackArgs a;
  a.buf = detail[0];
  a.slot_base = detail[1];
  a.slot_term = detail[2];
  a.ent_drop = detail[3];
  a.need_snapshot = detail[4];
  a.ring_term = detail[5];
  a.ring_cc = detail[6];
  for (int f = 0; f < dbt::N_VALS; ++f) a.vals[f] = vals[f];
  a.idx4 = idx4;
  a.idx_sum = idx_sum;
  a.flat = flat;
  a.G = G;
  a.O = O;
  a.M = M;
  a.E = E;
  a.P = P;
  a.W = W;
  a.b = b;
  a.b2 = b2;
  if (b + b2 == 0) return;
  gather_pack_kernel<<<b + b2, 128, 0, (cudaStream_t)stream>>>(a);
}
#endif
