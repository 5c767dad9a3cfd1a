// inbox: the colocated engine's inbox builders.
//
// Replaces dragonboat_tpu/ops/colocated.py
//   `_assemble_inbox` (colocated.py:175; with raft_step it is
//     `_assemble_and_step`, :199): the routed regions ("pending", width
//     PB) first, then the host slots (width Mh); a row whose alive lane
//     combo[g, 0] is 0 is zeroed whole, entry axis included;
//   `_host_inbox_from_ticks` (:411): the host region built from the
//     fused tick counts combo[g, 3] — slot 0 is MT_TICK where the count
//     is above 0, and log_index[g, 0] is the count on every row;
//   `_zero_inbox_rows` (:399): rows with mask[g] != 0 zeroed.
// (`_scatter_inbox_rows`, :441, is place_rows over the 12 fields.)
//
// One thread per (row, slot), writing that slot's 10 scalar fields and
// its 2E entry words.  Bound: bytes — each input word is read once and
// each output word written once; there is no arithmetic to speak of.
#include "common.cuh"
#include "launch.h"

namespace dbt {

constexpr int INBOX_ASSEMBLE = 0;
constexpr int INBOX_FROM_TICKS = 1;
constexpr int INBOX_ZERO_ROWS = 2;

struct InboxArgs {
  int mode;
  const int* a[N_INBOX];  // assemble: host; zero_rows: the inbox
  const int* b[N_INBOX];  // assemble: pending
  const int* combo;       // [G, 4] (assemble, from_ticks)
  const int* mask;        // [G] (zero_rows)
  int* out[N_INBOX];
  int G, M, E, PB;        // M = output slots; PB = pending slots
};

// the (row g, output slot m) word of field f, entry e (e = 0 for the
// [G, M] fields)
DBT_HD int inbox_word(const InboxArgs& a, int g, int m, int f, int e) {
  const int E = a.E;
  const int w = f >= 10 ? E : 1;
  if (a.mode == INBOX_ASSEMBLE) {
    if (a.combo[(long long)g * 4 + 0] == 0) return 0;
    if (m < a.PB)
      return a.b[f][((long long)g * a.PB + m) * w + e];
    const int Mh = a.M - a.PB;
    return a.a[f][((long long)g * Mh + (m - a.PB)) * w + e];
  }
  if (a.mode == INBOX_FROM_TICKS) {
    const int t = a.combo[(long long)g * 4 + 3];
    if (m != 0) return 0;
    if (f == 0) return t > 0 ? MT_TICK : 0;  // mtype
    if (f == 4) return t;                    // log_index
    return 0;
  }
  // INBOX_ZERO_ROWS
  if (a.mask[g] != 0) return 0;
  return a.a[f][((long long)g * a.M + m) * w + e];
}

DBT_HD void inbox_slot(const InboxArgs& a, int g, int m) {
  const long long at = (long long)g * a.M + m;
  for (int f = 0; f < 10; ++f) a.out[f][at] = inbox_word(a, g, m, f, 0);
  for (int f = 10; f < N_INBOX; ++f)
    for (int e = 0; e < a.E; ++e)
      a.out[f][at * a.E + e] = inbox_word(a, g, m, f, e);
}

}  // namespace dbt

#ifdef __CUDACC__
__global__ void inbox_kernel(const dbt::InboxArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)a.G * a.M) return;
  dbt::inbox_slot(a, (int)(t / a.M), (int)(t % a.M));
}

void dbt::inbox_launch(int mode, const int* const* a_in,
                       const int* const* b_in, const int* combo,
                       const int* mask, int* const* out, int G, int M, int E,
                       int PB, void* stream) {
  dbt::InboxArgs a;
  a.mode = mode;
  for (int f = 0; f < dbt::N_INBOX; ++f) {
    a.a[f] = a_in ? a_in[f] : nullptr;
    a.b[f] = b_in ? b_in[f] : nullptr;
    a.out[f] = out[f];
  }
  a.combo = combo;
  a.mask = mask;
  a.G = G;
  a.M = M;
  a.E = E;
  a.PB = PB;
  const long long slots = (long long)G * M;
  if (slots == 0) return;
  const int threads = 256;
  inbox_kernel<<<(unsigned)((slots + threads - 1) / threads), threads, 0,
                 (cudaStream_t)stream>>>(a);
}
#endif
