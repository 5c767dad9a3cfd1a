// summarize_flags: the per-row flag word of the post-step readback.
//
// Replaces dragonboat_tpu/ops/engine.py `_summarize_flags`
// (engine.py:194-245): one int32 per row with F_CHANGED / F_COUNT /
// F_APPEND / F_NEED_SS / F_ESC / F_PEERS_BEHIND / F_QUORUM_ACTIVE.
//
// One thread per row.  Bound: bytes — a row reads 12 + 4P words of old
// state, new state and step outputs and writes one word; the logic is
// a handful of compares per peer slot.
#include "common.cuh"
#include "launch.h"

namespace dbt {

struct FlagsArgs {
  // old: term, vote, committed, leader_id, role, last_index
  const int* old_[6];
  // new: term, vote, committed, leader_id, role, last_index
  const int* new_[6];
  const int* peer_id;     // [G, P]
  const int* peer_kind;   // [G, P]
  const int* match;       // [G, P]
  const int* active;      // [G, P]
  const int* self_slot;   // [G]
  const int* check_quorum;
  const int* count;       // out.count
  const int* append_lo;   // out.append_lo
  const int* escalate;    // out.escalate
  const int* need_snapshot;  // [G, P]
  int* flags;             // [G]
  int G, P;
};

DBT_HD int flags_row(const FlagsArgs& a, int g) {
  const int P = a.P;
  bool changed = false;
  for (int f = 0; f < 6; ++f) changed |= a.old_[f][g] != a.new_[f][g];
  int fl = changed ? F_CHANGED : 0;
  if (a.count[g] > 0) fl |= F_COUNT;
  if (a.append_lo[g] != APPEND_LO_NONE) fl |= F_APPEND;
  if (a.escalate[g] != 0) fl |= F_ESC;
  const long long base = (long long)g * P;
  const int self = a.self_slot[g];
  const int role = a.new_[4][g];
  const int last = a.new_[5][g];
  bool need_ss = false, behind = false, self_voter = false;
  int n_voters = 0, n_active = 1;
  for (int p = 0; p < P; ++p) {
    int pid = a.peer_id[base + p];
    int kind = a.peer_kind[base + p];
    need_ss |= a.need_snapshot[base + p] == 1;
    bool lane = pid != 0;
    behind |= lane && p != self && a.match[base + p] < last;
    bool voter = lane && (kind == KIND_VOTER || kind == KIND_WITNESS);
    n_voters += voter ? 1 : 0;
    if (voter && p != self && a.active[base + p] == 1) ++n_active;
    self_voter |= p == self && lane && kind == KIND_VOTER;
  }
  if (need_ss) fl |= F_NEED_SS;
  if (role == ROLE_LEADER && behind) fl |= F_PEERS_BEHIND;
  if (role == ROLE_LEADER && a.check_quorum[g] == 1 && self_voter &&
      n_active >= n_voters / 2 + 1)
    fl |= F_QUORUM_ACTIVE;
  return fl;
}

}  // namespace dbt

#ifdef __CUDACC__
__global__ void summarize_flags_kernel(const dbt::FlagsArgs a) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < a.G) a.flags[g] = dbt::flags_row(a, g);
}

void dbt::summarize_flags_launch(const int* const* srcs, int* flags, int G,
                                 int P, void* stream) {
  dbt::FlagsArgs a;
  int k = 0;
  for (int f = 0; f < 6; ++f) a.old_[f] = srcs[k++];
  for (int f = 0; f < 6; ++f) a.new_[f] = srcs[k++];
  a.peer_id = srcs[k++];
  a.peer_kind = srcs[k++];
  a.match = srcs[k++];
  a.active = srcs[k++];
  a.self_slot = srcs[k++];
  a.check_quorum = srcs[k++];
  a.count = srcs[k++];
  a.append_lo = srcs[k++];
  a.escalate = srcs[k++];
  a.need_snapshot = srcs[k++];
  a.flags = flags;
  a.G = G;
  a.P = P;
  const int threads = 256;
  summarize_flags_kernel<<<(G + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(a);
}
#endif
