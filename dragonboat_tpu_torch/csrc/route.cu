// route: the device router — every row's outbox scattered into the
// co-located peer rows' next inbox.
//
// Replaces dragonboat_tpu/ops/route.py `route` (route.py:131), with the
// [0, base) prefix of `make_prefill` (:395) generated in place and the
// colocated tail of `_route_step` (colocated.py:241-256: the
// undelivered-row bit and the delivered bit-pack) fused into the sender
// pass.  `merge_and_route` (:431), `routed_round` (:475) and
// `fused_rounds` (:500) are compositions of this kernel with raft_step
// and place_rows (ops/route.py).
//
// Design: two passes, one launch each, on one stream.
//   1. Sender pass, one thread per row g.  It walks the row's O outbox
//      slots in order with one counter per peer slot p (the reference's
//      k_excl: deliverable messages already sent toward p).  For each
//      message it computes every per-message fact over ALL matching peer
//      slots (hits is an `any`, k a `sum` — a peer table that repeats an
//      id gives the reference's k, at_pstar and stats), its delivered
//      bit and the stats, and writes the message's packed receiver row
//      (9 wire fields, found, from, E ring terms, E cc bits — route.py
//      :303-318) into scratch[g, p, k_excl] for each matching p with
//      k_excl < budget.  Unused (p, b) slots get found = 0.
//   2. Receiver pass, one thread per (dest row d, inbox slot m).  Slots
//      below `base` are the prefix (copied from base_inbox, or the
//      tick / propose_leaders prefill); slot base + r*B + b gathers
//      scratch[dest_row[d, r], rank_in_dest[d, r], b] (route.py:320-338).
// The stats are int32 sums: each warp reduces its threads' counts and
// adds them to the [7] stats vector with one atomic (integer sums do not
// depend on order).  stats[6] is the number of suppressed rows (the
// escalation count of merge_and_route).
//
// Bound: bytes.  The sender reads the outbox (G*O*11 words), the peer
// and ring rows of every sending row, and writes G*P*B*(11+2E) scratch
// words; the receiver reads those back and writes the G*M*(10+2E) inbox.
// One thread per row walks O*P compares; it is a small share next to the
// strided outbox reads.
#include "common.cuh"
#include "launch.h"

namespace dbt {

// packed receiver row: the 9 wire fields in WIRE order, then found,
// from, E ring terms, E cc bits
constexpr int N_WIRE = 9;
constexpr int IDX_FOUND = N_WIRE;
constexpr int IDX_FROM = N_WIRE + 1;
constexpr int KF = N_WIRE + 2;

DBT_HD int wire_col(int i) {
  // F_MTYPE, F_TERM, F_LOG_TERM, F_LOG_INDEX, F_COMMIT, F_REJECT,
  // F_HINT, F_HINT_HIGH, F_N_ENTRIES
  const int cols[N_WIRE] = {F_MTYPE,  F_TERM,  F_LOG_TERM,
                            F_LOG_INDEX, F_COMMIT, F_REJECT,
                            F_HINT,   F_HINT_HIGH, F_N_ENTRIES};
  return cols[i];
}

struct RouteArgs {
  // post-step (merged) state of the sending rows
  const int* peer_id;      // [G, P]
  const int* replica_id;   // [G]
  const int* first_index;  // [G]
  const int* last_index;   // [G]
  const int* role;         // [G]
  const int* ring_term;    // [G, W]
  const int* ring_cc;      // [G, W]
  const int* buf;          // [G, O, N_FIELDS]
  const int* count;        // [G]
  const int* dest_row;     // [G, P]
  const int* rank;         // [G, P]
  const int* suppress;     // [G] nonzero = suppressed row, or null
  const int* alive;        // alive[g * alive_stride] nonzero, or null
  int alive_stride;
  const int* base_inbox[N_INBOX];  // [G, M_base(, E)] or all null
  int M_base;
  int* inbox[N_INBOX];     // [G, M(, E)]
  int* stats;              // [7]
  int* packed;             // [G, nw] delivered bits, or null
  int* undeliv;            // [G] 0/1, or null
  unsigned char* delivered;  // [G, O] bool, or null
  int* scratch;            // [G, P, B, KT]
  int G, P, W, O, M, E, B, base;
  int tick, propose_leaders, propose_n;
};

DBT_HD int kt(const RouteArgs& a) { return KF + 2 * a.E; }

// Sender pass for row g; adds its stats to s[0..6].
DBT_HD void route_send_row(const RouteArgs& a, int g, int* s) {
  const int P = a.P, O = a.O, B = a.B, E = a.E, W = a.W, G = a.G;
  const int KT = kt(a);
  int cnt[16];
  bool dge0[16], dns[16], alv[16];
  int pid[16];
  const long long pb = (long long)g * P;
  for (int p = 0; p < P; ++p) {
    cnt[p] = 0;
    pid[p] = a.peer_id[pb + p];
    const int d = a.dest_row[pb + p];
    dge0[p] = d >= 0;
    dns[p] = d != g;
    if (a.alive) {
      const int dc = d < 0 ? 0 : (d > G - 1 ? G - 1 : d);
      alv[p] = a.alive[(long long)dc * a.alive_stride] != 0 && dge0[p];
    } else {
      alv[p] = dge0[p];
    }
  }
  const int count = a.count[g];
  const bool sup = a.suppress && a.suppress[g] != 0;
  const int last = a.last_index[g];
  const int win_lo = imax(a.first_index[g], wsub(last, W - 1));
  const int me = a.replica_id[g];
  const int nw = (O + 31) / 32;
  uint32_t word = 0;
  bool undeliv = false;
  for (int o = 0; o < O; ++o) {
    const int* m = a.buf + ((long long)g * O + o) * N_FIELDS;
    const bool v_raw = o < count;
    const bool v = v_raw && !sup;
    if (v_raw && sup) s[4] += 1;
    const int mt = m[F_MTYPE], to = m[F_TO], n_ent = m[F_N_ENTRIES];
    const int li = m[F_LOG_INDEX], lt = m[F_LOG_TERM];
    bool found = false, ap_ge0 = false, ap_ns = false, ap_alive = false;
    int k = 0;
    for (int p = 0; p < P; ++p) {
      const bool h = pid[p] == to && to != 0 && pid[p] != 0;
      if (!h) continue;
      found = true;
      ap_ge0 |= dge0[p];
      ap_ns |= dns[p];
      ap_alive |= alv[p];
      k += cnt[p];
    }
    const bool routable = v && found;
    const bool on_dev = routable && ap_ge0;
    const bool is_repl = mt == MT_REPLICATE;
    const bool carries = is_repl && n_ent > 0;
    const bool marker = is_repl && li > 0 && lt == 0;
    const bool ring_ok =
        !carries ||
        (wadd(li, 1) >= win_lo && wadd(li, n_ent) <= last && !marker);
    const bool msg_ok = mt != MT_PROPOSE && ap_ns && ap_alive;
    const bool deliverable = v && ring_ok && msg_ok;
    const bool in_budget = k < B;
    const bool deliv = v && found && ring_ok && msg_ok && in_budget;
    if (routable && !ap_ge0) s[1] += 1;
    if (on_dev && msg_ok && ring_ok && !in_budget) s[2] += 1;
    if (on_dev && msg_ok && !ring_ok) s[3] += 1;
    if (on_dev && !msg_ok) s[5] += 1;
    undeliv |= v_raw && !deliv;
    if (deliv) word |= 1u << (o % 32);
    if (o % 32 == 31 || o == O - 1) {
      if (a.packed) a.packed[(long long)g * nw + o / 32] = (int)word;
      word = 0;
    }
    if (a.delivered) a.delivered[(long long)g * O + o] = deliv ? 1 : 0;
    if (!deliverable) continue;
    for (int p = 0; p < P; ++p) {
      const bool h = pid[p] == to && to != 0 && pid[p] != 0;
      if (!h) continue;
      const int b = cnt[p]++;
      if (b >= B) continue;
      int* row = a.scratch + ((pb + p) * B + b) * KT;
      for (int i = 0; i < N_WIRE; ++i) row[i] = m[wire_col(i)];
      row[IDX_FOUND] = 1;
      row[IDX_FROM] = me;
      for (int e = 0; e < E; ++e) {
        const bool has_e = is_repl && e < n_ent;
        const int pos = imax(wadd(wadd(li, 1), e), 0) & (W - 1);
        row[KF + e] = has_e ? a.ring_term[(long long)g * W + pos] : 0;
        row[KF + E + e] = has_e ? a.ring_cc[(long long)g * W + pos] : 0;
      }
    }
  }
  if (a.undeliv) a.undeliv[g] = undeliv ? 1 : 0;
  if (sup) s[6] += 1;
  for (int p = 0; p < P; ++p)
    for (int b = imin(cnt[p], B); b < B; ++b)
      a.scratch[((pb + p) * B + b) * KT + IDX_FOUND] = 0;
}

// Receiver pass for inbox slot m of row d; returns 1 if a routed
// message was delivered there.
DBT_HD int route_recv_slot(const RouteArgs& a, int d, int m) {
  const int M = a.M, E = a.E, G = a.G, P = a.P, B = a.B;
  const long long at = (long long)d * M + m;
  // Inbox order: mtype, from_id, term, log_term, log_index, commit,
  // reject, hint, hint_high, n_entries, ent_term, ent_cc
  if (m < a.base) {
    if (a.base_inbox[0]) {
      const long long bt = (long long)d * a.M_base + m;
      for (int i = 0; i < 10; ++i) a.inbox[i][at] = a.base_inbox[i][bt];
      for (int e = 0; e < E; ++e) {
        a.inbox[10][at * E + e] = a.base_inbox[10][bt * E + e];
        a.inbox[11][at * E + e] = a.base_inbox[11][bt * E + e];
      }
      return 0;
    }
    int mt = (a.tick && m == 0) ? MT_TICK : 0, n = 0;
    if (a.propose_leaders && m == 1) {
      const bool lead = a.role[d] == ROLE_LEADER;
      mt = lead ? MT_PROPOSE : 0;
      n = lead ? a.propose_n : 0;
    }
    a.inbox[0][at] = mt;
    for (int i = 1; i < 9; ++i) a.inbox[i][at] = 0;
    a.inbox[9][at] = n;
    for (int e = 0; e < E; ++e) a.inbox[10][at * E + e] = a.inbox[11][at * E + e] = 0;
    return 0;
  }
  const int j = m - a.base;
  const int r = j / B, b = j % B;
  const int src = a.dest_row[(long long)d * P + r];
  const int src_c = src < 0 ? 0 : (src > G - 1 ? G - 1 : src);
  long long flat = (long long)src_c * P + a.rank[(long long)d * P + r];
  const long long n = (long long)G * P;
  if (flat < 0) flat += n;
  if (flat < 0) flat = 0;
  if (flat > n - 1) flat = n - 1;
  const int* row = a.scratch + (flat * B + b) * kt(a);
  const bool sel = row[IDX_FOUND] != 0 && src >= 0 && src_c != d;
  // wire order -> Inbox order
  a.inbox[0][at] = sel ? row[0] : 0;         // mtype
  a.inbox[1][at] = sel ? row[IDX_FROM] : 0;  // from_id
  for (int i = 1; i < N_WIRE; ++i)           // term .. n_entries
    a.inbox[i + 1][at] = sel ? row[i] : 0;
  for (int e = 0; e < E; ++e) {
    a.inbox[10][at * E + e] = sel ? row[KF + e] : 0;
    a.inbox[11][at * E + e] = sel ? row[KF + E + e] : 0;
  }
  return sel ? 1 : 0;
}

}  // namespace dbt

#ifdef __CUDACC__
namespace {

__device__ void add_stats(int* stats, const int* s, int n, bool active) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < n; ++i) {
    const int v = __reduce_add_sync(full, active ? s[i] : 0);
    if (lane == 0 && v) atomicAdd(stats + i, v);
  }
}

__global__ void route_send_kernel(const dbt::RouteArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int s[7] = {0, 0, 0, 0, 0, 0, 0};
  const bool active = g < a.G;
  if (active) dbt::route_send_row(a, g, s);
  add_stats(a.stats, s, 7, active);
}

__global__ void route_recv_kernel(const dbt::RouteArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t < (long long)a.G * a.M;
  int hit = 0;
  if (active) hit = dbt::route_recv_slot(a, (int)(t / a.M), (int)(t % a.M));
  add_stats(a.stats, &hit, 1, active);
}

}  // namespace

void dbt::route_launch(const int* const* st, const int* buf, const int* count,
                       const int* dest_row, const int* rank,
                       const int* suppress, const int* alive,
                       int alive_stride, const int* const* base_inbox,
                       int M_base, int* const* inbox, int* stats,
                       int* packed, int* undeliv, unsigned char* delivered,
                       int* scratch, int G, int P, int W, int O, int M,
                       int E, int B, int base, int tick, int propose_leaders,
                       int propose_n, void* stream) {
  dbt::RouteArgs a;
  a.peer_id = st[0];
  a.replica_id = st[1];
  a.first_index = st[2];
  a.last_index = st[3];
  a.role = st[4];
  a.ring_term = st[5];
  a.ring_cc = st[6];
  a.buf = buf;
  a.count = count;
  a.dest_row = dest_row;
  a.rank = rank;
  a.suppress = suppress;
  a.alive = alive;
  a.alive_stride = alive_stride;
  for (int i = 0; i < dbt::N_INBOX; ++i) {
    a.base_inbox[i] = base_inbox ? base_inbox[i] : nullptr;
    a.inbox[i] = inbox[i];
  }
  a.M_base = M_base;
  a.stats = stats;
  a.packed = packed;
  a.undeliv = undeliv;
  a.delivered = delivered;
  a.scratch = scratch;
  a.G = G;
  a.P = P;
  a.W = W;
  a.O = O;
  a.M = M;
  a.E = E;
  a.B = B;
  a.base = base;
  a.tick = tick;
  a.propose_leaders = propose_leaders;
  a.propose_n = propose_n;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(stats, 0, 7 * sizeof(int), s);
  const int threads = 256;
  route_send_kernel<<<(G + threads - 1) / threads, threads, 0, s>>>(a);
  const long long slots = (long long)G * M;
  route_recv_kernel<<<(unsigned)((slots + threads - 1) / threads), threads, 0,
                      s>>>(a);
}
#endif
