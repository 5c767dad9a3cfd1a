// route: the device router — every row's outbox scattered into the
// co-located peer rows' next inbox.
//
// Replaces dragonboat_tpu/ops/route.py `route` (route.py:131), with the
// [0, base) prefix of `make_prefill` (:395) generated in place and the
// colocated tail of `_route_step` (colocated.py:241-256: the
// undelivered-row bit and the delivered bit-pack) fused into the walk.
// `merge_and_route` (:431), `routed_round` (:475) and `fused_rounds`
// (:500) are compositions of this kernel with raft_step and place_rows
// (ops/route.py).
//
// Bound: bytes.  The least the function moves is the valid outbox
// messages (11 words each), the sending rows' tables, row scalars and the
// ring words of the entries they carry, and what it writes: the whole
// inbox (G*M*(10+2E) words), the delivered bits and the undelivered word.
// The inbox is most of it at every geometry of the repo.  The compares of
// a message against the P peer slots are a few dozen integer operations;
// what the card spends beyond the bytes is the latency of the loads each
// step depends on, so the design keeps those chains short.
//
// Design: a memset and two kernels on one stream.
//   1. Walk (route_walk_kernel): a sub-warp of 8 lanes (walk.cuh) walks
//      one row's outbox, one lane a message, in chunks of 8 messages, as
//      far as the longest outbox among the warp's rows reaches.  The
//      row's P peer slots are loaded lane-parallel (lane p holds slot p,
//      and p + 8 when P > 8): the slot bits are ballots, a peer id a
//      shuffle.  Lane o reads message
//      o's words only when o < count; a row's O x 11 words are
//      contiguous, so the sub-warp's loads are coalesced.  Each lane
//      computes its message's facts as the reference does, over ALL
//      matching peer slots (a peer table that repeats an id gives the
//      reference's hits, k and stats).  The reference's exclusive cumsum
//      k_excl per peer slot p is a ballot of (hit_p && deliverable): a
//      lane's k_excl is the popcount of the ballot's lower lanes plus the
//      earlier chunks' carry (walk.cuh `lane_rank`), the same at each of
//      its hit slots, and k its sum over them.  From the walk come the
//      delivered bytes (one a lane, coalesced), the packed bits (the
//      ballot of deliv), the undelivered-row word (a sub-warp any) and
//      the stats.  A
//      deliverable message's index o is the scratch word (g, p, k_excl)
//      of each hit slot p with k_excl < B, and the row's cnt[g, p] =
//      min(messages toward p, B) is written once the walk is done.
//      Nothing else is written: an unused (p, b) slot is never touched,
//      and no message is copied.
//   2. Receive (route_recv_kernel), one thread per (dest row d, inbox
//      slot m), stores coalesced (the E entry words as one 16- or 8-byte
//      store where they allow).  Slots below `base` are the prefix
//      (copied from base_inbox, or the tick / propose_leaders prefill);
//      slot base + r*B + b selects (flat, b), flat = dest_row[d, r] * P +
//      rank_in_dest[d, r] clamped as the reference's gather is, when
//      b < cnt[flat] — the reference's pick_found — and then reads the
//      message o = scratch[flat, b] of sender row flat / P: its wire
//      fields from the outbox, `from` and the E entry words from that
//      row (route.py:303-318).  It pulls, as the reference gathers: a
//      push into destination rows would differ from it wherever the
//      tables are not symmetric.
// The stats are int32 sums: a block adds its threads' counts in shared
// memory and then each nonzero one to the [7] vector with one atomic
// (integer sums do not depend on order).  stats[6] is the number of
// suppressed rows (the escalation count of merge_and_route).
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain
// C++: then the per-slot, per-row and per-message steps (`route_slot`,
// `route_row_scalars`, `route_lane_facts`, `lane_rank`,
// `route_lane_emit`, `route_recv_slot`) are host functions, and a host
// loop that runs them lane by lane, with the masks made from the lanes'
// predicates, checks the walk without a card.
#include "common.cuh"
#include "launch.h"
#include "walk.cuh"

namespace dbt {

// threads a block of either kernel
constexpr int ROUTE_THREADS = 256;

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
  int* scratch;            // [G, P, B] message index: words b < cnt set
  int* cnt;                // [G, P]
  int G, P, W, O, M, E, B, base;
  int tick, propose_leaders, propose_n;
};

// One peer slot of a sending row.
struct RouteSlot {
  int pid;
  bool ge0, ns, alive;  // dest_row >= 0, dest_row != g, alive destination
};

DBT_FI RouteSlot route_slot(const RouteArgs& a, int g, int p) {
  const long long at = (long long)g * a.P + p;
  const int d = a.dest_row[at];
  RouteSlot s;
  s.pid = a.peer_id[at];
  s.ge0 = d >= 0;
  s.ns = d != g;
  s.alive = d >= 0;
  if (a.alive) {
    const int dc = d < 0 ? 0 : (d > a.G - 1 ? a.G - 1 : d);
    s.alive = s.alive && a.alive[(long long)dc * a.alive_stride] != 0;
  }
  return s;
}

// A row's facts, the same in every lane of its sub-warp.
struct RouteRow {
  int g, count, last, win_lo;
  bool sup;
  uint32_t dge0, dns, alv;  // the slots' bits (RouteSlot), set by the caller
};

DBT_FI void route_row_empty(RouteRow& r) {
  r.g = r.count = r.last = r.win_lo = 0;
  r.sup = false;
  r.dge0 = r.dns = r.alv = 0;
}

DBT_FI void route_row_scalars(const RouteArgs& a, int g, RouteRow& r) {
  r.g = g;
  r.count = a.count[g];
  r.sup = a.suppress && a.suppress[g] != 0;
  r.last = a.last_index[g];
  r.win_lo = imax(a.first_index[g], wsub(r.last, a.W - 1));
  r.dge0 = r.dns = r.alv = 0;
}

// One message, in the lane that holds it.
struct RouteMsg {
  int mt, to, n_ent, li, lt;
  uint32_t hits;  // peer slots whose id matches `to`, set by the caller
  bool v_raw, v, routable, on_dev, ring_ok, msg_ok, deliverable;
};

// Message o's words, read only when o < count and the row is not
// suppressed.
DBT_FI void route_msg_load(const RouteArgs& a, const RouteRow& r, int o,
                           RouteMsg& f) {
  f.v_raw = o < a.O && o < r.count;
  f.v = f.v_raw && !r.sup;
  f.mt = f.to = f.n_ent = f.li = f.lt = 0;
  f.hits = 0;
  if (!f.v) return;
  const int* m = a.buf + ((long long)r.g * a.O + o) * N_FIELDS;
  f.mt = m[F_MTYPE];
  f.to = m[F_TO];
  f.n_ent = m[F_N_ENTRIES];
  f.li = m[F_LOG_INDEX];
  f.lt = m[F_LOG_TERM];
}

// The message's facts, once its hits are set.
DBT_FI void route_msg_facts(const RouteRow& r, RouteMsg& f) {
  f.routable = f.hits != 0;
  f.on_dev = (f.hits & r.dge0) != 0;
  const bool carries = f.mt == MT_REPLICATE && f.n_ent > 0;
  const bool marker = f.mt == MT_REPLICATE && f.li > 0 && f.lt == 0;
  f.ring_ok = !carries || (wadd(f.li, 1) >= r.win_lo &&
                           wadd(f.li, f.n_ent) <= r.last && !marker);
  f.msg_ok = f.v && f.mt != MT_PROPOSE && (f.hits & r.dns) != 0 &&
             (f.hits & r.alv) != 0;
  f.deliverable = f.ring_ok && f.msg_ok;
}

// Message o's facts in the lane that holds it: its words, the peer
// slots it hits (`pid`: the row's peer ids) and what follows from them.
DBT_LANE void route_lane_facts(const RouteArgs& a, const RouteRow& r, int o,
                               const LaneWords& pid, RouteMsg& f) {
  route_msg_load(a, r, o, f);
  for (int p = 0; p < a.P; ++p) {
    const int id = pid.get(p);
    if (f.v && id == f.to && f.to != 0 && id != 0) f.hits |= 1u << p;
  }
  route_msg_facts(r, f);
}

// Message o once its k_excl b is known (its rank among the row's
// deliverable messages toward its hit slots; 0 for a message that is not
// deliverable): a deliverable message with b < B is the scratch word
// (g, p, b) of each hit slot p, and its counts go to s[1..5] in RouteStats
// order.  Every hit slot of a message gives it the same k_excl: the slots
// that match `to` hold one id, so the earlier messages that hit one of
// them hit them all (k, their sum, is popc(hits) * b).  Returns whether
// the message is delivered.
DBT_FI bool route_lane_emit(const RouteArgs& a, const RouteRow& r,
                            const RouteMsg& f, int o, int b, int* s) {
  const bool in_budget = popc(f.hits) * b < a.B;
  if (f.v_raw && !f.v) s[4] += 1;
  if (f.routable && !f.on_dev) s[1] += 1;
  if (f.on_dev && f.msg_ok && f.ring_ok && !in_budget) s[2] += 1;
  if (f.on_dev && f.msg_ok && !f.ring_ok) s[3] += 1;
  if (f.on_dev && !f.msg_ok) s[5] += 1;
  if (!f.deliverable || b >= a.B) return false;
  const long long pb = (long long)r.g * a.P;
#pragma unroll 1
  for (int p = 0; p < a.P; ++p)
    if ((f.hits >> p) & 1u) a.scratch[(pb + p) * a.B + b] = o;
  return in_budget;
}

// dst[0, E) = src[0, E), or zeros when src is null; on the card one
// 16- or 8-byte store where E and the address allow it.
DBT_FI void put_ents(int* dst, const int* src, int E) {
#ifdef __CUDA_ARCH__
  const unsigned long long at = (unsigned long long)dst;
  if (E == 4 && (at & 15) == 0) {
    *reinterpret_cast<int4*>(dst) = src ? make_int4(src[0], src[1], src[2],
                                                    src[3])
                                        : make_int4(0, 0, 0, 0);
    return;
  }
  if (E == 2 && (at & 7) == 0) {
    *reinterpret_cast<int2*>(dst) =
        src ? make_int2(src[0], src[1]) : make_int2(0, 0);
    return;
  }
#endif
  for (int e = 0; e < E; ++e) dst[e] = src ? src[e] : 0;
}

// A routed message's E entry words: the sender's (row s) ring term and
// cc at max(li + 1 + e, 0) & (W-1) while e < n_ent of a REPLICATE, else
// 0, into dt[0, E) and dc[0, E).
DBT_FI void put_ring_ents(const RouteArgs& a, int s, bool is_repl,
                          int n_ent, int li, int* dt, int* dc) {
  const long long rw = (long long)s * a.W;
  const int E = a.E;
  if (E <= 4) {  // the words in registers: all their loads at once
    int t[4], c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool has_e = e < E && is_repl && e < n_ent;
      const int pos = imax(wadd(wadd(li, 1), e), 0) & (a.W - 1);
      t[e] = has_e ? a.ring_term[rw + pos] : 0;
      c[e] = has_e ? a.ring_cc[rw + pos] : 0;
    }
#ifdef __CUDA_ARCH__
    const unsigned long long at =
        (unsigned long long)dt | (unsigned long long)dc;
    if (E == 4 && (at & 15) == 0) {
      *reinterpret_cast<int4*>(dt) = make_int4(t[0], t[1], t[2], t[3]);
      *reinterpret_cast<int4*>(dc) = make_int4(c[0], c[1], c[2], c[3]);
      return;
    }
    if (E == 2 && (at & 7) == 0) {
      *reinterpret_cast<int2*>(dt) = make_int2(t[0], t[1]);
      *reinterpret_cast<int2*>(dc) = make_int2(c[0], c[1]);
      return;
    }
#endif
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E) {
        dt[e] = t[e];
        dc[e] = c[e];
      }
    return;
  }
  for (int e = 0; e < E; ++e) {
    const bool has_e = is_repl && e < n_ent;
    const int pos = imax(wadd(wadd(li, 1), e), 0) & (a.W - 1);
    dt[e] = has_e ? a.ring_term[rw + pos] : 0;
    dc[e] = has_e ? a.ring_cc[rw + pos] : 0;
  }
}

// Receiver for inbox slot m of row d; returns 1 if a routed message was
// delivered there.
DBT_FI int route_recv_slot(const RouteArgs& a, int d, int m) {
  const int M = a.M, E = a.E, G = a.G, P = a.P, B = a.B;
  const long long at = (long long)d * M + m;
  int* et = a.inbox[10] + at * E;
  int* ec = a.inbox[11] + at * E;
  // Inbox order: mtype, from_id, term, log_term, log_index, commit,
  // reject, hint, hint_high, n_entries, ent_term, ent_cc
  if (m < a.base) {
    if (a.base_inbox[0]) {
      const long long bt = (long long)d * a.M_base + m;
#pragma unroll
      for (int i = 0; i < 10; ++i) a.inbox[i][at] = a.base_inbox[i][bt];
      put_ents(et, a.base_inbox[10] + bt * E, E);
      put_ents(ec, a.base_inbox[11] + bt * E, E);
      return 0;
    }
    int mt = (a.tick && m == 0) ? MT_TICK : 0, n = 0;
    if (a.propose_leaders && m == 1) {
      const bool lead = a.role[d] == ROLE_LEADER;
      mt = lead ? MT_PROPOSE : 0;
      n = lead ? a.propose_n : 0;
    }
    a.inbox[0][at] = mt;
#pragma unroll
    for (int i = 1; i < 9; ++i) a.inbox[i][at] = 0;
    a.inbox[9][at] = n;
    put_ents(et, nullptr, E);
    put_ents(ec, nullptr, E);
    return 0;
  }
  const int j = m - a.base;
  const int r = j / B, b = j - r * B;
  const int src = a.dest_row[(long long)d * P + r];
  const int src_c = src < 0 ? 0 : (src > G - 1 ? G - 1 : src);
  long long flat = (long long)src_c * P + a.rank[(long long)d * P + r];
  const long long n = (long long)G * P;
  if (flat < 0) flat += n;
  if (flat < 0) flat = 0;
  if (flat > n - 1) flat = n - 1;
  if (!(src >= 0 && src_c != d && b < a.cnt[flat])) {
#pragma unroll
    for (int i = 0; i < 10; ++i) a.inbox[i][at] = 0;
    put_ents(et, nullptr, E);
    put_ents(ec, nullptr, E);
    return 0;
  }
  // the message sender row s put at (flat, b): its outbox words in
  // Inbox order (mtype, from_id = the sender's id, term .. n_entries)
  const int s = (int)(flat / P);
  const int o = a.scratch[flat * B + b];
  const int* w = a.buf + ((long long)s * a.O + o) * N_FIELDS;
  const int mt = w[F_MTYPE], li = w[F_LOG_INDEX], n_ent = w[F_N_ENTRIES];
  a.inbox[0][at] = mt;
  a.inbox[1][at] = a.replica_id[s];
  a.inbox[2][at] = w[F_TERM];
  a.inbox[3][at] = w[F_LOG_TERM];
  a.inbox[4][at] = li;
  a.inbox[5][at] = w[F_COMMIT];
  a.inbox[6][at] = w[F_REJECT];
  a.inbox[7][at] = w[F_HINT];
  a.inbox[8][at] = w[F_HINT_HIGH];
  a.inbox[9][at] = n_ent;
  put_ring_ents(a, s, mt == MT_REPLICATE, n_ent, li, et, ec);
  return 1;
}

}  // namespace dbt

#ifdef __CUDACC__
namespace {

// The block's counts s[0..N) added to stats: a warp sum each, a shared
// sum over the warps, then one atomic a nonzero stat.  Every thread of the
// block calls it.
template <int N>
__device__ __forceinline__ void block_add(int* stats, const int* s) {
  __shared__ int part[N];
  const unsigned full = 0xffffffffu;
  if (threadIdx.x < N) part[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int v = __reduce_add_sync(full, s[i]);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(part + i, v);
  }
  __syncthreads();
  if (threadIdx.x < N && part[threadIdx.x])
    atomicAdd(stats + threadIdx.x, part[threadIdx.x]);
}

// The walk: ROUTE_THREADS / WALK_LANES rows a block, a sub-warp a row.  A
// warp walks as many chunks of WALK_LANES messages as the longest outbox
// among its rows needs; the later chunks hold no valid message and only
// write zeros.
__global__ void __launch_bounds__(dbt::ROUTE_THREADS)
    route_walk_kernel(const __grid_constant__ dbt::RouteArgs a) {
  constexpr int L = dbt::WALK_LANES;
  const int sub = threadIdx.x & (L - 1);
  const int g = blockIdx.x * (dbt::ROUTE_THREADS / L) + threadIdx.x / L;
  const bool row_ok = g < a.G;
  dbt::RouteRow r;
  if (row_ok)
    dbt::route_row_scalars(a, g, r);
  else
    dbt::route_row_empty(r);
  // the row's peer slots, lane-parallel: slot p in lane p % L
  dbt::LaneWords pid;
  {
    dbt::RouteSlot lo{0, false, false, false}, hi{0, false, false, false};
    if (row_ok && sub < a.P) lo = dbt::route_slot(a, g, sub);
    if (row_ok && sub + L < a.P) hi = dbt::route_slot(a, g, sub + L);
    pid.lo = lo.pid;
    pid.hi = hi.pid;
    r.dge0 = dbt::sub_ballot(lo.ge0) | dbt::sub_ballot(hi.ge0) << L;
    r.dns = dbt::sub_ballot(lo.ns) | dbt::sub_ballot(hi.ns) << L;
    r.alv = dbt::sub_ballot(lo.alive) | dbt::sub_ballot(hi.alive) << L;
  }
  const int n_live = __reduce_max_sync(
      0xffffffffu, dbt::imax(0, dbt::imin(r.count, a.O)));
  const auto ballot = [](int, bool pred) { return dbt::sub_ballot(pred); };
  int s[7] = {0, 0, 0, 0, 0, 0, 0};
  dbt::LaneWords carry;  // deliverable messages toward each peer slot
  bool und = false;
  uint32_t word = 0;
  const int nw = (a.O + 31) / 32;
  for (int c = 0; c * L < a.O; ++c) {
    const int o = c * L + sub;
    bool deliv = false;
    if (c * L < n_live) {
      dbt::RouteMsg f;
      dbt::route_lane_facts(a, r, o, pid, f);
      const int b = dbt::lane_rank(a.P, f.deliverable ? f.hits : 0u, sub,
                                   ballot, carry);
      deliv = dbt::route_lane_emit(a, r, f, o, b, s);
      und = und || (f.v_raw && !deliv);
    }
    // message o's delivered bit is bit o % 32 of packed word o / 32
    word |= dbt::sub_ballot(deliv) << ((c * L) & 31);
    const bool flush = (((c + 1) * L) & 31) == 0 || (c + 1) * L >= a.O;
    if (row_ok) {
      if (a.delivered && o < a.O)
        a.delivered[(long long)g * a.O + o] = deliv ? 1 : 0;
      if (a.packed && flush && sub == 0)
        a.packed[(long long)g * nw + ((c * L) >> 5)] = (int)word;
    }
    if (flush) word = 0;
  }
  const bool any_und = dbt::sub_ballot(und) != 0;
  if (row_ok) {
    if (a.undeliv && sub == 0) a.undeliv[g] = any_und ? 1 : 0;
    for (int p = sub; p < a.P; p += L)
      a.cnt[(long long)g * a.P + p] = dbt::imin(carry.held(p), a.B);
    if (r.sup && sub == 0) s[6] += 1;
  }
  block_add<7>(a.stats, s);
}

__global__ void __launch_bounds__(dbt::ROUTE_THREADS)
    route_recv_kernel(const __grid_constant__ dbt::RouteArgs a) {
  const int t = blockIdx.x * dbt::ROUTE_THREADS + threadIdx.x;
  int hit[1] = {0};
  if (t < a.G * a.M) {
    const int d = t / a.M;
    hit[0] = dbt::route_recv_slot(a, d, t - d * a.M);
  }
  block_add<1>(a.stats, hit);
}

}  // namespace

void dbt::route_launch(const int* const* st, const int* buf, const int* count,
                       const int* dest_row, const int* rank,
                       const int* suppress, const int* alive,
                       int alive_stride, const int* const* base_inbox,
                       int M_base, int* const* inbox, int* stats,
                       int* packed, int* undeliv, unsigned char* delivered,
                       int* scratch, int* cnt, int G, int P, int W, int O,
                       int M, int E, int B, int base, int tick,
                       int propose_leaders, int propose_n, void* stream) {
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
  a.cnt = cnt;
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
  const int T = dbt::ROUTE_THREADS;
  cudaMemsetAsync(stats, 0, dbt::N_ROUTE_STATS * sizeof(int), s);
  const int rows = T / dbt::WALK_LANES;
  route_walk_kernel<<<(unsigned)((G + rows - 1) / rows), T, 0, s>>>(a);
  const long long slots = (long long)G * M;
  route_recv_kernel<<<(unsigned)((slots + T - 1) / T), T, 0, s>>>(a);
}
#endif
