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
// The inbox is most of it at every geometry of the repo, and 95-97% of
// its slots are empty at the benchmark's (a fresh inbox each round, so
// they are written as zeros).  The compares of a message against the P
// peer slots are a few dozen integer operations; what the card spends
// beyond the bytes is the latency of the loads each step depends on, so
// the design keeps those chains short and off the path of the zeros.
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
//   2. Receive (route_recv_kernel): persistent blocks, a few an SM, walk
//      tiles of R destination rows with a grid stride (`recv_tile_rows`:
//      about RECV_TILE_BYTES of inbox words, R * M a multiple of 4 words
//      so that every plane's span of a tile, R * M or R * M * E contiguous
//      words, starts on a 16-byte boundary; fewer rows where G is small).
//      A block holds its tile's inbox in shared memory, all zeros, and a
//      tile is three steps.  First, one thread a (row d, peer region r)
//      decides the region once (`recv_decide`): the reference's clamped
//      gather flat = dest_row[d, r] * P + rank_in_dest[d, r], and n =
//      cnt[flat] when the source is another resident row (the reference's
//      pick_found: slot base + r*B + b holds (flat, b) for b < n); it
//      appends the region's n occupied slots to the tile's list.  Then
//      one thread a listed slot writes it into the tile, so no gather lane
//      idles beside a zero: each prefix slot, copied from base_inbox or
//      generated as the tick / propose_leaders prefill (`recv_prefix`,
//      which reads `role` for slot 1 only), and each occupied slot's
//      message o = scratch[flat, b] of sender row flat / P
//      (`recv_message`: its wire fields from the outbox, `from` and the E
//      entry words from that row, route.py:303-318).  Last, the block
//      copies the tile out plane by plane (`recv_copy`: consecutive
//      threads on consecutive 16 bytes of a plane, each zeroed in the tile
//      behind it), so every word of the inbox is stored once, whole
//      16-byte stores, and an empty slot's zeros wait on no load of the
//      device's memory.  The tile in shared memory is what keeps the
//      stores whole: writing the listed slots' words straight to the
//      inbox beside 16-byte zeros left sectors half written across the
//      tile's loads, and the receive ran more than twice as long on the
//      H100 at the c4 geometry (PERF.md, section 6).  The receive pulls,
//      as the reference gathers: a push into destination rows would differ
//      from it wherever the tables are not symmetric.
// The stats are int32 sums: the walk's block adds its threads' counts in
// shared memory and then each nonzero one to the [7] vector with one
// atomic (integer sums do not depend on order); the receive sums its
// delivered count over all of a block's tiles and adds it once.
// stats[6] is the number of suppressed rows (the escalation count of
// merge_and_route).
// The election census (given a `census` vector, which the fused wave does
// while the port's span recorder is on): the walk is then instantiated
// with CENSUS, and each lane also counts its message's type, and for a
// vote or pre-vote response its reject word, into four more sums, which
// the block adds to the 64-bit vector the same way.  The vector is added
// to across launches and never zeroed here, so a window's totals are read
// back once.  Without it the walk is the kernel it was before the census.
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain
// C++: then the per-slot, per-row and per-message steps (`route_slot`,
// `route_row_scalars`, `route_lane_facts`, `lane_rank`,
// `route_lane_emit`, `route_lane_census`) and the receive tile's steps
// (`recv_tile_clear`, `recv_decide`, `recv_listed`, `recv_copy`) are host
// functions: a host loop that runs the walk lane by lane, with the
// masks made from the lanes' predicates, and the receive tile by tile,
// step by step, checks both without a card.
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
  // [N_ROUTE_CENSUS] election census, added to (never zeroed), or null;
  // last, so every other field keeps its offset in the kernels' arguments
  unsigned long long* census;
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

// The election census of message o (`route_walk_kernel<true>`; the plain
// version is ops/route_ref.py `census_counts`): a message the walk takes
// from the outbox (o < count, its row not suppressed), whether it is then
// delivered or dropped, adds one to e[0] if it is a pre-vote request, e[1]
// a vote request, e[2] a pre-vote response that grants (reject 0), e[3] a
// vote response that grants.  Only a response's reject word is read.  Each
// count has a fixed index, so e[] stays in registers (an index computed at
// run time would put it on the stack).
DBT_FI void route_lane_census(const RouteArgs& a, const RouteRow& r,
                              const RouteMsg& f, int o, int* e) {
  if (!f.v) return;
  const bool pv_resp = f.mt == MT_REQUEST_PREVOTE_RESP;
  const bool v_resp = f.mt == MT_REQUEST_VOTE_RESP;
  bool granted = false;
  if (pv_resp || v_resp)
    granted = a.buf[((long long)r.g * a.O + o) * N_FIELDS + F_REJECT] == 0;
  e[0] += f.mt == MT_REQUEST_PREVOTE ? 1 : 0;
  e[1] += f.mt == MT_REQUEST_VOTE ? 1 : 0;
  e[2] += granted && pv_resp ? 1 : 0;
  e[3] += granted && v_resp ? 1 : 0;
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

// bytes of shared memory a receive tile's inbox words take, about
constexpr int RECV_TILE_BYTES = 32 * 1024;

// Rows a receive tile: a multiple of the rows whose slots make a multiple
// of 4 words (so every plane's span of a tile starts on a 16-byte
// boundary where the plane does), about RECV_TILE_BYTES of inbox words,
// and no more than G / tiles_wanted rounded up, so that a small G still
// spreads over `tiles_wanted` tiles.
DBT_HD int recv_tile_rows(int G, int M, int E, int tiles_wanted) {
  const int unit = M % 4 == 0 ? 1 : (M % 2 == 0 ? 2 : 4);
  const int by_size = RECV_TILE_BYTES / (4 * M * (10 + 2 * E)) / unit * unit;
  const int per = (G + tiles_wanted - 1) / tiles_wanted;
  const int by_g = (per + unit - 1) / unit * unit;
  return imax(unit, imin(by_size, by_g));
}

// A receive tile: its rows d0 .. d0 + rows and the block's shared arrays
// (R rows' worth; `recv_tile_layout`).
struct RecvTile {
  int d0, rows, R;
  int* words;  // [R * M * (10 + 2E)] the tile's inbox, plane by plane
  int* count;  // [2] the occupied list's length, by tile parity
  int* pos;    // [R * P * B] the occupied list: the slot row * M + m
  int* fb;     //   and its scratch word flat * B + b
};

// bytes of a tile of R rows, the inbox words first
DBT_HD int recv_smem_bytes(int R, int M, int E, int P, int B) {
  return 4 * R * M * (10 + 2 * E) + 16 + 8 * R * P * B;
}

DBT_HD RecvTile recv_tile_layout(void* smem, int R, int M, int E, int P,
                                 int B) {
  RecvTile t;
  t.d0 = t.rows = 0;
  t.R = R;
  t.words = static_cast<int*>(smem);
  t.count = t.words + R * M * (10 + 2 * E);
  t.pos = t.count + 4;
  t.fb = t.pos + R * P * B;
  return t;
}

// The tile's words of plane `plane`: R * M (a header plane) or R * M * E
// (an entry plane) words, laid out as the plane lays out the tile's rows.
DBT_FI int* recv_plane(const RouteArgs& a, const RecvTile& t, int plane) {
  const int rm = t.R * a.M;
  return plane < 10 ? t.words + plane * rm
                    : t.words + 10 * rm + (plane - 10) * rm * a.E;
}

// The tile's words all zero: each empty slot stays so.  Thread `lane` of
// `lanes`, at the start (each tile's copy-out zeroes what it copied).
DBT_FI void recv_tile_clear(const RouteArgs& a, const RecvTile& t, int lane,
                            int lanes) {
  const int n = t.R * a.M * (10 + 2 * a.E);
  for (int w = lane; w < n; w += lanes) t.words[w] = 0;
}

// n slots of the tile's occupied list for the caller: the first one's index
DBT_FI int recv_claim(int* count, int n) {
#ifdef __CUDA_ARCH__
  return atomicAdd(count, n);
#else
  const int k = *count;
  *count += n;
  return k;
#endif
}

// Region r of the tile's row i / P (i < rows * P): the reference's
// clamped gather picks flat = dest_row[d, r] * P + rank_in_dest[d, r],
// and the region holds the first n = cnt[flat] messages the walk put at
// (flat, 0 .. n) when its source row is another resident row.  Appends
// the region's n occupied slots to the tile's list (`count`: the list's
// length this tile); returns n.
DBT_FI int recv_decide(const RouteArgs& a, const RecvTile& t, int* count,
                       int i) {
  const int G = a.G, P = a.P, B = a.B;
  const int row = i / P, r = i - row * P;
  const int d = t.d0 + row;
  const long long at = (long long)d * P + r;
  const int src = a.dest_row[at];
  const int src_c = src < 0 ? 0 : (src > G - 1 ? G - 1 : src);
  long long flat = (long long)src_c * P + a.rank[at];
  const long long n_flat = (long long)G * P;
  if (flat < 0) flat += n_flat;
  if (flat < 0) flat = 0;
  if (flat > n_flat - 1) flat = n_flat - 1;
  const int n = src >= 0 && src_c != d ? imax(0, imin(a.cnt[flat], B)) : 0;
  if (n) {
    const int k0 = recv_claim(count, n);
    const int q0 = row * a.M + a.base + r * B;
    for (int b = 0; b < n; ++b) {
      t.pos[k0 + b] = q0 + b;
      t.fb[k0 + b] = (int)(flat * B + b);
    }
  }
  return n;
}

// Prefix slot i % base of the tile's row i / base, into the tile (whose
// words are zero): the base_inbox slot, or the tick / propose_leaders
// prefill (make_prefill, route.py:395), which reads `role` for slot 1
// only.
DBT_FI void recv_prefix(const RouteArgs& a, const RecvTile& t, int i) {
  const int row = i / a.base, m = i - row * a.base;
  const int d = t.d0 + row, q = row * a.M + m, E = a.E;
  if (a.base_inbox[0]) {
    const long long bt = (long long)d * a.M_base + m;
#pragma unroll
    for (int k = 0; k < 10; ++k) recv_plane(a, t, k)[q] = a.base_inbox[k][bt];
    for (int e = 0; e < E; ++e) {
      recv_plane(a, t, 10)[q * E + e] = a.base_inbox[10][bt * E + e];
      recv_plane(a, t, 11)[q * E + e] = a.base_inbox[11][bt * E + e];
    }
    return;
  }
  if (a.tick && m == 0) recv_plane(a, t, 0)[q] = MT_TICK;
  if (a.propose_leaders && m == 1 && a.role[d] == ROLE_LEADER) {
    recv_plane(a, t, 0)[q] = MT_PROPOSE;
    recv_plane(a, t, 9)[q] = a.propose_n;
  }
}

// Entry k of the tile's occupied list: the message sender row s put at
// (flat, b), into every plane of its slot in the tile: its outbox words in
// Inbox order (mtype, from_id = the sender's id, term .. n_entries), then
// its E entry words from the sender's ring (route.py:303-318).
DBT_FI void recv_message(const RouteArgs& a, const RecvTile& t, int k) {
  const int fb = t.fb[k], q = t.pos[k];
  const int s = fb / (a.P * a.B);
  const int o = a.scratch[fb];
  const int* w = a.buf + ((long long)s * a.O + o) * N_FIELDS;
  const int mt = w[F_MTYPE], li = w[F_LOG_INDEX], n_ent = w[F_N_ENTRIES];
  recv_plane(a, t, 0)[q] = mt;
  recv_plane(a, t, 1)[q] = a.replica_id[s];
  recv_plane(a, t, 2)[q] = w[F_TERM];
  recv_plane(a, t, 3)[q] = w[F_LOG_TERM];
  recv_plane(a, t, 4)[q] = li;
  recv_plane(a, t, 5)[q] = w[F_COMMIT];
  recv_plane(a, t, 6)[q] = w[F_REJECT];
  recv_plane(a, t, 7)[q] = w[F_HINT];
  recv_plane(a, t, 8)[q] = w[F_HINT_HIGH];
  recv_plane(a, t, 9)[q] = n_ent;
  put_ring_ents(a, s, mt == MT_REPLICATE, n_ent, li,
                recv_plane(a, t, 10) + q * a.E,
                recv_plane(a, t, 11) + q * a.E);
}

// The tile's list, entry j (j < rows * base + the occupied list's n): the
// prefix slots, then the occupied ones.
DBT_FI void recv_listed(const RouteArgs& a, const RecvTile& t, int j) {
  const int n_pre = t.rows * a.base;
  if (j < n_pre)
    recv_prefix(a, t, j);
  else
    recv_message(a, t, j - n_pre);
}

// Words [4c, 4c + 4) of plane `plane`'s span in the tile (the tile's rows
// of the plane, rows * M or rows * M * E words, contiguous in both the
// tile and the inbox) copied out to the inbox and zeroed in the tile.  With
// `vec` (the plane starts on a 16-byte boundary, and so does the span),
// one 16-byte store whole: no word of the inbox is stored twice, and an
// empty slot's zeros wait on no load of the device's memory.
DBT_FI void recv_copy(const RouteArgs& a, const RecvTile& t, int plane,
                      int c, bool vec) {
  const int per = plane < 10 ? 1 : a.E;  // words a slot
  const int span = t.rows * a.M * per;
  const int w0 = 4 * c;
  int* src = recv_plane(a, t, plane) + w0;
  int* dst = a.inbox[plane] + (long long)t.d0 * a.M * per + w0;
#ifdef __CUDA_ARCH__
  if (vec && w0 + 4 <= span) {
    int4* s4 = reinterpret_cast<int4*>(src);
    *reinterpret_cast<int4*>(dst) = *s4;
    *s4 = make_int4(0, 0, 0, 0);
    return;
  }
#endif
  for (int j = 0; j < 4 && w0 + j < span; ++j) {
    dst[j] = src[j];
    src[j] = 0;
  }
}

// The tile's planes chunk by chunk: the caller (`lane` of `lanes`) takes
// chunks lane, lane + lanes, ... of the planes one after another, so
// consecutive lanes write consecutive 16 bytes of a plane.
DBT_FI void recv_planes(const RouteArgs& a, const RecvTile& t, int lane,
                        int lanes, bool vec) {
  const int hc = (t.rows * a.M + 3) / 4;          // chunks of a header plane
  const int ec = (t.rows * a.M * a.E + 3) / 4;    // of an entry plane
  int plane = 0, c = lane;
  while (plane < N_INBOX) {
    const int nc = plane < 10 ? hc : ec;
    if (c < nc) {
      recv_copy(a, t, plane, c, vec);
      c += lanes;
    } else {
      c -= nc;
      ++plane;
    }
  }
}

// Whether every inbox plane starts on a 16-byte boundary.
DBT_HD bool recv_vec(const RouteArgs& a) {
  bool ok = true;
  for (int i = 0; i < N_INBOX; ++i)
    ok = ok && (reinterpret_cast<unsigned long long>(a.inbox[i]) & 15) == 0;
  return ok;
}

}  // namespace dbt

#ifdef __CUDACC__
namespace {

// The block's counts s[0..N) added to stats: a warp sum each, a shared
// sum over the warps, then one atomic a nonzero stat.  Every thread of the
// block calls it.
template <int N, typename T>
__device__ __forceinline__ void block_add(T* stats, const int* s) {
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
    atomicAdd(stats + threadIdx.x, static_cast<T>(part[threadIdx.x]));
}

// The walk: ROUTE_THREADS / WALK_LANES rows a block, a sub-warp a row.  A
// warp walks as many chunks of WALK_LANES messages as the longest outbox
// among its rows needs; the later chunks hold no valid message and only
// write zeros.  CENSUS (a.census given) also counts the election messages
// (`route_lane_census`) into a.census; without it the walk is the same
// code as before the census existed.
template <bool CENSUS>
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
  int e[dbt::N_ROUTE_CENSUS] = {0, 0, 0, 0};
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
      if constexpr (CENSUS) dbt::route_lane_census(a, r, f, o, e);
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
  if constexpr (CENSUS) block_add<dbt::N_ROUTE_CENSUS>(a.census, e);
}

// The receive: persistent blocks, a few an SM, walk the tiles of R rows
// (`recv_tile_rows`) with a grid stride.  A tile is three steps: each
// (row, region) decided by one thread; its list written into the tile in
// shared memory; the tile copied out plane by plane in 16-byte chunks
// (and zeroed for the next).  The copy-out needs no barrier after it: the
// next tile's decisions touch only the list, and its list is written
// after the next barrier.  The delivered count is summed over all of a
// block's tiles and added once.
__global__ void __launch_bounds__(dbt::ROUTE_THREADS)
    route_recv_kernel(const __grid_constant__ dbt::RouteArgs a, int R) {
  extern __shared__ int4 recv_smem[];
  const int T = dbt::ROUTE_THREADS;
  dbt::RecvTile t =
      dbt::recv_tile_layout(recv_smem, R, a.M, a.E, a.P, a.B);
  const bool vec = dbt::recv_vec(a);
  dbt::recv_tile_clear(a, t, threadIdx.x, T);
  if (threadIdx.x < 2) t.count[threadIdx.x] = 0;
  __syncthreads();
  int hit[1] = {0};
  const int n_tiles = (a.G + R - 1) / R;
  int par = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    t.d0 = tile * R;
    t.rows = dbt::imin(R, a.G - t.d0);
    for (int i = threadIdx.x; i < t.rows * a.P; i += T)
      hit[0] += dbt::recv_decide(a, t, t.count + par, i);
    // the next tile's list starts empty: its count was last read before
    // this tile began
    if (threadIdx.x == 0) t.count[par ^ 1] = 0;
    __syncthreads();
    const int n = t.rows * a.base + t.count[par];
    for (int j = threadIdx.x; j < n; j += T) dbt::recv_listed(a, t, j);
    __syncthreads();
    dbt::recv_planes(a, t, threadIdx.x, T, vec);
    par ^= 1;
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
                       int propose_leaders, int propose_n,
                       unsigned long long* census, void* stream) {
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
  a.census = census;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = dbt::ROUTE_THREADS;
  cudaMemsetAsync(stats, 0, dbt::N_ROUTE_STATS * sizeof(int), s);
  const int rows = T / dbt::WALK_LANES;
  const unsigned walk_blocks = (unsigned)((G + rows - 1) / rows);
  if (census)
    route_walk_kernel<true><<<walk_blocks, T, 0, s>>>(a);
  else
    route_walk_kernel<false><<<walk_blocks, T, 0, s>>>(a);
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int R = dbt::recv_tile_rows(G, M, E, 2 * sms);
  const int smem = dbt::recv_smem_bytes(R, M, E, P, B);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(route_recv_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, route_recv_kernel, T,
                                                smem);
  const int n_tiles = (G + R - 1) / R;
  const int blocks = dbt::imin(n_tiles, sms * dbt::imax(per_sm, 1));
  route_recv_kernel<<<(unsigned)blocks, T, smem, s>>>(a, R);
}
#endif
