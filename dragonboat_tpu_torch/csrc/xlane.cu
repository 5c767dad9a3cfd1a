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
// this file.
//
// Bound: bytes.  The pack reads the valid outbox messages (11 words
// each), their rows' tables and ring words, and writes all of xbuf
// (D*XB*KT words, mostly zeros: the per-edge budget is sized for the
// worst case); the scatter reads (D-1)*XB*KT words and adds into the
// inbox words it delivers.
//
// xlane_pack, three launches on one stream, R rows a block (32, 64 or
// 128: ops/route.py `lane_rows_per_block`):
//   1. count (xlane_count_kernel): a sub-warp of 8 lanes walks a row's
//      outbox, one lane a message (walk.cuh, as route.cu's walk), as far
//      as the longest outbox among the warp's rows reaches.  The row's P
//      peer slots (id and the three tables) are loaded lane-parallel and
//      read by shuffles.  Each lane computes its message's facts over ALL
//      matching peer slots (hits, the sums xdev / xloc / xrank at the
//      hits: at_pstar, :711; the ring window, :719-729).  The reference's
//      exclusive cumsum k_excl per peer slot is a ballot of (hit_p &&
//      deliverable) a slot (:737), the row's sendable count toward device
//      d a ballot of (sendable && xdev == d) a device (both walk.cuh
//      `lane_rank`).  The block's R rows put their counts in shared
//      memory and scan them in row order (a warp a device): the kernel
//      writes each row's in-block offset per device [G, D], the block's
//      totals [nblk, D] and its partial stats [nblk, 4].
//   2. scan (xlane_scan_kernel): one block scans the nblk x D block
//      totals into block offsets (one block-wide scan for every device and
//      partial stat at once), writes the device totals and the stats row
//      whole (the partials summed; sent = sum of min(total_d, XB)).  No
//      memset, no atomic.
//   3. write (xlane_write_kernel): first the grid zeroes rows
//      [min(total_d, XB), XB) of every device, 16 bytes a store where the
//      address allows.  Then the same walk again: the j-th of a block's
//      sendable messages toward device d has lane slot q = the block's
//      offset + j — the count of earlier sendable messages toward d in
//      flat (g, o) order (route.py:742-747), the same on every run (an
//      atomic counter would not be) — and is packed there when q < XB.
//      A block's rows toward d have consecutive slots, so a block packs
//      them in shared memory first (up to XL_STAGE_BYTES) and writes each
//      device's run out whole, coalesced; a block with more rows than
//      that packs each in place.
//   With the colocated engine's operands (a mesh-mode launch's route
//   step, ops/colocated.py) the pack also holds a message to its
//   receiver's alive word, in the global row order dest_dev * G +
//   dest_local: a stopping or detached receiver is not fed, as the
//   single-device route's dest_alive (route.py:143).  The write pass then
//   sets the delivered bit of every message it carried in the route's
//   bit-packed mask and rewrites the row's undelivered word (a valid
//   message left without a bit), so the flag word built after it tells
//   the host which messages it still owns.  The stats row has an eighth
//   word then: the messages toward another device the lane refuses (a
//   forwarded PROPOSE, or a receiver not alive), which the single-device
//   route counts as host_carried.
// xlane_scatter, one launch: one thread per received row; a row with
// found != 0 is counted in `delivered` and, when its row and slot lie in
// [0, G) x [0, M), its fields are ADDED into the inbox with atomicAdd
// (the reference's one-hot sum, exact even if two rows met).
//
// Per-message arithmetic kept as the reference's: a forwarded PROPOSE
// never rides the lane; the below-ring marker; payload word e is the
// sender's ring at max(log_index + 1 + e, 0) & (W-1) while e < n_entries;
// b is the SUM of k_excl over the hit slots (each gives the same k_excl:
// the slots that match `to` hold one id).
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain
// C++: then the per-slot, per-row and per-message steps (`xlane_slot`,
// `xlane_row_scalars`, `xlane_lane_facts`, `lane_rank`,
// `xlane_lane_tally`, `xlane_row_at`, `xlane_pack_row`,
// `xlane_block_segs`, `xlane_flush_rows`, `xlane_finish_stats`,
// `xlane_zero_range`, `xlane_scatter_row`) are host functions, and a host
// loop that runs them lane by lane and block by block, with the masks
// made from the lanes' predicates, checks the three passes without a card.
#include "blocks.cuh"
#include "common.cuh"
#include "launch.h"
#include "walk.cuh"

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
// most devices a row's counters hold
constexpr int XDMAX = 16;
// shared memory a block of the write pass stages its packed rows in
// (below the 48 KB a block takes without opting in to more)
constexpr int XL_STAGE_BYTES = 40 * 1024;
// threads a block of the count and write passes; most rows a block
constexpr int XL_THREADS = 256;
constexpr int XL_RMAX = 128;
// the partial stats a block writes: dropped_budget, dropped_ring,
// sendable, suppressed rows, refused (host-carried) messages
constexpr int XL_NPART = 5;

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
  int* rowoff;             // [G, D] a row's in-block offset per device
  int* btot;               // [nblk, D] a block's sendable rows per device
  int* boff;               // [nblk, D] the block's first lane slot
  int* part;               // [nblk, XL_NPART] a block's partial stats
  int* tot;                // [D] device totals
  int* stats;              // [n_stats]: 7, or 8 with the refused count
  int G, P, W, O, E, D, XB, B, me, R, nblk;
  int stage_rows;          // packed rows a block stages in shared memory
  // the colocated operands: the receivers' alive words, read at
  // alive[(dest_dev * G + dest_local) * alive_stride] (null: every
  // receiver alive); the route's delivered bits [G, nw] and undelivered
  // words [G], updated by the write pass (both null, or neither)
  const int* alive = nullptr;
  int alive_stride = 1;
  int* packed = nullptr;
  int* undeliv = nullptr;
  int nw = 0;
  int n_stats = 7;
};

// One peer slot of a sending row: its id and the three mesh tables.
struct XSlot {
  int pid, dev, loc, rank;
};

DBT_FI XSlot xlane_slot(const XPackArgs& a, int g, int p) {
  const long long at = (long long)g * a.P + p;
  return XSlot{a.peer_id[at], a.dest_dev[at], a.dest_local[at], a.rank[at]};
}

// A row's facts, the same in every lane of its sub-warp.
struct XRow {
  int g, count, last, win_lo, me;
  bool sup;
};

DBT_FI void xlane_row_empty(XRow& r) {
  r.g = r.count = r.last = r.win_lo = r.me = 0;
  r.sup = false;
}

DBT_FI void xlane_row_scalars(const XPackArgs& a, int g, XRow& r) {
  r.g = g;
  r.count = a.count[g];
  r.sup = a.suppress && a.suppress[g] != 0;
  r.last = a.last_index[g];
  r.win_lo = imax(a.first_index[g], wsub(r.last, a.W - 1));
  r.me = a.replica_id[g];
}

// the messages of row r a walk must look at: none when it is suppressed
DBT_FI int xlane_row_live(const XPackArgs& a, const XRow& r) {
  return r.sup ? 0 : imax(0, imin(r.count, a.O));
}

// One message, in the lane that holds it.
struct XMsg {
  const int* m;  // its words
  int mt, to, n_ent, li, lt;
  uint32_t hits;         // peer slots whose id matches `to`
  int xdev, xloc, xrank;  // the tables summed over the hits
  int b;                  // its region slot: the sum of k_excl at the hits
  bool v, routable, refused, ring_ok, deliverable;
};

// Message o's words, read only when the row's walk holds it.
DBT_FI void xlane_msg_load(const XPackArgs& a, const XRow& r, int o,
                           XMsg& f) {
  f.m = a.buf + ((long long)r.g * a.O + o) * N_FIELDS;
  f.v = o < xlane_row_live(a, r);
  f.mt = f.to = f.n_ent = f.li = f.lt = 0;
  f.hits = 0;
  f.xdev = f.xloc = f.xrank = f.b = 0;
  if (!f.v) return;
  f.mt = f.m[F_MTYPE];
  f.to = f.m[F_TO];
  f.n_ent = f.m[F_N_ENTRIES];
  f.li = f.m[F_LOG_INDEX];
  f.lt = f.m[F_LOG_TERM];
}

// Peer slot p (`s`) against the message: a hit adds its tables.
DBT_FI void xlane_hit(XMsg& f, int p, const XSlot& s) {
  if (!(f.v && s.pid == f.to && f.to != 0 && s.pid != 0)) return;
  f.hits |= 1u << p;
  f.xdev = wadd(f.xdev, s.dev);
  f.xloc = wadd(f.xloc, s.loc);
  f.xrank = wadd(f.xrank, s.rank);
}

// The message's facts, once every slot has been held against it.
DBT_FI void xlane_msg_facts(const XPackArgs& a, const XRow& r, XMsg& f) {
  const bool carries = f.mt == MT_REPLICATE && f.n_ent > 0;
  const bool marker = f.mt == MT_REPLICATE && f.li > 0 && f.lt == 0;
  f.ring_ok = !carries || (wadd(f.li, 1) >= r.win_lo &&
                           wadd(f.li, f.n_ent) <= r.last && !marker);
  const bool remote = f.hits != 0 && f.xdev >= 0 && f.xdev != a.me;
  bool alive = true;
  if (a.alive && remote) {
    // the receiver's global row, clamped into the mesh as the reference
    // clamps dest_row (route.py:236)
    const int x = imin(imax(wadd(wmul(f.xdev, a.G), f.xloc), 0),
                       wmul(a.D, a.G) - 1);
    alive = a.alive[(long long)x * a.alive_stride] != 0;
  }
  f.routable = remote && f.mt != MT_PROPOSE && alive;
  f.refused = remote && !f.routable;
  f.deliverable = f.routable && f.ring_ok;
}

// A row's peer slots, id and the three tables: on the card slot p is
// held by the sub-warp's lane p % WALK_LANES (LaneWords).
struct XSlots {
  LaneWords pid, dev, loc, rank;
  DBT_LANE XSlot get(int p) const {
    return XSlot{pid.get(p), dev.get(p), loc.get(p), rank.get(p)};
  }
};

// Message o's facts in the lane that holds it: its words, every peer
// slot held against it, and what follows from them.
DBT_LANE void xlane_lane_facts(const XPackArgs& a, const XRow& r, int o,
                               const XSlots& sl, XMsg& f) {
  xlane_msg_load(a, r, o, f);
  for (int p = 0; p < a.P; ++p) xlane_hit(f, p, sl.get(p));
  xlane_msg_facts(a, r, f);
}

// The message's region slot b = popc(hits) * bx (bx: its k_excl, the
// same at every hit slot) and its counts: s[0] dropped_budget, s[1]
// dropped_ring, s[2] sendable, s[4] refused.  Returns whether it takes a
// lane slot: a
// sendable message toward a device outside [0, D) has no lane (counted
// as dropped_xlane).
DBT_FI bool xlane_lane_tally(const XPackArgs& a, XMsg& f, int bx, int* s) {
  f.b = popc(f.hits) * bx;
  const bool in_b = f.b < a.B;
  if (f.deliverable && !in_b) s[0] += 1;
  if (f.routable && !f.ring_ok) s[1] += 1;
  if (f.deliverable && in_b) s[2] += 1;
  if (f.refused) s[4] += 1;
  return f.deliverable && in_b && f.xdev < a.D;
}

// Whether the j-th of block blk's sendable rows toward device x gets a
// lane slot (q = boff + j below XB): the message is carried.
DBT_HD bool xlane_carried(const XPackArgs& a, int blk, int x, int j) {
  return a.boff[(long long)blk * a.D + x] + j < a.XB;
}

// Message o of row g after the lane: whether it stays with the host — a
// valid message (`v`) that neither the route (its bit in `packed`) nor
// the lane (`carried`) delivered.
DBT_HD bool xlane_undelivered(const XPackArgs& a, int g, int o, bool v,
                              bool carried) {
  if (!v || carried) return false;
  const int w = a.packed[(long long)g * a.nw + (o >> 5)];
  return ((w >> (o & 31)) & 1) == 0;
}

// The delivered bits of chunk c of row g (bit l: message
// c * WALK_LANES + l) set in the row's packed words: a chunk lies in
// one word, and only the row's walk writes them.
DBT_HD void xlane_mark_carried(const XPackArgs& a, int g, int c,
                               uint32_t carried) {
  if (!carried) return;
  const int o = c * WALK_LANES;
  int* w = a.packed + (long long)g * a.nw + (o >> 5);
  *w = (int)((uint32_t)*w | (carried << (o & 31)));
}

// Where the j-th of block blk's sendable rows toward device x is packed:
// row seg[x] + j of the block's stage, or with no stage its lane slot
// q = boff + j of xbuf when q < XB; else nowhere (null).
DBT_HD int* xlane_row_at(const XPackArgs& a, int blk, int x, int j,
                         int* stage, const int* seg) {
  const long long KT = X_KF + 2 * a.E;
  if (stage) return stage + (seg[x] + j) * KT;
  const int q = a.boff[(long long)blk * a.D + x] + j;
  return q < a.XB ? a.xbuf + ((long long)x * a.XB + q) * KT : nullptr;
}

// The message as a packed lane row at `row` (KT words).
DBT_FI void xlane_pack_row(const XPackArgs& a, const XRow& r, const XMsg& f,
                           int* row) {
  const int E = a.E;
  const int* m = f.m;
  row[0] = f.mt;
  row[1] = m[F_TERM];
  row[2] = f.lt;
  row[3] = f.li;
  row[4] = m[F_COMMIT];
  row[5] = m[F_REJECT];
  row[6] = m[F_HINT];
  row[7] = m[F_HINT_HIGH];
  row[8] = f.n_ent;
  row[XI_FROM] = r.me;
  row[XI_LOC] = f.xloc;
  row[XI_RANK] = f.xrank;
  row[XI_B] = f.b;
  row[XI_FOUND] = 1;
  const bool is_repl = f.mt == MT_REPLICATE;
  const long long rw = (long long)r.g * a.W;
  if (E <= 4) {  // the ring words in registers: all their loads at once
    int t[4], c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool has_e = e < E && is_repl && e < f.n_ent;
      const int pos = imax(wadd(wadd(f.li, 1), e), 0) & (a.W - 1);
      t[e] = has_e ? a.ring_term[rw + pos] : 0;
      c[e] = has_e ? a.ring_cc[rw + pos] : 0;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E) {
        row[X_KF + e] = t[e];
        row[X_KF + E + e] = c[e];
      }
    return;
  }
  for (int e = 0; e < E; ++e) {
    const bool has_e = is_repl && e < f.n_ent;
    const int pos = imax(wadd(wadd(f.li, 1), e), 0) & (a.W - 1);
    row[X_KF + e] = has_e ? a.ring_term[rw + pos] : 0;
    row[X_KF + E + e] = has_e ? a.ring_cc[rw + pos] : 0;
  }
}

// The stats row from the device totals and the summed partial stats.
DBT_HD void xlane_finish_stats(const XPackArgs& a, const int* tot,
                               const int* st) {
  int sent = 0;
  for (int d = 0; d < a.D; ++d) sent += imin(tot[d], a.XB);
  a.stats[0] = sent;
  a.stats[1] = 0;  // delivered: the scatter's
  a.stats[2] = st[0];
  a.stats[3] = st[2] - sent;  // sendable, less sent: dropped_xlane
  a.stats[4] = st[1];
  a.stats[5] = st[3];
  a.stats[6] = a.G - st[3];
  if (a.n_stats > 7) a.stats[7] = st[4];
}

// The packed rows a block of the write pass can stage: as many as its R
// rows can send, or as many as XL_STAGE_BYTES hold.
DBT_HD int xlane_stage_rows(int R, int O, int E) {
  const long long most = (long long)R * O;
  const int fit = XL_STAGE_BYTES / (4 * (X_KF + 2 * E));
  return most < fit ? (int)most : fit;
}

// Where block blk stages its rows toward each device: seg[d] = the rows
// toward the devices before d; returns the block's sendable rows.
DBT_HD int xlane_block_segs(const XPackArgs& a, int blk, int* seg) {
  int n = 0;
  for (int d = 0; d < a.D; ++d) {
    seg[d] = n;
    n += a.btot[(long long)blk * a.D + d];
  }
  return n;
}

// Of block blk's rows toward device d, those that get a lane slot (the
// slot q = boff + j of its j-th row is below XB).
DBT_HD int xlane_flush_rows(const XPackArgs& a, int blk, int d) {
  const long long at = (long long)blk * a.D + d;
  return imin(a.btot[at], imax(0, a.XB - a.boff[at]));
}

// The xbuf words of device d's block past its last packed row:
// [*lo, *hi), rows [min(total, XB), XB).
DBT_HD void xlane_zero_range(const XPackArgs& a, int d, int total,
                             long long* lo, long long* hi) {
  const long long KT = X_KF + 2 * a.E;
  *lo = ((long long)d * a.XB + imin(total, a.XB)) * KT;
  *hi = ((long long)d + 1) * a.XB * KT;
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

constexpr int SCAN_THREADS = 512;

__device__ void warp_add(int* dst, int v, bool active) {
  const int s = __reduce_add_sync(0xffffffffu, active ? v : 0);
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(dst, s);
}

// A row's peer slots, lane-parallel: slot p in lane p % WALK_LANES.
__device__ __forceinline__ void xlane_load_slots(const dbt::XPackArgs& a,
                                                 const dbt::XRow& r,
                                                 bool row_ok, int sub,
                                                 dbt::XSlots& sl) {
  constexpr int L = dbt::WALK_LANES;
  if (row_ok && sub < a.P) {
    const dbt::XSlot x = dbt::xlane_slot(a, r.g, sub);
    sl.pid.lo = x.pid, sl.dev.lo = x.dev, sl.loc.lo = x.loc;
    sl.rank.lo = x.rank;
  }
  if (row_ok && sub + L < a.P) {
    const dbt::XSlot x = dbt::xlane_slot(a, r.g, sub + L);
    sl.pid.hi = x.pid, sl.dev.hi = x.dev, sl.loc.hi = x.loc;
    sl.rank.hi = x.rank;
  }
}

// One row's walk by its sub-warp, as many chunks of WALK_LANES messages as
// the longest live outbox among the warp's rows needs.  dcnt: the row's
// sendable messages toward each device so far.  Count pass: the stats go
// to s.  Write pass: the j-th of block blk's sendable messages toward
// device d (j = rowoff[d], the row's offset in the block, plus its rank
// in the row) is packed at `xlane_row_at`; with the colocated operands it
// also sets the carried messages' delivered bits and returns whether a
// valid message of the row stays undelivered.
template <bool WRITE>
__device__ __forceinline__ bool xlane_walk(const dbt::XPackArgs& a,
                                           const dbt::XRow& r, int sub,
                                           int blk, const dbt::XSlots& sl,
                                           const dbt::LaneWords& rowoff,
                                           int* stage, const int* seg,
                                           int* s, dbt::LaneWords& dcnt) {
  constexpr int L = dbt::WALK_LANES;
  const int n_live =
      __reduce_max_sync(0xffffffffu, dbt::xlane_row_live(a, r));
  const auto ballot = [](int, bool pred) { return dbt::sub_ballot(pred); };
  dbt::LaneWords carry;  // deliverable messages toward each peer slot
  bool und = false;
  for (int c = 0; c * L < n_live; ++c) {
    dbt::XMsg f;
    const int o = c * L + sub;
    dbt::xlane_lane_facts(a, r, o, sl, f);
    const int bx = dbt::lane_rank(a.P, f.deliverable ? f.hits : 0u, sub,
                                  ballot, carry);
    const bool ok = dbt::xlane_lane_tally(a, f, bx, s);
    const int q = dbt::lane_rank(a.D, ok ? 1u << f.xdev : 0u, sub, ballot,
                                 dcnt);
    if (WRITE) {
      const int j = q + rowoff.pick(ok ? f.xdev : 0);
      int* row = ok ? dbt::xlane_row_at(a, blk, f.xdev, j, stage, seg)
                    : nullptr;
      if (row) dbt::xlane_pack_row(a, r, f, row);
      if (a.packed) {
        const bool carried = ok && dbt::xlane_carried(a, blk, f.xdev, j);
        const uint32_t bits = dbt::sub_ballot(carried);
        und |= dbt::sub_ballot(
                   dbt::xlane_undelivered(a, r.g, o, f.v, carried)) != 0;
        if (sub == 0) dbt::xlane_mark_carried(a, r.g, c, bits);
      }
    }
  }
  return und;
}

// The count pass: XL_THREADS / WALK_LANES rows at a time, R rows a block.
__global__ void __launch_bounds__(dbt::XL_THREADS)
    xlane_count_kernel(const __grid_constant__ dbt::XPackArgs a) {
  constexpr int L = dbt::WALK_LANES;
  __shared__ int rc[dbt::XL_RMAX][dbt::XDMAX];
  __shared__ int wsum[dbt::XL_THREADS / 32][dbt::XL_NPART];
  const unsigned full = 0xffffffffu;
  const int sub = threadIdx.x & (L - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = blockIdx.x;
  int s[dbt::XL_NPART] = {0, 0, 0, 0};
  const dbt::LaneWords none;
  for (int r0 = 0; r0 < a.R; r0 += dbt::XL_THREADS / L) {
    const int rr = r0 + threadIdx.x / L;
    const int g = blk * a.R + rr;
    const bool row_ok = g < a.G && rr < a.R;
    dbt::XRow r;
    if (row_ok)
      dbt::xlane_row_scalars(a, g, r);
    else
      dbt::xlane_row_empty(r);
    dbt::XSlots sl;
    xlane_load_slots(a, r, row_ok, sub, sl);
    dbt::LaneWords dcnt;
    xlane_walk<false>(a, r, sub, blk, sl, none, nullptr, nullptr, s, dcnt);
    if (r.sup && sub == 0) s[3] += 1;
    if (rr < a.R)
      for (int d = sub; d < a.D; d += L) rc[rr][d] = dcnt.held(d);
  }
  __syncthreads();
  // the block's rows in row order, a warp a device: `per` rows a lane
  const int per = (a.R + 31) / 32;
  for (int d = warp; d < a.D; d += dbt::XL_THREADS / 32) {
    int v[dbt::XL_RMAX / 32], sum = 0;
#pragma unroll
    for (int i = 0; i < dbt::XL_RMAX / 32; ++i) {
      const int rr = lane * per + i;
      v[i] = i < per && rr < a.R ? rc[rr][d] : 0;
      sum += v[i];
    }
    const int incl = dbt::warp_incl_scan(sum);
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < dbt::XL_RMAX / 32; ++i) {
      const int rr = lane * per + i;
      const int g = blk * a.R + rr;
      if (i < per && rr < a.R && g < a.G)
        a.rowoff[(long long)g * a.D + d] = run;
      run += v[i];
    }
    if (lane == 31) a.btot[(long long)blk * a.D + d] = incl;
  }
#pragma unroll
  for (int i = 0; i < dbt::XL_NPART; ++i) {
    const int v = __reduce_add_sync(full, s[i]);
    if (lane == 0) wsum[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < dbt::XL_NPART) {
    int t = 0;
    for (int w = 0; w < dbt::XL_THREADS / 32; ++w) t += wsum[w][threadIdx.x];
    a.part[(long long)blk * dbt::XL_NPART + threadIdx.x] = t;
  }
}

// The scan: one block of SCAN_THREADS threads, one pass.  Thread t sums
// `per` consecutive blocks' totals toward each device and their partial
// stats; a block-wide scan of those sums (a warp scan, then a scan of the
// warps' sums) gives each block's offsets, and the totals.
__global__ void __launch_bounds__(SCAN_THREADS)
    xlane_scan_kernel(const __grid_constant__ dbt::XPackArgs a) {
  constexpr int NV = dbt::XDMAX + dbt::XL_NPART;
  constexpr int NW = SCAN_THREADS / 32;
  __shared__ int wsum[NW][NV];
  __shared__ int total[NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.D, n = a.nblk;
  const int per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = dbt::imin((int)threadIdx.x * per, n);
  const int hi = dbt::imin(lo + per, n);
  int v[NV], incl[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0;
  for (int i = lo; i < hi; ++i) {
#pragma unroll
    for (int d = 0; d < dbt::XDMAX; ++d)
      if (d < D) v[d] += a.btot[(long long)i * D + d];
#pragma unroll
    for (int k = 0; k < dbt::XL_NPART; ++k)
      v[dbt::XDMAX + k] += a.part[(long long)i * dbt::XL_NPART + k];
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    incl[k] = dbt::warp_incl_scan(v[k]);
    if (lane == 31) wsum[warp][k] = incl[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int x = lane < NW ? wsum[lane][k] : 0;
      const int xi = dbt::warp_incl_scan(x);
      if (lane < NW) wsum[lane][k] = xi - x;
      if (lane == 31) total[k] = xi;
    }
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < dbt::XDMAX; ++d) {
    if (d >= D) continue;
    int run = wsum[warp][d] + incl[d] - v[d];
    for (int i = lo; i < hi; ++i) {
      a.boff[(long long)i * D + d] = run;
      run += a.btot[(long long)i * D + d];
    }
  }
  if (threadIdx.x < D) a.tot[threadIdx.x] = total[threadIdx.x];
  if (threadIdx.x == 0)
    dbt::xlane_finish_stats(a, total, total + dbt::XDMAX);
}

// p[0, n) = 0 by the grid's threads (t of `stride`), 16 bytes a store
// between the first and the last 16-byte boundary
__device__ __forceinline__ void zero_words(int* p, long long n, long long t,
                                           long long stride) {
  // words up to the first 16-byte boundary
  const long long mis = ((16 - ((unsigned long long)p & 15)) & 15) / 4;
  const long long head = mis < n ? mis : n;
  if (t < head) p[t] = 0;
  int4* q = reinterpret_cast<int4*>(p + head);
  const long long n4 = (n - head) / 4;
  const int4 z = make_int4(0, 0, 0, 0);
  for (long long i = t; i < n4; i += stride) q[i] = z;
  const long long rest = head + n4 * 4;
  if (t < n - rest) p[rest + t] = 0;
}

// The write pass: first the grid's share of the zero rows (they need only
// the device totals, so their stores go out while the walks wait on their
// loads), then the count pass's walk again.  A block whose sendable rows
// fit its stage packs them there, in lane-slot order a device, and then
// writes each device's run of rows out whole (its rows toward a device
// have consecutive slots); a block with more packs each row in place.
// (a minimum of one block an SM: with the colocated operands' state the
// default bounds cap the walk at 64 registers and spill 8 bytes)
__global__ void __launch_bounds__(dbt::XL_THREADS, 1)
    xlane_write_kernel(const __grid_constant__ dbt::XPackArgs a) {
  constexpr int L = dbt::WALK_LANES;
  extern __shared__ int stage[];
  __shared__ int seg[dbt::XDMAX];
  __shared__ int staged;
  const long long t = (long long)blockIdx.x * dbt::XL_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * dbt::XL_THREADS;
  for (int d = 0; d < a.D; ++d) {
    long long lo, hi;
    dbt::xlane_zero_range(a, d, a.tot[d], &lo, &hi);
    zero_words(a.xbuf + lo, hi - lo, t, stride);
  }
  const int blk = blockIdx.x;
  if (blk >= a.nblk) return;  // a block of the zero fill only
  if (threadIdx.x == 0)
    staged = dbt::xlane_block_segs(a, blk, seg) <= a.stage_rows;
  __syncthreads();
  const int sub = threadIdx.x & (L - 1);
  int s[dbt::XL_NPART] = {0, 0, 0, 0};
  for (int r0 = 0; r0 < a.R; r0 += dbt::XL_THREADS / L) {
    const int rr = r0 + threadIdx.x / L;
    const int g = blk * a.R + rr;
    const bool row_ok = g < a.G && rr < a.R;
    dbt::XRow r;
    if (row_ok)
      dbt::xlane_row_scalars(a, g, r);
    else
      dbt::xlane_row_empty(r);
    dbt::XSlots sl;
    xlane_load_slots(a, r, row_ok, sub, sl);
    // the row's offset in the block toward each device
    dbt::LaneWords rowoff;
    if (row_ok && sub < a.D)
      rowoff.lo = a.rowoff[(long long)g * a.D + sub];
    if (row_ok && sub + L < a.D)
      rowoff.hi = a.rowoff[(long long)g * a.D + sub + L];
    dbt::LaneWords dcnt;
    const bool und = xlane_walk<true>(a, r, sub, blk, sl, rowoff,
                                      staged ? stage : nullptr, seg, s, dcnt);
    // a live row's undelivered word: the route's, with the lane's
    // deliveries (a suppressed row keeps the route's)
    if (a.packed && row_ok && !r.sup && sub == 0) a.undeliv[g] = und;
  }
  if (!staged) return;
  __syncthreads();
  const int KT = dbt::X_KF + 2 * a.E;
  for (int d = 0; d < a.D; ++d) {
    const int n = dbt::xlane_flush_rows(a, blk, d) * KT;
    const int* src = stage + (long long)seg[d] * KT;
    int* dst = a.xbuf + ((long long)d * a.XB +
                         a.boff[(long long)blk * a.D + d]) * KT;
    for (int w = threadIdx.x; w < n; w += dbt::XL_THREADS) dst[w] = src[w];
  }
}

__global__ void xlane_scatter_kernel(const dbt::XScatArgs a) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = r < a.R;
  const int hit = active ? dbt::xlane_scatter_row(a, r) : 0;
  warp_add(a.stats + 1, hit, active);
}

// at least a block an SM for the write pass's zero fill
constexpr int N_SM = 132;

}  // namespace

void dbt::xlane_pack_launch(const int* const* st, const int* buf,
                            const int* count, const int* suppress,
                            const int* dest_local, const int* dest_dev,
                            const int* rank, int* xbuf, int* rowoff,
                            int* btot, int* boff, int* part, int* tot,
                            int* stats, int n_stats, const int* alive,
                            int alive_stride, int* packed, int* undeliv,
                            int G, int P, int W, int O, int E, int D, int XB,
                            int B, int me, int rows_per_block,
                            void* stream) {
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
  a.rowoff = rowoff;
  a.btot = btot;
  a.boff = boff;
  a.part = part;
  a.tot = tot;
  a.stats = stats;
  a.n_stats = n_stats;
  a.alive = alive;
  a.alive_stride = alive_stride;
  a.packed = packed;
  a.undeliv = undeliv;
  a.nw = (O + 31) / 32;
  a.G = G;
  a.P = P;
  a.W = W;
  a.O = O;
  a.E = E;
  a.D = D;
  a.XB = XB;
  a.B = B;
  a.me = me;
  a.R = rows_per_block;
  a.nblk = (G + rows_per_block - 1) / rows_per_block;
  a.stage_rows = dbt::xlane_stage_rows(a.R, O, E);
  const size_t smem = (size_t)a.stage_rows * 4 * (dbt::X_KF + 2 * E);
  cudaStream_t s = (cudaStream_t)stream;
  const int T = dbt::XL_THREADS;
  const unsigned wgrid = (unsigned)(a.nblk > N_SM ? a.nblk : N_SM);
  if (a.nblk) xlane_count_kernel<<<a.nblk, T, 0, s>>>(a);
  xlane_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(a);
  xlane_write_kernel<<<wgrid, T, smem, s>>>(a);
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
