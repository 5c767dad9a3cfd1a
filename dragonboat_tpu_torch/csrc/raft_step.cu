// raft_step: the raft step for every row, one thread per row, the row's
// arrays staged in shared memory.
//
// Replaces dragonboat_tpu/ops/kernel.py `step` (:1652; `_step_impl` /
// `_process_slot` and every handler, kernel.py:181-1649) as
// `raft_step_kernel`, and `step_internal` (:1674, the G-last layout) as
// `raft_step_internal_kernel`.  It computes what that program computes,
// not how: the JAX program runs each inbox slot as one masked pass over
// all rows with one-hot selects; here each thread walks ITS row's inbox
// slots in order, skipping empty ones, and stops once its `escalate` word
// is set.  That gives the reference's slot compaction/un-compaction for
// free: slot outputs and buf[..., F_SRC_SLOT] are in caller coordinates.
//
// Bound: bytes.  A row reads its state (21 + 8P + 2W words) and inbox
// slot types (M) once, the other words of its occupied slots (9 + 2E
// each), and writes its new state and outputs (11O + 5 + P + 2M + ME
// words); the control flow is a few hundred integer operations a
// message, far below the card's integer rate.  What the card spends
// beyond the bound is the row logic's latency: one thread walks a row's
// slots, and the rows of a warp take different handlers.
//
// Design.  A block steps R rows (32, 64 or 128), one thread each, in
// four phases split by __syncthreads():
//   1. load: the block's 8 peer arrays and 2 ring arrays (8P + 2W words a
//      row) are copied into a shared-memory tile with cp.async, coalesced:
//      in the external layout ([G, n] arrays) the block's rows of an array
//      are one contiguous slab, read linearly and transposed into the
//      tile; in the G-last layout ([n, G]) they are n runs of R words,
//      copied 16 bytes at a time where G and the pointers allow it.  Each
//      thread publishes its row's first occupied inbox slot and sets its
//      row's first K outbox messages in the tile: zeros, and F_SRC_SLOT =
//      that first slot (what the reference's un-compaction gives an
//      unused outbox row).
//   2. prefill: the block writes its rows' other outputs coalesced, as
//      the reference initialises them: outbox messages K .. O-1 (as
//      above), need_snapshot, slot_base, slot_term and ent_drop.
//   3. rows: each thread runs the row logic on its row: the 21 state
//      scalars in registers, the 10 state arrays in the tile, where
//      thread t's element k of the array at tile word a is
//      tile[(a + k) * S + t] (S = R in the G-last layout, R + 1 in the
//      external one, so that the transposes of phases 1 and 4 hit
//      distinct banks; consecutive threads always do).  An emit of one
//      of the row's first K messages writes the tile; later messages, a
//      proposal's slot words and a snapshot flag are written straight to
//      device memory.
//   4. store: the block writes the tile's arrays and staged messages
//      out, coalesced, as in phase 1.
// raft_step_kernel is a template on ROUTED.  raft_step_kernel<false> is
// the full step above, whose outputs are DeviceOut's every field (the
// engines read the side channels).  raft_step_kernel<true> is the routed
// round's (ops/route.routed_round), whose outbox goes only to the route,
// which reads a row's count, escalate and messages below the count: it
// skips phase 2 and its barrier, phase 1's staged fill and first-slot
// scan, and the row logic's writes of need_snapshot, slot_base,
// slot_term, ent_drop, append_lo and the barrier pair; phase 3 leaves the
// row's count in the tile's row word and phase 4 stores only the staged
// messages below it.  No other output word is written.
// The row logic is one piece of code for both layouts: the two layouts'
// kernels differ only in phases 1, 2 and 4 and in the stride they hand it
// (an inbox or output element k of row g sits at g * n + k in the external
// layout, es = 1, and at g + k * G in the G-last one, es = G).  The Row
// holds no pointer into device memory: its outputs are addressed from
// the kernel's arguments when written.  Shared memory a block:
// (S * (8P + 2W + 11K) + R) * 4 bytes.  ops/kernel.py picks R
// (`rows_per_block`: the largest that still gives every SM a block) and
// K (`staged_messages`: min(O, 8)); both were chosen by measurement on
// the H100 (scripts/step_ab.py --sweep; PERF.md): staging the
// first 8 messages takes bench phase A's election traffic off scattered
// device-memory stores, while staging all 32 of a wide outbox costs
// more occupancy than it saves.
//
// Hazards handled as the reference defines them:
//   * a peer slot outside [0, P) reads 0 and writes nothing (the
//     one-hot selects of `_col` / `_set_col`);
//   * `_slot_of` returns slot 0 when no peer matches;
//   * the election jitter is uint32 arithmetic;
//   * int32 sums wrap (wadd/wsub), as JAX int32 does;
//   * the quorum index is the value at position P - quorum of the sorted
//     slot values (match of a voter, -1 otherwise), counted, not sorted;
//   * a full outbox sets ESC_OVERFLOW, as `_emit` does.
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain
// C++: then the phases (`step_load`, `step_prefill`, `step_rows`,
// `step_store`) are host functions that one caller runs for every thread
// of a block in turn, in the kernel's order.
#include "common.cuh"
#include "launch.h"

// Everything of the row logic is inlined into the kernels: a call that
// is not would take the Row, and with it the row's scalars, by address,
// into the thread's stack frame (ptxas -v shows it as a frame).
#ifdef __CUDACC__
#define DBT_RI __host__ __device__ __forceinline__
#else
#define DBT_RI inline
#endif

namespace dbt {

constexpr int N_SCALARS = 21;  // DeviceState's [G] fields, first in order

// the 8 peer arrays, in DeviceState's order (fields 21..28)
enum PeerArray {
  PA_ID = 0,
  PA_KIND,
  PA_MATCH,
  PA_NEXT,
  PA_RSTATE,
  PA_SNAP,
  PA_ACTIVE,
  PA_GRANTED
};

// i / n for 0 <= i and i * n < 2^32, with m = div_magic(n)
DBT_RI unsigned div_magic(int n) {
  return n <= 1 ? 0u
                : (unsigned)((0x100000000ull + (unsigned)n - 1) / (unsigned)n);
}
DBT_RI int div_by(int i, unsigned m) {
#ifdef __CUDA_ARCH__
  return m ? (int)__umulhi((unsigned)i, m) : i;
#else
  return m ? (int)(((unsigned long long)(unsigned)i * m) >> 32) : i;
#endif
}

struct StepArgs {
  const int* st_in[N_STATE];
  int* st_out[N_STATE];
  const int* ib[N_INBOX];
  int* out[N_OUT];
  int G, P, W, M, E, O;
  int R;          // rows (threads) a block
  int lgR;        // log2(R)
  int S;          // the tile's stride: R (G-last) or R + 1 (external)
  int K;          // outbox messages a row staged in the tile (<= O)
  unsigned mP, mW, mK;  // div_magic of P, W and K * N_FIELDS

  // first tile word of each array (state field 21 + f)
  DBT_RI int arr(int f) const { return f < 8 ? f * P : 8 * P + (f - 8) * W; }
  // first tile word of the staged outbox
  DBT_RI int t_buf() const { return 8 * P + 2 * W; }
  // the tile's words a row; the block's first-slot words follow at T * S
  DBT_RI int T() const { return t_buf() + K * N_FIELDS; }
};

DBT_RI void step_args_init(StepArgs& a, int G, int P, int W, int M, int E,
                           int O, int internal, int R, int K) {
  a.G = G;
  a.P = P;
  a.W = W;
  a.M = M;
  a.E = E;
  a.O = O;
  a.R = R;
  a.lgR = 0;
  while ((1 << a.lgR) < R) ++a.lgR;
  a.S = internal ? R : R + 1;
  a.K = K;
  a.mP = div_magic(P);
  a.mW = div_magic(W);
  a.mK = div_magic(K * N_FIELDS);
}

// Where row g's inbox and output elements sit in device memory: element
// k of an array with n elements a row at row_off(g, n, es) + k * es, es =
// row_stride(a): [G, n] rows are contiguous (es = 1), [n, G] rows are
// columns (es = G; G = 1 addresses the same words either way).
DBT_RI long long row_off(int g, int n, int es) {
  return (long long)g * (es == 1 ? n : 1);
}
template <bool GL>
DBT_RI int row_stride(const StepArgs& a) {
  return GL ? a.G : 1;
}

struct Msg {
  int mtype, from_id, term, log_term, log_index, commit, reject, hint,
      hint_high, n_entries;
  const int* ent_term;  // entry i at ent_term[i * es]
  const int* ent_cc;
  int es;
  DBT_RI int eterm(int i) const { return ent_term[(long long)i * es]; }
  DBT_RI int ecc(int i) const { return ent_cc[(long long)i * es]; }
};

DBT_RI uint32_t splitmix32(uint32_t x) {
  uint32_t z = x + 0x9E3779B9u;
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

DBT_RI bool is_hot(int mt) {
  switch (mt) {
    case MT_TICK:
    case MT_ELECTION:
    case MT_PROPOSE:
    case MT_READ_INDEX:
    case MT_REPLICATE:
    case MT_REPLICATE_RESP:
    case MT_REQUEST_VOTE:
    case MT_REQUEST_VOTE_RESP:
    case MT_REQUEST_PREVOTE:
    case MT_REQUEST_PREVOTE_RESP:
    case MT_HEARTBEAT:
    case MT_HEARTBEAT_RESP:
    case MT_TIMEOUT_NOW:
    case MT_CHECK_QUORUM:
    case MT_UNREACHABLE:
    case MT_SNAPSHOT_STATUS:
    case MT_SNAPSHOT_RECEIVED:
      return true;
    default:
      return false;
  }
}

// One row: its scalars by value, its arrays in its column of the tile.
// ROUTED: the routed round's row (`raft_step_kernel<true>`), which writes
// of its outputs only the messages, `count` and `escalate`.
template <bool ROUTED>
struct RowLogic {
  int shard_id, replica_id, self_slot, election_timeout, heartbeat_timeout,
      check_quorum, pre_vote;
  int term, vote, leader_id, role, committed, last_index, first_index,
      base_term, election_tick, heartbeat_tick, rand_timeout, timeout_seq,
      pending_cc, transfer_target;
  int P, W, M, E, O, S;
  // the row's column of the tile: element k of the array at tile word a
  // is tt[(a + k) * S]
  int* tt;
  int K, kb;  // messages 0 .. K-1 go to the tile from word kb on
  // the row's outputs in device memory (the outbox from message K on,
  // need_snapshot, slot_base, slot_term, ent_drop), addressed from the
  // kernel's arguments when written: element k of an output with n
  // elements a row at out[f] + row_off(g, n, es) + k * es
  const StepArgs* args;
  int g, es;
  // the step never writes peer_id or peer_kind: the row's peer slots
  // (bit p: peer_id[p] != 0), its voters (voter or witness) and what
  // follows from them are read once
  unsigned peers, voters;
  int n_voters, self_kind_, self_voter;
  // outputs
  int count, escalate, append_lo, barrier_idx, barrier_term;

  // -- the tile ------------------------------------------------------------
  DBT_RI int& el(int a, int k) const { return tt[(a + k) * S]; }
  DBT_RI int& pa(int f, int p) const { return el(f * P, p); }
  DBT_RI int& ring_term(int j) const { return el(8 * P, j); }
  DBT_RI int& ring_cc(int j) const { return el(8 * P + W, j); }
  DBT_RI int* out_row(int f, int n) const {
    return args->out[f] + row_off(g, n, es);
  }
  DBT_RI int& need_snapshot(int p) const {
    return out_row(3, P)[(long long)p * es];
  }
  DBT_RI int& slot_base(int s) const { return out_row(4, M)[(long long)s * es]; }
  DBT_RI int& slot_term(int s) const { return out_row(5, M)[(long long)s * es]; }
  DBT_RI int& ent_drop(int k) const {
    return out_row(6, M * E)[(long long)k * es];
  }

  // -- peer slots ---------------------------------------------------------
  DBT_RI bool in_p(int s) const { return s >= 0 && s < P; }
  DBT_RI int col(int f, int s) const { return in_p(s) ? pa(f, s) : 0; }
  DBT_RI void set_col(int f, int s, int v) {
    if (in_p(s)) pa(f, s) = v;
  }
  DBT_RI void read_peers() {
    peers = voters = 0;
    n_voters = 0;
    for (int p = 0; p < P; ++p) {
      const int id = pa(PA_ID, p), k = pa(PA_KIND, p);
      const bool v = id != 0 && (k == KIND_VOTER || k == KIND_WITNESS);
      peers |= (id != 0 ? 1u : 0u) << p;
      voters |= (v ? 1u : 0u) << p;
      n_voters += v ? 1 : 0;
    }
    self_kind_ = col(PA_KIND, self_slot);
    self_voter = col(PA_ID, self_slot) == replica_id && self_kind_ == KIND_VOTER;
  }
  DBT_RI bool valid(int p) const { return (peers >> p) & 1u; }
  DBT_RI bool is_voter(int p) const { return (voters >> p) & 1u; }
  DBT_RI int num_voters() const { return n_voters; }
  DBT_RI int quorum() const { return n_voters / 2 + 1; }
  DBT_RI int self_kind() const { return self_kind_; }
  DBT_RI bool self_is_voter() const { return self_voter != 0; }
  DBT_RI int slot_of(int pid, bool* found) const {
    if (pid != 0) {
      for (int p = 0; p < P; ++p) {
        if (pa(PA_ID, p) == pid) {
          *found = true;
          return p;
        }
      }
    }
    *found = false;
    return 0;
  }

  // -- log-term ring ------------------------------------------------------
  DBT_RI int win_lo() const { return imax(first_index, wsub(last_index, W - 1)); }
  DBT_RI int ring_pos(int idx) const { return (idx < 0 ? 0 : idx) & (W - 1); }
  DBT_RI int log_term(int idx, bool* known, bool* esc) const {
    bool zero = idx == 0;
    bool boundary = idx == wsub(first_index, 1);
    bool in_win = idx >= win_lo() && idx <= last_index;
    bool beyond = idx > last_index;
    int t = zero ? 0 : (boundary ? base_term : ring_term(ring_pos(idx)));
    *known = zero || boundary || in_win;
    *esc = !*known && !beyond;
    return t;
  }
  DBT_RI bool match_term(int idx, int t, bool* esc) const {
    bool known;
    int lt = log_term(idx, &known, esc);
    return known && lt == t;
  }
  DBT_RI int last_term(bool* esc) const {
    bool known;
    return log_term(last_index, &known, esc);
  }
  DBT_RI void ring_write(int idx, int t, int cc) {
    int p = ring_pos(idx);
    ring_term(p) = t;
    ring_cc(p) = cc;
  }
  DBT_RI bool pending_cc_any() const {
    int lo = win_lo();
    for (int j = 0; j < W; ++j) {
      int cand = wadd(lo, (int)((uint32_t)wsub(j, lo) & (uint32_t)(W - 1)));
      if (cand > committed && cand <= last_index && ring_cc(j) == 1) return true;
    }
    return false;
  }

  // -- outbox ---------------------------------------------------------------
  // one message's fields at w[f * s]
  template <typename Stride>
  DBT_RI static void put_msg(int* w, Stride s, int mtype, int to, int t,
                             int log_term_, int log_index, int commit,
                             int reject, int hint, int hint_high,
                             int n_entries, int src_slot) {
    w[F_MTYPE * s] = mtype;
    w[F_TO * s] = to;
    w[F_TERM * s] = t;
    w[F_LOG_TERM * s] = log_term_;
    w[F_LOG_INDEX * s] = log_index;
    w[F_COMMIT * s] = commit;
    w[F_REJECT * s] = reject;
    w[F_HINT * s] = hint;
    w[F_HINT_HIGH * s] = hint_high;
    w[F_N_ENTRIES * s] = n_entries;
    w[F_SRC_SLOT * s] = src_slot;
  }
  DBT_RI void emit(int mtype, int to, int t, int log_term_, int log_index,
                   int commit, int reject, int hint, int hint_high,
                   int n_entries, int src_slot) {
    if (count >= O) {
      escalate |= ESC_OVERFLOW;
      return;
    }
    if (count < K)
      put_msg(&el(kb + count * N_FIELDS, 0), S, mtype, to, t, log_term_,
              log_index, commit, reject, hint, hint_high, n_entries,
              src_slot);
    else
      put_msg(out_row(0, O * N_FIELDS) + (long long)count * N_FIELDS * es,
              (long long)es, mtype,
              to, t, log_term_, log_index, commit, reject, hint, hint_high,
              n_entries, src_slot);
    ++count;
  }

  // -- role transitions -----------------------------------------------------
  DBT_RI int jitter(int seq) const {
    uint32_t h = splitmix32(((uint32_t)shard_id << 24) ^
                            ((uint32_t)replica_id << 8) ^ (uint32_t)seq);
    uint32_t span = (uint32_t)election_timeout;
    return (int)(span ? h % span : h);
  }
  DBT_RI void reset_timeout() {
    int seq = wadd(timeout_seq, 1);
    rand_timeout = wadd(election_timeout, jitter(seq));
    timeout_seq = seq;
  }
  DBT_RI void reset(int new_term) {
    if (term != new_term) vote = 0;
    term = new_term;
    leader_id = 0;
    election_tick = 0;
    heartbeat_tick = 0;
    for (int p = 0; p < P; ++p) pa(PA_GRANTED, p) = 0;
    transfer_target = 0;
    pending_cc = 0;
    reset_timeout();
    for (int p = 0; p < P; ++p) {
      if (!valid(p)) continue;
      pa(PA_MATCH, p) = p == self_slot ? last_index : 0;
      pa(PA_NEXT, p) = wadd(last_index, 1);
      pa(PA_RSTATE, p) = RS_RETRY;
      pa(PA_SNAP, p) = 0;
    }
  }
  DBT_RI void become_follower(int new_term, int leader) {
    int sk = self_kind();
    role = sk == KIND_NON_VOTING ? ROLE_NON_VOTING
           : sk == KIND_WITNESS  ? ROLE_WITNESS
                                 : ROLE_FOLLOWER;
    reset(new_term);
    leader_id = leader;
  }
  DBT_RI void become_pre_candidate() {
    role = ROLE_PRE_CANDIDATE;
    for (int p = 0; p < P; ++p) pa(PA_GRANTED, p) = 0;
    leader_id = 0;
    election_tick = 0;
    reset_timeout();
  }
  DBT_RI void grant_self() { set_col(PA_GRANTED, self_slot, 1); }
  DBT_RI void become_candidate() {
    role = ROLE_CANDIDATE;
    reset(wadd(term, 1));
    vote = replica_id;
    grant_self();
  }
  DBT_RI bool votes_at_least_quorum(int want) const {
    int n = 0;
    for (int p = 0; p < P; ++p) n += (is_voter(p) && pa(PA_GRANTED, p) == want) ? 1 : 0;
    return n >= quorum();
  }
  DBT_RI bool vote_quorum() const { return votes_at_least_quorum(1); }
  DBT_RI bool vote_rejected() const { return votes_at_least_quorum(2); }

  DBT_RI void append_one(int cc) {
    int new_last = wadd(last_index, 1);
    append_lo = imin(append_lo, new_last);
    ring_write(new_last, term, cc);
    last_index = new_last;
    int sm = col(PA_MATCH, self_slot);
    int sn = col(PA_NEXT, self_slot);
    set_col(PA_MATCH, self_slot, imax(sm, new_last));
    set_col(PA_NEXT, self_slot, imax(sn, wadd(new_last, 1)));
  }

  // The reference sorts v_p (match of a voter, -1 otherwise) ascending and
  // takes s[P - quorum] (0 when that is out of range): the quorum-th
  // largest value, which is the largest v_p that at least quorum of the
  // values reach.  Counted here, with no array.
  DBT_RI int quorum_index() const {
    const int q = quorum();
    const int k = P - q;
    if (k < 0 || k >= P) return 0;
    int best = 0;
    bool found = false;
    for (int p = 0; p < P; ++p) {
      const int v = (voters >> p & 1u) ? pa(PA_MATCH, p) : -1;
      if (found && v <= best) continue;
      int n = 0;
      for (int j = 0; j < P; ++j) {
        const int u = (voters >> j & 1u) ? pa(PA_MATCH, j) : -1;
        n += u >= v ? 1 : 0;
      }
      if (n >= q) {
        best = v;
        found = true;
      }
    }
    return best;
  }

  // quorum index + current-term-only gate; true when it advanced
  DBT_RI bool try_commit() {
    const int qidx = quorum_index();
    if (!(qidx > committed)) return false;
    bool esc;
    bool ok = match_term(qidx, term, &esc);
    if (esc) escalate |= ESC_WINDOW;
    if (!ok) return false;
    committed = qidx;
    return true;
  }

  // -- replicate / heartbeat sending --------------------------------------
  DBT_RI void send_replicate(int slot) {
    int rs = col(PA_RSTATE, slot);
    int nxt = col(PA_NEXT, slot);
    int to = col(PA_ID, slot);
    if (rs == RS_WAIT || rs == RS_SNAPSHOT || to == 0) return;
    int prev = wsub(nxt, 1);
    if (prev < wsub(first_index, 1)) {
      // compacted below the resolvable boundary -> snapshot path
      if constexpr (!ROUTED)
        if (in_p(slot)) need_snapshot(slot) = 1;
      set_col(PA_RSTATE, slot, RS_WAIT);
      return;
    }
    bool known, esc;
    int pt = log_term(prev, &known, &esc);
    int n = wsub(last_index, prev);
    n = n < 0 ? 0 : (n > E ? E : n);
    // below-ring prev: log_term 0 is the host-fixup marker
    emit(MT_REPLICATE, to, term, known ? pt : 0, prev, committed, 0, 0, 0, n,
         -1);
    if (n > 0) {
      int last_sent = wadd(prev, n);
      if (rs == RS_REPLICATE) set_col(PA_NEXT, slot, wadd(last_sent, 1));
      if (rs == RS_RETRY) set_col(PA_RSTATE, slot, RS_WAIT);
    }
  }
  DBT_RI void broadcast_replicate() {
    for (int p = 0; p < P; ++p)
      if (valid(p) && self_slot != p) send_replicate(p);
  }
  DBT_RI void broadcast_heartbeat(int hint, int hint_high) {
    for (int p = 0; p < P; ++p) {
      if (!valid(p) || self_slot == p) continue;
      emit(MT_HEARTBEAT, pa(PA_ID, p), term, 0, committed,
           imin(pa(PA_MATCH, p), committed), 0, hint, hint_high, 0, -1);
    }
  }

  DBT_RI void become_leader() {
    role = ROLE_LEADER;
    reset(term);
    leader_id = replica_id;
    for (int p = 0; p < P; ++p)
      if (valid(p)) pa(PA_ACTIVE, p) = 1;
    if (wadd(committed, 1) < win_lo() && committed < last_index)
      escalate |= ESC_WINDOW;
    pending_cc = pending_cc_any() ? 1 : 0;
    append_one(0);  // commit barrier
    barrier_idx = last_index;
    barrier_term = term;
    if (num_voters() == 1 && self_is_voter()) try_commit();
  }

  DBT_RI void campaign(bool pre, bool transfer) {
    if (pre) {
      become_pre_candidate();
      grant_self();
      if (!vote_quorum()) {
        bool esc;
        int lt = last_term(&esc);
        if (esc) escalate |= ESC_WINDOW;
        for (int p = 0; p < P; ++p) {
          if (!is_voter(p) || self_slot == p) continue;
          emit(MT_REQUEST_PREVOTE, pa(PA_ID, p), wadd(term, 1), lt, last_index,
               0, 0, 0, 0, 0, -1);
        }
        return;
      }
      // single-voter shortcut: straight into the real leg
    }
    become_candidate();
    if (vote_quorum()) {
      become_leader();
      return;
    }
    bool esc;
    int lt = last_term(&esc);
    if (esc) escalate |= ESC_WINDOW;
    int hint = transfer ? replica_id : 0;
    for (int p = 0; p < P; ++p) {
      if (!is_voter(p) || self_slot == p) continue;
      emit(MT_REQUEST_VOTE, pa(PA_ID, p), term, lt, last_index, 0, 0, hint, 0,
           0, -1);
    }
  }

  DBT_RI void handle_election(int hint) {
    if (role == ROLE_LEADER || role == ROLE_NON_VOTING ||
        role == ROLE_WITNESS || !self_is_voter())
      return;
    bool transfer = hint == replica_id;
    campaign(pre_vote == 1 && !transfer, transfer);
  }

  DBT_RI void check_quorum_now() {
    int cnt = 1;
    for (int p = 0; p < P; ++p)
      if (is_voter(p) && p != self_slot && pa(PA_ACTIVE, p) == 1) ++cnt;
    for (int p = 0; p < P; ++p)
      if (is_voter(p)) pa(PA_ACTIVE, p) = 0;
    if (cnt < quorum()) become_follower(term, 0);
  }

  DBT_RI void tick(int n, int hint, int hint_high) {
    if (role == ROLE_LEADER) {
      int el_ = wadd(election_tick, n);
      int hb = wadd(heartbeat_tick, n);
      bool fired = el_ >= election_timeout;
      election_tick = fired ? 0 : el_;
      heartbeat_tick = hb;
      if (fired && check_quorum == 1) check_quorum_now();
      if (role != ROLE_LEADER) return;
      if (fired) transfer_target = 0;
      if (heartbeat_tick >= heartbeat_timeout) {
        heartbeat_tick = 0;
        broadcast_heartbeat(hint, hint_high);
      }
      return;
    }
    int el2 = wadd(election_tick, n);
    bool time_up = el2 >= rand_timeout;
    bool nvw = role == ROLE_NON_VOTING || role == ROLE_WITNESS;
    election_tick = el2;
    if (nvw && check_quorum == 1 && time_up) {
      election_tick = 0;
      reset_timeout();
    }
    if (!nvw && time_up) {
      election_tick = 0;
      handle_election(0);
    }
  }

  // -- message-term gate ------------------------------------------------------
  DBT_RI bool on_message_term(const Msg& m) {
    int mt = m.mtype;
    bool local = m.term == 0;
    bool higher = !local && m.term > term;
    bool lower = !local && m.term < term;
    bool vote_like = mt == MT_REQUEST_VOTE || mt == MT_REQUEST_PREVOTE;
    bool in_lease = check_quorum == 1 && leader_id != 0 &&
                    election_tick < election_timeout;
    bool drop_lease = higher && vote_like && in_lease && m.hint == 0;
    bool leader_msg = mt == MT_REPLICATE || mt == MT_INSTALL_SNAPSHOT ||
                      mt == MT_HEARTBEAT || mt == MT_TIMEOUT_NOW ||
                      mt == MT_READ_INDEX_RESP;
    bool keep_term = mt == MT_REQUEST_PREVOTE ||
                     (mt == MT_REQUEST_PREVOTE_RESP && m.reject == 0);
    if (higher && !drop_lease && !keep_term)
      become_follower(m.term, leader_msg ? m.from_id : 0);
    bool poke = lower &&
                (mt == MT_REPLICATE || mt == MT_HEARTBEAT ||
                 mt == MT_INSTALL_SNAPSHOT) &&
                (check_quorum == 1 || pre_vote == 1);
    if (poke) emit(MT_REPLICATE_RESP, m.from_id, term, 0, 0, 0, 0, 0, 0, 0, -1);
    if (lower && mt == MT_REQUEST_PREVOTE)
      emit(MT_REQUEST_PREVOTE_RESP, m.from_id, term, 0, 0, 0, 1, 0, 0, 0, -1);
    return local || m.term == term || (higher && !drop_lease);
  }

  // -- votes ------------------------------------------------------------------
  DBT_RI bool up_to_date(const Msg& m) {
    bool esc;
    int lt = last_term(&esc);
    if (esc) escalate |= ESC_WINDOW;
    return m.log_term > lt || (m.log_term == lt && m.log_index >= last_index);
  }
  DBT_RI void handle_request_vote(const Msg& m) {
    if (role == ROLE_NON_VOTING) return;
    bool utd = up_to_date(m);
    bool grant = (vote == 0 || vote == m.from_id) && utd;
    if (grant) {
      election_tick = 0;
      vote = m.from_id;
    }
    emit(MT_REQUEST_VOTE_RESP, m.from_id, term, 0, 0, 0, grant ? 0 : 1, 0, 0,
         0, -1);
  }
  DBT_RI void handle_request_prevote(const Msg& m) {
    if (role == ROLE_NON_VOTING) return;
    bool utd = up_to_date(m);
    bool grant = utd && (m.term > term || vote == 0 || vote == m.from_id);
    emit(MT_REQUEST_PREVOTE_RESP, m.from_id, grant ? m.term : term, 0, 0, 0,
         grant ? 0 : 1, 0, 0, 0, -1);
  }

  // -- follower side ------------------------------------------------------------
  DBT_RI void handle_replicate(const Msg& m) {
    if (m.log_index < committed) {
      emit(MT_REPLICATE_RESP, m.from_id, term, 0, committed, 0, 0, 0, 0, 0, -1);
      return;
    }
    bool esc;
    bool prev_ok = match_term(m.log_index, m.log_term, &esc);
    if (esc) escalate |= ESC_WINDOW;
    if (!prev_ok) {
      emit(MT_REPLICATE_RESP, m.from_id, term, 0, m.log_index, 0, 1,
           last_index, 0, 0, -1);
      return;
    }
    int n = m.n_entries;
    int last_new = wadd(m.log_index, n);
    // conflict scan: first carried entry whose (index, term) mismatches
    int conflict_off = E + 1;
    bool conflict_esc = false;
    for (int i = 0; i < E && i < n; ++i) {
      bool e_esc;
      if (!match_term(wadd(m.log_index, 1 + i), m.eterm(i), &e_esc)) {
        conflict_off = i;
        conflict_esc = e_esc;
        break;
      }
    }
    int idx_at_conf = wadd(wadd(m.log_index, 1), conflict_off);
    // a conflict beyond last_index is an append, not an escalation
    if (conflict_esc && idx_at_conf <= last_index) escalate |= ESC_WINDOW;
    bool has_conflict = conflict_off <= E;
    if (has_conflict) {
      // invariant: a conflict must be above commit
      if (idx_at_conf <= committed) escalate |= ESC_INVARIANT;
      append_lo = imin(append_lo, idx_at_conf);
      for (int i = conflict_off; i < E && i < n; ++i)
        ring_write(wadd(m.log_index, 1 + i), m.eterm(i), m.ecc(i));
      last_index = last_new;
    }
    committed = imax(committed, imin(m.commit, last_new));
    emit(MT_REPLICATE_RESP, m.from_id, term, 0, last_new, 0, 0, 0, 0, 0, -1);
  }
  DBT_RI void handle_heartbeat(const Msg& m) {
    committed = imax(committed, imin(m.commit, last_index));
    emit(MT_HEARTBEAT_RESP, m.from_id, term, 0, 0, 0, 0, m.hint, m.hint_high,
         0, -1);
  }

  // -- leader side --------------------------------------------------------------
  DBT_RI void handle_replicate_resp(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (!found) return;
    set_col(PA_ACTIVE, slot, 1);
    int rs = col(PA_RSTATE, slot);
    int mt0 = col(PA_MATCH, slot);
    int nxt = col(PA_NEXT, slot);
    int snap = col(PA_SNAP, slot);
    int li = m.log_index;
    bool rej = m.reject == 1;
    // decrease (oracle: remote.decrease)
    bool repl = rs == RS_REPLICATE;
    bool do_r = rej && repl && li > mt0;
    if (do_r) {
      set_col(PA_NEXT, slot, wadd(mt0, 1));
      set_col(PA_SNAP, slot, 0);
      set_col(PA_RSTATE, slot, RS_RETRY);
    }
    bool do_nr = rej && !repl && wsub(nxt, 1) == li;
    if (do_nr) {
      int dec = imax(imax(imin(li, wadd(m.hint, 1)), wadd(mt0, 1)), 1);
      set_col(PA_NEXT, slot, dec);
      if (rs == RS_WAIT) set_col(PA_RSTATE, slot, RS_RETRY);
    }
    if (do_r || do_nr) send_replicate(slot);
    // ack
    bool ack = m.reject == 0;
    bool paused = rs == RS_WAIT || rs == RS_SNAPSHOT;
    bool advanced = ack && mt0 < li;
    int new_match = imax(mt0, li);
    int new_next = imax(nxt, wadd(li, 1));
    if (advanced) set_col(PA_MATCH, slot, new_match);
    if (ack) set_col(PA_NEXT, slot, new_next);
    if (advanced && rs == RS_WAIT) set_col(PA_RSTATE, slot, RS_RETRY);
    if (advanced && col(PA_RSTATE, slot) == RS_SNAPSHOT && new_match >= snap) {
      set_col(PA_NEXT, slot, imax(wadd(new_match, 1), wadd(snap, 1)));
      set_col(PA_SNAP, slot, 0);
      set_col(PA_RSTATE, slot, RS_RETRY);
    }
    if (advanced && col(PA_RSTATE, slot) == RS_RETRY) {
      set_col(PA_NEXT, slot, wadd(new_match, 1));
      set_col(PA_SNAP, slot, 0);
      set_col(PA_RSTATE, slot, RS_REPLICATE);
    }
    bool cadv = advanced && try_commit();
    if (cadv) broadcast_replicate();
    if (advanced && !cadv && paused) send_replicate(slot);
    // leader transfer: target caught up -> TIMEOUT_NOW
    if (advanced && transfer_target == m.from_id && last_index == new_match)
      emit(MT_TIMEOUT_NOW, m.from_id, term, 0, 0, 0, 0, 0, 0, 0, -1);
    // stale ack while streaming a snapshot that has completed
    int rs4 = col(PA_RSTATE, slot);
    int m4 = col(PA_MATCH, slot);
    int s4 = col(PA_SNAP, slot);
    if (ack && !advanced && rs4 == RS_SNAPSHOT && m4 >= s4) {
      set_col(PA_NEXT, slot, imax(wadd(m4, 1), wadd(s4, 1)));
      set_col(PA_SNAP, slot, 0);
      set_col(PA_RSTATE, slot, RS_RETRY);
    }
  }

  DBT_RI void handle_heartbeat_resp(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (!found) return;
    set_col(PA_ACTIVE, slot, 1);
    if (col(PA_RSTATE, slot) == RS_WAIT) set_col(PA_RSTATE, slot, RS_RETRY);
    if (col(PA_MATCH, slot) < last_index) send_replicate(slot);
    // read-index ctx echo to the host (voting members only)
    int kind = col(PA_KIND, slot);
    bool voter = kind == KIND_VOTER || kind == KIND_WITNESS;
    if (voter && (m.hint != 0 || m.hint_high != 0))
      emit(MT_READ_INDEX_RESP, replica_id, term, 0, m.from_id, 0, 0, m.hint,
           m.hint_high, 0, -1);
  }

  DBT_RI void handle_read_index(const Msg& m) {
    if (!(role == ROLE_LEADER && self_kind() != KIND_WITNESS)) {
      emit(MT_READ_INDEX_RESP, replica_id, term, 0, 0, 0, 1, m.hint,
           m.hint_high, 0, -1);
      return;
    }
    bool esc;
    bool ok = match_term(committed, term, &esc);
    if (esc) escalate |= ESC_WINDOW;
    if (!ok && !esc)
      emit(MT_READ_INDEX_RESP, replica_id, term, 0, 0, 0, 1, m.hint,
           m.hint_high, 0, -1);
    if (ok) {
      emit(MT_READ_INDEX_RESP, replica_id, term, 0, 0, committed, 0, m.hint,
           m.hint_high, 0, -1);
      if (num_voters() > 1) broadcast_heartbeat(m.hint, m.hint_high);
    }
  }

  DBT_RI void handle_unreachable(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (!found || col(PA_RSTATE, slot) != RS_REPLICATE) return;
    set_col(PA_NEXT, slot, wadd(col(PA_MATCH, slot), 1));
    set_col(PA_SNAP, slot, 0);
    set_col(PA_RSTATE, slot, RS_RETRY);
  }

  DBT_RI void handle_snapshot_status(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (!found || col(PA_RSTATE, slot) != RS_SNAPSHOT) return;
    int snap = m.reject == 1 ? 0 : col(PA_SNAP, slot);
    set_col(PA_NEXT, slot, imax(wadd(col(PA_MATCH, slot), 1), wadd(snap, 1)));
    set_col(PA_SNAP, slot, 0);
    set_col(PA_RSTATE, slot, RS_WAIT);
  }

  DBT_RI void handle_propose(const Msg& m, int slot_i) {
    bool lead = role == ROLE_LEADER;
    int n = m.n_entries;
    bool transferring = transfer_target != 0;
    bool drop_all = lead && transferring;
    bool accept = lead && !transferring;
    int base = last_index;
    bool appended_any = false;
    if (accept) {
      for (int i = 0; i < E && i < n; ++i) {
        bool is_cc = m.ecc(i) == 1;
        if (is_cc && pending_cc == 1) {
          // config-change gate
          if constexpr (!ROUTED) ent_drop(slot_i * E + i) = 1;
          continue;
        }
        if (is_cc) pending_cc = 1;
        append_one(is_cc ? 1 : 0);
        appended_any = true;
      }
    }
    if (appended_any && num_voters() == 1 && self_is_voter()) try_commit();
    if (appended_any) broadcast_replicate();
    // the routed step has no slot outputs, so reads and writes none
    int sb = 0, stm = 0;
    if constexpr (!ROUTED) {
      sb = accept ? base : (drop_all ? SLOT_DROPPED : slot_base(slot_i));
      stm = accept ? term : slot_term(slot_i);
    }
    bool foll = role == ROLE_FOLLOWER || role == ROLE_NON_VOTING ||
                role == ROLE_WITNESS;
    if (foll && leader_id != 0) {
      emit(MT_PROPOSE, leader_id, term, 0, 0, 0, 0, 0, 0, n, slot_i);
      sb = SLOT_FORWARDED;
    }
    if ((foll && leader_id == 0) || role == ROLE_CANDIDATE ||
        role == ROLE_PRE_CANDIDATE)
      sb = SLOT_DROPPED;
    if constexpr (!ROUTED) {
      slot_base(slot_i) = sb;
      slot_term(slot_i) = stm;
    }
  }

  // -- candidate / follower blocks ------------------------------------------
  DBT_RI void record_vote(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (found) set_col(PA_GRANTED, slot, m.reject == 1 ? 2 : 1);
  }
  DBT_RI void candidate_block(const Msg& m) {
    int mt = m.mtype;
    if (!(role == ROLE_CANDIDATE || role == ROLE_PRE_CANDIDATE)) return;
    if (mt == MT_REPLICATE || mt == MT_HEARTBEAT) {
      become_follower(term, m.from_id);
    } else if (mt == MT_REQUEST_VOTE_RESP && role == ROLE_CANDIDATE) {
      record_vote(m);
      if (vote_quorum()) {
        become_leader();
        broadcast_replicate();
      } else if (vote_rejected()) {
        become_follower(term, 0);
      }
    } else if (mt == MT_REQUEST_PREVOTE_RESP && role == ROLE_PRE_CANDIDATE) {
      record_vote(m);
      if (vote_quorum()) {
        campaign(false, false);
      } else if (vote_rejected()) {
        become_follower(term, 0);
      }
    }
  }
  DBT_RI void follower_block(const Msg& m) {
    int mt = m.mtype;
    if (!(role == ROLE_FOLLOWER || role == ROLE_NON_VOTING ||
          role == ROLE_WITNESS))
      return;
    if (mt == MT_REPLICATE || mt == MT_HEARTBEAT) {
      election_tick = 0;
      leader_id = m.from_id;
      if (mt == MT_REPLICATE)
        handle_replicate(m);
      else
        handle_heartbeat(m);
    } else if (mt == MT_TIMEOUT_NOW && role == ROLE_FOLLOWER &&
               self_is_voter()) {
      campaign(false, true);
    }
  }

  // one inbox slot (oracle: Raft.handle + _step)
  DBT_RI void process_slot(const Msg& m, int slot_i) {
    int mt = m.mtype;
    if (!is_hot(mt)) {
      escalate |= ESC_COLD;
      return;
    }
    if (mt == MT_TICK) {
      tick(imax(m.log_index, 1), m.hint, m.hint_high);
      return;
    }
    if (!on_message_term(m)) return;
    bool lead = role == ROLE_LEADER;
    switch (mt) {
      case MT_ELECTION:
        handle_election(m.hint);
        break;
      case MT_REQUEST_VOTE:
        handle_request_vote(m);
        break;
      case MT_REQUEST_PREVOTE:
        handle_request_prevote(m);
        break;
      case MT_PROPOSE:
        handle_propose(m, slot_i);
        break;
      case MT_READ_INDEX:
        handle_read_index(m);
        break;
      case MT_CHECK_QUORUM:
        if (lead) check_quorum_now();
        break;
      case MT_UNREACHABLE:
        if (lead) handle_unreachable(m);
        break;
      case MT_SNAPSHOT_STATUS:
      case MT_SNAPSHOT_RECEIVED:
        if (lead) handle_snapshot_status(m);
        break;
      case MT_REPLICATE_RESP:
        if (lead) handle_replicate_resp(m);
        break;
      case MT_HEARTBEAT_RESP:
        if (lead) handle_heartbeat_resp(m);
        break;
      case MT_REQUEST_VOTE_RESP:
      case MT_REQUEST_PREVOTE_RESP:
        candidate_block(m);
        break;
      case MT_REPLICATE:
      case MT_HEARTBEAT:
        candidate_block(m);
        follower_block(m);
        break;
      case MT_TIMEOUT_NOW:
        follower_block(m);
        break;
      default:
        break;
    }
  }
};

// the full step's row, whose outputs are DeviceOut's every field
using Row = RowLogic<false>;

// The row logic of row g, the block's row t: layout-blind, given the
// element stride es of its inbox and outputs (element k of an array with
// n elements a row at g * n + k in the external layout, es = 1, and at
// g + k * G in the G-last one, es = G).  The routed row leaves its count
// in the tile's word of the row for phase 4.
template <bool ROUTED>
DBT_RI void step_row(const StepArgs& a, int* tile, int g, int t, int es) {
  const long long ib0 = row_off(g, a.M, es);
  const long long e0 = row_off(g, a.M * a.E, es);
  RowLogic<ROUTED> r;
  const int* const* si = a.st_in;
  r.shard_id = si[0][g];
  r.replica_id = si[1][g];
  r.self_slot = si[2][g];
  r.election_timeout = si[3][g];
  r.heartbeat_timeout = si[4][g];
  r.check_quorum = si[5][g];
  r.pre_vote = si[6][g];
  r.term = si[7][g];
  r.vote = si[8][g];
  r.leader_id = si[9][g];
  r.role = si[10][g];
  r.committed = si[11][g];
  r.last_index = si[12][g];
  r.first_index = si[13][g];
  r.base_term = si[14][g];
  r.election_tick = si[15][g];
  r.heartbeat_tick = si[16][g];
  r.rand_timeout = si[17][g];
  r.timeout_seq = si[18][g];
  r.pending_cc = si[19][g];
  r.transfer_target = si[20][g];
  r.P = a.P;
  r.W = a.W;
  r.M = a.M;
  r.E = a.E;
  r.O = a.O;
  r.S = a.S;
  r.tt = tile + t;
  r.K = a.K;
  r.kb = a.t_buf();
  r.args = &a;
  r.g = g;
  r.es = es;
  r.count = 0;
  r.escalate = 0;
  r.append_lo = APPEND_LO_NONE;
  r.barrier_idx = -1;
  r.barrier_term = 0;
  r.read_peers();
  // the row's inbox slots, in order; empty slots are no-ops and an
  // escalated row handles nothing more
  const long long es_slot = (long long)a.E * es;
  for (int s = 0; s < a.M && r.escalate == 0; ++s) {
    const long long off = ib0 + (long long)s * es;
    const int mt = a.ib[0][off];
    if (mt == 0) continue;
    Msg m;
    m.mtype = mt;
    m.log_index = a.ib[4][off];
    m.hint = a.ib[7][off];
    m.hint_high = a.ib[8][off];
    if (mt != MT_TICK) {  // a tick reads no other word
      m.from_id = a.ib[1][off];
      m.term = a.ib[2][off];
      m.log_term = a.ib[3][off];
      m.commit = a.ib[5][off];
      m.reject = a.ib[6][off];
      m.n_entries = a.ib[9][off];
    }
    m.ent_term = a.ib[10] + e0 + s * es_slot;
    m.ent_cc = a.ib[11] + e0 + s * es_slot;
    m.es = es;
    r.process_slot(m, s);
  }
  int* const* so = a.st_out;
  so[0][g] = r.shard_id;
  so[1][g] = r.replica_id;
  so[2][g] = r.self_slot;
  so[3][g] = r.election_timeout;
  so[4][g] = r.heartbeat_timeout;
  so[5][g] = r.check_quorum;
  so[6][g] = r.pre_vote;
  so[7][g] = r.term;
  so[8][g] = r.vote;
  so[9][g] = r.leader_id;
  so[10][g] = r.role;
  so[11][g] = r.committed;
  so[12][g] = r.last_index;
  so[13][g] = r.first_index;
  so[14][g] = r.base_term;
  so[15][g] = r.election_tick;
  so[16][g] = r.heartbeat_tick;
  so[17][g] = r.rand_timeout;
  so[18][g] = r.timeout_seq;
  so[19][g] = r.pending_cc;
  so[20][g] = r.transfer_target;
  a.out[1][g] = r.count;
  a.out[2][g] = r.escalate;
  if constexpr (ROUTED) {
    tile[a.T() * a.S + t] = r.count;
  } else {
    a.out[7][g] = r.append_lo;
    a.out[8][g] = r.barrier_idx;
    a.out[9][g] = r.barrier_term;
  }
}

// ---------------------------------------------------------------------------
// the block's phases; thread t's share of each
// ---------------------------------------------------------------------------
// cp.async copies into shared memory on the card (4 bytes, or 16 from a
// 16-byte aligned address to one), wait_all before the barrier; plain
// copies on the host
DBT_RI void async4(int* sdst, const int* gsrc) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gsrc)
               : "memory");
#else
  *sdst = *gsrc;
#endif
}
DBT_RI void async16(int* sdst, const int* gsrc) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gsrc)
               : "memory");
#else
  for (int i = 0; i < 4; ++i) sdst[i] = gsrc[i];
#endif
}
DBT_RI void async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}
// 16 bytes from shared memory to device memory, both 16-byte aligned
DBT_RI void copy16(int* dst, const int* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

DBT_RI bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

// The block's rows of a per-row array of n elements into the tile from
// word b on.  m = div_magic(n).
template <bool GL>
DBT_RI void copy_in(const StepArgs& a, int* tile, const int* src, int b,
                    int n, unsigned m, int g0, int n_rows, int t) {
  const int S = a.S;
  if (!GL) {
    // one contiguous slab of n_rows * n words, read linearly
    const int* s = src + (long long)g0 * n;
    const int total = n_rows * n;
    for (int i = t; i < total; i += a.R) {
      const int r = div_by(i, m);
      async4(tile + (b + i - r * n) * S + r, s + i);
    }
  } else if ((a.G & 3) == 0 && aligned16(src)) {
    // n runs of n_rows words (a multiple of 4), 16 bytes a copy
    const int qs = a.lgR - 2;
    const int nq = n << qs;
    for (int i = t; i < nq; i += a.R) {
      const int k = i >> qs, j = (i & ((1 << qs) - 1)) << 2;
      if (j < n_rows)
        async16(tile + (b + k) * S + j, src + (long long)k * a.G + g0 + j);
    }
  } else if (t < n_rows) {
    for (int k = 0; k < n; ++k)
      async4(tile + (b + k) * S + t, src + (long long)k * a.G + g0 + t);
  }
}

// The tile's words b .. b + n - 1 of the block's rows out to the first n
// elements of dst's rows of rs elements (external layout; rs = n but for
// the staged outbox).
template <bool GL>
DBT_RI void copy_out(const StepArgs& a, const int* tile, int* dst, int b,
                     int n, unsigned m, int g0, int n_rows, int t,
                     int rs = 0) {
  const int S = a.S;
  if (!GL) {
    rs = rs ? rs : n;
    int* d = dst + (long long)g0 * rs;
    const int total = n_rows * n;
    for (int i = t; i < total; i += a.R) {
      const int r = div_by(i, m), k = i - r * n;
      d[(long long)r * rs + k] = tile[(b + k) * S + r];
    }
  } else if ((a.G & 3) == 0 && aligned16(dst)) {
    const int qs = a.lgR - 2;
    const int nq = n << qs;
    for (int i = t; i < nq; i += a.R) {
      const int k = i >> qs, j = (i & ((1 << qs) - 1)) << 2;
      if (j < n_rows)
        copy16(dst + (long long)k * a.G + g0 + j, tile + (b + k) * S + j);
    }
  } else if (t < n_rows) {
    for (int k = 0; k < n; ++k)
      dst[(long long)k * a.G + g0 + t] = tile[(b + k) * S + t];
  }
}

DBT_RI int block_rows(const StepArgs& a, int blk) {
  return imin(a.R, a.G - blk * a.R);
}

// Phase 1: the peer and ring arrays into the tile (asynchronous copies on
// the card: wait for them before the barrier); the row's first occupied
// inbox slot and its staged messages' fill (not in the routed step, which
// stores only the messages its rows emit).
template <bool GL, bool ROUTED = false>
DBT_RI void step_load(const StepArgs& a, int* tile, int blk, int t) {
  const int g0 = blk * a.R, n_rows = block_rows(a, blk);
  for (int f = 0; f < 10; ++f)
    copy_in<GL>(a, tile, a.st_in[N_SCALARS + f], a.arr(f), f < 8 ? a.P : a.W,
                f < 8 ? a.mP : a.mW, g0, n_rows, t);
  if constexpr (ROUTED) return;
  if (t >= n_rows) return;
  const int es = row_stride<GL>(a);
  const long long ib0 = row_off(g0 + t, a.M, es);
  int first = 0;
  for (int s = 0; s < a.M; ++s) {
    if (a.ib[0][ib0 + (long long)s * es] != 0) {
      first = s;
      break;
    }
  }
  tile[a.T() * a.S + t] = first;
  int* tt = tile + t;
  for (int k = 0; k < a.K * N_FIELDS; ++k)
    tt[(a.t_buf() + k) * a.S] = k % N_FIELDS == F_SRC_SLOT ? first : 0;
}

// The block's rows of an output of n elements a row, all set to v.
template <bool GL>
DBT_RI void fill_out(const StepArgs& a, int* dst, int n, int v, int g0,
                     int n_rows, int t) {
  if (!GL) {
    int* d = dst + (long long)g0 * n;
    for (int i = t; i < n_rows * n; i += a.R) d[i] = v;
  } else if (t < n_rows) {
    for (int k = 0; k < n; ++k) dst[(long long)k * a.G + g0 + t] = v;
  }
}

// Phase 2: the outputs the row logic writes in device memory, as the
// reference initialises them: need_snapshot 0, slot_base SLOT_UNUSED,
// slot_term 0, ent_drop 0, and the outbox messages past the staged ones
// zeros but F_SRC_SLOT = the row's first occupied inbox slot.
template <bool GL>
DBT_RI void step_prefill(const StepArgs& a, const int* tile, int blk, int t) {
  const int g0 = blk * a.R, n_rows = block_rows(a, blk);
  fill_out<GL>(a, a.out[3], a.P, 0, g0, n_rows, t);
  fill_out<GL>(a, a.out[4], a.M, SLOT_UNUSED, g0, n_rows, t);
  fill_out<GL>(a, a.out[5], a.M, 0, g0, n_rows, t);
  fill_out<GL>(a, a.out[6], a.M * a.E, 0, g0, n_rows, t);
  const int nb = a.O * N_FIELDS, k0 = a.K * N_FIELDS, n = nb - k0;
  if (n == 0) return;
  const int* first = tile + a.T() * a.S;
  if (!GL) {
    // row r's words k0 .. nb - 1; word i of the n_rows * n walked in
    // steps of R as (r, k)
    int* d = a.out[0] + (long long)g0 * nb + k0;
    const int total = n_rows * n;
    int r = t / n, k = t - r * n;
    const int dr = a.R / n, dk = a.R - dr * n;
    for (int i = t; i < total; i += a.R) {
      d[(long long)r * nb + k] = (k0 + k) % N_FIELDS == F_SRC_SLOT ? first[r] : 0;
      r += dr;
      k += dk;
      if (k >= n) {
        k -= n;
        ++r;
      }
    }
  } else if (t < n_rows) {
    int* d = a.out[0] + g0 + t;
    for (int k = k0; k < nb; ++k)
      d[(long long)k * a.G] = k % N_FIELDS == F_SRC_SLOT ? first[t] : 0;
  }
}

// Phase 3: the row logic of the block's row t.
template <bool GL, bool ROUTED = false>
DBT_RI void step_rows(const StepArgs& a, int* tile, int blk, int t) {
  if (t >= block_rows(a, blk)) return;
  const int g = blk * a.R + t;
  step_row<ROUTED>(a, tile, g, t, row_stride<GL>(a));
}

// The routed step's staged messages out (external layout): of row r's
// staged words, those of its first min(count, K) messages, coalesced as
// copy_out's; the counts are the tile's row words (phase 3).
DBT_RI void store_sent(const StepArgs& a, const int* tile, int g0,
                       int n_rows, int t) {
  const int n = a.K * N_FIELDS, rs = a.O * N_FIELDS, b = a.t_buf();
  const int* cnt = tile + a.T() * a.S;
  int* d = a.out[0] + (long long)g0 * rs;
  const int total = n_rows * n;
  for (int i = t; i < total; i += a.R) {
    const int r = div_by(i, a.mK), k = i - r * n;
    if (k < cnt[r] * N_FIELDS)
      d[(long long)r * rs + k] = tile[(b + k) * a.S + r];
  }
}

// Phase 4: the tile's arrays out, and the staged messages: all K of every
// row, or in the routed step those emitted.
template <bool GL, bool ROUTED = false>
DBT_RI void step_store(const StepArgs& a, const int* tile, int blk, int t) {
  const int g0 = blk * a.R, n_rows = block_rows(a, blk);
  for (int f = 0; f < 10; ++f)
    copy_out<GL>(a, tile, a.st_out[N_SCALARS + f], a.arr(f),
                 f < 8 ? a.P : a.W, f < 8 ? a.mP : a.mW, g0, n_rows, t);
  if constexpr (ROUTED) {
    static_assert(!GL, "the routed step runs on the external layout");
    store_sent(a, tile, g0, n_rows, t);
  } else if (a.K) {
    copy_out<GL>(a, tile, a.out[0], a.t_buf(), a.K * N_FIELDS, a.mK, g0,
                 n_rows, t, a.O * N_FIELDS);
  }
}

}  // namespace dbt

#ifdef __CUDACC__
// ROUTED: no prefill (and no barrier after it), the routed row logic, and
// only the emitted staged messages stored
template <bool GL, bool ROUTED>
__device__ __forceinline__ void step_block(const dbt::StepArgs& a) {
  extern __shared__ int4 dbt_step_tile[];
  int* tile = reinterpret_cast<int*>(dbt_step_tile);
  const int blk = blockIdx.x, t = threadIdx.x;
  dbt::step_load<GL, ROUTED>(a, tile, blk, t);
  dbt::async_wait_all();
  __syncthreads();
  if constexpr (!ROUTED) {
    dbt::step_prefill<GL>(a, tile, blk, t);
    __syncthreads();
  }
  dbt::step_rows<GL, ROUTED>(a, tile, blk, t);
  __syncthreads();
  dbt::step_store<GL, ROUTED>(a, tile, blk, t);
}

template <bool ROUTED>
__global__ void raft_step_kernel(const __grid_constant__ dbt::StepArgs a) {
  step_block<false, ROUTED>(a);
}

__global__ void raft_step_internal_kernel(
    const __grid_constant__ dbt::StepArgs a) {
  step_block<true, false>(a);
}

void dbt::raft_step_launch(const int* const* st_in, int* const* st_out,
                           const int* const* inbox, int* const* out, int G,
                           int P, int W, int M, int E, int O,
                           dbt::StepKind kind, int rows_per_block,
                           int staged, void* stream) {
  const bool internal = kind == dbt::STEP_INTERNAL;
  dbt::StepArgs a;
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_in[f] = st_in[f];
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_out[f] = st_out[f];
  for (int f = 0; f < dbt::N_INBOX; ++f) a.ib[f] = inbox[f];
  for (int f = 0; f < dbt::N_OUT; ++f) a.out[f] = out[f];
  dbt::step_args_init(a, G, P, W, M, E, O, internal, rows_per_block, staged);
  const size_t smem = ((size_t)a.S * a.T() + a.R) * sizeof(int);
  const void* fn = internal ? (const void*)raft_step_internal_kernel
                   : kind == dbt::STEP_ROUTED
                       ? (const void*)raft_step_kernel<true>
                       : (const void*)raft_step_kernel<false>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const int blocks = (G + a.R - 1) / a.R;
  if (internal)
    raft_step_internal_kernel<<<blocks, a.R, smem, (cudaStream_t)stream>>>(a);
  else if (kind == dbt::STEP_ROUTED)
    raft_step_kernel<true><<<blocks, a.R, smem, (cudaStream_t)stream>>>(a);
  else
    raft_step_kernel<false><<<blocks, a.R, smem, (cudaStream_t)stream>>>(a);
}
#endif

#undef DBT_RI
