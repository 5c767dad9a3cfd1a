// raft_step: the raft step for every row, one thread per row.
//
// Replaces dragonboat_tpu/ops/kernel.py `step` (`_step_impl` /
// `_process_slot` and every handler, kernel.py:181-1649).  It computes
// what that program computes, not how: the JAX program runs each inbox
// slot as one masked pass over all rows with one-hot selects; here each
// thread walks ITS row's inbox slots in order, skipping empty ones, and
// stops handling a row once its `escalate` word is set.  That gives the
// reference's slot compaction/un-compaction for free: slot outputs and
// buf[..., F_SRC_SLOT] are written in caller coordinates directly.
//
// Bound: bytes.  A row reads its state (21 + 8P + 2W words) and inbox
// (10M + 2ME words) once and writes the new state and its outputs
// (11O + 5 + P + 2M + ME words); the control flow is a few hundred
// integer operations per message, far below the card's integer rate.
// This first version keeps the row's scalars in registers and works on
// its peer/ring/outbox arrays in place in the OUTPUT tensors (the input
// arrays are copied over first); the row-major [G, P] layout makes
// those accesses strided across a warp.  A later version can stage
// them through shared memory or registers.
//
// Two layouts, one row logic, compiled once per layout.  The row
// logic reads and writes every per-row array as DBT_EL(a, k), element k
// counted from the row's first element a:
//   * this file alone builds the external layout of `kernel.step`
//     ([G, P], [G, W], inbox [G, M] / [G, M, E], out.buf [G, O,
//     N_FIELDS]) as `dbt::ext::step_row` and `raft_step_kernel`: a row's
//     elements are contiguous and DBT_EL(a, k) is a[k];
//   * raft_step_internal.cu defines DBT_STEP_GL and includes this file
//     to build the G-last layout of `kernel.step_internal`
//     (kernel.py:1674) as `dbt::gl::step_row` and
//     `raft_step_internal_kernel`: element k of row g sits at k * G + g,
//     DBT_EL(a, k) is Row::at(a, k) = a[k * G].
// Choosing the layout in the preprocessor, not by a template argument,
// leaves the external kernel's source and so its machine code as it was
// before the G-last layout was added (a template or an accessor function
// changes the compiler's inlining; checked with `python3 -m
// dragonboat_tpu_torch.ops.sass_compare <earlier csrc>`).  The G-last
// kernel still keeps part of its row in the thread's stack frame
// (ptxas -v): staging that is work for a faster version.
//
// Hazards handled as the reference defines them:
//   * a peer slot outside [0, P) reads 0 and writes nothing (the
//     one-hot selects of `_col` / `_set_col`);
//   * `_slot_of` returns slot 0 when no peer matches;
//   * the election jitter is uint32 arithmetic;
//   * int32 sums wrap (wadd/wsub), as JAX int32 does;
//   * the quorum sort is an insertion sort over at most PMAX slots;
//   * a full outbox sets ESC_OVERFLOW, as `_emit` does.
//
// The file compiles as CUDA (nvcc) and, without __CUDACC__, as plain
// C++: then only the per-row logic (`dbt::ext::step_row`, or with
// DBT_STEP_GL `dbt::gl::step_row`) is built; including it twice, the
// second time with DBT_STEP_GL defined, builds both.
#include "common.cuh"
#include "launch.h"

#ifndef DBT_STEP_GL
#define DBT_STEP_GL 0
#endif

// What both layouts share, defined once however often the file is
// included.
#ifndef DBT_RAFT_STEP_SHARED
#define DBT_RAFT_STEP_SHARED

namespace dbt {

constexpr int PMAX = 16;

struct StepArgs {
  const int* st_in[N_STATE];
  int* st_out[N_STATE];
  const int* ib[N_INBOX];
  int* out[N_OUT];
  int G, P, W, M, E, O;
};

struct Msg {
  int mtype, from_id, term, log_term, log_index, commit, reject, hint,
      hint_high, n_entries;
  const int* ent_term;
  const int* ent_cc;
};

DBT_HD uint32_t splitmix32(uint32_t x) {
  uint32_t z = x + 0x9E3779B9u;
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

DBT_HD bool is_hot(int mt) {
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

// raft_step_internal.cu: the G-last kernel on `stream`
void raft_step_internal_launch(const StepArgs& a, void* stream);

}  // namespace dbt

#endif  // DBT_RAFT_STEP_SHARED

// Element k of a row's per-row array that starts at a (DBT_ROW_EL: in
// step_row, through the row r): a[k] in the external layout, a[k * S]
// through Row::at in the G-last one.
#if DBT_STEP_GL
#define DBT_STEP_NS gl
#define DBT_EL(a, k) at(a, k)
#define DBT_ROW_EL(a, k) r.at(a, k)
#else
#define DBT_STEP_NS ext
#define DBT_EL(a, k) (a)[k]
#define DBT_ROW_EL(a, k) (a)[k]
#endif

namespace dbt {
namespace DBT_STEP_NS {

// One row's state: scalars by value, peer/ring/out arrays in place.
struct Row {
  int shard_id, replica_id, self_slot, election_timeout, heartbeat_timeout,
      check_quorum, pre_vote;
  int term, vote, leader_id, role, committed, last_index, first_index,
      base_term, election_tick, heartbeat_tick, rand_timeout, timeout_seq,
      pending_cc, transfer_target;
  int *peer_id, *peer_kind, *match, *next_idx, *rstate, *snap_index, *active,
      *granted;
  int *ring_term, *ring_cc;
  int P, W, E, O;
  // outputs
  int* buf;
  int* need_snapshot;
  int* slot_base;
  int* slot_term;
  int* ent_drop;
  int count, escalate, append_lo, barrier_idx, barrier_term;
#if DBT_STEP_GL
  long long S;  // the element stride of the per-row arrays: G

  template <typename T>
  DBT_HD T& at(T* a, int k) const {
    return a[(long long)k * S];
  }
#endif

  // -- peer slots ---------------------------------------------------------
  DBT_HD bool in_p(int s) const { return s >= 0 && s < P; }
  DBT_HD int col(const int* a, int s) const { return in_p(s) ? DBT_EL(a, s) : 0; }
  DBT_HD void set_col(int* a, int s, int v) {
    if (in_p(s)) DBT_EL(a, s) = v;
  }
  DBT_HD bool valid(int p) const { return DBT_EL(peer_id, p) != 0; }
  DBT_HD bool is_voter(int p) const {
    return DBT_EL(peer_id, p) != 0 &&
           (DBT_EL(peer_kind, p) == KIND_VOTER || DBT_EL(peer_kind, p) == KIND_WITNESS);
  }
  DBT_HD int num_voters() const {
    int n = 0;
    for (int p = 0; p < P; ++p) n += is_voter(p) ? 1 : 0;
    return n;
  }
  DBT_HD int quorum() const { return num_voters() / 2 + 1; }
  DBT_HD int self_kind() const { return col(peer_kind, self_slot); }
  DBT_HD bool self_is_voter() const {
    return col(peer_id, self_slot) == replica_id && self_kind() == KIND_VOTER;
  }
  DBT_HD int slot_of(int pid, bool* found) const {
    if (pid != 0) {
      for (int p = 0; p < P; ++p) {
        if (DBT_EL(peer_id, p) != 0 && DBT_EL(peer_id, p) == pid) {
          *found = true;
          return p;
        }
      }
    }
    *found = false;
    return 0;
  }

  // -- log-term ring ------------------------------------------------------
  DBT_HD int win_lo() const { return imax(first_index, wsub(last_index, W - 1)); }
  DBT_HD int ring_pos(int idx) const { return (idx < 0 ? 0 : idx) & (W - 1); }
  DBT_HD int log_term(int idx, bool* known, bool* esc) const {
    bool zero = idx == 0;
    bool boundary = idx == wsub(first_index, 1);
    bool in_win = idx >= win_lo() && idx <= last_index;
    bool beyond = idx > last_index;
    int t = zero ? 0 : (boundary ? base_term : DBT_EL(ring_term, ring_pos(idx)));
    *known = zero || boundary || in_win;
    *esc = !*known && !beyond;
    return t;
  }
  DBT_HD bool match_term(int idx, int t, bool* esc) const {
    bool known;
    int lt = log_term(idx, &known, esc);
    return known && lt == t;
  }
  DBT_HD int last_term(bool* esc) const {
    bool known;
    return log_term(last_index, &known, esc);
  }
  DBT_HD void ring_write(int idx, int t, int cc) {
    int p = ring_pos(idx);
    DBT_EL(ring_term, p) = t;
    DBT_EL(ring_cc, p) = cc;
  }
  DBT_HD bool pending_cc_any() const {
    int lo = win_lo();
    for (int j = 0; j < W; ++j) {
      int cand = wadd(lo, (int)((uint32_t)wsub(j, lo) & (uint32_t)(W - 1)));
      if (cand > committed && cand <= last_index && DBT_EL(ring_cc, j) == 1) return true;
    }
    return false;
  }

  // -- outbox ---------------------------------------------------------------
  DBT_HD void emit(int mtype, int to, int t, int log_term_, int log_index,
                   int commit, int reject, int hint, int hint_high,
                   int n_entries, int src_slot) {
    if (count < O) {
#if DBT_STEP_GL
      int* r = buf + (long long)count * N_FIELDS * S;
#else
      int* r = buf + count * N_FIELDS;
#endif
      DBT_EL(r, F_MTYPE) = mtype;
      DBT_EL(r, F_TO) = to;
      DBT_EL(r, F_TERM) = t;
      DBT_EL(r, F_LOG_TERM) = log_term_;
      DBT_EL(r, F_LOG_INDEX) = log_index;
      DBT_EL(r, F_COMMIT) = commit;
      DBT_EL(r, F_REJECT) = reject;
      DBT_EL(r, F_HINT) = hint;
      DBT_EL(r, F_HINT_HIGH) = hint_high;
      DBT_EL(r, F_N_ENTRIES) = n_entries;
      DBT_EL(r, F_SRC_SLOT) = src_slot;
      ++count;
    } else {
      escalate |= ESC_OVERFLOW;
    }
  }

  // -- role transitions -----------------------------------------------------
  DBT_HD int jitter(int seq) const {
    uint32_t h = splitmix32(((uint32_t)shard_id << 24) ^
                            ((uint32_t)replica_id << 8) ^ (uint32_t)seq);
    uint32_t span = (uint32_t)election_timeout;
    return (int)(span ? h % span : h);
  }
  DBT_HD void reset_timeout() {
    int seq = wadd(timeout_seq, 1);
    rand_timeout = wadd(election_timeout, jitter(seq));
    timeout_seq = seq;
  }
  DBT_HD void reset(int new_term) {
    if (term != new_term) vote = 0;
    term = new_term;
    leader_id = 0;
    election_tick = 0;
    heartbeat_tick = 0;
    for (int p = 0; p < P; ++p) DBT_EL(granted, p) = 0;
    transfer_target = 0;
    pending_cc = 0;
    reset_timeout();
    for (int p = 0; p < P; ++p) {
      if (!valid(p)) continue;
      DBT_EL(match, p) = p == self_slot ? last_index : 0;
      DBT_EL(next_idx, p) = wadd(last_index, 1);
      DBT_EL(rstate, p) = RS_RETRY;
      DBT_EL(snap_index, p) = 0;
    }
  }
  DBT_HD void become_follower(int new_term, int leader) {
    int sk = self_kind();
    role = sk == KIND_NON_VOTING ? ROLE_NON_VOTING
           : sk == KIND_WITNESS  ? ROLE_WITNESS
                                 : ROLE_FOLLOWER;
    reset(new_term);
    leader_id = leader;
  }
  DBT_HD void become_pre_candidate() {
    role = ROLE_PRE_CANDIDATE;
    for (int p = 0; p < P; ++p) DBT_EL(granted, p) = 0;
    leader_id = 0;
    election_tick = 0;
    reset_timeout();
  }
  DBT_HD void grant_self() { set_col(granted, self_slot, 1); }
  DBT_HD void become_candidate() {
    role = ROLE_CANDIDATE;
    reset(wadd(term, 1));
    vote = replica_id;
    grant_self();
  }
  DBT_HD bool votes_at_least_quorum(int want) const {
    int n = 0;
    for (int p = 0; p < P; ++p) n += (is_voter(p) && DBT_EL(granted, p) == want) ? 1 : 0;
    return n >= quorum();
  }
  DBT_HD bool vote_quorum() const { return votes_at_least_quorum(1); }
  DBT_HD bool vote_rejected() const { return votes_at_least_quorum(2); }

  DBT_HD void append_one(int cc) {
    int new_last = wadd(last_index, 1);
    append_lo = imin(append_lo, new_last);
    ring_write(new_last, term, cc);
    last_index = new_last;
    int sm = col(match, self_slot);
    int sn = col(next_idx, self_slot);
    set_col(match, self_slot, imax(sm, new_last));
    set_col(next_idx, self_slot, imax(sn, wadd(new_last, 1)));
  }

  // sorted-match quorum + current-term-only gate; true when it advanced
  DBT_HD bool try_commit() {
    int s[PMAX];
    for (int p = 0; p < P; ++p) {
      int v = is_voter(p) ? DBT_EL(match, p) : -1;
      int j = p;
      while (j > 0 && s[j - 1] > v) {
        s[j] = s[j - 1];
        --j;
      }
      s[j] = v;
    }
    int k = P - quorum();
    int qidx = (k >= 0 && k < P) ? s[k] : 0;
    if (!(qidx > committed)) return false;
    bool esc;
    bool ok = match_term(qidx, term, &esc);
    if (esc) escalate |= ESC_WINDOW;
    if (!ok) return false;
    committed = qidx;
    return true;
  }

  // -- replicate / heartbeat sending --------------------------------------
  DBT_HD void send_replicate(int slot) {
    int rs = col(rstate, slot);
    int nxt = col(next_idx, slot);
    int to = col(peer_id, slot);
    if (rs == RS_WAIT || rs == RS_SNAPSHOT || to == 0) return;
    int prev = wsub(nxt, 1);
    if (prev < wsub(first_index, 1)) {
      // compacted below the resolvable boundary -> snapshot path
      if (in_p(slot)) DBT_EL(need_snapshot, slot) = 1;
      set_col(rstate, slot, RS_WAIT);
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
      if (rs == RS_REPLICATE) set_col(next_idx, slot, wadd(last_sent, 1));
      if (rs == RS_RETRY) set_col(rstate, slot, RS_WAIT);
    }
  }
  DBT_HD void broadcast_replicate() {
    for (int p = 0; p < P; ++p)
      if (valid(p) && self_slot != p) send_replicate(p);
  }
  DBT_HD void broadcast_heartbeat(int hint, int hint_high) {
    for (int p = 0; p < P; ++p) {
      if (!valid(p) || self_slot == p) continue;
      emit(MT_HEARTBEAT, DBT_EL(peer_id, p), term, 0, committed,
           imin(DBT_EL(match, p), committed), 0, hint, hint_high, 0, -1);
    }
  }

  DBT_HD void become_leader() {
    role = ROLE_LEADER;
    reset(term);
    leader_id = replica_id;
    for (int p = 0; p < P; ++p)
      if (valid(p)) DBT_EL(active, p) = 1;
    if (wadd(committed, 1) < win_lo() && committed < last_index)
      escalate |= ESC_WINDOW;
    pending_cc = pending_cc_any() ? 1 : 0;
    append_one(0);  // commit barrier
    barrier_idx = last_index;
    barrier_term = term;
    if (num_voters() == 1 && self_is_voter()) try_commit();
  }

  DBT_HD void campaign(bool pre, bool transfer) {
    if (pre) {
      become_pre_candidate();
      grant_self();
      if (!vote_quorum()) {
        bool esc;
        int lt = last_term(&esc);
        if (esc) escalate |= ESC_WINDOW;
        for (int p = 0; p < P; ++p) {
          if (!is_voter(p) || self_slot == p) continue;
          emit(MT_REQUEST_PREVOTE, DBT_EL(peer_id, p), wadd(term, 1), lt, last_index,
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
      emit(MT_REQUEST_VOTE, DBT_EL(peer_id, p), term, lt, last_index, 0, 0, hint, 0,
           0, -1);
    }
  }

  DBT_HD void handle_election(int hint) {
    if (role == ROLE_LEADER || role == ROLE_NON_VOTING ||
        role == ROLE_WITNESS || !self_is_voter())
      return;
    bool transfer = hint == replica_id;
    campaign(pre_vote == 1 && !transfer, transfer);
  }

  DBT_HD void check_quorum_now() {
    int cnt = 1;
    for (int p = 0; p < P; ++p)
      if (is_voter(p) && p != self_slot && DBT_EL(active, p) == 1) ++cnt;
    for (int p = 0; p < P; ++p)
      if (is_voter(p)) DBT_EL(active, p) = 0;
    if (cnt < quorum()) become_follower(term, 0);
  }

  DBT_HD void tick(int n, int hint, int hint_high) {
    if (role == ROLE_LEADER) {
      int el = wadd(election_tick, n);
      int hb = wadd(heartbeat_tick, n);
      bool fired = el >= election_timeout;
      election_tick = fired ? 0 : el;
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
  DBT_HD bool on_message_term(const Msg& m) {
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
  DBT_HD bool up_to_date(const Msg& m) {
    bool esc;
    int lt = last_term(&esc);
    if (esc) escalate |= ESC_WINDOW;
    return m.log_term > lt || (m.log_term == lt && m.log_index >= last_index);
  }
  DBT_HD void handle_request_vote(const Msg& m) {
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
  DBT_HD void handle_request_prevote(const Msg& m) {
    if (role == ROLE_NON_VOTING) return;
    bool utd = up_to_date(m);
    bool grant = utd && (m.term > term || vote == 0 || vote == m.from_id);
    emit(MT_REQUEST_PREVOTE_RESP, m.from_id, grant ? m.term : term, 0, 0, 0,
         grant ? 0 : 1, 0, 0, 0, -1);
  }

  // -- follower side ------------------------------------------------------------
  DBT_HD void handle_replicate(const Msg& m) {
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
      if (!match_term(wadd(m.log_index, 1 + i), DBT_EL(m.ent_term, i), &e_esc)) {
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
        ring_write(wadd(m.log_index, 1 + i), DBT_EL(m.ent_term, i), DBT_EL(m.ent_cc, i));
      last_index = last_new;
    }
    committed = imax(committed, imin(m.commit, last_new));
    emit(MT_REPLICATE_RESP, m.from_id, term, 0, last_new, 0, 0, 0, 0, 0, -1);
  }
  DBT_HD void handle_heartbeat(const Msg& m) {
    committed = imax(committed, imin(m.commit, last_index));
    emit(MT_HEARTBEAT_RESP, m.from_id, term, 0, 0, 0, 0, m.hint, m.hint_high,
         0, -1);
  }

  // -- leader side --------------------------------------------------------------
  DBT_HD void handle_replicate_resp(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (!found) return;
    set_col(active, slot, 1);
    int rs = col(rstate, slot);
    int mt0 = col(match, slot);
    int nxt = col(next_idx, slot);
    int snap = col(snap_index, slot);
    int li = m.log_index;
    bool rej = m.reject == 1;
    // decrease (oracle: remote.decrease)
    bool repl = rs == RS_REPLICATE;
    bool do_r = rej && repl && li > mt0;
    if (do_r) {
      set_col(next_idx, slot, wadd(mt0, 1));
      set_col(snap_index, slot, 0);
      set_col(rstate, slot, RS_RETRY);
    }
    bool do_nr = rej && !repl && wsub(nxt, 1) == li;
    if (do_nr) {
      int dec = imax(imax(imin(li, wadd(m.hint, 1)), wadd(mt0, 1)), 1);
      set_col(next_idx, slot, dec);
      if (rs == RS_WAIT) set_col(rstate, slot, RS_RETRY);
    }
    if (do_r || do_nr) send_replicate(slot);
    // ack
    bool ack = m.reject == 0;
    bool paused = rs == RS_WAIT || rs == RS_SNAPSHOT;
    bool advanced = ack && mt0 < li;
    int new_match = imax(mt0, li);
    int new_next = imax(nxt, wadd(li, 1));
    if (advanced) set_col(match, slot, new_match);
    if (ack) set_col(next_idx, slot, new_next);
    if (advanced && rs == RS_WAIT) set_col(rstate, slot, RS_RETRY);
    if (advanced && col(rstate, slot) == RS_SNAPSHOT && new_match >= snap) {
      set_col(next_idx, slot, imax(wadd(new_match, 1), wadd(snap, 1)));
      set_col(snap_index, slot, 0);
      set_col(rstate, slot, RS_RETRY);
    }
    if (advanced && col(rstate, slot) == RS_RETRY) {
      set_col(next_idx, slot, wadd(new_match, 1));
      set_col(snap_index, slot, 0);
      set_col(rstate, slot, RS_REPLICATE);
    }
    bool cadv = advanced && try_commit();
    if (cadv) broadcast_replicate();
    if (advanced && !cadv && paused) send_replicate(slot);
    // leader transfer: target caught up -> TIMEOUT_NOW
    if (advanced && transfer_target == m.from_id && last_index == new_match)
      emit(MT_TIMEOUT_NOW, m.from_id, term, 0, 0, 0, 0, 0, 0, 0, -1);
    // stale ack while streaming a snapshot that has completed
    int rs4 = col(rstate, slot);
    int m4 = col(match, slot);
    int s4 = col(snap_index, slot);
    if (ack && !advanced && rs4 == RS_SNAPSHOT && m4 >= s4) {
      set_col(next_idx, slot, imax(wadd(m4, 1), wadd(s4, 1)));
      set_col(snap_index, slot, 0);
      set_col(rstate, slot, RS_RETRY);
    }
  }

  DBT_HD void handle_heartbeat_resp(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (!found) return;
    set_col(active, slot, 1);
    if (col(rstate, slot) == RS_WAIT) set_col(rstate, slot, RS_RETRY);
    if (col(match, slot) < last_index) send_replicate(slot);
    // read-index ctx echo to the host (voting members only)
    int kind = col(peer_kind, slot);
    bool voter = kind == KIND_VOTER || kind == KIND_WITNESS;
    if (voter && (m.hint != 0 || m.hint_high != 0))
      emit(MT_READ_INDEX_RESP, replica_id, term, 0, m.from_id, 0, 0, m.hint,
           m.hint_high, 0, -1);
  }

  DBT_HD void handle_read_index(const Msg& m) {
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

  DBT_HD void handle_unreachable(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (!found || col(rstate, slot) != RS_REPLICATE) return;
    set_col(next_idx, slot, wadd(col(match, slot), 1));
    set_col(snap_index, slot, 0);
    set_col(rstate, slot, RS_RETRY);
  }

  DBT_HD void handle_snapshot_status(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (!found || col(rstate, slot) != RS_SNAPSHOT) return;
    int snap = m.reject == 1 ? 0 : col(snap_index, slot);
    set_col(next_idx, slot, imax(wadd(col(match, slot), 1), wadd(snap, 1)));
    set_col(snap_index, slot, 0);
    set_col(rstate, slot, RS_WAIT);
  }

  DBT_HD void handle_propose(const Msg& m, int slot_i) {
    bool lead = role == ROLE_LEADER;
    int n = m.n_entries;
    bool transferring = transfer_target != 0;
    bool drop_all = lead && transferring;
    bool accept = lead && !transferring;
    int base = last_index;
    bool appended_any = false;
    if (accept) {
      for (int i = 0; i < E && i < n; ++i) {
        bool is_cc = DBT_EL(m.ent_cc, i) == 1;
        if (is_cc && pending_cc == 1) {
          DBT_EL(ent_drop, slot_i * E + i) = 1;  // config-change gate
          continue;
        }
        if (is_cc) pending_cc = 1;
        append_one(is_cc ? 1 : 0);
        appended_any = true;
      }
    }
    if (appended_any && num_voters() == 1 && self_is_voter()) try_commit();
    if (appended_any) broadcast_replicate();
    int sb = accept ? base : (drop_all ? SLOT_DROPPED : DBT_EL(slot_base, slot_i));
    int stm = accept ? term : DBT_EL(slot_term, slot_i);
    bool foll = role == ROLE_FOLLOWER || role == ROLE_NON_VOTING ||
                role == ROLE_WITNESS;
    if (foll && leader_id != 0) {
      emit(MT_PROPOSE, leader_id, term, 0, 0, 0, 0, 0, 0, n, slot_i);
      sb = SLOT_FORWARDED;
    }
    if ((foll && leader_id == 0) || role == ROLE_CANDIDATE ||
        role == ROLE_PRE_CANDIDATE)
      sb = SLOT_DROPPED;
    DBT_EL(slot_base, slot_i) = sb;
    DBT_EL(slot_term, slot_i) = stm;
  }

  // -- candidate / follower blocks ------------------------------------------
  DBT_HD void record_vote(const Msg& m) {
    bool found;
    int slot = slot_of(m.from_id, &found);
    if (found) set_col(granted, slot, m.reject == 1 ? 2 : 1);
  }
  DBT_HD void candidate_block(const Msg& m) {
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
  DBT_HD void follower_block(const Msg& m) {
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
  DBT_HD void process_slot(const Msg& m, int slot_i) {
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

// The whole step for row g.
DBT_HD void step_row(const StepArgs& a, int g) {
  const int P = a.P, W = a.W, M = a.M, E = a.E, O = a.O;
  Row r;
#if DBT_STEP_GL
  r.S = a.G;
#endif
  const int* const* si = a.st_in;
  int sc[21];
  for (int f = 0; f < 21; ++f) sc[f] = si[f][g];
  r.shard_id = sc[0];
  r.replica_id = sc[1];
  r.self_slot = sc[2];
  r.election_timeout = sc[3];
  r.heartbeat_timeout = sc[4];
  r.check_quorum = sc[5];
  r.pre_vote = sc[6];
  r.term = sc[7];
  r.vote = sc[8];
  r.leader_id = sc[9];
  r.role = sc[10];
  r.committed = sc[11];
  r.last_index = sc[12];
  r.first_index = sc[13];
  r.base_term = sc[14];
  r.election_tick = sc[15];
  r.heartbeat_tick = sc[16];
  r.rand_timeout = sc[17];
  r.timeout_seq = sc[18];
  r.pending_cc = sc[19];
  r.transfer_target = sc[20];
  // peer and ring arrays: copy the row over, then work in place
  int* arr[10];
  for (int f = 0; f < 10; ++f) {
    int n = f < 8 ? P : W;
    // row g's first element: [G, n] rows are contiguous, [n, G] rows
    // are columns
#if DBT_STEP_GL
    const int* src = si[21 + f] + g;
    int* dst = a.st_out[21 + f] + g;
#else
    const int* src = si[21 + f] + (long long)g * n;
    int* dst = a.st_out[21 + f] + (long long)g * n;
#endif
    for (int k = 0; k < n; ++k) DBT_ROW_EL(dst, k) = DBT_ROW_EL(src, k);
    arr[f] = dst;
  }
  r.peer_id = arr[0];
  r.peer_kind = arr[1];
  r.match = arr[2];
  r.next_idx = arr[3];
  r.rstate = arr[4];
  r.snap_index = arr[5];
  r.active = arr[6];
  r.granted = arr[7];
  r.ring_term = arr[8];
  r.ring_cc = arr[9];
  r.P = P;
  r.W = W;
  r.E = E;
  r.O = O;
  // outputs, initialised as make_out does
#if DBT_STEP_GL
  r.buf = a.out[0] + g;
  r.need_snapshot = a.out[3] + g;
  r.slot_base = a.out[4] + g;
  r.slot_term = a.out[5] + g;
  r.ent_drop = a.out[6] + g;
#else
  r.buf = a.out[0] + (long long)g * O * N_FIELDS;
  r.need_snapshot = a.out[3] + (long long)g * P;
  r.slot_base = a.out[4] + (long long)g * M;
  r.slot_term = a.out[5] + (long long)g * M;
  r.ent_drop = a.out[6] + (long long)g * M * E;
#endif
  for (int k = 0; k < O * N_FIELDS; ++k) DBT_ROW_EL(r.buf, k) = 0;
  for (int k = 0; k < P; ++k) DBT_ROW_EL(r.need_snapshot, k) = 0;
  for (int k = 0; k < M; ++k) {
    DBT_ROW_EL(r.slot_base, k) = SLOT_UNUSED;
    DBT_ROW_EL(r.slot_term, k) = 0;
  }
  for (int k = 0; k < M * E; ++k) DBT_ROW_EL(r.ent_drop, k) = 0;
  r.count = 0;
  r.escalate = 0;
  r.append_lo = APPEND_LO_NONE;
  r.barrier_idx = -1;
  r.barrier_term = 0;
  // the row's inbox slots, in order; empty slots are no-ops and an
  // escalated row handles nothing more
  int first_occ = -1;
  for (int s = 0; s < M; ++s) {
    // slot s of row g: [G, M] / [G, M, E], or [M, G] / [M, E, G]
#if DBT_STEP_GL
    long long off = s * r.S + g;
#else
    long long off = (long long)g * M + s;
#endif
    int mt = a.ib[0][off];
    if (mt == 0) continue;
    if (first_occ < 0) first_occ = s;
    if (r.escalate != 0) continue;
    Msg m;
    m.mtype = mt;
    m.from_id = a.ib[1][off];
    m.term = a.ib[2][off];
    m.log_term = a.ib[3][off];
    m.log_index = a.ib[4][off];
    m.commit = a.ib[5][off];
    m.reject = a.ib[6][off];
    m.hint = a.ib[7][off];
    m.hint_high = a.ib[8][off];
    m.n_entries = a.ib[9][off];
#if DBT_STEP_GL
    m.ent_term = a.ib[10] + s * E * r.S + g;
    m.ent_cc = a.ib[11] + s * E * r.S + g;
#else
    m.ent_term = a.ib[10] + off * E;
    m.ent_cc = a.ib[11] + off * E;
#endif
    r.process_slot(m, s);
  }
  // The reference maps every outbox row's F_SRC_SLOT back through its
  // slot compaction order; an unused row holds 0 there, which maps to
  // the row's first occupied slot (or 0 when the inbox is empty).
  if (first_occ < 0) first_occ = 0;
  for (int k = r.count; k < O; ++k)
    DBT_ROW_EL(r.buf, k * N_FIELDS + F_SRC_SLOT) = first_occ;
  // scalars out
  int so[21] = {r.shard_id, r.replica_id, r.self_slot, r.election_timeout,
                r.heartbeat_timeout, r.check_quorum, r.pre_vote, r.term,
                r.vote, r.leader_id, r.role, r.committed, r.last_index,
                r.first_index, r.base_term, r.election_tick, r.heartbeat_tick,
                r.rand_timeout, r.timeout_seq, r.pending_cc,
                r.transfer_target};
  for (int f = 0; f < 21; ++f) a.st_out[f][g] = so[f];
  a.out[1][g] = r.count;
  a.out[2][g] = r.escalate;
  a.out[7][g] = r.append_lo;
  a.out[8][g] = r.barrier_idx;
  a.out[9][g] = r.barrier_term;
}

}  // namespace DBT_STEP_NS
}  // namespace dbt

#ifdef __CUDACC__
#if DBT_STEP_GL
__global__ void raft_step_internal_kernel(const dbt::StepArgs a) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < a.G) dbt::gl::step_row(a, g);
}

void dbt::raft_step_internal_launch(const dbt::StepArgs& a, void* stream) {
  const int threads = 128;
  const int blocks = (a.G + threads - 1) / threads;
  raft_step_internal_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
}
#else
__global__ void raft_step_kernel(const dbt::StepArgs a) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < a.G) dbt::ext::step_row(a, g);
}

void dbt::raft_step_launch(const int* const* st_in, int* const* st_out,
                           const int* const* inbox, int* const* out, int G,
                           int P, int W, int M, int E, int O, int internal,
                           void* stream) {
  dbt::StepArgs a;
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_in[f] = st_in[f];
  for (int f = 0; f < dbt::N_STATE; ++f) a.st_out[f] = st_out[f];
  for (int f = 0; f < dbt::N_INBOX; ++f) a.ib[f] = inbox[f];
  for (int f = 0; f < dbt::N_OUT; ++f) a.out[f] = out[f];
  a.G = G;
  a.P = P;
  a.W = W;
  a.M = M;
  a.E = E;
  a.O = O;
  if (internal) {
    dbt::raft_step_internal_launch(a, stream);
    return;
  }
  const int threads = 128;
  const int blocks = (G + threads - 1) / threads;
  raft_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
}
#endif
#endif

#undef DBT_EL
#undef DBT_ROW_EL
#undef DBT_STEP_NS
#undef DBT_STEP_GL
