// Host-side launchers of the port's CUDA kernels, one per csrc/*.cu.
//
// bindings.cpp checks the tensors and calls these with their device
// pointers; each launcher fills its kernel's argument struct and
// launches on `stream`.  They do not synchronise and do not check the
// launch: the binding does (C10_CUDA_KERNEL_LAUNCH_CHECK).  `stream` is
// a cudaStream_t; the header names no CUDA type, so the .cu files still
// compile as plain C++ (their per-row logic) where there is no CUDA.
#pragma once

namespace dbt {

// field counts of ops/types.py's DeviceState, Inbox and DeviceOut
constexpr int N_STATE = 31;
constexpr int N_INBOX = 12;
constexpr int N_OUT = 10;
// the routed step's outputs: DeviceOut's first three (buf, count, escalate)
constexpr int N_ROUTED_OUT = 3;
// the [G] and [G, P] sources of the flag word, in flags.cu's order
constexpr int N_FLAG_SRCS = 22;
// gather_pack: the detail sources and the values block's sources
constexpr int N_DETAIL_SRCS = 7;
constexpr int N_PACK_VALS = 10;
// place_rows: fields moved by one launch
constexpr int MAX_FIELDS = 32;
// route: the state sources (peer_id, replica_id, first_index,
// last_index, role, ring_term, ring_cc) and the stats vector (the six
// RouteStats, then the suppressed-row count)
constexpr int N_ROUTE_STATE = 7;
constexpr int N_ROUTE_STATS = 7;
// route: the election census (pre-vote and vote requests, granted pre-vote
// and vote responses), 64-bit counts a run adds to
constexpr int N_ROUTE_CENSUS = 4;
// xlane: the state sources (peer_id, replica_id, first_index,
// last_index, ring_term, ring_cc) and the lane stats row (the five
// CrossStats, then the suppressed and the live row counts)
constexpr int N_LANE_STATE = 6;
constexpr int N_LANE_STATS = 7;
// the colocated pack's stats row: the seven, then the refused messages
constexpr int N_LANE_STATS_X = 8;

// raft_step.cu's kernels: the full step in the external [G, ...] layout
// or in the G-last one, and the routed round's step (external layout:
// out[N_ROUTED_OUT ..] may be null, and of buf only each row's messages
// below its count are written)
enum StepKind { STEP_EXTERNAL = 0, STEP_INTERNAL = 1, STEP_ROUTED = 2 };

// raft_step.cu — every array in the field order of ops/types.py; blocks
// of rows_per_block rows (32, 64 or 128), the first `staged` (<= O) outbox
// messages of a row staged in shared memory
void raft_step_launch(const int* const* st_in, int* const* st_out,
                      const int* const* inbox, int* const* out, int G,
                      int P, int W, int M, int E, int O, StepKind kind,
                      int rows_per_block, int staged, void* stream);

// flags.cu — srcs: old term, vote, committed, leader_id, role,
// last_index; the same six of new; new peer_id, peer_kind, match,
// active, self_slot, check_quorum; out count, append_lo, escalate,
// need_snapshot.  undeliv (may be null): the colocated F_COUNT override
void summarize_flags_launch(const int* const* srcs, const int* undeliv,
                            int* flags, int G, int P, void* stream);

// gather_pack.cu — detail: buf, slot_base, slot_term, ent_drop,
// need_snapshot, ring_term, ring_cc; vals: the values block's sources in
// R_* order; idx4 is null when b = 0, idx_sum when b2 = 0
void gather_pack_launch(const int* const* detail, const int* const* vals,
                        const int* idx4, const int* idx_sum, int* flat,
                        int G, int O, int M, int E, int P, int W, int b,
                        int b2, void* stream);

// place_rows.cu, rows mode — dst may be null (a gather) and dst[f] may be
// null; width[f] is field f's words per row; every output is a view of
// one 16-byte aligned allocation `out`, field f at out + off[f] (a
// multiple of 4 words).  Returns 0, 1 (a misaligned output) or 2 (a tile
// too wide for int offsets); launches nothing but on 0
int place_rows_launch(const int* pos, const int* const* dst,
                      const int* const* src, int* out, const long long* off,
                      const int* width, int n_fields, int G_out, int G_src,
                      void* stream);

// place_rows.cu, in-place merge: new_f[g] = old_f[g] where escalate[g] !=
// 0; returns 0, or 2 (rows too wide for int offsets)
int merge_escalated_launch(const int* escalate, const int* const* old_,
                           int* const* new_, const int* width, int n_fields,
                           int G, void* stream);

// place_rows.cu, snapshot mode
void set_remote_snapshot_launch(const int* rstate, const int* snap_index,
                                const int* g_idx, const int* p_idx,
                                const int* snap, int* out_rstate,
                                int* out_snap, int G, int P, int n,
                                void* stream);

// route.cu — st: N_ROUTE_STATE sources; suppress, alive, base_inbox,
// packed, undeliv and delivered may be null; stats is zeroed and filled;
// scratch [G, P, B] and cnt [G, P] are the walk's workspace; census
// (N_ROUTE_CENSUS counts, added to, not zeroed) may be null, and then the
// walk is the kernel without it
void route_launch(const int* const* st, const int* buf, const int* count,
                  const int* dest_row, const int* rank, const int* suppress,
                  const int* alive, int alive_stride,
                  const int* const* base_inbox, int M_base,
                  int* const* inbox, int* stats, int* packed, int* undeliv,
                  unsigned char* delivered, int* scratch, int* cnt, int G,
                  int P, int W, int O, int M, int E, int B, int base,
                  int tick, int propose_leaders, int propose_n,
                  unsigned long long* census, void* stream);

// inbox.cu — every output inbox is one int32 allocation `out` laid out
// by inbox_layout.  Fill (from_ticks): every word 0 but slot 0 of mtype
// (MT_TICK where combo[g, 3] > 0) and of log_index (combo[g, 3]).  Copy
// (assemble, zero_rows): an output row is PA slots of region a then
// M - PA of region b (a may be null when PA = 0), zeroed where the row's
// lane word lane[g * lane_stride] is nonzero (alive_if = 0) or zero
// (alive_if = 1).  Each returns 0, 1 (out is not 16-byte aligned) or 2
// (too large for 32-bit word indexes) and launches nothing but on 0
int inbox_fill_launch(const int* combo, int* out, int G, int M, int E,
                      void* stream);
int inbox_copy_launch(const int* const* a, const int* const* b,
                      const int* lane, int lane_stride, int alive_if,
                      int* out, int G, int M, int E, int PA, void* stream);

// the word offset of each inbox plane in one allocation (field-major:
// the ten [G, M] planes, then the two [G, M, E]; each starts on a
// 16-byte boundary); returns the allocation's words
inline long long inbox_layout(int G, int M, int E, long long* off) {
  long long t = 0;
  for (int f = 0; f < N_INBOX; ++f) {
    off[f] = t;
    const long long n = (long long)G * M * (f >= 10 ? E : 1);
    t += (n + 3) & ~3LL;
  }
  return t;
}

// select_blob.cu — detail_srcs: buf, slot_base, slot_term, ent_drop,
// need_snapshot, ring_term, ring_cc; caps: buf, slot, need, append, sum;
// mask [G] bytes, btot and boff [ceil(G / 256), 5] are scratch.  Returns 0,
// or 2 (a detail row too wide for int offsets)
int select_blob_launch(const int* flags, const int* combo, const int* packed,
                       const int* stats, const int* const* detail_srcs,
                       int* head, int* detail, unsigned char* mask, int* btot,
                       int* boff, const int* caps, int G, int nw, int O,
                       int Mo, int E, int P, int W, int host_off,
                       void* stream);

// xlane.cu, pack — st: N_LANE_STATE sources; suppress may be null;
// xbuf [D, XB, 14 + 2E] and stats [n_stats] (N_LANE_STATS, or
// N_LANE_STATS_X with the refused count) are written whole; rowoff
// [G, D], btot [nblk, D], boff [nblk, D], part [nblk, 5] and tot [D] are
// workspace (nblk = the blocks of rows_per_block rows: 32, 64 or 128).
// The colocated operands may be null: alive (the receivers' words at
// (dest_dev * G + dest_local) * alive_stride), and packed [G, ceil(O/32)]
// and undeliv [G], updated in place (both or neither)
void xlane_pack_launch(const int* const* st, const int* buf,
                       const int* count, const int* suppress,
                       const int* dest_local, const int* dest_dev,
                       const int* rank, int* xbuf, int* rowoff, int* btot,
                       int* boff, int* part, int* tot, int* stats,
                       int n_stats, const int* alive, int alive_stride,
                       int* packed, int* undeliv, int G, int P, int W, int O,
                       int E, int D, int XB, int B, int me,
                       int rows_per_block, void* stream);

// xlane.cu, scatter — adds the R received rows into inbox (in place) and
// writes the delivered count into stats[1]
void xlane_scatter_launch(int* const* inbox, const int* recv, int* stats,
                          int R, int G, int M, int E, int B, int base,
                          void* stream);

}  // namespace dbt
