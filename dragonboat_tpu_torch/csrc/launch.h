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
// the [G] and [G, P] sources of the flag word, in flags.cu's order
constexpr int N_FLAG_SRCS = 22;
// gather_pack: the detail sources and the values block's sources
constexpr int N_DETAIL_SRCS = 7;
constexpr int N_PACK_VALS = 10;
// place_rows: fields moved by one launch
constexpr int MAX_FIELDS = 32;

// raft_step.cu — every array in the field order of ops/types.py
void raft_step_launch(const int* const* st_in, int* const* st_out,
                      const int* const* inbox, int* const* out, int G,
                      int P, int W, int M, int E, int O,
                      void* stream);

// flags.cu — srcs: old term, vote, committed, leader_id, role,
// last_index; the same six of new; new peer_id, peer_kind, match,
// active, self_slot, check_quorum; out count, append_lo, escalate,
// need_snapshot
void summarize_flags_launch(const int* const* srcs, int* flags, int G,
                            int P, void* stream);

// gather_pack.cu — detail: buf, slot_base, slot_term, ent_drop,
// need_snapshot, ring_term, ring_cc; vals: the values block's sources in
// R_* order; idx4 is null when b = 0, idx_sum when b2 = 0
void gather_pack_launch(const int* const* detail, const int* const* vals,
                        const int* idx4, const int* idx_sum, int* flat,
                        int G, int O, int M, int E, int P, int W, int b,
                        int b2, void* stream);

// place_rows.cu, rows mode — dst[f] may be null (a gather); width[f] is
// field f's words per row
void place_rows_launch(const int* pos, const int* const* dst,
                       const int* const* src, int* const* out,
                       const int* width, int n_fields, int G_out, int G_src,
                       void* stream);

// place_rows.cu, snapshot mode
void set_remote_snapshot_launch(const int* rstate, const int* snap_index,
                                const int* g_idx, const int* p_idx,
                                const int* snap, int* out_rstate,
                                int* out_snap, int G, int P, int n,
                                void* stream);

}  // namespace dbt
