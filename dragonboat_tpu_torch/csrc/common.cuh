// Shared constants and helpers for the port's CUDA kernels.
//
// The constants mirror dragonboat_tpu_torch/ops/types.py one for one;
// tests/test_torch_types.py parses every `constexpr int NAME = VALUE;`
// line of this file and holds it against the Python value, so the two
// cannot drift apart.
//
// Every file that includes this header also compiles as plain C++ (no
// __CUDACC__): the per-row logic is then host code, which keeps it
// checkable with an ordinary compiler.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DBT_HD __host__ __device__ inline
#else
#define DBT_HD inline
#endif

namespace dbt {

// message types (pb.MessageType)
constexpr int MT_NOOP = 0;
constexpr int MT_TICK = 1;
constexpr int MT_ELECTION = 2;
constexpr int MT_PROPOSE = 3;
constexpr int MT_REPLICATE = 4;
constexpr int MT_REPLICATE_RESP = 5;
constexpr int MT_REQUEST_VOTE = 6;
constexpr int MT_REQUEST_VOTE_RESP = 7;
constexpr int MT_REQUEST_PREVOTE = 8;
constexpr int MT_REQUEST_PREVOTE_RESP = 9;
constexpr int MT_HEARTBEAT = 10;
constexpr int MT_HEARTBEAT_RESP = 11;
constexpr int MT_READ_INDEX = 12;
constexpr int MT_READ_INDEX_RESP = 13;
constexpr int MT_INSTALL_SNAPSHOT = 14;
constexpr int MT_SNAPSHOT_STATUS = 15;
constexpr int MT_SNAPSHOT_RECEIVED = 16;
constexpr int MT_UNREACHABLE = 17;
constexpr int MT_LEADER_TRANSFER = 18;
constexpr int MT_TIMEOUT_NOW = 19;
constexpr int MT_CHECK_QUORUM = 21;

// roles (raft.RaftRole)
constexpr int ROLE_FOLLOWER = 0;
constexpr int ROLE_PRE_CANDIDATE = 1;
constexpr int ROLE_CANDIDATE = 2;
constexpr int ROLE_LEADER = 3;
constexpr int ROLE_NON_VOTING = 4;
constexpr int ROLE_WITNESS = 5;

// remote states (raft.RemoteState)
constexpr int RS_RETRY = 0;
constexpr int RS_WAIT = 1;
constexpr int RS_REPLICATE = 2;
constexpr int RS_SNAPSHOT = 3;

// peer slot kinds
constexpr int KIND_VOTER = 0;
constexpr int KIND_NON_VOTING = 1;
constexpr int KIND_WITNESS = 2;

// escalation bits
constexpr int ESC_WINDOW = 1;
constexpr int ESC_OVERFLOW = 2;
constexpr int ESC_COLD = 4;
constexpr int ESC_INVARIANT = 8;

// slot_base sentinels
constexpr int SLOT_UNUSED = -3;
constexpr int SLOT_FORWARDED = -2;
constexpr int SLOT_DROPPED = -1;

// outbox buffer fields
constexpr int F_MTYPE = 0;
constexpr int F_TO = 1;
constexpr int F_TERM = 2;
constexpr int F_LOG_TERM = 3;
constexpr int F_LOG_INDEX = 4;
constexpr int F_COMMIT = 5;
constexpr int F_REJECT = 6;
constexpr int F_HINT = 7;
constexpr int F_HINT_HIGH = 8;
constexpr int F_N_ENTRIES = 9;
constexpr int F_SRC_SLOT = 10;
constexpr int N_FIELDS = 11;

constexpr int APPEND_LO_NONE = 2147483647;

// flag-word bits (engine._summarize_flags)
constexpr int F_CHANGED = 1;
constexpr int F_COUNT = 2;
constexpr int F_APPEND = 4;
constexpr int F_NEED_SS = 8;
constexpr int F_ESC = 16;
constexpr int F_PEERS_BEHIND = 32;
constexpr int F_QUORUM_ACTIVE = 64;

// values block width (engine._gather_vals)
constexpr int N_VALS = 10;

// int32 arithmetic that wraps like the JAX program (signed overflow is
// undefined in C++, so sums go through uint32_t)
DBT_HD int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
DBT_HD int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
DBT_HD int imax(int a, int b) { return a > b ? a : b; }
DBT_HD int imin(int a, int b) { return a < b ? a : b; }

}  // namespace dbt
