// The sub-warp walk of a row's outbox that route.cu and xlane.cu share.
//
// A sub-warp of WALK_LANES lanes walks one row's outbox, one lane a
// message, in chunks of WALK_LANES messages; a warp walks 32 / WALK_LANES
// rows at once.  Eight lanes a row measured faster than 16 and 32 at every
// geometry of the repo on the H100 (PERF.md, section 6): the walks wait on
// their loads, and more rows a warp keep more of them in flight.
//
// The lanes of a sub-warp share what they know in two ways: a mask (bit
// i for the sub-warp's lane i whose predicate holds) and LaneWords (up
// to 2 * WALK_LANES counters, or a row's peer-slot values, spread over
// the lanes).  On the card the masks are ballots (`sub_ballot`) and
// LaneWords reads are shuffles.  Without __CUDACC__ this is host code:
// LaneWords is a plain array, and `host_lane_ranks` runs a sub-warp lane
// by lane with each mask made from the lanes' predicates.  Everything
// past the masks, `lane_rank` included, is the same code in both builds.
#pragma once

#include "common.cuh"

#ifdef __CUDACC__
// a step that reads LaneWords: on the card its reads are shuffles
#define DBT_LANE __device__ __forceinline__
#else
#define DBT_LANE inline
#endif

namespace dbt {

constexpr int WALK_LANES = 8;
// a row's 16 peer slots and a lane's 16 devices fit two words a lane
static_assert(2 * WALK_LANES >= 16, "LaneWords holds 16 values");

// set bits of a lane mask
DBT_HD int popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// The lanes below `lane` whose bit is set in `mask`.
DBT_HD int excl_count(uint32_t mask, int lane) {
  return popc(mask & ((1u << lane) - 1u));
}

#ifdef __CUDACC__
// the ballot of `pred` over the sub-warp that holds this thread; every
// lane of the warp calls it (a lane with nothing to say passes false)
__device__ __forceinline__ uint32_t sub_ballot(bool pred) {
  const uint32_t b = __ballot_sync(0xffffffffu, pred);
  return (b >> ((threadIdx.x & 31) & ~(WALK_LANES - 1))) &
         ((1u << WALK_LANES) - 1u);
}

// Up to 2 * WALK_LANES values of a sub-warp in two registers a lane:
// value i is held by the sub-warp's lane i % WALK_LANES, in `lo` below
// WALK_LANES, else in `hi`.  `get` reads a value the whole warp names
// alike, `pick` one each lane names for itself; every lane of the warp
// calls them.
struct LaneWords {
  int lo = 0, hi = 0;
  __device__ __forceinline__ int src(int i) const {
    return ((threadIdx.x & 31) & ~(WALK_LANES - 1)) + (i & (WALK_LANES - 1));
  }
  __device__ __forceinline__ int get(int i) const {
    return __shfl_sync(0xffffffffu, i < WALK_LANES ? lo : hi, src(i));
  }
  __device__ __forceinline__ int pick(int i) const {
    const int vlo = __shfl_sync(0xffffffffu, lo, src(i));
    const int vhi = __shfl_sync(0xffffffffu, hi, src(i));
    return i < WALK_LANES ? vlo : vhi;
  }
  __device__ __forceinline__ void add(int i, int n) {
    if ((threadIdx.x & (WALK_LANES - 1)) == (i & (WALK_LANES - 1)))
      (i < WALK_LANES ? lo : hi) += n;
  }
  // value i on its holder lane
  __device__ __forceinline__ int held(int i) const {
    return i < WALK_LANES ? lo : hi;
  }
};
#else
// The host's LaneWords: every value in one array, seen by every lane.
struct LaneWords {
  int v[2 * WALK_LANES] = {};
  int get(int i) const { return v[i]; }
  int pick(int i) const { return v[i]; }
  void add(int i, int n) { v[i] += n; }
  int held(int i) const { return v[i]; }
};
#endif

// One chunk's step over n counters (a row's peer slots, or the devices
// of the lane): bit i of `in` says whether this lane's message adds to
// counter i, `ballot(i, bit)` gives the mask of the sub-warp's lanes whose
// message does, and `before` holds each counter's messages from the
// earlier chunks, which it advances by this chunk's.  Returns the lane's
// rank at its last counter: the messages before it that add to it (the
// reference's exclusive cumsum).  Every lane of the sub-warp calls it
// with the same n.
template <class Ballot>
DBT_LANE int lane_rank(int n, uint32_t in, int lane, Ballot ballot,
                       LaneWords& before) {
  int rank = 0;
  for (int i = 0; i < n; ++i) {
    const bool mine = (in >> i) & 1u;
    const uint32_t m = ballot(i, mine);
    const int b = before.get(i);
    if (mine) rank = b + excl_count(m, lane);
    before.add(i, popc(m));
  }
  return rank;
}

#ifndef __CUDACC__
// lane_rank for each lane of a sub-warp, run lane by lane on the host:
// bit l of mask i is bit i of lane l's `in` (the ballot the card takes),
// and each lane starts from the counters as the chunk found them; rank[l]
// for lane l.  `before` is advanced as on the card.
inline void host_lane_ranks(int n, const uint32_t* in, LaneWords& before,
                            int* rank) {
  uint32_t m[2 * WALK_LANES];
  for (int i = 0; i < n; ++i) {
    m[i] = 0;
    for (int l = 0; l < WALK_LANES; ++l) m[i] |= ((in[l] >> i) & 1u) << l;
  }
  LaneWords after = before;
  for (int l = 0; l < WALK_LANES; ++l) {
    LaneWords mine = before;
    rank[l] = lane_rank(n, in[l], l, [&](int i, bool) { return m[i]; }, mine);
    after = mine;
  }
  before = after;
}
#endif

}  // namespace dbt
