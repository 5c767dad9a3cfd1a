// Block-level helpers that place_rows.cu, select_blob.cu and xlane.cu
// share.
//
// * FastDiv: n / d and n % d for 0 <= n < 2^31 and a divisor fixed per
//   launch, as one 32 x 32 -> 64-bit multiply and a shift (the
//   Granlund-Montgomery round-up method: p = 31 + ceil(log2 d),
//   m = ceil(2^p / d) < 2^32, exact for every n below 2^31).  The kernels
//   never divide on the device.
// * Quad: four consecutive int32 words, moved as one 16-byte load or
//   store on the card where the address allows it.
// * bits_below: a lane's rank among the set bits of a warp's ballot.
// * seg_of: the segment of a flattened index in a prefix table (a
//   binary search over at most 33 entries).
// * warp_incl_scan (card only): the inclusive sum over a warp's lanes.
//
// Without __CUDACC__ everything but warp_incl_scan is plain host code, so
// the kernels' block logic built with g++ runs the same arithmetic.
#pragma once

#include "common.cuh"

namespace dbt {

struct FastDiv {
  uint32_t mul;
  int shift;
  int d;
};

// host side: the multiplier and shift of divisor d >= 1
inline FastDiv fast_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  FastDiv f;
  f.d = d;
  f.shift = 31 + l;
  f.mul = (uint32_t)(((1ULL << f.shift) + (uint64_t)d - 1) / (uint64_t)d);
  return f;
}

// n / f.d for 0 <= n < 2^31
DBT_HD int fdiv(const FastDiv& f, int n) {
  return (int)(((uint64_t)(uint32_t)n * f.mul) >> f.shift);
}

struct Quad {
  int v[4];
};

DBT_HD bool is_aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

#ifndef __CUDA_ARCH__
// host build: the 16-byte loads and stores made at an address the card
// would fault on (a host check reads it and requires 0)
inline long long& misaligned_quads() {
  static long long n = 0;
  return n;
}
#endif

// p must be 16-byte aligned
DBT_HD Quad load4(const int* p) {
  Quad q;
#ifdef __CUDA_ARCH__
  const int4 x = *reinterpret_cast<const int4*>(p);
  q.v[0] = x.x;
  q.v[1] = x.y;
  q.v[2] = x.z;
  q.v[3] = x.w;
#else
  misaligned_quads() += !is_aligned16(p);
  for (int k = 0; k < 4; ++k) q.v[k] = p[k];
#endif
  return q;
}

DBT_HD void store4(int* p, const Quad& q) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(p) = make_int4(q.v[0], q.v[1], q.v[2], q.v[3]);
#else
  misaligned_quads() += !is_aligned16(p);
  for (int k = 0; k < 4; ++k) p[k] = q.v[k];
#endif
}

// the set bits of m below bit `lane` (a lane's rank in a warp's ballot)
DBT_HD int bits_below(uint32_t m, int lane) {
  const uint32_t x = m & ((1u << lane) - 1u);
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// the largest i in [0, n) with pre[i] <= j (pre ascending, pre[0] <= j)
DBT_HD int seg_of(const int* pre, int n, int j) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= j)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

#ifdef __CUDACC__
// inclusive sum of v over the warp's lanes 0..lane
__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  return v;
}
#endif

}  // namespace dbt
