// Shared device helpers of the checksum and snapshot kernels.
//
// The digest of a row of uint32 words x[0..wpc) is the pair
//     s1 = sum_j x[j]            (mod 2^32)
//     s2 = sum_j (j + 1) * x[j]  (mod 2^32)
// Native uint32 arithmetic wraps mod 2^32, and both sums are plain sums of
// per-element terms, so any split of a row across threads and blocks,
// combined with uint32 adds (warp shuffles, atomicAdd), gives the same
// bits in any order.  Both kernels take their per-tile sums from
// tile_sums(), so the snapshot kernel's digest columns equal the checksum
// kernel's digest of the same bytes by construction.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace craft {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 32;                  // 8 uint4 loads
constexpr long long kTile = kThreads * kWordsPerThread;   // 8192 words

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; the result is valid in thread 0 only.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? scratch[threadIdx.x] : 0u;
  if (warp == 0) v = warp_sum(v);
  __syncthreads();                                    // scratch reusable
  return v;
}

// The digest terms of words [lo, hi) of one row, for this thread.  In the
// vector path the row start and `lo` are 16-byte aligned and hi - lo is a
// multiple of 4.  `visit` sees every word this thread reads (the snapshot
// kernel's histogram); the checksum kernel passes a no-op.
template <bool kVec, typename Visit>
__device__ __forceinline__ void tile_sums(const uint32_t* __restrict__ row,
                                          long long lo, long long hi,
                                          uint32_t& s1, uint32_t& s2,
                                          Visit visit) {
  if (kVec) {
    for (long long j = lo + 4 * threadIdx.x; j < hi; j += 4 * kThreads) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + j));
      const uint32_t p = static_cast<uint32_t>(j) + 1u;
      s1 += v.x + v.y + v.z + v.w;
      s2 += p * v.x + (p + 1u) * v.y + (p + 2u) * v.z + (p + 3u) * v.w;
      visit(v.x); visit(v.y); visit(v.z); visit(v.w);
    }
  } else {
    for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
      const uint32_t v = __ldg(row + j);
      s1 += v;
      s2 += (static_cast<uint32_t>(j) + 1u) * v;
      visit(v);
    }
  }
}

}  // namespace craft
