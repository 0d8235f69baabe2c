// Fused per-chunk snapshot pass: [s1, s2, dirty, hist[0..15]] per row of a
// (n_chunks, wpc) uint32 matrix (or [s1, s2, dirty] without the histogram).
//
// Replaces the Pallas TPU kernel repro/kernels/snapshot/kernel.py::snapshot.
//
// Bound: device-memory bytes without the histogram.  With it, each word
// also feeds eight nibble counts, so the pass may become bound by the
// shared-memory increments rather than by the bytes.  Design:
//   * digest: the checksum kernel's tile_sums() (fletcher.cuh), one block
//     per 8192-word tile, block reduce by warp shuffles, uint32 atomicAdd
//     into the zeroed output row — exact and order-free mod 2^32;
//   * histogram: each thread counts into its own column of a 16 x 256
//     shared-memory table (bank = thread lane whatever the nibble, so no
//     bank conflicts and no atomics), where the Pallas body needs sixteen
//     compare-and-sum passes per tile; the columns are reduced with warp
//     shuffles and added to the output with atomicAdd;
//   * dirty: the TPU kernel resolves it on a chunk's last grid step, which
//     relies on the grid running in order.  Here blocks run in any order,
//     so the dirty column doubles as a per-row arrival counter: after its
//     digest atomics (fenced), each block increments it, and the block that
//     arrives last reads the finished sums and overwrites the counter with
//     (s1, s2) != prev.
#include "fletcher.cuh"

namespace {

constexpr int kBins = 16;

struct NoVisit {
  __device__ __forceinline__ void operator()(uint32_t) const {}
};

struct NibbleVisit {
  uint32_t* col;   // this thread's column: col[bin * kThreads]
  __device__ __forceinline__ void operator()(uint32_t w) const {
#pragma unroll
    for (int sh = 0; sh < 32; sh += 4) col[((w >> sh) & 15u) * craft::kThreads]++;
  }
};

template <bool kVec, bool kHist>
__global__ void __launch_bounds__(craft::kThreads)
snapshot_kernel(const uint32_t* __restrict__ words,
                const uint32_t* __restrict__ prev,
                uint32_t* __restrict__ out, long long wpc,
                long long tiles_per_row, int width) {
  __shared__ uint32_t scratch[craft::kThreads / 32];
  __shared__ uint32_t hist[kHist ? kBins * craft::kThreads : 1];
  __shared__ uint32_t bins[kBins];
  const long long row = blockIdx.x / tiles_per_row;
  const long long tile = blockIdx.x % tiles_per_row;
  const long long lo = tile * craft::kTile;
  const long long hi = lo + craft::kTile < wpc ? lo + craft::kTile : wpc;
  uint32_t* orow = out + row * width;

  uint32_t s1 = 0u, s2 = 0u;
  if (kHist) {
#pragma unroll
    for (int k = 0; k < kBins; ++k) hist[k * craft::kThreads + threadIdx.x] = 0u;
    if (threadIdx.x < kBins) bins[threadIdx.x] = 0u;
    craft::tile_sums<kVec>(words + row * wpc, lo, hi, s1, s2,
                           NibbleVisit{hist + threadIdx.x});
  } else {
    craft::tile_sums<kVec>(words + row * wpc, lo, hi, s1, s2, NoVisit{});
  }
  s1 = craft::block_sum(s1, scratch);     // its __syncthreads also orders
  s2 = craft::block_sum(s2, scratch);     // the bins[] zeroing above

  if (kHist) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kBins; ++k) {
      const uint32_t c = craft::warp_sum(hist[k * craft::kThreads + threadIdx.x]);
      if (lane == 0 && c) atomicAdd(bins + k, c);
    }
    __syncthreads();
    if (threadIdx.x < kBins && bins[threadIdx.x])
      atomicAdd(orow + 3 + threadIdx.x, bins[threadIdx.x]);
  }

  if (threadIdx.x == 0) {
    atomicAdd(orow, s1);
    atomicAdd(orow + 1, s2);
    __threadfence();                       // sums visible before arrival
    const uint32_t arrived = atomicAdd(orow + 2, 1u);
    if (arrived == static_cast<uint32_t>(tiles_per_row - 1)) {
      __threadfence();
      const uint32_t a = atomicAdd(orow, 0u);      // coherent L2 reads
      const uint32_t b = atomicAdd(orow + 1, 0u);
      orow[2] = (a != prev[2 * row] || b != prev[2 * row + 1]) ? 1u : 0u;
    }
  }
}

template <bool kVec>
void launch(bool with_hist, unsigned blocks, cudaStream_t s,
            const uint32_t* w, const uint32_t* p, uint32_t* o,
            long long wpc, long long tiles, int width) {
  if (with_hist) {
    snapshot_kernel<kVec, true><<<blocks, craft::kThreads, 0, s>>>(
        w, p, o, wpc, tiles, width);
  } else {
    snapshot_kernel<kVec, false><<<blocks, craft::kThreads, 0, s>>>(
        w, p, o, wpc, tiles, width);
  }
}

}  // namespace

// words: (n_chunks, wpc) 32-bit words; prev: (n_chunks, 2) digests of the
// previous snapshot; out: (n_chunks, 19 or 3) zero-initialised.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int craft_snapshot(const void* words, const void* prev, void* out,
                              long long n_chunks, long long wpc,
                              int with_hist, void* stream) {
  if (n_chunks <= 0 || wpc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (wpc + craft::kTile - 1) / craft::kTile;
  const long long blocks = n_chunks * tiles;
  if (blocks > 0x7fffffffLL || tiles > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = with_hist ? 3 + kBins : 3;
  const bool vec = wpc % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(words) % 16 == 0;
  auto* w = static_cast<const uint32_t*>(words);
  auto* p = static_cast<const uint32_t*>(prev);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (vec) {
    launch<true>(with_hist != 0, nb, s, w, p, o, wpc, tiles, width);
  } else {
    launch<false>(with_hist != 0, nb, s, w, p, o, wpc, tiles, width);
  }
  return static_cast<int>(cudaGetLastError());
}
