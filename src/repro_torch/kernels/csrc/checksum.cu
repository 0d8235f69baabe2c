// Per-row Fletcher digest [s1, s2] of a (rows, wpc) uint32 matrix.
//
// Replaces the Pallas TPU kernel repro/kernels/checksum/kernel.py::checksum
// (1-D blocked form) and the batched jnp form
// repro/kernels/checksum/ops.py::_rows_checksum: a 1-D digest is rows = 1.
//
// Bound: device-memory bytes.  Every word is read once and takes three
// integer operations, far below the card's integer rate.  Design: each
// block reduces one tile of 8192 words of one row (16-byte loads through
// the read-only path), reduces across the block with warp shuffles, and
// adds its two sums into the zeroed output row with uint32 atomicAdd,
// which is exact and order-free mod 2^32.  The TPU kernel's sequential
// grid with a carried accumulator has no counterpart here: blocks run in
// any order, so the position weight is the element's index in its row,
// computed from the tile offset, instead of a per-block `s2 += off * s1`
// shift.  Any wpc is accepted (no block-size divisibility); the vector
// path needs wpc % 4 == 0 and a 16-byte aligned base.
#include "fletcher.cuh"

namespace {

struct NoVisit {
  __device__ __forceinline__ void operator()(uint32_t) const {}
};

template <bool kVec>
__global__ void __launch_bounds__(craft::kThreads)
checksum_rows_kernel(const uint32_t* __restrict__ words,
                     uint32_t* __restrict__ out, long long wpc,
                     long long tiles_per_row) {
  __shared__ uint32_t scratch[craft::kThreads / 32];
  const long long row = blockIdx.x / tiles_per_row;
  const long long tile = blockIdx.x % tiles_per_row;
  const long long lo = tile * craft::kTile;
  const long long hi = lo + craft::kTile < wpc ? lo + craft::kTile : wpc;
  uint32_t s1 = 0u, s2 = 0u;
  craft::tile_sums<kVec>(words + row * wpc, lo, hi, s1, s2, NoVisit{});
  s1 = craft::block_sum(s1, scratch);
  s2 = craft::block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    atomicAdd(out + 2 * row, s1);
    atomicAdd(out + 2 * row + 1, s2);
  }
}

}  // namespace

// words: (rows, wpc) 32-bit words; out: (rows, 2) zero-initialised.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int craft_checksum_rows(const void* words, void* out,
                                   long long rows, long long wpc,
                                   void* stream) {
  if (rows <= 0 || wpc <= 0) return 0;
  const long long tiles = (wpc + craft::kTile - 1) / craft::kTile;
  const long long blocks = rows * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = wpc % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(words) % 16 == 0;
  auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    checksum_rows_kernel<true><<<static_cast<unsigned>(blocks),
                                 craft::kThreads, 0, s>>>(w, o, wpc, tiles);
  } else {
    checksum_rows_kernel<false><<<static_cast<unsigned>(blocks),
                                  craft::kThreads, 0, s>>>(w, o, wpc, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
