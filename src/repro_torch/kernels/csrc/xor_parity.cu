// XOR-reduce of a (G, N) uint32 matrix over its group axis: out[j] =
// x[0][j] ^ x[1][j] ^ ... ^ x[G-1][j].
//
// Replaces the Pallas TPU kernel repro/kernels/xor_parity/kernel.py::
// xor_reduce: the node tier's XOR parity encode and single-loss rebuild.
//
// Bound: device-memory bytes.  Each word is read once and takes one XOR, so
// the pass moves (G + 1) * N * 4 bytes and nothing else matters.  Design:
// a grid-stride loop in which each thread owns one 16-byte column (a uint4
// of four words) and XORs it down the G rows; neighbouring threads read
// neighbouring 16-byte slots of every row, so each row is streamed with
// full-width coalesced loads.  No state is shared between threads, so block
// order is irrelevant (the TPU kernel's grid carries nothing either).  A
// row width that is not a multiple of 4 words, or a base that is not
// 16-byte aligned, takes the scalar loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;    // 8 resident blocks per SM

__global__ void __launch_bounds__(kThreads)
xor_reduce_vec(const uint4* __restrict__ x, uint4* __restrict__ out, int g,
               long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       j < n4; j += stride) {
    uint4 acc = x[j];
    for (int r = 1; r < g; ++r) {
      const uint4 v = x[r * n4 + j];
      acc.x ^= v.x;
      acc.y ^= v.y;
      acc.z ^= v.z;
      acc.w ^= v.w;
    }
    out[j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
xor_reduce_scalar(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  int g, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       j < n; j += stride) {
    uint32_t acc = x[j];
    for (int r = 1; r < g; ++r) acc ^= x[r * n + j];
    out[j] = acc;
  }
}

unsigned blocks_for(long long items) {
  long long b = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// stacked: (g, n) 32-bit words, row-major; out: (n,) words.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int craft_xor_reduce(const void* stacked, void* out, long long g,
                                long long n, void* stream) {
  if (g <= 0 || g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(stacked) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const long long n4 = n / 4;
    xor_reduce_vec<<<blocks_for(n4), kThreads, 0, s>>>(
        static_cast<const uint4*>(stacked), static_cast<uint4*>(out),
        static_cast<int>(g), n4);
  } else {
    xor_reduce_scalar<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(stacked), static_cast<uint32_t*>(out),
        static_cast<int>(g), n);
  }
  return static_cast<int>(cudaGetLastError());
}
