// GF(2^8) product of an (R, G) byte matrix with a (G, N) uint32 matrix whose
// words pack four field elements each (poly 0x11B):
//     out[r][j] = XOR_i  M[r][i] * x[i][j]      (bytewise in each word)
//
// Replaces the Pallas TPU kernel repro/kernels/rs_erasure/kernel.py::
// gf_matmul: Reed-Solomon encode, the decode syndrome pass and the erasure
// solve are this one primitive with different matrices.
//
// The field product.  The Pallas kernel bakes the (static) matrix into its
// body as unrolled xtime chains; here the matrix is a runtime argument, so
// each coefficient c is applied as the same SWAR chain in a loop over its
// bits: c * x = XOR_{b : bit b of c} xtime^b(x), where xtime multiplies the
// four bytes of a word by 2 at once (shift masked with 0xFEFEFEFE so no bit
// crosses into the next byte, 0x1B added to exactly the bytes whose high
// bit was set; 0/1 byte mask times 0x1B never carries).  This gives the
// reference's bits for every matrix, and needs no tables: the alternative,
// a 256-byte log/exp table in shared memory, costs two dependent gathers
// and a zero test per byte (eight per word) where the chain costs six
// word-wide operations per bit of c.  The matrix is copied into shared
// memory once per block; every thread reads the same coefficient at the
// same time, so the loads broadcast and the bit loop's branches are
// uniform across the warp.
//
// Bound: for the matrices of the node tier, device-memory bytes: (G + R) *
// N * 4 bytes move once, while the chains cost at most 6 * 7 + 8 operations
// per coefficient and word.  Design: a grid-stride loop in which each
// thread owns one 16-byte column (uint4) of every row and produces the R
// output words of that column; the G input words are re-read for each
// output row, from L1/L2 (the thread read them a moment ago).  A width
// that is not a multiple of 4 words, or an unaligned base, takes the
// scalar loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;
// R * G bytes in shared memory; kernel.py's MAX_COEF must match
constexpr int kMaxCoef = 4096;

__device__ __forceinline__ uint32_t xtime(uint32_t x) {
  return ((x << 1) & 0xFEFEFEFEu) ^ (((x >> 7) & 0x01010101u) * 0x1Bu);
}

__device__ __forceinline__ uint4 xtime(uint4 v) {
  return make_uint4(xtime(v.x), xtime(v.y), xtime(v.z), xtime(v.w));
}

__device__ __forceinline__ void xor_into(uint32_t& acc, uint32_t v) {
  acc ^= v;
}

__device__ __forceinline__ void xor_into(uint4& acc, uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ uint32_t zero<uint32_t>() { return 0u; }
template <>
__device__ __forceinline__ uint4 zero<uint4>() { return make_uint4(0, 0, 0, 0); }

// acc ^= c * v for a non-zero coefficient c (uniform across the warp).
template <typename T>
__device__ __forceinline__ void mul_acc(uint32_t c, T v, T& acc) {
  while (true) {
    if (c & 1u) xor_into(acc, v);
    c >>= 1;
    if (c == 0u) break;
    v = xtime(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mat,
                 T* __restrict__ out, int r, int g, long long n) {
  __shared__ uint8_t coef[kMaxCoef];
  for (int t = threadIdx.x; t < r * g; t += kThreads) coef[t] = mat[t];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       j < n; j += stride) {
    for (int row = 0; row < r; ++row) {
      T acc = zero<T>();
      for (int i = 0; i < g; ++i) {
        const uint32_t c = coef[row * g + i];
        if (c != 0u) mul_acc(c, x[i * n + j], acc);
      }
      out[row * n + j] = acc;
    }
  }
}

unsigned blocks_for(long long items) {
  long long b = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// stacked: (g, n) 32-bit words; matrix: (r, g) bytes on the device;
// out: (r, n) words.  Returns the cudaError_t of the launch (0 on success).
extern "C" int craft_gf_matmul(const void* stacked, const void* matrix,
                               void* out, int r, int g, long long n,
                               void* stream) {
  if (r <= 0 || g <= 0 || static_cast<long long>(r) * g > kMaxCoef)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<const uint8_t*>(matrix);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(stacked) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const long long n4 = n / 4;
    gf_matmul_kernel<uint4><<<blocks_for(n4), kThreads, 0, s>>>(
        static_cast<const uint4*>(stacked), m, static_cast<uint4*>(out), r, g,
        n4);
  } else {
    gf_matmul_kernel<uint32_t><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(stacked), m,
        static_cast<uint32_t*>(out), r, g, n);
  }
  return static_cast<int>(cudaGetLastError());
}
