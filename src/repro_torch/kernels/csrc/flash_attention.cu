// Blocked attention forward with an online softmax (flash attention).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention: out = softmax(q k^T * scale + mask) v with float32
// accumulation.  GQA: query head h reads kv head h / (Hq / Hkv).  Masks:
// causal (kpos <= qpos), sliding window (kpos > qpos - window), kv_len
// (kpos < kv_len), with qpos = q_offset + query row.  A row with no
// unmasked key returns 0.
//
// Bound: at the serving path's prefill shapes (L = 8192, D = 80) the two
// products per tile make it compute-bound (~4 D flops per unmasked pair
// against 2 bytes per element read once); at decode (Lq = 1) it is bound by
// reading the K/V cache.  This first version runs on scalar float32 FMAs,
// not the tensor cores (wgmma/TMA are for a later redesign).
//
// Design.  The TPU kernel carries m, l and the accumulator across a
// sequential grid axis over k blocks; here that axis is a loop inside the
// block.  One block of 256 threads owns one (batch, q head, 64-row q tile).
// The q tile is staged once in shared memory as float32, transposed
// (qt[d][row]); each step stages a 64-key K tile (transposed, kt[d][key])
// and V tile (vs[key][d]).  Thread (tr, tc) = (tid / 16, tid % 16) owns q
// rows 4 tr .. 4 tr + 3: it computes their scores against keys tc + 16 j
// (j < 4) and their outputs at dims tc + 16 j (j < 8, D <= 128), so a row's
// running max, denominator and accumulator live in the registers of the 16
// lanes of one half-warp and the row reductions are 4 shuffles.  Padded
// strides (+1) keep the transposed stores and the column reads free of bank
// conflicts.  K tiles wholly outside the causal / window / kv_len range of
// the q tile are never loaded; the ragged edge (Lk, Lq not multiples of 64)
// is masked in the kernel, with no padded copies.  Groups of rows past Lq
// (decode: Lq = 1) skip the arithmetic.  D is a run-time argument (80 on
// the path: scalar loads, so no 16-byte alignment is assumed).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr int kDMax = 128;
constexpr int kRows = 4;       // q rows per thread
constexpr int kCols = kBK / 16;    // score columns per thread
constexpr int kDims = kDMax / 16;  // output dims per thread

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, lq, lk, d;
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl;
  float scale;
  int causal, window, q_offset, kv_len;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(d) * (kBQ + 1) +
                          static_cast<size_t>(d) * (kBK + 1) +
                          static_cast<size_t>(kBK) * d +
                          static_cast<size_t>(kBK) * (kBQ + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  extern __shared__ float smem[];
  const int D = a.d;
  float* qt = smem;                      // [D][kBQ + 1]
  float* kt = qt + D * (kBQ + 1);        // [D][kBK + 1]
  float* vs = kt + D * (kBK + 1);        // [kBK][D]
  float* ps = vs + kBK * D;              // [kBK][kBQ + 1]

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int nq = min(kBQ, a.lq - q0);

  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh +
                static_cast<long long>(q0) * a.qsl;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, dd = i - r * D;
    qt[dd * (kBQ + 1) + r] =
        r < nq ? to_f(qp[static_cast<long long>(r) * a.qsl + dd]) : 0.f;
  }

  // keys any row of this tile can see
  const int qlo = a.q_offset + q0, qhi = a.q_offset + q0 + nq - 1;
  const int k_lim = min(a.lk, a.kv_len);
  int k_end = k_lim;
  if (a.causal) k_end = min(k_end, qhi + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, qlo - a.window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }
  const bool active = tr * kRows < nq;       // uniform in a half-warp
  const unsigned half = 0xffffu << (tid & 16);

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                 // the previous tile's readers are done
    const int nk = min(kBK, a.lk - k0);
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, dd = i - c * D;
      float kv = 0.f, vv = 0.f;
      if (c < nk) {
        const long long row = k0 + c;
        kv = to_f(kp[row * a.ksl + dd]);
        vv = to_f(vp[row * a.vsl + dd]);
      }
      kt[dd * (kBK + 1) + c] = kv;
      vs[c * D + dd] = vv;
    }
    __syncthreads();

    if (active) {
      float s[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = qt[dd * (kBQ + 1) + tr * kRows + i];
#pragma unroll
        for (int j = 0; j < kCols; ++j) kv[j] = kt[dd * (kBK + 1) + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int qpos = qlo + tr * kRows + i;
        float rmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int kpos = k0 + tc + 16 * j;
          bool ok = kpos < k_lim;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && kpos > qpos - a.window;
          s[i][j] = ok ? s[i][j] * a.scale : -INFINITY;
          rmax = fmaxf(rmax, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rmax = fmaxf(rmax, __shfl_xor_sync(half, rmax, off));
        const float m_new = fmaxf(m[i], rmax);
        float alpha = 1.f, rsum = 0.f;
        if (m_new != -INFINITY) {
          alpha = expf(m[i] - m_new);        // 0 while m[i] is -inf
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = expf(s[i][j] - m_new);   // masked: exp(-inf) = 0
            rsum += s[i][j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rsum += __shfl_xor_sync(half, rsum, off);
        l[i] = l[i] * alpha + rsum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[i][j] *= alpha;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          ps[(tc + 16 * j) * (kBQ + 1) + tr * kRows + i] = s[i][j];
      }
    }
    __syncthreads();

    if (active) {
      const int kn = min(kBK, k_end - k0);   // later keys have p = 0
      for (int c = 0; c < kn; ++c) {
        float pv[kRows], vv[kDims];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pv[i] = ps[c * (kBQ + 1) + tr * kRows + i];
#pragma unroll
        for (int j = 0; j < kDims; ++j) {
          const int dd = tc + 16 * j;
          vv[j] = dd < D ? vs[c * D + dd] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kDims; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

  if (!active) return;
  T* op = static_cast<T*>(a.o) +
          ((static_cast<long long>(b) * a.hq + h) * a.lq + q0) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = tr * kRows + i;
    if (r >= nq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int dd = tc + 16 * j;
      if (dd < D) op[static_cast<long long>(r) * D + dd] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const Args& a, int b, cudaStream_t s) {
  const size_t smem = smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.lq + kBQ - 1) / kBQ, a.hq, b);
  flash_fwd<T><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D) with the given element strides of
// their batch, head and row axes (the last axis contiguous); out
// (B, Hq, Lq, D) contiguous.  dtype 0 = float32, 1 = bfloat16 (all four
// tensors).  window <= 0 means no window.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int craft_flash_attention(
    const void* q, const void* k, const void* v, void* out, int b, int hq,
    int hkv, int lq, int lk, int d, long long qsb, long long qsh,
    long long qsl, long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl, float scale, int causal,
    int window, int q_offset, int kv_len, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || d <= 0 || d > kDMax ||
      lq < 0 || lk < 0 || b > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lq == 0) return 0;
  Args a{q, k, v, out, hq, hkv, lq, lk, d, qsb, qsh, qsl, ksb, ksh, ksl,
         vsb, vsh, vsl, scale, causal, window, q_offset, kv_len};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
