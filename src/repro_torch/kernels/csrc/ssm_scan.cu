// Selective scans (the mamba recurrence), mamba2 (ssd_scan) and mamba1
// (s6_scan):
//
//   h_t = exp(dt_t * A) * h_{t-1} + dtx_t (x) B_t,   y_t = <h_t, C_t>_state
//
// Replaces the Pallas TPU kernels repro/kernels/ssm_scan/kernel.py::ssd_scan
// (A a scalar per head; state (hd, st) per batch row and head) and ::s6_scan
// (A per channel and state; state (st,) per batch row and channel).
//
// Bound: the recurrence is sequential in time, so the card is limited by
// the latency of one step times L, not by bytes (each input is read once)
// or by peak float32 rate (~2 FMAs per state value and step; mamba1 adds
// one exp per state value and step).
//
// Design.  The TPU kernels carry the state in VMEM scratch across a
// sequential grid axis over time blocks; here the time loop runs inside one
// block and the state lives in registers for the whole scan, never in
// device memory.  A thread holds 16 state values; a state row of st values
// is split over tpr = st/16 threads (rounded up to a power of two) that
// sum their parts of y_t with warp shuffles.  ssd_scan: one block per
// (head, batch row), one state row per head-dim row (hd * tpr threads).
// s6_scan: one block per (64 channels, batch row), one state row per
// channel.  The inputs of 32 timesteps are staged in shared memory at a
// time with coalesced loads (B_t and C_t, shared by every row of the block,
// once per block), and the 32 y_t rows go back as coalesced stores.  dtx,
// B, C and y are float32 or bfloat16 (one type); dt, A, h0 and h_last are
// float32.  dt = 0 steps are exact (decay 1, injection 0).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSPT = 16;       // state values per thread
constexpr int kTT = 32;        // timesteps staged per tile
constexpr int kCh = 64;        // s6: channels per block
constexpr int kStMax = kSPT * 8;

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

// the lanes of this thread's warp that exist in the block
__device__ __forceinline__ unsigned warp_lanes() {
  const int base = threadIdx.x & ~31;
  const int n = min(32, static_cast<int>(blockDim.x) - base);
  return n == 32 ? 0xffffffffu : ((1u << n) - 1u);
}

// y summed over the tpr adjacent lanes that share a state row
__device__ __forceinline__ float row_sum(float y, int tpr, unsigned lanes) {
  for (int off = tpr >> 1; off > 0; off >>= 1)
    y += __shfl_xor_sync(lanes, y, off);
  return y;
}

int threads_per_row(int st) {
  int t = 1;
  while (t * kSPT < st) t <<= 1;
  return t;
}

// ------------------------------------------------------------------ mamba2
struct SsdArgs {
  const void* dtx;
  const void* bh;
  const void* ch;
  const float* dt;
  const float* A;
  const float* h0;
  void* y;
  float* h_last;
  int L, nh, hd, st, tpr;
  long long xsb, xsl, xsh, bsb, bsl, bsh, csb, csl, csh, dsb, dsl, dsh;
};

template <typename T>
__global__ void ssd_scan_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  const int st = a.st, hd = a.hd, tpr = a.tpr;
  float* sb = smem;                  // [kTT][st]
  float* sc = sb + kTT * st;         // [kTT][st]
  float* sdec = sc + kTT * st;       // [kTT]
  float* sx = sdec + kTT;            // [kTT][hd]
  float* sy = sx + kTT * hd;         // [kTT][hd]
  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, row = tid / tpr, s0 = (tid - row * tpr) * kSPT;
  const bool lead = s0 == 0;
  const float A = a.A[head];
  const T* dtx = static_cast<const T*>(a.dtx) + b * a.xsb + head * a.xsh;
  const T* bh = static_cast<const T*>(a.bh) + b * a.bsb + head * a.bsh;
  const T* ch = static_cast<const T*>(a.ch) + b * a.csb + head * a.csh;
  const float* dt = a.dt + b * a.dsb + head * a.dsh;
  const long long srow = ((static_cast<long long>(b) * a.nh + head) * hd + row) * st;
  const unsigned lanes = warp_lanes();

  float h[kSPT];
#pragma unroll
  for (int j = 0; j < kSPT; ++j) h[j] = s0 + j < st ? a.h0[srow + s0 + j] : 0.f;

  for (int t0 = 0; t0 < a.L; t0 += kTT) {
    const int n = min(kTT, a.L - t0);
    __syncthreads();                 // the previous tile's readers are done
    for (int i = tid; i < n * st; i += blockDim.x) {
      const int t = i / st, s = i - t * st;
      sb[i] = to_f(bh[(t0 + t) * a.bsl + s]);
      sc[i] = to_f(ch[(t0 + t) * a.csl + s]);
    }
    for (int i = tid; i < n; i += blockDim.x) sdec[i] = expf(dt[(t0 + i) * a.dsl] * A);
    for (int i = tid; i < n * hd; i += blockDim.x) {
      const int t = i / hd, r = i - t * hd;
      sx[i] = to_f(dtx[(t0 + t) * a.xsl + r]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float dec = sdec[t], x = sx[t * hd + row];
      const float* bt = sb + t * st + s0;
      const float* ct = sc + t * st + s0;
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < kSPT; ++j) {
        if (s0 + j < st) {
          h[j] = fmaf(dec, h[j], x * bt[j]);
          y = fmaf(h[j], ct[j], y);
        }
      }
      y = row_sum(y, tpr, lanes);
      if (lead) sy[t * hd + row] = y;
    }
    __syncthreads();
    T* yp = static_cast<T*>(a.y) +
            ((static_cast<long long>(b) * a.L + t0) * a.nh + head) * hd;
    for (int i = tid; i < n * hd; i += blockDim.x) {
      const int t = i / hd, r = i - t * hd;
      yp[static_cast<long long>(t) * a.nh * hd + r] = from_f<T>(sy[i]);
    }
  }
#pragma unroll
  for (int j = 0; j < kSPT; ++j)
    if (s0 + j < st) a.h_last[srow + s0 + j] = h[j];
}

// ------------------------------------------------------------------ mamba1
struct S6Args {
  const void* dtx;
  const void* bh;
  const void* ch;
  const float* dt;
  const float* A;
  const float* h0;
  void* y;
  float* h_last;
  int L, di, st, tpr;
  long long xsb, xsl, bsb, bsl, csb, csl, dsb, dsl;
};

template <typename T>
__global__ void s6_scan_kernel(S6Args a) {
  extern __shared__ float smem[];
  const int st = a.st, tpr = a.tpr;
  float* sb = smem;                  // [kTT][st]
  float* sc = sb + kTT * st;         // [kTT][st]
  float* sdt = sc + kTT * st;        // [kTT][kCh]
  float* sx = sdt + kTT * kCh;       // [kTT][kCh]
  float* sy = sx + kTT * kCh;        // [kTT][kCh]
  const int b = blockIdx.y, c0 = blockIdx.x * kCh;
  const int nc = min(kCh, a.di - c0);
  const int tid = threadIdx.x, row = tid / tpr, s0 = (tid - row * tpr) * kSPT;
  const bool lead = s0 == 0, valid = row < nc;
  const int chn = c0 + row;
  const T* dtx = static_cast<const T*>(a.dtx) + b * a.xsb + c0;
  const T* bh = static_cast<const T*>(a.bh) + b * a.bsb;
  const T* ch = static_cast<const T*>(a.ch) + b * a.csb;
  const float* dt = a.dt + b * a.dsb + c0;
  const long long srow = (static_cast<long long>(b) * a.di + chn) * st;
  const unsigned lanes = warp_lanes();

  float h[kSPT], Ar[kSPT];
#pragma unroll
  for (int j = 0; j < kSPT; ++j) {
    const bool on = valid && s0 + j < st;
    Ar[j] = on ? a.A[static_cast<long long>(chn) * st + s0 + j] : 0.f;
    h[j] = on ? a.h0[srow + s0 + j] : 0.f;
  }

  for (int t0 = 0; t0 < a.L; t0 += kTT) {
    const int n = min(kTT, a.L - t0);
    __syncthreads();
    for (int i = tid; i < n * st; i += blockDim.x) {
      const int t = i / st, s = i - t * st;
      sb[i] = to_f(bh[(t0 + t) * a.bsl + s]);
      sc[i] = to_f(ch[(t0 + t) * a.csl + s]);
    }
    for (int i = tid; i < n * kCh; i += blockDim.x) {
      const int t = i / kCh, c = i - t * kCh;
      const bool on = c < nc;
      sdt[i] = on ? dt[(t0 + t) * a.dsl + c] : 0.f;
      sx[i] = on ? to_f(dtx[(t0 + t) * a.xsl + c]) : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float d = sdt[t * kCh + row], x = sx[t * kCh + row];
      const float* bt = sb + t * st + s0;
      const float* ct = sc + t * st + s0;
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < kSPT; ++j) {
        if (s0 + j < st) {
          h[j] = fmaf(expf(d * Ar[j]), h[j], x * bt[j]);
          y = fmaf(h[j], ct[j], y);
        }
      }
      y = row_sum(y, tpr, lanes);
      if (lead) sy[t * kCh + row] = y;
    }
    __syncthreads();
    T* yp = static_cast<T*>(a.y) + (static_cast<long long>(b) * a.L + t0) * a.di + c0;
    for (int i = tid; i < n * kCh; i += blockDim.x) {
      const int t = i / kCh, c = i - t * kCh;
      if (c < nc) yp[static_cast<long long>(t) * a.di + c] = from_f<T>(sy[i]);
    }
  }
  if (!valid) return;
#pragma unroll
  for (int j = 0; j < kSPT; ++j)
    if (s0 + j < st) a.h_last[srow + s0 + j] = h[j];
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_ssd(const SsdArgs& a, int b, cudaStream_t s) {
  const size_t smem = sizeof(float) * (2 * kTT * a.st + kTT + 2 * kTT * a.hd);
  cudaError_t err = set_smem(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<dim3(a.nh, b), a.hd * a.tpr, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_s6(const S6Args& a, int b, cudaStream_t s) {
  const size_t smem = sizeof(float) * (2 * kTT * a.st + 3 * kTT * kCh);
  cudaError_t err = set_smem(s6_scan_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.di + kCh - 1) / kCh, b);
  s6_scan_kernel<T><<<grid, kCh * a.tpr, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mamba2.  dtx (B, L, nh, hd), bh/ch (B, L, nh, st) with element strides of
// their batch, time and head axes (the last axis contiguous); dt (B, L, nh)
// float32 with strides; A (nh,), h0 (B, nh, hd, st) float32 contiguous.
// Writes y (B, L, nh, hd) contiguous in dtx's type and h_last
// (B, nh, hd, st) float32.  dtype 0 = float32, 1 = bfloat16 (dtx, bh, ch,
// y).  Returns the cudaError_t of the launch (0 on success).
extern "C" int craft_ssd_scan(
    const void* dtx, const void* bh, const void* ch, const void* dt,
    const void* A, const void* h0, void* y, void* h_last, int b, int L,
    int nh, int hd, int st, long long xsb, long long xsl, long long xsh,
    long long bsb, long long bsl, long long bsh, long long csb,
    long long csl, long long csh, long long dsb, long long dsl,
    long long dsh, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || nh <= 0 || hd <= 0 || st <= 0 || st > kStMax ||
      L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpr = threads_per_row(st);
  if (hd * tpr > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  SsdArgs a{dtx, bh, ch, static_cast<const float*>(dt),
            static_cast<const float*>(A), static_cast<const float*>(h0), y,
            static_cast<float*>(h_last), L, nh, hd, st, tpr,
            xsb, xsl, xsh, bsb, bsl, bsh, csb, csl, csh, dsb, dsl, dsh};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_ssd<float>(a, b, s);
  if (dtype == 1) return launch_ssd<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// mamba1.  dtx (B, L, di), bh/ch (B, L, st) with element strides of their
// batch and time axes (the last axis contiguous); dt (B, L, di) float32
// with strides; A (di, st), h0 (B, di, st) float32 contiguous.  Writes y
// (B, L, di) contiguous in dtx's type and h_last (B, di, st) float32.
extern "C" int craft_s6_scan(
    const void* dtx, const void* bh, const void* ch, const void* dt,
    const void* A, const void* h0, void* y, void* h_last, int b, int L,
    int di, int st, long long xsb, long long xsl, long long bsb,
    long long bsl, long long csb, long long csl, long long dsb,
    long long dsl, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || di <= 0 || st <= 0 || st > kStMax || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  S6Args a{dtx, bh, ch, static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(h0), y,
           static_cast<float*>(h_last), L, di, st, threads_per_row(st),
           xsb, xsl, bsb, bsl, csb, csl, dsb, dsl};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_s6<float>(a, b, s);
  if (dtype == 1) return launch_s6<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
