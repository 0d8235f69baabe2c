// Selective scans (the mamba recurrence), mamba2 (ssd_scan) and mamba1
// (s6_scan):
//
//   h_t = exp(dt_t * A) * h_{t-1} + dtx_t (x) B_t,   y_t = <h_t, C_t>_state
//
// Replaces the Pallas TPU kernels repro/kernels/ssm_scan/kernel.py::ssd_scan
// (A a scalar per head; state (hd, st) per batch row and head) and ::s6_scan
// (A per channel and state; state (st,) per batch row and channel).  Both
// routes of each scan replace the same TPU kernel; the wrapper
// (kernels/ssm_scan/kernel.py::choose_route) picks one from L and the shape,
// never on a failure.  dtx, B, C and y are float32 or bfloat16 (one type);
// dt, A, h0, h_last and every sum are float32.  dt = 0 steps are exact
// (decay 1, injection 0).
//
// Route "sequential" (decode, L = 1, and short L): one pass over time inside
// one block, the state in registers for the whole scan.  A thread holds 16
// state values; a state row of st values is split over tpr = st/16 threads
// (rounded up to a power of two) that sum their parts of y_t with warp
// shuffles.  ssd_scan: one block per (head, batch row), one state row per
// head-dim row (hd * tpr threads).  s6_scan: one block per (64 channels,
// batch row), one state row per channel.  The inputs of 32 timesteps are
// staged in shared memory at a time (B_t and C_t once per block), the 32
// y_t rows go back as coalesced stores.  Bound on the H100: the latency of
// one dependent step times L.  A decode step is one launch of a few
// microseconds; at L = 8192 the grid has 160 (zamba2) or 256 (falcon) blocks,
// under one warp per scheduler, and a step costs 0.8-1.7 us (PERF.md).
//
// Route "chunked" (long L): the time axis is cut into chunks of Q = 128
// steps (the wrapper's CHUNK), which run at once; only a short pass over
// the L/Q chunks stays sequential.  The wrapper takes it from L = 256 for
// mamba2 (with a single chunk it does the sequential kernel's work twice
// and loses at L = 64 and 128) and from L = 64 for mamba1 (its passes step
// faster than the sequential kernel, ex2 against expf and the tiles copied
// ahead, so it wins even as one chunk): chip_smoke.py's sweep of both
// routes over L on the card (PERF.md).  Three launches:
//   1. states: per (batch row, chunk, block of heads or channels), the
//      chunk's end state from a zero start and its sum of dt.  mamba2 in
//      the matrix form, walking the chunk backwards:
//        S_c = sum_j exp(A * sum_{k>j} dt_k) * dtx_j (x) B_j
//      (one exp a step and head, one FMA a state value and step); mamba1
//      replays the recurrence from 0 (one exp a state value and step).
//   2. carry: per state value, sequential over the chunks, 8 chunk states
//      in flight a thread:
//        h_in[c] = h;  h = exp(A * sum_c dt) * h + S_c
//      h_in overwrites S_c in the same float32 scratch (B, L/Q, nh, hd, st)
//      or (B, L/Q, di, st), which the wrapper allocates: 4 * B * ceil(L/Q)
//      * nh * hd * st bytes (168 MB for zamba2 at B 2, L 8192, Q 128) or 4 *
//      B * ceil(L/Q) * di * st (67 MB for falcon-mamba-7b), plus the sums of
//      dt, (B, L/Q, heads or channels).  It also writes h_last.
//   3. outputs: per (batch row, chunk, block), the recurrence run over the
//      chunk's Q steps from h_in[c], emitting y.
// The decay is exp2(dt * A * log2 e), one MUFU ex2 a value.  Tiles of 32
// (mamba2) or 16 (mamba1) steps stream into a 2-stage ring in shared memory
// by cp.async (16-byte copies where the strides allow, else 4-byte ones),
// so the next tile loads while this one is stepped.
//   mamba2: a thread owns 4 state rows x 16 states, so each B/C value it
//   loads from shared memory serves 4 rows; the tpr threads of a row group
//   hold interleaved 4-state pieces of the row (adjacent 16 bytes: no bank
//   conflict), and at st = 64 sum their parts of y as a reduce-scatter (3
//   shuffles, not 8).  Blocks of 256 threads: a stride-0 head axis of B/C
//   (one group broadcast over the heads, zamba2's call) is staged once for
//   the 4 heads of a block; else a block takes one head.  Each step's y
//   rows overwrite their x rows in the ring stage and leave as 16-byte
//   stores.  2,560 blocks of 256 threads at zamba2's L = 8192, Q = 128.
//   mamba1: pass 3 is the sequential route's inner loop over the chunk
//   (one channel a thread, 64 a block); 16,384 blocks at falcon's shape.
// Bound on the H100.  mamba1 does 2 exps a state value and step (passes 1
// and 3) at 16 a clock per SM: ~1.03 ms for falcon's (2, 8192, 8192, 16),
// above its bytes (dtx and dt read twice, y once: ~0.85 ms).  mamba2 does 4
// FP32 instructions a state value and step (1 in pass 1, 3 in pass 3),
// ~0.65 ms for zamba2's (2, 8192, 80, 64, 64).  On the card both passes run
// near the sum of their FP32 (or MUFU) and shared-memory / shuffle
// instruction times rather than the larger of the two, with 16-24 warps
// an SM (inferred from variants: no instruction-level profiler runs
// there); that is why the mamba2 design spends registers on rows to cut
// loads and shuffles a state value (PERF.md).
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSPT = 16;       // state values per thread
constexpr int kTT = 32;        // sequential: timesteps staged per tile
constexpr int kCh = 64;        // s6: channels per block
constexpr int kStMax = kSPT * 8;
constexpr int kQT = 32;        // ssd chunked: timesteps a ring stage holds
constexpr int kRows = 4;       // ssd chunked: state rows a thread
constexpr int kChunkThreads = 256;   // ssd chunked: most threads a block
constexpr int kS6T = 16;       // s6 chunked: timesteps a ring stage holds
constexpr float kLog2e = 1.4426950408889634f;

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
  // chunked route only: scratch (S_c, then h_in) and the chunks' sums of
  // dt, Q, L/Q, heads a block, and whether x and B/C take 16-byte copies
  float* states;
  float* dsum;
  int chunk, nchunks, hpb, vx, vbc;
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
  // chunked route only, as SsdArgs; vdt: dt takes 16-byte copies
  float* states;
  float* dsum;
  int chunk, nchunks, vx, vbc, vdt;
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

// ------------------------------------------------------------ chunked route
// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0, a decay that has vanished anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy an (n, g, w) tile of T into shared memory, element (t, j, k) from
// src[t * sl + j * sg + k] to dst[t * dtt + j * dg + k], by the whole
// block: 16-byte cp.async when vec (both sides of every 16 bytes aligned),
// else one element at a time (4-byte cp.async, or a plain copy for bf16).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int dtt, int dg, const T* src,
                                      long long sl, long long sg, int n,
                                      int g, int w, bool vec) {
  const int v = vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int wv = w / v, per = g * wv;
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int t = i / per, r = i - t * per, j = r / wv, k = (r - j * wv) * v;
    T* d = dst + t * dtt + j * dg + k;
    const T* s = src + t * sl + j * sg + k;
    if (vec) {
      cp_async16(d, s);
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(d, s);
    } else {
      *d = *s;
    }
  }
}

__host__ __device__ inline int up16(int n) { return (n + 15) & ~15; }

// 4 consecutive values of T from shared memory as float: one vector load
// when V (the caller knows all 4 lie in the row and are 16-byte aligned
// for float, 8 for bf16: st == 16 * tpr for B/C, hd % 4 == 0 for x), else
// the first n of them and zeros
template <typename T, bool V>
__device__ __forceinline__ void load4(const T* p, int n, float* out) {
  if constexpr (V && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (V) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

// 4 floats to shared or global memory as T, one vector store (16-byte
// aligned for float, 8 for bf16)
template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

// y[0..4) of 4 rows summed over the 4 lanes of their row group as a
// reduce-scatter: lane q ends with the sum of row q, after 3 shuffles in
// two rounds (4 independent row sums would take 8)
__device__ __forceinline__ float rows4_sum(const float* y, int q,
                                           unsigned lanes) {
  const bool hi = q & 2;
  float a = hi ? y[2] : y[0], b = hi ? y[3] : y[1];
  a += __shfl_xor_sync(lanes, hi ? y[0] : y[2], 2);
  b += __shfl_xor_sync(lanes, hi ? y[1] : y[3], 2);
  const bool odd = q & 1;
  return (odd ? b : a) + __shfl_xor_sync(lanes, odd ? a : b, 1);
}

// byte offsets of the tiles in one ring stage of the ssd chunked kernels
// and the stage's size
struct SsdRing {
  int x, b, c, dt, stage;
};
__host__ __device__ inline SsdRing ssd_ring(int hpb, int hd, int st, int es,
                                            bool out) {
  SsdRing r;
  r.x = 0;
  r.b = up16(kQT * hpb * hd * es);
  r.c = r.b + up16(kQT * st * es);
  r.dt = out ? r.c + up16(kQT * st * es) : r.c;
  r.stage = r.dt + up16(kQT * hpb * 4);
  return r;
}

// the tile of steps [t0, t0 + n) of heads [head0, head0 + nhv) into one
// ring stage: x (n, nhv, hd), one B (and C) row a step (the heads of a
// block share it: a broadcast group, or hpb = 1), dt (n, nhv)
template <typename T>
__device__ __forceinline__ void ssd_stage(const SsdArgs& a, const SsdRing& r,
                                          unsigned char* base, int b,
                                          int head0, int nhv, int t0, int n,
                                          bool out) {
  const long long tb = static_cast<long long>(t0);
  stage<T>(reinterpret_cast<T*>(base + r.x), a.hpb * a.hd, a.hd,
           static_cast<const T*>(a.dtx) + b * a.xsb + tb * a.xsl +
               head0 * a.xsh,
           a.xsl, a.xsh, n, nhv, a.hd, a.vx);
  stage<T>(reinterpret_cast<T*>(base + r.b), a.st, 0,
           static_cast<const T*>(a.bh) + b * a.bsb + tb * a.bsl +
               head0 * a.bsh,
           a.bsl, 0, n, 1, a.st, a.vbc);
  if (out)
    stage<T>(reinterpret_cast<T*>(base + r.c), a.st, 0,
             static_cast<const T*>(a.ch) + b * a.csb + tb * a.csl +
                 head0 * a.csh,
             a.csl, 0, n, 1, a.st, a.vbc);
  stage<float>(reinterpret_cast<float*>(base + r.dt), a.hpb, 1,
               a.dt + b * a.dsb + tb * a.dsl + head0 * a.dsh, a.dsl, a.dsh,
               n, nhv, 1, false);
  cp_async_commit();
}

// What one thread of an ssd chunked block owns: kRows state rows of one
// head (hh of the block's heads) and, of each row, the 16 states
// s = 4 * tpr * m + 4 * q + i (m, i < 4), so the tpr threads of a row
// group read adjacent 16-byte pieces of a B or C row (no bank conflict)
// and every B/C value a thread loads serves kRows rows.
struct SsdThread {
  int hh, row0, q, nhv, head0, chunk, b, tb, nsteps, ntiles;
  bool valid;
  __device__ SsdThread(const SsdArgs& a) {
    const int groups = a.hd / kRows;          // row groups a head
    const int g = threadIdx.x / a.tpr;
    q = threadIdx.x - g * a.tpr;
    hh = g / groups;
    row0 = (g - hh * groups) * kRows;
    head0 = blockIdx.x * a.hpb;
    chunk = blockIdx.y;
    b = blockIdx.z;
    nhv = min(a.hpb, a.nh - head0);
    valid = hh < nhv;
    tb = chunk * a.chunk;
    nsteps = min(a.chunk, a.L - tb);
    ntiles = (nsteps + kQT - 1) / kQT;
  }
  // index of this (batch row, chunk, head) in the (B, L/Q, nh) grid
  __device__ long long group(const SsdArgs& a) const {
    return (static_cast<long long>(b) * a.nchunks + chunk) * a.nh + head0 +
           hh;
  }
  // offset of the state (row0, 0) in the chunk states
  __device__ long long state_base(const SsdArgs& a) const {
    return (group(a) * a.hd + row0) * a.st;
  }
};

// pass 1 (mamba2): the chunk's end state from 0 and its sum of dt, walking
// the chunk backwards so the weight exp(A * sum_{k>j} dt_k) of step j comes
// from a running suffix sum: S[r][s] += (w_j x_j[r]) B_j[s]
template <typename T, bool V>
__global__ void __launch_bounds__(kChunkThreads)
    ssd_states_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int st = a.st, hd = a.hd, hpb = a.hpb, tpr = a.tpr;
  const SsdRing r = ssd_ring(hpb, hd, st, sizeof(T), false);
  const SsdThread th(a);
  const float A2 = th.valid ? a.A[th.head0 + th.hh] * kLog2e : 0.f;

  float acc[kRows][kSPT];
#pragma unroll
  for (int k = 0; k < kRows; ++k)
#pragma unroll
    for (int j = 0; j < kSPT; ++j) acc[k][j] = 0.f;
  float sfx = 0.f;                  // sum of dt after the current step
  const int last = th.ntiles - 1;   // tiles run from the chunk's end
  ssd_stage<T>(a, r, ring, th.b, th.head0, th.nhv, th.tb + last * kQT,
               th.nsteps - last * kQT, false);
  for (int k = 0; k < th.ntiles; ++k) {
    const int idx = last - k, n = min(kQT, th.nsteps - idx * kQT);
    cp_async_wait<0>();
    __syncthreads();                // tile k landed; stage (k+1)&1 is free
    if (k < last)
      ssd_stage<T>(a, r, ring + ((k + 1) & 1) * r.stage, th.b, th.head0,
                   th.nhv, th.tb + (idx - 1) * kQT, kQT, false);
    const unsigned char* base = ring + (k & 1) * r.stage;
    const T* sx = reinterpret_cast<const T*>(base + r.x);
    const T* sb = reinterpret_cast<const T*>(base + r.b);
    const float* sdt = reinterpret_cast<const float*>(base + r.dt);
    for (int t = n - 1; t >= 0; --t) {
      const float w = ex2(A2 * sfx);
      float xv[kRows];
      load4<T, true>(sx + (t * hpb + th.hh) * hd + th.row0, kRows, xv);
#pragma unroll
      for (int k2 = 0; k2 < kRows; ++k2) xv[k2] *= w;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int s = 4 * tpr * m + 4 * th.q;
        float bv[4];
        load4<T, V>(sb + t * st + s, st - s, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k2 = 0; k2 < kRows; ++k2)
            acc[k2][4 * m + i] = fmaf(xv[k2], bv[i], acc[k2][4 * m + i]);
      }
      sfx += sdt[t * hpb + th.hh];
    }
  }
  if (!th.valid) return;
  float* sp = a.states + th.state_base(a);
#pragma unroll
  for (int k2 = 0; k2 < kRows; ++k2)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int s = 4 * tpr * m + 4 * th.q;
      float* p = sp + k2 * st + s;
      if (V) {
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[k2][4 * m], acc[k2][4 * m + 1],
                        acc[k2][4 * m + 2], acc[k2][4 * m + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (s + i < st) p[i] = acc[k2][4 * m + i];
      }
    }
  if (th.row0 == 0 && th.q == 0)
    a.dsum[th.group(a)] = sfx;
}

// pass 3 (mamba2): the recurrence over the chunk from h_in, emitting y.
// Each step's y rows overwrite the x rows they came from in the ring stage
// (already read by every lane of the row group, which the shuffles sync),
// and the whole tile of y leaves in 4-element stores.
template <typename T, bool V>
__global__ void __launch_bounds__(kChunkThreads)
    ssd_outputs_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int st = a.st, hd = a.hd, hpb = a.hpb, tpr = a.tpr;
  const SsdRing r = ssd_ring(hpb, hd, st, sizeof(T), true);
  const SsdThread th(a);
  const float A2 = th.valid ? a.A[th.head0 + th.hh] * kLog2e : 0.f;
  const unsigned lanes = warp_lanes();

  float h[kRows][kSPT];
  {
    const float* hp = a.states + (th.valid ? th.state_base(a) : 0);
#pragma unroll
    for (int k2 = 0; k2 < kRows; ++k2)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int s = 4 * tpr * m + 4 * th.q;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[k2][4 * m + i] =
              th.valid && s + i < st ? hp[k2 * st + s + i] : 0.f;
      }
  }
  ssd_stage<T>(a, r, ring, th.b, th.head0, th.nhv, th.tb,
               min(kQT, th.nsteps), true);
  for (int k = 0; k < th.ntiles; ++k) {
    const int t0 = th.tb + k * kQT, n = min(kQT, th.nsteps - k * kQT);
    cp_async_wait<0>();
    __syncthreads();                // tile k landed; stage (k+1)&1 is free
    if (k + 1 < th.ntiles)
      ssd_stage<T>(a, r, ring + ((k + 1) & 1) * r.stage, th.b, th.head0,
                   th.nhv, t0 + kQT, min(kQT, th.nsteps - (k + 1) * kQT),
                   true);
    unsigned char* base = ring + (k & 1) * r.stage;
    T* sx = reinterpret_cast<T*>(base + r.x);
    const T* sb = reinterpret_cast<const T*>(base + r.b);
    const T* sc = reinterpret_cast<const T*>(base + r.c);
    const float* sdt = reinterpret_cast<const float*>(base + r.dt);
    for (int t = 0; t < n; ++t) {
      const float dec = ex2(A2 * sdt[t * hpb + th.hh]);
      T* xrow = sx + (t * hpb + th.hh) * hd + th.row0;
      float xv[kRows], y[kRows];
      load4<T, true>(xrow, kRows, xv);
#pragma unroll
      for (int k2 = 0; k2 < kRows; ++k2) y[k2] = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int s = 4 * tpr * m + 4 * th.q;
        float bv[4], cv[4];
        load4<T, V>(sb + t * st + s, st - s, bv);
        load4<T, V>(sc + t * st + s, st - s, cv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k2 = 0; k2 < kRows; ++k2) {
            float& hv = h[k2][4 * m + i];
            hv = fmaf(dec, hv, xv[k2] * bv[i]);
            y[k2] = fmaf(hv, cv[i], y[k2]);
          }
      }
      if (tpr == kRows) {           // st 49..64: lane q ends with row q
        const float v = rows4_sum(y, th.q, lanes);
        if (th.valid) xrow[th.q] = from_f<T>(v);
      } else {
#pragma unroll
        for (int k2 = 0; k2 < kRows; ++k2)
          y[k2] = row_sum(y[k2], tpr, lanes);
        if (th.q == 0 && th.valid) store4<T>(xrow, y);
      }
    }
    __syncthreads();                // every y row of the tile is in place
    T* yp = static_cast<T*>(a.y) +
            ((static_cast<long long>(th.b) * a.L + t0) * a.nh + th.head0) *
                hd;
    const int w4 = th.nhv * hd / 4, rowlen = hpb * hd;
    for (int i = threadIdx.x; i < n * w4; i += blockDim.x) {
      const int t = i / w4, c = (i - t * w4) * 4;
      float v[4];
      load4<T, true>(sx + t * rowlen + c, 4, v);
      store4<T>(yp + static_cast<long long>(t) * a.nh * hd + c, v);
    }
  }
}

// pass 2 (both scans): per state value of (batch row, group g, element e),
// sequential over the chunks: h_in[c] = h (over S_c in place), then
// h = exp(A * dsum_c) * h + S_c; h_last = h.  A is per group (mamba2's
// heads) or per (group, element) (mamba1's (channel, state)).
__global__ void carry_kernel(float* states, const float* dsum,
                             const float* A, const float* h0, float* h_last,
                             int nchunks, int G, int E, int a_per_elem,
                             long long total) {
  constexpr int kAhead = 8;          // chunk states in flight a thread
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const long long cs = static_cast<long long>(G) * E;
  const long long b = i / cs, ge = i - b * cs;
  const int g = static_cast<int>(ge / E), e = static_cast<int>(ge - g * E);
  const float A2 = A[a_per_elem ? ge : g] * kLog2e;
  float* sp = states + b * nchunks * cs + ge;
  const float* dp = dsum + b * nchunks * G + g;
  float h = h0[i];
  (void)e;
  for (int c0 = 0; c0 < nchunks; c0 += kAhead) {
    float s[kAhead], d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nchunks) {
        s[k] = sp[(c0 + k) * cs];
        d[k] = dp[static_cast<long long>(c0 + k) * G];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nchunks) {
        sp[(c0 + k) * cs] = h;
        h = fmaf(ex2(A2 * d[k]), h, s[k]);
      }
    }
  }
  h_last[i] = h;
}

// byte offsets of one ring stage of the s6 chunked kernels
struct S6Ring {
  int dt, x, b, c, stage;
};
__host__ __device__ inline S6Ring s6_ring(int st, int es, bool out) {
  S6Ring r;
  r.dt = 0;
  r.x = up16(kS6T * kCh * 4);
  r.b = r.x + up16(kS6T * kCh * es);
  r.c = r.b + up16(kS6T * st * es);
  r.stage = out ? r.c + up16(kS6T * st * es) : r.c;
  return r;
}

// passes 1 (kOut false: the chunk's end state from 0 and its sum of dt)
// and 3 (kOut: from h_in, emitting y) of mamba1; one block per (64
// channels, chunk, batch row), one state row per channel
template <typename T, bool kOut, bool V>
__global__ void __launch_bounds__(kCh * 8) s6_chunk_kernel(S6Args a) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int st = a.st, tpr = a.tpr;
  const S6Ring r = s6_ring(st, sizeof(T), kOut);
  const int c0 = blockIdx.x * kCh, chunk = blockIdx.y, b = blockIdx.z;
  const int nc = min(kCh, a.di - c0);
  const int tb = chunk * a.chunk, nsteps = min(a.chunk, a.L - tb);
  const int ntiles = (nsteps + kS6T - 1) / kS6T;
  const int tid = threadIdx.x, row = tid / tpr, s0 = (tid - row * tpr) * kSPT;
  const bool lead = s0 == 0, valid = row < nc;
  const int chn = c0 + (valid ? row : 0);
  const bool vx = a.vx && (nc * static_cast<int>(sizeof(T))) % 16 == 0;
  const bool vdt = a.vdt && nc % 4 == 0;
  const unsigned lanes = warp_lanes();
  const long long srow =
      ((static_cast<long long>(b) * a.nchunks + chunk) * a.di + chn) * st;

  float h[kSPT], A2[kSPT];
#pragma unroll
  for (int j = 0; j < kSPT; ++j) {
    const bool on = valid && s0 + j < st;
    A2[j] = on ? a.A[static_cast<long long>(chn) * st + s0 + j] * kLog2e : 0.f;
    h[j] = kOut && on ? a.states[srow + s0 + j] : 0.f;
  }
  float dsum = 0.f;
  auto load_tile = [&](unsigned char* base, int t0, int n) {
    const long long tl = static_cast<long long>(t0);
    stage<float>(reinterpret_cast<float*>(base + r.dt), kCh, 0,
                 a.dt + b * a.dsb + tl * a.dsl + c0, a.dsl, 0, n, 1, nc, vdt);
    stage<T>(reinterpret_cast<T*>(base + r.x), kCh, 0,
             static_cast<const T*>(a.dtx) + b * a.xsb + tl * a.xsl + c0,
             a.xsl, 0, n, 1, nc, vx);
    stage<T>(reinterpret_cast<T*>(base + r.b), st, 0,
             static_cast<const T*>(a.bh) + b * a.bsb + tl * a.bsl, a.bsl, 0,
             n, 1, st, a.vbc);
    if (kOut)
      stage<T>(reinterpret_cast<T*>(base + r.c), st, 0,
               static_cast<const T*>(a.ch) + b * a.csb + tl * a.csl, a.csl,
               0, n, 1, st, a.vbc);
    cp_async_commit();
  };
  T* yp = static_cast<T*>(a.y) + static_cast<long long>(b) * a.L * a.di + chn;
  load_tile(ring, tb, min(kS6T, nsteps));
  for (int k = 0; k < ntiles; ++k) {
    const int t0 = tb + k * kS6T, n = min(kS6T, nsteps - k * kS6T);
    if (k + 1 < ntiles) {
      load_tile(ring + ((k + 1) & 1) * r.stage, t0 + kS6T,
                min(kS6T, nsteps - (k + 1) * kS6T));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* base = ring + (k & 1) * r.stage;
    const float* sdt = reinterpret_cast<const float*>(base + r.dt);
    const T* sx = reinterpret_cast<const T*>(base + r.x);
    const T* sb = reinterpret_cast<const T*>(base + r.b);
    const T* sc = reinterpret_cast<const T*>(base + r.c);
    for (int t = 0; t < n; ++t) {
      const float d = sdt[t * kCh + row], x = to_f(sx[t * kCh + row]);
      float bv[kSPT], cv[kSPT];
#pragma unroll
      for (int m = 0; m < kSPT / 4; ++m) {
        const int s = s0 + 4 * m;
        load4<T, V>(sb + t * st + s, st - s, bv + 4 * m);
        if (kOut) load4<T, V>(sc + t * st + s, st - s, cv + 4 * m);
      }
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < kSPT; ++j) {
        h[j] = fmaf(ex2(d * A2[j]), h[j], x * bv[j]);
        if (kOut) y = fmaf(h[j], cv[j], y);
      }
      if (kOut) {
        y = row_sum(y, tpr, lanes);
        if (lead && valid)
          yp[static_cast<long long>(t0 + t) * a.di] = from_f<T>(y);
      } else {
        dsum += d;
      }
    }
    __syncthreads();
  }
  if (kOut || !valid) return;
#pragma unroll
  for (int j = 0; j < kSPT; ++j)
    if (V || s0 + j < st) a.states[srow + s0 + j] = h[j];
  if (lead)
    a.dsum[(static_cast<long long>(b) * a.nchunks + chunk) * a.di + chn] =
        dsum;
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

int carry(float* states, const float* dsum, const float* A, const float* h0,
          float* h_last, int b, int nchunks, int G, int E, int a_per_elem,
          cudaStream_t s) {
  const long long total = static_cast<long long>(b) * G * E;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  carry_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      states, dsum, A, h0, h_last, nchunks, G, E, a_per_elem, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool V>
int launch_ssd_chunked(const SsdArgs& a, int b, cudaStream_t s) {
  const dim3 grid((a.nh + a.hpb - 1) / a.hpb, a.nchunks, b);
  const int threads = a.hpb * (a.hd / kRows) * a.tpr;
  const size_t smem1 = 2 * ssd_ring(a.hpb, a.hd, a.st, sizeof(T), false).stage;
  const size_t smem3 = 2 * ssd_ring(a.hpb, a.hd, a.st, sizeof(T), true).stage;
  cudaError_t err = set_smem(ssd_states_kernel<T, V>, smem1);
  if (err == cudaSuccess) err = set_smem(ssd_outputs_kernel<T, V>, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_states_kernel<T, V><<<grid, threads, smem1, s>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  rc = carry(a.states, a.dsum, a.A, a.h0, a.h_last, b, a.nchunks, a.nh,
             a.hd * a.st, 0, s);
  if (rc) return rc;
  ssd_outputs_kernel<T, V><<<grid, threads, smem3, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool V>
int launch_s6_chunked(const S6Args& a, int b, cudaStream_t s) {
  const dim3 grid((a.di + kCh - 1) / kCh, a.nchunks, b);
  const int threads = kCh * a.tpr;
  const size_t smem1 = 2 * s6_ring(a.st, sizeof(T), false).stage;
  const size_t smem3 = 2 * s6_ring(a.st, sizeof(T), true).stage;
  cudaError_t err = set_smem(s6_chunk_kernel<T, false, V>, smem1);
  if (err == cudaSuccess) err = set_smem(s6_chunk_kernel<T, true, V>, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  s6_chunk_kernel<T, false, V><<<grid, threads, smem1, s>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  rc = carry(a.states, a.dsum, a.A, a.h0, a.h_last, b, a.nchunks, a.di,
             a.st, 1, s);
  if (rc) return rc;
  s6_chunk_kernel<T, true, V><<<grid, threads, smem3, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool al16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}
// strides (in elements of es bytes) that keep 16-byte alignment
bool m16(int es, std::initializer_list<long long> strides) {
  for (long long s : strides)
    if ((s * es) % 16) return false;
  return true;
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

// mamba2, route "chunked": as craft_ssd_scan, over chunks of `chunk` steps
// (three launches).  states: float32 scratch of (B, ceil(L/chunk), nh, hd,
// st) elements; dsum: float32 scratch of (B, ceil(L/chunk), nh).
extern "C" int craft_ssd_scan_chunked(
    const void* dtx, const void* bh, const void* ch, const void* dt,
    const void* A, const void* h0, void* y, void* h_last, void* states,
    void* dsum, int b, int L, int nh, int hd, int st, int chunk,
    long long xsb, long long xsl, long long xsh, long long bsb,
    long long bsl, long long bsh, long long csb, long long csl,
    long long csh, long long dsb, long long dsl, long long dsh, int dtype,
    void* stream) {
  if (b <= 0 || b > 65535 || nh <= 0 || hd <= 0 || st <= 0 || st > kStMax ||
      L < 0 || chunk <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpr = threads_per_row(st);
  const int nchunks = L == 0 ? 0 : (L - 1) / chunk + 1;
  if (hd % kRows || (hd / kRows) * tpr > kChunkThreads || nchunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  const int es = dtype == 0 ? 4 : 2;
  // one B/C row serves every head of a block only where the head axis is
  // a broadcast (stride 0); else a block takes one head
  const int cap = kChunkThreads / ((hd / kRows) * tpr);
  const int hpb = bsh == 0 && csh == 0 ? (nh < cap ? nh : cap) : 1;
  SsdArgs a{dtx, bh, ch, static_cast<const float*>(dt),
            static_cast<const float*>(A), static_cast<const float*>(h0), y,
            static_cast<float*>(h_last), L, nh, hd, st, tpr,
            xsb, xsl, xsh, bsb, bsl, bsh, csb, csl, csh, dsb, dsl, dsh,
            static_cast<float*>(states), static_cast<float*>(dsum), chunk,
            nchunks, hpb,
            al16(dtx) && m16(es, {xsb, xsl, xsh, hd}),
            al16(bh) && al16(ch) && m16(es, {bsb, bsl, bsh, csb, csl, csh,
                                             st})};
  auto s = static_cast<cudaStream_t>(stream);
  const bool v = st == kSPT * threads_per_row(st);
  if (dtype == 0)
    return v ? launch_ssd_chunked<float, true>(a, b, s)
             : launch_ssd_chunked<float, false>(a, b, s);
  return v ? launch_ssd_chunked<__nv_bfloat16, true>(a, b, s)
           : launch_ssd_chunked<__nv_bfloat16, false>(a, b, s);
}

// mamba1, route "chunked": as craft_s6_scan, over chunks of `chunk` steps
// (three launches).  states: float32 scratch of (B, ceil(L/chunk), di, st)
// elements; dsum: float32 scratch of (B, ceil(L/chunk), di).
extern "C" int craft_s6_scan_chunked(
    const void* dtx, const void* bh, const void* ch, const void* dt,
    const void* A, const void* h0, void* y, void* h_last, void* states,
    void* dsum, int b, int L, int di, int st, int chunk, long long xsb,
    long long xsl, long long bsb, long long bsl, long long csb,
    long long csl, long long dsb, long long dsl, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || di <= 0 || st <= 0 || st > kStMax || L < 0 ||
      chunk <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = L == 0 ? 0 : (L - 1) / chunk + 1;
  if (nchunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  const int es = dtype == 0 ? 4 : 2;
  S6Args a{dtx, bh, ch, static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(h0), y,
           static_cast<float*>(h_last), L, di, st, threads_per_row(st),
           xsb, xsl, bsb, bsl, csb, csl, dsb, dsl,
           static_cast<float*>(states), static_cast<float*>(dsum), chunk,
           nchunks, al16(dtx) && m16(es, {xsb, xsl}),
           al16(bh) && al16(ch) && m16(es, {bsb, bsl, csb, csl, st}),
           al16(dt) && m16(4, {dsb, dsl})};
  auto s = static_cast<cudaStream_t>(stream);
  const bool v = st == kSPT * threads_per_row(st);
  if (dtype == 0)
    return v ? launch_s6_chunked<float, true>(a, b, s)
             : launch_s6_chunked<float, false>(a, b, s);
  return v ? launch_s6_chunked<__nv_bfloat16, true>(a, b, s)
           : launch_s6_chunked<__nv_bfloat16, false>(a, b, s);
}
