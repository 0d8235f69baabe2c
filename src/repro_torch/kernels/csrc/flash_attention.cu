// Blocked attention forward with an online softmax (flash attention).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention: out = softmax(q k^T * scale + mask) v with float32
// accumulation.  q and k have head dim DQK, v and out DV, each up to 256
// (MLA: 192 and 128).  GQA: query head h reads kv head h / (Hq / Hkv).  Masks:
// causal (kpos <= qpos), sliding window (kpos > qpos - window), kv_len
// (kpos < kv_len), with qpos = q_offset + query row.  A row with no
// unmasked key returns 0.  Asked for it, the scalar and tc_prefill routes
// also write each row's log-sum-exp of its scaled scores (-1e30 for a row
// with no unmasked key): the residual of the training backward.
//
// Bound on the H100.  Prefill (L = 8192, D = 80) is bound by operations:
// 4 D flops per unmasked (query, key) pair against 2 bytes per element
// read once, about 0.7 ms at the 989 TFLOP/s bf16 tensor rate for
// zamba2's (2, 32, 8192, 80) causal call; 2 (DQK + DV) flops a pair in
// general, so about 5.6 ms for MLA's (2, 128, 8192, 192 / 128).  Decode
// (one query row per head) is bound by reading the K/V cache once: 6-50 us
// at 3.35 TB/s.
//
// Three routes; the wrapper (kernels/flash_attention/kernel.py) picks one
// from the dtype and shape, never on a failure.
//
// 1. tc_prefill (flash_tc): bf16, (DQK, DV) one of the instantiated pairs
//    (template parameters: DQK == DV a multiple of 16 up to 128, and MLA's
//    192 / 128), more than 64 rows of (query, group head).  One block of
//    256 threads owns 128 q rows of one (batch, q head): two warpgroups of
//    4 warps, 16 rows a warp.  The q tile and 64-key K/V tiles come into
//    shared memory by 16-byte cp.async into a 2-stage ring, each stage's
//    completion signalled on an mbarrier (cp.async.mbarrier.arrive), so the
//    next tile streams in while the tensor cores work on this one.  Rows
//    are padded to D + 8 elements (an odd number of 16-byte chunks: 88 for
//    D = 80; q and K rows by DQK, V rows by DV), which keeps ldmatrix free
//    of bank conflicts without padding D itself.  At DQK 192 a warp holds
//    Q's 12 k-steps of fragments (48 registers) beside its 16 x 128 fp32 O
//    accumulator (64); ptxas reports the instance's registers and spills
//    in the build log.  S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in,
//    fp32 accumulators in registers); Q's fragments are loaded once, K's by
//    ldmatrix, V's by ldmatrix.trans.  The online softmax stays in the
//    accumulator registers (exp2f with scale * log2 e folded in; a row's
//    max and sum over the 4 lanes of a quad), and P is rounded to bf16 in
//    registers as the A operand of the second product; on tiles that cross
//    a mask edge the remainder P - bf16(P) adds a third (rows that see a
//    handful of keys get them all there, and bf16 P alone would move such
//    a row by up to 2^-9 of a dominant value).  Key tiles wholly
//    outside the causal / window / kv_len range of the q tile are never
//    loaded, a warp skips tiles wholly masked for its rows, and only tiles
//    that cross an edge evaluate the mask.  Rows past Lq and keys past
//    kv_len are zero-filled by the copy (no padded tensors).  q tiles run
//    longest first, so causal blocks balance over the 132 SMs.
//    (mma.sync, not wgmma: see PERF.md; wgmma is queued in ROADMAP.md.)
// 2. split_decode (flash_decode + flash_combine): Lq * group <= 64 rows,
//    float32 or bf16, the same (DQK, DV) pairs as tc_prefill (the wrapper
//    also requires the block's shared memory to fit: float32 at 192 / 128
//    fits up to 56 rows).  The group's q heads (and the Lq
//    query rows) are the rows of one block, so each K/V tile is read once
//    for the whole group, and the visible keys [k_begin, k_end) are cut
//    into splits: one block of 128 threads per (batch, kv head, split),
//    with the split count chosen by the wrapper so the blocks fill the
//    card.  K/V tiles of 64 keys stream in by 16-byte cp.async (2 stages,
//    mbarriers); scores and P V run on CUDA cores in fp32 (the bytes bound
//    it, not the arithmetic), a thread taking 4 rows at once so each K
//    chunk and V pair is read from shared memory once for 4 rows; with a
//    single row group two lanes split D for the scores, and key groups
//    split each tile's keys for P V.  Each split writes float32 partials
//    (o, m, l) to scratch the wrapper allocates; flash_combine rescales
//    and sums them.  A split with no visible key writes m = -inf, l = 0,
//    o = 0 and adds nothing.
// 3. scalar (flash_fwd): float32 prefill and every other (DQK, DV).  One
//    block of 256 threads per (batch, q head, 64-row q tile); q, K and V
//    tiles staged transposed in shared memory as float32, scalar fp32 FMAs
//    (each thread 4 rows x 4 key columns, then 4 rows x 8 output dims, or
//    16 where DV > 128), the row reductions in 16-lane shuffles; any DQK,
//    DV <= 256 and any 4-byte aligned strides.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kDMax = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// lse of a row that sees no key: the reference's blocked forward starts its
// running max at -1e30 and divides by 1 where the sum is 0
constexpr float kEmptyLse = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                  // (B, Hq, Lq) or null: m + log(l) per row
  int hq, hkv, lq, lk, dqk, dv;
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

// ---- asynchronous copies, mbarriers, ldmatrix and mma.sync (sm_80+ PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_size 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this thread's arrival on bar, made when its earlier cp.asyncs land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to a bf16 pair; rem gets the pair of what rounding left
__device__ __forceinline__ uint32_t split_bf16(float lo, float hi,
                                               uint32_t& rem) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(v);
  __nv_bfloat162 r = __floats2bfloat162_rn(lo - f.x, hi - f.y);
  rem = *reinterpret_cast<uint32_t*>(&r);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- scalar
namespace scalar {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr int kRows = 4;       // q rows per thread
constexpr int kCols = kBK / 16;    // score columns per thread

size_t smem_bytes(int dqk, int dv) {
  return sizeof(float) * (static_cast<size_t>(dqk) * (kBQ + 1) +
                          static_cast<size_t>(dqk) * (kBK + 1) +
                          static_cast<size_t>(kBK) * dv +
                          static_cast<size_t>(kBK) * (kBQ + 1));
}

// kDims: output dims per thread (8 for DV <= 128, 16 for DV <= 256)
template <typename T, int kDims>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  extern __shared__ float smem[];
  const int DQK = a.dqk, DV = a.dv;
  float* qt = smem;                      // [DQK][kBQ + 1]
  float* kt = qt + DQK * (kBQ + 1);      // [DQK][kBK + 1]
  float* vs = kt + DQK * (kBK + 1);      // [kBK][DV]
  float* ps = vs + kBK * DV;             // [kBK][kBQ + 1]

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

  for (int i = tid; i < kBQ * DQK; i += kThreads) {
    const int r = i / DQK, dd = i - r * DQK;
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
    for (int i = tid; i < kBK * DQK; i += kThreads) {
      const int c = i / DQK, dd = i - c * DQK;
      kt[dd * (kBK + 1) + c] =
          c < nk ? to_f(kp[static_cast<long long>(k0 + c) * a.ksl + dd]) : 0.f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int c = i / DV, dd = i - c * DV;
      vs[c * DV + dd] =
          c < nk ? to_f(vp[static_cast<long long>(k0 + c) * a.vsl + dd]) : 0.f;
    }
    __syncthreads();

    if (active) {
      float s[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
      for (int dd = 0; dd < DQK; ++dd) {
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
          vv[j] = dd < DV ? vs[c * DV + dd] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kDims; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

  if (!active) return;
  const long long row0 = (static_cast<long long>(b) * a.hq + h) * a.lq + q0;
  T* op = static_cast<T*>(a.o) + row0 * DV;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = tr * kRows + i;
    if (r >= nq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (a.lse != nullptr && tc == 0)
      a.lse[row0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : kEmptyLse;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int dd = tc + 16 * j;
      if (dd < DV) op[static_cast<long long>(r) * DV + dd] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int kDims>
int launch_dims(const Args& a, int b, cudaStream_t s) {
  const size_t smem = smem_bytes(a.dqk, a.dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, kDims>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.lq + kBQ - 1) / kBQ, a.hq, b);
  flash_fwd<T, kDims><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int b, cudaStream_t s) {
  return a.dv <= 128 ? launch_dims<T, 8>(a, b, s)
                     : launch_dims<T, 16>(a, b, s);
}

}  // namespace scalar

// ------------------------------------------------------------ tc_prefill
namespace tc {

constexpr int kBQ = 128;       // q rows per block: 8 warps of 16
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // K/V ring depth
constexpr int kBarBytes = 128; // mbarriers, ahead of the tiles

template <int DQK, int DV>
struct Shape {
  static constexpr int kRow = DQK + 8;      // q / K rows: odd 16-byte chunks
  static constexpr int kRowV = DV + 8;      // V rows
  static constexpr int kChunks = DQK / 8;   // 16-byte chunks of a q / K row
  static constexpr int kChunksV = DV / 8;
  static constexpr int kKSteps = DQK / 16;  // k-steps of Q K^T
  static constexpr int kVSteps = DV / 16;   // 16-wide output steps of P V
  static constexpr int kDTiles = DV / 8;    // 8-wide output tiles of P V
  static constexpr size_t kSmem =
      kBarBytes + sizeof(__nv_bfloat16) *
                      (kRow * (kBQ + kStages * kBK) + kRowV * kStages * kBK);
};

using bf16 = __nv_bfloat16;

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_tc(Args a) {
  using S = Shape<DQK, DV>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(smem + kBarBytes);  // [kBQ][kRow]
  bf16* ks = qs + kBQ * S::kRow;               // [kStages][kBK][kRow]
  bf16* vs = ks + kStages * kBK * S::kRow;     // [kStages][kBK][kRowV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest tiles first
  const int nq = min(kBQ, a.lq - q0);
  const int hk = h / (a.hq / a.hkv);
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh +
                   static_cast<long long>(q0) * a.qsl;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh;

  // keys any row of this tile can see, in whole tiles from k_begin
  const int qlo = a.q_offset + q0, qhi = qlo + nq - 1;
  const int k_lim = min(a.lk, a.kv_len);
  int k_end = k_lim;
  if (a.causal) k_end = min(k_end, qhi + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, qlo - a.window + 1);
  k_begin = (k_begin / kBK) * kBK;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid < kStages) mbar_init(smem_u32(&bars[tid]), kThreads);
  __syncthreads();

  // every thread copies its share of a tile, then arrives on the stage's
  // barrier when those copies land (rows past kv_len / Lk are zeros)
  auto load_kv = [&](int t, int st) {
    const int k0 = k_begin + t * kBK;
    const uint32_t kd = smem_u32(ks + st * kBK * S::kRow);
    const uint32_t vd = smem_u32(vs + st * kBK * S::kRowV);
    for (int i = tid; i < kBK * S::kChunks; i += kThreads) {
      const int r = i / S::kChunks, c = i - r * S::kChunks;
      const bool ok = k0 + r < k_lim;
      const long long row = ok ? k0 + r : 0;
      const uint32_t off = (r * S::kRow + c * 8) * sizeof(bf16);
      cp_async16(kd + off, kp + row * a.ksl + c * 8, ok);
      if constexpr (DQK == DV) cp_async16(vd + off, vp + row * a.vsl + c * 8, ok);
    }
    if constexpr (DQK != DV) {
      for (int i = tid; i < kBK * S::kChunksV; i += kThreads) {
        const int r = i / S::kChunksV, c = i - r * S::kChunksV;
        const bool ok = k0 + r < k_lim;
        const long long row = ok ? k0 + r : 0;
        cp_async16(vd + (r * S::kRowV + c * 8) * sizeof(bf16),
                   vp + row * a.vsl + c * 8, ok);
      }
    }
    cp_async_arrive(smem_u32(&bars[st]));
  };
  if (n_kt > 0) {
    const uint32_t qd = smem_u32(qs);
    for (int i = tid; i < kBQ * S::kChunks; i += kThreads) {
      const int r = i / S::kChunks, c = i - r * S::kChunks;
      const bool ok = r < nq;
      cp_async16(qd + (r * S::kRow + c * 8) * sizeof(bf16),
                 qp + static_cast<long long>(ok ? r : 0) * a.qsl + c * 8, ok);
    }
    for (int t = 0; t < kStages && t < n_kt; ++t) load_kv(t, t);  // q in 0
  }

  const int g = lane >> 2, tig = lane & 3;     // mma fragment coordinates
  const int wr0 = warp * 16;                   // this warp's first row
  const bool live = wr0 < nq;                  // uniform in the warp
  const int w_qlo = qlo + wr0, w_qhi = qlo + min(wr0 + 15, nq - 1);
  const int qpos0 = qlo + wr0 + g, qpos1 = qpos0 + 8;
  const float sl2 = a.scale * kLog2e;

  uint32_t qf[S::kKSteps][4];
  float o[S::kDTiles][4];
#pragma unroll
  for (int j = 0; j < S::kDTiles; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int st = t % kStages;
    mbar_wait(smem_u32(&bars[st]), (t / kStages) & 1);
    const int k0 = k_begin + t * kBK;
    if (t == 0 && live) {
#pragma unroll
      for (int kk = 0; kk < S::kKSteps; ++kk)
        ldsm_x4(smem_u32(qs + (wr0 + (lane & 15)) * S::kRow + kk * 16 +
                         (lane >> 4) * 8),
                qf[kk]);
    }
    bool skip = !live;
    if (a.causal && k0 > w_qhi) skip = true;        // after every row
    if (a.window > 0 && k0 + kBK - 1 <= w_qlo - a.window)
      skip = true;                                  // before every window
    if (!skip) {
      const bf16* kt = ks + st * kBK * S::kRow;
      const bf16* vt = vs + st * kBK * S::kRowV;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T: one ldmatrix.x4 gives the B fragments of 16 keys
#pragma unroll
      for (int kk = 0; kk < S::kKSteps; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t bk[4];
          ldsm_x4(smem_u32(kt + (n2 * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                    S::kRow +
                           kk * 16 + ((lane >> 3) & 1) * 8),
                  bk);
          mma_bf16(s[2 * n2], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], bk[2], bk[3]);
        }
      }
      // base-2 scores; the mask only where the tile crosses an edge
      const bool edge = k0 + kBK > k_lim ||
                        (a.causal && k0 + kBK - 1 > w_qlo) ||
                        (a.window > 0 && k0 <= w_qhi - a.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[j][c] * sl2;
          if (edge) {
            const int kpos = k0 + j * 8 + tig * 2 + (c & 1);
            const int qpos = c < 2 ? qpos0 : qpos1;
            bool ok = kpos < k_lim;
            if (a.causal) ok = ok && kpos <= qpos;
            if (a.window > 0) ok = ok && kpos > qpos - a.window;
            if (!ok) x = -INFINITY;
          }
          s[j][c] = x;
          if (c < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;   // no NaN from -inf
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2f(s[j][0] - mu0);
        s[j][1] = exp2f(s[j][1] - mu0);
        s[j][2] = exp2f(s[j][2] - mu1);
        s[j][3] = exp2f(s[j][3] - mu1);
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + rs0;         // this lane's share; quad-summed at the end
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < S::kDTiles; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }
      // O += P V: the score accumulators are P's A fragments.  On an edge
      // tile the rounding remainder P - bf16(P) goes through a second
      // product: rows that see only a few keys take them all from edge
      // tiles, and there bf16's 2^-9 rounding of a dominant p would show
      // at the output's own precision
#pragma unroll
      for (int kt2 = 0; kt2 < 4; ++kt2) {
        uint32_t pa[4], pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * kt2 + (i >> 1), c = 2 * (i & 1);
          pa[i] = split_bf16(s[j][c], s[j][c + 1], pr[i]);
        }
#pragma unroll
        for (int d2 = 0; d2 < S::kVSteps; ++d2) {
          uint32_t bv[4];
          ldsm_x4_t(smem_u32(vt + (kt2 * 16 + ((lane >> 3) & 1) * 8 +
                                   (lane & 7)) *
                                      S::kRowV +
                             d2 * 16 + (lane >> 4) * 8),
                    bv);
          mma_bf16(o[2 * d2], pa, bv[0], bv[1]);
          mma_bf16(o[2 * d2 + 1], pa, bv[2], bv[3]);
          if (edge) {
            mma_bf16(o[2 * d2], pr, bv[0], bv[1]);
            mma_bf16(o[2 * d2 + 1], pr, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();                     // every warp is done with stage st
    if (t + kStages < n_kt) load_kv(t + kStages, st);
  }

  if (!live) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;   // a row with no key: 0
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const long long row0 = (static_cast<long long>(b) * a.hq + h) * a.lq + q0;
  bf16* op = static_cast<bf16*>(a.o) + row0 * DV;
  const int r0 = wr0 + g, r1 = r0 + 8;
  if (a.lse != nullptr && tig == 0) {   // m is base 2: lse = m ln 2 + ln l
    if (r0 < nq) a.lse[row0 + r0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kEmptyLse;
    if (r1 < nq) a.lse[row0 + r1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kEmptyLse;
  }
#pragma unroll
  for (int j = 0; j < S::kDTiles; ++j) {
    const int col = j * 8 + tig * 2;
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(op + r0 * DV + col) =
          __floats2bfloat162_rn(o[j][0] * i0, o[j][1] * i0);
    if (r1 < nq)
      *reinterpret_cast<__nv_bfloat162*>(op + r1 * DV + col) =
          __floats2bfloat162_rn(o[j][2] * i1, o[j][3] * i1);
  }
}

template <int DQK, int DV = DQK>
int launch(const Args& a, int b, cudaStream_t s) {
  const size_t smem = Shape<DQK, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.hq, b, (a.lq + kBQ - 1) / kBQ);
  flash_tc<DQK, DV><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------- split_decode
namespace dec {

constexpr int kKT = 64;        // keys per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kMaxRows = 64;   // Lq * group
constexpr int kRG = 4;         // rows a thread takes together
constexpr int kBarBytes = 128;

struct DecArgs {
  const void* q;
  const void* k;
  const void* v;
  float* po;                   // (B, Hkv, splits, rows, DV) unnormalized o
  float* pml;                  // (B, Hkv, splits, rows, 2) m (base 2), l
  int hq, hkv, lq, group, rows;
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl;
  float scale_log2;
  int causal, window, q_offset, k_lim, k_begin, k_end, split_len, splits;
};

template <typename T, int DQK, int DV>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);       // elements a 16-byte copy
  static constexpr int kChunks = DQK / kVec;        // even: DQK % 16 == 0
  static constexpr int kChunksV = DV / kVec;
  static constexpr int kRow = DQK + kVec;           // odd number of chunks
  static constexpr int kRowV = DV + kVec;
  static constexpr int kPairs = DV / 2;
  static constexpr int kMaxItems =                  // (row group, pair)
      (kMaxRows / kRG * kPairs + kThreads - 1) / kThreads;
};

// rows padded to whole groups of kRG (kernel.py's decode_smem_bytes is the
// same formula: the wrapper routes a shape that does not fit to scalar)
size_t smem_bytes(size_t elem, int dqk, int dv, int rows) {
  const size_t padded = (rows + kRG - 1) / kRG * kRG;
  return kBarBytes + elem * kStages * kKT * (dqk + dv + 2 * 16 / elem) +
         sizeof(float) * (padded * dqk + padded * kKT + padded * 3 +
                          kThreads * 2 * kRG);
}

// one 16-byte chunk of a K row as floats
__device__ __forceinline__ void chunk_f(const float* k, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(k);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void chunk_f(const __nv_bfloat16* k, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_decode(DecArgs a) {
  using S = Shape<T, DQK, DV>;
  constexpr int kVec = S::kVec, kHalf = S::kChunks / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* ks = reinterpret_cast<T*>(smem + kBarBytes);   // [kStages][kKT][kRow]
  T* vs = ks + kStages * kKT * S::kRow;             // [kStages][kKT][kRowV]
  const int R = a.rows, n_rg = (R + kRG - 1) / kRG, RP = n_rg * kRG;
  float* qs = reinterpret_cast<float*>(vs + kStages * kKT * S::kRowV);
  float* ps = qs + RP * DQK;           // [n_rg][kKT][kRG] scores, then p
  float* ml = ps + RP * kKT;           // [RP][3] m, l, alpha of the tile
  float* red = ml + RP * 3;            // key-group partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int s_begin = a.k_begin + split * a.split_len;
  const int s_end = min(s_begin + a.split_len, a.k_end);
  const int n_kt = s_end > s_begin ? (s_end - s_begin + kKT - 1) / kKT : 0;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  if (tid < kStages) mbar_init(smem_u32(&bars[tid]), kThreads);
  // row r = i * group + j: q head hk * group + j at query row i; rows
  // past R (padding of the last group) are zeros with p = 0 throughout
  for (int idx = tid; idx < RP * DQK; idx += kThreads) {
    const int r = idx / DQK, dd = idx - r * DQK;
    float x = 0.f;
    if (r < R) {
      const int i = r / a.group, j = r - i * a.group;
      x = to_f(static_cast<const T*>(a.q)[
          b * a.qsb + static_cast<long long>(hk * a.group + j) * a.qsh +
          static_cast<long long>(i) * a.qsl + dd]);
    }
    qs[idx] = x;
  }
  for (int idx = tid; idx < RP * kKT; idx += kThreads) ps[idx] = 0.f;
  for (int r = tid; r < RP; r += kThreads) {
    ml[3 * r] = -INFINITY;
    ml[3 * r + 1] = 0.f;
    ml[3 * r + 2] = 1.f;
  }
  __syncthreads();

  auto load_kv = [&](int t, int st) {
    const int k0 = s_begin + t * kKT;
    const uint32_t kd = smem_u32(ks + st * kKT * S::kRow);
    const uint32_t vd = smem_u32(vs + st * kKT * S::kRowV);
    for (int i = tid; i < kKT * S::kChunks; i += kThreads) {
      const int r = i / S::kChunks, c = i - r * S::kChunks;
      const bool ok = k0 + r < s_end;
      const long long row = ok ? k0 + r : 0;
      const uint32_t off = (r * S::kRow + c * kVec) * sizeof(T);
      cp_async16(kd + off, kp + row * a.ksl + c * kVec, ok);
      if constexpr (DQK == DV)
        cp_async16(vd + off, vp + row * a.vsl + c * kVec, ok);
    }
    if constexpr (DQK != DV) {
      for (int i = tid; i < kKT * S::kChunksV; i += kThreads) {
        const int r = i / S::kChunksV, c = i - r * S::kChunksV;
        const bool ok = k0 + r < s_end;
        const long long row = ok ? k0 + r : 0;
        cp_async16(vd + (r * S::kRowV + c * kVec) * sizeof(T),
                   vp + row * a.vsl + c * kVec, ok);
      }
    }
    cp_async_arrive(smem_u32(&bars[st]));
  };
  for (int t = 0; t < kStages && t < n_kt; ++t) load_kv(t, t);

  // scores: item (row group, key); with a single row group two lanes share
  // an item, each taking half the chunks of DQK
  const int n_si = n_rg * kKT;
  const int tpi = n_si < kThreads ? 2 : 1;
  const int half = tpi == 2 ? (tid & 1) : 0;
  // P V: item (row group, dim pair); with fewer items than threads, nkg
  // key groups each sum every nkg-th key of a tile
  const int n_out = n_rg * S::kPairs;
  const int nkg = n_out >= kThreads ? 1 : kThreads / n_out;
  const int kg = n_out >= kThreads ? 0 : tid / n_out;
  const int o_first = n_out >= kThreads ? tid : tid % n_out;
  const bool active = kg < nkg;
  float2 acc[S::kMaxItems][kRG];
#pragma unroll
  for (int i = 0; i < S::kMaxItems; ++i)
#pragma unroll
    for (int rr = 0; rr < kRG; ++rr) acc[i][rr] = make_float2(0.f, 0.f);

  for (int t = 0; t < n_kt; ++t) {
    const int st = t % kStages;
    mbar_wait(smem_u32(&bars[st]), (t / kStages) & 1);
    const int k0 = s_begin + t * kKT;
    const int nk = min(kKT, s_end - k0);
    const T* kt = ks + st * kKT * S::kRow;
    const T* vt = vs + st * kKT * S::kRowV;
    // 1. base-2 scores: each K chunk is read once for kRG rows
    for (int it = tid / tpi; it < n_si; it += kThreads / tpi) {
      const int rg = it / kKT, c = it - rg * kKT;
      float dot[kRG] = {0.f, 0.f, 0.f, 0.f};
      const int nr = min(kRG, R - rg * kRG);       // uniform in the warp
      for (int hh = half; hh < 2; hh += tpi) {
#pragma unroll
        for (int cc = 0; cc < kHalf; ++cc) {
          const int ch = hh * kHalf + cc;
          float kf[kVec];
          chunk_f(kt + c * S::kRow + ch * kVec, kf);
#pragma unroll
          for (int rr = 0; rr < kRG; ++rr) {
            if (rr >= nr) break;
            const float* qr = qs + (rg * kRG + rr) * DQK + ch * kVec;
#pragma unroll
            for (int e = 0; e < kVec; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              dot[rr] = fmaf(qv.x, kf[e], dot[rr]);
              dot[rr] = fmaf(qv.y, kf[e + 1], dot[rr]);
              dot[rr] = fmaf(qv.z, kf[e + 2], dot[rr]);
              dot[rr] = fmaf(qv.w, kf[e + 3], dot[rr]);
            }
          }
        }
      }
      if (tpi == 2) {
#pragma unroll
        for (int rr = 0; rr < kRG; ++rr)
          dot[rr] += __shfl_xor_sync(0xffffffffu, dot[rr], 1);
      }
      if (half == 0) {
        const int kpos = k0 + c;
#pragma unroll
        for (int rr = 0; rr < kRG; ++rr) {
          const int r = rg * kRG + rr;
          if (r >= R) break;
          const int qpos = a.q_offset + r / a.group;
          bool ok = c < nk && kpos < a.k_lim;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && kpos > qpos - a.window;
          ps[it * kRG + rr] = ok ? dot[rr] * a.scale_log2 : -INFINITY;
        }
      }
    }
    __syncthreads();
    // 2. online softmax, a warp a row
    for (int r = warp; r < R; r += kThreads / 32) {
      float* pr = ps + (r / kRG) * kKT * kRG + (r % kRG);
      const float x0 = pr[lane * kRG], x1 = pr[(lane + 32) * kRG];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ml[3 * r];
      const float m_new = fmaxf(m_old, mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f(x0 - mu), p1 = exp2f(x1 - mu);
      pr[lane * kRG] = p0;
      pr[(lane + 32) * kRG] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = exp2f(m_old - mu);
        ml[3 * r] = m_new;
        ml[3 * r + 1] = ml[3 * r + 1] * alpha + sum;
        ml[3 * r + 2] = alpha;
      }
    }
    __syncthreads();
    // 3. acc = acc * alpha + p V: each V pair is read once for kRG rows
    if (active) {
#pragma unroll
      for (int i = 0; i < S::kMaxItems; ++i) {
        const int o = o_first + i * kThreads;
        if (o < n_out) {
          const int rg = o / S::kPairs, dp = o - rg * S::kPairs;
#pragma unroll
          for (int rr = 0; rr < kRG; ++rr) {
            const float alpha = ml[3 * (rg * kRG + rr) + 2];
            acc[i][rr].x *= alpha;
            acc[i][rr].y *= alpha;
          }
          const float* pg = ps + rg * kKT * kRG;
          if (R - rg * kRG == 1) {                  // one row: zamba2's MHA
            for (int c = kg; c < nk; c += nkg) {
              const float p = pg[c * kRG];
              const float2 vv = load_pair(vt + c * S::kRowV + 2 * dp);
              acc[i][0].x = fmaf(p, vv.x, acc[i][0].x);
              acc[i][0].y = fmaf(p, vv.y, acc[i][0].y);
            }
          } else {                                  // pad rows have p = 0
            for (int c = kg; c < nk; c += nkg) {
              const float4 p =
                  *reinterpret_cast<const float4*>(pg + c * kRG);
              const float2 vv = load_pair(vt + c * S::kRowV + 2 * dp);
              acc[i][0].x = fmaf(p.x, vv.x, acc[i][0].x);
              acc[i][0].y = fmaf(p.x, vv.y, acc[i][0].y);
              acc[i][1].x = fmaf(p.y, vv.x, acc[i][1].x);
              acc[i][1].y = fmaf(p.y, vv.y, acc[i][1].y);
              acc[i][2].x = fmaf(p.z, vv.x, acc[i][2].x);
              acc[i][2].y = fmaf(p.z, vv.y, acc[i][2].y);
              acc[i][3].x = fmaf(p.w, vv.x, acc[i][3].x);
              acc[i][3].y = fmaf(p.w, vv.y, acc[i][3].y);
            }
          }
        }
      }
    }
    __syncthreads();                     // stage st and ps are free again
    if (t + kStages < n_kt) load_kv(t + kStages, st);
  }

  // 4. sum the key groups; write the split's partials
  if (nkg > 1) {
    if (active) {
#pragma unroll
      for (int rr = 0; rr < kRG; ++rr) {
        red[2 * (tid * kRG + rr)] = acc[0][rr].x;
        red[2 * (tid * kRG + rr) + 1] = acc[0][rr].y;
      }
    }
    __syncthreads();
    if (kg == 0) {
      for (int gi = 1; gi < nkg; ++gi) {
        const int from = (gi * n_out + o_first) * kRG;
#pragma unroll
        for (int rr = 0; rr < kRG; ++rr) {
          acc[0][rr].x += red[2 * (from + rr)];
          acc[0][rr].y += red[2 * (from + rr) + 1];
        }
      }
    }
  }
  const long long base =
      ((static_cast<long long>(b) * a.hkv + hk) * a.splits + split) * R;
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < S::kMaxItems; ++i) {
      const int o = o_first + i * kThreads;
      if (o < n_out) {
        const int rg = o / S::kPairs, dp = o - rg * S::kPairs;
#pragma unroll
        for (int rr = 0; rr < kRG; ++rr) {
          const int r = rg * kRG + rr;
          if (r < R)
            *reinterpret_cast<float2*>(a.po + (base + r) * DV + 2 * dp) =
                acc[i][rr];
        }
      }
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    a.pml[2 * (base + r)] = ml[3 * r];
    a.pml[2 * (base + r) + 1] = ml[3 * r + 1];
  }
}

// out[b, hk * group + j, i] = sum_s o_s 2^(m_s - M) / sum_s l_s 2^(m_s - M),
// M = max_s m_s; 0 where no split saw a key.  One block per (b, hk, row).
template <typename T>
__global__ void __launch_bounds__(128) flash_combine(DecArgs a, int d,
                                                     void* out) {
  const int row = blockIdx.x;
  const int r = row % a.rows, bh = row / a.rows;
  const int hk = bh % a.hkv, b = bh / a.hkv;
  const long long base = static_cast<long long>(bh) * a.splits * a.rows + r;
  float m_max = -INFINITY;
  for (int s = 0; s < a.splits; ++s)
    m_max = fmaxf(m_max, a.pml[2 * (base + s * a.rows)]);
  float l = 0.f, acc = 0.f;
  const int dd = threadIdx.x;
  if (m_max != -INFINITY) {
    for (int s = 0; s < a.splits; ++s) {
      const long long at = base + s * a.rows;
      const float w = exp2f(a.pml[2 * at] - m_max);   // 0 for an empty split
      l = fmaf(a.pml[2 * at + 1], w, l);
      if (dd < d) acc = fmaf(a.po[at * d + dd], w, acc);
    }
  }
  if (dd >= d) return;
  const int i = r / a.group, j = r - i * a.group;
  T* op = static_cast<T*>(out) +
          ((static_cast<long long>(b) * a.hq + hk * a.group + j) * a.lq + i) *
              d;
  op[dd] = from_f<T>(l > 0.f ? acc / l : 0.f);
}

template <typename T, int DQK, int DV = DQK>
int launch(const DecArgs& a, int b, void* out, cudaStream_t s) {
  static_assert(DV <= 128, "flash_combine has a thread per output dim");
  const size_t smem = smem_bytes(sizeof(T), DQK, DV, a.rows);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode<T, DQK, DV><<<dim3(a.splits, a.hkv, b), kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_combine<T><<<b * a.hkv * a.rows, 128, 0, s>>>(a, DV, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dec

}  // namespace

// q (B, Hq, Lq, DQK), k (B, Hkv, Lk, DQK), v (B, Hkv, Lk, DV) with the given
// element strides of their batch, head and row axes (the last axis
// contiguous); out (B, Hq, Lq, DV) contiguous.  window <= 0 means no window.
// lse (B, Hq, Lq) float32 contiguous, or null (scalar and tc_prefill
// routes): each row's log-sum-exp of its scaled scores, -1e30 for a row
// that sees no key.  Each entry point returns the cudaError_t of its
// launches (0 on success).

// scalar route: any dqk, dv <= 256; dtype 0 = float32, 1 = bfloat16 (all
// four tensors)
extern "C" int craft_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int b, int hq,
    int hkv, int lq, int lk, int dqk, int dv, long long qsb, long long qsh,
    long long qsl, long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl, float scale, int causal,
    int window, int q_offset, int kv_len, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || dqk <= 0 ||
      dqk > kDMax || dv <= 0 || dv > kDMax || lq < 0 || lk < 0 ||
      b > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lq == 0) return 0;
  Args a{q, k, v, out, static_cast<float*>(lse), hq, hkv, lq, lk, dqk, dv,
         qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, scale, causal, window,
         q_offset, kv_len};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return scalar::launch<float>(a, b, s);
  if (dtype == 1) return scalar::launch<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tc_prefill route: bfloat16, dqk == dv a multiple of 16 up to 128, or
// (dqk, dv) = (192, 128); q, k, v bases and strides 16-byte aligned
extern "C" int craft_flash_prefill_tc(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int b, int hq,
    int hkv, int lq, int lk, int dqk, int dv, long long qsb, long long qsh,
    long long qsl, long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl, float scale, int causal,
    int window, int q_offset, int kv_len, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || lq < 0 || lk < 0 ||
      b > 65535 || hq > 65535 ||
      (lq + tc::kBQ - 1) / tc::kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lq == 0) return 0;
  Args a{q, k, v, out, static_cast<float*>(lse), hq, hkv, lq, lk, dqk, dv,
         qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, scale, causal, window,
         q_offset, kv_len};
  auto s = static_cast<cudaStream_t>(stream);
  if (dqk == 192 && dv == 128) return tc::launch<192, 128>(a, b, s);
  if (dqk != dv) return static_cast<int>(cudaErrorInvalidValue);
  switch (dqk) {
    case 16: return tc::launch<16>(a, b, s);
    case 32: return tc::launch<32>(a, b, s);
    case 48: return tc::launch<48>(a, b, s);
    case 64: return tc::launch<64>(a, b, s);
    case 80: return tc::launch<80>(a, b, s);
    case 96: return tc::launch<96>(a, b, s);
    case 112: return tc::launch<112>(a, b, s);
    case 128: return tc::launch<128>(a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int decode_d(const dec::DecArgs& a, int b, int dqk, int dv, void* out,
             cudaStream_t s) {
  if (dqk == 192 && dv == 128) return dec::launch<T, 192, 128>(a, b, out, s);
  if (dqk != dv) return static_cast<int>(cudaErrorInvalidValue);
  switch (dqk) {
    case 16: return dec::launch<T, 16>(a, b, out, s);
    case 32: return dec::launch<T, 32>(a, b, out, s);
    case 48: return dec::launch<T, 48>(a, b, out, s);
    case 64: return dec::launch<T, 64>(a, b, out, s);
    case 80: return dec::launch<T, 80>(a, b, out, s);
    case 96: return dec::launch<T, 96>(a, b, out, s);
    case 112: return dec::launch<T, 112>(a, b, out, s);
    case 128: return dec::launch<T, 128>(a, b, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// split_decode route: Lq * (Hq / Hkv) <= 64 rows, the (dqk, dv) pairs of
// tc_prefill, dtype 0 = float32, 1 = bfloat16; the visible keys
// [k_begin, k_end) (kv_len already folded into k_lim = min(Lk, kv_len)) in
// `splits` splits of split_len keys; part_o (B, Hkv, splits, rows, DV) and
// part_ml (B, Hkv, splits, rows, 2) float32 scratch
extern "C" int craft_flash_decode(
    const void* q, const void* k, const void* v, void* out, void* part_o,
    void* part_ml, int b, int hq, int hkv, int lq, int dqk, int dv,
    long long qsb,
    long long qsh, long long qsl, long long ksb, long long ksh,
    long long ksl, long long vsb, long long vsh, long long vsl, float scale,
    int causal, int window, int q_offset, int k_lim, int k_begin, int k_end,
    int split_len, int splits, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || lq <= 0 ||
      lq * (hq / hkv) > dec::kMaxRows || splits <= 0 || split_len <= 0 ||
      b > 65535 || hkv > 65535 || splits > 65535 ||
      static_cast<long long>(b) * hkv * lq * (hq / hkv) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = hq / hkv;
  dec::DecArgs a{q, k, v, static_cast<float*>(part_o),
                 static_cast<float*>(part_ml), hq, hkv, lq, group,
                 lq * group, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl,
                 scale * kLog2e, causal, window, q_offset, k_lim, k_begin,
                 k_end, split_len, splits};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return decode_d<float>(a, b, dqk, dv, out, s);
  if (dtype == 1) return decode_d<__nv_bfloat16>(a, b, dqk, dv, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
