// One three-term Lanczos step on the graphene lattice, in three passes.
//
// Replaces no TPU kernel: the reference's matvec and step are plain jnp
// (repro/apps/lanczos.py), and the port ran them as some 25 eager PyTorch
// passes, each reading or writing whole vectors.  The state is an
// (nx, ny, 2) float32 grid, site (x, y) holding its A and B amplitudes
// side by side.  The tight-binding stencil with periodic boundaries is
//
//   (H v)_A(x, y) = t [(v_B(x, y) + v_B(x-1, y)) + v_B(x, y-1)] + eps_A v_A
//   (H v)_B(x, y) = t [(v_A(x, y) + v_A(x+1, y)) + v_A(x, y+1)] + eps_B v_B
//
// Bound: device-memory bytes.  A step must read v_cur, v_prev and eps and
// write v_new (4 vectors); these passes move 8:
//   1. stencil + alpha: read v_cur and eps, one partial of sum w v_cur a
//      block (w is not written: pass 2 recomputes it);
//   2. update + beta: every block sums alpha's partials, recomputes w,
//      reads v_prev, writes w' = w - alpha v_cur - beta v_prev into v_new
//      and one partial of sum w'^2;
//   3. scale: every block sums beta's partials, beta_new = sqrt, and
//      v_new /= (beta_new, or 1 where it is 0), in place.
// Design: ny is even and every vector 16-byte aligned (the wrapper
// checks), so a thread's two sites are one 16-byte load.  In the stencil
// passes a block of 256 threads covers a strip of 512 sites of a row and
// walks `rows` consecutive rows, keeping the row above and the row below
// in registers, so each row is read from memory once (plus one halo row
// at each end of the walk).  The y neighbours come from the next and the
// previous lane by warp shuffle, or from the row itself (already in L1)
// at a warp's edge and at the periodic boundary.
//
// Determinism: the grid depends only on (nx, ny) (the caller computes
// `rows` from them); a thread adds its products in memory order, a block
// adds its threads' sums by a fixed shuffle tree and writes one partial;
// partials are summed in a fixed order by every block that needs them.
// No atomics.  Every product and sum is a single float32 rounding
// (__fmul_rn / __fadd_rn: no fused multiply-add), in the order of the
// plain PyTorch step, and sqrt and the divide are IEEE, so the plain
// mirror of kernels/lanczos/ref.py gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 2 * kThreads;
constexpr unsigned kFull = 0xffffffffu;

struct Sites {  // a thread's two sites of one row: (a0, b0), (a1, b1)
  float a0, b0, a1, b1;
};

// The sum of v over the block by the shuffle tree; valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
  }
  return v;
}

// The sum of n partials in the fixed order, in every thread of the block.
__device__ __forceinline__ float sum_partials(const float* __restrict__ p,
                                              int n, float* sh) {
  __shared__ float total;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc = __fadd_rn(acc, p[i]);
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) total = acc;
  __syncthreads();
  return total;
}

__device__ __forceinline__ Sites load_sites(const float* __restrict__ row,
                                            int y0, bool on) {
  if (!on) return {0.f, 0.f, 0.f, 0.f};
  const float4 q = *reinterpret_cast<const float4*>(row + 2 * y0);
  return {q.x, q.y, q.z, q.w};
}

__device__ __forceinline__ void store_sites(float* __restrict__ row, int y0,
                                            bool on, const Sites& s) {
  if (on)
    *reinterpret_cast<float4*>(row + 2 * y0) =
        make_float4(s.a0, s.b0, s.a1, s.b1);
}

// A block's walk down its rows: the row above (its B amplitudes), the
// current row and the row below, so w of the current row is at hand.
struct Walk {
  const float* __restrict__ v;
  int nx, ny, y0, lane;
  bool on;           // this thread's sites exist (ny is even: both or none)
  long long stride;  // floats a row
  float pb0, pb1;    // B of row x-1
  Sites cur, nxt;

  __device__ Walk(const float* __restrict__ v_, int nx_, int ny_, int x)
      : v(v_), nx(nx_), ny(ny_) {
    lane = threadIdx.x & 31;
    y0 = blockIdx.x * kStrip + 2 * threadIdx.x;
    on = y0 < ny;
    stride = 2LL * ny;
    const Sites up =
        load_sites(v + stride * (x == 0 ? nx - 1 : x - 1), y0, on);
    pb0 = up.b0;
    pb1 = up.b1;
    cur = load_sites(v + stride * x, y0, on);
  }

  // Load row x + 1 (periodic).
  __device__ __forceinline__ void fetch(int x) {
    nxt = load_sites(v + stride * (x + 1 == nx ? 0 : x + 1), y0, on);
  }

  // w of row x at this thread's sites (t, eps e), in the plain step's
  // order of operations.  Every lane of the warp calls it (shuffles).
  __device__ __forceinline__ Sites w(int x, float t, const Sites& e) const {
    const float* row = v + stride * x;
    // A of the site after our second, B of the site before our first
    float ar1 = __shfl_down_sync(kFull, cur.a0, 1);
    float bl0 = __shfl_up_sync(kFull, cur.b1, 1);
    if (on && (lane == 31 || y0 + 2 >= ny))
      ar1 = row[y0 + 2 < ny ? 2 * (y0 + 2) : 0];
    if (on && lane == 0) bl0 = row[2 * (y0 == 0 ? ny - 1 : y0 - 1) + 1];
    Sites r;
    r.a0 = __fadd_rn(
        __fmul_rn(t, __fadd_rn(__fadd_rn(cur.b0, pb0), bl0)),
        __fmul_rn(e.a0, cur.a0));
    r.b0 = __fadd_rn(
        __fmul_rn(t, __fadd_rn(__fadd_rn(cur.a0, nxt.a0), cur.a1)),
        __fmul_rn(e.b0, cur.b0));
    r.a1 = __fadd_rn(
        __fmul_rn(t, __fadd_rn(__fadd_rn(cur.b1, pb1), cur.b0)),
        __fmul_rn(e.a1, cur.a1));
    r.b1 = __fadd_rn(
        __fmul_rn(t, __fadd_rn(__fadd_rn(cur.a1, nxt.a1), ar1)),
        __fmul_rn(e.b1, cur.b1));
    return r;
  }

  __device__ __forceinline__ void advance() {
    pb0 = cur.b0;
    pb1 = cur.b1;
    cur = nxt;
  }
};

// acc + x.a0 y.a0 + x.b0 y.b0 + x.a1 y.a1 + x.b1 y.b1, in memory order,
// where the sites exist.
__device__ __forceinline__ float dot_add(float acc, const Sites& x,
                                         const Sites& y, bool on) {
  if (on) {
    acc = __fadd_rn(acc, __fmul_rn(x.a0, y.a0));
    acc = __fadd_rn(acc, __fmul_rn(x.b0, y.b0));
    acc = __fadd_rn(acc, __fmul_rn(x.a1, y.a1));
    acc = __fadd_rn(acc, __fmul_rn(x.b1, y.b1));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
alpha_pass(const float* __restrict__ v, const float* __restrict__ eps,
           float* __restrict__ part, int nx, int ny, int rows, float t) {
  __shared__ float sh[kWarps];
  const int x0 = blockIdx.y * rows;
  const int x1 = min(x0 + rows, nx);
  Walk walk(v, nx, ny, x0);
  float acc = 0.f;
  for (int x = x0; x < x1; ++x) {
    walk.fetch(x);
    const Sites e = load_sites(eps + walk.stride * x, walk.y0, walk.on);
    const Sites w = walk.w(x, t, e);
    acc = dot_add(acc, w, walk.cur, walk.on);
    walk.advance();
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) part[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
update_pass(const float* __restrict__ v, const float* __restrict__ eps,
            const float* __restrict__ vp, float* __restrict__ out,
            const float* __restrict__ apart, float* __restrict__ bpart,
            float* __restrict__ ab, int nx, int ny, int rows, float t,
            float beta) {
  __shared__ float sh[kWarps];
  const int nparts = gridDim.x * gridDim.y;
  const float alpha = sum_partials(apart, nparts, sh);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) ab[0] = alpha;
  const int x0 = blockIdx.y * rows;
  const int x1 = min(x0 + rows, nx);
  Walk walk(v, nx, ny, x0);
  float acc = 0.f;
  for (int x = x0; x < x1; ++x) {
    walk.fetch(x);
    const long long off = walk.stride * x;
    const Sites e = load_sites(eps + off, walk.y0, walk.on);
    const Sites p = load_sites(vp + off, walk.y0, walk.on);
    Sites w = walk.w(x, t, e);
    const Sites& c = walk.cur;
    // (w - alpha v) - beta v_prev, as the plain step
    w.a0 = __fsub_rn(__fsub_rn(w.a0, __fmul_rn(alpha, c.a0)),
                     __fmul_rn(beta, p.a0));
    w.b0 = __fsub_rn(__fsub_rn(w.b0, __fmul_rn(alpha, c.b0)),
                     __fmul_rn(beta, p.b0));
    w.a1 = __fsub_rn(__fsub_rn(w.a1, __fmul_rn(alpha, c.a1)),
                     __fmul_rn(beta, p.a1));
    w.b1 = __fsub_rn(__fsub_rn(w.b1, __fmul_rn(alpha, c.b1)),
                     __fmul_rn(beta, p.b1));
    store_sites(out + off, walk.y0, walk.on, w);
    acc = dot_add(acc, w, w, walk.on);
    walk.advance();
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) bpart[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

// v_new /= (beta_new, or 1 where it is 0), in float4s (n % 4 == 0).
__global__ void __launch_bounds__(kThreads)
scale_pass(float4* __restrict__ out, const float* __restrict__ bpart,
           int nparts, float* __restrict__ ab, long long n4) {
  __shared__ float sh[kWarps];
  const float beta = __fsqrt_rn(sum_partials(bpart, nparts, sh));
  if (blockIdx.x == 0 && threadIdx.x == 0) ab[1] = beta;
  const float d = beta == 0.f ? 1.f : beta;
  const long long step = 1LL * gridDim.x * kThreads;
  for (long long i = 1LL * blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += step) {
    float4 q = out[i];
    q.x = __fdiv_rn(q.x, d);
    q.y = __fdiv_rn(q.y, d);
    q.z = __fdiv_rn(q.z, d);
    q.w = __fdiv_rn(q.w, d);
    out[i] = q;
  }
}

constexpr int kScaleBlocks = 132 * 8;

}  // namespace

// One step: vp, v, eps, out are (nx, ny, 2) float32, contiguous, 16-byte
// aligned, ny even; scratch holds 2 + 2 * blocks floats: [alpha,
// beta_new], then the two passes' partials.  `rows` is the rows a block
// walks, from kernels/lanczos/ref.py::geometry.  Returns the cudaError_t
// of the launches (0 on success).
extern "C" int craft_lanczos_step(const void* v_prev, const void* v_cur,
                                  const void* eps, void* v_new,
                                  void* scratch, int nx, int ny, int rows,
                                  float t, float beta, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(v_prev) |
                         reinterpret_cast<uintptr_t>(v_cur) |
                         reinterpret_cast<uintptr_t>(eps) |
                         reinterpret_cast<uintptr_t>(v_new)) % 16) == 0;
  if (nx < 2 || ny < 2 || ny % 2 || rows < 1 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long strips = (ny + kStrip - 1) / kStrip;
  const long long groups = (nx + rows - 1) / rows;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int nparts = static_cast<int>(strips * groups);
  const auto* vp = static_cast<const float*>(v_prev);
  const auto* v = static_cast<const float*>(v_cur);
  const auto* e = static_cast<const float*>(eps);
  auto* out = static_cast<float*>(v_new);
  auto* ab = static_cast<float*>(scratch);
  float* apart = ab + 2;
  float* bpart = apart + nparts;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(strips),
                  static_cast<unsigned>(groups));
  alpha_pass<<<grid, kThreads, 0, s>>>(v, e, apart, nx, ny, rows, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  update_pass<<<grid, kThreads, 0, s>>>(v, e, vp, out, apart, bpart, ab, nx,
                                        ny, rows, t, beta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = 2LL * nx * ny / 4;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kScaleBlocks) blocks = kScaleBlocks;
  scale_pass<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      reinterpret_cast<float4*>(out), bpart, nparts, ab, n4);
  return static_cast<int>(cudaGetLastError());
}
