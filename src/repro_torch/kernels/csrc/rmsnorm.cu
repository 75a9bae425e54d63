// RMSNorm over the last axis, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `rmsnorm_pallas` -> `_kernel`
// (src/repro/kernels/rmsnorm.py:23, :16):
//
//   out = x * rsqrt(mean(x^2) + eps) * w        (f32 inside, rows of d)
//
// Bound on this card: bytes.  Each element must be read from device memory
// once and written once, with a handful of operations per element, far
// below the card's ratio of operations to bytes.  The LM path launches it
// at two shapes: many rows (a long prefill, [14812, 2048]) and a few
// (a decode step, [4, 2048]; a short prefill of <= 128 rows).  Two
// variants, chosen by the wrapper (rmsnorm.norm_variant) from d and the
// pointers' alignment:
//
//   split   — a row over a whole CTA, one or two 16-byte vectors per
//             thread, held in registers from load to store (the row is
//             read once); warp shuffles, then one shared-memory step under
//             one barrier.  Every row of whole 16-byte vectors, up to 2048
//             of them.  On the H100 it beat a grid of the card's resident
//             warps, each holding its columns of w in registers and a row
//             at a time (the next one prefetched), at both shapes the LM
//             path launches: one CTA per row keeps more rows in flight.
//   generic — any d, any alignment: one warp per row, two passes over the
//             row (the second from L1), scalar or 16-byte loads.
//
// Two roundings, because the Pallas kernel and the model's jnp RMSNorm
// (src/repro/models/layers.py:24) round differently in bf16:
//   kModel = false ("pallas"): (y * w) in f32, rounded once to x's type;
//   kModel = true  ("model"):  y rounded to x's type, times w rounded to
//                              x's type, the product rounded again.
// In f32 both are the same function.  Sums of squares are f32 in both
// variants: per-thread partials in element order, then an xor-shuffle tree
// (and, in the split variant, the warps' sums added in warp order); the
// plain replay of the split order is rmsnorm.rmsnorm_split_order.
//
// The backward (training) -- rmsnorm_bwd_rows_kernel ("rows"),
// rmsnorm_bwd_kernel ("generic") and the reduction of their partials,
// rmsnorm_bwd_reduce_kernel -- is described where it is defined.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGenericThreads = 256;      // 8 rows (warps) per CTA
constexpr int kMaxSplitThreads = 1024;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);             // round to nearest even
}

// x rounded to T and back (the identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// VEC elements of T per lane per step: 16 bytes when the row allows it.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The VEC weights of 16-byte vector i, in f32 (rounded to T for the
// model's rounding): VEC / 4 16-byte loads.
template <typename T, bool kModel>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int i,
                                       float (&wf)[16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  const float4* w4 = reinterpret_cast<const float4*>(w) + i * (VEC / 4);
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 f = __ldg(w4 + q);
    wf[4 * q] = f.x;
    wf[4 * q + 1] = f.y;
    wf[4 * q + 2] = f.z;
    wf[4 * q + 3] = f.w;
  }
  if (kModel) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) wf[e] = round_to<T>(wf[e]);
  }
}

// One output vector from x's vector, the row's factor r and the weights.
template <typename T, bool kModel>
__device__ __forceinline__ Vec<T, 16 / sizeof(T)> scale(
    const Vec<T, 16 / sizeof(T)>& a, float r, const float (&wf)[16 / sizeof(T)]) {
  Vec<T, 16 / sizeof(T)> b;
#pragma unroll
  for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) {
    float y = to_f32<T>(a.v[e]) * r;
    if (kModel) y = round_to<T>(y);
    b.v[e] = from_f32<T>(y * wf[e]);
  }
  return b;
}

template <typename T, int VEC>
__device__ __forceinline__ float sum_sq(const Vec<T, VEC>& a, float ss) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float f = to_f32<T>(a.v[e]);
    ss += f * f;
  }
  return ss;
}

// ---------------------------------------------------------------------------
// split: one row per CTA, VPT 16-byte vectors per thread
// ---------------------------------------------------------------------------
template <typename T, int VPT, bool kModel>
__global__ void __launch_bounds__(kMaxSplitThreads)
rmsnorm_split_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using V = Vec<T, VEC>;
  __shared__ float s_part[kMaxSplitThreads / 32];
  const int nv = d / VEC;
  const V* xr = reinterpret_cast<const V*>(
      x + static_cast<size_t>(blockIdx.x) * d);
  V a[VPT];
  bool has[VPT];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + blockDim.x * k;
    has[k] = i < nv;
    if (has[k]) a[k] = xr[i];
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (has[k]) ss = sum_sq(a[k], ss);
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
  for (int j = 0; j < static_cast<int>(blockDim.x / 32); ++j)
    total += s_part[j];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);
  V* orow = reinterpret_cast<V*>(out + static_cast<size_t>(blockIdx.x) * d);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (has[k]) {
      const int i = threadIdx.x + blockDim.x * k;
      float wf[VEC];
      load_w<T, kModel>(w, i, wf);
      orow[i] = scale<T, kModel>(a[k], r, wf);
    }
  }
}

// ---------------------------------------------------------------------------
// generic: one warp per row, two passes
// ---------------------------------------------------------------------------
template <typename T, int VEC, bool kModel>
__global__ void __launch_bounds__(kGenericThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * (kGenericThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  using V = Vec<T, VEC>;
  const V* xr = reinterpret_cast<const V*>(x + static_cast<size_t>(row) * d);
  V* orow = reinterpret_cast<V*>(out + static_cast<size_t>(row) * d);
  const int nv = d / VEC;
  float ss = 0.f;
  for (int i = lane; i < nv; i += 32) ss = sum_sq(xr[i], ss);
  const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  for (int i = lane; i < nv; i += 32) {
    const V a = xr[i];
    V b;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float y = to_f32<T>(a.v[e]) * r;
      float wi = w[i * VEC + e];
      if (kModel) {
        y = round_to<T>(y);
        wi = round_to<T>(wi);
      }
      b.v[e] = from_f32<T>(y * wi);
    }
    orow[i] = b;
  }
}

template <typename T, bool kModel>
int launch_typed(const void* xv, const float* w, void* outv, int rows, int d,
                 int variant, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const bool aligned = d % kVec == 0 &&
                       reinterpret_cast<size_t>(x) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0 &&
                       reinterpret_cast<size_t>(w) % 16 == 0;
  const int nv = d / kVec;
  if (variant == 0) {                     // split
    if (!aligned || nv > 2 * kMaxSplitThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    const int vpt = nv <= 256 ? 1 : 2;
    const int threads = ((nv + vpt - 1) / vpt + 31) / 32 * 32;
    if (vpt == 1)
      rmsnorm_split_kernel<T, 1, kModel><<<rows, threads, 0, stream>>>(
          x, w, out, d, eps);
    else
      rmsnorm_split_kernel<T, 2, kModel><<<rows, threads, 0, stream>>>(
          x, w, out, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (rows + kGenericThreads / 32 - 1) / (kGenericThreads / 32);
  const bool vec = d % kVec == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  if (vec)
    rmsnorm_kernel<T, kVec, kModel><<<grid, kGenericThreads, 0, stream>>>(
        x, w, out, rows, d, eps);
  else
    rmsnorm_kernel<T, 1, kModel><<<grid, kGenericThreads, 0, stream>>>(
        x, w, out, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward (training): dx, and dw through per-CTA partials
// ---------------------------------------------------------------------------
// Replaces the gradient the JAX package takes by autodiff of the model's
// jnp RMSNorm (src/repro/models/layers.py:24); the Pallas kernel has no
// backward.  With r = rsqrt(mean(x^2) + eps), x^ = x r and the incoming
// gradient dy:
//   g  = dy w            (dy times w rounded to T, the product rounded
//                         to T, as the model's product is)
//   dx = r (g - x^ mean(g x^)),  rounded to T
//   dw = sum over rows of dy a,  a = x^ rounded to T, f32
// (the gradient of the model's rounding; the Pallas kernel's rounding has
// no backward here, since nothing trains through it).
//
// Bound by bytes: x and dy read once, dx written once, w read and dw
// written once (50.3 MB at [4096, 2048] bf16, 15 µs at 3.35 TB/s).  What
// the design does about it (rmsnorm_bwd_rows_kernel, the "rows" variant):
//   * a group of WPR warps owns a whole row, each lane VPL 16-byte vectors
//     of it (rmsnorm.rows_shape: 2 a lane, 4 warps a row at d = 2048 in
//     bf16), x and dy read once into registers, and the group's next row
//     loaded while this one is worked (two rows in flight a group); few
//     vectors a lane leave registers for 16 warps an SM;
//   * g = dy w, exact in T, kept in registers between the two passes;
//   * both sums (sum x^2, sum g x) by warp shuffles; a group of several
//     warps adds its warps' sums in warp order after a named barrier of
//     the group (sums double-buffered by row parity), never a CTA barrier;
//   * w, rounded to T, staged once a CTA in shared memory;
//   * the grid is sized to the card (the wrapper: SMs x resident CTAs,
//     at most a row per group), each group strides over the rows in a
//     fixed assignment (row = CTA G + group + k gridDim G), and each lane
//     keeps its columns' sum of dy a in registers across its rows (a
//     product rounded, then added: no fused multiply-add, so the sum is
//     replayed exactly);
//   * at the end the CTA's groups add their sums into shared memory in
//     group order, one f32 partial [d] a CTA; rmsnorm_bwd_reduce_kernel
//     sums the partials over many CTAs (32 columns and 8 slices of the
//     partials a CTA, each slice in order, then a fixed tree over the
//     slices).  No atomics: two calls are byte-equal.  The plain replays
//     are rmsnorm.rmsnorm_backward_partials and rmsnorm.reduce_partials.
// rmsnorm_bwd_kernel<T> (the "generic" variant: d up to kBwdMaxD that is
// not whole 16-byte vectors, or unaligned, or wider than 8 warps hold in 4
// vectors a lane) keeps the first design: CTA c (256 threads) takes the
// rows [c R, (c + 1) R) one after the other, two passes over each row
// under two CTA barriers, a column of the CTA's partial of dw per thread
// in shared memory, one element a thread.
constexpr int kBwdThreads = 256;
// the generic variant's partial of dw (dynamic) and red (static) share
// 48 KB of shared memory
constexpr int kBwdRedBytes = 2 * (kBwdThreads / 32) * sizeof(float);
constexpr int kBwdMaxD = (48 * 1024 - kBwdRedBytes) / sizeof(float);  // 12272
constexpr int kRowsWarps = 8;             // warps of a rows CTA
constexpr int kReduceSlices = 8;          // rows of a reduction CTA

template <typename T>
__device__ __forceinline__ float grad_in(float dyf, float wf) {
  return round_to<T>(dyf * round_to<T>(wf));
}

// A barrier of the `threads` threads of named barrier `id` (1 .. 15).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T, int VPL, int WPR>
__global__ void __launch_bounds__(32 * kRowsWarps)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, int rows, int d,
                        float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int G = kRowsWarps / WPR;       // groups (rows in flight)
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) float ws[];   // d: w in T, then dw
  __shared__ float red[2][kRowsWarps][2];
  const int nv = d / VEC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / WPR, gl = (warp % WPR) * 32 + lane;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    ws[i] = round_to<T>(w[i]);
  __syncthreads();
  float acc[VPL][VEC];
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
  auto load = [&](int row, V (&a)[VPL], V (&b)[VPL]) {
    const V* xr = reinterpret_cast<const V*>(x + static_cast<size_t>(row) * d);
    const V* gr = reinterpret_cast<const V*>(dy + static_cast<size_t>(row) * d);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = gl + 32 * WPR * k;
      if (i < nv) {
        a[k] = xr[i];
        b[k] = gr[i];
      }
    }
  };
  const int stride = gridDim.x * G;
  int par = 0;
  int row = blockIdx.x * G + grp;
  V a[VPL], b[VPL];
  if (row < rows) load(row, a, b);
  for (; row < rows; row += stride) {
    V an[VPL], bn[VPL], gv[VPL];
    if (row + stride < rows) load(row + stride, an, bn);
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = gl + 32 * WPR * k;
      if (i < nv) {
        const float4* w4 = reinterpret_cast<const float4*>(ws + i * VEC);
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 f = w4[q];
          const float wq[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 4 * q + u;
            const float xf = to_f32<T>(a[k].v[e]);
            gv[k].v[e] = from_f32<T>(to_f32<T>(b[k].v[e]) * wq[u]);
            const float g = to_f32<T>(gv[k].v[e]);
            ss += xf * xf;
            sg += g * xf;
          }
        }
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if (WPR > 1) {
      if (lane == 0) {
        red[par][warp][0] = ss;
        red[par][warp][1] = sg;
      }
      group_sync(1 + grp, 32 * WPR);
      ss = sg = 0.f;
#pragma unroll
      for (int j = 0; j < WPR; ++j) {
        ss += red[par][grp * WPR + j][0];
        sg += red[par][grp * WPR + j][1];
      }
      par ^= 1;
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float mean = sg * r / static_cast<float>(d);    // mean(g x^)
    V* dxr = reinterpret_cast<V*>(dx + static_cast<size_t>(row) * d);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = gl + 32 * WPR * k;
      if (i < nv) {
        V out;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float dyf = to_f32<T>(b[k].v[e]);
          const float xh = to_f32<T>(a[k].v[e]) * r;
          out.v[e] = from_f32<T>(r * (to_f32<T>(gv[k].v[e]) - xh * mean));
          acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(dyf, round_to<T>(xh)));
        }
        dxr[i] = out;
      }
    }
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      a[k] = an[k];
      b[k] = bn[k];
    }
  }
  // the groups' sums into the CTA's partial, in group order
  __syncthreads();                          // w is read no more
  for (int j = 0; j < G; ++j) {
    if (grp == j) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int i = gl + 32 * WPR * k;
        if (i < nv) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            ws[i * VEC + e] = j == 0 ? acc[k][e]
                                     : __fadd_rn(ws[i * VEC + e], acc[k][e]);
        }
      }
    }
    __syncthreads();
  }
  float* pr = part + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) pr[c] = ws[c];
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ part, int rows, int d,
                   int rows_per_cta, float eps) {
  extern __shared__ float dw_s[];           // d floats: this CTA's partial
  __shared__ float red[2][kBwdThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < d; i += kBwdThreads) dw_s[i] = 0.f;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + static_cast<size_t>(row) * d;
    const T* gr = dy + static_cast<size_t>(row) * d;
    float ss = 0.f, sg = 0.f;
    for (int i = tid; i < d; i += kBwdThreads) {
      const float xf = to_f32<T>(xr[i]);
      const float g = grad_in<T>(to_f32<T>(gr[i]), w[i]);
      ss += xf * xf;
      sg += g * xf;
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sg;
    }
    __syncthreads();
    float tss = 0.f, tsg = 0.f;
    for (int j = 0; j < kBwdThreads / 32; ++j) {
      tss += red[0][j];
      tsg += red[1][j];
    }
    __syncthreads();                        // red is the next row's
    const float r = rsqrtf(tss / static_cast<float>(d) + eps);
    const float mean = tsg * r / static_cast<float>(d);   // mean(g x^)
    T* dxr = dx + static_cast<size_t>(row) * d;
    for (int i = tid; i < d; i += kBwdThreads) {
      const float dyf = to_f32<T>(gr[i]);
      const float g = grad_in<T>(dyf, w[i]);
      const float xh = to_f32<T>(xr[i]) * r;
      dxr[i] = from_f32<T>(r * (g - xh * mean));
      dw_s[i] = __fadd_rn(dw_s[i], __fmul_rn(dyf, round_to<T>(xh)));
    }
  }
  float* pr = part + static_cast<size_t>(blockIdx.x) * d;
  for (int i = tid; i < d; i += kBwdThreads) pr[i] = dw_s[i];
}

// dw[c] = the partials' column c summed: slice s of the CTA's 8 sums rows
// s, s + 8, ... in order, then ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6
// + s7)).  A CTA takes 32 columns (a warp reads 128 contiguous bytes a row).
__global__ void __launch_bounds__(32 * kReduceSlices)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ dw, int n_cta, int d) {
  __shared__ float s[kReduceSlices][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (c < d)
    for (int j = ty; j < n_cta; j += kReduceSlices)
      acc += part[static_cast<size_t>(j) * d + c];
  s[ty][tx] = acc;
#pragma unroll
  for (int h = 1; h < kReduceSlices; h <<= 1) {
    __syncthreads();
    if (ty % (2 * h) == 0) s[ty][tx] += s[ty + h][tx];
  }
  if (ty == 0 && c < d) dw[c] = s[0][tx];
}

// The rows kernel of (VPL, WPR) as a function of T: its launch, or (launch
// == false) the CTAs of it an SM holds (its shared memory, 4 d bytes, is
// at most 32 KB: no opt-in).
template <typename T, int VPL, int WPR>
int rows_entry(bool launch, const void* x, const float* w, const void* dy,
               void* dx, float* part, int rows, int d, int n_cta, float eps,
               cudaStream_t stream) {
  auto kernel = rmsnorm_bwd_rows_kernel<T, VPL, WPR>;
  const size_t smem = sizeof(float) * d;
  if (!launch) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, 32 * kRowsWarps, smem);
    return e == cudaSuccess ? n : -static_cast<int>(e);
  }
  kernel<<<n_cta, 32 * kRowsWarps, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// The (VPL, WPR) instantiations: the shapes rmsnorm.rows_shape picks (at
// most 2 vectors a lane where 8 warps hold the row that way, else 4).
#define RMS_ROWS_SHAPES(X) X(1, 1) X(2, 1) X(2, 2) X(2, 4) X(2, 8) X(4, 8)

template <typename T>
int rows_dispatch(bool launch, int vpl, int wpr, const void* x,
                  const float* w, const void* dy, void* dx, float* part,
                  int rows, int d, int n_cta, float eps,
                  cudaStream_t stream) {
#define RMS_ROWS(V, W)                                                 \
  if (vpl == V && wpr == W)                                            \
    return rows_entry<T, V, W>(launch, x, w, dy, dx, part, rows, d,    \
                               n_cta, eps, stream);
  RMS_ROWS_SHAPES(RMS_ROWS)
#undef RMS_ROWS
  return launch ? static_cast<int>(cudaErrorInvalidValue)
                : -static_cast<int>(cudaErrorInvalidValue);
}

bool valid_rows_plan(int d, int vec, int vpl, int wpr) {
  bool shape = false;
#define RMS_IS(V, W) shape |= vpl == V && wpr == W;
  RMS_ROWS_SHAPES(RMS_IS)
#undef RMS_IS
  return shape && d % vec == 0 && d / vec <= 32 * vpl * wpr;
}

}  // namespace

extern "C" {

// out[rows, d] = RMSNorm(x[rows, d]) * w[d] on `stream`; x and out are
// contiguous of dtype code 0 (float32) or 1 (bfloat16), w is float32.
// model != 0 selects the model's rounding; variant 0 is the split variant
// (one CTA per row), 1 the generic one.  Returns
// cudaGetLastError() (0 = ok); an unknown dtype code or variant, or a
// variant that cannot take the shape or the pointers' alignment, returns
// cudaErrorInvalidValue.
int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int d,
                   int dtype, int model, int variant, float eps,
                   void* stream) {
  if (rows <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return model ? launch_typed<float, true>(x, wf, out, rows, d, variant,
                                             eps, s)
                 : launch_typed<float, false>(x, wf, out, rows, d, variant,
                                              eps, s);
  if (dtype == 1)
    return model ? launch_typed<__nv_bfloat16, true>(x, wf, out, rows, d,
                                                     variant, eps, s)
                 : launch_typed<__nv_bfloat16, false>(x, wf, out, rows, d,
                                                      variant, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of the model's rounding: dx [rows, d] (dtype code of x) and
// this call's partials of dw, part [n_cta, d] f32; x, dy, dx contiguous, w
// float32 [d].  variant 0 ("rows"): n_cta CTAs of rmsnorm_bwd_rows_kernel,
// vpl 16-byte vectors a lane and wpr warps a row (each 1, 2, 4 or 8; d a
// whole number of vectors, at most 32 vpl wpr of them, x, dy and dx
// 16-byte aligned; one of the instantiated shapes); variant 1
// ("generic"): rmsnorm_bwd_kernel, CTA c taking the rows
// [c rows_per_cta, (c + 1) rows_per_cta), d at most kBwdMaxD (12272).  A
// shape, plan or alignment the variant does not take returns
// cudaErrorInvalidValue.
int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy,
                       void* dx, float* part, int rows, int d, int dtype,
                       int variant, int n_cta, int rows_per_cta, int vpl,
                       int wpr, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || n_cta <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  if (variant == 0) {
    const int vec = dtype == 0 ? 4 : 8;
    const bool aligned = reinterpret_cast<size_t>(x) % 16 == 0 &&
                         reinterpret_cast<size_t>(dy) % 16 == 0 &&
                         reinterpret_cast<size_t>(dx) % 16 == 0;
    if (!aligned || !valid_rows_plan(d, vec, vpl, wpr))
      return static_cast<int>(cudaErrorInvalidValue);
    return dtype == 0
               ? rows_dispatch<float>(true, vpl, wpr, x, wf, dy, dx, part,
                                      rows, d, n_cta, eps, s)
               : rows_dispatch<__nv_bfloat16>(true, vpl, wpr, x, wf, dy, dx,
                                              part, rows, d, n_cta, eps, s);
  }
  if (variant != 1 || d > kBwdMaxD || rows_per_cta <= 0 ||
      static_cast<long long>(n_cta) * rows_per_cta < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * d;
  if (dtype == 0)
    rmsnorm_bwd_kernel<float><<<n_cta, kBwdThreads, smem, s>>>(
        static_cast<const float*>(x), wf, static_cast<const float*>(dy),
        static_cast<float*>(dx), part, rows, d, rows_per_cta, eps);
  else
    rmsnorm_bwd_kernel<__nv_bfloat16><<<n_cta, kBwdThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf,
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), part, rows, d, rows_per_cta, eps);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the rows kernel of (dtype code, vpl, wpr) one SM holds at width
// d (its dynamic shared memory), or minus a CUDA error code.
int rmsnorm_bwd_rows_occupancy(int dtype, int d, int vpl, int wpr) {
  if (d <= 0 || (dtype != 0 && dtype != 1) ||
      !valid_rows_plan(d, dtype == 0 ? 4 : 8, vpl, wpr))
    return -static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0
             ? rows_dispatch<float>(false, vpl, wpr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, 0, d, 0, 0.f,
                                    nullptr)
             : rows_dispatch<__nv_bfloat16>(false, vpl, wpr, nullptr,
                                            nullptr, nullptr, nullptr,
                                            nullptr, 0, d, 0, 0.f, nullptr);
}

// dw[d] = the n_cta partials [n_cta, d] summed column by column in the
// order of rmsnorm_bwd_reduce_kernel
int rmsnorm_bwd_reduce_launch(const float* part, float* dw, int n_cta, int d,
                              void* stream) {
  if (d <= 0) return 0;
  if (n_cta < 0) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_bwd_reduce_kernel<<<(d + 31) / 32, 32 * kReduceSlices, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      part, dw, n_cta, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
