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
// The backward (training) -- rmsnorm_bwd_kernel and the reduction of its
// partials, rmsnorm_bwd_reduce_kernel -- is described where it is defined.
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
// Bound by bytes: x and dy are read (twice: the second pass from L1/L2),
// dx written, w read and dw written once.
// rmsnorm_bwd_kernel<T, VEC>: CTA c (256 threads) takes the rows
// [c R, (c + 1) R).  Per row, one pass sums x^2 and g x (per-thread
// partials in element order, warp shuffles, the warps' sums in warp
// order), a second writes dx and adds each column's dy a to the CTA's
// partial of dw in shared memory (a column belongs to one thread: no
// atomics).  The partials [n_cta, d] f32 go to a workspace, and
// rmsnorm_bwd_reduce_kernel sums each column's partials in CTA order (one
// thread a column): deterministic.  VEC: 16-byte vectors of T where d and
// the pointers allow ("vec"), else one element ("generic").
constexpr int kBwdThreads = 256;
// the partial of dw (dynamic) and red (static) share 48 KB of shared memory
constexpr int kBwdRedBytes = 2 * (kBwdThreads / 32) * sizeof(float);
constexpr int kBwdMaxD = (48 * 1024 - kBwdRedBytes) / sizeof(float);  // 12272

template <typename T>
__device__ __forceinline__ float grad_in(float dyf, float wf) {
  return round_to<T>(dyf * round_to<T>(wf));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ part, int rows, int d,
                   int rows_per_cta, float eps) {
  extern __shared__ float dw_s[];           // d floats: this CTA's partial
  __shared__ float red[2][kBwdThreads / 32];
  using V = Vec<T, VEC>;
  const int nv = d / VEC;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < nv; i += kBwdThreads)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dw_s[i * VEC + e] = 0.f;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  for (int row = r0; row < r1; ++row) {
    const V* xr = reinterpret_cast<const V*>(x + static_cast<size_t>(row) * d);
    const V* gr = reinterpret_cast<const V*>(dy + static_cast<size_t>(row) * d);
    float ss = 0.f, sg = 0.f;
    for (int i = tid; i < nv; i += kBwdThreads) {
      const V a = xr[i], b = gr[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = to_f32<T>(a.v[e]);
        const float g = grad_in<T>(to_f32<T>(b.v[e]), w[i * VEC + e]);
        ss += xf * xf;
        sg += g * xf;
      }
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
    V* dxr = reinterpret_cast<V*>(dx + static_cast<size_t>(row) * d);
    for (int i = tid; i < nv; i += kBwdThreads) {
      const V a = xr[i], b = gr[i];
      V out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float dyf = to_f32<T>(b.v[e]);
        const float g = grad_in<T>(dyf, w[i * VEC + e]);
        const float xh = to_f32<T>(a.v[e]) * r;
        out.v[e] = from_f32<T>(r * (g - xh * mean));
        dw_s[i * VEC + e] += dyf * round_to<T>(xh);
      }
      dxr[i] = out;
    }
  }
  float* pr = part + static_cast<size_t>(blockIdx.x) * d;
  for (int i = tid; i < nv; i += kBwdThreads)
#pragma unroll
    for (int e = 0; e < VEC; ++e) pr[i * VEC + e] = dw_s[i * VEC + e];
}

__global__ void __launch_bounds__(256)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ dw, int n_cta, int d) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int j = 0; j < n_cta; ++j) s += part[static_cast<size_t>(j) * d + c];
  dw[c] = s;
}

template <typename T>
int launch_bwd_typed(const void* xv, const float* w, const void* dyv,
                     void* dxv, float* part, int rows, int d, int variant,
                     int rows_per_cta, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  const int n_cta = (rows + rows_per_cta - 1) / rows_per_cta;
  const size_t smem = sizeof(float) * d;
  if (variant == 0) {                     // vec
    if (d % kVec != 0 || reinterpret_cast<size_t>(x) % 16 != 0 ||
        reinterpret_cast<size_t>(dy) % 16 != 0 ||
        reinterpret_cast<size_t>(dx) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    rmsnorm_bwd_kernel<T, kVec><<<n_cta, kBwdThreads, smem, stream>>>(
        x, w, dy, dx, part, rows, d, rows_per_cta, eps);
  } else if (variant == 1) {              // generic
    rmsnorm_bwd_kernel<T, 1><<<n_cta, kBwdThreads, smem, stream>>>(
        x, w, dy, dx, part, rows, d, rows_per_cta, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
// this call's partials of dw, part [ceil(rows / rows_per_cta), d] f32; x,
// dy, dx contiguous, w float32 [d]; variant 0 ("vec", 16-byte vectors) or 1
// ("generic").  d at most kBwdMaxD (12272).
int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy,
                       void* dx, float* part, int rows, int d, int dtype,
                       int variant, int rows_per_cta, float eps,
                       void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > kBwdMaxD || rows_per_cta <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return launch_bwd_typed<float>(x, wf, dy, dx, part, rows, d, variant,
                                   rows_per_cta, eps, s);
  if (dtype == 1)
    return launch_bwd_typed<__nv_bfloat16>(x, wf, dy, dx, part, rows, d,
                                           variant, rows_per_cta, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw[d] = the n_cta partials [n_cta, d] summed in order, column by column
int rmsnorm_bwd_reduce_launch(const float* part, float* dw, int n_cta, int d,
                              void* stream) {
  if (d <= 0) return 0;
  if (n_cta < 0) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_bwd_reduce_kernel<<<(d + 255) / 256, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      part, dw, n_cta, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
