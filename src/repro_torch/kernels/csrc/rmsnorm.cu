// RMSNorm over the last axis, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `rmsnorm_pallas` -> `_kernel`
// (src/repro/kernels/rmsnorm.py:23, :16):
//
//   out = x * rsqrt(mean(x^2) + eps) * w        (f32 inside, rows of d)
//
// Bound on this card: bytes.  Each element is read from device memory
// once and written once (the second read of a row comes from L1), with
// a handful of operations per element, far below the card's ratio of
// operations to bytes.  Design: one warp per row, 16-byte vector loads
// and stores where the row length allows them, the sum of squares in
// f32 reduced with warp shuffles; no shared memory, no block barrier.
//
// Two instantiations of one template, because the Pallas kernel and the
// model's jnp RMSNorm (src/repro/models/layers.py:24) round differently
// in bf16:
//   kModel = false ("pallas"): (y * w) in f32, rounded once to x's type;
//   kModel = true  ("model"):  y rounded to x's type, times w rounded to
//                              x's type, the product rounded again.
// In f32 both are the same function.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 rows (warps) per CTA

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

template <typename T, int VEC, bool kModel>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  using V = Vec<T, VEC>;
  const V* xr = reinterpret_cast<const V*>(x + static_cast<size_t>(row) * d);
  V* orow = reinterpret_cast<V*>(out + static_cast<size_t>(row) * d);
  const int nv = d / VEC;
  float ss = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const V a = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32<T>(a.v[e]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
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
int launch_typed(const void* x, const float* w, void* out, int rows, int d,
                 float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int grid = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const bool aligned = d % kVec == 0 &&
                       reinterpret_cast<size_t>(x) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  if (aligned)
    rmsnorm_kernel<T, kVec, kModel><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(out), rows, d, eps);
  else
    rmsnorm_kernel<T, 1, kModel><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[rows, d] = RMSNorm(x[rows, d]) * w[d] on `stream`; x and out are
// contiguous of dtype code 0 (float32) or 1 (bfloat16), w is float32.
// model != 0 selects the model's rounding.  Returns cudaGetLastError()
// (0 = ok); an unknown dtype code returns cudaErrorInvalidValue.
int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int d,
                   int dtype, int model, float eps, void* stream) {
  if (rows <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return model ? launch_typed<float, true>(x, wf, out, rows, d, eps, s)
                 : launch_typed<float, false>(x, wf, out, rows, d, eps, s);
  if (dtype == 1)
    return model
               ? launch_typed<__nv_bfloat16, true>(x, wf, out, rows, d, eps, s)
               : launch_typed<__nv_bfloat16, false>(x, wf, out, rows, d, eps,
                                                    s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
