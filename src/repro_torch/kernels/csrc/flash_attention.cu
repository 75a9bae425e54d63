// GQA flash attention with an online softmax, hand-written for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernel `flash_attention_pallas` ->
// `_kernel` (src/repro/kernels/flash_attention.py:62, :25), generalised
// as the model's jnp attention is (src/repro/models/layers.py:72): a
// query offset and a valid key length, both given at run time.
//
//   q [B, Sq, H, hd], k/v [B, Skv, Hkv, hd]  ->  o [B, Sq, H, hd]
//   query i of head h sits at position q_offset + i and attends to key j
//   of kv head h / G (G = H / Hkv) iff j < min(kv_len, Skv) and, causal,
//   j <= q_offset + i; scores are (q * hd^-1/2) . k in f32, the softmax
//   is online in f32, a row with no key at all gives 0.
//
// Bound on this card: at the prefill shapes, operations (4 * hd flops per
// visible (query, key) pair; the bound is taken against the tensor cores'
// bf16 rate although this simple kernel runs on the f32 CUDA cores and
// uses no tensor core); in decode (one query per row), bytes (the K/V
// cache is read once).
//
// Design (not the Pallas grid, which walks KV blocks in order on one
// core): one CTA per (q tile, kv head, batch) and 128 threads as 16 row
// groups x 8 column groups.  A CTA holds R = 16 * RM rows, each a (query,
// head) pair of its kv head, so the G query heads of one kv head share
// every K/V tile.  The CTA loops over 64-key tiles below min(kv_len, Skv)
// and below the causal bound of its last query, and stages each K and V
// tile in shared memory as f32 (row-major, rows padded by 4 floats so
// that the 16-byte reads of 8 neighbouring rows fall in distinct banks).
// A thread computes an RM x 8 block of scores (rows ty + 16 i, keys
// tx + 8 c), reduces the row max and sum over its 8-lane group with warp
// shuffles, keeps m, l and its RM x hd/8 slice of the output in
// registers, and passes the probabilities to the P.V product through
// shared memory.  Tiles that a CTA skips contribute exactly 0, as masked
// keys do (p = exp(-inf) = 0); a row whose first tiles are fully masked
// keeps m = -inf and uses 0 in its place, so exp(-inf - (-inf)) never
// occurs.  RM = 4 (64 rows) serves prefill, RM = 1 (16 rows) the short
// query counts of decode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;      // 16 row groups x 8 column groups
constexpr int kTY = 16, kTX = 8;
constexpr int kBK = 64;            // keys per tile
constexpr int kPad = 4;            // floats of padding per shared row

template <typename T>
struct Load8;                      // 8 consecutive elements -> 8 floats

template <>
struct Load8<float> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

template <>
struct Load8<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      o[2 * e] = f.x;
      o[2 * e + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);        // round to nearest even
}

// VD consecutive floats of shared memory (16, 8 or 4 bytes, aligned)
template <int VD>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (VD == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else if constexpr (VD == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = p[0];
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, Hkv, G, BQ;      // BQ query positions per CTA
  int causal, q_offset, kv_valid;  // kv_valid = min(kv_len, Skv)
  float scale;
};

template <int HD, int RM>
constexpr size_t smem_bytes() {
  // Qs [R][HD+pad], Ks and Vs [BK][HD+pad], Ps [BK][R+pad]
  return sizeof(float) *
         (static_cast<size_t>(kTY * RM) * (HD + kPad) +
          2 * static_cast<size_t>(kBK) * (HD + kPad) +
          static_cast<size_t>(kBK) * (kTY * RM + kPad));
}

template <typename T, int HD, int RM>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int R = kTY * RM;      // rows (query, head) per CTA
  constexpr int QS = HD + kPad;    // shared row strides, in floats
  constexpr int PS = R + kPad;
  constexpr int DN = HD / kTX;     // output dims per thread
  constexpr int VD = DN < 4 ? DN : 4;
  constexpr int NC = HD / 8;       // 8-element chunks per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + R * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * QS;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int q0 = blockIdx.x * a.BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.G;
  const int nq = min(a.BQ, a.Sq - q0);       // query positions here
  const int rows = nq * G;                   // valid rows r < rows

  // stage q * scale (f32); rows past `rows` are zero
  for (int e = tid; e < R * NC; e += kThreads) {
    const int r = e / NC, c = e % NC;
    float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (r < rows) {
      const int qi = q0 + r / G, h = kvh * G + r % G;
      Load8<T>::run(q + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) *
                            HD + c * 8, f);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) Qs[r * QS + c * 8 + t] = f[t] * a.scale;
  }

  // keys this CTA can see: below kv_valid and the causal bound of its
  // last query
  int kend = a.kv_valid;
  if (a.causal) kend = min(kend, a.q_offset + q0 + nq);
  const int n_tiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DN; ++d) acc[i][d] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // the previous tile's readers are done
    for (int e = tid; e < kBK * NC; e += kThreads) {
      const int j = e / NC, c = e % NC;
      float fk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      float fv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (k0 + j < a.Skv) {
        const size_t off =
            ((static_cast<size_t>(b) * a.Skv + k0 + j) * a.Hkv + kvh) * HD +
            c * 8;
        Load8<T>::run(k + off, fk);
        Load8<T>::run(v + off, fv);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        Ks[j * QS + c * 8 + t] = fk[t];
        Vs[j * QS + c * 8 + t] = fv[t];
      }
    }
    __syncthreads();

    // scores s[i][c]: row ty + 16 i, key tx + 8 c
    float s[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) lds<4>(&Qs[(ty + kTY * i) * QS + d], qv[i]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float kv[4];
        lds<4>(&Ks[(tx + kTX * c) * QS + d], kv);
#pragma unroll
        for (int i = 0; i < RM; ++i)
          s[i][c] += qv[i][0] * kv[0] + qv[i][1] * kv[1] +
                     qv[i][2] * kv[2] + qv[i][3] * kv[3];
      }
    }

    // mask, online softmax, probabilities to shared memory
    float p[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + kTY * i;
      const bool row_ok = r < rows;
      const int qpos = a.q_offset + q0 + r / G;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + tx + kTX * c;
        const bool ok = row_ok && kpos < a.kv_valid &&
                        (!a.causal || kpos <= qpos);
        s[i][c] = ok ? s[i][c] : -INFINITY;
        tmax = fmaxf(tmax, s[i][c]);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        p[i][c] = expf(s[i][c] - m_use);
        psum += p[i][c];
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DN; ++d) acc[i][d] *= corr;
    }
    // Ps[key][ty * RM + i] holds row ty + 16 i
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float* dst = &Ps[(tx + kTX * c) * PS + ty * RM];
      if constexpr (RM == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) dst[i] = p[i][c];
      }
    }
    __syncthreads();

    // acc += P . V over the tile; this thread's dims are
    // 8 * VD * mm + tx * VD + e
    const int jmax = min(kBK, kend - k0);
#pragma unroll 2
    for (int j = 0; j < jmax; ++j) {
      float pv[RM];
      lds<RM == 4 ? 4 : 1>(&Ps[j * PS + ty * RM], pv);
#pragma unroll
      for (int mm = 0; mm < DN / VD; ++mm) {
        float vv[VD];
        lds<VD>(&Vs[j * QS + kTX * VD * mm + tx * VD], vv);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int e = 0; e < VD; ++e) acc[i][mm * VD + e] += pv[i] * vv[e];
      }
    }
  }

  // out = acc / l (a row with no visible key: l = 0 -> 1, out = 0)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + kTY * i;
    if (r >= rows) continue;
    const int qi = q0 + r / G, h = kvh * G + r % G;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* dst = o + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) * HD;
#pragma unroll
    for (int mm = 0; mm < DN / VD; ++mm)
#pragma unroll
      for (int e = 0; e < VD; ++e)
        store_out(dst + kTX * VD * mm + tx * VD + e, acc[i][mm * VD + e] / li);
  }
}

template <typename T, int HD, int RM>
int launch_tiled(Args a, int B, cudaStream_t stream) {
  constexpr int R = kTY * RM;
  constexpr size_t smem = smem_bytes<HD, RM>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD, RM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  a.BQ = R / a.G;
  const dim3 grid((a.Sq + a.BQ - 1) / a.BQ, a.Hkv, B);
  flash_attention_kernel<T, HD, RM><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(Args a, int B, cudaStream_t stream) {
  // 16 rows when the query heads of one kv head fit; 64 otherwise
  if (a.Sq * a.G <= kTY && a.G <= kTY)
    return launch_tiled<T, HD, 1>(a, B, stream);
  return launch_tiled<T, HD, 4>(a, B, stream);
}

template <typename T>
int launch_typed(Args a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, B, stream);
    case 32: return launch_hd<T, 32>(a, B, stream);
    case 64: return launch_hd<T, 64>(a, B, stream);
    case 128: return launch_hd<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream` (shapes and mask above); q, k, v, o
// contiguous of dtype code 0 (float32) or 1 (bfloat16), 16-byte aligned;
// hd in {16, 32, 64, 128}; G = H / Hkv at most 64.  Returns
// cudaGetLastError() (0 = ok); arguments the kernel does not take return
// cudaErrorInvalidValue.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Skv, int H, int Hkv,
                           int hd, int dtype, int causal, int q_offset,
                           int kv_len, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 4 * kTY || Skv < 0 ||
      q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.Sq = Sq; a.Skv = Skv; a.H = H; a.Hkv = Hkv; a.G = H / Hkv;
  a.causal = causal != 0;
  a.q_offset = q_offset;
  a.kv_valid = kv_len < 0 ? 0 : (kv_len < Skv ? kv_len : Skv);
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(a, B, hd, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(a, B, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
