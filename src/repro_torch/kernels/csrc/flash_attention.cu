// GQA flash attention, hand-written for Hopper (sm_90a): three kernels
// and a combine pass.  The wrapper (src/repro_torch/kernels/
// flash_attention.py, `flash_attention_cuda`) picks one by dtype and shape
// alone: G * Sq <= 16 (decode) -> split + combine, either dtype; else bf16
// -> the tensor-core kernel; else f32 -> the CUDA-core kernel.
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
// GQA reuse: in every kernel a CTA holds rows r = i * G + g of ONE kv head
// (query i, head kvh * G + g), so the G query heads of a kv head share
// every K/V tile the CTA loads.  A row whose keys so far are all masked
// keeps m = -inf and uses 0 in its place, so exp(-inf - (-inf)) never
// occurs; a row that sees no key gives 0.  Keys past a CTA's last
// visible key are never read: their tile rows are zero-filled.
//
// 1. flash_attention_wgmma_kernel<HD> (bf16, G * Sq > 16; prefill).
//    Bound by operations: 4 * hd flops per visible (query, key) pair at
//    the tensor cores' bf16 rate.  FlashAttention-2 on Hopper's warpgroup
//    products, wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate): one
//    warpgroup (4 warps) and 64 rows per CTA, 16 rows per warp.  The Q
//    tile is loaded once (cp.async, rows padded by 16 bytes so ldmatrix
//    is conflict-free) and held in registers as A fragments for the CTA's
//    whole walk over the keys.  64-key K and V tiles come by 16-byte
//    cp.async into a double buffer in shared memory, one barrier per
//    tile, in the canonical swizzled layout (16-byte chunks XOR-ed with
//    the key within 8-key atoms: conflict-free for the copies and for
//    wgmma's reads); S = Q.K^T reads K as a K-major operand and O += P.V
//    reads the same bytes of V as an N-major one, both by descriptor.  S
//    is scaled by hd^-1/2 (times log2 e, for exp2) in f32; the online
//    softmax runs on the accumulator fragments (the mma.sync C layout per
//    warp), row max by quad shuffles, each thread keeping a partial row
//    sum that its quad adds at the end.  P, rounded to bf16 in registers,
//    is the A operand of the P.V product as it stands (two 8-key S tiles
//    are one 16-key A step): it never goes through shared memory.  Each
//    product is one asm block that fences, starts its wgmmas, commits and
//    waits, so the compiler sees a synchronous statement.  Key tiles
//    wholly above the CTA's causal bound or past min(kv_len, Skv) are
//    skipped, and only tiles that a bound crosses are masked.  CTAs are
//    scheduled heaviest (latest queries) first.  wgmma, not mma.sync: the
//    same design on mma.sync.m16n8k16, with K and V fragments loaded by
//    ldmatrix, measured slower at the long wave's prefill (PERF.md).  At
//    hd 64 the P.V product runs as two n32 halves: when both products
//    were m64n64k16, nvcc placed P's bf16 fragments in the registers
//    that hold Q's, which the next key tile still reads (the SASS loads
//    Q once and never again), so from the second tile on S was P.K^T.
//    hd 112 (kimi-k2's 7168 / 64) runs the hd 128 instantiation's shared
//    layout and products (flash_attention_wgmma_kernel<128, 112>): each
//    row's 112 dims land in a 128-wide swizzled tile whose dims 112-127
//    are zero-filled (cp.async with a zero source size), the 128-wide
//    Q.K^T (the zeros add nothing) and P.V run as at hd 128, and 112
//    dims are stored (P.V's last 16 are dropped): 128/112 = 1.14x the
//    products for the same bytes.
// 2. flash_attention_kernel<HD> (f32, G * Sq > 16): the CUDA-core kernel
//    (TF32 would not hold the f32 tolerance), described below.
// 3. flash_attention_split_kernel<T, HD, RB> + flash_attention_combine_
//    kernel<T> (G * Sq <= 16; decode).  Bound by bytes: the visible K/V
//    rows are read once.  The visible keys are cut into n_split equal
//    ranges (the wrapper's `decode_splits`, about 4 CTAs per SM); grid
//    (n_split, Hkv, B); a CTA (4 warps) takes the G * Sq rows of its kv
//    head, sized to RB = 4 rows (16 only when G * Sq > 4), not a 16-row
//    tile.  It streams its range in 32-key K/V tiles by 16-byte cp.async
//    through a three-stage ring (each K/V byte read once), computes
//    scores on the CUDA cores (lane = key, warp = a quarter of hd), an
//    online softmax per row (one warp per row) and acc += P.V (thread =
//    output dim), and writes f32 partials (m, l, acc[hd]) per row to a
//    workspace.  The combine kernel (one warp per row) merges them:
//    m* = max m_s, l* = sum l_s e^(m_s - m*), o = sum acc_s e^(m_s - m*) /
//    l*, 0 where l* = 0; a split whose keys are all masked (m_s = -inf)
//    adds exactly 0.  At hd 112 the split kernel's P.V runs on 112 of its
//    128 threads (one output dim each) and a warp's quarter of the score
//    dims (28) is read 8 bytes at a time; the f32 kernel (2.) reads V by
//    twos (14 dims a thread).
// 4. flash_attention_bwd_dq_kernel<HD> + flash_attention_bwd_dkdv_
//    kernel<HD> (training, f32): the gradient of the prefill kernels'
//    function at q_offset 0 over every key, from their row log-sum-exp
//    (which kernels 1 and 2 write when asked), on the CUDA cores;
//    described below.  hd 112 has an instantiation of its own (a thread's
//    7 dims read one float at a time).
// 5. flash_attention_bwd_dq_wgmma_kernel<HD, HDG> + flash_attention_bwd_
//    dkdv_wgmma_kernel<HD, HDG> (training, bf16): the same gradient on the
//    tensor cores; hd 112 on zero-padded hd 128 tiles, as kernel 1;
//    described below.  The wrapper picks 4 or 5 by dtype alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; zero-filled when !ok (no
// byte of src is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>   // wait until at most N of this thread's groups pend
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices; thread i gives the address of row i % 8 of
// matrix i / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// two floats -> bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}


// ---------------------------------------------------------------------------
// warpgroup matrix multiply (wgmma) helpers
// ---------------------------------------------------------------------------
// shared memory written by cp.async becomes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared-memory matrix descriptor of a swizzled operand (layout 1, 2, 3:
// rows of 128, 64, 32 bytes, their 16-byte chunks XOR-ed with the row
// index within 8-row atoms); lbo, sbo: byte strides between atoms (see
// the kernel)
__device__ __forceinline__ unsigned long long smem_desc(unsigned addr,
                                                        unsigned lbo,
                                                        unsigned sbo,
                                                        unsigned layout) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<unsigned long long>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<unsigned long long>(layout) << 62);
}

// S (64 x 64 keys, f32) = Q (64 x 16 KS dims: A fragments in registers,
// per step the mma.sync A fragment of each warp's 16 rows) . K^T (K-major
// B in shared memory, one descriptor per 16-dim step), KS steps in one
// block that waits for its own result (the compiler sees a synchronous
// statement: no register can be read or copied while a wgmma writes it)
template <int KS>
struct WgmmaQK;

template <>
struct WgmmaQK<1> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned (&a)[1][4],
      const unsigned long long (&desc)[1]) {
    asm volatile(
        "{\n.reg .pred pf, pt;\n"
        "setp.ne.b32 pf, %37, %37;\n"
        "setp.eq.b32 pt, %37, %37;\n"
        "wgmma.fence.sync.aligned;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, pf, 1, 1, 0;\n"
        "wgmma.commit_group.sync.aligned;\n"
        "wgmma.wait_group.sync.aligned 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "l"(desc[0]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaQK<2> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned (&a)[2][4],
      const unsigned long long (&desc)[2]) {
    asm volatile(
        "{\n.reg .pred pf, pt;\n"
        "setp.ne.b32 pf, %42, %42;\n"
        "setp.eq.b32 pt, %42, %42;\n"
        "wgmma.fence.sync.aligned;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %40, pf, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%36, %37, %38, %39}, %41, pt, 1, 1, 0;\n"
        "wgmma.commit_group.sync.aligned;\n"
        "wgmma.wait_group.sync.aligned 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
          "l"(desc[0]), "l"(desc[1]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaQK<4> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned (&a)[4][4],
      const unsigned long long (&desc)[4]) {
    asm volatile(
        "{\n.reg .pred pf, pt;\n"
        "setp.ne.b32 pf, %52, %52;\n"
        "setp.eq.b32 pt, %52, %52;\n"
        "wgmma.fence.sync.aligned;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %48, pf, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%36, %37, %38, %39}, %49, pt, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%40, %41, %42, %43}, %50, pt, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%44, %45, %46, %47}, %51, pt, 1, 1, 0;\n"
        "wgmma.commit_group.sync.aligned;\n"
        "wgmma.wait_group.sync.aligned 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
          "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
          "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
          "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaQK<8> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned (&a)[8][4],
      const unsigned long long (&desc)[8]) {
    asm volatile(
        "{\n.reg .pred pf, pt;\n"
        "setp.ne.b32 pf, %72, %72;\n"
        "setp.eq.b32 pt, %72, %72;\n"
        "wgmma.fence.sync.aligned;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %64, pf, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%36, %37, %38, %39}, %65, pt, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%40, %41, %42, %43}, %66, pt, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%44, %45, %46, %47}, %67, pt, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%48, %49, %50, %51}, %68, pt, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%52, %53, %54, %55}, %69, pt, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%56, %57, %58, %59}, %70, pt, 1, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%60, %61, %62, %63}, %71, pt, 1, 1, 0;\n"
        "wgmma.commit_group.sync.aligned;\n"
        "wgmma.wait_group.sync.aligned 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
          "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
          "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
          "r"(a[4][0]), "r"(a[4][1]), "r"(a[4][2]), "r"(a[4][3]),
          "r"(a[5][0]), "r"(a[5][1]), "r"(a[5][2]), "r"(a[5][3]),
          "r"(a[6][0]), "r"(a[6][1]), "r"(a[6][2]), "r"(a[6][3]),
          "r"(a[7][0]), "r"(a[7][1]), "r"(a[7][2]), "r"(a[7][3]),
          "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]),
          "l"(desc[4]), "l"(desc[5]), "l"(desc[6]), "l"(desc[7]), "r"(0)
        : "memory");
  }
};

// O (64 x N dims, f32) += P (64 x 64 keys, bf16 A fragments in registers,
// 4 steps of 16 keys) . V (N-major B in shared memory, one descriptor per
// step), synchronous as above
template <int N>
struct WgmmaPV;

template <>
struct WgmmaPV<16> {
  static __device__ __forceinline__ void run(
      float (&d)[8], const unsigned (&a)[4][4],
      const unsigned long long (&desc)[4]) {
    asm volatile(
        "{\n.reg .pred pf, pt;\n"
        "setp.ne.b32 pf, %28, %28;\n"
        "setp.eq.b32 pt, %28, %28;\n"
        "wgmma.fence.sync.aligned;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %24, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%12, %13, %14, %15}, %25, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%16, %17, %18, %19}, %26, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%20, %21, %22, %23}, %27, pt, 1, 1, 1;\n"
        "wgmma.commit_group.sync.aligned;\n"
        "wgmma.wait_group.sync.aligned 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
          "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
          "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
          "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaPV<32> {
  static __device__ __forceinline__ void run(
      float (&d)[16], const unsigned (&a)[4][4],
      const unsigned long long (&desc)[4]) {
    asm volatile(
        "{\n.reg .pred pf, pt;\n"
        "setp.ne.b32 pf, %36, %36;\n"
        "setp.eq.b32 pt, %36, %36;\n"
        "wgmma.fence.sync.aligned;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %32, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%20, %21, %22, %23}, %33, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%24, %25, %26, %27}, %34, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%28, %29, %30, %31}, %35, pt, 1, 1, 1;\n"
        "wgmma.commit_group.sync.aligned;\n"
        "wgmma.wait_group.sync.aligned 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
          "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
          "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
          "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaPV<128> {
  static __device__ __forceinline__ void run(
      float (&d)[64], const unsigned (&a)[4][4],
      const unsigned long long (&desc)[4]) {
    asm volatile(
        "{\n.reg .pred pf, pt;\n"
        "setp.ne.b32 pf, %84, %84;\n"
        "setp.eq.b32 pt, %84, %84;\n"
        "wgmma.fence.sync.aligned;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %80, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%68, %69, %70, %71}, %81, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%72, %73, %74, %75}, %82, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%76, %77, %78, %79}, %83, pt, 1, 1, 1;\n"
        "wgmma.commit_group.sync.aligned;\n"
        "wgmma.wait_group.sync.aligned 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
          "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
          "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
          "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]), "r"(0)
        : "memory");
  }
};

// N = 64: two m64n32k16 per step, so that this product's shape differs
// from Q.K^T's m64n64k16 (with both m64n64k16, nvcc reused Q's registers
// for P: see the header), desc[2 t + h] for the half h of the dims
template <>
struct WgmmaPV<64> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned (&a)[4][4],
      const unsigned long long (&desc)[8]) {
    asm volatile(
        "{\n.reg .pred pt;\n"
        "setp.eq.b32 pt, %56, %56;\n"
        "wgmma.fence.sync.aligned;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%32, %33, %34, %35}, %48, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %49, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%36, %37, %38, %39}, %50, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%36, %37, %38, %39}, %51, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%40, %41, %42, %43}, %52, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%40, %41, %42, %43}, %53, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%44, %45, %46, %47}, %54, pt, 1, 1, 1;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%44, %45, %46, %47}, %55, pt, 1, 1, 1;\n"
        "wgmma.commit_group.sync.aligned;\n"
        "wgmma.wait_group.sync.aligned 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
          "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
          "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
          "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]),
          "l"(desc[4]), "l"(desc[5]), "l"(desc[6]), "l"(desc[7]), "r"(0)
        : "memory");
  }
};

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(bf16 x) { return __bfloat162float(x); }

// N consecutive elements of shared memory (8- or 16-byte aligned) -> floats
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* o) {
  if constexpr (sizeof(T) == 4) {
    static_assert(N % 4 == 0, "float4 reads");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = x.x; o[4 * i + 1] = x.y; o[4 * i + 2] = x.z;
      o[4 * i + 3] = x.w;
    }
  } else if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        o[8 * i + 2 * e] = f.x;
        o[8 * i + 2 * e + 1] = f.y;
      }
    }
  } else {
    // 4 bf16 per 8-byte read (hd 16: N = 4; hd 112: N = 28, and only 8-byte
    // alignment, the warps' quarters starting 56 bytes apart)
    static_assert(N % 4 == 0, "4 bf16 per 8-byte read");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 f0 = __bfloat1622float2(h[0]);
      const float2 f1 = __bfloat1622float2(h[1]);
      o[4 * i] = f0.x; o[4 * i + 1] = f0.y; o[4 * i + 2] = f1.x;
      o[4 * i + 3] = f1.y;
    }
  }
}

// one call's tensors, shapes and mask, as the prefill kernels take them
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                      // [B, H, Sq] row log-sum-exp, or null
  int Sq, Skv, H, Hkv, G, BQ;      // BQ query positions per CTA
  int causal, q_offset, kv_valid;  // kv_valid = min(kv_len, Skv)
  float scale;
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);        // round to nearest even
}

// ---------------------------------------------------------------------------
// 1. the bf16 tensor-core kernel (prefill)
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kWgRows = 64;                 // rows (query, head): 16 a warp
constexpr int kWgKeys = 64;                 // keys per K/V tile
constexpr int kQPad = 8;                    // bf16 of padding per Q row
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
constexpr size_t wgmma_smem_bytes() {
  // two stages, each a K tile and a V tile of 64 x HD bf16 (swizzled);
  // the Q tile (row-major, padded) is staged in stage 1 first
  return sizeof(bf16) * 2 * 2 * kWgKeys * HD;
}

// A tile of 64 rows (keys or queries) x HD dims of bf16 in shared memory,
// as the tensor-core kernels keep K, V (and, in the backward, Q and dO):
// blocks of W bytes of dims (64 rows x W bytes each), 16-byte chunks
// swizzled within 8-row atoms (conflict-free for cp.async and for
// wgmma's reads); tile bases 1024-byte aligned.  The same bytes serve as
// a K-major operand (K: the dims) and as an N-major one (N: the dims).
// At hd 64 the blocks are 32 dims wide, for two n32 halves (see the
// header).
template <int HD>
struct SwzTile {
  static constexpr int W = HD == 64 ? 64 : HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int NP = HD == 64 ? 2 : 1;  // N-major descriptors a step
  static constexpr unsigned kLayout = W == 128 ? 1 : W == 64 ? 2 : 3;
  static constexpr unsigned kSwz = W / 16 - 1;
  static constexpr int CPR = HD / 8;           // 16-byte chunks a row
  static constexpr int BYTES = kWgRows * HD * 2;

  // byte offset of (row j, dims 8 c .. 8 c + 7)
  static __device__ __forceinline__ unsigned off(int j, int c) {
    const unsigned o = (c * 16 / W) * (kWgRows * W) + j * W + c * 16 % W;
    return o ^ (((o >> 7) & kSwz) << 4);
  }
  // K-major operand (rows x dims; K = dims), 16-dim step kk
  static __device__ __forceinline__ unsigned long long kmajor(unsigned base,
                                                              int kk) {
    return smem_desc(base + (kk * 32 / W) * (kWgRows * W) + kk * 32 % W, 16,
                     8 * W, kLayout);
  }
  // N-major operand (N = dims, K = rows), 16-row step t, dim block h
  static __device__ __forceinline__ unsigned long long nmajor(unsigned base,
                                                              int t, int h) {
    return smem_desc(base + h * kWgRows * W + t * 16 * W, kWgRows * W,
                     8 * W, kLayout);
  }
  // rows [0, n) of the tile at dst from row_ptr(j), the rest zero-filled;
  // of each row the first CPG chunks (CPG < CPR: a head dim below the
  // tile's, dims 8 CPG.. zero-filled)
  template <int CPG = CPR, typename F>
  static __device__ __forceinline__ void load(unsigned char* dst, int n,
                                              F row_ptr) {
    for (int e = threadIdx.x; e < kWgRows * CPR; e += kWgThreads) {
      const int j = e / CPR, c = e % CPR;
      const bool ok = j < n && c < CPG;
      cp_async16(dst + off(j, c), ok ? row_ptr(j) + c * 8 : row_ptr(0), ok);
    }
  }
};

// HD: the tiles' and products' width; HDG <= HD: the tensors' head dim
// (dims HDG..HD-1 of every tile zero-filled, never stored)
template <int HD, int HDG = HD>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_wgmma_kernel(const Args a) {
  constexpr int KS = HD / 16;       // 16-dim steps of Q.K^T
  constexpr int NO = HD / 8;        // 8-dim tiles of the output
  constexpr int NOG = HDG / 8;      // ... of them stored
  constexpr int NS = kWgKeys / 8;   // 8-key tiles of S
  using L = SwzTile<HD>;             // the K and V tiles' layout
  constexpr int CPR = L::CPR;
  constexpr int CPG = HDG / 8;      // 16-byte chunks a row of the tensors
  static_assert(HDG <= HD && HDG % 8 == 0, "the stored dims fit the tile");
  constexpr int NP = L::NP;         // B descriptors per P.V step
  constexpr int TILE = kWgKeys * HD;
  constexpr int QLD = HD + kQPad;   // Q rows padded: ldmatrix conflict-free
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* const sm = reinterpret_cast<bf16*>(wg_smem);
  static_assert(kWgRows * QLD <= 2 * TILE, "Q fits stage 1");
  bf16* const Qs = sm + 2 * TILE;

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  bf16* o = static_cast<bf16*>(a.o);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * a.BQ;   // heaviest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.G;
  const int nq = min(a.BQ, a.Sq - q0);
  const int rows = nq * G;
  int kend = a.kv_valid;
  if (a.causal) kend = min(kend, a.q_offset + q0 + nq);
  const int n_tiles = kend > 0 ? (kend + kWgKeys - 1) / kWgKeys : 0;

  for (int e = tid; e < kWgRows * CPR; e += kWgThreads) {
    const int r = e / CPR, c = e % CPR;
    const bool ok = r < rows && c < CPG;
    const bf16* src =
        ok ? q + ((static_cast<size_t>(b) * a.Sq + q0 + r / G) * a.H +
                  kvh * G + r % G) * HDG + c * 8
           : q;
    cp_async16(Qs + r * QLD + c * 8, src, ok);
  }
  cp_async_commit();
  // key tile kt into stage kt & 1 (keys at or past kend zero-filled)
  auto load_tile = [&](int kt) {
    unsigned char* Ks = wg_smem + (kt & 1) * 4 * TILE;
    unsigned char* Vs = Ks + 2 * TILE;
    const int k0 = kt * kWgKeys;
    for (int e = tid; e < kWgKeys * CPR; e += kWgThreads) {
      const int j = e / CPR, c = e % CPR;
      const bool ok = k0 + j < kend && c < CPG;
      const size_t off =
          ok ? ((static_cast<size_t>(b) * a.Skv + k0 + j) * a.Hkv + kvh) *
                   HDG + c * 8
             : 0;
      cp_async16(Ks + L::off(j, c), k + off, ok);
      cp_async16(Vs + L::off(j, c), v + off, ok);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  unsigned qf[KS][4];
  {
    const bf16* p = Qs + (warp * 16 + (lane & 7) + (lane & 8)) * QLD +
                    (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], p + kk * 16);
  }

  const float sl2 = a.scale * 1.4426950408889634f;
  const int r0 = warp * 16 + (lane >> 2);
  const int qp0 = a.q_offset + q0 + r0 / G;
  const int qp1 = a.q_offset + q0 + (r0 + 8) / G;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < n_tiles) load_tile(kt + 1);
    cp_async_commit();
    const unsigned Ks = smem_addr(wg_smem) + (kt & 1) * 4 * TILE;
    const unsigned Vs = Ks + 2 * TILE;

    // S = Q . K^T: K-major B, 16 dims per step
    float s[NS * 4];
    unsigned long long dk[KS];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) dk[kk] = L::kmajor(Ks, kk);
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
    WgmmaQK<KS>::run(s, qf, dk);

    const int k0 = kt * kWgKeys;
    if (k0 + kWgKeys > a.kv_valid ||
        (a.causal && k0 + kWgKeys - 1 > a.q_offset + q0)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (key >= a.kv_valid || (a.causal && key > qp))
            s[n * 4 + e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n * 4], s[n * 4 + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n * 4 + 2], s[n * 4 + 3]));
    }
    float mu[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i] * sl2);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = exp2f(m_r[i] - mu[i]);
      m_r[i] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) {
      s[i] = exp2f(fmaf(s[i], sl2, -mu[(i >> 1) & 1]));
      ps[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + ps[i];
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) acc[i] *= corr[(i >> 1) & 1];

    unsigned pa[NS / 2][4];
#pragma unroll
    for (int t = 0; t < NS / 2; ++t) {
      pa[t][0] = pack_bf16(s[8 * t], s[8 * t + 1]);
      pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
      pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
      pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
    }
    // O += P . V: N-major B, 16 keys per step
    unsigned long long dv[NS / 2 * NP];
#pragma unroll
    for (int t = 0; t < NS / 2; ++t)
#pragma unroll
      for (int h = 0; h < NP; ++h) dv[t * NP + h] = L::nmajor(Vs, t, h);
    WgmmaPV<HD>::run(acc, pa, dv);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
    const float inv = l_r[i] == 0.f ? 0.f : 1.f / l_r[i];
    if (a.lse != nullptr && (lane & 3) == 0)   // m_r is in log2 units
      a.lse[(static_cast<size_t>(b) * a.H + kvh * G + r % G) * a.Sq + q0 +
            r / G] = l_r[i] == 0.f ? -INFINITY
                                   : (m_r[i] + log2f(l_r[i])) * kLn2;
    bf16* dst = o + ((static_cast<size_t>(b) * a.Sq + q0 + r / G) * a.H +
                     kvh * G + r % G) * HDG + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < NOG; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n * 4 + 2 * i] * inv,
                                acc[n * 4 + 2 * i + 1] * inv);
  }
}

template <int HD, int HDG = HD>
int launch_wgmma(Args a, int B, cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<HD, HDG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  a.BQ = kWgRows / a.G;
  const dim3 grid((a.Sq + a.BQ - 1) / a.BQ, a.Hkv, B);
  flash_attention_wgmma_kernel<HD, HDG>
      <<<grid, kWgThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. the f32 CUDA-core kernel
// ---------------------------------------------------------------------------
// One CTA per (q tile, kv head, batch) and 128 threads as 16 row groups x
// 8 column groups; R = 16 * kRM = 64 rows per CTA.  The CTA loops over
// 64-key tiles below min(kv_len, Skv) and below the causal bound of its
// last query, and stages each K and V tile in shared memory as f32
// (row-major, rows padded by 4 floats so that the 16-byte reads of 8
// neighbouring rows fall in distinct banks).  A thread computes a kRM x
// 8 block of scores (rows ty + 16 i, keys tx + 8 c), reduces the row max
// and sum over its 8-lane group with warp shuffles, keeps m, l and its kRM
// x hd/8 slice of the output in registers, and passes the probabilities
// to the P.V product through shared memory.  Tiles that a CTA skips
// contribute exactly 0, as masked keys do (p = exp(-inf) = 0).
constexpr int kThreads = 128;      // 16 row groups x 8 column groups
constexpr int kTY = 16, kTX = 8;
constexpr int kRM = 4;             // rows per thread
constexpr int kBK = 64;            // keys per tile
constexpr int kPad = 4;            // floats of padding per shared row

// 8 consecutive floats of global memory (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
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

template <int HD>
constexpr size_t smem_bytes() {
  // Qs [R][HD+pad], Ks and Vs [BK][HD+pad], Ps [BK][R+pad]
  return sizeof(float) *
         (static_cast<size_t>(kTY * kRM) * (HD + kPad) +
          2 * static_cast<size_t>(kBK) * (HD + kPad) +
          static_cast<size_t>(kBK) * (kTY * kRM + kPad));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int R = kTY * kRM;      // rows (query, head) per CTA
  constexpr int QS = HD + kPad;    // shared row strides, in floats
  constexpr int PS = R + kPad;
  constexpr int DN = HD / kTX;     // output dims per thread
  // dims per shared read of V: 4 where they divide DN (hd 112: DN = 14,
  // read by twos)
  constexpr int VD = DN % 4 == 0 ? 4 : DN % 2 == 0 ? 2 : 1;
  static_assert(DN * kTX == HD, "kTX groups cover the head dims");
  constexpr int NC = HD / 8;       // 8-element chunks per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + R * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * QS;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);
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
      load8(q + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) * HD +
                c * 8, f);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) Qs[r * QS + c * 8 + t] = f[t] * a.scale;
  }

  // keys this CTA can see: below kv_valid and the causal bound of its
  // last query
  int kend = a.kv_valid;
  if (a.causal) kend = min(kend, a.q_offset + q0 + nq);
  const int n_tiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  float m[kRM], l[kRM], acc[kRM][DN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
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
        load8(k + off, fk);
        load8(v + off, fv);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        Ks[j * QS + c * 8 + t] = fk[t];
        Vs[j * QS + c * 8 + t] = fv[t];
      }
    }
    __syncthreads();

    // scores s[i][c]: row ty + 16 i, key tx + 8 c
    float s[kRM][8];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[kRM][4];
#pragma unroll
      for (int i = 0; i < kRM; ++i) lds<4>(&Qs[(ty + kTY * i) * QS + d], qv[i]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float kv[4];
        lds<4>(&Ks[(tx + kTX * c) * QS + d], kv);
#pragma unroll
        for (int i = 0; i < kRM; ++i)
          s[i][c] += qv[i][0] * kv[0] + qv[i][1] * kv[1] +
                     qv[i][2] * kv[2] + qv[i][3] * kv[3];
      }
    }

    // mask, online softmax, probabilities to shared memory
    float p[kRM][8];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
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
    // Ps[key][ty * kRM + i] holds row ty + 16 i
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<float4*>(&Ps[(tx + kTX * c) * PS + ty * kRM]) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    }
    __syncthreads();

    // acc += P . V over the tile; this thread's dims are
    // 8 * VD * mm + tx * VD + e
    const int jmax = min(kBK, kend - k0);
#pragma unroll 2
    for (int j = 0; j < jmax; ++j) {
      float pv[kRM];
      lds<kRM>(&Ps[j * PS + ty * kRM], pv);
#pragma unroll
      for (int mm = 0; mm < DN / VD; ++mm) {
        float vv[VD];
        lds<VD>(&Vs[j * QS + kTX * VD * mm + tx * VD], vv);
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int e = 0; e < VD; ++e) acc[i][mm * VD + e] += pv[i] * vv[e];
      }
    }
  }

  // out = acc / l (a row with no visible key: l = 0 -> 1, out = 0)
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty + kTY * i;
    if (r >= rows) continue;
    const int qi = q0 + r / G, h = kvh * G + r % G;
    const float li = l[i] == 0.f ? 1.f : l[i];
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<size_t>(b) * a.H + h) * a.Sq + qi] =
          l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
    float* dst = o + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) * HD;
#pragma unroll
    for (int mm = 0; mm < DN / VD; ++mm)
#pragma unroll
      for (int e = 0; e < VD; ++e)
        dst[kTX * VD * mm + tx * VD + e] = acc[i][mm * VD + e] / li;
  }
}

template <int HD>
int launch_tiled(Args a, int B, cudaStream_t stream) {
  constexpr int R = kTY * kRM;
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  a.BQ = R / a.G;
  const dim3 grid((a.Sq + a.BQ - 1) / a.BQ, a.Hkv, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 3. decode: the split over the keys and the combine pass
// ---------------------------------------------------------------------------
constexpr int kSplitThreads = 128;   // 4 warps
constexpr int kSplitKeys = 32;       // keys per K/V tile: one per lane
constexpr int kSplitStages = 3;      // K/V tiles in flight per CTA
constexpr int kSplitRows = 16;       // G * Sq at most

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  float* m;                          // [B, Hkv, n_split, R]
  float* l;                          // [B, Hkv, n_split, R]
  float* acc;                        // [B, Hkv, n_split, R, hd]
  int Sq, Skv, H, Hkv, G, R;         // R = G * Sq rows per kv head
  int causal, q_offset;
  int visible, chunk, n_split;       // split s: keys [s * chunk, ...)
  float scale;
};

template <typename T, int HD>
__host__ __device__ constexpr int split_ld() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int HD, int RB>
constexpr size_t split_smem_bytes() {
  // K and V tiles x kSplitStages (T), then f32: Q [RB][HD], score parts
  // [4][RB][keys] (the final reduction [RB][HD] after the loop), P
  // [RB][keys], the rows' rescale factors [RB]
  return sizeof(T) * kSplitStages * 2 * kSplitKeys * split_ld<T, HD>() +
         sizeof(float) * (RB * HD + 4 * RB * kSplitKeys + RB * kSplitKeys +
                          RB);
}

// RB: rows the CTA's registers and buffers are sized for (R <= RB)
template <typename T, int HD, int RB>
__global__ void __launch_bounds__(kSplitThreads)
flash_attention_split_kernel(const SplitArgs a) {
  constexpr int LD = split_ld<T, HD>();
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // per chunk
  constexpr int CPR = HD / EPC;                            // chunks per row
  constexpr int DQ = HD / 4;                // dims per warp in the scores
  constexpr int KG = kSplitThreads / HD;    // key groups of the P.V sum
  constexpr int KPG = kSplitKeys / KG;      // keys per group
  static_assert(RB * HD <= 4 * RB * kSplitKeys,
                "the final reduction fits the score parts");
  static_assert(KG == 1 || KG * HD == kSplitThreads,
                "key groups of whole threads");
  extern __shared__ float4 smem4[];
  T* const kvs = reinterpret_cast<T*>(smem4);
  float* const Qs =
      reinterpret_cast<float*>(kvs + kSplitStages * 2 * kSplitKeys * LD);
  float* const Sp = Qs + RB * HD;
  float* const Ps = Sp + 4 * RB * kSplitKeys;
  float* const Cs = Ps + RB * kSplitKeys;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.G, R = a.R;
  const int start = split * a.chunk;
  const int end = min(a.visible, start + a.chunk);
  const int n_tiles = (end - start + kSplitKeys - 1) / kSplitKeys;

  // key tile t of the range into stage t % kSplitStages (keys at or past
  // end zero-filled, never read)
  auto load_tile = [&](int t) {
    T* Ks = kvs + (t % kSplitStages) * 2 * kSplitKeys * LD;
    T* Vs = Ks + kSplitKeys * LD;
    const int k0 = start + t * kSplitKeys;
    for (int e = tid; e < kSplitKeys * CPR; e += kSplitThreads) {
      const int j = e / CPR, c = e % CPR;
      const bool ok = k0 + j < end;
      const size_t off =
          ok ? ((static_cast<size_t>(b) * a.Skv + k0 + j) * a.Hkv + kvh) *
                   HD + c * EPC
             : 0;
      cp_async16(Ks + j * LD + c * EPC, k + off, ok);
      cp_async16(Vs + j * LD + c * EPC, v + off, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kSplitStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  for (int e = tid; e < R * HD; e += kSplitThreads) {   // q * scale, f32
    const int r = e / HD, d = e % HD;
    Qs[e] = as_f32(q[((static_cast<size_t>(b) * a.Sq + r / G) * a.H +
                      kvh * G + r % G) * HD + d]) * a.scale;
  }
  // rows R..RB-1 keep p = 0 and corr = 0: the P.V loop runs all RB rows
  for (int e = R * kSplitKeys + tid; e < RB * kSplitKeys;
       e += kSplitThreads)
    Ps[e] = 0.f;
  if (tid >= R && tid < RB) Cs[tid] = 0.f;

  float m_r[(RB + 3) / 4], l_r[(RB + 3) / 4];   // rows warp + 4 i
#pragma unroll
  for (int i = 0; i < (RB + 3) / 4; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }
  const int dcol = tid % HD, kg = tid / HD;   // output dim, key group
  // hd 112: one key group of 112 threads; the last 16 sit out P.V
  const bool pv = tid < KG * HD;
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kSplitStages - 2>();   // key tile t has landed
    // past this barrier every thread is done with tile t - 1: its stage
    // takes tile t + kSplitStages - 1, P and the rescale factors are free
    __syncthreads();
    if (t + kSplitStages - 1 < n_tiles) load_tile(t + kSplitStages - 1);
    cp_async_commit();
    const T* Ks = kvs + (t % kSplitStages) * 2 * kSplitKeys * LD;
    const T* Vs = Ks + kSplitKeys * LD;
    const int k0 = start + t * kSplitKeys;

    // score parts: lane = key, warp = dims [warp * DQ, (warp + 1) * DQ)
    {
      float kf[DQ];
      load_f32<T, DQ>(Ks + lane * LD + warp * DQ, kf);
      for (int r = 0; r < R; ++r) {
        const float* qr = Qs + r * HD + warp * DQ;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DQ; d += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qr + d);
          s += x.x * kf[d] + x.y * kf[d + 1] + x.z * kf[d + 2] +
               x.w * kf[d + 3];
        }
        Sp[(warp * RB + r) * kSplitKeys + lane] = s;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + 4, ...; lane = key
#pragma unroll
    for (int i = 0; i < (RB + 3) / 4; ++i) {
      const int r = warp + 4 * i;
      if (r >= R) break;
      const int key = k0 + lane;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) s += Sp[(w * RB + r) * kSplitKeys + lane];
      const bool ok = key < end && (!a.causal || key <= a.q_offset + r / G);
      s = ok ? s : -INFINITY;
      float tmax = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_r[i], tmax);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m_r[i] - mu);
      const float p = expf(s - mu);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_r[i] = l_r[i] * corr + psum;
      m_r[i] = m_new;
      Ps[r * kSplitKeys + lane] = p;
      if (lane == 0) Cs[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P . V over this thread's keys, at dim dcol
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] *= Cs[r];
    if (pv) {
#pragma unroll
      for (int j4 = 0; j4 < KPG; j4 += 4) {
        const int j = kg * KPG + j4;
        float vj[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) vj[e] = as_f32(Vs[(j + e) * LD + dcol]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 p =
              *reinterpret_cast<const float4*>(Ps + r * kSplitKeys + j);
          acc[r] += p.x * vj[0] + p.y * vj[1] + p.z * vj[2] + p.w * vj[3];
        }
      }
    }
  }

  // the partials of this split
  const size_t p0 = ((static_cast<size_t>(b) * a.Hkv + kvh) * a.n_split +
                     split) * R;     // (b, kvh, split, row 0)
#pragma unroll
  for (int i = 0; i < (RB + 3) / 4; ++i) {
    const int r = warp + 4 * i;
    if (r < R && lane == 0) {
      a.m[p0 + r] = m_r[i];
      a.l[p0 + r] = l_r[i];
    }
  }
  if constexpr (KG == 1) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < R && pv) a.acc[(p0 + r) * HD + dcol] = acc[r];
  } else {
    // the score parts are free (last read before the last tile's second
    // barrier): [RB][HD], key groups added in order
    float* red = Sp;
    for (int g = 0; g < KG; ++g) {
      if (kg == g) {
#pragma unroll
        for (int r = 0; r < RB; ++r)
          red[r * HD + dcol] = g ? red[r * HD + dcol] + acc[r] : acc[r];
      }
      __syncthreads();
    }
    for (int e = tid; e < R * HD; e += kSplitThreads)
      a.acc[p0 * HD + e] = red[e];
  }
}

template <typename T, int HD, int RB>
int launch_split(const SplitArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<T, HD, RB>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_split_kernel<T, HD, RB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(a.n_split, a.Hkv, B);
  flash_attention_split_kernel<T, HD, RB>
      <<<grid, kSplitThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_split_rows(const SplitArgs& a, int B, cudaStream_t stream) {
  return a.R <= 4 ? launch_split<T, HD, 4>(a, B, stream)
                  : launch_split<T, HD, kSplitRows>(a, B, stream);
}

template <typename T>
int launch_split_hd(const SplitArgs& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_split_rows<T, 16>(a, B, stream);
    case 32: return launch_split_rows<T, 32>(a, B, stream);
    case 64: return launch_split_rows<T, 64>(a, B, stream);
    case 112: return launch_split_rows<T, 112>(a, B, stream);
    case 128: return launch_split_rows<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct CombineArgs {
  const float* m;
  const float* l;
  const float* acc;
  void* o;
  int Sq, H, Hkv, G, R, hd, n_split, n_rows;   // n_rows = B * Hkv * R
};

// one warp per row (b, kv head, r): lanes over the splits for m* and l*,
// then over the head dims (at most 128: 4 per lane)
template <typename T>
__global__ void __launch_bounds__(128)
flash_attention_combine_kernel(const CombineArgs a) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= a.n_rows) return;
  const int r = row % a.R, bh = row / a.R;
  const int kvh = bh % a.Hkv, b = bh / a.Hkv;
  const size_t p0 = static_cast<size_t>(bh) * a.n_split * a.R + r;
  float mx = -INFINITY;
  for (int s = lane; s < a.n_split; s += 32)
    mx = fmaxf(mx, a.m[p0 + s * a.R]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float mu = mx == -INFINITY ? 0.f : mx;
  float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < a.n_split; s0 += 32) {
    const int s = s0 + lane;
    const float w = s < a.n_split ? expf(a.m[p0 + s * a.R] - mu) : 0.f;
    if (s < a.n_split) lsum += a.l[p0 + s * a.R] * w;
    const int ns = min(32, a.n_split - s0);
    for (int u = 0; u < ns; ++u) {
      const float wu = __shfl_sync(0xffffffffu, w, u);
      const float* src = a.acc + (p0 + (s0 + u) * a.R) * a.hd;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane + 32 * i < a.hd) o[i] += src[lane + 32 * i] * wu;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  T* dst = static_cast<T*>(a.o) +
           ((static_cast<size_t>(b) * a.Sq + r / a.G) * a.H + kvh * a.G +
            r % a.G) * a.hd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < a.hd)
      store_out(dst + lane + 32 * i, lsum == 0.f ? 0.f : o[i] / lsum);
}

// ---------------------------------------------------------------------------
// 4. the backward (training): dQ (and D), then dK and dV
// ---------------------------------------------------------------------------
// Replaces the gradient the JAX package takes by autodiff of its jnp
// attention (src/repro/models/layers.py:72); its Pallas kernel has no
// backward.  The training case only: q_offset = 0 and every key valid,
// causal or not, any G.  With P = exp(S - lse) recomputed from (q hd^-1/2)
// . k and the forward's row log-sum-exp, and D = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = hd^-1/2 dS K,  dK = hd^-1/2 dS^T Q.
// Bound by operations: five products of 2 hd flops per visible (query,
// key) pair and head (the dQ kernel recomputes S and dP, so the two
// kernels run seven).  These two are the f32 route (dtype 0): they run on
// the CUDA cores in f32, since TF32 would not hold the f32 tolerance;
// bf16 takes the tensor-core kernels of section 5.  Deterministic: no
// float atomics, every output element is written once by one thread, and
// every sum is taken in a fixed order.
//
// flash_attention_bwd_dq_kernel<HD>: one CTA (256 threads as 16 x 16)
//   per (query tile of 64, head, batch row), the tiles with the most keys
//   first.  It stages Q (times hd^-1/2) and dO as f32 in shared memory
//   (rows padded by 4 floats: the 16-byte reads of 8 neighbouring rows
//   fall in distinct banks), the rows' lse and D (which it computes, four
//   threads a row, and writes out for the second kernel), then walks the
//   key tiles its queries see: stages K and V, computes S and dP (a thread
//   4 rows x 4 keys), P and dS, puts dS in shared memory and adds dS K to
//   dQ, a thread's 4 rows x HD/16 dims in registers.
// flash_attention_bwd_dkdv_kernel<HD>: one CTA per (key tile of 64, kv
//   head, batch row), the tiles that the most queries see first.  It
//   stages its K and V once, then walks, for each of the G query heads of
//   its kv head in turn, every query tile that sees its keys: stages Q
//   (scaled) and dO, lse and D, computes S, dP, P and dS (a thread 4 rows x
//   4 keys) into shared memory, and adds P^T dO to dV and dS^T Q to dK, a
//   thread's 4 keys x HD/16 dims in registers.  The sum over the G heads
//   stays inside the CTA.
// A row that sees no key (lse = -inf) has P = 0 and adds 0; a key that no
// query sees gets dK = dV = 0.
constexpr int kBwThreads = 256;      // 16 x 16
constexpr int kBwTile = 64;          // queries of a query tile, keys of a key tile

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                  // [B, H, Sq] from the forward
  float* D;                          // [B, H, Sq]: the dQ kernel writes it
  void* dq;
  void* dk;
  void* dv;
  int Sq, Skv, H, Hkv, G, causal;
  float scale;
};

// floats a thread reads at once of its DN = HD / 16 dims (tx + 16 m blocks
// of VD): 4 where they divide DN, else 1 (hd 112: 7 dims, tx + 16 m)
__host__ __device__ constexpr int bwd_vd(int dn) {
  return dn < 4 ? dn : dn % 4 == 0 ? 4 : 1;
}

// four [64][HD + pad] f32 tiles, n_p [64][64 + pad] ones, lse and D
template <int HD>
constexpr size_t bwd_smem_bytes(int n_p) {
  return sizeof(float) *
         (4 * static_cast<size_t>(kBwTile) * (HD + kPad) +
          static_cast<size_t>(n_p) * kBwTile * (kBwTile + kPad) +
          2 * kBwTile);
}

// rows [0, n) of an f32 tile at src (rows `stride` elements apart) into
// dst ([64][HD + pad] f32), times mul; rows n.. are zero
template <int HD>
__device__ __forceinline__ void bwd_stage(float* dst, const float* src,
                                          size_t stride, int n, float mul) {
  constexpr int NC = HD / 8;
  constexpr int LD = HD + kPad;
  for (int e = threadIdx.x; e < kBwTile * NC; e += kBwThreads) {
    const int r = e / NC, c = e % NC;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n) load_f32<float, 8>(src + r * stride + c * 8, f);
    float4* d4 = reinterpret_cast<float4*>(dst + r * LD + c * 8);
    d4[0] = make_float4(f[0] * mul, f[1] * mul, f[2] * mul, f[3] * mul);
    d4[1] = make_float4(f[4] * mul, f[5] * mul, f[6] * mul, f[7] * mul);
  }
}

// S = Qs . Ks^T and dP = dOs . Vs^T for rows ty + 16 i, keys tx + 16 c
template <int HD>
__device__ __forceinline__ void bwd_scores(const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs,
                                           int ty, int tx, float (&s)[4][4],
                                           float (&dp)[4][4]) {
  constexpr int LD = HD + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qv[4], ov[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
      ov[i] = *reinterpret_cast<const float4*>(dOs + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 kv =
          *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * LD + d);
      const float4 vv =
          *reinterpret_cast<const float4*>(Vs + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][c] += qv[i].x * kv.x + qv[i].y * kv.y + qv[i].z * kv.z +
                   qv[i].w * kv.w;
        dp[i][c] += ov[i].x * vv.x + ov[i].y * vv.y + ov[i].z * vv.z +
                    ov[i].w * vv.w;
      }
    }
  }
}

// s -> P, dp -> dS for the thread's 4 x 4 (query tile at q0, key tile at
// k0): P = exp(S - lse) where the key is visible, else 0
__device__ __forceinline__ void bwd_probs(float (&s)[4][4], float (&dp)[4][4],
                                          const float* lse_s,
                                          const float* D_s, int ty, int tx,
                                          int q0, int k0, int Sq, int Skv,
                                          int causal) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const float L = lse_s[ty + 16 * i], Dv = D_s[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kj = k0 + tx + 16 * c;
      const bool ok = qi < Sq && kj < Skv && (!causal || kj <= qi) &&
                      L != -INFINITY;
      const float p = ok ? expf(s[i][c] - L) : 0.f;
      s[i][c] = p;
      dp[i][c] = p * (dp[i][c] - Dv);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwThreads, 1)
flash_attention_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LD = HD + kPad, PLD = kBwTile + kPad;
  constexpr int DN = HD / 16, VD = bwd_vd(DN);
  extern __shared__ float4 bw_smem4[];
  float* Qs = reinterpret_cast<float*>(bw_smem4);
  float* dOs = Qs + kBwTile * LD;
  float* Ks = dOs + kBwTile * LD;
  float* Vs = Ks + kBwTile * LD;
  float* dSs = Vs + kBwTile * LD;        // [key][slot 4 ty + i of row ty + 16 i]
  float* lse_s = dSs + kBwTile * PLD;
  float* D_s = lse_s + kBwTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwTile;   // heaviest first
  const int h = blockIdx.x % a.H, b = blockIdx.x / a.H;
  const int kvh = h / a.G;
  const int nq = min(kBwTile, a.Sq - q0);
  const size_t qs = static_cast<size_t>(a.H) * HD;
  const size_t ks = static_cast<size_t>(a.Hkv) * HD;
  const size_t qoff = (static_cast<size_t>(b) * a.Sq + q0) * qs + h * HD;
  const size_t koff = static_cast<size_t>(b) * a.Skv * ks + kvh * HD;
  const float* q = static_cast<const float*>(a.q) + qoff;
  const float* o = static_cast<const float*>(a.o) + qoff;
  const float* dout = static_cast<const float*>(a.dout) + qoff;
  const float* k = static_cast<const float*>(a.k) + koff;
  const float* v = static_cast<const float*>(a.v) + koff;
  const size_t row0 = (static_cast<size_t>(b) * a.H + h) * a.Sq + q0;

  bwd_stage<HD>(Qs, q, qs, nq, a.scale);
  bwd_stage<HD>(dOs, dout, qs, nq, 1.f);
  {  // D = rowsum(dO o O), four threads a row, in a fixed order
    const int r = tid / 4, part = tid % 4;
    float acc = 0.f;
    if (r < nq) {
      for (int d = part * 8; d < HD; d += 32) {
        float fo[8], fd[8];
        load_f32<float, 8>(o + r * qs + d, fo);
        load_f32<float, 8>(dout + r * qs + d, fd);
#pragma unroll
        for (int t = 0; t < 8; ++t) acc += fo[t] * fd[t];
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      D_s[r] = acc;
      lse_s[r] = r < nq ? a.lse[row0 + r] : -INFINITY;
      if (r < nq) a.D[row0 + r] = acc;
    }
  }

  int kend = a.Skv;
  if (a.causal) kend = min(kend, q0 + nq);
  const int n_kt = kend > 0 ? (kend + kBwTile - 1) / kBwTile : 0;
  float acc[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBwTile;
    __syncthreads();               // staged rows ready; last tile's readers done
    bwd_stage<HD>(Ks, k + k0 * ks, ks, min(kBwTile, a.Skv - k0), 1.f);
    bwd_stage<HD>(Vs, v + k0 * ks, ks, min(kBwTile, a.Skv - k0), 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    bwd_scores<HD>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    bwd_probs(s, dp, lse_s, D_s, ty, tx, q0, k0, a.Sq, a.Skv, a.causal);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(dSs + (tx + 16 * c) * PLD + 4 * ty) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    __syncthreads();
    const int jmax = min(kBwTile, kend - k0);
    for (int j = 0; j < jmax; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(dSs + j * PLD + 4 * ty);
      const float ds[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int mm = 0; mm < DN / VD; ++mm) {
        float kv[VD];
        lds<VD>(Ks + j * LD + VD * (tx + 16 * mm), kv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VD; ++e) acc[i][mm * VD + e] += ds[i] * kv[e];
      }
    }
  }

  float* dq = static_cast<float*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
#pragma unroll
    for (int mm = 0; mm < DN / VD; ++mm)
#pragma unroll
      for (int e = 0; e < VD; ++e)
        store_out(dq + r * qs + VD * (tx + 16 * mm) + e,
                  acc[i][mm * VD + e] * a.scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwThreads, 1)
flash_attention_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int LD = HD + kPad, PLD = kBwTile + kPad;
  constexpr int DN = HD / 16, VD = bwd_vd(DN);
  extern __shared__ float4 bw_smem4[];
  float* Ks = reinterpret_cast<float*>(bw_smem4);
  float* Vs = Ks + kBwTile * LD;
  float* Qs = Vs + kBwTile * LD;
  float* dOs = Qs + kBwTile * LD;
  float* Ps = dOs + kBwTile * LD;        // [row][slot 4 tx + c of key tx + 16 c]
  float* dSs = Ps + kBwTile * PLD;
  float* lse_s = dSs + kBwTile * PLD;
  float* D_s = lse_s + kBwTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.y * kBwTile;   // tile 0 is seen by the most queries
  const int kvh = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int nk = min(kBwTile, a.Skv - k0);
  const size_t qs = static_cast<size_t>(a.H) * HD;
  const size_t ks = static_cast<size_t>(a.Hkv) * HD;
  const size_t koff = (static_cast<size_t>(b) * a.Skv + k0) * ks + kvh * HD;
  bwd_stage<HD>(Ks, static_cast<const float*>(a.k) + koff, ks, nk, 1.f);
  bwd_stage<HD>(Vs, static_cast<const float*>(a.v) + koff, ks, nk, 1.f);

  float dk[4][DN], dv[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DN; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int n_qt = (a.Sq + kBwTile - 1) / kBwTile;
  const int qt0 = a.causal ? k0 / kBwTile : 0;   // queries >= k0 see key k0
  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBwTile;
      const int nq = min(kBwTile, a.Sq - q0);
      const size_t qoff = (static_cast<size_t>(b) * a.Sq + q0) * qs + h * HD;
      const size_t row0 = (static_cast<size_t>(b) * a.H + h) * a.Sq + q0;
      __syncthreads();             // K, V staged; last tile's readers done
      bwd_stage<HD>(Qs, static_cast<const float*>(a.q) + qoff, qs, nq,
                       a.scale);
      bwd_stage<HD>(dOs, static_cast<const float*>(a.dout) + qoff, qs, nq,
                       1.f);
      if (tid < kBwTile) {
        lse_s[tid] = tid < nq ? a.lse[row0 + tid] : -INFINITY;
        D_s[tid] = tid < nq ? a.D[row0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      bwd_scores<HD>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
      bwd_probs(s, dp, lse_s, D_s, ty, tx, q0, k0, a.Sq, a.Skv, a.causal);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(Ps + (ty + 16 * i) * PLD + 4 * tx) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        *reinterpret_cast<float4*>(dSs + (ty + 16 * i) * PLD + 4 * tx) =
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      }
      __syncthreads();
      for (int r = 0; r < nq; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + r * PLD + 4 * ty);
        const float4 d4 = *reinterpret_cast<const float4*>(dSs + r * PLD + 4 * ty);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
        const float ds[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int mm = 0; mm < DN / VD; ++mm) {
          float ov[VD], qv[VD];
          lds<VD>(dOs + r * LD + VD * (tx + 16 * mm), ov);
          lds<VD>(Qs + r * LD + VD * (tx + 16 * mm), qv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < VD; ++e) {
              dv[i][mm * VD + e] += p[i] * ov[e];
              dk[i][mm * VD + e] += ds[i] * qv[e];
            }
        }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk) + koff;
  float* dvp = static_cast<float*>(a.dv) + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = ty + 16 * i;
    if (j >= nk) continue;
#pragma unroll
    for (int mm = 0; mm < DN / VD; ++mm)
#pragma unroll
      for (int e = 0; e < VD; ++e) {
        const size_t off = j * ks + VD * (tx + 16 * mm) + e;
        store_out(dkp + off, dk[i][mm * VD + e]);   // Q was staged scaled
        store_out(dvp + off, dv[i][mm * VD + e]);
      }
  }
}

template <int HD>
int launch_bwd(const BwdArgs& a, int B, bool dq, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bwd_dq_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_smem_bytes<HD>(1)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_smem_bytes<HD>(2)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (dq) {
    const dim3 grid(B * a.H, (a.Sq + kBwTile - 1) / kBwTile);
    flash_attention_bwd_dq_kernel<HD>
        <<<grid, kBwThreads, bwd_smem_bytes<HD>(1), stream>>>(a);
  } else {
    const dim3 grid(B * a.Hkv, (a.Skv + kBwTile - 1) / kBwTile);
    flash_attention_bwd_dkdv_kernel<HD>
        <<<grid, kBwThreads, bwd_smem_bytes<HD>(2), stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_hd(const BwdArgs& a, int B, int hd, bool dq,
                  cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_bwd<16>(a, B, dq, stream);
    case 32: return launch_bwd<32>(a, B, dq, stream);
    case 64: return launch_bwd<64>(a, B, dq, stream);
    case 112: return launch_bwd<112>(a, B, dq, stream);
    case 128: return launch_bwd<128>(a, B, dq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// 5. the backward on the tensor cores (bf16): dQ (and D), then dK and dV
// ---------------------------------------------------------------------------
// The same function as section 4 for bf16 inputs (it replaces the same
// autodiff, src/repro/models/layers.py:72), its products on the tensor
// cores (wgmma.mma_async m64nNk16, bf16 in, f32 accumulate, one
// warpgroup of 128 threads a CTA).  Bound by operations at the bf16 rate:
// four products of 2 hd flops per visible (query, key) pair and head in
// the dK/dV kernel, three in the dQ kernel (it recomputes S and dP); at
// train_4k's seq 4096, 16/8 heads, hd 128, causal, 0.139 and 0.104 ms on
// an H100 at 989 TFLOP/s.  Every tile of Q,
// dO, K and V lives in shared memory in the prefill kernel's swizzled
// layout (`SwzTile`), read by descriptor as a K-major operand (A or B) and,
// for the products over keys or queries, as an N-major one from the same
// bytes.  P and dS are computed in f32 on the accumulator fragments and
// become register A operands as the prefill kernel's P does, each carried
// as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), so a product
// over them takes 8 k-steps of 16 for 64 keys (or queries): one bf16
// rounding of P and dS put the gradients at (b)'s shape, seq 4096, 1.2-2.0
// times the bf16 tolerance away from the f32 plain version, two terms at
// 0.21 (the plain replay, scripts/attn_bwd_rounding.py).  Each product is
// one asm block that fences, starts its wgmmas, commits and waits.
// Deterministic: no atomics; one CTA writes each output element, and the
// G heads' sum of a kv head stays in its CTA.
//
// flash_attention_bwd_dq_wgmma_kernel<HD>: one CTA per 64 rows r = i G + g
//   of one kv head (64 / G queries of its G heads, as the prefill kernel
//   packs them: the G heads share every K/V tile), latest queries first.
//   It loads its Q and dO tiles once (cp.async), computes D = rowsum(dO o
//   O) of its rows (a quad of threads a row, in a fixed order) and writes
//   it for the second kernel, then streams the 64-key K/V tiles its
//   queries see through a two-stage cp.async ring, one barrier a tile:
//   S = Q K^T and dP = dO V^T (A and B by descriptor), P = exp2(S hd^-1/2
//   log2 e - lse log2 e), dS = P o (dP - D), dQ += dS K (K N-major).  dQ is
//   scaled by hd^-1/2 in f32 at the end.
// flash_attention_bwd_dkdv_wgmma_kernel<HD>: one CTA per 64 keys of one kv
//   head, key tile 0 (seen by the most queries under the causal mask)
//   first.  It loads K and V once, then walks each of the G heads' 64-query
//   tiles that see its keys (from its own under the causal mask), Q, dO,
//   lse and D through a two-stage cp.async ring: S^T = K Q^T and dP^T = V
//   dO^T (K and V the A operands by descriptor), P^T and dS^T on the
//   fragments, dV += P^T dO and dK += dS^T Q (dO and Q N-major).  dK is
//   scaled by hd^-1/2 at the end.
// Tiles wholly masked are never visited; only tiles that a bound (causal,
// Sq, Skv) crosses are masked.  A row whose lse is -inf (none in the
// training case unless Skv = 0) gets P = 0.
// hd 112 (zamba2-7b's 3584 / 32) runs both kernels on the hd 128 tiles
// (`<128, 112>`), as kernel 1 does: dims 112-127 of every Q, dO, K and V
// tile are zero-filled by cp.async (and the dQ kernel's D reads 112), so
// S, dP and every product over them are the hd 112 ones; dQ, dK and dV
// come out with zero columns 112-127, which are not stored.  The padding
// lives in shared memory only: no column mask in registers, so the
// kernels keep the hd 128 instantiations' registers.

// 4 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// x, y -> hi = their bf16 roundings, lo = the bf16 roundings of what is
// left (x - hi is exact in f32)
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// a 64 x 64 accumulator (the mma.sync C layout per warp) -> A fragments
// of its 4 16-column steps, hi terms in steps 0-3, lo terms in 4-7
__device__ __forceinline__ void split_a(const float (&x)[32],
                                        unsigned (&a)[8][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(x[8 * t + 2 * i], x[8 * t + 2 * i + 1], a[t][i],
                 a[4 + t][i]);
}

// asm text of the products: the accumulator lists, one wgmma a step
#define WG_D8(a, b, c, d, e, f, g, h) \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h
#define WG_D8S "{" WG_D8(0, 1, 2, 3, 4, 5, 6, 7) "}"
#define WG_D16 "{" WG_D8(0, 1, 2, 3, 4, 5, 6, 7) ", " \
  WG_D8(8, 9, 10, 11, 12, 13, 14, 15) "}"
#define WG_D16B "{" WG_D8(16, 17, 18, 19, 20, 21, 22, 23) ", " \
  WG_D8(24, 25, 26, 27, 28, 29, 30, 31) "}"
#define WG_D32 "{" WG_D8(0, 1, 2, 3, 4, 5, 6, 7) ", " \
  WG_D8(8, 9, 10, 11, 12, 13, 14, 15) ", " \
  WG_D8(16, 17, 18, 19, 20, 21, 22, 23) ", " \
  WG_D8(24, 25, 26, 27, 28, 29, 30, 31) "}"
#define WG_D64 "{" WG_D8(0, 1, 2, 3, 4, 5, 6, 7) ", " \
  WG_D8(8, 9, 10, 11, 12, 13, 14, 15) ", " \
  WG_D8(16, 17, 18, 19, 20, 21, 22, 23) ", " \
  WG_D8(24, 25, 26, 27, 28, 29, 30, 31) ", " \
  WG_D8(32, 33, 34, 35, 36, 37, 38, 39) ", " \
  WG_D8(40, 41, 42, 43, 44, 45, 46, 47) ", " \
  WG_D8(48, 49, 50, 51, 52, 53, 54, 55) ", " \
  WG_D8(56, 57, 58, 59, 60, 61, 62, 63) "}"
// fence; pf / pt: a false and a true predicate from operand z
#define WG_BEGIN(z) \
  "{\n.reg .pred pf, pt;\n" \
  "setp.ne.b32 pf, %" #z ", %" #z ";\n" \
  "setp.eq.b32 pt, %" #z ", %" #z ";\n" \
  "wgmma.fence.sync.aligned;\n"
#define WG_END \
  "wgmma.commit_group.sync.aligned;\n" \
  "wgmma.wait_group.sync.aligned 0;\n}\n"
// both operands K-major by descriptor; p: pf overwrites, pt adds
#define WG_SS(ad, bd, p) \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32 \
  ", %" #ad ", %" #bd ", " #p ", 1, 1, 0, 0;\n"
// A in registers (operands a0-a3), B N-major by descriptor, adds
#define WG_RS(n, acc, a0, a1, a2, a3, bd) \
  "wgmma.mma_async.sync.aligned.m64n" #n "k16.f32.bf16.bf16 " acc \
  ", {%" #a0 ", %" #a1 ", %" #a2 ", %" #a3 "}, %" #bd ", pt, 1, 1, 1;\n"
#define WG_OUT8(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_OUT32(d) WG_OUT8(d, 0), WG_OUT8(d, 8), WG_OUT8(d, 16), \
  WG_OUT8(d, 24)
#define WG_A4(a, t) "r"(a[t][0]), "r"(a[t][1]), "r"(a[t][2]), "r"(a[t][3])
#define WG_A32(a) WG_A4(a, 0), WG_A4(a, 1), WG_A4(a, 2), WG_A4(a, 3), \
  WG_A4(a, 4), WG_A4(a, 5), WG_A4(a, 6), WG_A4(a, 7)

// D (64 x 64, f32) = A (64 x 16 KS, K-major by descriptor) . B^T (64 x 16
// KS, K-major by descriptor), KS steps, the first overwriting D
template <int KS>
struct WgmmaSS;

template <>
struct WgmmaSS<1> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned long long (&a)[1],
      const unsigned long long (&b)[1]) {
    asm volatile(
        WG_BEGIN(34)
        WG_SS(32, 33, pf)
        WG_END
        : WG_OUT32(d)
        : "l"(a[0]), "l"(b[0]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaSS<2> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned long long (&a)[2],
      const unsigned long long (&b)[2]) {
    asm volatile(
        WG_BEGIN(36)
        WG_SS(32, 34, pf)
        WG_SS(33, 35, pt)
        WG_END
        : WG_OUT32(d)
        : "l"(a[0]), "l"(a[1]), "l"(b[0]), "l"(b[1]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaSS<4> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned long long (&a)[4],
      const unsigned long long (&b)[4]) {
    asm volatile(
        WG_BEGIN(40)
        WG_SS(32, 36, pf)
        WG_SS(33, 37, pt)
        WG_SS(34, 38, pt)
        WG_SS(35, 39, pt)
        WG_END
        : WG_OUT32(d)
        : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]), "l"(b[0]), "l"(b[1]),
          "l"(b[2]), "l"(b[3]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaSS<8> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned long long (&a)[8],
      const unsigned long long (&b)[8]) {
    asm volatile(
        WG_BEGIN(48)
        WG_SS(32, 40, pf)
        WG_SS(33, 41, pt)
        WG_SS(34, 42, pt)
        WG_SS(35, 43, pt)
        WG_SS(36, 44, pt)
        WG_SS(37, 45, pt)
        WG_SS(38, 46, pt)
        WG_SS(39, 47, pt)
        WG_END
        : WG_OUT32(d)
        : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]), "l"(a[4]), "l"(a[5]),
          "l"(a[6]), "l"(a[7]), "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]),
          "l"(b[4]), "l"(b[5]), "l"(b[6]), "l"(b[7]), "r"(0)
        : "memory");
  }
};

// D (64 x N, f32) += A (64 x 64 as hi and lo bf16 terms: register A
// fragments, steps 0-3 the hi terms of 16 columns each, 4-7 the lo terms)
// . B (64 x N, N-major by descriptor, one a 16-row step, read for both
// terms); N = 64 as two n32 halves (desc[2 t + h] for half h), as the
// prefill kernel's P.V
template <int N>
struct WgmmaRS2;

template <>
struct WgmmaRS2<16> {
  static __device__ __forceinline__ void run(
      float (&d)[8], const unsigned (&a)[8][4],
      const unsigned long long (&desc)[4]) {
    asm volatile(
        WG_BEGIN(44)
        WG_RS(16, WG_D8S, 8, 9, 10, 11, 40)
        WG_RS(16, WG_D8S, 12, 13, 14, 15, 41)
        WG_RS(16, WG_D8S, 16, 17, 18, 19, 42)
        WG_RS(16, WG_D8S, 20, 21, 22, 23, 43)
        WG_RS(16, WG_D8S, 24, 25, 26, 27, 40)
        WG_RS(16, WG_D8S, 28, 29, 30, 31, 41)
        WG_RS(16, WG_D8S, 32, 33, 34, 35, 42)
        WG_RS(16, WG_D8S, 36, 37, 38, 39, 43)
        WG_END
        : WG_OUT8(d, 0)
        : WG_A32(a), "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]),
          "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaRS2<32> {
  static __device__ __forceinline__ void run(
      float (&d)[16], const unsigned (&a)[8][4],
      const unsigned long long (&desc)[4]) {
    asm volatile(
        WG_BEGIN(52)
        WG_RS(32, WG_D16, 16, 17, 18, 19, 48)
        WG_RS(32, WG_D16, 20, 21, 22, 23, 49)
        WG_RS(32, WG_D16, 24, 25, 26, 27, 50)
        WG_RS(32, WG_D16, 28, 29, 30, 31, 51)
        WG_RS(32, WG_D16, 32, 33, 34, 35, 48)
        WG_RS(32, WG_D16, 36, 37, 38, 39, 49)
        WG_RS(32, WG_D16, 40, 41, 42, 43, 50)
        WG_RS(32, WG_D16, 44, 45, 46, 47, 51)
        WG_END
        : WG_OUT8(d, 0), WG_OUT8(d, 8)
        : WG_A32(a), "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]),
          "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaRS2<64> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const unsigned (&a)[8][4],
      const unsigned long long (&desc)[8]) {
    asm volatile(
        WG_BEGIN(72)
        WG_RS(32, WG_D16, 32, 33, 34, 35, 64)
        WG_RS(32, WG_D16B, 32, 33, 34, 35, 65)
        WG_RS(32, WG_D16, 36, 37, 38, 39, 66)
        WG_RS(32, WG_D16B, 36, 37, 38, 39, 67)
        WG_RS(32, WG_D16, 40, 41, 42, 43, 68)
        WG_RS(32, WG_D16B, 40, 41, 42, 43, 69)
        WG_RS(32, WG_D16, 44, 45, 46, 47, 70)
        WG_RS(32, WG_D16B, 44, 45, 46, 47, 71)
        WG_RS(32, WG_D16, 48, 49, 50, 51, 64)
        WG_RS(32, WG_D16B, 48, 49, 50, 51, 65)
        WG_RS(32, WG_D16, 52, 53, 54, 55, 66)
        WG_RS(32, WG_D16B, 52, 53, 54, 55, 67)
        WG_RS(32, WG_D16, 56, 57, 58, 59, 68)
        WG_RS(32, WG_D16B, 56, 57, 58, 59, 69)
        WG_RS(32, WG_D16, 60, 61, 62, 63, 70)
        WG_RS(32, WG_D16B, 60, 61, 62, 63, 71)
        WG_END
        : WG_OUT32(d)
        : WG_A32(a), "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]),
          "l"(desc[4]), "l"(desc[5]), "l"(desc[6]), "l"(desc[7]), "r"(0)
        : "memory");
  }
};

template <>
struct WgmmaRS2<128> {
  static __device__ __forceinline__ void run(
      float (&d)[64], const unsigned (&a)[8][4],
      const unsigned long long (&desc)[4]) {
    asm volatile(
        WG_BEGIN(100)
        WG_RS(128, WG_D64, 64, 65, 66, 67, 96)
        WG_RS(128, WG_D64, 68, 69, 70, 71, 97)
        WG_RS(128, WG_D64, 72, 73, 74, 75, 98)
        WG_RS(128, WG_D64, 76, 77, 78, 79, 99)
        WG_RS(128, WG_D64, 80, 81, 82, 83, 96)
        WG_RS(128, WG_D64, 84, 85, 86, 87, 97)
        WG_RS(128, WG_D64, 88, 89, 90, 91, 98)
        WG_RS(128, WG_D64, 92, 93, 94, 95, 99)
        WG_END
        : WG_OUT32(d), WG_OUT8(d, 32), WG_OUT8(d, 40), WG_OUT8(d, 48),
          WG_OUT8(d, 56)
        : WG_A32(a), "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]),
          "r"(0)
        : "memory");
  }
};

// HD: the tiles' and products' width; HDG <= HD: the tensors' head dim
// (dims HDG..HD-1 of every tile zero-filled, never stored), as in kernel 1
template <int HD, int HDG = HD>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_bwd_dq_wgmma_kernel(const BwdArgs a) {
  using L = SwzTile<HD>;
  constexpr int KS = HD / 16;
  constexpr int CPG = HDG / 8, NOG = HDG / 8;   // chunks read, 8-dim tiles stored
  static_assert(HDG <= HD && HDG % 8 == 0, "the stored dims fit the tile");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* const Qs = wg_smem;
  unsigned char* const dOs = Qs + L::BYTES;
  unsigned char* const KV = dOs + L::BYTES;  // stage s: K, V at 2 s, 2 s + 1
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, BQ = kWgRows / G;
  const int kvh = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;     // heaviest first
  const int nq = min(BQ, a.Sq - q0), rows = nq * G;
  int kend = a.Skv;
  if (a.causal) kend = min(kend, q0 + nq);
  const int n_tiles = (kend + kWgKeys - 1) / kWgKeys;
  const bf16* const q = static_cast<const bf16*>(a.q);
  const bf16* const o = static_cast<const bf16*>(a.o);
  const bf16* const dout = static_cast<const bf16*>(a.dout);
  const bf16* const k = static_cast<const bf16*>(a.k);
  const bf16* const v = static_cast<const bf16*>(a.v);
  // row r: query q0 + r / G of head kvh G + r % G
  auto row_off = [&](int r) {
    return ((static_cast<size_t>(b) * a.Sq + q0 + r / G) * a.H + kvh * G +
            r % G) * HDG;
  };
  auto row_stat = [&](int r) {          // its index in lse and D
    return (static_cast<size_t>(b) * a.H + kvh * G + r % G) * a.Sq + q0 +
           r / G;
  };
  L::template load<CPG>(Qs, rows, [&](int r) { return q + row_off(r); });
  L::template load<CPG>(dOs, rows, [&](int r) { return dout + row_off(r); });
  cp_async_commit();
  auto load_tile = [&](int kt) {        // keys at or past kend zero-filled
    unsigned char* Ks = KV + (kt & 1) * 2 * L::BYTES;
    const int k0 = kt * kWgKeys;
    auto key = [&](int j) {
      return (static_cast<size_t>(b) * a.Skv + k0 + j) * a.Hkv * HDG +
             kvh * HDG;
    };
    L::template load<CPG>(Ks, kend - k0, [&](int j) { return k + key(j); });
    L::template load<CPG>(Ks + L::BYTES, kend - k0,
                          [&](int j) { return v + key(j); });
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  // D = rowsum(dO o O) and lse (times log2 e; +inf where there is none)
  // of the thread's rows r0, r0 + 8, the quad's four threads summing
  // every fourth 8-dim chunk, then each other's sums
  const float kLog2e = 1.4426950408889634f;
  const int r0 = warp * 16 + (lane >> 2);
  float Dr[2], Lr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float acc = 0.f;
    if (r < rows) {
      for (int c = lane & 3; c < CPG; c += 4) {
        float fo[8], fd[8];
        load_f32<bf16, 8>(o + row_off(r) + c * 8, fo);
        load_f32<bf16, 8>(dout + row_off(r) + c * 8, fd);
#pragma unroll
        for (int t = 0; t < 8; ++t) acc += fo[t] * fd[t];
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    Dr[i] = acc;
    const float l = r < rows ? a.lse[row_stat(r)] : -INFINITY;
    Lr[i] = l == -INFINITY ? INFINITY : l * kLog2e;
    if (r < rows && (lane & 3) == 0) a.D[row_stat(r)] = acc;
  }

  const float sl2 = a.scale * kLog2e;
  const int qp0 = q0 + r0 / G, qp1 = q0 + (r0 + 8) / G;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < n_tiles) load_tile(kt + 1);
    cp_async_commit();
    const unsigned Ks = smem_addr(KV) + (kt & 1) * 2 * L::BYTES;
    const unsigned Vs = Ks + L::BYTES;
    float s[32], dp[32];
    unsigned long long da[KS], db[KS];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      da[kk] = L::kmajor(smem_addr(Qs), kk);
      db[kk] = L::kmajor(Ks, kk);
    }
    WgmmaSS<KS>::run(s, da, db);                       // S = Q . K^T
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      da[kk] = L::kmajor(smem_addr(dOs), kk);
      db[kk] = L::kmajor(Vs, kk);
    }
    WgmmaSS<KS>::run(dp, da, db);                      // dP = dO . V^T
    const int k0 = kt * kWgKeys;
    if (k0 + kWgKeys > kend || (a.causal && k0 + kWgKeys - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= kend || (a.causal && key > (e < 2 ? qp0 : qp1)))
            s[n * 4 + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {                     // dS = P o (dP - D)
      const int h = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], sl2, -Lr[h])) * (dp[i] - Dr[h]);
    }
    unsigned ds[8][4];
    split_a(s, ds);
    unsigned long long dk[4 * L::NP];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < L::NP; ++h) dk[t * L::NP + h] = L::nmajor(Ks, t, h);
    WgmmaRS2<HD>::run(acc, ds, dk);                    // dQ += dS . K
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
    bf16* dst = static_cast<bf16*>(a.dq) + row_off(r) + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < NOG; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n * 4 + 2 * i] * a.scale,
                                acc[n * 4 + 2 * i + 1] * a.scale);
  }
}

template <int HD, int HDG = HD>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_bwd_dkdv_wgmma_kernel(const BwdArgs a) {
  using L = SwzTile<HD>;
  constexpr int KS = HD / 16;
  constexpr int CPG = HDG / 8, NOG = HDG / 8;
  static_assert(HDG <= HD && HDG % 8 == 0, "the stored dims fit the tile");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* const Ks = wg_smem;
  unsigned char* const Vs = Ks + L::BYTES;
  unsigned char* const QO = Vs + L::BYTES;   // stage s: Q, dO at 2 s, 2 s + 1
  float* const stats = reinterpret_cast<float*>(QO + 4 * L::BYTES);
  // stats + 128 s: lse of stage s's 64 queries, then their D
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G;
  const int kvh = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int kt = blockIdx.y, k0 = kt * kWgKeys;
  const int nk = min(kWgKeys, a.Skv - k0);
  const int n_qt = (a.Sq + kWgRows - 1) / kWgRows;
  const int qt0 = a.causal ? kt : 0;         // queries >= k0 see key k0
  const int per = max(0, n_qt - qt0);        // query tiles of each head
  const int steps = G * per;
  const size_t kv0 = (static_cast<size_t>(b) * a.Skv + k0) * a.Hkv * HDG +
                     kvh * HDG;
  L::template load<CPG>(Ks, nk, [&](int j) {
    return static_cast<const bf16*>(a.k) + kv0 + j * a.Hkv * HDG;
  });
  L::template load<CPG>(Vs, nk, [&](int j) {
    return static_cast<const bf16*>(a.v) + kv0 + j * a.Hkv * HDG;
  });
  // step w: head kvh G + w / per, query tile qt0 + w % per, into stage w & 1
  auto load_step = [&](int w) {
    const int h = kvh * G + w / per, q0 = (qt0 + w % per) * kWgRows;
    const int nq = min(kWgRows, a.Sq - q0);
    unsigned char* Qst = QO + (w & 1) * 2 * L::BYTES;
    auto row = [&](int i) {
      return ((static_cast<size_t>(b) * a.Sq + q0 + i) * a.H + h) * HDG;
    };
    L::template load<CPG>(Qst, nq, [&](int i) {
      return static_cast<const bf16*>(a.q) + row(i);
    });
    L::template load<CPG>(Qst + L::BYTES, nq, [&](int i) {
      return static_cast<const bf16*>(a.dout) + row(i);
    });
    if (tid < kWgRows) {
      const size_t st = (static_cast<size_t>(b) * a.H + h) * a.Sq + q0 +
                        (tid < nq ? tid : 0);
      float* dst = stats + 128 * (w & 1);
      cp_async4(dst + tid, a.lse + st, tid < nq);
      cp_async4(dst + 64 + tid, a.D + st, tid < nq);
    }
  };
  if (steps > 0) load_step(0);
  cp_async_commit();

  const float kLog2e = 1.4426950408889634f;
  const float sl2 = a.scale * kLog2e;
  const int j0 = warp * 16 + (lane >> 2);    // the thread's keys j0, j0 + 8
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int w = 0; w < steps; ++w) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (w + 1 < steps) load_step(w + 1);
    cp_async_commit();
    const int qt = qt0 + w % per, q0 = qt * kWgRows;
    const unsigned Qa = smem_addr(QO) + (w & 1) * 2 * L::BYTES;
    const unsigned dOa = Qa + L::BYTES;
    const float* lse_s = stats + 128 * (w & 1);
    const float* D_s = lse_s + 64;
    float s[32], dp[32];
    unsigned long long da[KS], db[KS];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      da[kk] = L::kmajor(smem_addr(Ks), kk);
      db[kk] = L::kmajor(Qa, kk);
    }
    WgmmaSS<KS>::run(s, da, db);                       // S^T = K . Q^T
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      da[kk] = L::kmajor(smem_addr(Vs), kk);
      db[kk] = L::kmajor(dOa, kk);
    }
    WgmmaSS<KS>::run(dp, da, db);                      // dP^T = V . dO^T
    if ((a.causal && qt == kt) || q0 + kWgRows > a.Sq ||
        k0 + kWgKeys > a.Skv) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + n * 8 + (lane & 3) * 2 + (e & 1);
          const int key = k0 + j0 + (e < 2 ? 0 : 8);
          if (qi >= a.Sq || key >= a.Skv || (a.causal && key > qi))
            s[n * 4 + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)                        // P^T, dS^T
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + (lane & 3) * 2 + (e & 1), i = n * 4 + e;
        const float l = lse_s[c];
        const float p = exp2f(
            fmaf(s[i], sl2, l == -INFINITY ? -INFINITY : -l * kLog2e));
        s[i] = p;
        dp[i] = p * (dp[i] - D_s[c]);
      }
    unsigned pa[8][4];
    unsigned long long dd[4 * L::NP];
    split_a(s, pa);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < L::NP; ++h) dd[t * L::NP + h] = L::nmajor(dOa, t, h);
    WgmmaRS2<HD>::run(dv, pa, dd);                     // dV += P^T . dO
    split_a(dp, pa);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < L::NP; ++h) dd[t * L::NP + h] = L::nmajor(Qa, t, h);
    WgmmaRS2<HD>::run(dk, pa, dd);                     // dK += dS^T . Q
  }

  bf16* const dkp = static_cast<bf16*>(a.dk) + kv0 + (lane & 3) * 2;
  bf16* const dvp = static_cast<bf16*>(a.dv) + kv0 + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + 8 * i;
    if (j >= nk) continue;
    const size_t off = static_cast<size_t>(j) * a.Hkv * HDG;
#pragma unroll
    for (int n = 0; n < NOG; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + n * 8) =
          __floats2bfloat162_rn(dk[n * 4 + 2 * i] * a.scale,
                                dk[n * 4 + 2 * i + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + n * 8) =
          __floats2bfloat162_rn(dv[n * 4 + 2 * i], dv[n * 4 + 2 * i + 1]);
    }
  }
}

template <int HD>
constexpr size_t bwd_mma_smem_bytes(bool dq) {
  // six 64 x HD bf16 tiles (dQ: Q, dO and two stages of K, V; dK/dV: K, V
  // and two stages of Q, dO), the dK/dV kernel's lse and D of two stages
  return 6 * static_cast<size_t>(SwzTile<HD>::BYTES) +
         (dq ? 0 : sizeof(float) * 2 * 2 * kWgRows);
}

template <int HD, int HDG = HD>
int launch_bwd_mma(const BwdArgs& a, int B, bool dq, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bwd_dq_wgmma_kernel<HD, HDG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_mma_smem_bytes<HD>(true)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_wgmma_kernel<HD, HDG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_mma_smem_bytes<HD>(false)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (dq) {
    const int BQ = kWgRows / a.G;
    const dim3 grid(B * a.Hkv, (a.Sq + BQ - 1) / BQ);
    flash_attention_bwd_dq_wgmma_kernel<HD, HDG>
        <<<grid, kWgThreads, bwd_mma_smem_bytes<HD>(true), stream>>>(a);
  } else {
    const dim3 grid(B * a.Hkv, (a.Skv + kWgKeys - 1) / kWgKeys);
    flash_attention_bwd_dkdv_wgmma_kernel<HD, HDG>
        <<<grid, kWgThreads, bwd_mma_smem_bytes<HD>(false), stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// one backward launch: dq (the dQ kernel, which writes D) or dk/dv, of
// the f32 CUDA-core kernels (dtype 0) or the bf16 tensor-core ones (1)
int bwd_launch(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* D, void* dq,
               void* dk, void* dv, int B, int Sq, int Skv, int H, int Hkv,
               int hd, int dtype, int causal, bool is_dq, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > 64 || (dtype != 0 && dtype != 1) || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse; a.D = D;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.Sq = Sq; a.Skv = Skv; a.H = H; a.Hkv = Hkv; a.G = H / Hkv;
  a.causal = causal != 0;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  if (B == 0 || (is_dq ? Sq : Skv) == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_hd(a, B, hd, is_dq, s);
  switch (hd) {
    case 16: return launch_bwd_mma<16>(a, B, is_dq, s);
    case 32: return launch_bwd_mma<32>(a, B, is_dq, s);
    case 64: return launch_bwd_mma<64>(a, B, is_dq, s);
    case 112: return launch_bwd_mma<128, 112>(a, B, is_dq, s);   // zero-padded
    case 128: return launch_bwd_mma<128>(a, B, is_dq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the checks and fields every launch shares; false: invalid arguments
bool fill_args(Args& a, const void* q, const void* k, const void* v,
               void* o, int B, int Sq, int Skv, int H, int Hkv, int hd,
               int causal, int q_offset, int kv_len) {
  if (B < 0 || Sq < 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 64 ||
      Skv < 0 || q_offset < 0 || hd <= 0)
    return false;
  a = Args{};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.Sq = Sq; a.Skv = Skv; a.H = H; a.Hkv = Hkv; a.G = H / Hkv;
  a.causal = causal != 0;
  a.q_offset = q_offset;
  a.kv_valid = kv_len < 0 ? 0 : (kv_len < Skv ? kv_len : Skv);
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  return true;
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream` (shapes and mask above); q, k, v, o
// contiguous, 16-byte aligned; hd in {16, 32, 64, 112, 128} (the forward
// kernels; the backward's {16, 32, 64, 128}); G = H / Hkv at most 64;
// `dtype` 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() (0
// = ok); arguments a kernel does not take return cudaErrorInvalidValue,
// a head dim without an instantiation among them (each `switch (hd)`
// names its widths, and its default launches nothing; an empty call
// returns 0 before it).  The two prefill kernels also write each row's
// log-sum-exp of its scaled scores, f32 [B, H, Sq] (-inf for a row that
// sees no key), where `lse` is not null (training; serving passes null).

// the f32 CUDA-core kernel (dtype 0 only)
int flash_attention_tiled_launch(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int Sq, int Skv,
                                 int H, int Hkv, int hd, int dtype,
                                 int causal, int q_offset, int kv_len,
                                 void* stream) {
  Args a;
  if (!fill_args(a, q, k, v, o, B, Sq, Skv, H, Hkv, hd, causal, q_offset,
                 kv_len) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.lse = lse;
  if (B == 0 || Sq == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_tiled<16>(a, B, s);
    case 32: return launch_tiled<32>(a, B, s);
    case 64: return launch_tiled<64>(a, B, s);
    case 112: return launch_tiled<112>(a, B, s);
    case 128: return launch_tiled<128>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the bf16 tensor-core (wgmma) kernel (dtype 1 only)
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int Sq, int Skv,
                                 int H, int Hkv, int hd, int dtype,
                                 int causal, int q_offset, int kv_len,
                                 void* stream) {
  Args a;
  if (!fill_args(a, q, k, v, o, B, Sq, Skv, H, Hkv, hd, causal, q_offset,
                 kv_len) || dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.lse = lse;
  if (B == 0 || Sq == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_wgmma<16>(a, B, s);
    case 32: return launch_wgmma<32>(a, B, s);
    case 64: return launch_wgmma<64>(a, B, s);
    case 112: return launch_wgmma<128, 112>(a, B, s);   // zero-padded
    case 128: return launch_wgmma<128>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the split kernel: f32 partials m, l [B, Hkv, n_split, R] and acc [B,
// Hkv, n_split, R, hd] (R = G * Sq <= 16) of the key ranges [s * chunk,
// min((s + 1) * chunk, visible)), visible = min(kv_len, Skv) and, causal,
// at most q_offset + Sq; n_split must be the number of such ranges
int flash_attention_split_launch(const void* q, const void* k, const void* v,
                                 float* m, float* l, float* acc, int B,
                                 int Sq, int Skv, int H, int Hkv, int hd,
                                 int dtype, int causal, int q_offset,
                                 int kv_len, int n_split, int chunk,
                                 void* stream) {
  Args a;
  if (!fill_args(a, q, k, v, nullptr, B, Sq, Skv, H, Hkv, hd, causal,
                 q_offset, kv_len) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs sa{};
  sa.q = q; sa.k = k; sa.v = v; sa.m = m; sa.l = l; sa.acc = acc;
  sa.Sq = Sq; sa.Skv = Skv; sa.H = H; sa.Hkv = Hkv; sa.G = a.G;
  sa.R = Sq * a.G;
  sa.causal = a.causal;
  sa.q_offset = q_offset;
  sa.visible = a.kv_valid;
  if (a.causal && q_offset + Sq < sa.visible) sa.visible = q_offset + Sq;
  sa.chunk = chunk;
  sa.n_split = n_split;
  sa.scale = a.scale;
  if (sa.R > kSplitRows || chunk <= 0 ||
      n_split != (sa.visible + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || n_split == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_split_hd<float>(sa, B, hd, s)
                    : launch_split_hd<bf16>(sa, B, hd, s);
}

// the combine pass: o [B, Sq, H, hd] of dtype `dtype` from the partials of
// n_split splits (n_split = 0: zeros)
int flash_attention_combine_launch(const float* m, const float* l,
                                   const float* acc, void* o, int B, int Sq,
                                   int H, int Hkv, int hd, int dtype,
                                   int n_split, void* stream) {
  if (B < 0 || Sq < 0 || Hkv <= 0 || H % Hkv != 0 || hd <= 0 ||
      hd > 128 || n_split < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  CombineArgs c{};
  c.m = m; c.l = l; c.acc = acc; c.o = o;
  c.Sq = Sq; c.H = H; c.Hkv = Hkv; c.G = H / Hkv; c.R = Sq * c.G;
  c.hd = hd; c.n_split = n_split; c.n_rows = B * Hkv * c.R;
  if (c.n_rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = (c.n_rows + 3) / 4;
  if (dtype == 0)
    flash_attention_combine_kernel<float><<<grid, 128, 0, s>>>(c);
  else
    flash_attention_combine_kernel<bf16><<<grid, 128, 0, s>>>(c);
  return static_cast<int>(cudaGetLastError());
}

// The backward of the training case (q_offset 0, every key valid): first
// the dQ kernel, which also writes D = rowsum(dO o O) [B, H, Sq] f32, then
// the dK/dV kernel, which reads it.  q, k, v, o, dout, dq, dk, dv
// contiguous, 16-byte aligned, of dtype `dtype`; lse [B, H, Sq] f32 from
// the forward.
// the f32 CUDA-core kernels (dtype 0 only)
int flash_attention_bwd_dq_launch(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const float* lse,
                                  float* D, void* dq, int B, int Sq, int Skv,
                                  int H, int Hkv, int hd, int dtype,
                                  int causal, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_launch(q, k, v, o, dout, lse, D, dq, nullptr, nullptr, B, Sq,
                    Skv, H, Hkv, hd, dtype, causal, true, stream);
}

int flash_attention_bwd_dkdv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* D,
                                    void* dk, void* dv, int B, int Sq,
                                    int Skv, int H, int Hkv, int hd,
                                    int dtype, int causal, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_launch(q, k, v, nullptr, dout, lse, const_cast<float*>(D),
                    nullptr, dk, dv, B, Sq, Skv, H, Hkv, hd, dtype, causal,
                    false, stream);
}

// the bf16 tensor-core (wgmma) kernels (dtype 1 only)
int flash_attention_bwd_dq_wgmma_launch(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const float* lse,
                                        float* D, void* dq, int B, int Sq,
                                        int Skv, int H, int Hkv, int hd,
                                        int dtype, int causal, void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_launch(q, k, v, o, dout, lse, D, dq, nullptr, nullptr, B, Sq,
                    Skv, H, Hkv, hd, dtype, causal, true, stream);
}

int flash_attention_bwd_dkdv_wgmma_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse, const float* D,
                                          void* dk, void* dv, int B, int Sq,
                                          int Skv, int H, int Hkv, int hd,
                                          int dtype, int causal,
                                          void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_launch(q, k, v, nullptr, dout, lse, const_cast<float*>(D),
                    nullptr, dk, dv, B, Sq, Skv, H, Hkv, hd, dtype, causal,
                    false, stream);
}

}  // extern "C"
