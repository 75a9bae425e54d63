// Device helpers shared by the fabric's block kernels (dataflow_fire.cu,
// multifabric.cu): the fire rule of a group of nodes, the staging of feed
// windows, and the slot-group idiom of the warp kernels.
#pragma once

#include <cstdint>

#include "alu.cuh"
#include "cp_async.cuh"

// The fire rule of G nodes (a group of slots of one lane), each with its
// opcode op[g], on the (full, val) pairs of its three input arcs x0..x2
// and the full bits of its two output arcs, without a divergent branch
// (selects; `ops`, the opcodes the warp may meet, is uniform over it:
// alu_select).  Sets each node's cp word: consume bits 0..2 (one per input
// slot) and produce bits 3..4 (one per output slot) if it fires, 0 if not;
// z, its ALU result (the merges pick an input); and ir, whether its
// (selected) inputs are present (the profile's stall attribution).
// kControlFree compiles the rule of NDMERGE, DMERGE and BRANCH out.
template <bool kControlFree, int G>
__device__ __forceinline__ void fire_rule(const int (&op)[G],
                                          const int2 (&x0)[G],
                                          const int2 (&x1)[G],
                                          const int2 (&x2)[G],
                                          const int (&full_o0)[G],
                                          const int (&full_o1)[G],
                                          unsigned ops, int (&z)[G],
                                          int (&cp)[G], int (&ir)[G]) {
  int a[G], bv[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    a[g] = x0[g].y;
    bv[g] = x1[g].y;
  }
  alu_select(op, a, bv, z, ops);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool all_in = (x0[g].x > 0) & (x1[g].x > 0) & (x2[g].x > 0);
    ir[g] = all_in;
    cp[g] = all_in & (full_o0[g] == 0) & (full_o1[g] == 0) ? 31 : 0;
  }                                      // 31: consume all, produce both
  if (kControlFree || !(ops & kOpControl)) return;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool in0 = x0[g].x > 0, in1 = x1[g].x > 0, in2 = x2[g].x > 0;
    const bool oe0 = full_o0[g] == 0, oe1 = full_o1[g] == 0;
    const bool all_in = in0 & in1 & in2, all_out = oe0 & oe1;
    const bool nd = op[g] == OP_NDMERGE, dm = op[g] == OP_DMERGE;
    const bool br = op[g] == OP_BRANCH, c3 = x2[g].y != 0;
    const bool c2 = bv[g] != 0;
    // BRANCH takes all inputs (in2 is the always-full pad) and needs only
    // its chosen output empty
    const bool r_in = nd ? in0 | in1 : dm ? in2 & (c3 ? in0 : in1) : all_in;
    const bool ready = br ? in0 & in1 & (c2 ? oe0 : oe1) : r_in & all_out;
    const int cons = nd ? (in0 ? 1 : 2) : dm ? (c3 ? 5 : 6) : 7;
    const int prod = br ? (c2 ? 1 : 2) : 3;
    ir[g] = r_in;
    z[g] = nd ? (in0 ? a[g] : bv[g]) : dm ? (c3 ? a[g] : bv[g]) : z[g];
    cp[g] = ready ? cons | prod << 3 : 0;
  }
}

__device__ __forceinline__ int clamp_index(long long p, int L) {
  return static_cast<int>(p < 0 ? 0 : (p > L - 1 ? L - 1 : p));
}

// Stages the tokens a feed row can read in the next `chunk` cycles,
// fv[row][clamp(p) .. clamp(min(p + chunk, fl) - 1)], into dst: 16-byte
// pieces aligned on the device address (fv_al is the tokens rounded down
// to 16 bytes and `row` the row's first int counted from there; a piece
// never straddles a page, so the few ints read around a row are mapped).
// Returns false, staging nothing, when the row feeds nothing in the
// chunk; else sets *offset, which maps a clamped feed index to its
// token's slot: token = dst[*offset + clamp(ptr)].
__device__ __forceinline__ bool stage_window(const int* fv_al, long long row,
                                             int p, int fl, int chunk, int L,
                                             int* dst, int* offset) {
  const long long hi = min(static_cast<long long>(p) + chunk,
                           static_cast<long long>(fl));
  if (hi <= p) return false;
  const int a = clamp_index(p, L), e = clamp_index(hi - 1, L);
  const long long start = (row + a) & ~3LL;
  const int pieces = static_cast<int>((row + e - start) >> 2) + 1;
  for (int k = 0; k < pieces; ++k)
    cp_async16(dst + 4 * k, fv_al + start + 4 * k);
  *offset = static_cast<int>(row + a - start) - a;
  return true;
}

// A count of slots as a type, for the groups of a warp kernel's phases.
template <int N>
struct Slots {
  static constexpr int value = N;
};

__device__ __forceinline__ int2 lds2(const unsigned char* smem, int off) {
  return *reinterpret_cast<const int2*>(smem + off);
}
