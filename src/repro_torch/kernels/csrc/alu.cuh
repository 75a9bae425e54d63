// The int32 ALU of the dataflow fabric, shared by every kernel of this
// directory (dataflow_fire.cu, schedule_fire.cu), so one set of C integer
// rules serves them all.
//
// Integer semantics follow jnp/numpy int32 exactly: ADD/SUB/MUL/SHL wrap
// (computed in uint32), DIV is floor division with x // 0 == 0 and
// INT_MIN // -1 == INT_MIN, shift counts are clipped to 0..31, SHR is
// arithmetic, comparisons give 0 or 1 and NOT is a == 0.  The plain
// PyTorch version is _alu_op in ../dataflow_fire.py.
#pragma once

#include <climits>

// Opcodes: src/repro_torch/core/graph.py Op (values are stable).
enum : int {
  OP_COPY = 0, OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_DIV = 4, OP_AND = 5,
  OP_OR = 6, OP_XOR = 7, OP_MAX = 8, OP_MIN = 9, OP_SHL = 10, OP_SHR = 11,
  OP_NOT = 12, OP_IFGT = 13, OP_IFGE = 14, OP_IFLT = 15, OP_IFLE = 16,
  OP_IFEQ = 17, OP_IFDF = 18, OP_DMERGE = 19, OP_NDMERGE = 20,
  OP_BRANCH = 21, OP_SINK = 22
};

__device__ __forceinline__ int floor_div(int a, int b) {
  if (b == 0) return 0;
  if (a == INT_MIN && b == -1) return INT_MIN;   // wraps, as in jnp
  int q = a / b;                                 // C truncates ...
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;  // ... floor instead
  return q;
}

// The result of a data opcode on operands a, b: `a` for COPY, BRANCH,
// SINK (and for the merges, whose result picks an input: see alu() in
// dataflow_fire.cu).
__device__ __forceinline__ int alu_int(int op, int a, int b) {
  const unsigned ua = static_cast<unsigned>(a);
  const unsigned ub = static_cast<unsigned>(b);
  const int bs = min(max(b, 0), 31);
  switch (op) {
    case OP_ADD: return static_cast<int>(ua + ub);
    case OP_SUB: return static_cast<int>(ua - ub);
    case OP_MUL: return static_cast<int>(ua * ub);
    case OP_DIV: return floor_div(a, b);
    case OP_AND: return a & b;
    case OP_OR: return a | b;
    case OP_XOR: return a ^ b;
    case OP_MAX: return max(a, b);
    case OP_MIN: return min(a, b);
    case OP_SHL: return static_cast<int>(ua << bs);
    case OP_SHR: return a >> bs;                 // arithmetic
    case OP_NOT: return a == 0;
    case OP_IFGT: return a > b;
    case OP_IFGE: return a >= b;
    case OP_IFLT: return a < b;
    case OP_IFLE: return a <= b;
    case OP_IFEQ: return a == b;
    case OP_IFDF: return a != b;
    default: return a;                           // COPY, BRANCH, SINK
  }
}

// Opcode groups of alu_select (bit op of a mask stands for opcode op).
constexpr unsigned kOpArith = 1u << OP_ADD | 1u << OP_SUB | 1u << OP_MUL;
constexpr unsigned kOpLogic = 1u << OP_AND | 1u << OP_OR | 1u << OP_XOR;
constexpr unsigned kOpMinMax = 1u << OP_MAX | 1u << OP_MIN;
constexpr unsigned kOpShift = 1u << OP_SHL | 1u << OP_SHR;
constexpr unsigned kOpCompare = 1u << OP_NOT | 1u << OP_IFGT |
                                1u << OP_IFGE | 1u << OP_IFLT |
                                1u << OP_IFLE | 1u << OP_IFEQ | 1u << OP_IFDF;
constexpr unsigned kOpDiv = 1u << OP_DIV;
constexpr unsigned kOpControl = 1u << OP_NDMERGE | 1u << OP_DMERGE |
                                1u << OP_BRANCH;
constexpr unsigned kOpAll = (1u << (OP_SINK + 1)) - 1;

// alu_int's results for G nodes at once (a group of slots of one lane)
// without a divergent branch, for loops where one warp evaluates nodes of
// several opcodes: each opcode group's results are computed and each
// node's selected, so the warp runs one instruction stream (a switch
// compiles to a tree of divergent branches).  `ops`, the opcodes the warp
// may meet, is uniform over it; a group none of whose opcodes is in `ops`
// is skipped, once for all G nodes.
template <int G>
__device__ __forceinline__ void alu_select(const int (&op)[G],
                                           const int (&a)[G],
                                           const int (&b)[G], int (&z)[G],
                                           unsigned ops) {
#pragma unroll
  for (int g = 0; g < G; ++g) z[g] = a[g];      // COPY, BRANCH, SINK
  // one jump when a single group computes (the common fabrics)
  const unsigned computed = ops & ~(1u << OP_COPY | 1u << OP_BRANCH |
                                    1u << OP_SINK | kOpControl);
  if ((computed & ~kOpArith) == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const unsigned ua = static_cast<unsigned>(a[g]);
      const unsigned ub = static_cast<unsigned>(b[g]);
      z[g] = op[g] == OP_ADD ? static_cast<int>(ua + ub) : z[g];
      z[g] = op[g] == OP_SUB ? static_cast<int>(ua - ub) : z[g];
      z[g] = op[g] == OP_MUL ? static_cast<int>(ua * ub) : z[g];
    }
    return;
  }
  if ((computed & ~kOpMinMax) == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      z[g] = op[g] == OP_MAX ? max(a[g], b[g]) : z[g];
      z[g] = op[g] == OP_MIN ? min(a[g], b[g]) : z[g];
    }
    return;
  }
  if (ops & kOpArith) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const unsigned ua = static_cast<unsigned>(a[g]);
      const unsigned ub = static_cast<unsigned>(b[g]);
      z[g] = op[g] == OP_ADD ? static_cast<int>(ua + ub) : z[g];
      z[g] = op[g] == OP_SUB ? static_cast<int>(ua - ub) : z[g];
      z[g] = op[g] == OP_MUL ? static_cast<int>(ua * ub) : z[g];
    }
  }
  if (ops & kOpLogic) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      z[g] = op[g] == OP_AND ? (a[g] & b[g]) : z[g];
      z[g] = op[g] == OP_OR ? (a[g] | b[g]) : z[g];
      z[g] = op[g] == OP_XOR ? (a[g] ^ b[g]) : z[g];
    }
  }
  if (ops & kOpMinMax) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      z[g] = op[g] == OP_MAX ? max(a[g], b[g]) : z[g];
      z[g] = op[g] == OP_MIN ? min(a[g], b[g]) : z[g];
    }
  }
  if (ops & kOpShift) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int bs = min(max(b[g], 0), 31);
      z[g] = op[g] == OP_SHL
                 ? static_cast<int>(static_cast<unsigned>(a[g]) << bs)
                 : z[g];
      z[g] = op[g] == OP_SHR ? (a[g] >> bs) : z[g];   // arithmetic
    }
  }
  if (ops & kOpCompare) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int x = a[g], y = b[g];
      z[g] = op[g] == OP_NOT ? (x == 0) : z[g];
      z[g] = op[g] == OP_IFGT ? (x > y) : z[g];
      z[g] = op[g] == OP_IFGE ? (x >= y) : z[g];
      z[g] = op[g] == OP_IFLT ? (x < y) : z[g];
      z[g] = op[g] == OP_IFLE ? (x <= y) : z[g];
      z[g] = op[g] == OP_IFEQ ? (x == y) : z[g];
      z[g] = op[g] == OP_IFDF ? (x != y) : z[g];
    }
  }
  if (ops & kOpDiv) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // floor division; x // 0 == 0 and INT_MIN // -1 == INT_MIN
      // (divided by 1 instead)
      const int x = a[g], y = b[g];
      const int d = (y == 0 || (x == INT_MIN && y == -1)) ? 1 : y;
      int q = x / d;
      q -= (x - q * d != 0) && ((x < 0) != (d < 0));
      z[g] = op[g] == OP_DIV ? (y == 0 ? 0 : q) : z[g];
    }
  }
}
