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
