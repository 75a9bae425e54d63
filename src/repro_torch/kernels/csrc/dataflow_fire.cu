// Fire-block kernel for Hopper (sm_90a): K fused feed -> fire -> drain
// cycles of a static dataflow fabric per launch, one CTA per stream.
//
// Replaces the TPU kernels of src/repro/kernels/dataflow_fire.py:
//   fire_block_pallas         -> _block_kernel          (:390)
//   fire_block_batched_pallas -> _batched_block_kernel  (:405)
// One kernel computes both: grid = (B,), and the single-stream entry
// launches it with B = 1 and every stream active (active == nullptr).
// The plain PyTorch version of the same function is fire_block /
// fire_block_batched in ../dataflow_fire.py; results are bit-identical.
//
// What bounds it on this card.  Neither bytes nor operations: one launch
// moves a few KB per stream (state in and out, tables, the feed tokens it
// consumes) and evaluates each node once per cycle, microseconds of work
// for the whole card even at B = 1024.  What bounds it is latency: the K
// cycles are a serial chain (each cycle's node phase reads what the
// previous cycle's arc phase wrote), and each cycle is four phases
// separated by CTA barriers, so one stream costs about
// K x (4 barriers + shared-memory round trips) however small its fabric.
//
// What the design does about it:
//   * everything a cycle touches stays on chip for the whole block: the
//     arc registers full/val[A2], the feed pointers and the output
//     accumulators live in shared memory, read once from device memory at
//     the start of the block and written once at the end;
//   * the tables are read through the read-only data cache (__ldg), where
//     they stay for the block after the first cycle;
//   * one CTA per stream, so B streams run side by side on the 132 SMs
//     and hide each other's barrier latency (a small fabric's CTA is a few
//     warps, and many fit on one SM);
//   * the per-stream active gate copies a parked stream's state through
//     with the whole CTA, so no barrier ever diverges.
//
// Integer semantics follow jnp/numpy int32 exactly: ADD/SUB/MUL/SHL wrap
// (computed in uint32), DIV is floor division with x // 0 == 0 and
// INT_MIN // -1 == INT_MIN, shift counts are clipped to 0..31, SHR is
// arithmetic, comparisons and NOT give 0 or 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ../_build.py); plain C interface for ctypes.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

// Opcodes: src/repro_torch/core/graph.py Op (values are stable).
enum : int {
  OP_COPY = 0, OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_DIV = 4, OP_AND = 5,
  OP_OR = 6, OP_XOR = 7, OP_MAX = 8, OP_MIN = 9, OP_SHL = 10, OP_SHR = 11,
  OP_NOT = 12, OP_IFGT = 13, OP_IFGE = 14, OP_IFLT = 15, OP_IFLE = 16,
  OP_IFEQ = 17, OP_IFDF = 18, OP_DMERGE = 19, OP_NDMERGE = 20,
  OP_BRANCH = 21, OP_SINK = 22
};

struct Tables {
  const int* opcode;      // [N2]
  const int* in_idx;      // [N2, 3]
  const int* out_idx;     // [N2, 2]
  const int* prod_node;   // [A2]
  const int* prod_slot;   // [A2]
  const int* cons_node;   // [A2]
  const int* cons_slot;   // [A2]
  const int* const_mask;  // [A2]
  const int* env_row;     // [A2]
  const int* in_arc_idx;  // [n_in]
  const int* out_arc_idx; // [n_out]
  const int* out_mask;    // [A2]
};

struct State {
  const int* feed_vals;   // [B, n_in, L]
  const int* feed_len;    // [B, n_in]
  const int* full;        // [B, A2]
  const int* val;         // [B, A2]
  const int* ptr;         // [B, n_in]
  const int* out_last;    // [B, n_out]
  const int* out_count;   // [B, n_out]
  const int* active;      // [B] or nullptr (all active)
  int* full_o;
  int* val_o;
  int* ptr_o;
  int* out_last_o;
  int* out_count_o;
  int* fired_o;           // [B]
  int* last_prog_o;       // [B]
};

__device__ __forceinline__ int floor_div(int a, int b) {
  if (b == 0) return 0;
  if (a == INT_MIN && b == -1) return INT_MIN;   // wraps, as in jnp
  int q = a / b;                                 // C truncates ...
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;  // ... floor instead
  return q;
}

// The dense rule's ALU result z: `a` unless the opcode selects another.
__device__ __forceinline__ int alu(int op, int a, int b, int c, bool in0) {
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
    case OP_NDMERGE: return in0 ? a : b;
    case OP_DMERGE: return c != 0 ? a : b;
    default: return a;                           // COPY, BRANCH, SINK
  }
}

// Shared memory: full[A2] val[A2] z[N2] cp[N2] ptr[n_in] out_last[n_out]
// out_count[n_out].  cp packs a fired node's consume bits (0..2, one per
// input slot) and produce bits (3..4, one per output slot); 0 if not ready.
__global__ void fire_block_kernel(Tables t, State s, int N2, int A2,
                                  int n_in, int n_out, int L,
                                  int n_cycles) {
  extern __shared__ int smem[];
  __shared__ int s_cycle_fired;
  int* s_full = smem;
  int* s_val = s_full + A2;
  int* s_z = s_val + A2;
  int* s_cp = s_z + N2;
  int* s_ptr = s_cp + N2;
  int* s_out_last = s_ptr + n_in;
  int* s_out_count = s_out_last + n_out;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int* full = s.full + static_cast<size_t>(b) * A2;
  const int* val = s.val + static_cast<size_t>(b) * A2;
  const int* ptr = s.ptr + static_cast<size_t>(b) * n_in;
  const int* out_last = s.out_last + static_cast<size_t>(b) * n_out;
  const int* out_count = s.out_count + static_cast<size_t>(b) * n_out;
  int* full_o = s.full_o + static_cast<size_t>(b) * A2;
  int* val_o = s.val_o + static_cast<size_t>(b) * A2;
  int* ptr_o = s.ptr_o + static_cast<size_t>(b) * n_in;
  int* out_last_o = s.out_last_o + static_cast<size_t>(b) * n_out;
  int* out_count_o = s.out_count_o + static_cast<size_t>(b) * n_out;

  if (s.active != nullptr && s.active[b] == 0) {
    // parked stream: the whole CTA copies the state through
    for (int i = tid; i < A2; i += nt) {
      full_o[i] = full[i];
      val_o[i] = val[i];
    }
    for (int i = tid; i < n_in; i += nt) ptr_o[i] = ptr[i];
    for (int i = tid; i < n_out; i += nt) {
      out_last_o[i] = out_last[i];
      out_count_o[i] = out_count[i];
    }
    if (tid == 0) {
      s.fired_o[b] = 0;
      s.last_prog_o[b] = 0;
    }
    return;
  }

  const int* fv = s.feed_vals + static_cast<size_t>(b) * n_in * L;
  const int* fl = s.feed_len + static_cast<size_t>(b) * n_in;
  for (int i = tid; i < A2; i += nt) {
    s_full[i] = full[i];
    s_val[i] = val[i];
  }
  for (int i = tid; i < n_in; i += nt) s_ptr[i] = ptr[i];
  for (int i = tid; i < n_out; i += nt) {
    s_out_last[i] = out_last[i];
    s_out_count[i] = out_count[i];
  }
  __syncthreads();

  int fired = 0;       // uniform across the CTA
  int last_prog = 0;   // uniform across the CTA
  for (int cyc = 0; cyc < n_cycles; ++cyc) {
    bool prog = false;
    // 1. feed: strobe each empty input arc from its stream
    for (int r = tid; r < n_in; r += nt) {
      const int arc = __ldg(t.in_arc_idx + r);
      const int p = s_ptr[r];
      if (s_full[arc] == 0 && p < fl[r]) {
        if (__ldg(t.env_row + arc) == r) {   // pad rows write no arc
          s_val[arc] = fv[static_cast<size_t>(r) * L + min(max(p, 0), L - 1)];
          s_full[arc] = 1;
        }
        s_ptr[r] = p + 1;
        prog = true;
      }
    }
    if (tid == 0) s_cycle_fired = 0;   // last read before the previous
                                       // cycle's closing barrier
    __syncthreads();

    // 2. node phase: the dense rule on the post-feed registers
    int nfire = 0;
    for (int n = tid; n < N2; n += nt) {
      const int op = __ldg(t.opcode + n);
      const int i0 = __ldg(t.in_idx + 3 * n);
      const int i1 = __ldg(t.in_idx + 3 * n + 1);
      const int i2 = __ldg(t.in_idx + 3 * n + 2);
      const int o0 = __ldg(t.out_idx + 2 * n);
      const int o1 = __ldg(t.out_idx + 2 * n + 1);
      const bool in0 = s_full[i0] > 0, in1 = s_full[i1] > 0;
      const bool in2 = s_full[i2] > 0;
      const bool oe0 = s_full[o0] == 0, oe1 = s_full[o1] == 0;
      const int a = s_val[i0], bv = s_val[i1], c = s_val[i2];
      const bool all_out = oe0 && oe1;
      bool ready;
      unsigned cons, prod;
      switch (op) {
        case OP_NDMERGE:
          ready = (in0 || in1) && all_out;
          cons = in0 ? 1u : 2u;
          prod = 3u;
          break;
        case OP_DMERGE:
          ready = in2 && (c != 0 ? in0 : in1) && all_out;
          cons = (c != 0 ? 1u : 2u) | 4u;
          prod = 3u;
          break;
        case OP_BRANCH:
          ready = in0 && in1 && (bv != 0 ? oe0 : oe1);
          cons = 7u;
          prod = bv != 0 ? 1u : 2u;
          break;
        default:
          ready = in0 && in1 && in2 && all_out;
          cons = 7u;
          prod = 3u;
      }
      s_z[n] = alu(op, a, bv, c, in0);
      s_cp[n] = ready ? static_cast<int>(cons | (prod << 3)) : 0;
      nfire += ready;
    }
    nfire = __reduce_add_sync(0xffffffffu, nfire);
    if (lane == 0 && nfire) atomicAdd(&s_cycle_fired, nfire);
    __syncthreads();

    // 3. arc phase, gather only: each arc pulls from its producer/consumer
    for (int i = tid; i < A2; i += nt) {
      const int pn = __ldg(t.prod_node + i), ps = __ldg(t.prod_slot + i);
      const int cn = __ldg(t.cons_node + i), cs = __ldg(t.cons_slot + i);
      const bool produced = (s_cp[pn] >> (3 + ps)) & 1;
      const bool consumed = (s_cp[cn] >> cs) & 1;
      const bool f = (s_full[i] > 0 && !consumed) || produced ||
                     __ldg(t.const_mask + i) > 0;
      if (produced) s_val[i] = s_z[pn];
      s_full[i] = f;
    }
    __syncthreads();

    // 4. drain the output buses into the accumulators
    for (int r = tid; r < n_out; r += nt) {
      const int arc = __ldg(t.out_arc_idx + r);
      if (s_full[arc] > 0) {
        s_out_last[r] = s_val[arc];
        s_out_count[r] += 1;
        prog = true;
      }
      if (__ldg(t.out_mask + arc) > 0) s_full[arc] = 0;
    }
    const int cycle_fired = s_cycle_fired;   // read before the barrier
    fired += cycle_fired;
    if (__syncthreads_or(prog || cycle_fired > 0)) last_prog = cyc + 1;
  }

  for (int i = tid; i < A2; i += nt) {
    full_o[i] = s_full[i];
    val_o[i] = s_val[i];
  }
  for (int i = tid; i < n_in; i += nt) ptr_o[i] = s_ptr[i];
  for (int i = tid; i < n_out; i += nt) {
    out_last_o[i] = s_out_last[i];
    out_count_o[i] = s_out_count[i];
  }
  if (tid == 0) {
    s.fired_o[b] = fired;
    s.last_prog_o[b] = last_prog;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
int fire_block_launch(
    const int* opcode, const int* in_idx, const int* out_idx,
    const int* prod_node, const int* prod_slot, const int* cons_node,
    const int* cons_slot, const int* const_mask, const int* env_row,
    const int* in_arc_idx, const int* out_arc_idx, const int* out_mask,
    const int* feed_vals, const int* feed_len, const int* full,
    const int* val, const int* ptr, const int* out_last,
    const int* out_count, const int* active, int* full_o, int* val_o,
    int* ptr_o, int* out_last_o, int* out_count_o, int* fired_o,
    int* last_prog_o, int B, int N2, int A2, int n_in, int n_out, int L,
    int n_cycles, void* stream) {
  Tables t{opcode, in_idx, out_idx, prod_node, prod_slot, cons_node,
           cons_slot, const_mask, env_row, in_arc_idx, out_arc_idx,
           out_mask};
  State s{feed_vals, feed_len, full, val, ptr, out_last, out_count, active,
          full_o, val_o, ptr_o, out_last_o, out_count_o, fired_o,
          last_prog_o};
  int threads = std::max(std::max(N2, A2), std::max(n_in, n_out));
  threads = std::min(1024, (threads + 31) / 32 * 32);
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(A2) + 2 * N2 +
                                     n_in + 2 * n_out);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fire_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fire_block_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      t, s, N2, A2, n_in, n_out, L, n_cycles);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory one block may opt in to on `device`, in bytes.
int fire_block_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

const char* fire_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
