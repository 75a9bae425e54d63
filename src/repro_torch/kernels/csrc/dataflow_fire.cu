// Fire-block and fire-step kernels for Hopper (sm_90a): a static dataflow
// fabric, K fused feed -> fire -> drain cycles per launch (one CTA per
// stream), or one bare fire step (one CTA).
//
// Replaces the TPU kernels of src/repro/kernels/dataflow_fire.py:
//   fire_block_pallas              -> _block_kernel                (:390)
//   fire_block_pallas(prof=)       -> _block_kernel_prof           (:428)
//   fire_block_batched_pallas      -> _batched_block_kernel        (:405)
//   fire_block_batched_pallas(prof=) -> _batched_block_kernel_prof (:448)
//   _ready_and_z_spec (:117), traced into the four above when the tables
//                                carry class_slices  -> kSpec instantiations
//   fire_step_pallas               -> _kernel (:196)  -> fire_step_kernel
// One template computes the four block kernels and the specialized rule:
// grid = (B,); the single-stream entry launches it with B = 1 and every
// stream active (active == nullptr); kProf adds the five counters; kSpec
// takes each node's opcode from its bucket of an opcode-sorted plan, and
// kControlFree (no NDMERGE/DMERGE/BRANCH bucket) compiles the control
// cases out.  The plain PyTorch versions of the same functions are
// fire_block / fire_block_batched / fire_step in ../dataflow_fire.py;
// results are bit-identical.
//
// What bounds them on this card.  Neither bytes nor operations: one block
// launch moves a few KB per stream (state and counters in and out, tables,
// the feed tokens it consumes) and evaluates each node once per cycle,
// microseconds of work for the whole card even at B = 1024.  What bounds a
// block is latency: the K cycles are a serial chain (each cycle's node
// phase reads what the previous cycle's arc phase wrote), and each cycle
// is four phases separated by CTA barriers, so one stream costs about
// K x (4 barriers + shared-memory round trips) however small its fabric.
// The fire step is bound by the launch and the host's sync around it: one
// launch per fabric cycle, a few microseconds of fixed cost each.
//
// What the design does about it:
//   * everything a cycle touches stays on chip for the whole block: the
//     arc registers full/val[A2], the feed pointers, the output
//     accumulators and the counters live in shared memory, read once from
//     device memory at the start of the block and written once at the end;
//   * the counters add no barrier: a node's three counters are updated by
//     the thread that evaluates it in the node phase, from an
//     inputs-ready bit on the same post-feed snapshot as its fire rule; an
//     arc's busy and high-water counters by the thread that writes its
//     full bit in the arc phase, which is after the fire and before the
//     drain (the sample point) by construction;
//   * the specialized rule changes no phase: a node's opcode comes from
//     its bucket (a register per thread, set once per launch), so in an
//     opcode-sorted table a warp inside a bucket takes one branch, and a
//     control-free fabric evaluates ready = all inputs full & all outputs
//     empty with no switch; the same .so serves every fabric;
//   * the tables are read through the read-only data cache (__ldg), where
//     they stay for the block after the first cycle;
//   * one CTA per stream, so B streams run side by side on the 132 SMs
//     and hide each other's barrier latency (a small fabric's CTA is a few
//     warps, and many fit on one SM);
//   * the per-stream active gate copies a parked stream's state (and its
//     counters) through with the whole CTA, so no barrier ever diverges.
//
// Integer semantics follow jnp/numpy int32 exactly (the shared ALU of
// alu.cuh).
//
// Build: ../_build.py compiles every .cu of this directory for sm_90a and
// links them into one shared library; plain C interface for ctypes.

#include <algorithm>
#include <cuda_runtime.h>

#include "alu.cuh"

namespace {

// One bucket per opcode plus the trailing bucket of the dummy node row
// (dataflow_fire.MAX_CLASSES); device_tables() checks the class table.
constexpr int kMaxClasses = 24;
constexpr int kProfArrays = 5;   // nf, si, so [N2]; ab, ahw [A2]

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
  const int* class_table; // [n_classes, 3] (op, lo, hi) or nullptr
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
  const int* prof[kProfArrays];   // counters in (kProf only)
  int* full_o;
  int* val_o;
  int* ptr_o;
  int* out_last_o;
  int* out_count_o;
  int* fired_o;           // [B]
  int* last_prog_o;       // [B]
  int* prof_o[kProfArrays];       // counters out (kProf only)
};

// The dense rule's ALU result z: the merges pick an input, every other
// opcode is the shared ALU's.
__device__ __forceinline__ int alu(int op, int a, int b, int c, bool in0) {
  switch (op) {
    case OP_NDMERGE: return in0 ? a : b;
    case OP_DMERGE: return c != 0 ? a : b;
    default: return alu_int(op, a, b);
  }
}

// Shared memory, in ints: full[A2] val[A2] z[N2] cp[N2] ptr[n_in]
// out_last[n_out] out_count[n_out], then with counters nf[N2] si[N2]
// so[N2] ab[A2] ahw[A2].  cp packs a fired node's consume bits (0..2, one
// per input slot) and produce bits (3..4, one per output slot); 0 if not
// ready.  The fire step uses the first four arrays.
size_t dynamic_smem_bytes(int N2, int A2, int n_in, int n_out, bool prof) {
  size_t ints = 2 * static_cast<size_t>(A2) + 2 * static_cast<size_t>(N2) +
                n_in + 2 * static_cast<size_t>(n_out);
  if (prof) ints += 3 * static_cast<size_t>(N2) + 2 * static_cast<size_t>(A2);
  return sizeof(int) * ints;
}
// the block kernel's static arrays: the cycle's firing count and the
// class table
constexpr size_t kStaticSmemBytes = sizeof(int) * (1 + 3 * kMaxClasses);

struct NodeCounters {
  int* nf;
  int* si;
  int* so;
};

// Node phase for row n with opcode op, on the post-feed registers: writes
// z and cp, counts (kProf) fired / stalled on input / stalled on output,
// and returns whether the node fires.
template <bool kProf, bool kControlFree>
__device__ __forceinline__ int fire_node(const Tables& t, int n, int op,
                                         const int* s_full, const int* s_val,
                                         int* s_z, int* s_cp,
                                         NodeCounters nc) {
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
  bool ready, ir;                  // ir: the (selected) inputs are present
  unsigned cons = 7u, prod = 3u;
  if (kControlFree) {
    ir = in0 && in1 && in2;
    ready = ir && all_out;
  } else {
    switch (op) {
      case OP_NDMERGE:
        ir = in0 || in1;
        ready = ir && all_out;
        cons = in0 ? 1u : 2u;
        break;
      case OP_DMERGE:
        ir = in2 && (c != 0 ? in0 : in1);
        ready = ir && all_out;
        cons = (c != 0 ? 1u : 2u) | 4u;
        break;
      case OP_BRANCH:
        ir = in0 && in1 && in2;      // in2 is the always-full pad
        ready = in0 && in1 && (bv != 0 ? oe0 : oe1);
        prod = bv != 0 ? 1u : 2u;
        break;
      default:
        ir = in0 && in1 && in2;
        ready = ir && all_out;
    }
  }
  s_z[n] = alu(op, a, bv, c, in0);
  s_cp[n] = ready ? static_cast<int>(cons | (prod << 3)) : 0;
  if (kProf) {
    nc.nf[n] += ready;
    nc.si[n] += !ir;
    nc.so[n] += ir && !ready;
  }
  return ready;
}

// Next full bit of arc i (gather only: it pulls from its producer and
// consumer); *from is the producer row when the arc was produced this
// cycle, -1 otherwise.
__device__ __forceinline__ bool arc_next(const Tables& t, int i,
                                         const int* s_full, const int* s_cp,
                                         int* from) {
  const int pn = __ldg(t.prod_node + i), ps = __ldg(t.prod_slot + i);
  const int cn = __ldg(t.cons_node + i), cs = __ldg(t.cons_slot + i);
  const bool produced = (s_cp[pn] >> (3 + ps)) & 1;
  const bool consumed = (s_cp[cn] >> cs) & 1;
  *from = produced ? pn : -1;
  return (s_full[i] > 0 && !consumed) || produced ||
         __ldg(t.const_mask + i) > 0;
}

// The opcode of row n from the class table (rows are bucketed in order).
__device__ __forceinline__ int bucket_op(const int* s_cls, int n_classes,
                                         int n) {
  for (int k = 0; k < n_classes; ++k)
    if (n < s_cls[3 * k + 2]) return s_cls[3 * k];
  return OP_SINK;
}

__device__ __forceinline__ int prof_len(int k, int N2, int A2) {
  return k < 3 ? N2 : A2;
}

template <bool kProf, bool kSpec, bool kControlFree>
__global__ void fire_block_kernel(Tables t, State s, int N2, int A2,
                                  int n_in, int n_out, int L, int n_cycles,
                                  int n_classes) {
  extern __shared__ int smem[];
  __shared__ int s_cycle_fired;
  __shared__ int s_cls[3 * kMaxClasses];
  int* s_full = smem;
  int* s_val = s_full + A2;
  int* s_z = s_val + A2;
  int* s_cp = s_z + N2;
  int* s_ptr = s_cp + N2;
  int* s_out_last = s_ptr + n_in;
  int* s_out_count = s_out_last + n_out;
  int* s_prof[kProfArrays];       // nf si so ab ahw (kProf only)
  s_prof[0] = s_out_count + n_out;
  for (int k = 1; k < kProfArrays; ++k)
    s_prof[k] = s_prof[k - 1] + prof_len(k - 1, N2, A2);
  const NodeCounters nc{s_prof[0], s_prof[1], s_prof[2]};

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
    if (kProf) {
      for (int k = 0; k < kProfArrays; ++k) {
        const int n = prof_len(k, N2, A2);
        const size_t off = static_cast<size_t>(b) * n;
        for (int i = tid; i < n; i += nt) s.prof_o[k][off + i] = s.prof[k][off + i];
      }
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
  if (kProf) {
    for (int k = 0; k < kProfArrays; ++k) {
      const int n = prof_len(k, N2, A2);
      const size_t off = static_cast<size_t>(b) * n;
      for (int i = tid; i < n; i += nt) s_prof[k][i] = s.prof[k][off + i];
    }
  }
  if (kSpec)
    for (int i = tid; i < 3 * n_classes; i += nt) s_cls[i] = t.class_table[i];
  __syncthreads();
  // the specialized rule: this thread's first row takes its bucket's
  // opcode once per launch (rows past the first — only when N2 exceeds the
  // CTA — look theirs up per cycle)
  const int my_op = kSpec ? bucket_op(s_cls, n_classes, tid) : 0;

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

    // 2. node phase: the fire rule on the post-feed registers
    int nfire = 0;
    for (int n = tid; n < N2; n += nt) {
      const int op = !kSpec ? __ldg(t.opcode + n)
                   : n == tid ? my_op : bucket_op(s_cls, n_classes, n);
      nfire += fire_node<kProf, kControlFree>(t, n, op, s_full, s_val, s_z,
                                              s_cp, nc);
    }
    nfire = __reduce_add_sync(0xffffffffu, nfire);
    if (lane == 0 && nfire) atomicAdd(&s_cycle_fired, nfire);
    __syncthreads();

    // 3. arc phase, gather only; the occupancy sample (post-fire,
    //    pre-drain) is the full bit written here
    for (int i = tid; i < A2; i += nt) {
      int from;
      const bool f = arc_next(t, i, s_full, s_cp, &from);
      if (from >= 0) s_val[i] = s_z[from];
      s_full[i] = f;
      if (kProf) {
        s_prof[3][i] += f;
        s_prof[4][i] = max(s_prof[4][i], static_cast<int>(f));
      }
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
  if (kProf) {
    for (int k = 0; k < kProfArrays; ++k) {
      const int n = prof_len(k, N2, A2);
      const size_t off = static_cast<size_t>(b) * n;
      for (int i = tid; i < n; i += nt) s.prof_o[k][off + i] = s_prof[k][i];
    }
  }
  if (tid == 0) {
    s.fired_o[b] = fired;
    s.last_prog_o[b] = last_prog;
  }
}

// One fire step with no environment, one CTA: the block kernel's node and
// arc phases once, dense rule.
__global__ void fire_step_kernel(Tables t, const int* full, const int* val,
                                 int* full_o, int* val_o, int* fired_o,
                                 int N2, int A2) {
  extern __shared__ int smem[];
  __shared__ int s_fired;
  int* s_full = smem;
  int* s_val = s_full + A2;
  int* s_z = s_val + A2;
  int* s_cp = s_z + N2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < A2; i += nt) {
    s_full[i] = full[i];
    s_val[i] = val[i];
  }
  if (tid == 0) s_fired = 0;
  __syncthreads();
  int nfire = 0;
  for (int n = tid; n < N2; n += nt)
    nfire += fire_node<false, false>(t, n, __ldg(t.opcode + n), s_full,
                                     s_val, s_z, s_cp, NodeCounters{});
  nfire = __reduce_add_sync(0xffffffffu, nfire);
  if ((tid & 31) == 0 && nfire) atomicAdd(&s_fired, nfire);
  __syncthreads();
  for (int i = tid; i < A2; i += nt) {
    int from;
    full_o[i] = arc_next(t, i, s_full, s_cp, &from);
    val_o[i] = from >= 0 ? s_z[from] : s_val[i];
  }
  if (tid == 0) fired_o[0] = s_fired;
}

int cta_threads(int n) {
  return std::min(1024, (std::max(n, 1) + 31) / 32 * 32);
}

template <bool kProf, bool kSpec, bool kControlFree>
int launch_block(const Tables& t, const State& s, int B, int N2, int A2,
                 int n_in, int n_out, int L, int n_cycles, int n_classes,
                 cudaStream_t stream) {
  const size_t smem = dynamic_smem_bytes(N2, A2, n_in, n_out, kProf);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fire_block_kernel<kProf, kSpec, kControlFree>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = cta_threads(std::max(std::max(N2, A2),
                                           std::max(n_in, n_out)));
  fire_block_kernel<kProf, kSpec, kControlFree>
      <<<B, threads, smem, stream>>>(t, s, N2, A2, n_in, n_out, L, n_cycles,
                                     n_classes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the fire-block kernel on `stream`; returns cudaGetLastError()
// (0 = ok).  class_table == nullptr selects the dense rule, prof == nullptr
// (all five) the unprofiled instantiation; control_free must be 1 only when
// no bucket of class_table holds NDMERGE, DMERGE or BRANCH.
int fire_block_launch(
    const int* opcode, const int* in_idx, const int* out_idx,
    const int* prod_node, const int* prod_slot, const int* cons_node,
    const int* cons_slot, const int* const_mask, const int* env_row,
    const int* in_arc_idx, const int* out_arc_idx, const int* out_mask,
    const int* class_table, const int* feed_vals, const int* feed_len,
    const int* full, const int* val, const int* ptr, const int* out_last,
    const int* out_count, const int* active, const int* nf, const int* si,
    const int* so, const int* ab, const int* ahw, int* full_o, int* val_o,
    int* ptr_o, int* out_last_o, int* out_count_o, int* fired_o,
    int* last_prog_o, int* nf_o, int* si_o, int* so_o, int* ab_o,
    int* ahw_o, int B, int N2, int A2, int n_in, int n_out, int L,
    int n_cycles, int n_classes, int control_free, void* stream) {
  if (class_table != nullptr && (n_classes < 1 || n_classes > kMaxClasses))
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t{opcode, in_idx, out_idx, prod_node, prod_slot, cons_node,
           cons_slot, const_mask, env_row, in_arc_idx, out_arc_idx,
           out_mask, class_table};
  State s{feed_vals, feed_len, full, val, ptr, out_last, out_count, active,
          {nf, si, so, ab, ahw}, full_o, val_o, ptr_o, out_last_o,
          out_count_o, fired_o, last_prog_o,
          {nf_o, si_o, so_o, ab_o, ahw_o}};
  const bool prof = nf != nullptr;
  const bool spec = class_table != nullptr;
  const bool cf = spec && control_free != 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define FIRE_BLOCK_LAUNCH(P, S, C) \
  launch_block<P, S, C>(t, s, B, N2, A2, n_in, n_out, L, n_cycles, \
                        n_classes, st)
  if (prof) {
    if (!spec) return FIRE_BLOCK_LAUNCH(true, false, false);
    return cf ? FIRE_BLOCK_LAUNCH(true, true, true)
              : FIRE_BLOCK_LAUNCH(true, true, false);
  }
  if (!spec) return FIRE_BLOCK_LAUNCH(false, false, false);
  return cf ? FIRE_BLOCK_LAUNCH(false, true, true)
            : FIRE_BLOCK_LAUNCH(false, true, false);
#undef FIRE_BLOCK_LAUNCH
}

// Launches the fire-step kernel (one CTA) on `stream`; returns
// cudaGetLastError() (0 = ok).
int fire_step_launch(
    const int* opcode, const int* in_idx, const int* out_idx,
    const int* prod_node, const int* prod_slot, const int* cons_node,
    const int* cons_slot, const int* const_mask, const int* full,
    const int* val, int* full_o, int* val_o, int* fired_o, int N2, int A2,
    void* stream) {
  Tables t{opcode, in_idx, out_idx, prod_node, prod_slot, cons_node,
           cons_slot, const_mask, nullptr, nullptr, nullptr, nullptr,
           nullptr};
  const size_t smem = dynamic_smem_bytes(N2, A2, 0, 0, false);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fire_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fire_step_kernel<<<1, cta_threads(std::max(N2, A2)), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      t, full, val, full_o, val_o, fired_o, N2, A2);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory (dynamic + static) one CTA of the fire-block kernel needs
// for a fabric, in bytes; the fire step needs at most the value for
// n_in = n_out = 0 without counters.
int fire_block_smem_bytes(int N2, int A2, int n_in, int n_out, int prof) {
  return static_cast<int>(dynamic_smem_bytes(N2, A2, n_in, n_out, prof != 0) +
                          kStaticSmemBytes);
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
