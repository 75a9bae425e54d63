// Static-schedule kernels for Hopper (sm_90a): a control-free fabric's
// precomputed firing schedule, table-driven, with no ready rule at run
// time — a whole run per launch (one CTA per stream), or K cycles per slot
// of the resumable slot API (one CTA per slot).
//
// Replaces the TPU kernels of src/repro/kernels/schedule_fire.py:
//   make_sched_run (:69; pallas_call :97 solo, :116 batched) -> sched_run_kernel
//   make_sched_slot_step (:134; pallas_call :174)             -> sched_slot_step_kernel
// The Pallas versions trace a straight-line program per schedule structure
// and bake per-pattern index vectors into it.  Here both kernels read the
// same per-pattern tables (ScheduleContext.slot_tables() plus each
// pattern's fire count), so nothing is generated or compiled per fabric or
// per schedule: the run kernel walks a program of segments (offsets into a
// pid list, lengths, repetitions) — the plan's clipped RLE, any structure
// and any max_cycles clip — and the slot kernel walks a host-computed pid
// window per slot.  The plain PyTorch versions are sched_run /
// sched_slot_step in ../schedule_fire.py; results are bit-identical.
//
// One scheduled cycle of pattern pid, per CTA:
//   1. feed  — feed row r with feed[pid, r] loads fv[r, clip(ptr_r, 0, L-1)]
//              into arc ia[r], ptr_r += 1;
//   2. fire  — fire row k < nfire[pid] computes z = ALU(op, val[i0],
//              val[i1]) and writes val[o0], val[o1] (A2, the drop
//              sentinel, is skipped, never written: val[EMPTY_PAD] stays
//              as it was);
//   3. drain — output row r with drain[pid, r] records val[oa[r]] and
//              counts a token.
// A barrier separates feed from fire and fire from drain.  The fire phase
// needs none inside it: in a scheduled cycle a fired node's inputs are
// full and its outputs empty, so the arcs read and the arcs written are
// disjoint.  Drain needs none before the next feed: input and output arcs
// are disjoint, and the next fire waits at the next post-feed barrier.
//
// What bounds them on this card.  Latency: a run is a serial chain of
// cycles (8,197 of them for the dot-product fabric at n = 32 and 4096
// tokens per stream), each a feed, a fire and a drain that read what the
// previous one wrote, two barriers apart.  Bytes are small (the stream's
// tokens once, a few KB of tables that stay in L1/L2), and a cycle is a
// few dozen integer operations per stream.
//
// What the design does about it:
//   * the arc registers val[A2] live in shared memory for the whole launch;
//     every other piece of state lives in the registers of the thread that
//     owns it — thread r holds feed row r's pointer and its next token and
//     drain row r's last value and count (one thread per feed, fire and
//     drain row: the wrapper refuses patterns wider than the CTA);
//   * the next token of each feed row is loaded as soon as its pointer
//     moves, so the feed phase writes a register into shared memory and
//     the stream's global-memory latency overlaps the rest of the cycle;
//   * a thread loads its table entries for the cycle's pattern (feed flag,
//     fire row, drain flag) before the first barrier, all independent
//     loads through the read-only cache, where the few patterns of a
//     steady-state period stay;
//   * no run-time rule: no ready reduction, no empty-output checks, no arc
//     phase, no per-cycle firing count — the host knows them from the
//     plan;
//   * one CTA per stream or slot, so B streams run side by side on the 132
//     SMs and hide each other's barrier latency.
//
// Build: ../_build.py compiles every .cu of this directory for sm_90a and
// links them into one shared library; plain C interface for ctypes.

#include <algorithm>
#include <cuda_runtime.h>

#include "alu.cuh"

namespace {

struct SchedTables {
  const int* op;      // [P, F] fire rows (pad: COPY of FULL_PAD into A2)
  const int* i0;      // [P, F]
  const int* i1;      // [P, F]
  const int* o0;      // [P, F] (A2 = drop)
  const int* o1;      // [P, F] (A2 = drop)
  const int* feed;    // [P, n_in] 0/1
  const int* drain;   // [P, n_out] 0/1
  const int* full;    // [P, A2] 0/1 post-drain occupancy (slot kernel)
  const int* nfire;   // [P] real fire rows of each pattern
  const int* ia;      // [n_in] arc of each feed row
  const int* oa;      // [n_out] arc of each drain row
  const int* val0;    // [A2] registers of a fresh run (run kernel)
};

struct Dims {
  int A2, n_in, n_out, L, F;
};

// The rows one thread owns: feed row tid (pointer, next token, arc) and
// drain row tid (last value, count, arc).
struct Rows {
  int ptr, tok, in_arc;
  int ol, oc, out_arc;
};

__device__ __forceinline__ int load_tok(const int* fv, const Dims& d,
                                        int row, int ptr) {
  return __ldg(fv + static_cast<size_t>(row) * d.L + min(max(ptr, 0), d.L - 1));
}

// One scheduled cycle of pattern `pid` for this CTA's stream (see the
// header).  Every thread of the CTA calls it: it holds two barriers.
__device__ __forceinline__ void sched_cycle(const SchedTables& t,
                                            const Dims& d, int pid,
                                            const int* fv, int* s_val,
                                            Rows& r, int tid) {
  const bool feed =
      tid < d.n_in && __ldg(t.feed + static_cast<size_t>(pid) * d.n_in + tid);
  const bool fire = tid < __ldg(t.nfire + pid);
  int op = OP_COPY, i0 = 0, i1 = 0, o0 = d.A2, o1 = d.A2;
  if (fire) {
    const size_t k = static_cast<size_t>(pid) * d.F + tid;
    op = __ldg(t.op + k);
    i0 = __ldg(t.i0 + k);
    i1 = __ldg(t.i1 + k);
    o0 = __ldg(t.o0 + k);
    o1 = __ldg(t.o1 + k);
  }
  const bool drain = tid < d.n_out &&
                     __ldg(t.drain + static_cast<size_t>(pid) * d.n_out + tid);
  // 1. feed
  if (feed) {
    s_val[r.in_arc] = r.tok;
    r.ptr += 1;
    r.tok = load_tok(fv, d, tid, r.ptr);
  }
  __syncthreads();
  // 2. fire (reads and writes touch disjoint arcs)
  if (fire) {
    const int z = alu_int(op, s_val[i0], s_val[i1]);
    if (o0 < d.A2) s_val[o0] = z;
    if (o1 < d.A2) s_val[o1] = z;
  }
  __syncthreads();
  // 3. drain
  if (drain) {
    r.ol = s_val[r.out_arc];
    r.oc += 1;
  }
}

__device__ __forceinline__ Rows init_rows(const SchedTables& t, const Dims& d,
                                          const int* fv, int tid, int ptr,
                                          int ol, int oc) {
  Rows r{ptr, 0, 0, ol, oc, 0};
  if (tid < d.n_in) {
    r.in_arc = __ldg(t.ia + tid);
    r.tok = load_tok(fv, d, tid, ptr);
  }
  if (tid < d.n_out) r.out_arc = __ldg(t.oa + tid);
  return r;
}

// A whole scheduled run of stream blockIdx.x from a fresh start.  prog is
// seg_off[S] seg_len[S] seg_reps[S] then the pid list: segment s runs
// pids[seg_off[s] .. seg_off[s] + seg_len[s]) seg_reps[s] times.
__global__ void sched_run_kernel(SchedTables t, Dims d, const int* prog,
                                 int S, const int* fv_all, int* ol_o,
                                 int* oc_o) {
  extern __shared__ int s_val[];   // [A2]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* fv = fv_all + static_cast<size_t>(b) * d.n_in * d.L;
  for (int i = tid; i < d.A2; i += blockDim.x) s_val[i] = __ldg(t.val0 + i);
  Rows r = init_rows(t, d, fv, tid, 0, 0, 0);
  __syncthreads();
  const int* seg_off = prog;
  const int* seg_len = prog + S;
  const int* seg_reps = prog + 2 * S;
  const int* pids = prog + 3 * S;
  for (int s = 0; s < S; ++s) {
    const int* seg = pids + __ldg(seg_off + s);
    const int len = __ldg(seg_len + s);
    const int reps = __ldg(seg_reps + s);
    for (int rep = 0; rep < reps; ++rep)
      for (int j = 0; j < len; ++j)
        sched_cycle(t, d, __ldg(seg + j), fv, s_val, r, tid);
  }
  if (tid < d.n_out) {
    ol_o[static_cast<size_t>(b) * d.n_out + tid] = r.ol;
    oc_o[static_cast<size_t>(b) * d.n_out + tid] = r.oc;
  }
}

// K scheduled cycles of slot blockIdx.x from its state, then its full
// bits from the last pattern (fsel >= 0) or passed through (fsel == -1).
__global__ void sched_slot_step_kernel(
    SchedTables t, Dims d, int K, const int* fv_all, const int* pids,
    const int* fsel, const int* full, const int* val, const int* ptr,
    const int* out_last, const int* out_count, int* full_o, int* val_o,
    int* ptr_o, int* out_last_o, int* out_count_o) {
  extern __shared__ int s_val[];   // [A2]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t arcs = static_cast<size_t>(b) * d.A2;
  const size_t ins = static_cast<size_t>(b) * d.n_in;
  const size_t outs = static_cast<size_t>(b) * d.n_out;
  const int* fv = fv_all + ins * d.L;
  for (int i = tid; i < d.A2; i += blockDim.x) s_val[i] = val[arcs + i];
  Rows r = init_rows(t, d, fv, tid, tid < d.n_in ? ptr[ins + tid] : 0,
                     tid < d.n_out ? out_last[outs + tid] : 0,
                     tid < d.n_out ? out_count[outs + tid] : 0);
  __syncthreads();
  const int* my_pids = pids + static_cast<size_t>(b) * K;
  for (int j = 0; j < K; ++j)
    sched_cycle(t, d, __ldg(my_pids + j), fv, s_val, r, tid);
  // the last cycle's writes to s_val precede its post-fire barrier
  const int fs = fsel[b];
  const int* full_src = fs >= 0 ? t.full + static_cast<size_t>(fs) * d.A2
                                : full + arcs;
  for (int i = tid; i < d.A2; i += blockDim.x) {
    full_o[arcs + i] = full_src[i];
    val_o[arcs + i] = s_val[i];
  }
  if (tid < d.n_in) ptr_o[ins + tid] = r.ptr;
  if (tid < d.n_out) {
    out_last_o[outs + tid] = r.ol;
    out_count_o[outs + tid] = r.oc;
  }
}

int cta_threads(const Dims& d) {
  return (std::max(std::max(d.n_in, d.n_out), std::max(d.F, 1)) + 31) / 32 *
         32;
}

template <typename Kernel>
int prepare(Kernel kernel, const Dims& d, size_t* smem) {
  *smem = sizeof(int) * static_cast<size_t>(d.A2);
  if (cta_threads(d) > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

// Launches the scheduled-run kernel (grid = B) on `stream`; returns
// cudaGetLastError() (0 = ok).  prog holds 3 * S + (pid count) ints.
int sched_run_launch(
    const int* op, const int* i0, const int* i1, const int* o0,
    const int* o1, const int* feed, const int* drain, const int* full,
    const int* nfire, const int* ia, const int* oa, const int* val0,
    const int* prog, const int* fv, int* out_last_o, int* out_count_o,
    int S, int B, int A2, int n_in, int n_out, int L, int F, void* stream) {
  const SchedTables t{op, i0, i1, o0, o1, feed, drain, full, nfire, ia, oa,
                      val0};
  const Dims d{A2, n_in, n_out, L, F};
  size_t smem = 0;
  if (int e = prepare(sched_run_kernel, d, &smem)) return e;
  sched_run_kernel<<<B, cta_threads(d), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      t, d, prog, S, fv, out_last_o, out_count_o);
  return static_cast<int>(cudaGetLastError());
}

// Launches the scheduled slot-step kernel (grid = B slots) on `stream`;
// returns cudaGetLastError() (0 = ok).  pids is [B, K], fsel [B].
int sched_slot_step_launch(
    const int* op, const int* i0, const int* i1, const int* o0,
    const int* o1, const int* feed, const int* drain, const int* full_t,
    const int* nfire, const int* ia, const int* oa, const int* val0,
    const int* fv, const int* pids, const int* fsel, const int* full,
    const int* val, const int* ptr, const int* out_last,
    const int* out_count, int* full_o, int* val_o, int* ptr_o,
    int* out_last_o, int* out_count_o, int B, int K, int A2, int n_in,
    int n_out, int L, int F, void* stream) {
  const SchedTables t{op, i0, i1, o0, o1, feed, drain, full_t, nfire, ia,
                      oa, val0};
  const Dims d{A2, n_in, n_out, L, F};
  size_t smem = 0;
  if (int e = prepare(sched_slot_step_kernel, d, &smem)) return e;
  sched_slot_step_kernel<<<B, cta_threads(d), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      t, d, K, fv, pids, fsel, full, val, ptr, out_last, out_count, full_o,
      val_o, ptr_o, out_last_o, out_count_o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
