// Static-schedule kernels for Hopper (sm_90a): a control-free fabric's
// precomputed firing schedule, table-driven, with no ready rule at run
// time — a whole run per launch, or K cycles per slot of the resumable
// slot API.
//
// Replaces the TPU kernels of src/repro/kernels/schedule_fire.py:
//   make_sched_run (:69; pallas_call :97 solo, :116 batched)
//       -> sched_run_warp_kernel (one warp per stream, the warp variant)
//          and sched_run_kernel (one CTA per stream, the CTA variant)
//   make_sched_slot_step (:134; pallas_call :174)
//       -> sched_slot_warp_kernel (one warp per slot, the warp variant)
//          and sched_slot_step_kernel (one CTA per slot, the CTA variant)
// The Pallas versions trace a straight-line program per schedule structure
// and bake per-pattern index vectors into it.  Here the kernels read
// per-pattern tables (ScheduleContext.slot_tables() plus each pattern's
// fire count; packed for the warp variant), so nothing is generated or
// compiled per fabric or per schedule: the run kernels walk a program of
// segments (offsets into a pid list, lengths, repetitions) — the plan's
// clipped RLE, any structure and any max_cycles clip — and the slot
// kernels walk a host-computed pid window per slot.  The wrappers pick
// each kernel's variant by the tables' widths and the shared memory the
// program or the window needs (schedule_fire.sched_variant, slot_variant).
// The plain PyTorch versions are sched_run / sched_slot_step in
// ../schedule_fire.py; results are bit-identical; sched_run_staged and
// sched_slot_step_staged there replay the warp variants' staged feed
// windows on the CPU.
//
// One scheduled cycle of pattern pid, per stream:
//   1. feed  — feed row r with feed[pid, r] loads fv[r, clip(ptr_r, 0, L-1)]
//              into arc ia[r], ptr_r += 1;
//   2. fire  — fire row k < nfire[pid] computes z = ALU(op, val[i0],
//              val[i1]) and writes val[o0], val[o1] (A2, the drop
//              sentinel, lies past the registers: the CTA variant skips
//              it, the warp variant writes a spare slot that is never
//              read);
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
// tokens once, a few KB of tables), and a cycle is a few dozen integer
// operations per stream.
//
// What the warp variant does about it:
//   * one warp per stream, up to four streams a CTA: the barriers are
//     __syncwarp, and a lane owns feed, fire and drain rows lane + 32 k
//     (dot_prod n = 32: 2 feed rows and up to 2 fire rows a lane).  Below
//     4 streams an SM a stream of 64 rows or more takes two warps instead
//     (a named barrier of 64 threads, one row of each table a thread):
//     then nothing else would hide the stream's latency;
//   * the program and the tables on chip: at launch the CTA stages the
//     segments, the pid list and, for each pattern the program uses, one
//     8-byte word per fire row (op, i0, i1, o0, o1) and one word of feed
//     and drain bits per thread, into shared memory for its streams; a
//     thread reads the pid two cycles ahead and the next cycle's entries
//     while the current cycle runs, so a cycle's chain touches shared
//     memory and registers only, and every fire load precedes its stores;
//   * feed windows staged ahead: each row's tokens in windows of W,
//     double-buffered in shared memory, copied with 16-byte cp.async
//     aligned on the device address a whole chunk of W / 2 cycles before
//     the row can reach them; the next token of each row sits in a
//     register from one feed to the next;
//   * no run-time rule: no ready reduction, no empty-output checks, no arc
//     phase, no per-cycle firing count — the host knows them from the
//     plan.
// The slot step's warp variant (sched_slot_warp_kernel) runs the same
// cycle, one warp a slot: a slot's K cycles are its own pid window, so it
// stages that window's work once — each feed row's tokens for the K cycles
// and the list of cycles that do work — and reads each cycle's entries
// from the packed tables through the read-only cache one cycle ahead.
// The CTA variants (one thread per row, __syncthreads between the phases,
// tables read through the read-only cache, the next token loaded from
// device memory when the pointer moves) take patterns wider than the warp
// variants, and programs or windows that do not fit their shared memory;
// both share one cycle (sched_cycle).
//
// Build: ../_build.py compiles every .cu of this directory for sm_90a and
// links them into one shared library; plain C interface for ctypes.

#include <algorithm>
#include <cuda_runtime.h>

#include "alu.cuh"
#include "cp_async.cuh"

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

// ---------------------------------------------------------------------------
// The warp variant of the scheduled run
// ---------------------------------------------------------------------------
// Streams per CTA at most; streams an SM needs before a stream of 64 rows
// or more drops from two warps to one (below it nothing else would hide a
// stream's latency); the feed-window lengths a launch may take, longest
// first.
constexpr int kMaxRunStreams = 4;
constexpr int kFullStreamsPerSm = 4;
constexpr int kWindows[] = {64, 32, 16, 8, 4};

// Shapes of a warp-variant launch.  U: patterns staged (the program's own,
// renumbered 0..U-1 by the wrapper); Fp: fire rows per staged pattern (the
// rows a stream's threads own); W: tokens per feed window (a power of two,
// at least 4), log_w its log2; cycles: the program's length; restage: 0
// only for the latency floor (windows staged once, never again).
struct WarpDims {
  int B, A2, n_in, n_out, L, U, Fp, S, M, W, log_w, streams, warps, cycles,
      restage;
  unsigned ops;
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Ints between two feed rows' windows: two windows of W + 4, and 4 more
// when that is an even number of 16-byte pieces, so the rows of a warp's
// lanes start on 8 of the 32 banks, not 4.
__host__ __device__ inline int warp_row_ints(int W) {
  const int n = 2 * (W + 4);
  return (n / 4) % 2 == 0 ? n + 4 : n;
}

// Shared memory in ints, all offsets 16-byte aligned: the CTA's tables
// (fire words [U][Fp] as int2, thread bits [U][32 warps], the program [3S
// + M]), then per stream its registers [A2 + 1] (the last the drop
// sentinel's slot, written and never read) and its feed rows' windows.
__host__ __device__ inline int warp_table_ints(const WarpDims& d) {
  return align4(2 * d.U * d.Fp + 32 * d.warps * d.U + 3 * d.S + d.M);
}
__host__ __device__ inline int warp_stream_ints(const WarpDims& d) {
  return align4(d.A2 + 1) + d.n_in * warp_row_ints(d.W);
}

// Stages tokens [a, e] of a feed row (0 <= a <= e <= L - 1) into buf, in
// 16-byte pieces aligned on the device address (fv_al is the tokens rounded
// down to 16 bytes, row the row's first token from there; a piece never
// straddles a page, so the few ints read around a row are mapped).  Token
// p then sits at buf[row + p - ((row + a) & ~3)].
__device__ __forceinline__ void stage_range(const int* fv_al, long long row,
                                            long long a, long long e,
                                            int* buf) {
  const long long start = (row + a) & ~3LL;
  const int pieces = static_cast<int>((row + e - start) >> 2) + 1;
  for (int k = 0; k < pieces; ++k)
    cp_async16(buf + 4 * k, fv_al + start + 4 * k);
}

// Stages window w of a feed row — tokens [w W, (w + 1) W) clamped to L - 1,
// w W <= L - 1 — into buf.  Token q of the window then sits at buf[(row &
// 3) + (q & (W - 1))], since W is a multiple of 4.
__device__ __forceinline__ void stage_window(const int* fv_al, long long row,
                                             int w, const WarpDims& d,
                                             int* buf) {
  const long long a = static_cast<long long>(w) << d.log_w;
  stage_range(fv_al, row, a,
              min(a + d.W - 1, static_cast<long long>(d.L - 1)), buf);
}

// The barrier between a cycle's phases: the stream's warp, or its kG
// warps (named barrier 1 + the stream's index in the CTA).
template <int kG>
__device__ __forceinline__ void stream_sync(int id) {
  if constexpr (kG == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(32 * kG) : "memory");
  }
}

// A whole scheduled run, kG warps per stream, kR rows of each table a
// thread, `streams` streams per CTA.  prog: seg_off[S] seg_len[S]
// seg_reps[S], the pid list [M] renumbered to the staged patterns, then
// used[U] (the global pid of each).  fire[P][Fp] int2 words (x: i0 | i1 <<
// 13 | op << 26, y: o0 | o1 << 16; pad rows COPY of arc 0 into the sentinel
// A2) and bits[P][32 kG] (thread t, bit k: feed row t + 32 kG k is fed; 8
// + k: drain row t + 32 kG k drains; 16 + k, 20 + k, 24 + k: some feed,
// drain, real fire row of rows 32 kG k .. 32 kG (k + 1) - 1, so the stream
// skips the group otherwise) are schedule_fire.warp_tables.
//
// A cycle is feed, barrier, fire, barrier, drain, ordered as in
// sched_cycle.  Thread t of a stream owns feed, fire and drain rows t +
// 32 kG k (k < kR) and holds, from one cycle to the next, each feed row's
// pointer and next token and the next cycle's pattern entries (read from
// shared memory while the current cycle runs); a group of rows that the
// pattern leaves idle is skipped by the whole stream.  Feed windows: the
// tokens of a row are cut into windows of W by position, two buffers a
// row; the cycles into chunks of C = W / 2.  At each chunk's start a thread
// waits for its copies (issued a chunk earlier) and, for a row in window
// w whose window w + 1 is not yet issued, issues it.  A row enters window
// w + 1 at least C + 1 feeds after that issue, so past the next chunk's
// wait; each row's windows are copied and read by its own thread.
template <int kR, int kG>
__global__ void __launch_bounds__(32 * kMaxRunStreams * kG)
sched_run_warp_kernel(const int2* __restrict__ fire,
                      const int* __restrict__ bits,
                      const int* __restrict__ ia, const int* __restrict__ oa,
                      const int* __restrict__ val0,
                      const int* __restrict__ prog, const int* fv_al,
                      int mis, int* ol_o, int* oc_o, WarpDims d) {
  constexpr int TS = 32 * kG;                  // threads of a stream
  extern __shared__ __align__(16) int smem[];
  const int local = threadIdx.x / TS, t = threadIdx.x % TS;
  const int b = blockIdx.x * d.streams + local;
  int2* s_fire = reinterpret_cast<int2*>(smem);
  int* s_bits = smem + 2 * d.U * d.Fp;
  int* s_prog = s_bits + TS * d.U;
  int* s_val = smem + warp_table_ints(d) + local * warp_stream_ints(d);
  int* s_win = s_val + align4(d.A2 + 1);
  // the CTA's tables, gathered from the program's patterns
  const int* used = prog + 3 * d.S + d.M;
  for (int i = threadIdx.x; i < d.U * d.Fp; i += blockDim.x)
    s_fire[i] = fire[static_cast<size_t>(__ldg(used + i / d.Fp)) * d.Fp +
                     i % d.Fp];
  for (int i = threadIdx.x; i < TS * d.U; i += blockDim.x)
    s_bits[i] = __ldg(bits + static_cast<size_t>(__ldg(used + i / TS)) * TS +
                      i % TS);
  for (int i = threadIdx.x; i < 3 * d.S + d.M; i += blockDim.x)
    s_prog[i] = __ldg(prog + i);
  const bool live = b < d.B;
  if (live)
    for (int i = t; i <= d.A2; i += TS)
      s_val[i] = i < d.A2 ? __ldg(val0 + i) : 0;
  __syncthreads();
  if (!live) return;
  const int bar_id = 1 + local;

  // feed rows: pointer, next token, arc, window buffers, last window issued
  int ptr[kR], tok[kR], in_arc[kR], issued[kR];
  long long row0[kR];
  int* wbuf[kR];
  const int ws = d.W + 4;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = t + TS * k;
    ptr[k] = 0;
    tok[k] = 0;
    issued[k] = -1;
    in_arc[k] = r < d.n_in ? __ldg(ia + r) : 0;
    row0[k] = mis + (static_cast<long long>(b) * d.n_in + r) * d.L;
    wbuf[k] = s_win + r * warp_row_ints(d.W);
    if (r < d.n_in) {
      stage_window(fv_al, row0[k], 0, d, wbuf[k]);
      issued[k] = 0;
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  const int last_win = (d.L - 1) >> d.log_w;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if (t + TS * k < d.n_in) {
      tok[k] = wbuf[k][(row0[k] & 3)];           // token 0
      if (last_win >= 1) {
        stage_window(fv_al, row0[k], 1, d, wbuf[k] + ws);
        issued[k] = 1;
      }
    }
  }
  cp_async_commit();
  // drain rows
  int out_arc[kR], ol[kR], oc[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = t + TS * k;
    out_arc[k] = r < d.n_out ? __ldg(oa + r) : 0;
    ol[k] = oc[k] = 0;
  }

  // the program's cursor: segment s, repetition rep, index j
  const int* seg_off = s_prog;
  const int* seg_len = s_prog + d.S;
  const int* seg_reps = s_prog + 2 * d.S;
  const int* pids = s_prog + 3 * d.S;
  int s = 0, rep = 0, j = 0;
  while (s < d.S && (seg_len[s] == 0 || seg_reps[s] == 0)) ++s;
  int off = s < d.S ? seg_off[s] : 0;
  int len = s < d.S ? seg_len[s] : 1;
  int reps = s < d.S ? seg_reps[s] : 1;
  // the entries of a pattern this thread reads: its fire words and its
  // word of bits
  int2 fw[kR];
  int lb;
  auto entries = [&](int pid, int2 (&w)[kR], int& bb) {
#pragma unroll
    for (int k = 0; k < kR; ++k) w[k] = s_fire[pid * d.Fp + t + TS * k];
    bb = s_bits[pid * TS + t];
  };
  // the cursor's next cycle, and its pid (0 past the program's end)
  auto advance = [&]() {
    if (++j == len) {
      j = 0;
      if (++rep == reps) {
        rep = 0;
        do {
          ++s;
        } while (s < d.S && (seg_len[s] == 0 || seg_reps[s] == 0));
        if (s < d.S) {
          off = seg_off[s];
          len = seg_len[s];
          reps = seg_reps[s];
        }
      }
    }
    return s < d.S ? pids[off + j] : 0;
  };
  entries(s < d.S ? pids[off] : 0, fw, lb);
  int npid = advance();                         // cycle 1's pattern
  const int chunk_mask = (d.W >> 1) - 1;        // C = W / 2, a power of two

  for (int c = 0; c < d.cycles; ++c) {
    // the next cycle's entries and the pid of the one after, off this
    // cycle's chain (the pid two cycles ahead, so no load waits on one)
    int2 nfw[kR];
    int nlb;
    entries(npid, nfw, nlb);
    const int nnpid = advance();
    // 1. feed: the token held since the last feed; the next one read
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if ((lb >> (16 + k)) & 1) {
        if ((lb >> k) & 1) {
          s_val[in_arc[k]] = tok[k];
          ptr[k] += 1;
          const int q = min(max(ptr[k], 0), d.L - 1);
          tok[k] = wbuf[k][((q >> d.log_w) & 1) * ws + (row0[k] & 3) +
                           (q & (d.W - 1))];
        }
      }
    }
    stream_sync<kG>(bar_id);
    // 2. fire: every read before any write (they touch disjoint arcs, so
    //    the loads of all rows overlap); the sentinel's slot takes the
    //    dropped writes
    int op[kR], a[kR], bv[kR], z[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      op[k] = fw[k].x >> 26;
      a[k] = bv[k] = 0;
      if ((lb >> (24 + k)) & 1) {
        a[k] = s_val[fw[k].x & 0x1fff];
        bv[k] = s_val[(fw[k].x >> 13) & 0x1fff];
      }
    }
    alu_select<kR>(op, a, bv, z, d.ops);
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if ((lb >> (24 + k)) & 1) {
        s_val[fw[k].y & 0xffff] = z[k];
        s_val[fw[k].y >> 16] = z[k];
      }
    }
    stream_sync<kG>(bar_id);
    // 3. drain
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (((lb >> (20 + k)) & 1) && ((lb >> (8 + k)) & 1)) {
        ol[k] = s_val[out_arc[k]];
        oc[k] += 1;
      }
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) fw[k] = nfw[k];
    lb = nlb;
    npid = nnpid;
    // the next chunk's start: wait for the windows issued a chunk ago,
    // issue the next window of every row that has entered its last one
    // (never in the latency floor, whose results are not the run's)
    if (d.restage && ((c + 1) & chunk_mask) == 0) {
      cp_async_wait_all();
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int w = min(max(ptr[k], 0), d.L - 1) >> d.log_w;
        if (t + TS * k < d.n_in && issued[k] == w && w < last_win) {
          stage_window(fv_al, row0[k], w + 1, d,
                       wbuf[k] + ((w + 1) & 1) * ws);
          issued[k] = w + 1;
        }
      }
      cp_async_commit();
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = t + TS * k;
    if (r < d.n_out) {
      ol_o[static_cast<size_t>(b) * d.n_out + r] = ol[k];
      oc_o[static_cast<size_t>(b) * d.n_out + r] = oc[k];
    }
  }
}

// ---------------------------------------------------------------------------
// The warp variant of the scheduled slot step
// ---------------------------------------------------------------------------
// Shapes of a slot-step launch of the warp variant: K cycles a slot, Fp
// fire rows per pattern (the packed tables'), `streams` slots a CTA (the
// plan's), ops the opcodes of the fire rows.
struct SlotDims {
  int B, A2, n_in, n_out, L, Fp, K, streams;
  unsigned ops;
};

// Ints of one feed row's window: the at most K tokens a slot's row takes
// in K cycles, the slack of a start rounded down to 16 bytes, and one
// token past them (read and dropped after the row's last feed), in an odd
// number of 16-byte pieces so the rows of a warp's lanes start on 8 of the
// 32 banks, not 4.
__host__ __device__ inline int slot_row_ints(int K) {
  return 4 * ((((K + 2) >> 2) + 1) | 1);
}

// Shared memory in ints, per slot, all offsets 16-byte aligned: the pid
// window [K], the working cycles' pids [K], the registers [A2 + 1] (the
// last the drop sentinel's slot) and the feed rows' windows
// [n_in][slot_row_ints].
__host__ __device__ inline int slot_stream_ints(const SlotDims& d) {
  return 2 * align4(d.K) + align4(d.A2 + 1) + d.n_in * slot_row_ints(d.K);
}

// K scheduled cycles of each slot from its state, one warp a slot, kR
// rows of each table a lane, `streams` slots a CTA; then its full bits
// from the last pattern (fsel >= 0) or passed through (fsel == -1).  fire
// and bits are the packed tables of sched_run_warp_kernel (bits for one
// warp a stream), pids [B, K], t_full [P, A2].  (Two warps a slot, as the
// run kernel takes below 4 streams an SM, were no faster here.)
//
// At launch a slot's threads copy its pid window and registers into
// shared memory (cp.async, one round trip to memory) and walk the window
// once, loading their words of bits 16 cycles at a time: each thread
// counts its feed rows' tokens, and the cycles that feed, fire or drain
// are listed (the bits' group flags are the same on every thread of the
// slot; pid 0, the no-op pattern, and the all-quiet patterns past a plan's
// end do no work and are skipped).  Each feed row's window — tokens
// clamp(ptr) .. clamp(ptr + n - 1), the n it will take — is then copied by
// its own thread with 16-byte cp.async, once.  A slot with no working
// cycle copies its state through and runs none.  The cycle is
// sched_run_warp_kernel's (feed, barrier, fire, barrier, drain); its
// entries come through the read-only cache one working cycle ahead, so
// the chain touches shared memory and registers only.
template <int kR>
__global__ void __launch_bounds__(32 * kMaxRunStreams)
sched_slot_warp_kernel(const int2* __restrict__ fire,
                       const int* __restrict__ bits,
                       const int* __restrict__ ia, const int* __restrict__ oa,
                       const int* __restrict__ t_full, const int* fv_al,
                       int mis, const int* __restrict__ pids,
                       const int* __restrict__ fsel, const int* full,
                       const int* val, const int* ptr_in,
                       const int* out_last, const int* out_count,
                       int* full_o, int* val_o, int* ptr_o, int* out_last_o,
                       int* out_count_o, SlotDims d) {
  constexpr int TS = 32;                       // threads of a slot
  extern __shared__ __align__(16) int smem[];
  const int local = threadIdx.x / TS, t = threadIdx.x % TS;
  const int b = blockIdx.x * d.streams + local;
  if (b >= d.B) return;                  // the last CTA may be part-filled
  int* s_pid = smem + local * slot_stream_ints(d);
  int* s_live = s_pid + align4(d.K);
  int* s_val = s_live + align4(d.K);
  int* s_win = s_val + align4(d.A2 + 1);
  const int ri = slot_row_ints(d.K);
  const size_t arcs = static_cast<size_t>(b) * d.A2;
  const size_t ins = static_cast<size_t>(b) * d.n_in;
  const size_t outs = static_cast<size_t>(b) * d.n_out;
  stage_ints(s_pid, pids + static_cast<size_t>(b) * d.K, d.K, t, TS);
  stage_ints(s_val, val + arcs, d.A2, t, TS);
  // feed rows: pointer, arc, tokens to take, window; drain rows
  int ptr[kR], in_arc[kR], nfed[kR], wofs[kR], tok[kR];
  int out_arc[kR], ol[kR], oc[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = t + TS * k;
    ptr[k] = r < d.n_in ? ptr_in[ins + r] : 0;
    in_arc[k] = r < d.n_in ? __ldg(ia + r) : 0;
    out_arc[k] = r < d.n_out ? __ldg(oa + r) : 0;
    ol[k] = r < d.n_out ? out_last[outs + r] : 0;
    oc[k] = r < d.n_out ? out_count[outs + r] : 0;
    nfed[k] = wofs[k] = tok[k] = 0;
  }
  const int fs = fsel[b];
  cp_async_wait_all();
  __syncwarp();               // the pids and registers landed
  // the pid window, once: tokens per feed row, and the cycles that work,
  // 16 cycles at a time (their words of bits all loaded before any is
  // used; pid 0 stands past the window's end) into a mask, then listed
  int live = 0;
  for (int j0 = 0; j0 < d.K; j0 += 16) {
    int w[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      w[q] = __ldg(bits + static_cast<size_t>(j0 + q < d.K ? s_pid[j0 + q]
                                                           : 0) * TS + t);
    unsigned work = 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int wq = j0 + q < d.K ? w[q] : 0;
#pragma unroll
      for (int k = 0; k < kR; ++k) nfed[k] += (wq >> k) & 1;
      work |= static_cast<unsigned>(((wq >> 16) & 0xfff) != 0) << q;
    }
    if (t == 0)
      for (unsigned q = work, c = live; q; q &= q - 1)
        s_live[c++] = s_pid[j0 + __ffs(q) - 1];
    live += __popc(work);
  }
  // each feed row's window, by its own thread
  const int last = d.L - 1;
  auto clampL = [&](int q) { return min(max(q, 0), last); };
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = t + TS * k;
    if (r < d.n_in && nfed[k] > 0) {
      const long long row = mis + static_cast<long long>(ins + r) * d.L;
      const long long p = ptr[k];
      const long long a = min(max(p, 0LL), static_cast<long long>(last));
      stage_range(fv_al, row, a,
                  min(max(p + nfed[k] - 1, 0LL), static_cast<long long>(last)),
                  s_win + r * ri);
      wofs[k] = r * ri + static_cast<int>(row - ((row + a) & ~3LL));
    }
  }
  cp_async_wait_all();
  __syncwarp();               // s_live written
  // a token's slot in the windows, for the row's clamped pointer (past the
  // row's last feed: some slot of its window, read and dropped)
  auto slot = [&](int k) {
    return min(wofs[k] + clampL(ptr[k]), (t + TS * k) * ri + ri - 1);
  };
#pragma unroll
  for (int k = 0; k < kR; ++k)
    if (nfed[k] > 0) tok[k] = s_win[slot(k)];

  // working cycle c's entries: its fire words and word of bits (c clamped
  // to the last)
  auto entries = [&](int c, int2 (&w)[kR], int& bb) {
    const int pid = s_live[min(c, live - 1)];
#pragma unroll
    for (int k = 0; k < kR; ++k)
      w[k] = __ldg(fire + static_cast<size_t>(pid) * d.Fp + t + TS * k);
    bb = __ldg(bits + static_cast<size_t>(pid) * TS + t);
  };
  int2 fw[kR];
  int lb = 0;
  if (live > 0) entries(0, fw, lb);
  for (int c = 0; c < live; ++c) {
    // the next working cycle's entries, off the chain
    int2 nfw[kR];
    int nlb;
    entries(c + 1, nfw, nlb);
    // 1. feed
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (((lb >> (16 + k)) & 1) && ((lb >> k) & 1)) {
        s_val[in_arc[k]] = tok[k];
        ptr[k] += 1;
        tok[k] = s_win[slot(k)];
      }
    }
    __syncwarp();
    // 2. fire: every read before any write; the sentinel's slot takes the
    //    dropped writes
    int op[kR], a[kR], bv[kR], z[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      op[k] = fw[k].x >> 26;
      a[k] = bv[k] = 0;
      if ((lb >> (24 + k)) & 1) {
        a[k] = s_val[fw[k].x & 0x1fff];
        bv[k] = s_val[(fw[k].x >> 13) & 0x1fff];
      }
    }
    alu_select<kR>(op, a, bv, z, d.ops);
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if ((lb >> (24 + k)) & 1) {
        s_val[fw[k].y & 0xffff] = z[k];
        s_val[fw[k].y >> 16] = z[k];
      }
    }
    __syncwarp();
    // 3. drain
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (((lb >> (20 + k)) & 1) && ((lb >> (8 + k)) & 1)) {
        ol[k] = s_val[out_arc[k]];
        oc[k] += 1;
      }
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) fw[k] = nfw[k];
    lb = nlb;
  }
  // the last cycle's writes to s_val precede its post-fire barrier
  for (int i = t; i < d.A2; i += TS) {
    full_o[arcs + i] = fs >= 0 ? __ldg(t_full + static_cast<size_t>(fs) *
                                                    d.A2 + i)
                               : full[arcs + i];
    val_o[arcs + i] = s_val[i];
  }
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = t + TS * k;
    if (r < d.n_in) ptr_o[ins + r] = ptr[k];
    if (r < d.n_out) {
      out_last_o[outs + r] = ol[k];
      out_count_o[outs + r] = oc[k];
    }
  }
}

// Shared memory of one warp-variant CTA, in bytes.
size_t warp_smem_bytes(const WarpDims& d) {
  return 4 * static_cast<size_t>(warp_table_ints(d) +
                                 d.streams * warp_stream_ints(d));
}
size_t slot_smem_bytes(const SlotDims& d) {
  return 4 * static_cast<size_t>(d.streams) * slot_stream_ints(d);
}

// What the plans read of the card: SMs, and the shared memory a block may
// opt in to, an SM holds and the runtime reserves per block.
struct Card {
  int sms, optin, per_sm, reserved;
  // a CTA of `bytes` fits, two of them on an SM
  bool two_fit(size_t bytes) const {
    return bytes <= static_cast<size_t>(optin) &&
           2 * (bytes + reserved) <= static_cast<size_t>(per_sm);
  }
};

bool card_of(int device, Card* c) {
  return cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount,
                                device) == cudaSuccess &&
         cudaDeviceGetAttribute(&c->optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device) == cudaSuccess &&
         cudaDeviceGetAttribute(&c->per_sm,
                                cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                device) == cudaSuccess &&
         cudaDeviceGetAttribute(&c->reserved,
                                cudaDevAttrReservedSharedMemoryPerBlock,
                                device) == cudaSuccess;
}

// Warps a stream of the warp variants over tables Fp rows wide and B
// streams: `warps`, or with 0 two for tables of 64 rows or more while
// fewer than kFullStreamsPerSm streams share each SM, else one; 0 when the
// shapes are not the variants' (the slot step asks for one warp).
int stream_warps(int warps, int Fp, int A2, int n_in, int n_out, int B,
                 const Card& c) {
  if (warps == 0) warps = Fp >= 64 && B < kFullStreamsPerSm * c.sms ? 2 : 1;
  const int kr = warps >= 1 ? Fp / (32 * warps) : 0;
  if ((warps != 1 && warps != 2) || Fp % (32 * warps) ||
      (kr != 1 && kr != 2 && kr != 4) || std::max(n_in, n_out) > Fp ||
      A2 >= (1 << 13) || B < 1)
    return 0;
  return warps;
}

// Completes d (W, log_w, streams, warps) for a launch on `device`: the
// window `window` (0: the longest of kWindows) and then the most streams,
// up to kMaxRunStreams and B, with which two CTAs fit an SM, or one stream
// in one CTA; `warps` warps a stream (stream_warps).  Returns false when
// the shapes are not the variant's or nothing fits.
bool warp_plan(WarpDims& d, int window, int warps, int device) {
  Card c;
  if (!card_of(device, &c) || d.L < 1 || d.cycles < 0 ||
      (window != 0 && (window < 4 || (window & (window - 1)))))
    return false;
  d.warps = stream_warps(warps, d.Fp, d.A2, d.n_in, d.n_out, d.B, c);
  if (d.warps == 0) return false;
  auto set_window = [&](int W) {
    d.W = W;
    d.log_w = 0;
    while ((1 << d.log_w) < W) ++d.log_w;
  };
  for (d.streams = std::min(kMaxRunStreams, d.B); d.streams >= 1;
       d.streams /= 2) {
    for (const int W : kWindows) {
      set_window(window ? window : W);
      if (c.two_fit(warp_smem_bytes(d))) return true;
      if (window) break;
    }
  }
  d.streams = 1;
  set_window(window ? window : kWindows[4]);
  return warp_smem_bytes(d) <= static_cast<size_t>(c.optin);
}

// Completes d (streams) for a slot-step launch of the warp variant on
// `device`: the most slots, up to kMaxRunStreams and B, with which two
// CTAs fit an SM, or one slot in one CTA.  Returns false when the shapes
// are not the variant's on one warp (stream_warps) or one slot's windows
// do not fit a CTA (K too long: the CTA variant takes it).
bool slot_plan(SlotDims& d, int device) {
  Card c;
  if (!card_of(device, &c) || d.L < 1 || d.K < 1 ||
      stream_warps(1, d.Fp, d.A2, d.n_in, d.n_out, d.B, c) == 0)
    return false;
  for (d.streams = std::min(kMaxRunStreams, d.B); d.streams >= 1;
       d.streams /= 2)
    if (c.two_fit(slot_smem_bytes(d))) return true;
  d.streams = 1;
  return slot_smem_bytes(d) <= static_cast<size_t>(c.optin);
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

// Plans a launch of the warp variant on `device` (see warp_plan: window
// and warps 0 are the plan's choice) and writes {W, streams, warps} into
// plan; returns 0, or cudaErrorInvalidValue when the variant cannot take
// the shapes or its shared memory does not fit.
int sched_warp_plan(int A2, int n_in, int U, int Fp, int S, int M, int B,
                    int window, int warps, int device, int* plan) {
  WarpDims d{B, A2, n_in, 1, 1, U, Fp, S, M, 0, 0, 0, 0, 0, 1, 0u};
  if (!warp_plan(d, window, warps, device))
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = d.W;
  plan[1] = d.streams;
  plan[2] = d.warps;
  return 0;
}

// Launches the warp variant of the scheduled run on `stream`, planned as
// sched_warp_plan plans it on the current device; returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for shapes the
// variant does not take.  fv_al is the tokens rounded down to 16 bytes and
// mis the ints it was rounded by; prog holds 3 * S + M + U ints and bits
// the thread bits of `warps` warps a stream (see sched_run_warp_kernel).
// restage = 0 runs the latency floor: the same loop with the windows
// staged once.
int sched_run_warp_launch(const int* fire, const int* bits, const int* ia,
                          const int* oa, const int* val0, const int* prog,
                          const int* fv_al, int* out_last_o,
                          int* out_count_o, int mis, int S, int M, int U,
                          int B, int A2, int n_in, int n_out, int L, int Fp,
                          int cycles, int window, int warps, int restage,
                          int ops, void* stream) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || mis < 0 || mis > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  WarpDims d{B,  A2, n_in, n_out, L,      U,      Fp,  S,
             M,  0,  0,    0,     0,      cycles, restage != 0,
             static_cast<unsigned>(ops)};
  if (!warp_plan(d, window, warps, device))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = warp_smem_bytes(d);
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = (B + d.streams - 1) / d.streams;
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, 32 * d.warps * d.streams, smem, st>>>(
        reinterpret_cast<const int2*>(fire), bits, ia, oa, val0, prog,
        fv_al, mis, out_last_o, out_count_o, d);
    return static_cast<int>(cudaGetLastError());
  };
  const int kr = Fp / (32 * d.warps);
  if (d.warps == 1) {
    if (kr == 1) return run(sched_run_warp_kernel<1, 1>);
    if (kr == 2) return run(sched_run_warp_kernel<2, 1>);
    return run(sched_run_warp_kernel<4, 1>);
  }
  if (kr == 1) return run(sched_run_warp_kernel<1, 2>);
  return run(sched_run_warp_kernel<2, 2>);
}

// Plans a slot-step launch of the warp variant on `device` (see
// slot_plan) and writes its slots a CTA into plan[0]; returns 0, or
// cudaErrorInvalidValue when the variant cannot take the shapes or one
// slot's windows do not fit a CTA.
int sched_slot_plan(int A2, int n_in, int n_out, int Fp, int K, int B,
                    int device, int* plan) {
  SlotDims d{B, A2, n_in, n_out, 1, Fp, K, 0, 0u};
  if (!slot_plan(d, device)) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = d.streams;
  return 0;
}

// Launches the warp variant of the scheduled slot step on `stream`,
// planned as sched_slot_plan plans it on the current device; returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for shapes the
// variant does not take.  fv_al is the tokens rounded down to 16 bytes and
// mis the ints it was rounded by; fire and bits are the packed tables
// (bits of one warp a stream, see sched_slot_warp_kernel).
int sched_slot_warp_launch(
    const int* fire, const int* bits, const int* ia, const int* oa,
    const int* full_t, const int* fv_al, const int* pids, const int* fsel,
    const int* full, const int* val, const int* ptr, const int* out_last,
    const int* out_count, int* full_o, int* val_o, int* ptr_o,
    int* out_last_o, int* out_count_o, int mis, int B, int K, int A2,
    int n_in, int n_out, int L, int Fp, int ops, void* stream) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || mis < 0 || mis > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  SlotDims d{B, A2, n_in, n_out, L, Fp, K, 0, static_cast<unsigned>(ops)};
  if (!slot_plan(d, device))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slot_smem_bytes(d);
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = (B + d.streams - 1) / d.streams;
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, 32 * d.streams, smem, st>>>(
        reinterpret_cast<const int2*>(fire), bits, ia, oa, full_t, fv_al,
        mis, pids, fsel, full, val, ptr, out_last, out_count, full_o, val_o,
        ptr_o, out_last_o, out_count_o, d);
    return static_cast<int>(cudaGetLastError());
  };
  const int kr = Fp / 32;
  if (kr == 1) return run(sched_slot_warp_kernel<1>);
  if (kr == 2) return run(sched_slot_warp_kernel<2>);
  return run(sched_slot_warp_kernel<4>);
}

}  // extern "C"
