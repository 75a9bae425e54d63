// Fire-block and fire-step kernels for Hopper (sm_90a): a static dataflow
// fabric, K fused feed -> fire -> drain cycles per launch, or one bare fire
// step (one warp, or one CTA for large fabrics).
//
// Replaces the TPU kernels of src/repro/kernels/dataflow_fire.py:
//   fire_block_pallas              -> _block_kernel                (:390)
//   fire_block_pallas(prof=)       -> _block_kernel_prof           (:428)
//   fire_block_batched_pallas      -> _batched_block_kernel        (:405)
//   fire_block_batched_pallas(prof=) -> _batched_block_kernel_prof (:448)
//   _ready_and_z_spec (:117), traced into the four above when the tables
//                                carry class_slices  -> kSpec instantiations
//   fire_step_pallas               -> _kernel (:196)  -> fire_step_warp_kernel
//                                     (one warp) and fire_step_kernel (one CTA)
// Two kernels compute the four block kernels and the specialized rule, in
// the same cycle order and bit for bit: fire_block_warp_kernel (one warp
// per stream, for fabrics whose every table fits in kRows rows per lane)
// and fire_block_cta_kernel (one CTA per stream, for larger fabrics).  The
// wrapper picks one by the fabric's size (dataflow_fire.block_variant).
// The single-stream entry launches them with B = 1 and every stream active
// (active == nullptr); kProf adds the five counters; kSpec takes each
// node's opcode from its bucket of an opcode-sorted plan, and kControlFree
// (no NDMERGE/DMERGE/BRANCH bucket) compiles the control cases out.  The
// plain PyTorch versions of the same functions are fire_block /
// fire_block_batched / fire_step in ../dataflow_fire.py; results are
// bit-identical.  fire_block_two_phase there replays this file's cycle
// order (lanes, reverse maps, staged windows) on the CPU.
//
// What bounds them on this card.  Neither bytes nor operations: one block
// launch moves a few KB per stream and evaluates each node once per cycle,
// microseconds of work for the whole card even at B = 1024.  What bounds a
// block is latency: the K cycles are a serial chain (each cycle's node
// phase reads what the previous cycle's arc phase wrote), so a stream
// costs K x (one cycle's chain) however small its fabric.  In the warp
// variant that chain is one lane's work on all of its rows (dot_prod n =
// 32: 2 node rows and 5 arc rows a lane), a few hundred dependent
// instructions: the barriers cost little.  The fire step is bound by its
// launch: its floor is an empty one-warp kernel (fire_empty_kernel), timed
// the same way.  Its warp variant (fire_step_warp_kernel, chosen by
// dataflow_fire.step_variant with block_variant's size rule) issues every
// load at entry, since none depends on the state, and so makes one round
// trip to device memory; the CTA variant (fire_step_kernel) makes three
// (the registers, then the node rows, then the arc rows), but spreads the
// rows over more warps.
//
// What the design does about it (the warp variant):
//   * one warp per stream: the cycle's two phases are separated by
//     __syncwarp(), never by a CTA barrier, and several streams share a
//     CTA, one warp each, without ever waiting for each other;
//   * two phases per cycle.  The node phase evaluates the fire rule on the
//     post-feed registers and stores each node's (z, cp) pair.  In the arc
//     phase the lane that owns arc i computes its next (full, val) from its
//     producer's and consumer's pairs, samples the counters (post-fire,
//     pre-drain), drains it if an output row reads it, clears it under
//     out_mask, and strobes it for the NEXT cycle from its feed row; that
//     is _env_cycle's feed (src/repro/kernels/dataflow_fire.py:333-341)
//     moved to the end of the previous cycle, where it sees the same
//     post-drain registers.  Cycle 0's feed (and the first of each staged
//     chunk) runs before the loop; the last cycle feeds nothing;
//   * tables in registers: each lane owns rows lane + 32 j (j < kRows) of
//     the node and arc tables and loads, once per launch, the shared-memory
//     offsets of each node's five operands and of each arc's producer and
//     consumer, the opcode and a word of the arc's flags; the reverse maps
//     of device_tables (arc -> its feed row, arc -> its output rows) put
//     the feed and the drain on the arc's lane; no table is read inside the
//     cycle loop;
//   * a lane's rows in groups of straight code (node rows in pairs, arc
//     rows in fours), so their loads and arithmetic overlap; the ALU
//     computes only the opcode groups some lane of the pair holds and
//     selects (alu_select), so lanes with different opcodes run one
//     instruction stream, and a group's drain and strobe run only where
//     some lane's arcs need them;
//   * no per-cycle reduction: each lane counts its own firings and the last
//     cycle in which its feed, fire or drain made progress; one warp
//     reduction at the end gives fired and last_prog;
//   * the feed window on chip: a row's pointer advances at most once a
//     cycle, so a chunk of C cycles reads at most fv[r, ptr : ptr + C]
//     (clamped to L); each lane copies its rows' windows into shared
//     memory with 16-byte cp.async at the start of every chunk, and the
//     loop reads tokens from there.
// The CTA variant keeps the same two phases, thread-local counts and staged
// windows, with __syncthreads between the phases and its tables read
// through the read-only cache.  Parked streams (active == 0) copy their
// state and counters through.
//
// Integer semantics follow jnp/numpy int32 exactly (the shared ALU of
// alu.cuh).
//
// Build: ../_build.py compiles every .cu of this directory for sm_90a and
// links them into one shared library; plain C interface for ctypes.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "alu.cuh"
#include "cp_async.cuh"
#include "fabric.cuh"

namespace {

// One bucket per opcode plus the trailing bucket of the dummy node row
// (dataflow_fire.MAX_CLASSES); device_tables() checks the class table.
constexpr int kMaxClasses = 24;
constexpr int kProfArrays = 5;   // nf, si, so [N2]; ab, ahw [A2]
// The warp variant: rows per lane of every table (dataflow_fire.WARP_ROWS
// = 32 * kRows) and streams per CTA at most.
constexpr int kRows = 8;
constexpr int kMaxStreams = 4;
constexpr int kCtaThreads = 1024;

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
  // reverse maps (CSR): the feed rows strobing arc a are
  // feed_rows[feed_ptr[a] : feed_ptr[a + 1]], its output rows
  // out_rows[out_ptr[a] : out_ptr[a + 1]]
  const int* feed_ptr;    // [A2 + 1]
  const int* feed_rows;   // [n_in]
  const int* out_ptr;     // [A2 + 1]
  const int* out_rows;    // [n_out]
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

// Shapes of a block launch.  chunk: cycles per staged feed window; window:
// ints per staged row (window_ints(chunk)); streams: warps per CTA (warp
// variant).
struct Dims {
  int B, N2, A2, n_in, n_out, L, n_cycles, n_classes, chunk, window, streams;
  unsigned ops;     // the opcodes of the fabric's nodes (alu_select)
};

__device__ __forceinline__ int prof_len(int k, int N2, int A2) {
  return k < 3 ? N2 : A2;
}

// One node's fire rule (the CTA variant and the fire step): fire_rule
// with G = 1; returns cp.
template <bool kControlFree>
__device__ __forceinline__ int fire_rule1(int op, int2 x0, int2 x1, int2 x2,
                                          int full_o0, int full_o1,
                                          unsigned ops, int* z, bool* ir) {
  const int op_[1] = {op}, o0[1] = {full_o0}, o1[1] = {full_o1};
  const int2 a[1] = {x0}, b[1] = {x1}, c[1] = {x2};
  int z_[1], cp[1], ir_[1];
  fire_rule<kControlFree, 1>(op_, a, b, c, o0, o1, ops, z_, cp, ir_);
  *z = z_[0];
  *ir = ir_[0];
  return cp[0];
}

// An arc's (full, val) after the fire, from its producer's (z, cp) pair and
// its consumer's cp word (gather only: the one-sender/one-receiver rule).
__device__ __forceinline__ int2 arc_fire(int full, int val, int ps, int cs,
                                         bool is_const, int2 pz, int ccp) {
  const bool produced = (pz.y >> (3 + ps)) & 1;
  const bool consumed = (ccp >> cs) & 1;
  return make_int2((full > 0 && !consumed) || produced || is_const,
                   produced ? pz.x : val);
}

// The opcode of row n from the class table (rows are bucketed in order).
__device__ __forceinline__ int bucket_op(const int* cls, int n_classes,
                                         int n) {
  for (int k = 0; k < n_classes; ++k)
    if (n < cls[3 * k + 2]) return cls[3 * k];
  return OP_SINK;
}

// Stages the tokens feed row r of stream b can read in the next chunk of
// cycles into s_win[r * window ...] (stage_window; mis is the ints
// feed_vals was rounded down by).  Returns the offset that maps a clamped
// feed index to its token's slot: token = s_win[offset + clamp(ptr)].
__device__ __forceinline__ int stage_row(const int* fv_al, int mis, int b,
                                         int r, int p, int fl, const Dims& d,
                                         int* s_win) {
  const long long row = mis + (static_cast<long long>(b) * d.n_in + r) * d.L;
  int off = 0;
  return stage_window(fv_al, row, p, fl, d.chunk, d.L, s_win + r * d.window,
                      &off)
             ? r * d.window + off
             : 0;                              // the row feeds nothing
}

// A parked stream's state and counters pass through; fired = last_prog =
// 0.  Threads t0, t0 + nt, ... of the stream's warp or CTA copy.
template <bool kProf>
__device__ void copy_parked(const State& s, const Dims& d, int b, int t0,
                            int nt) {
  const size_t ba = static_cast<size_t>(b) * d.A2;
  for (int i = t0; i < d.A2; i += nt) {
    s.full_o[ba + i] = s.full[ba + i];
    s.val_o[ba + i] = s.val[ba + i];
  }
  const size_t bi = static_cast<size_t>(b) * d.n_in;
  for (int i = t0; i < d.n_in; i += nt) s.ptr_o[bi + i] = s.ptr[bi + i];
  const size_t bo = static_cast<size_t>(b) * d.n_out;
  for (int i = t0; i < d.n_out; i += nt) {
    s.out_last_o[bo + i] = s.out_last[bo + i];
    s.out_count_o[bo + i] = s.out_count[bo + i];
  }
  if (kProf) {
    for (int k = 0; k < kProfArrays; ++k) {
      const int n = prof_len(k, d.N2, d.A2);
      const size_t off = static_cast<size_t>(b) * n;
      for (int i = t0; i < n; i += nt)
        s.prof_o[k][off + i] = s.prof[k][off + i];
    }
  }
  if (t0 == 0) {
    s.fired_o[b] = 0;
    s.last_prog_o[b] = 0;
  }
}

// ---------------------------------------------------------------------------
// The warp variant
// ---------------------------------------------------------------------------
// Per-stream shared memory: (full, val)[A2], (z, cp)[N2], then the staged
// windows [n_in][window], 16-byte aligned.
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}
__host__ __device__ inline size_t warp_stream_bytes(int N2, int A2, int n_in,
                                                    int window) {
  return align16(8 * static_cast<size_t>(A2)) +
         align16(8 * static_cast<size_t>(N2)) +
         4 * static_cast<size_t>(n_in) * window;
}

// An arc slot's word: the cp bits that fill it (its producer's produce
// bit, 3-4) and empty it (its consumer's consume bit, 0-2), then const,
// out_mask, read by an output row, strobed by a feed row, which writes it,
// and that row (bits 16-23).
constexpr unsigned kConst = 1u << 5, kOutMask = 1u << 6, kDrained = 1u << 7,
                   kFed = 1u << 8, kWriter = 1u << 9;

template <bool kProf, bool kSpec, bool kControlFree>
__global__ void __launch_bounds__(32 * kMaxStreams)
    fire_block_warp_kernel(Tables t, State s, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * d.streams + warp;
  if (b >= d.B) return;                  // the last CTA may be part-filled
  if (s.active != nullptr && s.active[b] == 0) {
    copy_parked<kProf>(s, d, b, lane, 32);
    return;
  }
  // byte offsets in smem of this stream's (full, val) and (z, cp) pairs
  const int fv0 =
      warp * static_cast<int>(warp_stream_bytes(d.N2, d.A2, d.n_in, d.window));
  const int zc0 = fv0 + static_cast<int>(align16(8 * d.A2));
  int* s_win = reinterpret_cast<int*>(smem + zc0 +
                                      static_cast<int>(align16(8 * d.N2)));
  // slots j < rn (ra) hold node (arc) rows on some lane: conditions on the
  // launch's arguments, so uniform branches; a lane past a table's end
  // runs the slot on row 0's offsets and stores nothing
  const int rn = (d.N2 + 31) >> 5, ra = (d.A2 + 31) >> 5;
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(s.feed_vals) >> 2) & 3);
  const int* fv_al = s.feed_vals - mis;
  const size_t bn = static_cast<size_t>(b) * d.N2;
  const size_t ba = static_cast<size_t>(b) * d.A2;
  const size_t bi = static_cast<size_t>(b) * d.n_in;

  // Rows, once per launch.  Every slot's loads go first, in one block
  // (rows past a table's end load its last row, unused), then what
  // depends on them.  Node slot: the byte offsets of its five arcs'
  // (full, val) pairs and its opcode (the opcode table's, which
  // device_tables checked equals the bucket's under kSpec).  Arc slot: the
  // offsets of its producer's and consumer's (z, cp) pairs, its word, its
  // registers, and its feed row (at most one: the warp variant's
  // condition), whose CSR position, row, pointer and length are three
  // rounds of loads.
  int nofs[kRows][5], nop[kRows];
  int nf[kRows], si[kRows], so[kRows];
  int apo[kRows], aco[kRows];
  unsigned aw[kRows];
  int full[kRows], val[kRows], ptr[kRows], fl[kRows], wofs[kRows];
  int gots[kRows], last[kRows], ab[kRows], ahw[kRows], frow[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int n = min(lane + 32 * j, d.N2 - 1);
#pragma unroll
    for (int k = 0; k < 3; ++k) nofs[j][k] = __ldg(t.in_idx + 3 * n + k);
#pragma unroll
    for (int k = 0; k < 2; ++k) nofs[j][3 + k] = __ldg(t.out_idx + 2 * n + k);
    nop[j] = __ldg(t.opcode + n);
    nf[j] = kProf ? s.prof[0][bn + n] : 0;
    si[j] = kProf ? s.prof[1][bn + n] : 0;
    so[j] = kProf ? s.prof[2][bn + n] : 0;
    const int i = min(lane + 32 * j, d.A2 - 1);
    apo[j] = __ldg(t.prod_node + i);
    aco[j] = __ldg(t.cons_node + i);
    aw[j] = 8u << __ldg(t.prod_slot + i) | 1u << __ldg(t.cons_slot + i);
    if (__ldg(t.const_mask + i) > 0) aw[j] |= kConst;
    if (__ldg(t.out_mask + i) > 0) aw[j] |= kOutMask;
    if (__ldg(t.out_ptr + i + 1) > __ldg(t.out_ptr + i)) aw[j] |= kDrained;
    const int f0 = __ldg(t.feed_ptr + i), f1 = __ldg(t.feed_ptr + i + 1);
    frow[j] = f1 > f0 ? f0 : -1;
    full[j] = s.full[ba + i];
    val[j] = s.val[ba + i];
    ab[j] = kProf ? s.prof[3][ba + i] : 0;
    ahw[j] = kProf ? s.prof[4][ba + i] : 0;
    ptr[j] = fl[j] = wofs[j] = gots[j] = last[j] = 0;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const bool av = lane + 32 * j < d.A2;
#pragma unroll
    for (int k = 0; k < 5; ++k) nofs[j][k] = fv0 + 8 * nofs[j][k];
    apo[j] = zc0 + 8 * apo[j];
    aco[j] = zc0 + 8 * aco[j];
    aw[j] = av ? aw[j] : 0u;
    frow[j] = av ? frow[j] : -1;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (frow[j] >= 0) frow[j] = __ldg(t.feed_rows + frow[j]);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (frow[j] >= 0) {
      const int r = frow[j];
      ptr[j] = s.ptr[bi + r];
      fl[j] = s.feed_len[bi + r];
      aw[j] |= kFed | static_cast<unsigned>(r) << 16;
      if (__ldg(t.env_row + lane + 32 * j) == r) aw[j] |= kWriter;
    }
  }
  const int win_last = d.n_in * d.window - 1;

  // Each phase takes its slots in groups (node slots in pairs, arc slots
  // in fours), each group one block of straight code so that its slots'
  // loads and arithmetic overlap.  A group runs when its first slot holds
  // rows on some lane (a condition on the launch's arguments, so a uniform
  // branch); a slot past a table's end runs on its offsets and stores
  // nothing.  A pair's opcode groups (nops), and a quad's drain and strobe
  // (aflags), run only when some lane's rows there need them (uniform
  // over the warp).
  int fired = 0, last_prog = 0;          // this lane's
  unsigned nops[kRows / 2], aflags[kRows / 4];
#pragma unroll
  for (int j = 0; j < kRows; j += 2) {
    const bool v0 = lane + 32 * j < d.N2, v1 = lane + 32 * (j + 1) < d.N2;
    nops[j / 2] = __reduce_or_sync(
        0xffffffffu, (v0 ? 1u << nop[j] : 0u) | (v1 ? 1u << nop[j + 1] : 0u));
  }
#pragma unroll
  for (int j = 0; j < kRows; j += 4)
    aflags[j / 4] = __reduce_or_sync(
        0xffffffffu, aw[j] | aw[j + 1] | aw[j + 2] | aw[j + 3]);

  // node phase, two slots at a time: the fire rule on the post-feed
  // registers
  auto node_pair = [&](auto first, int cyc) {
    constexpr int j0 = decltype(first)::value;
    int op[2], o0[2], o1[2], z[2], cp[2], ir[2];
    int2 x0[2], x1[2], x2[2];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = j0 + g;
      op[g] = nop[j];
      x0[g] = lds2(smem, nofs[j][0]);
      x1[g] = lds2(smem, nofs[j][1]);
      x2[g] = lds2(smem, nofs[j][2]);
      o0[g] = lds2(smem, nofs[j][3]).x;
      o1[g] = lds2(smem, nofs[j][4]).x;
    }
    fire_rule<kControlFree, 2>(op, x0, x1, x2, o0, o1, nops[j0 / 2], z, cp,
                               ir);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = j0 + g, n = lane + 32 * j;
      const bool valid = n < d.N2, fires = valid & (cp[g] != 0);
      if (valid)
        *reinterpret_cast<int2*>(smem + zc0 + 8 * n) = make_int2(z[g], cp[g]);
      fired += fires;
      last_prog = fires ? cyc + 1 : last_prog;
      if (kProf) {
        nf[j] += fires;
        si[j] += !ir[g];
        so[j] += ir[g] & (cp[g] == 0);
      }
    }
  };
  // arc phase, four slots at a time: fire, sample, drain, clear, strobe
  // for the next cycle (the chunk's last cycle leaves that to the next
  // chunk's start)
  auto arc_quad = [&](auto first, int cyc, bool feed_next) {
    constexpr int j0 = decltype(first)::value;
    const unsigned q = aflags[j0 / 4];
    int2 pz[4];
    int ccp[4], f[4], v[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      pz[g] = lds2(smem, apo[j0 + g]);
      ccp[g] = lds2(smem, aco[j0 + g]).y;
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int j = j0 + g;
      const bool produced = (pz[g].y & aw[j] & 0x18u) != 0;
      const bool consumed = (ccp[g] & aw[j] & 0x07u) != 0;
      f[g] = ((full[j] > 0) & !consumed) | produced | ((aw[j] & kConst) != 0);
      v[g] = produced ? pz[g].x : val[j];
      if (kProf) {
        ab[j] += f[g];
        ahw[j] = max(ahw[j], f[g]);
      }
    }
    if (q & (kDrained | kOutMask)) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int j = j0 + g;
        const bool got = ((aw[j] & kDrained) != 0) & (f[g] != 0);
        gots[j] += got;
        last[j] = got ? v[g] : last[j];
        last_prog = got ? max(last_prog, cyc + 1) : last_prog;
        f[g] = (aw[j] & kOutMask) != 0 ? 0 : f[g];
      }
    }
    if (feed_next & ((q & kFed) != 0)) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int j = j0 + g;
        const bool feed =
            ((aw[j] & kFed) != 0) & (f[g] == 0) & (ptr[j] < fl[j]);
        // the token's slot, clamped into the windows (a lane that does
        // not feed reads some token and drops it)
        const int tok = s_win[min(
            max(wofs[j] + clamp_index(ptr[j], d.L), 0), win_last)];
        const bool wr = feed & ((aw[j] & kWriter) != 0);
        v[g] = wr ? tok : v[g];
        f[g] = wr ? 1 : f[g];
        ptr[j] += feed;
        last_prog = feed ? cyc + 2 : last_prog;
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int j = j0 + g, i = lane + 32 * j;
      full[j] = f[g];
      val[j] = v[g];
      if (i < d.A2)
        *reinterpret_cast<int2*>(smem + fv0 + 8 * i) = make_int2(f[g], v[g]);
    }
  };

  for (int c0 = 0; c0 < d.n_cycles; c0 += d.chunk) {
    // the chunk's feed windows, staged from the pointers (each lane its
    // own rows: only it reads them), then cycle c0's feed
    const int c1 = min(c0 + d.chunk, d.n_cycles);
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < ra && (aw[j] & kWriter))
        wofs[j] = stage_row(fv_al, mis, b, static_cast<int>(aw[j] >> 16),
                            ptr[j], fl[j], d, s_win);
    cp_async_wait_all();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < ra) {
        const bool feed = (aw[j] & kFed) && full[j] == 0 && ptr[j] < fl[j];
        if (feed && (aw[j] & kWriter)) {
          val[j] = s_win[wofs[j] + clamp_index(ptr[j], d.L)];
          full[j] = 1;
        }
        ptr[j] += feed;
        last_prog = feed ? c0 + 1 : last_prog;
        if (lane + 32 * j < d.A2)
          *reinterpret_cast<int2*>(smem + fv0 + 8 * (lane + 32 * j)) =
              make_int2(full[j], val[j]);
      }
    }
    __syncwarp();

    for (int cyc = c0; cyc < c1; ++cyc) {
      node_pair(Slots<0>{}, cyc);
      if (rn > 2) node_pair(Slots<2>{}, cyc);
      if (rn > 4) node_pair(Slots<4>{}, cyc);
      if (rn > 6) node_pair(Slots<6>{}, cyc);
      __syncwarp();
      arc_quad(Slots<0>{}, cyc, cyc + 1 < c1);
      if (ra > 4) arc_quad(Slots<4>{}, cyc, cyc + 1 < c1);
      __syncwarp();
    }
  }

  fired = __reduce_add_sync(0xffffffffu, fired);
  last_prog = __reduce_max_sync(0xffffffffu, last_prog);
  if (lane == 0) {
    s.fired_o[b] = fired;
    s.last_prog_o[b] = last_prog;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int n = lane + 32 * j;
    if (kProf && j < rn && n < d.N2) {
      s.prof_o[0][bn + n] = nf[j];
      s.prof_o[1][bn + n] = si[j];
      s.prof_o[2][bn + n] = so[j];
    }
    const int i = lane + 32 * j;
    if (j < ra && i < d.A2) {
      s.full_o[ba + i] = full[j];
      s.val_o[ba + i] = val[j];
      if (kProf) {
        s.prof_o[3][ba + i] = ab[j];
        s.prof_o[4][ba + i] = ahw[j];
      }
      if (aw[j] & kFed) s.ptr_o[bi + (aw[j] >> 16)] = ptr[j];
      if (aw[j] & kDrained) {
        const size_t bo = static_cast<size_t>(b) * d.n_out;
        for (int k = __ldg(t.out_ptr + i); k < __ldg(t.out_ptr + i + 1);
             ++k) {
          const int r = __ldg(t.out_rows + k);
          s.out_count_o[bo + r] = s.out_count[bo + r] + gots[j];
          s.out_last_o[bo + r] = gots[j] ? last[j] : s.out_last[bo + r];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The CTA variant (fabrics above 32 * kRows rows in some table)
// ---------------------------------------------------------------------------
// Shared memory, in order: the staged windows [n_in][window] (16-byte
// aligned), (full, val)[A2] and (z, cp)[N2] pairs, then ints gots[A2]
// last[A2] ptr[n_in] fl[n_in] wofs[n_in], and with counters nf[N2] si[N2]
// so[N2] ab[A2] ahw[A2].
__host__ __device__ inline size_t cta_bytes(int N2, int A2, int n_in,
                                            int window, bool prof) {
  size_t ints = 2 * static_cast<size_t>(A2) + 3 * static_cast<size_t>(n_in);
  if (prof) ints += 3 * static_cast<size_t>(N2) + 2 * static_cast<size_t>(A2);
  return align16(4 * static_cast<size_t>(n_in) * window) +
         8 * (static_cast<size_t>(A2) + N2) + 4 * ints;
}
// the CTA variant's static arrays: the class table and the end-of-launch
// reduction
constexpr size_t kStaticSmemBytes = sizeof(int) * (3 * kMaxClasses + 64);

template <bool kProf, bool kSpec, bool kControlFree>
__global__ void fire_block_cta_kernel(Tables t, State s, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cls[3 * kMaxClasses];
  __shared__ int s_red[64];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  if (s.active != nullptr && s.active[b] == 0) {
    copy_parked<kProf>(s, d, b, tid, nt);
    return;
  }
  const int N2 = d.N2, A2 = d.A2, n_in = d.n_in;
  int* s_win = reinterpret_cast<int*>(smem);
  int2* s_fv = reinterpret_cast<int2*>(
      smem + align16(4 * static_cast<size_t>(n_in) * d.window));
  int2* s_zc = s_fv + A2;
  int* s_gots = reinterpret_cast<int*>(s_zc + N2);
  int* s_last = s_gots + A2;
  int* s_ptr = s_last + A2;
  int* s_fl = s_ptr + n_in;
  int* s_wofs = s_fl + n_in;
  int* s_prof[kProfArrays];
  s_prof[0] = s_wofs + n_in;
  for (int k = 1; k < kProfArrays; ++k)
    s_prof[k] = s_prof[k - 1] + prof_len(k - 1, N2, A2);
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(s.feed_vals) >> 2) & 3);
  const int* fv_al = s.feed_vals - mis;

  for (int i = tid; i < A2; i += nt) {
    const size_t o = static_cast<size_t>(b) * A2 + i;
    s_fv[i] = make_int2(s.full[o], s.val[o]);
    s_gots[i] = s_last[i] = 0;
  }
  for (int r = tid; r < n_in; r += nt) {
    s_ptr[r] = s.ptr[static_cast<size_t>(b) * n_in + r];
    s_fl[r] = s.feed_len[static_cast<size_t>(b) * n_in + r];
  }
  if (kProf) {
    for (int k = 0; k < kProfArrays; ++k) {
      const int n = prof_len(k, N2, A2);
      const size_t off = static_cast<size_t>(b) * n;
      for (int i = tid; i < n; i += nt) s_prof[k][i] = s.prof[k][off + i];
    }
  }
  if (kSpec)
    for (int i = tid; i < 3 * d.n_classes; i += nt)
      s_cls[i] = t.class_table[i];
  __syncthreads();

  // each thread strobes the feed rows of the arcs it owns, from windows
  // it staged itself; every row of an arc sees the same post-drain bit
  auto strobe = [&](int i, int& f, int& v) {
    bool prog = false;
    const int f0 = f;
    for (int k = __ldg(t.feed_ptr + i); k < __ldg(t.feed_ptr + i + 1); ++k) {
      const int r = __ldg(t.feed_rows + k);
      const int p = s_ptr[r];
      if (f0 != 0 || p >= s_fl[r]) continue;
      if (__ldg(t.env_row + i) == r) {
        v = s_win[s_wofs[r] + clamp_index(p, d.L)];
        f = 1;
      }
      s_ptr[r] = p + 1;
      prog = true;
    }
    return prog;
  };

  int fired = 0, last_prog = 0;          // this thread's
  for (int c0 = 0; c0 < d.n_cycles; c0 += d.chunk) {
    const int c1 = min(c0 + d.chunk, d.n_cycles);
    for (int i = tid; i < A2; i += nt)
      for (int k = __ldg(t.feed_ptr + i); k < __ldg(t.feed_ptr + i + 1); ++k) {
        const int r = __ldg(t.feed_rows + k);
        if (__ldg(t.env_row + i) == r)
          s_wofs[r] = stage_row(fv_al, mis, b, r, s_ptr[r], s_fl[r], d, s_win);
      }
    cp_async_wait_all();
    for (int i = tid; i < A2; i += nt) {
      int2 x = s_fv[i];
      if (strobe(i, x.x, x.y)) last_prog = c0 + 1;
      s_fv[i] = x;
    }
    __syncthreads();

    for (int cyc = c0; cyc < c1; ++cyc) {
      for (int n = tid; n < N2; n += nt) {
        const int op = kSpec ? bucket_op(s_cls, d.n_classes, n)
                             : __ldg(t.opcode + n);
        int z;
        bool ir;
        const int cp = fire_rule1<kControlFree>(
            op, s_fv[__ldg(t.in_idx + 3 * n)],
            s_fv[__ldg(t.in_idx + 3 * n + 1)],
            s_fv[__ldg(t.in_idx + 3 * n + 2)],
            s_fv[__ldg(t.out_idx + 2 * n)].x,
            s_fv[__ldg(t.out_idx + 2 * n + 1)].x, d.ops, &z, &ir);
        s_zc[n] = make_int2(z, cp);
        fired += cp != 0;
        last_prog = cp ? cyc + 1 : last_prog;
        if (kProf) {
          s_prof[0][n] += cp != 0;
          s_prof[1][n] += !ir;
          s_prof[2][n] += ir && !cp;
        }
      }
      __syncthreads();
      const bool feed_next = cyc + 1 < c1;
      for (int i = tid; i < A2; i += nt) {
        const int2 cur = s_fv[i];
        const int2 nx = arc_fire(
            cur.x, cur.y, __ldg(t.prod_slot + i), __ldg(t.cons_slot + i),
            __ldg(t.const_mask + i) > 0, s_zc[__ldg(t.prod_node + i)],
            s_zc[__ldg(t.cons_node + i)].y);
        int f = nx.x, v = nx.y;
        if (kProf) {
          s_prof[3][i] += f;
          s_prof[4][i] = max(s_prof[4][i], f);
        }
        if (f && __ldg(t.out_ptr + i + 1) > __ldg(t.out_ptr + i)) {
          ++s_gots[i];
          s_last[i] = v;
          last_prog = cyc + 1;
        }
        if (__ldg(t.out_mask + i) > 0) f = 0;
        if (feed_next && strobe(i, f, v)) last_prog = cyc + 2;
        s_fv[i] = make_int2(f, v);
      }
      __syncthreads();
    }
  }

  fired = __reduce_add_sync(0xffffffffu, fired);
  last_prog = __reduce_max_sync(0xffffffffu, last_prog);
  if ((tid & 31) == 0) {
    s_red[tid >> 5] = fired;
    s_red[32 + (tid >> 5)] = last_prog;
  }
  for (int i = tid; i < A2; i += nt) {
    const size_t o = static_cast<size_t>(b) * A2 + i;
    s.full_o[o] = s_fv[i].x;
    s.val_o[o] = s_fv[i].y;
    const size_t bo = static_cast<size_t>(b) * d.n_out;
    for (int k = __ldg(t.out_ptr + i); k < __ldg(t.out_ptr + i + 1); ++k) {
      const int r = __ldg(t.out_rows + k);
      s.out_count_o[bo + r] = s.out_count[bo + r] + s_gots[i];
      s.out_last_o[bo + r] = s_gots[i] ? s_last[i] : s.out_last[bo + r];
    }
  }
  for (int r = tid; r < n_in; r += nt)
    s.ptr_o[static_cast<size_t>(b) * n_in + r] = s_ptr[r];
  if (kProf) {
    for (int k = 0; k < kProfArrays; ++k) {
      const int n = prof_len(k, N2, A2);
      const size_t off = static_cast<size_t>(b) * n;
      for (int i = tid; i < n; i += nt) s.prof_o[k][off + i] = s_prof[k][i];
    }
  }
  __syncthreads();
  if (tid < 32) {
    const int nw = (nt + 31) >> 5;
    const int f = __reduce_add_sync(0xffffffffu, tid < nw ? s_red[tid] : 0);
    const int lp =
        __reduce_max_sync(0xffffffffu, tid < nw ? s_red[32 + tid] : 0);
    if (tid == 0) {
      s.fired_o[b] = f;
      s.last_prog_o[b] = lp;
    }
  }
}

// ---------------------------------------------------------------------------
// The fire step
// ---------------------------------------------------------------------------
// One fire step with no environment, one CTA, dense rule.  Shared memory:
// (full, val)[A2] and (z, cp)[N2] pairs.
__global__ void fire_step_kernel(Tables t, const int* full, const int* val,
                                 int* full_o, int* val_o, int* fired_o,
                                 int N2, int A2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_fired;
  int2* s_fv = reinterpret_cast<int2*>(smem);
  int2* s_zc = s_fv + A2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < A2; i += nt) s_fv[i] = make_int2(full[i], val[i]);
  if (tid == 0) s_fired = 0;
  __syncthreads();
  int nfire = 0;
  for (int n = tid; n < N2; n += nt) {
    int z;
    bool ir;
    const int cp = fire_rule1<false>(
        __ldg(t.opcode + n), s_fv[__ldg(t.in_idx + 3 * n)],
        s_fv[__ldg(t.in_idx + 3 * n + 1)], s_fv[__ldg(t.in_idx + 3 * n + 2)],
        s_fv[__ldg(t.out_idx + 2 * n)].x,
        s_fv[__ldg(t.out_idx + 2 * n + 1)].x, kOpAll, &z, &ir);
    s_zc[n] = make_int2(z, cp);
    nfire += cp != 0;
  }
  nfire = __reduce_add_sync(0xffffffffu, nfire);
  if ((tid & 31) == 0 && nfire) atomicAdd(&s_fired, nfire);
  __syncthreads();
  for (int i = tid; i < A2; i += nt) {
    const int2 nx = arc_fire(
        s_fv[i].x, s_fv[i].y, __ldg(t.prod_slot + i), __ldg(t.cons_slot + i),
        __ldg(t.const_mask + i) > 0, s_zc[__ldg(t.prod_node + i)],
        s_zc[__ldg(t.cons_node + i)].y);
    full_o[i] = nx.x;
    val_o[i] = nx.y;
  }
  if (tid == 0) fired_o[0] = s_fired;
}

// One fire step on one warp, for fabrics whose node and arc tables have at
// most 32 * kRows rows (dataflow_fire.step_variant): lane l owns node and
// arc rows l + 32 j.  Nothing the step reads depends on the state, so
// every load is issued at entry, at once: each lane's arcs' registers and,
// from the packed tables (dataflow_fire.step_words: one 16-byte word a
// node row, operand offsets and opcode; one 8-byte word an arc row,
// producer, consumer and const flag), its rows.  Packing matters: a single
// warp can keep only so many loads in flight, and the eight tables would
// take over twice the load instructions.  Then one round to shared memory:
// the registers are stored, one __syncwarp, the node phase (fire_rule:
// each node's (z, cp) pair), a second __syncwarp, and the arc phase
// (arc_fire on the lane's own registers) stores the outputs; fired is one
// warp reduction.  One trip to device memory in the chain, where the CTA
// variant makes three.  A lane's rows run in groups of straight code (node
// rows in pairs, arc rows in fours, as in the fire block's warp variant),
// so the serial work of its rows overlaps.
__global__ void __launch_bounds__(32)
    fire_step_warp_kernel(const int4* __restrict__ node,
                          const int2* __restrict__ arc, const int* full,
                          const int* val, int* full_o, int* val_o,
                          int* fired_o, int N2, int A2, unsigned ops) {
  __shared__ int2 s_fv[32 * kRows];
  __shared__ int2 s_zc[32 * kRows];
  const int lane = threadIdx.x;
  // slots j < rn (ra) hold node (arc) rows on some lane, rounded up to the
  // groups; a lane past a table's end loads its last row and stores nothing
  const int rn = ((N2 + 63) >> 6) << 1, ra = ((A2 + 127) >> 7) << 2;
  int4 nw[kRows];
  int2 aw[kRows];
  int f[kRows], v[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j < rn) nw[j] = __ldg(node + min(lane + 32 * j, N2 - 1));
    if (j < ra) {
      const int i = min(lane + 32 * j, A2 - 1);
      f[j] = full[i];
      v[j] = val[i];
      aw[j] = __ldg(arc + i);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (j < ra && lane + 32 * j < A2) s_fv[lane + 32 * j] = make_int2(f[j], v[j]);
  __syncwarp();
  int fired = 0;
  auto node_pair = [&](auto first) {
    constexpr int j0 = decltype(first)::value;
    int op[2], o0[2], o1[2], z[2], cp[2], ir[2];
    int2 x0[2], x1[2], x2[2];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int4 w = nw[j0 + g];
      op[g] = w.z >> 16;
      x0[g] = s_fv[w.x & 0xffff];
      x1[g] = s_fv[w.x >> 16];
      x2[g] = s_fv[w.y & 0xffff];
      o0[g] = s_fv[w.y >> 16].x;
      o1[g] = s_fv[w.z & 0xffff].x;
    }
    fire_rule<false, 2>(op, x0, x1, x2, o0, o1, ops, z, cp, ir);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = lane + 32 * (j0 + g);
      if (n < N2) {
        s_zc[n] = make_int2(z[g], cp[g]);
        fired += cp[g] != 0;
      }
    }
  };
  auto arc_quad = [&](auto first) {
    constexpr int j0 = decltype(first)::value;
    int2 pz[4];
    int ccp[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      pz[g] = s_zc[aw[j0 + g].x & 0xffff];
      ccp[g] = s_zc[aw[j0 + g].y & 0xffff].y;
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int j = j0 + g, i = lane + 32 * j;
      const int2 nx = arc_fire(f[j], v[j], aw[j].x >> 16,
                               (aw[j].y >> 16) & 0xff, (aw[j].y >> 24) & 1,
                               pz[g], ccp[g]);
      if (i < A2) {
        full_o[i] = nx.x;
        val_o[i] = nx.y;
      }
    }
  };
  node_pair(Slots<0>{});
  if (rn > 2) node_pair(Slots<2>{});
  if (rn > 4) node_pair(Slots<4>{});
  if (rn > 6) node_pair(Slots<6>{});
  __syncwarp();
  arc_quad(Slots<0>{});
  if (ra > 4) arc_quad(Slots<4>{});
  fired = __reduce_add_sync(0xffffffffu, fired);
  if (lane == 0) fired_o[0] = fired;
}

// An empty kernel of one warp: the fire step's floor, a launch that does
// nothing, timed as the fire step is.
__global__ void fire_empty_kernel() {}

// ---------------------------------------------------------------------------
// The latency floor
// ---------------------------------------------------------------------------
// The warp variant's dependent chain with no table work, for timing: one
// warp, n_cycles iterations of a node phase (five independent (full, val)
// loads at addresses held in registers, the rule's arithmetic, one (z, cp)
// store), __syncwarp, an arc phase (two independent (z, cp) loads, one
// (full, val) store), __syncwarp.  One lane per node and arc: the least a
// cycle of the warp variant can take.
__global__ void fire_floor_kernel(int* out, int n_cycles) {
  __shared__ int2 s_fv[64];
  __shared__ int2 s_zc[32];
  const int lane = threadIdx.x & 31;
  const int i0 = (5 * lane + 1) & 63, i1 = (7 * lane + 2) & 63;
  const int i2 = (11 * lane + 3) & 63, o0 = (13 * lane + 4) & 63;
  const int o1 = (3 * lane + 5) & 63;
  const int pn = (9 * lane + 7) & 31, cn = (17 * lane + 1) & 31;
  int full = lane & 1, val = lane;
  s_fv[lane] = make_int2(full, val);
  s_fv[lane + 32] = make_int2(lane & 2, -lane);
  __syncwarp();
  for (int cyc = 0; cyc < n_cycles; ++cyc) {
    const int2 a = s_fv[i0], bb = s_fv[i1], c = s_fv[i2];
    const int e0 = s_fv[o0].x, e1 = s_fv[o1].x;
    const bool ready = a.x > 0 && bb.x > 0 && c.x > 0 && e0 == 0 && e1 == 0;
    s_zc[lane] = make_int2(a.y + bb.y, ready ? 31 : 0);
    __syncwarp();
    const int2 pz = s_zc[pn];
    const int ccp = s_zc[cn].y;
    const bool produced = (pz.y >> 3) & 1, consumed = ccp & 1;
    full = (full > 0 && !consumed) || produced;
    val = produced ? pz.x : val;
    s_fv[lane] = make_int2(full, val);
    __syncwarp();
  }
  out[lane] = full + val;
}

int cta_threads(int n) {
  return std::min(kCtaThreads, (std::max(n, 1) + 31) / 32 * 32);
}

template <typename Kernel>
int launch(Kernel kernel, int grid, int threads, size_t smem,
           cudaStream_t stream, const Tables& t, const State& s,
           const Dims& d) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(t, s, d);
  return static_cast<int>(cudaGetLastError());
}

template <bool kProf, bool kSpec, bool kControlFree>
int launch_block(const Tables& t, const State& s, const Dims& d, bool warp,
                 cudaStream_t stream) {
  if (warp) {
    const size_t smem =
        d.streams * warp_stream_bytes(d.N2, d.A2, d.n_in, d.window);
    return launch(fire_block_warp_kernel<kProf, kSpec, kControlFree>,
                  (d.B + d.streams - 1) / d.streams, 32 * d.streams, smem,
                  stream, t, s, d);
  }
  const int threads = cta_threads(std::max(std::max(d.N2, d.A2),
                                           std::max(d.n_in, d.n_out)));
  return launch(fire_block_cta_kernel<kProf, kSpec, kControlFree>, d.B,
                threads, cta_bytes(d.N2, d.A2, d.n_in, d.window, kProf),
                stream, t, s, d);
}

}  // namespace

extern "C" {

// Launches a fire-block kernel on `stream`; returns cudaGetLastError() (0 =
// ok).  class_table == nullptr selects the dense rule, prof == nullptr (all
// five) the unprofiled instantiation; control_free must be 1 only when no
// bucket of class_table holds NDMERGE, DMERGE or BRANCH; bit k of ops is set
// when some node has opcode k.  variant 0 is the
// warp variant (every table at most 32 * kRows rows, at most one feed row
// per arc, streams warps per CTA), 1 the CTA variant; chunk is the cycles
// per staged feed window and window the ints per staged row.
int fire_block_launch(
    const int* opcode, const int* in_idx, const int* out_idx,
    const int* prod_node, const int* prod_slot, const int* cons_node,
    const int* cons_slot, const int* const_mask, const int* env_row,
    const int* in_arc_idx, const int* out_arc_idx, const int* out_mask,
    const int* class_table, const int* feed_ptr, const int* feed_rows,
    const int* out_ptr, const int* out_rows, const int* feed_vals,
    const int* feed_len, const int* full, const int* val, const int* ptr,
    const int* out_last, const int* out_count, const int* active,
    const int* nf, const int* si, const int* so, const int* ab,
    const int* ahw, int* full_o, int* val_o, int* ptr_o, int* out_last_o,
    int* out_count_o, int* fired_o, int* last_prog_o, int* nf_o, int* si_o,
    int* so_o, int* ab_o, int* ahw_o, int B, int N2, int A2, int n_in,
    int n_out, int L, int n_cycles, int n_classes, int control_free,
    int ops, int variant, int chunk, int window, int streams,
    void* stream) {
  if (class_table != nullptr && (n_classes < 1 || n_classes > kMaxClasses))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool warp = variant == 0;
  if (chunk < 1 || window < 4 * (((chunk + 2) >> 2) + 1) || window % 4 ||
      (warp && (std::max(std::max(N2, A2), std::max(n_in, n_out)) >
                    32 * kRows ||
                streams < 1 || streams > kMaxStreams)))
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t{opcode,    in_idx,      out_idx,     prod_node,  prod_slot,
           cons_node, cons_slot,   const_mask,  env_row,    in_arc_idx,
           out_arc_idx, out_mask,  class_table, feed_ptr,   feed_rows,
           out_ptr,   out_rows};
  State s{feed_vals, feed_len, full, val, ptr, out_last, out_count, active,
          {nf, si, so, ab, ahw}, full_o, val_o, ptr_o, out_last_o,
          out_count_o, fired_o, last_prog_o,
          {nf_o, si_o, so_o, ab_o, ahw_o}};
  const Dims d{B,         N2,     A2,     n_in,    n_out,
               L,         n_cycles, n_classes, chunk, window,
               warp ? streams : 1, static_cast<unsigned>(ops)};
  const bool prof = nf != nullptr;
  const bool spec = class_table != nullptr;
  const bool cf = spec && control_free != 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define FIRE_BLOCK_LAUNCH(P, S, C) launch_block<P, S, C>(t, s, d, warp, st)
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
  Tables t{opcode,    in_idx,    out_idx,    prod_node, prod_slot, cons_node,
           cons_slot, const_mask, nullptr,   nullptr,   nullptr,   nullptr,
           nullptr,   nullptr,   nullptr,    nullptr,   nullptr};
  const size_t smem = 8 * (static_cast<size_t>(A2) + N2);
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

// Launches the fire step's warp variant (one warp) on `stream` over the
// packed tables (node [N2] int4, arc [A2] int2: dataflow_fire.step_words);
// returns cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for a table
// past 32 * kRows rows.  Bit k of ops is set when some node has opcode k.
int fire_step_warp_launch(const int* node, const int* arc, const int* full,
                          const int* val, int* full_o, int* val_o,
                          int* fired_o, int N2, int A2, int ops,
                          void* stream) {
  if (N2 < 1 || A2 < 1 || std::max(N2, A2) > 32 * kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  fire_step_warp_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(node), reinterpret_cast<const int2*>(arc),
      full, val, full_o, val_o, fired_o, N2, A2, static_cast<unsigned>(ops));
  return static_cast<int>(cudaGetLastError());
}

// Launches the empty one-warp kernel (the fire step's floor) on `stream`.
int fire_empty_launch(void* stream) {
  fire_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Launches the latency-floor kernel (one warp) on `stream`.
int fire_floor_launch(int* out, int n_cycles, void* stream) {
  fire_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n_cycles);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one CTA of a fire-block kernel needs, in bytes: variant 0
// (warp) per stream (a CTA of S streams needs S times it), variant 1 (CTA)
// dynamic and static together; variant 2 the fire step.  window: ints per
// staged feed row.
int fire_block_smem_bytes(int N2, int A2, int n_in, int prof, int variant,
                          int window) {
  if (variant == 0)
    return static_cast<int>(warp_stream_bytes(N2, A2, n_in, window));
  if (variant == 1)
    return static_cast<int>(cta_bytes(N2, A2, n_in, window, prof != 0) +
                            kStaticSmemBytes);
  return static_cast<int>(8 * (static_cast<size_t>(A2) + N2));
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
