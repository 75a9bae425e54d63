// The sharded block kernel for Hopper (sm_90a): K lockstep cycles of a
// fabric partitioned into P regions (DESIGN.md §14), every stream of a
// batch in one launch.
//
// Replaces no Pallas kernel.  The JAX package runs a sharded block as a
// jnp program, MultiFabric._core_fn (src/repro/core/multifabric.py:285):
// lax.fori_loop over the block's cycles, the regions under vmap or
// shard_map, and one lax.psum a cycle for the channel merge, which XLA
// compiles into one dispatch per block.  This kernel is the port's
// counterpart on the "cuda" backend: one launch per block, bit for bit the
// plain PyTorch version mf_block in ../multifabric.py.
//
// Layout.  The P regions' arc registers are one flat register file per
// stream: region r owns slots r * A2m .. r * A2m + A2m - 1 (its own plan's
// arcs, FULL_PAD, EMPTY_PAD, then unused pad slots) and node rows
// r * N2m .. r * N2m + N2m - 1 (its plan's nodes, the dummy row, pad rows
// that never fire).  A cut arc has two slots, its producer region's
// out-copy and its consumer region's in-copy, and one channel register
// (chf, chv).  Feed rows, pointers and output rows are the whole graph's,
// each owned by the slot of its arc.
//
// One cycle, as MultiFabric._core_fn's cycle1:
//   1. mirror: both copies of every channel hold the channel register;
//   2. feed the environment's input arcs;
//   3. fire every ready node on the post-feed registers (the generic fire
//      rule; the ALU selects among the opcodes present);
//   4. channel deltas: the out-copy's region reports a push
//      (~cf & full[out-copy], with its value), the in-copy's region a
//      consume (cf & ~full[in-copy]);
//   5. drain the output arcs;
//   6. merge: full' = (full & ~consumed) | pushed, the value overwritten
//      only by a push; the cycle made progress when any region fed, fired
//      or drained.
// A parked stream (active == 0) does nothing: its state and counters stay
// where they are (the launch updates in place) and fired = last_prog = 0.
//
// What bounds it on this card.  Neither bytes nor operations: a block moves
// a few KB per stream.  Like the solo fire block, the K cycles are a serial
// chain of dependent shared-memory round trips, so a stream costs K times
// one cycle's chain; a sharded cycle adds a CTA barrier, since every
// region must see every channel's merged register before the next cycle.
//
// What the design does about it:
//   * one CTA per stream and one warp per region (32 P threads, P <= 32):
//     within a region the cycle's phases are separated by __syncwarp(),
//     never by a CTA barrier;
//   * each lane owns rows lane + 32 j (j < kRows) of its region's node and
//     arc tables, loaded once per launch as packed words
//     (multifabric.kernel_words); an arc slot's (full, val) lives in the
//     lane's registers between cycles and is published to shared memory
//     for the node phase;
//   * one CTA barrier a cycle: __syncthreads_or both publishes the
//     regions' channel deltas and ORs the progress bits.  Both endpoint
//     lanes of a channel then apply the merge themselves (the copies stay
//     equal, as the JAX package's replicated registers do), so no second
//     barrier is needed; the deltas are double-buffered by the cycle's
//     parity, since a warp may run into the next cycle while another still
//     reads this cycle's deltas;
//   * feed pointers, output accumulators and (profiled) counters sit in
//     shared memory, each word owned by one lane.
// The design keeps it simple: no staged feed windows (a feed reads its
// token from device memory), no opcode-class specialisation.
//
// Integer semantics follow jnp/numpy int32 exactly (the shared ALU of
// alu.cuh).  Build: ../_build.py; plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "alu.cuh"

namespace {

// Rows per lane of a region's node and arc tables (multifabric.REGION_ROWS
// = 32 * kRows) and regions per CTA at most (multifabric.MAX_REGIONS).
constexpr int kRows = 8;
constexpr int kMaxRegions = 32;
// Launches of at most this many regions take the instantiation with room
// for 255 registers a thread.
constexpr int kFewRegions = 8;

// An arc slot's flag word (multifabric.kernel_words): the consume bit of its
// consumer's cp word (bits 0-2) and the produce bit of its producer's (bits
// 3-4), then the flags below, and in bits 16-31 its feed row, output row or
// channel (at most one applies).
constexpr unsigned kConst = 1u << 5, kOcc = 1u << 6, kChIn = 1u << 7,
                   kChOut = 1u << 8, kFed = 1u << 9, kDrained = 1u << 10;
constexpr unsigned kChannel = kChIn | kChOut;

struct Tables {
  const int* node;    // [P * N2m, 3]: in0 | in1 << 16, in2 | out0 << 16,
                      // out1 | opcode << 16 (flat slots)
  const int* arc;     // [P * A2m, 2]: prod | cons << 16 (flat node rows),
                      // the flag word
};

struct State {
  const int* fv;      // [B, n_in, L]
  const int* fl;      // [B, n_in]
  const int* active;  // [B] or nullptr (all active)
  int* full;          // [B, P * A2m], updated in place
  int* val;           // [B, P * A2m]
  int* ptr;           // [B, n_in]
  int* out_last;      // [B, n_out]
  int* out_count;     // [B, n_out]
  int* chf;           // [B, Cp]
  int* chv;           // [B, Cp]
  int* prof[5];       // nf, si, so [B, P * N2m]; ab, ahw [B, P * A2m]
  int* chprof[3];     // busy, high water, pushes [B, Cp]
  int* fired;         // [B]
  int* last_prog;     // [B]
};

struct Dims {
  int B, P, N2m, A2m, n_in, n_out, L, Cp, n_cycles;
  unsigned ops;       // bit k: some node has opcode k (alu_select)
};

// Shared memory of one CTA, in ints: (full, val)[P A2m] and (z, cp)[P N2m]
// pairs, the channel deltas [2][3][Cp], ptr, fl [n_in], gots, last
// [n_out], the fired total, and with counters nf, si, so [P N2m], ab, ahw
// [P A2m], busy, high water, pushes [Cp].
__host__ __device__ inline size_t smem_ints(const Dims& d, bool prof) {
  const size_t PA = static_cast<size_t>(d.P) * d.A2m;
  const size_t PN = static_cast<size_t>(d.P) * d.N2m;
  size_t n = 2 * (PA + PN) + 6 * static_cast<size_t>(d.Cp) +
             2 * static_cast<size_t>(d.n_in) + 2 * static_cast<size_t>(d.n_out) +
             1;
  if (prof) n += 3 * PN + 2 * PA + 3 * static_cast<size_t>(d.Cp);
  return n;
}

// One node's fire rule on the (full, val) pairs of its three input arcs
// x0..x2 and the full bits of its two output arcs: returns its cp word
// (consume bits 0..2, one per input slot, and produce bits 3..4, one per
// output slot, if it fires; 0 if not), sets z, its ALU result (the merges
// pick an input), and ir, whether its (selected) inputs are present.  The
// rule of dataflow_fire.cu's fire_rule, for one node.
__device__ __forceinline__ int fire_rule(int op, int2 x0, int2 x1, int2 x2,
                                         int full_o0, int full_o1,
                                         unsigned ops, int* z, bool* ir) {
  const int op_[1] = {op}, a[1] = {x0.y}, bv[1] = {x1.y};
  int z_[1];
  alu_select(op_, a, bv, z_, ops);
  const bool in0 = x0.x > 0, in1 = x1.x > 0, in2 = x2.x > 0;
  const bool oe0 = full_o0 == 0, oe1 = full_o1 == 0;
  const bool all_in = in0 & in1 & in2, all_out = oe0 & oe1;
  if (!(ops & kOpControl)) {
    *z = z_[0];
    *ir = all_in;
    return all_in & all_out ? 31 : 0;  // consume all, produce both
  }
  const bool nd = op == OP_NDMERGE, dm = op == OP_DMERGE;
  const bool br = op == OP_BRANCH, c3 = x2.y != 0, c2 = x1.y != 0;
  // BRANCH takes all inputs (in2 is the always-full pad) and needs only
  // its chosen output empty
  const bool r_in = nd ? in0 | in1 : dm ? in2 & (c3 ? in0 : in1) : all_in;
  const bool ready = br ? in0 & in1 & (c2 ? oe0 : oe1) : r_in & all_out;
  const int cons = nd ? (in0 ? 1 : 2) : dm ? (c3 ? 5 : 6) : 7;
  const int prod = br ? (c2 ? 1 : 2) : 3;
  *ir = r_in;
  *z = nd ? (in0 ? x0.y : x1.y) : dm ? (c3 ? x0.y : x1.y) : z_[0];
  return ready ? cons | prod << 3 : 0;
}

// kWarps: the most regions (warps) a launch of this instantiation takes;
// it bounds the registers a thread may use (8 warps: up to 255, 32: 64).
template <bool kProf, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
    mf_block_kernel(Tables t, State s, Dims d) {
  extern __shared__ __align__(16) int smem[];
  const int PA = d.P * d.A2m, PN = d.P * d.N2m;
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  if (s.active != nullptr && s.active[b] == 0) {
    if (threadIdx.x == 0) {
      s.fired[b] = 0;
      s.last_prog[b] = 0;
    }
    return;                        // the whole CTA: no barrier is reached
  }
  int2* regs = reinterpret_cast<int2*>(smem);          // [PA] (full, val)
  int2* zc = regs + PA;                                // [PN] (z, cp)
  int* chbuf = reinterpret_cast<int*>(zc + PN);        // [2][3][Cp]
  int* ptr_s = chbuf + 6 * d.Cp;
  int* fl_s = ptr_s + d.n_in;
  int* got_s = fl_s + d.n_in;
  int* last_s = got_s + d.n_out;
  int* fired_s = last_s + d.n_out;
  int* nf_s = fired_s + 1;                             // kProf only
  int* si_s = nf_s + PN;
  int* so_s = si_s + PN;
  int* ab_s = so_s + PN;
  int* ahw_s = ab_s + PA;
  int* cb_s = ahw_s + PA;
  int* chw_s = cb_s + d.Cp;
  int* cpu_s = chw_s + d.Cp;

  const size_t bA = static_cast<size_t>(b) * PA;
  const size_t bN = static_cast<size_t>(b) * PN;
  const size_t bI = static_cast<size_t>(b) * d.n_in;
  const size_t bO = static_cast<size_t>(b) * d.n_out;
  const size_t bC = static_cast<size_t>(b) * d.Cp;
  for (int i = threadIdx.x; i < d.n_in; i += blockDim.x) {
    ptr_s[i] = s.ptr[bI + i];
    fl_s[i] = s.fl[bI + i];
  }
  for (int i = threadIdx.x; i < d.n_out; i += blockDim.x) {
    got_s[i] = 0;
    last_s[i] = s.out_last[bO + i];
  }
  if (threadIdx.x == 0) *fired_s = 0;
  if (kProf) {
    for (int i = threadIdx.x; i < PN; i += blockDim.x) {
      nf_s[i] = s.prof[0][bN + i];
      si_s[i] = s.prof[1][bN + i];
      so_s[i] = s.prof[2][bN + i];
    }
    for (int i = threadIdx.x; i < PA; i += blockDim.x) {
      ab_s[i] = s.prof[3][bA + i];
      ahw_s[i] = s.prof[4][bA + i];
    }
    for (int i = threadIdx.x; i < d.Cp; i += blockDim.x) {
      cb_s[i] = s.chprof[0][bC + i];
      chw_s[i] = s.chprof[1][bC + i];
      cpu_s[i] = s.chprof[2][bC + i];
    }
  }

  // This lane's rows of its region: slots j < rn (ra) hold node (arc) rows
  // on some lane (uniform branches); a lane past the table's end runs the
  // slot on the last row and stores nothing.  A channel slot's registers
  // start from the channel register (the mirror).
  const int rn = (d.N2m + 31) >> 5, ra = (d.A2m + 31) >> 5;
  unsigned nw0[kRows], nw1[kRows], nw2[kRows], aw0[kRows], aw1[kRows];
  int full[kRows], val[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int n = r * d.N2m + min(lane + 32 * j, d.N2m - 1);
    nw0[j] = __ldg(t.node + 3 * n);
    nw1[j] = __ldg(t.node + 3 * n + 1);
    nw2[j] = __ldg(t.node + 3 * n + 2);
    const bool av = lane + 32 * j < d.A2m;
    const int i = r * d.A2m + min(lane + 32 * j, d.A2m - 1);
    aw0[j] = __ldg(t.arc + 2 * i);
    aw1[j] = av ? static_cast<unsigned>(__ldg(t.arc + 2 * i + 1)) : 0u;
    if (aw1[j] & kChannel) {
      full[j] = s.chf[bC + (aw1[j] >> 16)];
      val[j] = s.chv[bC + (aw1[j] >> 16)];
    } else {
      full[j] = s.full[bA + i];
      val[j] = s.val[bA + i];
    }
  }
  __syncthreads();

  int fired = 0, last_prog = 0;
  for (int cyc = 0; cyc < d.n_cycles; ++cyc) {
    int* push = chbuf + (cyc & 1) * 3 * d.Cp;
    int* pushv = push + d.Cp;
    int* consd = pushv + d.Cp;
    bool prog = false;
    // 1-2. feed (channel slots already hold the channel register), then
    // publish the registers for the node phase
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < ra) {
        if (aw1[j] & kFed) {
          const int k = aw1[j] >> 16, p = ptr_s[k];
          if (full[j] == 0 && p < fl_s[k]) {
            val[j] = __ldg(s.fv + (bI + k) * d.L + p);
            full[j] = 1;
            ptr_s[k] = p + 1;
            prog = true;
          }
        }
        const int i = lane + 32 * j;
        if (i < d.A2m) regs[r * d.A2m + i] = make_int2(full[j], val[j]);
      }
    }
    __syncwarp();
    // 3. the node phase: every node's (z, cp) on the post-feed registers
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < rn) {
        const int2 x0 = regs[nw0[j] & 0xffffu], x1 = regs[nw0[j] >> 16];
        const int2 x2 = regs[nw1[j] & 0xffffu];
        const int o0 = regs[nw1[j] >> 16].x, o1 = regs[nw2[j] & 0xffffu].x;
        int z;
        bool ir;
        const int cp = fire_rule(static_cast<int>(nw2[j] >> 16), x0, x1, x2,
                                 o0, o1, d.ops, &z, &ir);
        const int n = lane + 32 * j;
        if (n < d.N2m) {
          const int fn = r * d.N2m + n;
          zc[fn] = make_int2(z, cp);
          const bool fires = cp != 0;
          fired += fires;
          prog |= fires;
          if (kProf) {
            nf_s[fn] += fires;
            si_s[fn] += !ir;
            so_s[fn] += ir & !fires;
          }
        }
      }
    }
    __syncwarp();
    // 3-5. the arc phase: each slot's state after the fire (gather from
    // its producer's and consumer's cp words), the channel deltas, the
    // counters (post-fire, pre-drain) and the drain
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < ra) {
        const unsigned w = aw1[j];
        const int2 pz = zc[aw0[j] & 0xffffu];
        const int ccp = zc[aw0[j] >> 16].y;
        const bool produced = (static_cast<unsigned>(pz.y) & w & 0x18u) != 0;
        const bool consumed = (static_cast<unsigned>(ccp) & w & 0x07u) != 0;
        int f = ((full[j] > 0) & !consumed) | produced | ((w & kConst) != 0);
        const int v = produced ? pz.x : val[j];
        const int c = static_cast<int>(w >> 16);
        if (w & kChOut) {
          push[c] = (full[j] == 0) & f;
          pushv[c] = v;
        } else if (w & kChIn) {
          consd[c] = (full[j] != 0) & !f;
        } else {
          const int i = lane + 32 * j;
          if (kProf && (w & kOcc)) {
            ab_s[r * d.A2m + i] += f;
            ahw_s[r * d.A2m + i] = max(ahw_s[r * d.A2m + i], f);
          }
          if (w & kDrained) {
            if (f) {
              got_s[c] += 1;
              last_s[c] = v;
              prog = true;
            }
            f = 0;
          }
          full[j] = f;
          val[j] = v;
        }
      }
    }
    // the deltas of every region are published; any region's progress is
    // the cycle's
    if (__syncthreads_or(prog)) last_prog = cyc + 1;
    // 6. the merge, on both endpoint lanes of every channel
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < ra && (aw1[j] & kChannel)) {
        const int c = static_cast<int>(aw1[j] >> 16);
        const int p = push[c];
        const int f2 = ((full[j] != 0) & (consd[c] == 0)) | (p != 0);
        if (p) val[j] = pushv[c];
        full[j] = f2;
        if (kProf && (aw1[j] & kChOut)) {
          cb_s[c] += f2;
          chw_s[c] = max(chw_s[c], f2);
          cpu_s[c] += p != 0;
        }
      }
    }
  }

  fired = __reduce_add_sync(0xffffffffu, fired);
  if (lane == 0) atomicAdd(fired_s, fired);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int i = lane + 32 * j;
    if (j < ra && i < d.A2m) {
      s.full[bA + r * d.A2m + i] = full[j];
      s.val[bA + r * d.A2m + i] = val[j];
      if (aw1[j] & kChOut) {
        s.chf[bC + (aw1[j] >> 16)] = full[j];
        s.chv[bC + (aw1[j] >> 16)] = val[j];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d.n_in; i += blockDim.x)
    s.ptr[bI + i] = ptr_s[i];
  for (int i = threadIdx.x; i < d.n_out; i += blockDim.x) {
    s.out_count[bO + i] += got_s[i];
    s.out_last[bO + i] = last_s[i];
  }
  if (kProf) {
    for (int i = threadIdx.x; i < PN; i += blockDim.x) {
      s.prof[0][bN + i] = nf_s[i];
      s.prof[1][bN + i] = si_s[i];
      s.prof[2][bN + i] = so_s[i];
    }
    for (int i = threadIdx.x; i < PA; i += blockDim.x) {
      s.prof[3][bA + i] = ab_s[i];
      s.prof[4][bA + i] = ahw_s[i];
    }
    for (int i = threadIdx.x; i < d.Cp; i += blockDim.x) {
      s.chprof[0][bC + i] = cb_s[i];
      s.chprof[1][bC + i] = chw_s[i];
      s.chprof[2][bC + i] = cpu_s[i];
    }
  }
  if (threadIdx.x == 0) {
    s.fired[b] = *fired_s;
    s.last_prog[b] = last_prog;
  }
}

template <bool kProf, int kWarps>
int launch(const Tables& t, const State& s, const Dims& d,
           cudaStream_t stream) {
  const size_t smem = 4 * smem_ints(d, kProf);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mf_block_kernel<kProf, kWarps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mf_block_kernel<kProf, kWarps><<<d.B, 32 * d.P, smem, stream>>>(t, s, d);
  return static_cast<int>(cudaGetLastError());
}

template <bool kProf>
int launch_regions(const Tables& t, const State& s, const Dims& d,
                   cudaStream_t stream) {
  return d.P <= kFewRegions ? launch<kProf, kFewRegions>(t, s, d, stream)
                            : launch<kProf, kMaxRegions>(t, s, d, stream);
}

}  // namespace

extern "C" {

// Launches the sharded block kernel on `stream` (one CTA of 32 P threads
// per stream); returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue past the kernel's limits (P <= 32 regions, at most
// 32 * kRows node rows and arc slots a region).  nf == nullptr selects the
// unprofiled instantiation.  The state arrays are updated in place.
int mf_block_launch(const int* node, const int* arc, const int* fv,
                    const int* fl, const int* active, int* full, int* val,
                    int* ptr, int* out_last, int* out_count, int* chf,
                    int* chv, int* nf, int* si, int* so, int* ab, int* ahw,
                    int* cb, int* chw, int* cpu, int* fired, int* last_prog,
                    int B, int P, int N2m, int A2m, int n_in, int n_out,
                    int L, int Cp, int n_cycles, int ops, void* stream) {
  if (B < 1 || P < 1 || P > kMaxRegions || N2m < 1 || A2m < 1 ||
      N2m > 32 * kRows || A2m > 32 * kRows || n_in < 1 || n_out < 1 ||
      L < 1 || Cp < 1 || n_cycles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{node, arc};
  const State s{fv,      fl,  active, full, val, ptr, out_last, out_count,
                chf,     chv, {nf, si, so, ab, ahw}, {cb, chw, cpu},
                fired,   last_prog};
  const Dims d{B, P, N2m, A2m, n_in, n_out, L, Cp, n_cycles,
               static_cast<unsigned>(ops)};
  const auto st = static_cast<cudaStream_t>(stream);
  return nf != nullptr ? launch_regions<true>(t, s, d, st)
                       : launch_regions<false>(t, s, d, st);
}

// Shared memory one CTA of the kernel needs, in bytes.
int mf_block_smem_bytes(int P, int N2m, int A2m, int n_in, int n_out, int Cp,
                        int prof) {
  const Dims d{1, P, N2m, A2m, n_in, n_out, 1, Cp, 0, 0u};
  return static_cast<int>(4 * smem_ints(d, prof != 0));
}

}  // extern "C"
