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
// One cycle, as MultiFabric._core_fn's cycle1: (1) mirror: both copies of
// every channel hold the channel register; (2) feed the environment's
// input arcs; (3) fire every ready node on the post-feed registers (the
// generic fire rule; the ALU selects among the opcodes present); (4)
// channel deltas: the out-copy's region reports a push (~cf &
// full[out-copy]), the in-copy's region a consume (cf & ~full[in-copy]);
// (5) drain the output arcs; (6) merge: cf' = (cf & ~consumed) | pushed,
// the value overwritten only by a push.  The cycle made progress when any
// region fed, fired or drained.  A parked stream (active == 0) does
// nothing: its state and counters stay where they are (the launch updates
// in place) and fired = last_prog = 0.
//
// What bounds it on this card.  Neither bytes nor operations: a block moves
// a few KB per stream.  The K cycles are a serial chain (each cycle's node
// phase reads what the previous cycle's arc phase wrote), so a stream
// costs K times one cycle's chain; the latency floor is one stream alone
// (B = 1).  The solo fire block (dataflow_fire.cu) met the same chain and
// this kernel takes its design:
//   * the merge is folded into the arc phase.  kernel_words gives both
//     copies of a channel the channel's real producer (the out-copy's) and
//     real consumer (the in-copy's), so each endpoint lane computes the
//     channel's next register from the two (z, cp) pairs as an uncut arc's
//     lane does: (cf & ~consumed) | produced.  That equals step 6, because
//     a node produces only into an empty output (produced implies cf = 0),
//     so the copies stay equal without exchanging deltas;
//   * the warp variant (mf_variant "warp": P N2m and P A2m at most 32 kR):
//     all P regions of a stream in one warp's lanes, 4 streams a CTA; the
//     cycle's two phases are separated by __syncwarp(), never by a CTA
//     barrier;
//   * the CTA variant (larger regions): one CTA per stream, one warp per
//     region (each lane rows lane + 32 j of its region).  A channel's lanes
//     read the other region's (z, cp) pair, so the node phase ends in one
//     CTA barrier a cycle; the (z, cp) pairs are double-buffered by the
//     cycle's parity, so no second barrier is needed;
//   * the feed window on chip: a row's pointer advances at most once a
//     cycle, so a chunk of C cycles reads at most fv[r, ptr : ptr + C]
//     (clamped to L); the lane of each feed slot copies its row's window
//     into shared memory with 16-byte cp.async at every chunk's start, and
//     the feed reads tokens from there.  The feed is strobed at the end of
//     the previous cycle's arc phase, where it sees the same post-drain
//     registers (a chunk's first feed runs before its loop);
//   * tables in registers, rows a lane (kR = 2, 4 or 8) by the fabric's
//     size, loaded once per launch with the operands' shared-memory byte
//     offsets; feed pointers, output accumulators and counters live in
//     their slot's lane (a channel's counters in its out-copy's), and
//     fired / last_prog are kept a lane and reduced once at the end;
//   * a lane's rows in groups of straight code (node rows in pairs, arc
//     slots in fours) whose loads overlap; the ALU computes the opcode
//     groups some lane of a pair holds (alu_select).
//
// Integer semantics follow jnp/numpy int32 exactly (the shared ALU of
// alu.cuh).  Build: ../_build.py; plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "alu.cuh"
#include "cp_async.cuh"
#include "fabric.cuh"

namespace {

// Regions a CTA (CTA variant) and rows a region at most
// (multifabric.MAX_REGIONS, multifabric.REGION_ROWS = 32 * kMaxRows);
// streams a CTA (warp variant, multifabric.MAX_STREAMS).
constexpr int kMaxRegions = 32;
constexpr int kMaxRows = 8;
constexpr int kMaxStreams = 4;
// CTA launches of at most this many regions take the instantiation with
// room for 255 registers a thread.
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

// Shapes of a launch.  chunk: cycles per staged feed window; window: ints
// per staged row (multifabric.window_ints(chunk)); streams: warps per CTA
// (warp variant).
struct Dims {
  int B, P, N2m, A2m, n_in, n_out, L, Cp, n_cycles;
  unsigned ops;       // bit k: some node has opcode k (alu_select)
  int chunk, window, streams;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared memory of one stream, in bytes: (full, val) pairs [P A2m], (z, cp)
// pairs [P N2m] (two buffers, by the cycle's parity, in the CTA variant),
// then the staged windows [n_in][window].
__host__ __device__ inline size_t stream_bytes(int P, int N2m, int A2m,
                                               int n_in, int window,
                                               bool cta) {
  const size_t PA = static_cast<size_t>(P) * A2m;
  const size_t PN = static_cast<size_t>(P) * N2m;
  return align16(8 * PA) + (cta ? 2 : 1) * align16(8 * PN) +
         4 * static_cast<size_t>(n_in) * window;
}

// f(Slots<0>{}), f(Slots<Step>{}), ...: each group of a phase as straight
// code with constant register indices.
template <int Step, typename F, int... I>
__device__ __forceinline__ void each_group(F&& f,
                                           std::integer_sequence<int, I...>) {
  (f(Slots<I * Step>{}), ...);
}

// kR: rows a lane of the node and arc tables (2, 4 or 8).  kCta: the CTA
// variant (one CTA a stream, one warp a region) or the warp variant (one
// warp a stream, streams warps a CTA).  kThreads: the most threads a
// launch of this instantiation takes, which bounds its registers.
template <bool kProf, int kR, bool kCta, int kThreads>
__global__ void __launch_bounds__(kThreads)
    mf_block_kernel(Tables t, State s, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[2][kCta ? kMaxRegions : 1];
  constexpr int AG = kR < 4 ? kR : 4;          // arc slots a group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = kCta ? static_cast<int>(blockIdx.x)
                     : static_cast<int>(blockIdx.x) * d.streams + warp;
  if (b >= d.B) return;            // the warp variant's last CTA
  if (s.active != nullptr && s.active[b] == 0) {
    if (kCta ? threadIdx.x == 0 : lane == 0) {
      s.fired[b] = 0;
      s.last_prog[b] = 0;
    }
    return;                        // the stream's every thread
  }
  const int PA = d.P * d.A2m, PN = d.P * d.N2m;
  // this thread's rows: node rows nbase + lane + 32 j below nbase + nlim,
  // arc slots abase + lane + 32 j below abase + alim; slots j < rn (ra)
  // hold rows on some lane of the warp (uniform branches), and a lane
  // past its table's end runs the slot on the last row and stores nothing
  const int nbase = kCta ? warp * d.N2m : 0, nlim = kCta ? d.N2m : PN;
  const int abase = kCta ? warp * d.A2m : 0, alim = kCta ? d.A2m : PA;
  const int rn = (nlim + 31) >> 5, ra = (alim + 31) >> 5;
  const int zbytes = static_cast<int>(align16(8 * static_cast<size_t>(PN)));
  const int fv0 = kCta ? 0
                       : warp * static_cast<int>(stream_bytes(
                                    d.P, d.N2m, d.A2m, d.n_in, d.window,
                                    false));
  const int zc0 = fv0 + static_cast<int>(align16(8 * static_cast<size_t>(PA)));
  int* s_win = reinterpret_cast<int*>(smem + zc0 + (kCta ? 2 : 1) * zbytes);
  const int win_last = d.n_in * d.window - 1;
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(s.fv) >> 2) & 3);
  const int* fv_al = s.fv - mis;
  const size_t bA = static_cast<size_t>(b) * PA;
  const size_t bN = static_cast<size_t>(b) * PN;
  const size_t bI = static_cast<size_t>(b) * d.n_in;
  const size_t bO = static_cast<size_t>(b) * d.n_out;
  const size_t bC = static_cast<size_t>(b) * d.Cp;

  // Rows, once per launch.  Node slot: the byte offsets of its five arcs'
  // (full, val) pairs and its opcode.  Arc slot: the offsets of its
  // producer's and consumer's (z, cp) pairs, its word, its registers (a
  // channel slot's from the channel register: the mirror), and by its
  // role the feed row's pointer and length or the output row's last
  // token.  Counters: a node row's firings and input stalls this launch
  // (dnf, dsi; a node fires, stalls on its inputs or on its outputs every
  // cycle, so the output stalls are the cycles less those two), an arc
  // slot's occupancy pair (ab, ahw); a channel's busy, high water and
  // pushes ride in its out-copy's ab, ahw and gots (a channel slot samples
  // no occupancy and drains nothing).
  int nofs[kR][5], nop[kR];
  int dnf[kR], dsi[kR];
  int apo[kR], aco[kR];
  unsigned aw[kR];
  int full[kR], val[kR], ptr[kR], fl[kR], wofs[kR];
  int gots[kR], last[kR], ab[kR], ahw[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int nl = lane + 32 * j;
    const int n = nbase + min(nl, nlim - 1);
    const unsigned w0 = static_cast<unsigned>(__ldg(t.node + 3 * n));
    const unsigned w1 = static_cast<unsigned>(__ldg(t.node + 3 * n + 1));
    const unsigned w2 = static_cast<unsigned>(__ldg(t.node + 3 * n + 2));
    nofs[j][0] = fv0 + 8 * static_cast<int>(w0 & 0xffffu);
    nofs[j][1] = fv0 + 8 * static_cast<int>(w0 >> 16);
    nofs[j][2] = fv0 + 8 * static_cast<int>(w1 & 0xffffu);
    nofs[j][3] = fv0 + 8 * static_cast<int>(w1 >> 16);
    nofs[j][4] = fv0 + 8 * static_cast<int>(w2 & 0xffffu);
    nop[j] = static_cast<int>(w2 >> 16);
    dnf[j] = dsi[j] = 0;
    const int al = lane + 32 * j;
    const bool av = al < alim;
    const int i = abase + min(al, alim - 1);
    const unsigned a0 = static_cast<unsigned>(__ldg(t.arc + 2 * i));
    aw[j] = av ? static_cast<unsigned>(__ldg(t.arc + 2 * i + 1)) : 0u;
    apo[j] = zc0 + 8 * static_cast<int>(a0 & 0xffffu);
    aco[j] = zc0 + 8 * static_cast<int>(a0 >> 16);
    const int aux = static_cast<int>(aw[j] >> 16);
    const bool ch = (aw[j] & kChannel) != 0;
    full[j] = ch ? s.chf[bC + aux] : s.full[bA + i];
    val[j] = ch ? s.chv[bC + aux] : s.val[bA + i];
    const bool cho = kProf && (aw[j] & kChOut);
    const bool occ = kProf && av && !ch;
    ab[j] = cho ? s.chprof[0][bC + aux] : occ ? s.prof[3][bA + i] : 0;
    ahw[j] = cho ? s.chprof[1][bC + aux] : occ ? s.prof[4][bA + i] : 0;
    gots[j] = cho ? s.chprof[2][bC + aux] : 0;
    const bool fed = (aw[j] & kFed) != 0;
    ptr[j] = fed ? s.ptr[bI + aux] : 0;
    fl[j] = fed ? s.fl[bI + aux] : 0;
    last[j] = (aw[j] & kDrained) ? s.out_last[bO + aux] : 0;
    wofs[j] = 0;
  }

  // A pair's opcode groups and a group's roles (drain, feed), uniform over
  // the warp: a group's drain and feed run only where some lane needs them.
  unsigned nops[kR / 2], aflags[kR / AG];
#pragma unroll
  for (int j = 0; j < kR; j += 2) {
    const bool v0 = lane + 32 * j < nlim, v1 = lane + 32 * (j + 1) < nlim;
    nops[j / 2] = __reduce_or_sync(
        0xffffffffu, (v0 ? 1u << nop[j] : 0u) | (v1 ? 1u << nop[j + 1] : 0u));
  }
#pragma unroll
  for (int j = 0; j < kR; j += AG) {
    unsigned f = 0u;
#pragma unroll
    for (int g = 0; g < AG; ++g) f |= aw[j + g];
    aflags[j / AG] = __reduce_or_sync(0xffffffffu, f);
  }

  int fired = 0, last_prog = 0;          // this lane's
  // node phase, two rows at a time: the fire rule on the post-feed
  // registers; (z, cp) into buffer zofs
  auto node_pair = [&](auto first, int cyc, int zofs) {
    constexpr int j0 = decltype(first)::value;
    if (j0 >= rn) return;
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
    fire_rule<false, 2>(op, x0, x1, x2, o0, o1, nops[j0 / 2], z, cp, ir);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = j0 + g, nl = lane + 32 * j;
      const bool valid = nl < nlim, fires = valid & (cp[g] != 0);
      if (valid)
        *reinterpret_cast<int2*>(smem + zc0 + zofs + 8 * (nbase + nl)) =
            make_int2(z[g], cp[g]);
      fired += fires;
      last_prog = fires ? cyc + 1 : last_prog;
      if (kProf) {
        dnf[j] += fires;
        dsi[j] += !ir[g];
      }
    }
  };
  // arc phase, AG slots at a time: the next state from the producer's and
  // consumer's pairs (a channel's copies both take the merged register),
  // the counters (post-fire, pre-drain), the drain, and the feed strobed
  // for the next cycle (not on the chunk's last cycle: the next chunk's
  // start does it); then publish the registers
  auto arc_group = [&](auto first, int cyc, int zofs, bool feed_next) {
    constexpr int j0 = decltype(first)::value;
    if (j0 >= ra) return;
    const unsigned q = aflags[j0 / AG];
    int2 pz[AG];
    int ccp[AG], f[AG], v[AG];
    // slots past ra hold no row on any lane: skipped (uniform)
#pragma unroll
    for (int g = 0; g < AG; ++g) {
      if (j0 + g >= ra) break;
      pz[g] = lds2(smem, apo[j0 + g] + zofs);
      ccp[g] = lds2(smem, aco[j0 + g] + zofs).y;
    }
#pragma unroll
    for (int g = 0; g < AG; ++g) {
      const int j = j0 + g;
      if (j >= ra) break;
      const bool produced = (pz[g].y & aw[j] & 0x18u) != 0;
      const bool consumed = (ccp[g] & aw[j] & 0x07u) != 0;
      f[g] = ((full[j] > 0) & !consumed) | produced | ((aw[j] & kConst) != 0);
      v[g] = produced ? pz[g].x : val[j];
      if (kProf) {
        const bool cho = (aw[j] & kChOut) != 0;
        const bool occ = cho || (aw[j] & (kOcc | kChannel)) == kOcc;
        ab[j] += occ ? f[g] : 0;
        ahw[j] = occ ? max(ahw[j], f[g]) : ahw[j];
        gots[j] += cho & (full[j] == 0) & (f[g] != 0);   // a push
      }
    }
    if (q & kDrained) {
#pragma unroll
      for (int g = 0; g < AG; ++g) {
        const int j = j0 + g;
        if (j >= ra) break;
        const bool dr = (aw[j] & kDrained) != 0;
        const bool got = dr & (f[g] != 0);
        gots[j] += got;
        last[j] = got ? v[g] : last[j];
        last_prog = got ? max(last_prog, cyc + 1) : last_prog;
        f[g] = dr ? 0 : f[g];
      }
    }
    if (feed_next & ((q & kFed) != 0)) {
#pragma unroll
      for (int g = 0; g < AG; ++g) {
        const int j = j0 + g;
        if (j >= ra) break;
        const bool feed =
            ((aw[j] & kFed) != 0) & (f[g] == 0) & (ptr[j] < fl[j]);
        // the token's slot, clamped into the windows (a lane that does
        // not feed reads some token and drops it)
        const int tok = s_win[min(
            max(wofs[j] + clamp_index(ptr[j], d.L), 0), win_last)];
        v[g] = feed ? tok : v[g];
        f[g] = feed ? 1 : f[g];
        ptr[j] += feed;
        last_prog = feed ? cyc + 2 : last_prog;
      }
    }
#pragma unroll
    for (int g = 0; g < AG; ++g) {
      const int j = j0 + g, al = lane + 32 * j;
      if (j >= ra) break;
      full[j] = f[g];
      val[j] = v[g];
      if (al < alim)
        *reinterpret_cast<int2*>(smem + fv0 + 8 * (abase + al)) =
            make_int2(f[g], v[g]);
    }
  };

  for (int c0 = 0; c0 < d.n_cycles; c0 += d.chunk) {
    // the chunk's feed windows, staged from the pointers (each feed slot's
    // lane its own row: only it reads it), then cycle c0's feed and every
    // slot published for the node phase
    const int c1 = min(c0 + d.chunk, d.n_cycles);
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < ra && (aw[j] & kFed)) {
        const int r = static_cast<int>(aw[j] >> 16);
        int off = 0;
        const long long row =
            mis + (static_cast<long long>(b) * d.n_in + r) * d.L;
        stage_window(fv_al, row, ptr[j], fl[j], d.chunk, d.L,
                     s_win + r * d.window, &off);
        wofs[j] = r * d.window + off;
      }
    }
    cp_async_wait_all();
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < ra) {
        const bool feed = (aw[j] & kFed) && full[j] == 0 && ptr[j] < fl[j];
        if (feed) {
          val[j] = s_win[wofs[j] + clamp_index(ptr[j], d.L)];
          full[j] = 1;
          ptr[j] += 1;
          last_prog = c0 + 1;
        }
        const int al = lane + 32 * j;
        if (al < alim)
          *reinterpret_cast<int2*>(smem + fv0 + 8 * (abase + al)) =
              make_int2(full[j], val[j]);
      }
    }
    __syncwarp();
    for (int cyc = c0; cyc < c1; ++cyc) {
      const int zofs = kCta ? (cyc & 1) * zbytes : 0;
      each_group<2>([&](auto first) { node_pair(first, cyc, zofs); },
                    std::make_integer_sequence<int, kR / 2>{});
      // the CTA variant's channel lanes read other regions' pairs
      if (kCta)
        __syncthreads();
      else
        __syncwarp();
      each_group<AG>(
          [&](auto first) { arc_group(first, cyc, zofs, cyc + 1 < c1); },
          std::make_integer_sequence<int, kR / AG>{});
      __syncwarp();
    }
  }

  fired = __reduce_add_sync(0xffffffffu, fired);
  last_prog = __reduce_max_sync(0xffffffffu, last_prog);
  if (kCta) {
    if (lane == 0) {
      red[0][warp] = fired;
      red[1][warp] = last_prog;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int f = 0, lp = 0;
      for (int r = 0; r < d.P; ++r) {
        f += red[0][r];
        lp = max(lp, red[1][r]);
      }
      s.fired[b] = f;
      s.last_prog[b] = lp;
    }
  } else if (lane == 0) {
    s.fired[b] = fired;
    s.last_prog[b] = last_prog;
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int nl = lane + 32 * j;
    if (kProf && j < rn && nl < nlim) {
      const size_t n = bN + nbase + nl;
      s.prof[0][n] += dnf[j];
      s.prof[1][n] += dsi[j];
      s.prof[2][n] += d.n_cycles - dnf[j] - dsi[j];
    }
    const int al = lane + 32 * j;
    if (j < ra && al < alim) {
      const size_t i = bA + abase + al;
      const int aux = static_cast<int>(aw[j] >> 16);
      s.full[i] = full[j];
      s.val[i] = val[j];
      if (aw[j] & kChOut) {
        s.chf[bC + aux] = full[j];
        s.chv[bC + aux] = val[j];
        if (kProf) {
          s.chprof[0][bC + aux] = ab[j];
          s.chprof[1][bC + aux] = ahw[j];
          s.chprof[2][bC + aux] = gots[j];
        }
      } else if (kProf && !(aw[j] & kChIn)) {
        s.prof[3][i] = ab[j];
        s.prof[4][i] = ahw[j];
      }
      if (aw[j] & kFed) s.ptr[bI + aux] = ptr[j];
      if (aw[j] & kDrained) {
        s.out_count[bO + aux] += gots[j];
        s.out_last[bO + aux] = last[j];
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int grid, int threads, size_t smem,
           cudaStream_t stream, const Tables& t, const State& s,
           const Dims& d) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(t, s, d);
  return static_cast<int>(cudaGetLastError());
}

// rows a lane: the fewest of 2, 4, 8 that hold `rows` rows
int lane_rows(int rows) {
  const int r = (rows + 31) / 32;
  return r <= 2 ? 2 : r <= 4 ? 4 : 8;
}

template <bool kProf, int kR>
int launch_variant(bool cta, const Tables& t, const State& s, const Dims& d,
                   cudaStream_t stream) {
  if (!cta) {
    const size_t smem = static_cast<size_t>(d.streams) *
                        stream_bytes(d.P, d.N2m, d.A2m, d.n_in, d.window,
                                     false);
    return launch(mf_block_kernel<kProf, kR, false, 32 * kMaxStreams>,
                  (d.B + d.streams - 1) / d.streams, 32 * d.streams, smem,
                  stream, t, s, d);
  }
  const size_t smem = stream_bytes(d.P, d.N2m, d.A2m, d.n_in, d.window, true);
  return d.P <= kFewRegions
             ? launch(mf_block_kernel<kProf, kR, true, 32 * kFewRegions>,
                      d.B, 32 * d.P, smem, stream, t, s, d)
             : launch(mf_block_kernel<kProf, kR, true, 32 * kMaxRegions>,
                      d.B, 32 * d.P, smem, stream, t, s, d);
}

template <bool kProf>
int launch_rows(bool cta, const Tables& t, const State& s, const Dims& d,
                cudaStream_t stream) {
  const int rows = cta ? lane_rows(max(d.N2m, d.A2m))
                       : lane_rows(d.P * max(d.N2m, d.A2m));
  if (rows == 2) return launch_variant<kProf, 2>(cta, t, s, d, stream);
  if (rows == 4) return launch_variant<kProf, 4>(cta, t, s, d, stream);
  return launch_variant<kProf, 8>(cta, t, s, d, stream);
}

}  // namespace

extern "C" {

// Launches the sharded block kernel on `stream`; returns cudaGetLastError()
// (0 = ok), or cudaErrorInvalidValue past the variant's limits.  variant 0
// is the warp variant (P N2m and P A2m at most 32 kMaxRows, `streams`
// warps a CTA, 1 .. kMaxStreams), 1 the CTA variant (P <= 32 regions of at
// most 32 kMaxRows node rows and arc slots, 32 P threads a CTA).  chunk is
// the cycles per staged feed window and window the ints per staged row.
// nf == nullptr selects the unprofiled instantiation.  The state arrays are
// updated in place.
int mf_block_launch(const int* node, const int* arc, const int* fv,
                    const int* fl, const int* active, int* full, int* val,
                    int* ptr, int* out_last, int* out_count, int* chf,
                    int* chv, int* nf, int* si, int* so, int* ab, int* ahw,
                    int* cb, int* chw, int* cpu, int* fired, int* last_prog,
                    int B, int P, int N2m, int A2m, int n_in, int n_out,
                    int L, int Cp, int n_cycles, int ops, int variant,
                    int chunk, int window, int streams, void* stream) {
  const bool cta = variant == 1;
  if (B < 1 || P < 1 || N2m < 1 || A2m < 1 || n_in < 1 || n_out < 1 ||
      L < 1 || Cp < 1 || n_cycles < 0 || (variant != 0 && variant != 1) ||
      chunk < 1 || window < 4 * (((chunk + 2) >> 2) + 1) || window % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cta ? P > kMaxRegions || N2m > 32 * kMaxRows || A2m > 32 * kMaxRows
          : P * N2m > 32 * kMaxRows || P * A2m > 32 * kMaxRows ||
                streams < 1 || streams > kMaxStreams)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{node, arc};
  const State s{fv,      fl,  active, full, val, ptr, out_last, out_count,
                chf,     chv, {nf, si, so, ab, ahw}, {cb, chw, cpu},
                fired,   last_prog};
  const Dims d{B, P, N2m, A2m, n_in, n_out, L, Cp, n_cycles,
               static_cast<unsigned>(ops), chunk, window,
               cta ? 1 : streams};
  const auto st = static_cast<cudaStream_t>(stream);
  return nf != nullptr ? launch_rows<true>(cta, t, s, d, st)
                       : launch_rows<false>(cta, t, s, d, st);
}

// Shared memory of one stream of the variant (0 warp, 1 CTA: its CTA's),
// in bytes, with `window` ints per staged feed row.
int mf_block_smem_bytes(int P, int N2m, int A2m, int n_in, int variant,
                        int window) {
  return static_cast<int>(
      stream_bytes(P, N2m, A2m, n_in, window, variant == 1));
}

}  // extern "C"
