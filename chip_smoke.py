#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero; no phase is caught and skipped):

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel from ``src/`` into ``build/`` (the
             fire-block and fire-step kernels, the two static-schedule
             kernels; one compiler per source, all started together);
             prints the time and the ``-Xptxas -v`` report;
3. kernel  — every instantiation against its plain PyTorch version on
             the card, bit for bit: the block kernel dense and
             specialized (``optimize``), unprofiled and profiled, batched
             and single-stream, in both variants (warp, the wrappers'
             choice for these fabrics, and CTA), on 7 benches (B = 64 with
             parked slots, K in {1, 16, 64, 65}: 65 is one past a staging
             chunk, random counters in), 64 random graphs (control
             operators included; the spec kernel also against the dense
             one on the same permuted tables) and 4 random graphs of 150
             nodes (the CTA variant by size); the fire step's two variants
             (one warp; one CTA, which alone takes the 150-node graphs)
             and its warp order's replay on random states of the 7
             benches and the 64 and 4 random graphs; the serving
             states the main path gives the kernels (dot_prod at B =
             1024, L = 4096, dense and
             optimized+profiled, bubble_sort(8) at B = 256, with the B = 1
             slice of each; dot_prod's also against the two-phase replay
             of the kernel's cycle order); random graphs fed int32 edge
             operands through the engine against the numpy oracle;
             device times and microseconds per cycle of every
             instantiation, and of the CTA variant, at the dot_prod
             serving state; the latency floor (one warp running the warp
             variant's dependent chain alone, K = 16 and 64); the
             two schedule kernels against their plain versions on the 6
             schedulable benches (K in {1, 16, 64}, parked slots, random
             mid-plan positions, mixed feed lengths) and at full width
             (the run over 1024 equal 4096-token dot_prod streams, the
             slot step at the scheduled serving state, B = 1024, K = 64),
             each also against the fire block over the same cycles, with
             their times; the run kernel's two variants (warp: one warp a
             stream, program, tables and feed windows on chip; CTA) bit
             for bit against the plain run on the 6 schedulable benches at
             B = 1, 8 and 1024 and stream lengths 1, W - 1, W, W + 1, 97
             and 4096 (W the planned window, and W = 4), with clamped
             feeds, misaligned tokens and rows fed every cycle; both
             variants' times at full width and at phase 4's shape
             (dot_prod, B = 8, 9 tokens) and the variant's latency floor
             (its own loop over the program on one stream of one warp,
             the feed windows staged once); the slot step's two variants
             (warp, one warp a slot; CTA) bit for bit against
             the plain slot step on the 6 schedulable benches at B = 1, 8
             and 1024, K = 1, 16, 64 and 65 (at B = 1024 64 and 65; 8
             plans of mixed feed lengths,
             random positions, parked slots, pointers at and past the
             stream's end, tokens 1-3 ints off 16 bytes, the warp order's
             replay at B = 8), and at the scheduled serving state against
             the fire block, with each variant's time and the floor (the
             first active slot alone on one warp); the fire step's
             variants' times and its floor (an empty one-warp kernel);
             both RMSNorm variants
             (split, generic) against the plain version at
             1-14812 rows by d = 32, 130, 2048 and 4096 in f32 and bf16,
             both roundings, with the wrapper's choice checked;
4. engine  — ``DataflowEngine(optimize=, profile=)`` ``run`` /
             ``run_batch`` against ``run_reference`` (7 benches, both
             flags, K in {1, 16, 64}); ``schedule=True`` on the 6
             schedulable benches (each run one launch of the run
             kernel); ``optimize_graph`` fabrics on the card;
             ``run_fabric`` (one fire-step launch per cycle, the warp
             variant on every bench) against ``run_reference``, with its
             microseconds per cycle beside the fused engine's at K = 16
             and 64 (the paper's Table-1 comparison);
4b. compile — the torch ALU (the ``"torch"`` backend's and compile's) on
             the card against ``alu_numpy`` on the edge operands, int32,
             uint32 and float32, float shifts at every integer in
             [-149, 126]; ``compile()``'s every executor (``"dag"`` where
             legal, ``"unrolled"``, ``"torch"``, ``"cuda"``) on the 7
             benches at K in {1, 16, 64}, ``optimize`` False / spec /
             full / sched, profile off and on, against ``run_reference``
             (``"dag"`` streams against each bench's reference), the cuda
             routes raising rows 1-5's and 7's launches; ``"torch"``,
             ``"dag"``, ``"unrolled"`` and ``"reference"`` in uint32,
             float32 and on tokens of shape (4,) on the 7 benches and 16
             random fabrics fed edge operands, bit for bit; at full width
             (phase 5's dot_prod deployment: 1024 streams of 4096 tokens)
             ``run_batch`` of the torch engine (int32, float32) and the
             cuda engine (dynamic, scheduled), every int32 result equal
             across them and 8 sampled streams to ``run_reference``,
             ``"dag"`` over all tokens, ``"unrolled"`` on one stream, with
             each executor's wall time and microseconds per fabric cycle;
5. serving — ``DataflowServer(slots=1024, block_cycles=64)`` on the
             paper's dot-product fabric at n = 32, 2048 requests of
             256..4096 tokens: dense, then optimized and profiled, then
             optimized, profiled and scheduled (every result equal to the
             dynamic deployment's in every field, every slot step the warp
             variant); then bubble_sort(8) at
             256 slots.  The launch counts are read here; 16 sampled
             results per deployment are then checked against
             ``run_reference``, a solo ``run`` and (profiled) a solo
             replay of the same blocks (those runs are not counted);
5b. hardened serving — phase 5's optimized, profiled dot_prod deployment
             again with four tenants, a seeded ``FaultPlan`` (transient
             dispatch faults that eat two retries, wedged slots, poisoned
             feeds; ``max_retries=3``), a ``TraceRecorder`` and a
             ``MetricsRegistry``, in turns with the same deployment plain
             and with the trace and metrics alone (plain, hooks, hardened,
             hardened, hooks, plain, plain, hooks, hardened: every plain
             and hooks run equal to phase 5's in every field, every
             hardened run to the first); unfaulted requests equal phase 5's
             results (every field where they rode the same block
             lengths), poisoned ones a solo run over the poisoned feeds,
             16 of each against a solo replay of their blocks in every
             field; the trace validates on both clocks and its terminal
             events match the metrics, the snapshot validates and counts
             the statuses and the retries; then the same hardened run
             scheduled at 256 slots over 512 requests (every slot step
             the warp variant), a persistent fault from block 5 at 64
             slots (every request answered, the late ones with a typed
             error, nothing raised) and a compile fault that raises; the
             walls of the turns and the host seconds in the hooks and in
             the garbage collector.  The checks of the two hardened runs
             (their solo runs and replays) come after phase 5's sampled
             checks, once the launch counts are read;
5c. traced programs — the ten traced benches of the library (torch
             programs through ``repro_torch.front``) traced on the card's
             torch, each held to the asm digest the CPU tests pin, with
             each trace's seconds; ``dot_prod_traced`` at phase 5's
             deployment (1024 slots, K = 64, the same 2048 requests),
             plain and optimized+profiled, every request against
             Bench.reference and every request that ran to the end equal
             in value and token count to phase 5's hand-built result (the
             truncated ones stop at the same 500-cycle budget with fewer
             tokens out of the deeper chain; 4 of them against
             run_reference); ``DataflowServer.for_fn(gcd)`` at 1024
             slots, K = 64: 4096 ``submit_args`` requests (uniform in
             [1, 1024]) equal to ``math.gcd`` and 8 that never quiesce,
             truncated at 4096 cycles with nothing left busy, 64 sampled
             results against a solo ``run_reference`` in every field;
             the other eight benches through ``compile_fn`` (int32 on
             ``"cuda"``, plain and spec+profiled; ``newton_sqrt`` on
             ``"torch"``) against ``run_reference`` bit for bit; rows
             1-5 must each launch here.  The sampled checks come after
             the counts are read;
5d. sharded serving — phase 5's dot_prod deployment (1024 slots, K =
             64, the same 2048 requests) with ``partition=2`` and ``4``,
             dense and optimized+profiled: each block one launch of the
             sharded block kernel (``mf_block_cuda``, its warp variant:
             a stream's regions in one warp), every request equal to
             phase 5's solo result of the same uid in every field (outputs, counts,
             cycles, fired, dispatches, node_fires, the node and arc
             counters, every metric), the channel counters within their
             bounds and each channel's pushes equal to its producer's
             firings; walls, requests/s, blocks, launches and
             ``reset_slots`` seconds beside phase 5's.  After the counts
             are read: each kernel variant (warp, CTA) against the plain
             version bit for bit on the slot state each run had after 8
             heartbeats (B = 1, 8 and 1024; K = 1, 16, 64 and 65; counters
             off and on), each variant's device ms a block at each full
             state (B = 1024) and on one stream alone (B = 1, the latency
             floor) beside its bound and row 3's µs a cycle, and one
             partitioned ``"torch"`` ``run_batch`` in float32 (8 streams of
             64 edge tokens) against ``run_reference``;
6. trace   — the optimized, profiled dot_prod serving runs again under
             ``torch.profiler`` (CPU and CUDA), dynamic and scheduled:
             busy time and idle share;
7. LM kernels — flash attention and RMSNorm against their plain versions
             on the card in f32 and bf16: attention at the long wave's
             prefill shape (internlm2-1.8b: 16 heads over 8, hd 128, a
             4160-entry cache), at its decode step (one query mid-cache),
             in the Pallas case (q_offset 0, every key valid, odd
             lengths, causal and not) and at the split decode's edge cases
             (kv_len 1, below one split, past the cache, a split with
             every key masked); each attention variant (bf16 tensor-core
             prefill, f32 CUDA-core kernel, split decode and its combine
             pass, the last two also each against its own plain version)
             and the dispatch rule's choice; RMSNorm at [B*S, 2048] in
             both roundings; their device times (profiler) and times per
             call (CUDA events), bounds, and the times of
             ``F.scaled_dot_product_attention`` and ``F.rms_norm`` on the
             same inputs (timed only, never used by the port); RMSNorm
             and ``F.rms_norm`` also by CUDA events with a cold L2 (a
             256 MB write before each call, the two and every RMSNorm
             variant timed in turns), the row's times, and at the decode
             step's [4, 1, 2048]
             by CUDA-graph replays over 4 input sets and cold per call;
8. LM serving — internlm2-1.8b at full width on the card: seeded
             ``init_params`` (peak memory), ``python -m
             repro_torch.launch.serve --full`` with the JAX launcher's
             defaults (8 requests of 4-32 tokens, 16 new, waves of 4, cache
             256), then one long wave (4 prompts of 2048-4096 tokens, 32
             new tokens, cache 4160): tokens/s, prefill and decode ms per
             step, both kernels' launches; then the long wave's logits at
             every step against the same engine on the plain versions,
             teacher-forced with the kernel path's tokens, a
             ``torch.profiler`` trace of 4 of its decode steps (naming
             the split and combine kernels), and a prompt holding ids
             outside the vocabulary;
8b. LM training — internlm2-1.8b: (a) ``train.loop.make_train_step`` at
             full width and depth (f32 parameters, bf16 compute, remat),
             30 steps of batch 4 x seq 128 from ``SyntheticLM(seed=0)``
             (peak memory, ms per step, tokens/s; every loss finite and
             the last 5 below the first 5; a profiled step); (b) 3 steps
             at seq 4096, batch 1 (train_4k's length; its batch of 256
             cut to fit one card), with the forward and backward kernels'
             launches by variant; (e) ``train.loop.run`` at reduced width:
             a failure at step 5, the resume from step 3 byte-equal to a
             clean run, and ``launch.train --reduced --steps 8``; (a)
             and (b) must launch only the tensor-core backward kernels
             (``dq_mma``, ``dkdv_mma``), (e) the f32 ones; then (c)
             the loss and every gradient at full width, 2 layers, seq
             4096 through the kernels against the plain path, and (d)
             each backward kernel against its plain version (attention at
             (b)'s shape and odd lengths, hd 16-128, RMSNorm at three
             shapes, f32 and bf16; two calls byte-equal) and its device
             time beside its bound, the plain version's and the library's
             backward, and the f32 route's time at (b)'s shape (RMSNorm
             also at (a)'s 512 rows, and its rows kernel at other
             shapes);
8c. LM families — the slice's families at full width and depth, random
             parameters from seed 0: (a) stablelm-1.6b (LayerNorm, SwiGLU,
             32 heads over 32, hd 64) through ``launch.serve --full`` with
             the launcher's defaults, every step's logits teacher-forced
             against the same engine on the plain versions (phase 8's
             rule), then ``make_train_step`` for 10 steps of batch 4 x seq
             128 (every loss finite, the mean of the last 5 below the
             first 5's, only ``dq_mma`` and ``dkdv_mma`` launched for the
             backward); (b) starcoder2-7b (LayerNorm, GELU, biases, 36
             heads over 4: G = 9, hd 128) served the same way, its peak
             memory under 80 GB (the launcher frees the f32 tree once the
             engine holds its bf16 copy, which the plain replay shares);
             (c) rwkv6-1.6b served the same way, then one wave of 4
             prompts of 480-512 tokens left-padded to 512 (16 chunks with
             the state carried) and 32 new tokens, the last logits of a
             prefill over 512 tokens against a prefill over 480 and 32
             teacher-forced decode steps, in f32 compute within 2e-4 (the
             CPU tests' f32 tolerance; the served bf16 paths each against
             the f32 logits, the split one no farther than twice the
             other), and 3 training steps of batch 4 x seq 128, every
             loss finite; each family finds at most 2 GB allocated when
             it starts; tokens/s, prefill and decode ms per step, peak
             memory and launches by variant for each; then row 9 at
             stablelm's and starcoder2's prefill shapes (the launcher's
             wave and a 4096-token prefill) against its plain version,
             timed beside ``F.scaled_dot_product_attention`` (timed only);
8d. MoE     — llama4-scout-17b-a16e (16 experts top-1, a shared expert,
             40 heads over 8, hd 128) and kimi-k2-1t-a32b (384 experts
             top-8, a shared expert, its leading dense layer, 64 heads
             over 8, hd 112; bf16 parameters): both trained 3 steps at
             their reduced width in bf16 (hd 32; every loss finite, aux
             above 0), then at full width, their depth cut to 2 layers,
             random parameters from seed 0, through a ``ServeEngine``
             built on the cut config: the launcher's default requests (8
             prompts of 4-32 tokens, 16 new, waves of 4, cache 256), then
             a long wave of 4 prompts of 4096 tokens (32 MoE groups of
             512) into a cache of 4104, 8 new tokens; each wave served
             with its routing recorded and every step's logits
             teacher-forced against the plain versions, which record
             their own routing and then route as the kernel path did:
             every step held to 0.125, every token the plain path would
             have routed otherwise a near tie (the gap between its k-th
             and (k+1)-th router logit below 2^-4); then served again
             with no routing recorder for tokens/s, prefill and decode
             ms; peak memory (under 80 GB), dropped (token, choice)
             pairs, launches by variant.  After the counts are read:
             kimi-k2 served with planted faults in row 9 (dims 104-111
             zeroed, which the limits must refuse; the last split lost)
             and read against the same limits; the training's loss and
             gradients held against the plain path, routed the same
             way; row 10 at d 5120 and 7168 against its plain version;
             row 9 at kimi-k2's prefill shapes (hd 112) against its
             plain version, timed beside SDPA, and at its heads over
             every case of phase 7 (caches 256 and 4104, f32 and bf16:
             the split kernel's partials and combine, the planted lost
             split), its decode at 4096 keys timed;
8e. hybrid  — zamba2-7b (81 Mamba2 layers, one shared attention layer
             at 13 sites, 32 heads over 32, hd 112; 6,751,130,832
             parameters) at full width and depth: the launcher's default
             run (``launch.serve --full``), each wave teacher-forced on
             the plain versions (phase 8's rule), row 10's launches
             counted by width (3584 and 7168); a long wave of 4 prompts
             of 4096 tokens (16 SSD chunks of 256, the state carried)
             into a cache of 4104, 8 new tokens, held the same way; one
             traced decode step; the state across the prefill/decode
             boundary in f32 (a prefill over 3840 tokens and 256
             teacher-forced decode steps, every step against one forward
             over 4096 at the same position, the last against one
             prefill, within 5e-3; the conv tails and h zeroed at the
             boundary must be refused within 8 steps) with bf16's drift
             from f32 read beside; ``make_train_step`` at full width and
             12 layers (2 sites) for 12 steps of batch 4 x seq 128 (the
             mean of the last 4 losses below the first 4's; a run
             stopped after 6 steps, its state taken to the host as a
             checkpoint stores it and resumed, byte-equal to the straight
             run); after the counts are read: the gradients at 12 layers
             and 1 x 4096 against the plain path (each leaf no farther
             from the f32 plain gradient than 1.5 x the bf16 plain
             path's), row 10 at d 3584 and 7168 and row 14 at [4096, d]
             against their plain versions, row 9 at zamba2's launcher
             wave and at 4 x 4096 and rows 12-13 at 1 x 4096 (hd 112,
             bf16 and f32) against theirs, byte-equal twice, timed beside
             SDPA and the bound;
9. summary — the ``kernels`` JSON line (Pallas rows 1-10; row 11, the
             sharded block kernel, which replaces the JAX package's jnp
             block ``MultiFabric._core_fn``; rows 12-14, the backward
             kernels of attention (dK/dV, dQ) and RMSNorm, which replace
             the JAX package's autodiff of its jnp layers), the card, and
             the result line.

The launch counts in the summary come from the main paths alone: every
count is set to 0 just before phase 4 and read after phase 5d's
runs (phase 4b's compile routes included), before phase 5's sampled
checks and phase 5b's, 5c's and 5d's checks (the fabric's rows 1-8 and
the sharded block, row 11), and set
to 0 again just
before phase 8 and read after the long wave, before its plain replay
(the LM's rows 9-10, and rows 9's and 10's launches per variant;
rows 1-8's per variant come from phases 4-5c), and once more just before
phase 8b and read after its training runs (a), (b) and (e), before its
comparisons (c) and (d) (rows 12-14), and once more just before phase
8c and read after its
families' runs, before row 9 is timed at their shapes (printed by
variant on a line of its own; the ``kernels`` line keeps phases 4-8b's
counts), and once more just before phase 8d and read after its trained
and served runs, before its planted faults, comparisons and timings (rows 9 and 10 of
the ``kernels`` line list them per MoE model as ``launches_moe``, and
row 9 kimi-k2's, all at hd 112, as ``variants_hd112_launches``), and
once more just before phase 8e and read after its served and trained
runs (its traced decode and state check taken out), before its
comparisons and timings (rows 9, 10, 12-14 list them as
``launches_zamba2``; row 10 its launches by width, rows 12-13 their
times at hd 112 as ``hd112_zamba2``).  The
script imports torch, numpy and the port;
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
SCALAR_OPS_PER_S = 67e12     # H100 SXM 32-bit rate outside the tensor cores
FIRE_SOURCE = "src/repro_torch/kernels/csrc/dataflow_fire.cu"
SCHED_SOURCE = "src/repro_torch/kernels/csrc/schedule_fire.cu"
JAX_KERNELS = "src/repro/kernels/dataflow_fire.py"
JAX_SCHED = "src/repro/kernels/schedule_fire.py"

# one row per Pallas kernel of the path: (file:line, Pallas function)
ROWS = {
    "fire_block": (f"{JAX_KERNELS}:477",
                   "fire_block_pallas -> _block_kernel (:390)"),
    "fire_block_prof": (f"{JAX_KERNELS}:428",
                        "fire_block_pallas(prof=) -> _block_kernel_prof"),
    "fire_block_batched": (f"{JAX_KERNELS}:519",
                           "fire_block_batched_pallas -> "
                           "_batched_block_kernel (:405)"),
    "fire_block_batched_prof": (f"{JAX_KERNELS}:448",
                                "fire_block_batched_pallas(prof=) -> "
                                "_batched_block_kernel_prof"),
    "fire_block_spec": (f"{JAX_KERNELS}:117",
                        "_ready_and_z_spec, traced into rows 1-4 when "
                        "class_slices is set"),
    "fire_step": (f"{JAX_KERNELS}:247", "fire_step_pallas -> _kernel (:196)"),
    "sched_run": (f"{JAX_SCHED}:69",
                  "make_sched_run (pallas_call :97 solo, :116 batched)"),
    "sched_slot_step": (f"{JAX_SCHED}:134",
                        "make_sched_slot_step (pallas_call :174)"),
}
SOURCES = {k: SCHED_SOURCE if k.startswith("sched") else FIRE_SOURCE
           for k in ROWS}

# the LM's Pallas rows: (file:line, Pallas function, CUDA source)
LM_ROWS = {
    "flash_attention": ("src/repro/kernels/flash_attention.py:62",
                        "flash_attention_pallas -> _kernel (:25)",
                        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "rmsnorm": ("src/repro/kernels/rmsnorm.py:23",
                "rmsnorm_pallas -> _kernel (:16)",
                "src/repro_torch/kernels/csrc/rmsnorm.cu"),
}
# kernel against plain version on the card: f32 sums in another order;
# bf16 at the JAX package's kernel tests' own tolerance (a rounding that
# differs gives one bf16 step, 2^-8 relative).  RMSNorm is held as allclose
# with rtol = atol = tol (as those tests hold Pallas against ref); attention
# by flash_attention.error_ratio, rtol = tol with the absolute part scaled
# to each row's RMS up to tol (a row over n keys has an RMS near n^-1/2, so
# a fixed atol of 3e-2 would pass a decode that lost a split); the split
# kernel's f32 partials at the f32 attention tolerance in either dtype
LM_TOL = {"float32": {"flash_attention": 1e-4, "rmsnorm": 1e-5},
          "bfloat16": {"flash_attention": 3e-2, "rmsnorm": 3e-2}}
ATTN_RULE = "rtol = {0}, atol = {0} x min(1, row RMS)"   # {0}: tolerance
LM_ARCH = "internlm2-1.8b"
# the attention kernels the bf16 main path runs (the f32 CUDA-core kernel
# serves f32 calls only; phase 7 holds it against its plain version)
MAIN_ATTENTION_VARIANTS = ("prefill_mma", "decode_split", "decode_combine")
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def launch_counts() -> dict:
    """Launches per Pallas row, from the wrappers' counts: unprofiled and
    profiled launches of each entry, and the specialized rule's launches
    (of either entry, profiled or not)."""
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multifabric as kmf
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import schedule_fire as ksf
    one, bat = df.fire_block_cuda, df.fire_block_batched_cuda
    bwd = fa.flash_attention_backward_cuda.launches_by
    return {"fire_block_by": {"fire_block": dict(one.launches_by),
                              "fire_block_batched": dict(bat.launches_by)},
            "fire_block": one.launches, "fire_block_prof": one.prof_launches,
            "fire_block_batched": bat.launches,
            "fire_block_batched_prof": bat.prof_launches,
            "fire_block_spec": one.spec_launches + bat.spec_launches,
            "fire_step": df.fire_step_cuda.launches,
            "fire_step_by": dict(df.fire_step_cuda.launches_by),
            "sched_run": ksf.sched_run_cuda.launches,
            "sched_run_by": dict(ksf.sched_run_cuda.launches_by),
            "sched_slot_step": ksf.sched_slot_step_cuda.launches,
            "sched_slot_step_by": dict(ksf.sched_slot_step_cuda.launches_by),
            "flash_attention": fa.flash_attention_cuda.launches,
            "flash_attention_by": dict(fa.flash_attention_cuda.launches_by),
            "rmsnorm": rn.rmsnorm_cuda.launches,
            "rmsnorm_by": dict(rn.rmsnorm_cuda.launches_by),
            "attention_bwd_dkdv": bwd["dkdv_mma"] + bwd["dkdv_f32"],
            "attention_bwd_dq": bwd["dq_mma"] + bwd["dq_f32"],
            "attention_bwd_by": dict(bwd),
            "rmsnorm_bwd": rn.rmsnorm_backward_cuda.launches,
            "rmsnorm_bwd_by": dict(rn.rmsnorm_backward_cuda.launches_by),
            "mf_block": kmf.mf_block_cuda.launches,
            "mf_block_prof": kmf.mf_block_cuda.prof_launches,
            "mf_block_by": dict(kmf.mf_block_cuda.launches_by)}


def reset_counts() -> None:
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multifabric as kmf
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import schedule_fire as ksf
    kmf.mf_block_cuda.launches = kmf.mf_block_cuda.prof_launches = 0
    kmf.mf_block_cuda.launches_by = dict.fromkeys(kmf.VARIANTS, 0)
    for w in (df.fire_block_cuda, df.fire_block_batched_cuda):
        w.launches = w.prof_launches = w.spec_launches = 0
        w.launches_by = dict.fromkeys(df.VARIANTS, 0)
    df.fire_step_cuda.launches = 0
    df.fire_step_cuda.launches_by = dict.fromkeys(df.STEP_VARIANTS, 0)
    ksf.sched_run_cuda.launches = ksf.sched_slot_step_cuda.launches = 0
    ksf.sched_run_cuda.launches_by = dict.fromkeys(ksf.SCHED_VARIANTS, 0)
    ksf.sched_slot_step_cuda.launches_by = dict.fromkeys(ksf.SLOT_VARIANTS,
                                                         0)
    fa.flash_attention_cuda.launches = rn.rmsnorm_cuda.launches = 0
    rn.rmsnorm_cuda.launches_by = dict.fromkeys(rn.VARIANTS, 0)
    fa.flash_attention_cuda.launches_by = dict.fromkeys(fa.VARIANTS, 0)
    fa.flash_attention_backward_cuda.launches = 0
    fa.flash_attention_backward_cuda.launches_by = dict.fromkeys(
        fa.BWD_VARIANTS, 0)
    rn.rmsnorm_backward_cuda.launches = 0
    rn.rmsnorm_backward_cuda.launches_by = dict.fromkeys(
        (*rn.BWD_VARIANTS, "reduce"), 0)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cold_turns_ms(fns: dict, reps: int, flush) -> dict:
    """Median milliseconds of each of ``fns`` (name -> fn) on the card,
    by CUDA events around each call with a cold L2 (``flush`` written
    before every call), the functions timed in turns — each repetition
    calls every one, starting one further along each time — so no place
    in the process favours one of them."""
    import torch
    names = list(fns)
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    marks = {k: [] for k in names}
    for r in range(reps):
        for i in range(len(names)):
            k = names[(r + i) % len(names)]
            flush.zero_()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fns[k]()
            t1.record()
            marks[k].append((t0, t1))
    torch.cuda.synchronize()
    return {k: float(np.median([a.elapsed_time(b) for a, b in v]))
            for k, v in marks.items()}


def profile_kernels(fn, reps: int, kernel: str | None = None,
                    tries: int = 3) -> tuple:
    """Mean device milliseconds per fn() from torch.profiler, and the
    launches it recorded, of the kernels whose name holds ``kernel`` (all
    kernels if None); (0.0, 0) when the profiler records no device time.
    The profiler loses records now and then, at times a whole window: a
    window that recorded fewer launches than half the calls is profiled
    again, up to ``tries`` windows, and the one with the most launches
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = (0.0, 0)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if kernel is None or kernel in e.key:
                us += getattr(e, "device_time_total", None) or 0.0
                n += e.count
        if n > best[1]:
            best = (us / reps / 1e3, n)
        if 2 * n >= reps:
            break
        log(f"  (the profiler recorded {n} launches of {kernel} in {reps} "
            "calls: profiled again)")
    return best


def profiled_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Mean device milliseconds per fn() of the kernels whose name holds
    ``kernel`` (:func:`profile_kernels`); 0.0 when the profiler records
    no device time.  Fewer launches recorded than calls can only be
    records the profiler lost: then the mean of the launches it recorded
    stands for a call, which is exact where a call launches one matching
    kernel (every row but the split decode's two kernels)."""
    ms, n = profile_kernels(fn, reps, kernel)
    if 0 < n < reps:
        log(f"  (the profiler recorded {n} launches of {kernel} in {reps} "
            "calls: the mean of those)")
        return ms * reps / n
    return ms


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """:func:`profiled_ms`, failing when the profiler records no device
    time for ``kernel`` (a name filter that misses must not read as a
    time from another clock)."""
    ms = profiled_ms(fn, reps, kernel)
    check(ms > 0, f"the profiler recorded no device time for "
                  f"{kernel or 'any kernel'}")
    return ms


def max_abs_err(got, want) -> int:
    check(len(got) == len(want), f"{len(got)} outputs, want {len(want)}")
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def hold(err, rows, got, want, what) -> None:
    """Kernel outputs ``got`` equal the reference ``want`` bit for bit;
    the error is recorded under every Pallas row in ``rows``."""
    e = max_abs_err(got, want)
    for r in rows:
        err[r] = max(err[r], e)
    check(e == 0, f"{what}: kernel != reference (max |err| {e})")


def block_rows(batched: bool, prof, spec: bool) -> list:
    """The Pallas rows one block-kernel launch stands for."""
    rows = [("fire_block_batched" if batched else "fire_block")
            + ("_prof" if prof is not None else "")]
    return rows + (["fire_block_spec"] if spec else [])


def serving_workload(name, bench, n_req, seed, max_len=4096):
    """n_req requests with stream lengths log-uniform in [256, max_len];
    every 16th carries a 500-cycle budget."""
    from repro_torch.core import library
    from repro_torch.serve.types import Request
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(np.log(256), np.log(max_len),
                              n_req)).astype(int)
    reqs = []
    for i, k in enumerate(lens):
        feeds = {a: np.asarray(v, np.int32) for a, v in
                 library.random_feeds(name, bench, int(k), rng).items()}
        reqs.append(Request(uid=i + 1, feeds=feeds,
                            max_cycles=500 if i % 16 == 15 else None))
    return reqs, lens


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def other_variants(tables) -> tuple:
    """The block kernel's variants the wrapper does not pick for these
    device tables but which can run them (the CTA variant beside the
    warp one)."""
    from repro_torch.kernels import dataflow_fire as df
    return tuple(v for v in df.VARIANTS if v != tables.variant
                 and (v == "cta" or tables.variant == "warp"))


def hold_blocks(dev, tables, x, prof, Ks, err, tag) -> int:
    """Both block entries on numpy ``tables`` (dense or optimized):
    batched over every stream of the random inputs ``x`` (parked ones
    included), single on stream 0, each unprofiled and profiled with the
    counters ``prof``, for each K, against the plain version, through
    the wrappers (the variant the fabric's size picks) and through the
    other variant; an optimized plan's spec kernel also against the
    dense kernel on the same permuted tables.  Returns the firings of
    the plain runs."""
    import torch
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.testing import STATE_KEYS
    dt = df.device_tables(tables, dev)
    spec = dt.class_slices is not None
    dense = df.device_tables(dict(tables, class_slices=None), dev) \
        if spec else None
    t = {k: torch.tensor(v, device=dev) for k, v in x.items()}
    args = [t["feed_vals"], t["feed_len"], *(t[k] for k in STATE_KEYS)]
    one = [a[0] for a in args]
    cnt = tuple(torch.tensor(p, device=dev) for p in prof)
    fired = 0
    for K in Ks:
        for pr in (None, cnt):
            kw = dict(n_cycles=K, active=t["active"], prof=pr)
            got = df.fire_block_batched_cuda(dt, *args, **kw)
            want = df.fire_block_batched(dt, *args, **kw)
            hold(err, block_rows(True, pr, spec), got, want,
                 f"{tag} batched K={K} prof={pr is not None}")
            fired += int(want[5].sum())
            pr1 = None if pr is None else tuple(p[0] for p in pr)
            got1 = df.fire_block_cuda(dt, *one, n_cycles=K, prof=pr1)
            want1 = df.fire_block(dt, *one, n_cycles=K, prof=pr1)
            hold(err, block_rows(False, pr, spec), got1, want1,
                 f"{tag} single K={K} prof={pr is not None}")
            for v in other_variants(dt):
                hold(err, block_rows(True, pr, spec),
                     df.launch_variant(v, dt, *args, **kw), want,
                     f"{tag} {v} batched K={K} prof={pr is not None}")
                hold(err, block_rows(False, pr, spec),
                     df.launch_variant(v, dt, *one, n_cycles=K, prof=pr1,
                                       batched=False), want1,
                     f"{tag} {v} single K={K} prof={pr is not None}")
            if spec:
                hold(err, ["fire_block_spec"], got,
                     df.fire_block_batched_cuda(dense, *args, **kw),
                     f"{tag} batched spec vs dense K={K}")
                hold(err, ["fire_block_spec"], got1,
                     df.fire_block_cuda(dense, *one, n_cycles=K, prof=pr1),
                     f"{tag} single spec vs dense K={K}")
    return fired


def hold_fire_step(dev, tables, x, err, tag) -> str:
    """The fire-step kernel against its plain version on every stream's
    registers of the random inputs ``x``: through the wrapper and in
    each variant that can run the fabric (the warp one up to 256 rows a
    table); the plain warp-order replay too.  Returns the wrapper's
    variant."""
    import torch
    from repro_torch.kernels import dataflow_fire as df
    dt = df.device_tables(tables, dev)
    variants = df.STEP_VARIANTS if dt.step_variant == "warp" else ("cta",)
    for b in range(x["full"].shape[0]):
        full = torch.tensor(x["full"][b], device=dev)
        val = torch.tensor(x["val"][b], device=dev)
        want = df.fire_step(dt, full, val)
        hold(err, ["fire_step"], df.fire_step_cuda(dt, full, val), want,
             f"{tag} fire step")
        for v in variants:
            hold(err, ["fire_step"], df.launch_step_variant(v, dt, full, val),
                 want, f"{tag} fire step, {v} variant")
        hold(err, ["fire_step"], df.fire_step_warp_order(dt, full, val),
             want, f"{tag} fire step, the warp order's replay")
    return dt.step_variant


def phase_kernel(dev) -> dict:
    """Every instantiation against its plain version on random mid-run
    states of the 7 benches and of 64 random graphs; random graphs fed
    edge operands through the engine against the oracle.  Returns each
    Pallas row's max |error|."""
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.testing import (EDGE_VALS, assert_same_result,
                                     random_block_inputs, random_graph,
                                     random_prof)
    err = dict.fromkeys(ROWS, 0)
    for name, build in library.HAND_BUILT.items():
        g = build().graph
        for opt in (False, True):
            tables = df.block_plan_arrays(g, optimize=opt)
            rng = np.random.default_rng(len(name) + 100 * opt)
            x = random_block_inputs(tables, 64, 96, rng)
            fired = hold_blocks(dev, tables, x, random_prof(tables, 64, rng),
                                (1, 16, 64, df.STAGE_CYCLES + 1), err,
                                f"{name} opt={opt}")
            check(fired > 0, f"nothing fired: {name} opt={opt}")
            if not opt:
                check(hold_fire_step(dev, tables, x, err, name) == "warp",
                      f"{name}: the fire step is not warp-sized")
        log(f"  {name:12s} dense and spec, unprofiled and profiled kernels, "
            f"warp and CTA variants == plain at B=64, K=1/16/64/"
            f"{df.STAGE_CYCLES + 1} ({int(x['active'].sum())} active); "
            f"spec == dense; fire step, warp and CTA variants == plain")
    for seed in range(64):
        g = random_graph(seed)
        rng = np.random.default_rng(seed)
        tables = df.block_plan_arrays(g, optimize=True)
        x = random_block_inputs(tables, 16, 24, rng)
        hold_blocks(dev, tables, x, random_prof(tables, 16, rng), (8,), err,
                    g.name)
        dense = df.block_plan_arrays(g)
        hold_fire_step(dev, dense, random_block_inputs(dense, 4, 1, rng),
                       err, g.name)
    log("  64 random graphs (NDMERGE/DMERGE/BRANCH among them): spec kernel "
        "== plain == dense kernel, unprofiled and profiled, warp and CTA "
        "variants, K=8; fire step, warp and CTA variants == plain")
    for seed in range(4):
        g = random_graph(seed, nodes=150)
        rng = np.random.default_rng(seed)
        tables = df.block_plan_arrays(g, optimize=seed % 2 == 1)
        check(df.block_variant(tables) == "cta", f"{g.name}: not CTA-sized")
        x = random_block_inputs(tables, 16, 96, rng)
        hold_blocks(dev, tables, x, random_prof(tables, 16, rng),
                    (8, df.STAGE_CYCLES + 1), err, f"{g.name} (150 nodes)")
        dense = df.block_plan_arrays(g)
        check(hold_fire_step(dev, dense, random_block_inputs(dense, 4, 1, rng),
                             err, f"{g.name} (150 nodes)") == "cta",
              f"{g.name}: the fire step is not CTA-sized")
    log(f"  4 random graphs of 150 nodes (CTA variants by size): kernels == "
        f"plain, unprofiled and profiled, K=8/{df.STAGE_CYCLES + 1}; fire "
        "step == plain")
    n_cases = 0
    for seed in range(24):
        g = random_graph(seed)
        rng = np.random.default_rng(seed)
        feeds = [{a: rng.choice(EDGE_VALS, 1 + (s + seed) % 5)
                  .astype(np.int32) for a in g.input_arcs()}
                 for s in range(4)]
        wants = [run_reference(g, f, max_cycles=192, profile=True)
                 for f in feeds]
        for opt in (False, True):
            eng = DataflowEngine(g, block_cycles=4 + seed % 3 * 6,
                                 max_cycles=192, device=dev, optimize=opt,
                                 profile=opt)
            got = [eng.run(f) for f in feeds] + eng.run_batch(feeds)
            for r, w in zip(got, wants + wants):
                assert_same_result(r, w, g.name, dispatches=False)
                if opt:
                    np.testing.assert_array_equal(r.node_fires, w.node_fires)
                    r.profile.check()
            n_cases += len(got)
    log(f"  {n_cases} random-graph runs (edge operands; dense, and optimized "
        "+ profiled) == run_reference")
    for name, build in sched_benches().items():
        for opt in (False, True):
            ctx = DataflowEngine(build().graph, device=dev, schedule=True,
                                 optimize=opt)._sched_ctx()
            hold_sched(dev, ctx, np.random.default_rng(len(name) + 7 * opt),
                       (1, 16, 64), err, f"{name} opt={opt}")
        log(f"  {name:12s} sched slot step == plain at B=64, K=1/16/64 "
            f"(mixed feed lengths, random plan positions, parked slots); "
            f"sched run == plain at B=16 and B=1, whole and clipped "
            f"({len(ctx.registry)} patterns)")
    return err


def sched_benches() -> dict:
    """The benches a static schedule can run (all but fibonacci)."""
    from repro_torch.core import library
    from repro_torch.core.schedule import schedulable
    return {n: b for n, b in library.HAND_BUILT.items()
            if schedulable(b().graph)}


def hold_sched(dev, ctx, rng, Ks, err, tag) -> None:
    """Both schedule kernels against their plain versions over the
    schedule context ``ctx``: the slot step at each K on random inputs
    (B = 64, L = 96), the run over 16 streams and over one, whole and
    clipped."""
    import torch
    from repro_torch.kernels import schedule_fire as ksf
    from repro_torch.testing import (STATE_KEYS, random_sched_run_inputs,
                                     random_sched_slot_inputs)
    for K in Ks:
        x = random_sched_slot_inputs(ctx, 64, K, 96, rng)
        tabs = ksf.device_sched_tables(ctx, dev)
        t = {k: torch.tensor(x[k], device=dev) for k in ("fv", *STATE_KEYS)}
        args = (t["fv"], x["pids"], x["fsel"], *(t[k] for k in STATE_KEYS))
        hold(err, ["sched_slot_step"], ksf.sched_slot_step_cuda(tabs, *args),
             ksf.sched_slot_step(tabs, *args), f"{tag} slot step K={K}")
    fv, plan = random_sched_run_inputs(ctx, 16, 96, rng)
    tabs = ksf.device_sched_tables(ctx, dev)
    fv = torch.tensor(fv, device=dev)
    for upto in (plan.total, plan.total // 2 + 1):
        program = ksf.flat_program(*plan.trace_struct(upto))
        for f in (fv, fv[:1].contiguous()):
            hold(err, ["sched_run"], ksf.sched_run_cuda(tabs, program, f),
                 ksf.sched_run(tabs, program, f),
                 f"{tag} run of {upto} cycles, B={f.shape[0]}")


def captured_state(dev, graph, reqs, slots, optimize=False, profile=False,
                   blocks=8):
    """The serving state after ``blocks`` heartbeats of a throwaway
    server over the first ``slots`` requests: the inputs the main path
    gives the kernel, taken outside it so its launch counts stay clean."""
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.serve.dataflow_server import DataflowServer
    srv = DataflowServer(graph, slots=slots, block_cycles=64, device=dev,
                         optimize=optimize, profile=profile)
    for r in reqs[:slots]:
        srv.submit(r)
    for _ in range(blocks):
        srv.step()
    st = srv.state
    active = st.active_dev
    check(int(active.sum()) > 0, f"{graph.name}: no slot still active")
    tables = df.block_plan_arrays(graph, optimize=optimize)
    return dict(np_tables=tables, tables=df.device_tables(tables, dev),
                K=64, fv=st.fv, fl=st.fl, active=active,
                one=int(active.nonzero()[0]),        # first active slot
                state=[st.full, st.val, st.ptr, st.out_last, st.out_count],
                prof=st.prof)


def kernel_vs_plain(st, tables=None, prof=None, replay=False) -> dict:
    """Both entries against their plain versions on a captured serving
    state, bit for bit, through the wrappers and through the other
    variant: the batched one at the full slot count, the single one on
    the first active slot's row.  ``tables`` (default the state's own)
    and ``prof`` (the state's counters, or None) pick the instantiation;
    ``replay`` also holds the batched kernel against the two-phase
    replay of its own cycle order (windows staged from the tokens' real
    alignment).  Returns each Pallas row's max |error|."""
    from repro_torch.kernels import dataflow_fire as df
    tables = st["tables"] if tables is None else tables
    K, act = st["K"], st["active"]
    spec = tables.class_slices is not None
    args = [st["fv"], st["fl"], *st["state"]]
    err = dict.fromkeys(ROWS, 0)
    kw = dict(n_cycles=K, active=act, prof=prof)
    want = df.fire_block_batched(tables, *args, **kw)
    got = df.fire_block_batched_cuda(tables, *args, **kw)
    hold(err, block_rows(True, prof, spec), got, want, "serving state")
    check(int(want[5].sum()) > 0, "nothing fired in the captured state")
    if replay:
        hold(err, block_rows(True, prof, spec), got,
             df.fire_block_two_phase(
                 tables, *args, misalign=st["fv"].data_ptr() // 4 % 4, **kw),
             "serving state vs the two-phase replay")
    b = st["one"]
    one = [a[b].contiguous() for a in args]
    p1 = None if prof is None else tuple(p[b].contiguous() for p in prof)
    want1 = df.fire_block(tables, *one, n_cycles=K, prof=p1)
    hold(err, block_rows(False, prof, spec),
         df.fire_block_cuda(tables, *one, n_cycles=K, prof=p1), want1,
         "serving state, B=1")
    for v in other_variants(tables):
        hold(err, block_rows(True, prof, spec),
             df.launch_variant(v, tables, *args, **kw), want,
             f"serving state, {v} variant")
        hold(err, block_rows(False, prof, spec),
             df.launch_variant(v, tables, *one, n_cycles=K, prof=p1,
                               batched=False), want1,
             f"serving state, B=1, {v} variant")
    return err


def misaligned(x, ints):
    """A contiguous copy of x whose data starts ``ints`` elements past a
    16-byte boundary."""
    import torch
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = buf[ints:ints + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def hold_sched_variants(dev, err, Bs=(1, 8, 1024), long=4096) -> dict:
    """Both variants of the run kernel bit for bit against the plain run
    on the 6 schedulable benches: B = 1, 8 and 1024 at stream lengths 1,
    W - 1, W, W + 1, 97 and 4096 (W the warp variant's window from the
    launch plan; W = 4 too), half the rows fed two tokens past their end
    (the clamp); the tokens off a 16-byte boundary by one int at B = 8;
    rows that take a token every cycle.  Returns the cases held per
    variant."""
    import torch
    from repro_torch.core.engine import DataflowEngine
    from repro_torch.kernels import schedule_fire as ksf
    from repro_torch.testing import edge_ints, every_cycle_sched
    rng = np.random.default_rng(19)
    cases = dict.fromkeys(ksf.SCHED_VARIANTS, 0)

    def run_all(tabs, program, fv, want, what):
        runs = [("cta", None, None), ("warp", 4, None)] + [
            ("warp", None, g) for g in sorted(tabs.warp["bits"])]
        for variant, window, warps in runs:
            got = ksf.launch_sched_variant(variant, tabs, program, fv,
                                           window=window, warps=warps)
            hold(err, ["sched_run"], got, want,
                 f"{what} {variant} variant (window {window or 'planned'}, "
                 f"{warps or 'planned'} warps a stream)")
            cases[variant] += 1

    for name, build in sched_benches().items():
        ctx = DataflowEngine(build().graph, device=dev,
                             schedule=True)._sched_ctx()
        n_in = ctx.in_arc.size
        plan = ctx.plan_for((long,) * n_in)
        plan.ensure(1 << 20)
        W = ksf.warp_plan(ksf.device_sched_tables(ctx, dev),
                          ksf.flat_program(*plan.trace_struct(plan.total)),
                          8, device_index(dev))["window"]
        lens = {1, W - 1, W, W + 1, 97, long}
        for L in sorted(lens):
            flen = tuple(L + 2 if r % 2 == 0 else L for r in range(n_in))
            plan = ctx.plan_for(flen)
            plan.ensure(1 << 20)
            tabs = ksf.device_sched_tables(ctx, dev)
            program = ksf.flat_program(*plan.trace_struct(plan.total))
            for B in Bs:
                fv = torch.tensor(edge_ints(rng, (B, ctx.ia_pad.size, L)),
                                  device=dev)
                want = ksf.sched_run(tabs, program, fv)
                what = f"{name} B={B} L={L} ({plan.total} cycles)"
                run_all(tabs, program, fv, want, what)
                if B == 8:
                    run_all(tabs, program, misaligned(fv, 1), want,
                            what + ", tokens 4 B off 16 B")
        log(f"  {name:12s} sched run, warp (W={W} and 4, 1 and 2 warps a "
            f"stream where the tables take them) and CTA variants "
            f"== plain at L={sorted(lens)}, B={'/'.join(map(str, Bs))}, "
            "clamped feeds, misaligned tokens")
    for L in (1, 3, 4, 5, 31, 32, 33, 97):
        host, program = every_cycle_sched(5, L, L + 9)
        tabs = ksf.upload_sched_tables(host, dev, 4)
        fv = torch.tensor(edge_ints(rng, (8, 5, L)), device=dev)
        run_all(tabs, program, fv, ksf.sched_run(tabs, program, fv),
                f"a token every cycle, L={L}")
    log("  rows fed every cycle (L=1..97): sched run, both variants == "
        "plain")
    return cases


SLOT_KERNELS = {"warp": "sched_slot_warp_kernel",
                "cta": "sched_slot_step_kernel"}


def hold_slot_variants(dev, err, Bs=(1, 8, 1024), Ks=(1, 16, 64, 65),
                       L=96) -> dict:
    """Both variants of the slot kernel bit for bit against the plain slot
    step on the 6 schedulable benches: B = 1, 8 and 1024 slots, K = 1,
    16, 64 and 65 cycles (at B = 1024 only the two longer: the run's time
    stays where it was); slots ride 8 plans of mixed feed lengths
    at random positions (past their end too), a quarter parked, pointers
    at L - 1, at L and past it (the clamp); at B = 8 also the tokens 1-3
    ints off a 16-byte boundary, and the plain replay of the warp
    variant's order.  Returns the cases held per variant."""
    import torch
    from repro_torch.core.engine import DataflowEngine
    from repro_torch.kernels import schedule_fire as ksf
    from repro_torch.testing import (STATE_KEYS, random_slot_window_inputs,
                                     slot_plans)
    rng = np.random.default_rng(20)
    cases = dict.fromkeys(ksf.SLOT_VARIANTS, 0)
    for name, build in sched_benches().items():
        ctx = DataflowEngine(build().graph, device=dev,
                             schedule=True)._sched_ctx()
        plans = slot_plans(ctx, L, rng)
        for B in Bs:
            for K in Ks if B < 1024 else Ks[2:]:
                x = random_slot_window_inputs(ctx, plans, B, K, L, rng)
                tabs = ksf.device_sched_tables(ctx, dev)
                t = {k: torch.tensor(x[k], device=dev)
                     for k in ("fv", *STATE_KEYS)}
                state = [t[k] for k in STATE_KEYS]
                ctl = (x["pids"], x["fsel"])
                want = ksf.sched_slot_step(tabs, t["fv"], *ctl, *state)
                what = f"{name} slot step B={B} K={K}"
                hold(err, ["sched_slot_step"],
                     ksf.sched_slot_step_cuda(tabs, t["fv"], *ctl, *state),
                     want, what)
                fvs = [t["fv"]]
                if B == 8:
                    fvs += [misaligned(t["fv"], m) for m in (1, 2, 3)]
                for fv in fvs:
                    mis = fv.data_ptr() // 4 % 4
                    for v in ksf.SLOT_VARIANTS:
                        hold(err, ["sched_slot_step"],
                             ksf.launch_slot_variant(v, tabs, fv, *ctl,
                                                     *state),
                             want, f"{what} {v} variant, tokens {mis} ints "
                             "off 16 B")
                        cases[v] += 1
                    if B == 8:
                        hold(err, ["sched_slot_step"],
                             ksf.sched_slot_step_staged(
                                 tabs, fv, *ctl, *state, misalign=mis),
                             want, f"{what}, the warp order's replay, "
                             f"tokens {mis} ints off 16 B")
        log(f"  {name:12s} sched slot step, warp and CTA variants == plain at "
            f"B={'/'.join(map(str, Bs))}, K={'/'.join(map(str, Ks))} "
            f"(B=1024: K={'/'.join(map(str, Ks[2:]))}) "
            f"(8 plans of mixed feed lengths, random positions, parked "
            f"slots, clamped pointers, misaligned tokens; "
            f"{len(ctx.registry)} patterns)")
    return cases


def device_index(dev) -> int:
    """The CUDA device index of ``dev``."""
    import torch
    return dev.index if dev.index is not None else torch.cuda.current_device()


def phase_norm_variants(dev, rows_list=(1, 4, 8, 131, 132, 133, 4096,
                                        14812),
                        ds=(32, 130, 2048, 4096)) -> list:
    """Every RMSNorm variant that takes the shape against the plain
    version: rows 1, 4, 8, 131-133, 4096 and 14812 by d 32, 130 (the
    generic variant only), 2048 and 4096, f32 and bf16, both roundings;
    the wrapper's choice checked against ``norm_variant``.  Returns the
    largest error per variant and dtype (tolerances of ``LM_TOL``)."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=dev).manual_seed(11)
    recs = {(v, dtn): dict(variant=v, dtype=dtn, max_abs_err=0.0,
                           tol_ratio=0.0, cases=0)
            for v in rn.VARIANTS for dtn in LM_TOL}
    for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tol = LM_TOL[dtn]["rmsnorm"]
        for rows in rows_list:
            for d in ds:
                x = (3 * torch.randn((rows, d), generator=gen,
                                     device=dev)).to(dt)
                w = 1 + 0.3 * torch.randn((d,), generator=gen, device=dev)
                vectors = d // (16 // x.element_size())
                chosen = rn.norm_variant(d, x.element_size())
                for model in (False, True):
                    want = rn.rmsnorm(x, w, model=model).float()
                    n0 = dict(rn.rmsnorm_cuda.launches_by)
                    rn.rmsnorm_cuda(x, w, model=model)
                    ran = [v for v, n in rn.rmsnorm_cuda.launches_by.items()
                           if n > n0[v]]
                    check(ran == [chosen], f"[{rows}, {d}] {dtn}: the "
                          f"wrapper ran {ran}, the rule names {chosen}")
                    for v in rn.VARIANTS:
                        if d % (16 // x.element_size()) and v != "generic":
                            continue
                        if v == "split" and vectors > 2 * rn.SPLIT_THREADS:
                            continue
                        got = rn.launch_norm_variant(v, x, w, model=model)
                        diff = (got.float() - want).abs()
                        ratio = float((diff / (tol * (1 + want.abs())))
                                      .max())
                        rec = recs[(v, dtn)]
                        rec["max_abs_err"] = max(rec["max_abs_err"],
                                                 float(diff.max()))
                        rec["tol_ratio"] = max(rec["tol_ratio"], ratio)
                        rec["cases"] += 1
                        check(ratio <= 1, f"rmsnorm {v} [{rows}, {d}] {dtn} "
                              f"model={model}: {ratio} of the tolerance")
                del x, w
    for rec in recs.values():
        log(f"  rmsnorm {rec['variant']:8s} {rec['dtype']:8s} == plain in "
            f"{rec['cases']} cases: max |err| {rec['max_abs_err']:.3g}, "
            f"{rec['tol_ratio']:.3f} of the tolerance")
    return list(recs.values())


def block_bound(tables, args, out, active_rows, K, prof):
    """The least time the card could take for one block launch: the
    bytes it must move (tables, every state and counter array read and
    written once, feed_len, active, fired/last_prog, and the feed tokens
    this launch consumed) over HBM bandwidth, against one 32-bit
    operation per node, arc, feed row and drain row (and counter) per
    active stream per cycle over the scalar rate."""
    rows, A2 = args[2].shape[0], args[2].shape[1]
    n_in, n_out = args[4].shape[1], args[5].shape[1]
    N2 = tables["opcode"].shape[0]
    table_bytes = sum(t.numel() * 4 for t in tables.values())
    tokens = int((out[2] - args[4]).sum())           # feed tokens consumed
    per_row = 2 * (2 * A2 + n_in + 2 * n_out) + n_in + 2 + 1
    per_cycle = N2 + A2 + n_in + n_out
    if prof is not None:
        per_row += 2 * (3 * N2 + 2 * A2)
        per_cycle += 3 * N2 + 2 * A2
    nbytes = table_bytes + 4 * rows * per_row + 4 * tokens
    ops = active_rows * K * per_cycle
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, tokens=tokens)


def timed(run_k, run_p, reps, kernel, plain_reps=3, plain_profile=True):
    """Kernel device time (profiler; CUDA events per call when the
    profiler sees no device time), per-call times with events, and the
    plain version's per-call and (``plain_profile``) summed device
    times (None: not measured)."""
    dev_ms = profiled_ms(run_k, reps, kernel)
    call_ms = cuda_ms(run_k, reps)
    return dict(ms=dev_ms or call_ms,
                ms_from="profiler" if dev_ms else "cuda events",
                call_ms=call_ms,
                plain_ms=cuda_ms(run_p, plain_reps, warmup=1),
                plain_device_ms=profiled_ms(run_p, 2) if plain_profile
                else None)


def time_block(st, tables, prof, batched, variant=None):
    """Times and bound of one block instantiation on a captured serving
    state: all slots (batched) or the first active slot's row (B = 1),
    through the wrapper or, with ``variant``, that variant."""
    from repro_torch.kernels import dataflow_fire as df
    K, act = st["K"], st["active"]
    args = [st["fv"], st["fl"], *st["state"]]
    variant = variant or tables.variant
    if batched:
        run_k = lambda: df.launch_variant(
            variant, tables, *args, n_cycles=K, active=act, prof=prof)
        run_p = lambda: df.fire_block_batched(
            tables, *args, n_cycles=K, active=act, prof=prof)
        b = block_bound(tables, args, run_k(), int(act.sum()), K, prof)
        shape = (f"B={args[2].shape[0]} slots ({int(act.sum())} active), "
                 f"K={K}, L={args[0].shape[2]}")
        reps = 20
    else:
        i = st["one"]
        one = [a[i].contiguous() for a in args]
        p1 = None if prof is None else tuple(p[i].contiguous() for p in prof)
        run_k = lambda: df.launch_variant(variant, tables, *one, n_cycles=K,
                                          prof=p1, batched=False)
        run_p = lambda: df.fire_block(tables, *one, n_cycles=K, prof=p1)
        b = block_bound(tables, [a[i:i + 1] for a in args],
                        [x[None] for x in run_k()], 1, K, p1)
        shape = f"B=1, K={K}, L={one[0].shape[1]}"
        reps = 50
    N2, A2 = tables["opcode"].shape[0], tables["prod_node"].shape[0]
    t = timed(run_k, run_p, reps, f"fire_block_{variant}_kernel")
    return dict(**t, **b, variant=variant, K=K,
                us_per_cycle=t["ms"] * 1e3 / K,
                shape=f"{shape}, N2={N2}, A2={A2}, {variant} variant")


STEP_KERNELS = {"warp": "fire_step_warp_kernel", "cta": "fire_step_kernel"}


def empty_launch(dev):
    """A launcher of the empty one-warp kernel (the fire step's floor)."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    lib = _build.load()

    def run():
        err = lib.fire_empty_launch(ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream))
        check(err == 0, "the empty kernel did not launch")
    return run


def time_fire_step(dev, graph):
    """Times and bound of the fire step on a random state of ``graph``'s
    tables (what ``run_fabric`` launches once per cycle): the wrapper's
    variant (device time and time per wrapper call), the other variant,
    and the floor — an empty one-warp kernel launched and timed the same
    way."""
    import torch
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.testing import random_block_inputs
    tables = df.block_plan_arrays(graph)
    dt = df.device_tables(tables, dev)
    x = random_block_inputs(tables, 1, 1, np.random.default_rng(3))
    full = torch.tensor(x["full"][0], device=dev)
    val = torch.tensor(x["val"][0], device=dev)
    run_k = lambda: df.fire_step_cuda(dt, full, val)
    run_p = lambda: df.fire_step(dt, full, val)
    N2, A2 = dt["opcode"].shape[0], dt["prod_node"].shape[0]
    # the tables the wrapper's variant reads (the warp one only the packed
    # words), full/val read and written, and fired
    tables_read = ([dt.step_words[k] for k in ("node", "arc")]
                   if dt.step_variant == "warp"
                   else [dt[k] for k in df.STEP_KEYS])
    nbytes = sum(x.numel() * 4 for x in tables_read) + 4 * (4 * A2 + 1)
    ops = N2 + A2
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    out = dict(**timed(run_k, run_p, 200, STEP_KERNELS[dt.step_variant]),
               variant=dt.step_variant)
    for v in df.STEP_VARIANTS:
        run_v = lambda v=v: df.launch_step_variant(v, dt, full, val)
        out[f"{v}_ms"] = device_ms(run_v, 200, STEP_KERNELS[v])
        out[f"{v}_call_ms"] = cuda_ms(run_v, 200)
    empty = empty_launch(dev)
    out.update(floor_ms=device_ms(empty, 200, "fire_empty_kernel"),
               floor_call_ms=cuda_ms(empty, 200))
    log(f"  fire step ({graph.name}): warp {out['warp_ms']:.5f} ms, CTA "
        f"{out['cta_ms']:.5f} ms, floor (empty one-warp kernel) "
        f"{out['floor_ms']:.5f} ms; per call: wrapper {out['call_ms']:.5f}, "
        f"warp {out['warp_call_ms']:.5f}, CTA {out['cta_call_ms']:.5f}, "
        f"empty launch {out['floor_call_ms']:.5f} ms")
    return dict(**out, bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, tokens=0,
                shape=f"{graph.name}: N2={N2}, A2={A2}, "
                      f"{dt.step_variant} variant")


def latency_floor(dev, Ks=(16, 64), long_cycles=1 << 16) -> dict:
    """The warp variant's latency floor: the device time of one warp
    running K cycles of its dependent chain with no table work
    (``fire_floor_kernel``), at each K, and the microseconds per cycle of
    a ``long_cycles`` run."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    lib = _build.load()
    out = torch.empty(32, dtype=torch.int32, device=dev)

    def run(n):
        err = lib.fire_floor_launch(
            ctypes.c_void_p(out.data_ptr()), n,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        check(err == 0, "the latency-floor kernel did not launch")

    ms = {}
    for K in Ks:
        ms[K] = device_ms(lambda: run(K), 50, "fire_floor_kernel")
    long_ms = device_ms(lambda: run(long_cycles), 5, "fire_floor_kernel")
    floor = dict(ms=ms, us_per_cycle=long_ms * 1e3 / long_cycles,
                 long_cycles=long_cycles)
    log(f"  latency floor (one warp, the chain alone): "
        + ", ".join(f"K={K} {v:.4f} ms" for K, v in ms.items())
        + f"; {floor['us_per_cycle'] * 1e3:.2f} ns per cycle over "
        f"{long_cycles} cycles")
    return floor


def log_times(times):
    for k, v in times.items():
        pd = v["plain_device_ms"]
        pd = "not measured" if pd is None else f"{pd:.3f} ms"
        per = f", {v['us_per_cycle']:.3f} us/cycle" if "us_per_cycle" in v \
            else ""
        log(f"  {k:30s} kernel {v['ms']:.4f} ms ({v['ms_from']}{per}; "
            f"{v['call_ms']:.4f} ms per wrapper call)  plain "
            f"{v['plain_ms']:.3f} ms per call ({pd} on the device)"
            f"  bound {v['bound_ms']:.6f} ms "
            f"({v['bound_by']}: {v['bytes']} B, {v['tokens']} feed tokens)"
            f"  [{v['shape']}]")


def phase_serving_states(dev, dot, dot_reqs, bub, bub_reqs, errs):
    """Every instantiation against its plain version on the serving
    states the main path gives the kernels, and their device times at
    the dot_prod states.  Returns the times by Pallas row, and by
    instantiation at the optimized, profiled state."""
    import torch
    from repro_torch.kernels import dataflow_fire as df

    def merge(err):
        for k, e in err.items():
            errs[k] = max(errs[k], e)

    times = {}
    for name, bench, slots, reqs in (("dot_prod", dot, 1024, dot_reqs),
                                     ("bubble_sort", bub, 256, bub_reqs)):
        st = captured_state(dev, bench.graph, reqs, slots)
        merge(kernel_vs_plain(st, replay=name == "dot_prod"))
        log(f"  {name:12s} dense kernel == plain on the serving state "
            f"(B={slots}, L={st['fv'].shape[2]}, K=64, "
            f"{int(st['active'].sum())} active; B=1 slot {st['one']})")
        if name == "dot_prod":
            times["fire_block_batched"] = time_block(st, st["tables"], None,
                                                     True)
            times["fire_block"] = time_block(st, st["tables"], None, False)
            times["fire_block_batched cta"] = time_block(
                st, st["tables"], None, True, "cta")
            times["fire_block cta"] = time_block(st, st["tables"], None,
                                                 False, "cta")
        del st
    # the optimized, profiled deployment's state: its tables are permuted,
    # so the dense instantiation runs on the same permuted tables without
    # the buckets
    st = captured_state(dev, dot.graph, dot_reqs, 1024, optimize=True,
                        profile=True)
    spec = st["tables"]
    dense = df.device_tables(dict(st["np_tables"], class_slices=None), dev)
    variants = {"dense": (dense, None), "spec": (spec, None),
                "prof": (dense, st["prof"]), "spec+prof": (spec, st["prof"])}
    for v, (tables, prof) in variants.items():
        merge(kernel_vs_plain(st, tables, prof))
    log(f"  dot_prod     dense, spec, prof and spec+prof kernels (warp and "
        f"CTA variants) == plain on the optimized, profiled serving state "
        f"(B=1024, L="
        f"{st['fv'].shape[2]}, {int(st['active'].sum())} active; B=1 slot "
        f"{st['one']})")
    by_variant = {v: time_block(st, t, p, True)
                  for v, (t, p) in variants.items()}
    by_variant["spec+prof B=1"] = time_block(st, spec, st["prof"], False)
    times["fire_block_batched_prof"] = by_variant["prof"]
    times["fire_block_spec"] = by_variant["spec"]
    times["fire_block_prof"] = time_block(st, dense, st["prof"], False)
    del st
    times["fire_step"] = time_fire_step(dev, dot.graph)
    torch.cuda.empty_cache()
    log_times(times)
    log("  by instantiation at the optimized, profiled dot_prod state:")
    log_times(by_variant)
    d = by_variant["dense"]["ms"]
    log(f"  ratios to dense: spec {by_variant['spec']['ms'] / d:.3f}, prof "
        f"{by_variant['prof']['ms'] / d:.3f}, spec+prof "
        f"{by_variant['spec+prof']['ms'] / d:.3f}")
    return times, by_variant


def sched_bound(tables, nbytes, work):
    """Bound of a schedule-kernel launch: ``nbytes`` plus every table once
    over HBM bandwidth, against ``work`` 32-bit operations (one per
    feed, firing and drain the schedule performs) over the scalar
    rate."""
    nbytes += sum(t.numel() * 4 for t in tables.values())
    t_b, t_o = nbytes / HBM_BYTES_PER_S, work / SCALAR_OPS_PER_S
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, work=work)


def window_work(ctx, counts) -> tuple[int, int]:
    """(feeds + firings + drains, feed tokens) of the cycles ``counts``
    (pid -> cycles) of one stream."""
    reg = ctx.registry
    ops = sum(n * (reg[p].fed.size + reg[p].n_fires + reg[p].n_drains)
              for p, n in counts.items())
    return ops, sum(n * reg[p].fed.size for p, n in counts.items())


def fire_block_cycles(tables, fv, fl, state, active, cycles, K=64):
    """The fire block run over ``cycles`` cycles in K-cycle launches:
    the dynamic path's work for the same schedule."""
    from repro_torch.kernels import dataflow_fire as df
    state = list(state)
    done = 0
    while done < cycles:
        nb = min(K, cycles - done)
        state = list(df.fire_block_batched_cuda(
            tables, fv, fl, *state, n_cycles=nb, active=active)[:5])
        done += nb
    return state


def sched_floor(tabs, program, fv, cycles, reps=10) -> dict:
    """The run kernel's latency floor: device time of the warp variant's
    own loop over ``program`` on one stream of one warp, the feed windows
    staged once (``schedule_fire.sched_floor_cuda``), and its microseconds
    per cycle."""
    from repro_torch.kernels import schedule_fire as ksf
    run = lambda: ksf.sched_floor_cuda(tabs, program, fv)
    ms = device_ms(run, reps, "sched_run_warp")
    check(ksf.sched_run_cuda.last_plan["warps"] == 1
          and ksf.sched_run_cuda.last_plan["streams"] == 1,
          "the latency floor did not run one stream of one warp")
    log(f"  sched run latency floor (one warp, its own loop over the "
        f"program, windows staged once): {ms:.4f} ms over {cycles} cycles, "
        f"{ms * 1e6 / cycles:.2f} ns per cycle")
    return dict(ms=ms, cycles=cycles, us_per_cycle=ms * 1e3 / cycles)


def time_variants(tabs, program, fv, reps, errs, want, what) -> dict:
    """Device ms of the run kernel through the wrapper and in each
    variant (the warp one on 1 and 2 warps a stream), each held against
    ``want`` first."""
    from repro_torch.kernels import schedule_fire as ksf
    runs = {"wrapper": lambda: ksf.sched_run_cuda(tabs, program, fv),
            "cta": lambda: ksf.launch_sched_variant("cta", tabs, program,
                                                    fv)}
    for g in sorted(tabs.warp["bits"]):
        runs[f"warp{g}"] = lambda g=g: ksf.launch_sched_variant(
            "warp", tabs, program, fv, warps=g)
    out = {}
    for k, run in runs.items():
        hold(errs, ["sched_run"], run(), want, f"{what}, {k}")
        out[f"{k}_ms"] = device_ms(run, reps, "sched_run")
        out[f"{k}_call_ms"] = cuda_ms(run, reps)
    return out


def time_sched_phase4(dev, ctx, n_in, errs, B=8, L=9) -> dict:
    """The run kernel at phase 4's shape (dot_prod, B = 8 streams of 9
    tokens): every variant against the plain run, and their times."""
    import torch
    from repro_torch.kernels import schedule_fire as ksf
    plan = ctx.plan_for((L,) * n_in)
    plan.ensure(1 << 20)
    program = ksf.flat_program(*plan.trace_struct(plan.total))
    tabs = ksf.device_sched_tables(ctx, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    fv = torch.randint(0, 9, (B, n_in, L), generator=gen, device=dev,
                       dtype=torch.int32)
    want = ksf.sched_run(tabs, program, fv)
    ksf.sched_run_cuda(tabs, program, fv)
    ran = dict(ksf.sched_run_cuda.last_plan)
    out = dict(B=B, L=L, cycles=plan.total, **ran,
               **time_variants(tabs, program, fv, 50, errs, want,
                               f"dot_prod B={B} L={L}"),
               floor=sched_floor(tabs, program, fv, plan.total, 50))
    log(f"  sched run at phase 4's shape (dot_prod B={B}, L={L}, "
        f"{plan.total} cycles), device ms: " + ", ".join(
            f"{k[:-3]} {v:.4f}" for k, v in out.items()
            if k.endswith("_ms") and "call" not in k)
        + f" (the wrapper runs the {out['variant']} variant, "
        f"{out['warps']} warps a stream)")
    return out


def phase_sched_states(dev, dot, dot_reqs, errs, B=1024, L=4096,
                       slots=1024):
    """The schedule kernels at full width against their plain versions
    and against the fire block over the same cycles, with their times:
    the run over B = 1024 equal L = 4096-token dot_prod streams (n = 32),
    the slot step at the scheduled serving state (1024 slots, K = 64)."""
    import torch
    from repro_torch.core.engine import DataflowEngine
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.kernels import schedule_fire as ksf
    from repro_torch.serve.dataflow_server import DataflowServer
    times, versus = {}, {}
    # the run: one launch for the whole run of every stream
    eng = DataflowEngine(dot.graph, device=dev, schedule=True)
    ctx = eng._sched_ctx()
    n_in = len(eng.p["input_arcs"])
    t0 = time.perf_counter()
    plan = ctx.plan_for((L,) * n_in)
    plan.ensure(1 << 20)
    plan_ms = (time.perf_counter() - t0) * 1e3
    program = ksf.flat_program(*plan.trace_struct(plan.total))
    tabs = ksf.device_sched_tables(ctx, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fv = torch.randint(0, 9, (B, n_in, L), generator=gen, device=dev,
                       dtype=torch.int32)
    run_k = lambda: ksf.sched_run_cuda(tabs, program, fv)
    run_p = lambda: ksf.sched_run(tabs, program, fv)
    got = run_k()
    ran = dict(ksf.sched_run_cuda.last_plan)
    hold(errs, ["sched_run"], got, run_p(), "dot_prod full-width run")
    fire_t = df.device_tables(df.block_plan_arrays(dot.graph), dev)
    fl = torch.full((B, n_in), L, dtype=torch.int32, device=dev)
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    dyn = lambda: fire_block_cycles(fire_t, fv, fl, eng._state0(batch=B),
                                    ones, plan.total)
    hold(errs, ["sched_run"], got, dyn()[3:5],
         "dot_prod full-width run vs the fire block")
    ops, tokens = window_work(ctx, plan.counts_between(0, plan.total))
    nbytes = 4 * (B * tokens + 2 * B * got[0].shape[1]
                  + sum(x.size for x in program.values()))
    times["sched_run"] = dict(
        **timed(run_k, run_p, 10, "sched_run", plain_reps=1,
                plain_profile=False),
        **sched_bound(tabs, nbytes, B * ops), tokens=B * tokens,
        shape=f"dot_prod n=32: B={B} streams of {L} tokens, "
              f"{plan.total} cycles ({len(program['seg_len'])} segments, "
              f"{len(ctx.registry)} patterns)")
    by = time_variants(tabs, program, fv, 5, errs, got,
                       "dot_prod full-width run")
    times["sched_run"].update(
        **ran, us_per_cycle=times["sched_run"]["ms"] * 1e3 / plan.total,
        by_variant=by, floor=sched_floor(tabs, program, fv, plan.total),
        phase4=time_sched_phase4(dev, ctx, n_in, errs))
    log("  sched run at full width, device ms: " + ", ".join(
        f"{k[:-3]} {v:.4f}" for k, v in by.items()
        if k.endswith("_ms") and "call" not in k))
    fire_ms = cuda_ms(dyn, 2, warmup=1)
    versus["run"] = dict(
        cycles=plan.total, sched_ms=times["sched_run"]["ms"],
        sched_us_per_cycle=times["sched_run"]["ms"] * 1e3 / plan.total,
        fire_block_ms=fire_ms,
        fire_block_launches=-(-plan.total // 64),
        fire_block_us_per_cycle=fire_ms * 1e3 / plan.total,
        plan_build_ms=plan_ms, segments=[(len(p), r) for p, r in
                                         plan.segments])
    log(f"  dot_prod     sched run == plain == the fire block over "
        f"{plan.total} cycles (B={B}, L={L}; plan built in "
        f"{plan_ms:.1f} ms: {versus['run']['segments']})")
    del fv, got
    # the slot step at the scheduled serving state
    srv = DataflowServer(dot.graph, slots=slots, block_cycles=64,
                         device=dev, optimize=True, profile=True,
                         schedule=True)
    for r in dot_reqs[:slots]:
        srv.submit(r)
    for _ in range(8):
        srv.step()
    st, ctx, K = srv.state, srv.engine._sched_ctx(), 64
    pids = np.zeros((st.slots, K), np.int32)
    fsel = np.full((st.slots,), -1, np.int32)
    ops = tokens = 0
    for b in np.nonzero(st.active)[0]:
        plan, pos = st.sched.plans[b], int(st.sched.pos[b])
        plan.ensure(pos + K)
        pids[b] = plan.pids_window(pos, pos + K)
        fsel[b] = pids[b, -1]
        o, t = window_work(ctx, plan.counts_between(pos, pos + K))
        ops, tokens = ops + o, tokens + t
    check(tokens > 0, "nothing fed in the scheduled serving state")
    tabs = ksf.device_sched_tables(ctx, dev)
    state = [st.full, st.val, st.ptr, st.out_last, st.out_count]
    run_k = lambda: ksf.sched_slot_step_cuda(tabs, st.fv, pids, fsel, *state)
    run_p = lambda: ksf.sched_slot_step(tabs, st.fv, pids, fsel, *state)
    got = run_k()
    ran = dict(ksf.sched_slot_step_cuda.last_plan)
    hold(errs, ["sched_slot_step"], got, run_p(), "scheduled serving state")
    fire_t = df.device_tables(df.block_plan_arrays(dot.graph, optimize=True),
                              dev)
    dyn = lambda: df.fire_block_batched_cuda(
        fire_t, st.fv, st.fl, *state, n_cycles=K, active=st.active_dev)
    hold(errs, ["sched_slot_step"], got, dyn()[:5],
         "scheduled serving state vs the fire block")
    by = {}
    for v in ksf.SLOT_VARIANTS:
        run_v = lambda v=v: ksf.launch_slot_variant(v, tabs, st.fv, pids,
                                                    fsel, *state)
        hold(errs, ["sched_slot_step"], run_v(), got,
             f"scheduled serving state, {v} variant")
        hold(errs, ["sched_slot_step"], run_v(), dyn()[:5],
             f"scheduled serving state vs the fire block, {v} variant")
        by[f"{v}_ms"] = device_ms(run_v, 20, SLOT_KERNELS[v])
        by[f"{v}_call_ms"] = cuda_ms(run_v, 20)
    # the floor: the warp variant on one warp over the first active slot
    b0 = int(np.nonzero(st.active)[0][0])
    one = [x[b0:b0 + 1] for x in (st.fv, *state)]
    run_f = lambda: ksf.sched_slot_floor_cuda(tabs, one[0], pids[b0:b0 + 1],
                                              fsel[b0:b0 + 1], *one[1:])
    hold(errs, ["sched_slot_step"], run_f(), [x[b0:b0 + 1] for x in got],
         f"scheduled serving state, slot {b0} alone on one warp")
    floor_ms = device_ms(run_f, 20, SLOT_KERNELS["warp"])
    live = int(sum(ctx.registry[p].fed.size + ctx.registry[p].n_fires
                   + ctx.registry[p].n_drains > 0 for p in pids[b0]))
    per_row = 2 * (2 * ctx.A2 + 2 * ctx.oa_pad.size + ctx.ia_pad.size)
    nbytes = 4 * (st.slots * (per_row + K + 1) + tokens)
    active = int(st.active.sum())
    times["sched_slot_step"] = dict(
        **timed(run_k, run_p, 20, SLOT_KERNELS[ran["variant"]]),
        **sched_bound(tabs, nbytes, ops), tokens=tokens, **ran, K=K,
        by_variant=by, floor_ms=floor_ms, floor_slot=b0,
        floor_cycles_run=live, patterns=len(ctx.registry),
        shape=f"B={st.slots} slots ({active} active), K={K}, "
              f"L={st.fv.shape[2]}, A2={ctx.A2}, {len(ctx.registry)} "
              "patterns")
    log(f"  sched slot step at the scheduled serving state "
        f"({len(ctx.registry)} patterns in the registry; the wrapper runs "
        f"the {ran['variant']} "
        f"variant, {ran['streams']} slots a CTA, one warp a slot), device "
        f"ms: " + ", ".join(
            f"{k[:-3]} {v:.4f}" for k, v in by.items()
            if not k.endswith("call_ms"))
        + f"; floor (slot {b0} alone on one warp, {live} of {K} cycles "
        f"doing work) {floor_ms:.4f}")
    fire_ms = device_ms(dyn, 20, "fire_block_")
    versus["slot_step"] = dict(
        cycles=K, sched_ms=times["sched_slot_step"]["ms"],
        fire_block_ms=fire_ms, active=active,
        sched_us_per_cycle=times["sched_slot_step"]["ms"] * 1e3 / K,
        fire_block_us_per_cycle=fire_ms * 1e3 / K)
    log(f"  dot_prod     sched slot step == plain == the fire block on the "
        f"scheduled serving state (B={st.slots}, {active} active, K={K})")
    del srv, st, state, got
    torch.cuda.empty_cache()
    log_times(times)
    log(f"  sched vs fire block: {json.dumps(versus)}")
    return times, versus


# ---------------------------------------------------------------------------
# phase 4: the engine, the passes and the per-cycle baseline
# ---------------------------------------------------------------------------
def hold_engine(got, want, tag, profile, same_window) -> None:
    """Every EngineResult field of ``got`` equals the oracle's; with
    ``profile`` also node_fires and the counter partition, and with
    ``same_window`` (both simulated the same cycles) every counter."""
    from repro_torch.testing import assert_same_result
    assert_same_result(got, want, tag, dispatches=False)
    if not profile:
        check(got.profile is None and got.node_fires is None,
              f"{tag}: an unprofiled run carries a profile")
        return
    np.testing.assert_array_equal(got.node_fires, want.node_fires,
                                  err_msg=str(tag))
    got.profile.check()
    if same_window:
        assert_same_result(got, want, tag, dispatches=False, profile=True)


def phase_engine(dev):
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine, run_reference
    for name, build in library.HAND_BUILT.items():
        bench = build()
        feeds = [library.random_feeds(name, bench, 1 + 3 * b,
                                      np.random.default_rng(b))
                 for b in range(8)]
        wants = [run_reference(bench.graph, f, profile=True) for f in feeds]
        for opt in (False, True):
            for prof in (False, True):
                for K in (1, 16, 64):
                    eng = DataflowEngine(bench.graph, block_cycles=K,
                                         device=dev, optimize=opt,
                                         profile=prof)
                    tag = (name, K, opt, prof)
                    for f, w in zip(feeds, wants):
                        # one-cycle blocks simulate the oracle's cycles
                        hold_engine(eng.run(f), w, tag, prof, K == 1)
                    for g, w in zip(eng.run_batch(feeds), wants):
                        hold_engine(g, w, tag + ("batch",), prof, False)
        log(f"  {name:12s} run + run_batch(B=8) == run_reference, "
            "optimize x profile, K=1/16/64 (K=1: every counter)")


def phase_engine_sched(dev):
    """``schedule=True`` on the schedulable benches: every run one launch
    of the run kernel (equal-length batches too), every field equal to
    the oracle's, profile included (a scheduled run's profile covers the
    oracle's cycles exactly)."""
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.kernels import schedule_fire as ksf
    for name, build in sched_benches().items():
        bench = build()
        feeds = [library.random_feeds(name, bench, 1 + 3 * b,
                                      np.random.default_rng(b))
                 for b in range(4)]
        batch = [library.random_feeds(name, bench, 9,
                                      np.random.default_rng(10 + b))
                 for b in range(8)]      # one length: one scheduled launch
        wants = [run_reference(bench.graph, f, profile=True)
                 for f in feeds + batch]
        for opt in (False, True):
            for prof in (False, True):
                eng = DataflowEngine(bench.graph, block_cycles=16,
                                     device=dev, optimize=opt, profile=prof,
                                     schedule=True)
                tag = (name, "sched", opt, prof)
                n0 = ksf.sched_run_cuda.launches
                got = [eng.run(f) for f in feeds] + eng.run_batch(batch)
                check(ksf.sched_run_cuda.launches == n0 + len(feeds) + 1,
                      f"{tag}: a scheduled run missed the run kernel")
                for g, w in zip(got, wants):
                    hold_engine(g, w, tag, prof, True)
        log(f"  {name:12s} schedule=True run + run_batch(B=8) == "
            "run_reference, optimize x profile (every counter); one run "
            "kernel launch each")


def phase_passes(dev):
    """``optimize_graph`` fabrics on the card keep the authored fabric's
    outputs and token counts."""
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.core.passes import optimize_graph
    for name, build in library.HAND_BUILT.items():
        bench = build()
        g, rep = optimize_graph(bench.graph)
        eng = DataflowEngine(g, block_cycles=16, device=dev, optimize=True,
                             profile=True)
        for b in range(4):
            f = library.random_feeds(name, bench, 2 + 5 * b,
                                     np.random.default_rng(b))
            want = run_reference(bench.graph, f)
            got = eng.run(f)
            check(got.counts == want.counts, f"{name}: counts after passes")
            for a, c in want.counts.items():
                check(c == 0 or int(got.outputs[a]) == int(want.outputs[a]),
                      f"{name}: {a} after passes")
            got.profile.check()
            check(got.profile.fired == got.fired, f"{name}: node_fires sum")
        log(f"  {name:12s} optimize_graph ({rep.summary()}): outputs and "
            "counts == the authored fabric's")


def phase_run_fabric(dev) -> dict:
    """``run_fabric`` (one fire-step launch and one read per cycle) on the
    7 benches against ``run_reference``, and its microseconds per cycle
    beside the fused engine's at K = 16 on the same feeds (the JAX
    package's Table-1 sweep: 20 iterations for fibonacci, 8 tokens
    otherwise, B = 1)."""
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.kernels import ops
    from repro_torch.testing import assert_same_result

    def wall_us(fn, reps=3):
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return float(np.median(ts)) * 1e6

    table = {}
    for name, build in library.HAND_BUILT.items():
        bench = build()
        k = 20 if name == "fibonacci" else 8
        feeds = library.random_feeds(name, bench, k, np.random.default_rng(0))
        want = run_reference(bench.graph, feeds)
        compiled = ops.make_fire_step(bench.graph, dev)
        by0 = dict(df.fire_step_cuda.launches_by)
        got = ops.run_fabric(bench.graph, feeds, compiled=compiled,
                             device=dev)
        assert_same_result(got, want, (name, "run_fabric"), dispatches=False)
        check(got.dispatches == got.cycles, f"{name}: one launch per cycle")
        by = df.fire_step_cuda.launches_by
        check(by["warp"] - by0["warp"] == got.cycles
              and by["cta"] == by0["cta"],
              f"{name}: run_fabric did not launch the warp fire step every "
              "cycle")
        eng = DataflowEngine(bench.graph, block_cycles=16, device=dev)
        fused = eng.run(feeds)
        assert_same_result(fused, want, (name, "fused"), dispatches=False)
        eng64 = DataflowEngine(bench.graph, block_cycles=64, device=dev)
        fused64 = eng64.run(feeds)
        assert_same_result(fused64, want, (name, "fused K=64"),
                           dispatches=False)
        per = wall_us(lambda: ops.run_fabric(bench.graph, feeds,
                                             compiled=compiled, device=dev))
        fus = wall_us(lambda: eng.run(feeds))
        fus64 = wall_us(lambda: eng64.run(feeds))
        table[name] = dict(cycles=got.cycles,
                           percycle_us_per_cycle=per / got.cycles,
                           fused_k16_us_per_cycle=fus / fused.cycles,
                           fused_dispatches=fused.dispatches,
                           fused_k64_us_per_cycle=fus64 / fused64.cycles,
                           fused_k64_dispatches=fused64.dispatches,
                           ratio=per / fus)
        log(f"  {name:12s} run_fabric == run_reference ({got.cycles} cycles,"
            f" {got.dispatches} launches): {per / got.cycles:.1f} us/cycle;"
            f" fused K=16: {fus / fused.cycles:.2f} us/cycle "
            f"({fused.dispatches} launches), K=64: "
            f"{fus64 / fused64.cycles:.2f} us/cycle; ratio "
            f"{per / fus:.1f}x")
    return table


# ---------------------------------------------------------------------------
# phase 4b: compile() and the "torch" backend
# ---------------------------------------------------------------------------
# the JAX package's ALU edge operands (its tests/test_passes.py), and float
# shift counts at every integer in [-149, 126] (ROADMAP C8)
ALU_EDGES = {
    "int32": [-(2 ** 31), -(2 ** 31) + 1, -40, -2, -1, 0, 1, 5, 31, 32, 33,
              40, 2 ** 31 - 1],
    "uint32": [0, 1, 2, 5, 7, 31, 32, 40, 2 ** 31, 2 ** 32 - 1],
    "float32": [-np.inf, -200.0, -13.0, -1.5, -0.0, 0.0, 0.5, 1.0, 13.0,
                126.0, 200.0, np.inf],
}
COMPILE_CAP = 96        # cycle cap of phase 4b's random fabrics (they may
                        # run free)


def hold_torch_alu(dev) -> int:
    """The torch ALU on the card against ``alu_numpy`` on the edge
    operands, bit for bit (a NaN only has to meet a NaN): int32 wraps
    (INT_MIN // -1, shifts past the clip), uint32 in its int64 carrier,
    the float signed-zero tie of MAX/MIN, and float SHL/SHR at every
    integral shift count in [-149, 126]."""
    from repro_torch.core.engine import (_alu_op, alu_numpy, from_carrier,
                                         to_carrier)
    from repro_torch.core.graph import Op
    from repro_torch.testing import tokens_equal
    n = 0
    for dtype, vals in ALU_EDGES.items():
        dt = np.dtype(dtype)
        vals = np.asarray(vals, dt)
        A, B = np.meshgrid(vals, vals)
        for op in Op:
            if op in (Op.DMERGE, Op.NDMERGE):
                continue
            a, b = A.ravel(), B.ravel()
            if dtype == "float32" and op in (Op.SHL, Op.SHR):
                X, Y = np.meshgrid(vals, np.arange(-149, 127, dtype=dt))
                a, b = X.ravel(), Y.ravel()
            got = from_carrier(_alu_op(op, to_carrier(a, dt, dev),
                                       to_carrier(b, dt, dev), dt), dt)
            with np.errstate(all="ignore"):
                want = np.asarray(alu_numpy(op, a, b, dt), dt)
            check(tokens_equal(got, want), f"torch ALU {op.name} {dtype} on "
                  "the card != alu_numpy")
            n += a.size
    log(f"  torch ALU on the card == alu_numpy on {n} edge operand pairs "
        "(int32, uint32, float32; float shifts at every integer in "
        "[-149, 126])")
    return n


def stream_and_expected(name, bench, k, seed):
    """A k-token stream (the draws of ``library.random_feeds``) and each
    output arc's expected k tokens from the bench's own reference, for the
    DAG benches."""
    rng = np.random.default_rng(seed)
    n = len(bench.graph.input_arcs())
    if name == "dot_prod":
        a, b = rng.integers(0, 9, (k, n // 2)), rng.integers(0, 9, (k, n // 2))
        return bench.make_feeds(a, b), {bench.out_arc: bench.reference(a, b)}
    if name == "pop_count":
        x = rng.integers(0, 2 ** 16, (k,))
    elif name == "fir":
        x = rng.integers(0, 99, (k + n - 1,))
    else:
        x = rng.integers(0, 99, (k, n))
    ref = bench.reference(x)
    if bench.out_arcs:
        return bench.make_feeds(x), {a: ref[:, i]
                                     for i, a in enumerate(bench.out_arcs)}
    return bench.make_feeds(x), {bench.out_arc: ref}


def phase_compile_benches(dev) -> dict:
    """(a) Every executor of ``compile`` on the 7 benches in int32, 16-token
    streams: "dag" where legal, "unrolled", "torch" and "cuda" at K = 1, 16
    and 64, optimize False / "spec" / "full" / "sched" where legal, profile
    off and on for the engines; two streams batched (and one solo at
    K = 1), every field
    against ``run_reference`` of the compiled fabric (at K > 1 the profile
    on node_fires, its full arrays at K = 1), and "dag" streams against
    each bench's own reference.  The cuda routes must raise the kernels'
    launch counts: optimize="sched" the scheduled run (row 7),
    optimize="full" with profile=True the profiled and specialized blocks
    (rows 2, 4, 5), the unprofiled dense engine rows 1 and 3."""
    from repro_torch.core import compile as tc
    from repro_torch.core import library
    from repro_torch.core.engine import run_reference
    from repro_torch.testing import assert_same_result, tokens_equal
    deltas = {k: 0 for k in ("sched", "full_prof", "dense")}
    rows_of = {"sched": ("sched_run",),
               "full_prof": ("fire_block_prof", "fire_block_batched_prof",
                             "fire_block_spec"),
               "dense": ("fire_block", "fire_block_batched")}
    grew = {k: {r: 0 for r in v} for k, v in rows_of.items()}
    n_runs = 0
    t0 = time.perf_counter()
    for name, build in library.HAND_BUILT.items():
        bench = build()
        feeds = [library.random_feeds(name, bench, 16,
                                      np.random.default_rng(s))
                 for s in range(2)]
        wants = {}
        for opt in (False, "spec", "full", "sched"):
            for backend in ("torch", "cuda"):
                for K in (1, 16, 64):
                    for prof in (False, True):
                        before = launch_counts()
                        run = tc.compile(bench.graph, block_cycles=K,
                                         backend=backend, optimize=opt,
                                         profile=prof, device=dev)
                        key = tasm_key(run.graph)
                        if key not in wants:
                            wants[key] = [run_reference(run.graph, f,
                                                        profile=True)
                                          for f in feeds]
                        # a solo run at K = 1, two streams batched always
                        got = run.engine.run_batch(feeds)
                        if K == 1:
                            got.append(run(feeds[1]))
                        tag = (name, backend, K, opt, prof)
                        for g, w in zip(got, wants[key] + wants[key][1:]):
                            hold_engine(g, w, tag, prof, K == 1)
                        n_runs += len(got)
                        if backend != "cuda":
                            continue
                        after = launch_counts()
                        group = ("sched" if opt == "sched" else "full_prof"
                                 if opt == "full" and prof else "dense"
                                 if opt is False and not prof else None)
                        if group == "sched" and name == "fibonacci":
                            group = None    # not schedulable: dynamic
                        if group:
                            deltas[group] += 1
                            for r in rows_of[group]:
                                grew[group][r] += after[r] - before[r]
        for opt in (False, "full"):
            for K in (1, 16, 64):
                run = tc.compile(bench.graph, block_cycles=K,
                                 backend="unrolled", optimize=opt,
                                 device=dev)
                key = tasm_key(run.graph)
                wants.setdefault(key, [run_reference(run.graph, f)
                                       for f in feeds])
                for f, w in zip(feeds, wants[key]):
                    got = run(f)
                    assert_same_result(got, w, (name, "unrolled", K, opt),
                                       dispatches=False)
                    check(got.dispatches is None and got.profile is None,
                          f"{name}: the unrolled executor reports "
                          "dispatches or a profile")
                    n_runs += 1
            if not tc.GraphTraits.probe(bench.graph).tokens_out_static:
                continue
            run = tc.compile(bench.graph, backend="dag", optimize=opt,
                             device=dev)
            f, expected = stream_and_expected(name, bench, 16, 3)
            out = run(f)
            for a, v in expected.items():
                check(tokens_equal(out[a], np.asarray(v, np.int32)),
                      f"{name}: dag stream {a} != the bench's reference")
            n_runs += 1
        log(f"  {name:12s} compile(): dag / unrolled / torch / cuda x K=1/16/"
            f"64 x optimize x profile == run_reference "
            f"({time.perf_counter() - t0:.1f} s so far)")
    for group, rows in grew.items():
        for r, d in rows.items():
            check(d > 0, f"compile(backend='cuda') {group} runs launched "
                  f"{r} no time")
    log(f"  {n_runs} runs; launches by the cuda routes: "
        f"{json.dumps(grew)}")
    return dict(runs=n_runs, cuda_launches=grew,
                seconds=time.perf_counter() - t0)


def tasm_key(graph) -> str:
    from repro_torch.core import asm
    return asm.emit(graph)


def phase_compile_dtypes(dev) -> dict:
    """(b) "torch", "dag", "unrolled" and "reference" in uint32 and float32
    and on tokens of shape (4,), on the 7 benches and 16 random fabrics
    fed edge operands of the dtype, bit for bit against ``run_reference``
    (float shift counts are integral: the benches' and the random
    fabrics' const buses, ``testing.FLOAT_SHIFTS``): two streams batched
    on "torch" (profiled, K = 16), one on the others, random fabrics cut
    at 96 cycles; "dag" streams also against the same executor on the
    CPU."""
    from repro_torch.core import compile as tc
    from repro_torch.core import library
    from repro_torch.core.engine import run_reference
    from repro_torch.testing import (assert_same_result, edge_feeds,
                                     random_graph, tokens_equal)
    t0 = time.perf_counter()
    n_runs = 0
    for dtype, ts in (("uint32", ()), ("float32", ()), ("int32", (4,)),
                      ("float32", (4,))):
        dt = np.dtype(dtype)
        fabrics = []
        for name, build in library.HAND_BUILT.items():
            bench = build()
            fabrics.append((bench.graph, [library.random_feeds(
                name, bench, 16, np.random.default_rng(s)) for s in range(2)]))
        for seed in range(16):
            g = random_graph(seed, dtype=dt)
            rng = np.random.default_rng(seed)
            fabrics.append((g, [edge_feeds(g, dt, 1 + (seed + s) % 5, rng)
                                for s in range(2)]))
        for g, feeds in fabrics:
            if ts:
                feeds = [{a: np.asarray(v)[:, None] + np.arange(ts[0],
                                                                dtype=dt)
                          for a, v in f.items()} for f in feeds]
            wants = [run_reference(g, f, ts, dt, COMPILE_CAP, profile=True)
                     for f in feeds]
            tag = (g.name, dtype, ts)
            run = tc.compile(g, ts, dt, COMPILE_CAP, "torch", 16,
                             profile=True, device=dev)
            for r, w in zip(run.engine.run_batch(feeds), wants):
                hold_engine(r, w, tag + ("torch",), True, False)
            for backend in ("unrolled", "reference"):
                run = tc.compile(g, ts, dt, COMPILE_CAP, backend,
                                 device=dev)
                assert_same_result(run(feeds[0]), wants[0], tag + (backend,),
                                   dispatches=False)
            n_runs += 2 + len(feeds)
            if tc.GraphTraits.probe(g).tokens_out_static:
                f = feeds[1]
                out = tc.compile(g, ts, dt, backend="dag", device=dev)(f)
                cpu = tc.compile(g, ts, dt, backend="dag", device="cpu")(f)
                for a, v in out.items():
                    check(tokens_equal(v, cpu[a]) and tokens_equal(
                        v[-1], wants[1].outputs[a]), f"{tag}: dag {a}")
                n_runs += 1
        log(f"  {dtype} tokens of shape {ts}: torch / unrolled / reference "
            f"(/ dag) on 7 benches and 16 random fabrics == run_reference "
            f"({time.perf_counter() - t0:.1f} s so far)")
    return dict(runs=n_runs, seconds=time.perf_counter() - t0)


def _import_engine() -> None:
    """A worker's first task: import the oracle before it is timed."""
    import repro_torch.core.engine  # noqa: F401


def _reference_stream(graph, feeds):
    """run_reference in a worker process (phase 4b's sampled streams)."""
    from repro_torch.core.engine import run_reference
    return run_reference(graph, feeds)


def phase_compile_full_width(dev, B=1024, L=4096, n=32) -> dict:
    """(c) Phase 5's deployment through compile(): dot_prod n = 32 (63
    nodes, 127 arcs), B = 1024 streams of L = 4096 tokens (1.07 GB of
    feeds).  ``run_batch`` of compile(backend="torch") in int32 and
    float32, of compile(backend="cuda") and compile(backend="cuda",
    optimize="sched") in int32, K = 64; every int32 result equal field
    for field across the three, the float32 run's equal in value; 8
    sampled streams equal to run_reference (in 8 worker processes, started
    and warmed before the timed runs, given the streams after them);
    "dag" over all B x L tokens against the bench's reference;
    "unrolled" on stream 0.  Wall time of each executor, and
    microseconds per fabric cycle (for "dag", per cycle the engines take
    for the same tokens)."""
    import concurrent.futures
    import multiprocessing
    import torch
    from repro_torch.core import compile as tc
    from repro_torch.core import library
    bench = library.dot_product_graph(n)
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=8, mp_context=multiprocessing.get_context("spawn"))
    try:
        warm = [pool.submit(_import_engine) for _ in range(8)]
        out = _full_width_runs(dev, tc, bench, B, L, n, pool, warm)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    torch.cuda.empty_cache()
    return out


def _full_width_runs(dev, tc, bench, B, L, n, pool, warm) -> dict:
    """The body of :func:`phase_compile_full_width`, with its worker pool
    started."""
    import torch
    from repro_torch.testing import assert_same_result, tokens_equal
    g = bench.graph
    rng = np.random.default_rng(21)
    t_gen = time.perf_counter()
    a = rng.integers(0, 9, (B, L, n), dtype=np.int32)
    b = rng.integers(0, 9, (B, L, n), dtype=np.int32)
    feeds = [bench.make_feeds(a[i], b[i]) for i in range(B)]
    sample = [0, *sorted(np.random.default_rng(22).choice(
        np.arange(1, B), 7, replace=False).tolist())]
    for w in warm:
        w.result()
    log(f"  {B} streams of {L} tokens made in "
        f"{time.perf_counter() - t_gen:.1f} s (8 workers started and "
        f"warmed beside); sampled streams {sample}")
    out = {}

    def timed_run(key, fn, cycles=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        cycles = cycles or (res[0] if isinstance(res, list) else res).cycles
        out[key] = dict(wall_s=wall, fabric_cycles=cycles,
                        us_per_cycle=wall / cycles * 1e6)
        log(f"  {key}: {wall:.3f} s wall, {wall / cycles * 1e6:.1f} us per "
            f"fabric cycle ({cycles} cycles)")
        return res

    runs = {}
    for key, backend, opt, dtype in (
            ("torch_int32", "torch", False, np.int32),
            ("cuda_int32", "cuda", False, np.int32),
            ("cuda_sched_int32", "cuda", "sched", np.int32),
            ("torch_float32", "torch", False, np.float32)):
        run = tc.compile(g, (), dtype, backend=backend, block_cycles=64,
                         optimize=opt, device=dev)
        check(run.engine._sched_on is (opt == "sched"),
              f"{key}: the schedule flag")
        runs[key] = timed_run(key, lambda: run.engine.run_batch(feeds))
    base = runs["torch_int32"]
    cycles = base[0].cycles
    for key in ("cuda_int32", "cuda_sched_int32"):
        for i, (x, y) in enumerate(zip(runs[key], base)):
            assert_same_result(x, y, (key, i), dispatches=False)
    for i, (x, y) in enumerate(zip(runs["torch_float32"], base)):
        check(x.cycles == y.cycles and x.fired == y.fired
              and x.counts == y.counts
              and float(x.outputs["dot"]) == float(y.outputs["dot"]),
              f"float32 stream {i} != the int32 run")
    del runs
    at = torch.from_numpy(a.reshape(B * L, n)).to(dev)
    bt = torch.from_numpy(b.reshape(B * L, n)).to(dev)
    dag_feeds = {f"a{i}": at[:, i] for i in range(n)}
    dag_feeds.update({f"b{i}": bt[:, i] for i in range(n)})
    dag = tc.compile(g, backend="dag", device=dev)
    got = timed_run("dag_int32", lambda: dag(dag_feeds), cycles)
    want = (a.astype(np.int64) * b).sum(-1).reshape(-1)
    check(tokens_equal(got["dot"], want), "dag != the bench's reference "
          f"over all {B * L} tokens")
    del at, bt, dag_feeds, got
    unrolled = tc.compile(g, backend="unrolled", device=dev)
    one = timed_run("unrolled_int32_one_stream", lambda: unrolled(feeds[0]))
    # the oracle on the sampled streams, one worker process each
    t_ref = time.perf_counter()
    refs = list(pool.map(_reference_stream, [g] * len(sample),
                         [feeds[i] for i in sample]))
    assert_same_result(one, refs[0], "unrolled", dispatches=False)
    for i, w in zip(sample, refs):
        assert_same_result(base[i], w, ("sampled", i), dispatches=False)
    log(f"  run_reference on the {len(sample)} sampled streams: "
        f"{time.perf_counter() - t_ref:.1f} s in {len(sample)} processes")
    log(f"  full width: every int32 result equal across torch / cuda / "
        f"cuda sched; {len(sample)} sampled streams == run_reference; dag "
        f"== the bench's reference on {B * L} tokens; unrolled == "
        "run_reference")
    out["shape"] = f"dot_prod n={n}, B={B}, L={L}, K=64"
    return out


def phase_compile(dev) -> dict:
    """Phase 4b: the torch ALU's edges on the card, then (a), (b), (c)."""
    t0 = time.perf_counter()
    out = dict(alu_pairs=hold_torch_alu(dev))
    out["benches"] = phase_compile_benches(dev)
    out["dtypes"] = phase_compile_dtypes(dev)
    out["full_width"] = phase_compile_full_width(dev)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card_line()
    return out


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------
def time_slot_api(engine) -> tuple[dict, list]:
    """Wrap the engine's slot-API methods with wall-clock accumulators
    (seconds per method; step_block ends in its one device sync, so its
    time includes the kernel) and record each heartbeat's block length.
    Returns the live totals and the block lengths."""
    totals, blocks = {}, []
    for k in ("reset_slots", "step_block", "harvest"):
        fn = getattr(engine, k)
        totals[k] = 0.0

        def timed_call(*a, _fn=fn, _k=k, **kw):
            if _k == "step_block":
                blocks.append(kw["n_cycles"])
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                totals[_k] += time.perf_counter() - t
        setattr(engine, k, timed_call)
    return totals, blocks


def expected_last(name, bench, feeds):
    """Bench.reference on a request's last input vector: the last value
    each output arc must drain."""
    if name == "dot_prod_traced":       # in0..in31 are a, in32..in63 b
        v = np.stack([feeds[f"in{i}"][-1:] for i in range(64)], 1)
        return np.atleast_1d(bench.reference(v[:, :32], v[:, 32:])[-1])
    if name == "dot_prod":
        a = np.stack([feeds[f"a{i}"][-1:] for i in range(32)], 1)
        b = np.stack([feeds[f"b{i}"][-1:] for i in range(32)], 1)
        return np.atleast_1d(bench.reference(a, b)[-1])
    v = np.stack([feeds[f"x{i}"][-1:] for i in range(8)], 1)
    return bench.reference(v)[-1]


def phase_serving(dev, name, bench, slots, reqs, lens, optimize=False,
                  profile=False, schedule=False, partition=None,
                  capture=None):
    """Serve the workload; check every result against Bench.reference
    (and, profiled, every profile's partition); return the stats, the
    results sorted by uid, the server's cap and the heartbeats' block
    lengths.  ``partition`` serves it sharded (each block one launch of
    the sharded block kernel); ``capture`` (a dict) receives a copy of
    the slot state after the first 8 heartbeats, the state the main path
    gives the kernel."""
    import torch
    from repro_torch.core import library
    from repro_torch.serve.dataflow_server import DataflowServer
    torch.cuda.reset_peak_memory_stats()
    srv = DataflowServer(bench.graph, slots=slots, block_cycles=64,
                         device=dev, optimize=optimize, profile=profile,
                         schedule=schedule, partition=partition)
    check(srv.engine._sched_on == schedule, "the schedule flag was lost")
    host_s, blocks = time_slot_api(srv.engine)
    batched0 = launch_counts()
    half = len(reqs) // 2
    t0 = time.perf_counter()
    for r in reqs[:half]:
        srv.submit(r)
    results = []
    for _ in range(8):
        results += srv.step()
    if capture is not None:
        t_cap = time.perf_counter()
        capture.update(copy_slot_state(srv))
        t0 += time.perf_counter() - t_cap    # the copy is not served time
    for r in reqs[half:]:
        srv.submit(r)
    results += srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in list(vars(srv.engine)):
        if k in host_s:
            delattr(srv.engine, k)          # back to the plain methods
    row = "sched_slot_step" if schedule else \
        ("mf_block" if partition else "fire_block_batched") \
        + ("_prof" if profile else "")
    launches = launch_counts()[row] - batched0[row]
    if schedule:
        warp = launch_counts()["sched_slot_step_by"]["warp"] - \
            batched0["sched_slot_step_by"]["warp"]
        check(warp == launches, f"{warp} of {launches} scheduled slot steps "
              "ran the warp variant")
    check(len(results) == len(reqs), "a request got no result")
    check(len(blocks) == srv.block, "a heartbeat went unrecorded")
    results.sort(key=lambda r: r.uid)
    out_arcs = bench.out_arcs or [bench.out_arc]
    truncated = []
    for r, req, k in zip(results, reqs, lens):
        check(r.uid == req.uid and r.error is None, f"request {r.uid}")
        if profile:
            r.engine.profile.check()
            check(r.engine.profile.fired == r.engine.fired,
                  f"request {r.uid}: node_fires sum")
        else:
            check(r.engine.profile is None, f"request {r.uid}: profile")
        if req.max_cycles is not None:
            check(r.status == "truncated" and r.engine.cycles == 500,
                  f"request {r.uid} should truncate at 500 cycles")
            truncated.append(r.uid)
            continue
        check(r.status == "ok", f"request {r.uid}: {r.status}")
        last = expected_last(name, bench, req.feeds)
        for i, a in enumerate(out_arcs):
            check(r.engine.counts[a] == library.tokens_out(name, int(k)),
                  f"request {r.uid}: {a} count")
            check(int(r.engine.outputs[a]) == int(last[i]),
                  f"request {r.uid}: {a} value")
    check(srv.block == launches,
          f"{srv.block} server blocks but {launches} kernel launches")
    res = np.array([r.metrics.residency_blocks for r in results])
    stats = dict(requests=len(reqs), slots=slots, optimize=optimize,
                 profile=profile, schedule=schedule, partition=partition,
                 blocks=srv.block,
                 launches=launches,
                 wall_s=wall, req_per_s=len(reqs) / wall,
                 tokens=int(lens.sum()), truncated=len(truncated),
                 residency_p50=float(np.percentile(res, 50)),
                 residency_p99=float(np.percentile(res, 99)),
                 launches_per_request=launches / len(reqs),
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 seconds_in={k: round(v, 4) for k, v in host_s.items()},
                 card=card_line())
    log(f"  {bench.graph.name} optimize={optimize} profile={profile} "
        f"schedule={schedule} partition={partition}: {json.dumps(stats)}")
    return stats, results, srv.max_cycles, blocks


def replay(engine, req, result, blocks, cap):
    """The request alone through the slot API, riding the same block
    lengths the server gave it: the solo run whose every field (launch
    count and profile window included) the served result must equal."""
    m = result.metrics
    st = engine.init_state(1)
    st = engine.reset_slots(st, [0], [req.feeds], caps=[cap])
    for nb in blocks[m.admitted_block:m.finished_block]:
        st = engine.step_block(st, n_cycles=nb)
    _, (res,) = engine.harvest(st, [0])
    return res


def check_sampled(dev, bench, reqs, results, max_cycles, blocks,
                  optimize=False, profile=False, schedule=False):
    """16 sampled results (4 truncated) against ``run_reference`` and a
    solo ``DataflowEngine.run`` in every EngineResult field; profiled,
    also against a solo replay of the same blocks in every field,
    profile arrays included."""
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.testing import assert_same_result
    rng = np.random.default_rng(1)
    truncated = [r.uid for r in reqs if r.max_cycles is not None]
    done = [r.uid for r in reqs if r.max_cycles is None]
    sample = list(rng.choice(truncated, min(4, len(truncated)),
                             replace=False)) + list(
        rng.choice(done, min(12, len(done)), replace=False))
    solo = DataflowEngine(bench.graph, block_cycles=64, device=dev,
                          optimize=optimize, profile=profile,
                          schedule=schedule)
    t_ref = time.perf_counter()
    same_window = 0
    for uid in sample:
        req, r = reqs[uid - 1], results[uid - 1]
        cap = req.max_cycles or max_cycles
        want = run_reference(bench.graph, req.feeds, max_cycles=cap,
                             profile=profile)
        assert_same_result(r.engine, want, ("sample", uid), dispatches=False)
        # a served request may ride more, shorter blocks than its solo
        # run (a neighbour's budget shortens a heartbeat's block), so
        # the launch counts and the profiled window may differ by design
        alone = solo.run(req.feeds, max_cycles=cap)
        assert_same_result(r.engine, alone, ("solo", uid), dispatches=False)
        if profile:
            np.testing.assert_array_equal(r.engine.node_fires,
                                          want.node_fires)
            np.testing.assert_array_equal(r.engine.node_fires,
                                          alone.node_fires)
            if r.engine.profile.cycles == alone.profile.cycles:
                assert_same_result(r.engine, alone, ("solo", uid),
                                   dispatches=False, profile=True)
                same_window += 1
            assert_same_result(r.engine, replay(solo, req, r, blocks, cap),
                               ("replay", uid), profile=True)
    log(f"  {bench.graph.name}: {len(sample)} sampled results == "
        f"run_reference and solo run"
        + (f" (profile window equal in {same_window}), == solo replay of "
           "the same blocks in every field" if profile else "")
        + f" ({time.perf_counter() - t_ref:.1f} s)")


def same_results(got, want, what) -> None:
    """Two runs answered every request alike: every EngineResult field
    (profile and launch count included) and every metric."""
    import dataclasses
    from repro_torch.testing import assert_same_result
    check(len(got) == len(want), f"{what}: the runs answered differently")
    for g, w in zip(got, want):
        check(g.uid == w.uid and g.status == w.status, f"{what}: {g.uid}")
        assert_same_result(g.engine, w.engine, (what, g.uid), profile=True)
        check(dataclasses.asdict(g.metrics) == dataclasses.asdict(w.metrics),
              f"{what}: request {g.uid}: metrics differ")


def same_as_dynamic(sched, dyn, stats_s, stats_d) -> None:
    """The scheduled deployment answered every request as the dynamic
    deployment did: every EngineResult field (profile and launch count
    included), every metric, residency p50/p99."""
    same_results(sched, dyn, "sched")
    for k in ("blocks", "residency_p50", "residency_p99"):
        check(stats_s[k] == stats_d[k], f"{k}: scheduled {stats_s[k]}, "
              f"dynamic {stats_d[k]}")
    log(f"  dot_prod     scheduled deployment == dynamic optimized+profiled "
        f"deployment on all {len(sched)} requests (every field, profile "
        "and metrics included)")


def device_busy_us(prof) -> tuple[float, dict]:
    """Microseconds in which the card ran anything (union of the device
    events' intervals in a torch.profiler trace), and device time per
    event name."""
    from torch.autograd import DeviceType
    spans, per = [], {}
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, per


def trace_serving(dev, bench, slots, reqs, untraced_wall, optimize,
                  profile, schedule=False):
    """Serve the workload again under torch.profiler (CPU and CUDA
    activities): the card's busy time, its idle share of the traced
    wall time, and what the tracing cost in wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.serve.dataflow_server import DataflowServer
    srv = DataflowServer(bench.graph, slots=slots, block_cycles=64,
                         device=dev, optimize=optimize, profile=profile,
                         schedule=schedule)
    half = len(reqs) // 2
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs[:half]:
            srv.submit(r)
        n = 0
        for _ in range(8):
            n += len(srv.step())
        for r in reqs[half:]:
            srv.submit(r)
        n += len(srv.drain())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(n == len(reqs), "the traced run lost a request")
    busy_us, per = device_busy_us(prof)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    out = dict(optimize=optimize, profile=profile, schedule=schedule,
               traced_wall_s=wall,
               untraced_wall_s=untraced_wall, device_busy_s=busy_us / 1e6,
               idle_share=(1 - busy_us / 1e6 / wall) if busy_us else None,
               device_s_by_name={k[:96]: v / 1e6 for k, v in top})
    log(f"  {bench.graph.name}: {json.dumps(out)}")
    if not busy_us:
        log("  the profiler recorded no device events: idle share not "
            "measured")
    return out


# ---------------------------------------------------------------------------
# phase 5b: hardened serving
# ---------------------------------------------------------------------------
# the seeded plan of phase 5b (a, b): transients that eat two retries,
# wedged slots, poisoned feeds
HARDENED_FAULTS = dict(dispatch_fail_rate=0.04, transient_attempts=2,
                       wedge_rate=0.01, poison_rate=0.02)
HOOKS = ("_trace", "_count", "_observe_result", "_update_queue_metrics")
# phase 5b's turns: three of each mode, each mode early and late
TURNS = ("plain", "hooks", "hardened", "hardened", "hooks", "plain",
         "plain", "hooks", "hardened")


def time_hooks(srv) -> dict:
    """Wrap the server's trace and metrics hooks with host-time
    accumulators: seconds inside each hook (nested calls included) and
    ``all``, the seconds inside any hook counted once."""
    totals = dict.fromkeys(HOOKS, 0.0)
    totals["all"] = 0.0
    depth = [0]
    for k in HOOKS:
        fn = getattr(srv, k)

        def timed_hook(*a, _fn=fn, _k=k, **kw):
            depth[0] += 1
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t
                depth[0] -= 1
                totals[_k] += dt
                if not depth[0]:
                    totals["all"] += dt
        setattr(srv, k, timed_hook)
    return totals


def gc_timer() -> tuple[dict, object]:
    """Seconds and counts of the garbage collector's passes from now on
    (``gc.callbacks``), and the function that stops counting."""
    import gc
    acc = dict(s=0.0, passes=0, gen2=0)
    start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
            return
        acc["s"] += time.perf_counter() - start[0]
        acc["passes"] += 1
        acc["gen2"] += info["generation"] == 2
    gc.callbacks.append(on_gc)
    return acc, lambda: gc.callbacks.remove(on_gc)


def serve_turn(dev, bench, slots, reqs, schedule=False, mode="plain"):
    """Phase 5's submission pattern (half the requests, 8 heartbeats, the
    rest, drain) on a new optimized, profiled server at K = 64.  ``mode``
    ``"plain"``: phase 5's deployment; ``"hooks"``: the same with a
    ``TraceRecorder`` and a ``MetricsRegistry``; ``"hardened"``: with
    them, four tenants, the seeded ``FaultPlan`` and ``max_retries=3``.
    With hooks, the host seconds in each hook are summed; the garbage
    collector's seconds are summed in every mode."""
    import dataclasses
    import torch
    from repro_torch.obs import MetricsRegistry, TraceRecorder
    from repro_torch.serve.dataflow_server import DataflowServer
    from repro_torch.serve.faults import FaultPlan
    kw = {}
    if mode != "plain":
        kw = dict(trace=TraceRecorder(), metrics=MetricsRegistry())
    if mode == "hardened":
        kw.update(faults=FaultPlan(seed=7, **HARDENED_FAULTS), max_retries=3)
        reqs = [dataclasses.replace(r, tenant=f"t{r.uid % 4}") for r in reqs]
    srv = DataflowServer(bench.graph, slots=slots, block_cycles=64,
                         device=dev, optimize=True, profile=True,
                         schedule=schedule, **kw)
    hooks = time_hooks(srv) if kw else None
    _, blocks = time_slot_api(srv.engine)
    row = "sched_slot_step" if schedule else "fire_block_batched_prof"
    before = launch_counts()
    half = len(reqs) // 2
    gc_s, stop_gc = gc_timer()
    t0 = time.perf_counter()
    for r in reqs[:half]:
        srv.submit(r)
    results = []
    for _ in range(8):
        results += srv.step()
    for r in reqs[half:]:
        srv.submit(r)
    results += srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stop_gc()
    for k in ("reset_slots", "step_block", "harvest"):
        delattr(srv.engine, k)              # back to the plain methods
    after = launch_counts()
    launches = after[row] - before[row]
    check(launches == srv.block == len(blocks),
          f"{srv.block} server blocks, {len(blocks)} steps, {launches} "
          "kernel launches")
    if schedule:
        warp = after["sched_slot_step_by"]["warp"] - \
            before["sched_slot_step_by"]["warp"]
        check(warp == launches, f"{warp} of {launches} scheduled slot steps "
              "ran the warp variant")
    results.sort(key=lambda r: r.uid)
    check([r.uid for r in results] == [r.uid for r in reqs],
          "a request got no result, or two")
    return dict(srv=srv, reqs=reqs, results=results, blocks=blocks,
                wall=wall, hooks=hooks, launches=launches, mode=mode,
                gc=gc_s)


def check_hardened(dev, bench, run, want, want_blocks, schedule=False):
    """Phase 5b's checks of one hardened run against phase 5's optimized,
    profiled run of the same requests (``want``, by uid; its block
    lengths ``want_blocks``).  Every request that is neither poisoned nor
    wedged equals phase 5's result in cycles, fired, counts, outputs and
    node_fires, and in every field (launch count and profile included)
    where it rode the same block lengths; 16 of the others, and 16
    poisoned requests, equal a solo replay of the blocks they rode in
    every field; poisoned requests equal a solo ``run`` over
    ``faults.poison(feeds)``; wedged requests are ``wedged`` (or
    ``truncated``, when their budget ran out first).  The trace passes
    ``validate_chrome`` on both clocks, each uid's terminal event carries
    its ``finished_block`` and status; the snapshot passes
    ``validate_snapshot``, counts the statuses, and its retries equal the
    plan's transients."""
    import collections
    import dataclasses
    from repro_torch.core.engine import DataflowEngine
    from repro_torch.obs import validate_chrome, validate_snapshot
    from repro_torch.obs.trace import TERMINAL_KINDS
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.testing import assert_same_result
    srv, faults, blocks = run["srv"], run["srv"].faults, run["blocks"]
    replays, poisoned = [], []
    n = dict(same_window=0, other_window=0, wedged=0, poisoned=0)
    for r, q in zip(run["results"], run["reqs"]):
        w = want[q.uid]
        wedge, poison = faults.wedge(q.uid), faults.poisoned(q.uid)
        status = ("truncated" if q.max_cycles else "wedged") if wedge \
            else w.status
        check(r.status == status and r.error is None,
              f"request {q.uid}: {r.status}, want {status}")
        r.engine.profile.check()
        if poison:
            n["poisoned"] += 1
            poisoned.append((q, r))
            continue
        assert_same_result(r.engine, w.engine, ("5b", q.uid),
                           dispatches=False)
        np.testing.assert_array_equal(r.engine.node_fires,
                                      w.engine.node_fires)
        m, wm = r.metrics, w.metrics
        if wedge:
            n["wedged"] += 1
        elif blocks[m.admitted_block:m.finished_block] == \
                want_blocks[wm.admitted_block:wm.finished_block]:
            assert_same_result(r.engine, w.engine, ("5b", q.uid),
                               profile=True)
            n["same_window"] += 1
        else:
            n["other_window"] += 1
            replays.append((q, r))
    check(n["wedged"] and n["poisoned"], f"the plan wedged or poisoned "
          f"nothing: {n}")
    rng = np.random.default_rng(2)
    plan = FaultPlan(seed=7, **HARDENED_FAULTS)   # a fresh log for poison
    solo = DataflowEngine(bench.graph, block_cycles=64, device=dev,
                          optimize=True, profile=True, schedule=schedule)
    picks = [replays[i] for i in rng.permutation(len(replays))[:16]]
    picks += [(dataclasses.replace(q, feeds=plan.poison(q.feeds, q.uid)), r)
              for q, r in (poisoned[i] for i in
                           rng.permutation(len(poisoned))[:16])]
    for q, r in picks:
        cap = q.max_cycles or srv.max_cycles
        assert_same_result(r.engine, replay(solo, q, r, blocks, cap),
                           ("5b replay", q.uid), profile=True)
        if faults.poisoned(q.uid):
            alone = solo.run(q.feeds, max_cycles=cap)
            assert_same_result(r.engine, alone, ("5b poisoned", q.uid),
                               dispatches=False)
            np.testing.assert_array_equal(r.engine.node_fires,
                                          alone.node_fires)
    trace = srv.trace
    for clock in ("block", "wall"):
        info = validate_chrome(trace.to_chrome(clock))
        check(info["uids"] == len(run["reqs"]), f"trace: {info}")
    terminal = {}
    for e in trace.events:
        if e.kind in TERMINAL_KINDS:
            check(e.uid not in terminal, f"uid {e.uid}: two terminal events")
            terminal[e.uid] = (e.block, e.status)
    for r in run["results"]:
        check(terminal[r.uid] == (r.metrics.finished_block, r.status),
              f"uid {r.uid}: terminal event {terminal[r.uid]}")
    snap = srv.metrics.snapshot()
    validate_snapshot(snap)
    c = snap["counters"]
    statuses = collections.Counter(r.status for r in run["results"])
    for s, k in statuses.items():
        check(c[f"requests_finished{{status={s}}}"] == k, f"{s}: {k}")
    check(sum(v for k, v in c.items() if k.startswith("requests_finished"))
          == len(run["results"]), "requests_finished")
    retries = sum(v for k, v in c.items() if k.startswith("dispatch_retries"))
    transients = sum(e[0] == "dispatch-transient" for e in faults.log)
    check(retries == transients > 0, f"{retries} retries counted, "
          f"{transients} transients injected")
    check(c["dispatches{backend=cuda}"] == srv.block, "dispatches")
    return dict(**n, replays=len(picks), statuses=dict(statuses),
                retries=retries, blocks=srv.block,
                trace_events=len(trace.events),
                metric_series=sum(len(snap[k]) for k in (
                    "counters", "gauges", "histograms")),
                events=dict(collections.Counter(
                    e["kind"] for e in srv.events)))


def phase_persistent(dev, bench, slots=64, n_req=128, from_block=5):
    """A persistent injected fault from block ``from_block``: every uid
    answered once, no exception; requests done by then ``ok`` with the
    reference's values, the rest ``error`` with a ``DispatchFault`` and
    their partial results.  A planned compile fault raises from the
    constructor."""
    from repro_torch.core import library
    from repro_torch.obs import (MetricsRegistry, TraceRecorder,
                                 validate_chrome, validate_snapshot)
    from repro_torch.serve.dataflow_server import DataflowServer
    from repro_torch.serve.faults import (CompileFault, DispatchFault,
                                          FaultPlan)
    from repro_torch.serve.types import Request
    rng = np.random.default_rng(11)
    lens = rng.integers(8, 400, n_req)
    reqs = [Request(uid=i + 1, feeds={
        a: np.asarray(v, np.int32) for a, v in library.random_feeds(
            "dot_prod", bench, int(k), rng).items()})
        for i, k in enumerate(lens)]
    tr, mr = TraceRecorder(), MetricsRegistry()
    srv = DataflowServer(bench.graph, slots=slots, block_cycles=64,
                         device=dev, faults=FaultPlan(
                             seed=7, persistent_backends={"cuda"},
                             persistent_from_block=from_block),
                         trace=tr, metrics=mr)
    results = srv.run(reqs)                         # must not raise
    check([r.uid for r in results] == [q.uid for q in reqs],
          "a request got no result, or two")
    check(srv.block == from_block and srv.pending == 0, "server state")
    ok = 0
    for r, q, k in zip(results, reqs, lens):
        if r.status == "ok":
            ok += 1
            check(r.metrics.finished_block <= from_block, f"uid {r.uid}")
            last = expected_last("dot_prod", bench, q.feeds)
            check(r.engine.counts["dot"] == library.tokens_out(
                "dot_prod", int(k)) and int(r.engine.outputs["dot"]) ==
                int(last[0]), f"uid {r.uid}: value")
        else:
            check(r.status == "error" and isinstance(r.error, DispatchFault)
                  and r.metrics.finished_block == from_block
                  and r.metrics.retries == srv.max_retries
                  and r.engine.dispatches == from_block
                  - r.metrics.admitted_block, f"uid {r.uid}: {r}")
    check(0 < ok < n_req, f"{ok} of {n_req} finished before the fault")
    check(validate_chrome(tr.to_chrome())["uids"] == n_req, "trace")
    validate_snapshot(mr.snapshot())
    try:
        DataflowServer(bench.graph, slots=slots, block_cycles=64,
                       device=dev, faults=FaultPlan(compile_fail={"cuda"}))
    except CompileFault:
        pass
    else:
        check(False, "compile_fail={'cuda'} built a server")
    failed = sum(e["kind"] == "dispatch-failed" for e in srv.events)
    return dict(requests=n_req, slots=slots, ok=ok, error=n_req - ok,
                failed_dispatches=failed)


def phase_hardened(dev, bench, reqs, want, slots=1024, sched_slots=256,
                   sched_requests=512) -> tuple[dict, list]:
    """Phase 5b's serving runs: (a) phase 5's optimized, profiled
    dot_prod deployment hardened (tenants, faults, trace, metrics), run
    in turns with the same deployment without hooks and with the hooks
    alone (``TURNS``: three of each); (b) the
    hardened deployment scheduled at ``sched_slots`` slots; (c) a
    persistent fault and a compile fault; (d) the walls and the hooks'
    host seconds.  Returns the summary and the hardened runs that
    ``check_phase_hardened`` checks: their checks replay requests through
    the counted wrappers, so they run after the main path's counts are
    read."""
    t0 = time.perf_counter()
    turns = []
    for mode in TURNS:
        run = serve_turn(dev, bench, slots, reqs, mode=mode)
        turns.append(run)
        log(f"  turn {mode}: {run['wall']:.4f} s, {run['srv'].block} "
            f"blocks, gc {run['gc']['s']:.4f} s ({run['gc']['passes']} "
            f"passes, {run['gc']['gen2']} gen-2)" +
            (f", hooks {run['hooks']['all']:.4f} s" if run["hooks"] else ""))
    # the plain turns are phase 5's deployment; the hooks change nothing
    same_results(turns[0]["results"], want, "plain turn vs phase 5")
    for t in turns[1:]:
        first = turns[TURNS.index("hardened")] if t["mode"] == "hardened" \
            else turns[0]
        if t is not first:
            same_results(t["results"], first["results"], t["mode"])
    out = dict(card=card_line(), requests=len(reqs), slots=slots)
    for mode in ("plain", "hooks", "hardened"):
        mine = [t for t in turns if t["mode"] == mode]
        out[mode] = dict(wall_s=[t["wall"] for t in mine],
                         blocks=mine[0]["srv"].block,
                         gc=[t["gc"] for t in mine])
        if mode != "plain":
            out[mode]["hook_s"] = [{k: round(v, 6) for k, v in
                                    t["hooks"].items()} for t in mine]
            out[mode]["trace_events"] = len(mine[0]["srv"].trace.events)
    dynamic = turns[TURNS.index("hardened")]
    del turns
    run = serve_turn(dev, bench, sched_slots, reqs[:sched_requests],
                     schedule=True, mode="hardened")
    out["dynamic"] = {}
    out["scheduled"] = dict(slots=sched_slots, requests=sched_requests,
                            wall_s=run["wall"], gc=run["gc"],
                            hook_s=run["hooks"])
    out["persistent"] = phase_persistent(dev, bench)
    out["seconds"] = time.perf_counter() - t0
    return out, [("dynamic", dynamic, False), ("scheduled", run, True)]


def check_phase_hardened(dev, bench, out, runs, want, want_blocks) -> None:
    """``check_hardened`` on phase 5b's hardened runs, after the main
    path's counts are read; its results join the summary ``out``."""
    t0 = time.perf_counter()
    want = {r.uid: r for r in want}
    for key, run, schedule in runs:
        out[key].update(check_hardened(dev, bench, run, want, want_blocks,
                                       schedule=schedule))
    out["check_seconds"] = time.perf_counter() - t0
    log(f"  dot_prod hardened: {json.dumps(out)}")


# ---------------------------------------------------------------------------
# phase 5c: traced programs
# ---------------------------------------------------------------------------
GCD_REQUESTS = 4096     # submit_args(a, b), a and b uniform in [1, 1024]
GCD_DIVERGENT = 8       # (0, b): never quiesces, capped at 4096 cycles
DIVERGENT_CAP = 4096
GCD_SAMPLE = 64         # results held against a solo run_reference
BLOCK_ROWS = ("fire_block", "fire_block_prof", "fire_block_batched",
              "fire_block_batched_prof", "fire_block_spec")


def row_deltas(before) -> dict:
    """Launches per fire-block row (rows 1-5) since ``before``."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in BLOCK_ROWS}


def trace_benches() -> tuple[dict, dict]:
    """Every traced bench of the library, traced on this torch and held
    to the digest pinned from the CPU tests' torch; the seconds of each
    trace (the first pays the capture's own imports)."""
    from repro_torch.core import library
    from repro_torch.testing import TRACED_ASM_SHA256, asm_sha256
    benches, secs = {}, {}
    for name, build in library.TRACED.items():
        t0 = time.perf_counter()
        bench = build()
        secs[name] = time.perf_counter() - t0
        digest = asm_sha256(bench.graph)
        check(digest == TRACED_ASM_SHA256[name],
              f"{name}: this torch traced another fabric (sha256 {digest}, "
              f"pinned {TRACED_ASM_SHA256[name]})")
        benches[name] = bench
    log(f"  traced {len(benches)} benches, every asm digest as pinned; "
        f"seconds: {json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    return benches, secs


def same_as_hand_built(traced, hand, out_arc, what) -> int:
    """The traced dot_prod deployment answered every request as phase 5's
    hand-built one: status, and for every request that ran to the end
    the drained value and token count.  A truncated request stops at the
    same 500-cycle budget in both, with fewer tokens out of the traced
    fabric's deeper chain; it is held against run_reference by
    check_sampled instead."""
    check(len(traced) == len(hand), f"{what}: the runs answered "
          "differently")
    done = 0
    for t, h in zip(traced, hand):
        check(t.uid == h.uid and t.status == h.status, f"{what}: {t.uid}")
        if t.status == "truncated":
            check(t.engine.cycles == h.engine.cycles == 500,
                  f"{what}: request {t.uid} budget")
            continue
        check(t.engine.counts[out_arc] == h.engine.counts["dot"],
              f"{what}: request {t.uid}: token count")
        check(int(t.engine.outputs[out_arc]) == int(h.engine.outputs["dot"]),
              f"{what}: request {t.uid}: value")
        done += 1
    return done


def phase_traced_dag(dev, bench, served, stats5, n_req=2048, slots=1024,
                     max_len=4096):
    """dot_prod_traced at phase 5's deployment, plain and optimized +
    profiled: every result against Bench.reference (phase_serving) and
    against phase 5's hand-built results of the same uid."""
    reqs, lens = serving_workload("dot_prod_traced", bench, n_req, seed=0,
                                  max_len=max_len)
    out, runs = {}, []
    for key, opt, prof in (("dot_prod", False, False),
                           ("dot_prod_opt_prof", True, True)):
        before = launch_counts()
        stats, results, cap, blocks = phase_serving(
            dev, "dot_prod_traced", bench, slots, reqs, lens, opt, prof)
        stats["launches_by_row"] = row_deltas(before)
        stats["ran_to_end_equal_to_hand_built"] = same_as_hand_built(
            results, served[key][0], bench.out_arc,
            f"traced {key} vs phase 5")
        stats["hand_built_wall_s"] = stats5[key]["wall_s"]
        stats["hand_built_req_per_s"] = stats5[key]["req_per_s"]
        out[key] = stats
        runs.append((reqs, results, cap, blocks, opt, prof))
        log(f"  dot_prod_traced {key}: wall {stats['wall_s']:.3f} s, "
            f"{stats['req_per_s']:.1f} req/s (hand-built "
            f"{stats5[key]['wall_s']:.3f} s, "
            f"{stats5[key]['req_per_s']:.1f} req/s); "
            f"{stats['ran_to_end_equal_to_hand_built']} results equal to "
            f"the hand-built ones; launches {stats['launches_by_row']}")
    return out, runs


def phase_traced_gcd(dev, bench, n_req=GCD_REQUESTS, slots=1024):
    """A loop deployment: DataflowServer.for_fn(gcd) at 1024 slots, K =
    64, 4096 submit_args requests and 8 that never quiesce."""
    import math
    import torch
    from repro_torch.serve.dataflow_server import DataflowServer
    from repro_torch.serve.types import Request
    fn, avals, kw = bench.program
    t0 = time.perf_counter()
    srv = DataflowServer.for_fn(fn, *avals, slots=slots, block_cycles=64,
                                device=dev, **kw)
    trace_s = time.perf_counter() - t0
    ab = np.random.default_rng(7).integers(1, 1025, (n_req, 2))
    bad_b = np.random.default_rng(8).integers(1, 1025, GCD_DIVERGENT)
    before = launch_counts()
    t0 = time.perf_counter()
    bad = []
    for j, b in enumerate(bad_b[:GCD_DIVERGENT // 2]):
        bad.append(srv.submit(Request(
            uid=n_req + 1 + j, feeds=srv.make_feeds(0, int(b)),
            max_cycles=DIVERGENT_CAP)))
    uids = [srv.submit_args(int(a), int(b)) for a, b in ab]
    for j, b in enumerate(bad_b[GCD_DIVERGENT // 2:], GCD_DIVERGENT // 2):
        bad.append(srv.submit(Request(
            uid=n_req + 1 + j, feeds=srv.make_feeds(0, int(b)),
            max_cycles=DIVERGENT_CAP)))
    results = {r.uid: r for r in srv.drain()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = row_deltas(before)
    check(len(results) == n_req + GCD_DIVERGENT, "gcd: a request got no "
          "result")
    check(srv.pending == 0 and not bool(srv.state.active.any()),
          "gcd: the queue or a slot is left busy")
    out_arc = srv.traced.out_arc
    for uid, (a, b) in zip(uids, ab):
        r = results[uid]
        check(r.status == "ok" and not r.metrics.truncated,
              f"gcd request {uid}: {r.status}")
        check(r.engine.counts[out_arc] == 1 and
              int(r.engine.outputs[out_arc]) == math.gcd(int(a), int(b)),
              f"gcd({a}, {b}) request {uid}")
    for uid in bad:
        r = results[uid]
        check(r.status == "truncated" and r.metrics.truncated
              and r.engine.cycles == DIVERGENT_CAP,
              f"divergent request {uid}: {r.status}, {r.engine.cycles}")
    check(launches["fire_block_batched"] == srv.block,
          f"gcd: {srv.block} blocks, {launches['fire_block_batched']} "
          "batched launches")
    cyc = np.array([results[u].engine.cycles for u in uids])
    res = np.array([results[u].metrics.residency_blocks for u in uids])
    stats = dict(requests=n_req, divergent=GCD_DIVERGENT, slots=slots,
                 block_cycles=64, blocks=srv.block, wall_s=wall,
                 req_per_s=(n_req + GCD_DIVERGENT) / wall,
                 trace_s=trace_s, launches_by_row=launches,
                 cycles={"min": int(cyc.min()),
                         "p50": float(np.percentile(cyc, 50)),
                         "p99": float(np.percentile(cyc, 99)),
                         "max": int(cyc.max())},
                 longest_rode_blocks=int(res.max()),
                 divergent_rode_blocks=[
                     results[u].metrics.residency_blocks for u in bad],
                 card=card_line())
    log(f"  gcd for_fn: {json.dumps(stats)}")
    return stats, (srv, ab, uids, results)


def check_traced_gcd(dev, bench, run) -> float:
    """64 sampled gcd results against a solo run_reference and a solo
    engine run, every EngineResult field (after the counts are read)."""
    from repro_torch.core.engine import run_reference
    from repro_torch.testing import assert_same_result
    srv, ab, uids, results = run
    t0 = time.perf_counter()
    pick = np.random.default_rng(2).choice(len(uids), GCD_SAMPLE,
                                           replace=False)
    for i in pick:
        a, b = (int(v) for v in ab[i])
        feeds = srv.make_feeds(a, b)
        r = results[uids[i]]
        assert_same_result(r.engine, run_reference(bench.graph, feeds),
                           ("gcd sample", a, b), dispatches=False)
        assert_same_result(r.engine, srv.engine.run(feeds),
                           ("gcd solo", a, b), dispatches=False)
    secs = time.perf_counter() - t0
    log(f"  gcd: {GCD_SAMPLE} sampled results == run_reference and a solo "
        f"run in every field ({secs:.1f} s)")
    return secs


def phase_traced_rest(dev, benches) -> dict:
    """The other eight benches once each through compile_fn on the card
    (int32 on "cuda", plain and optimized + profiled; newton_sqrt on
    "torch"), every field against run_reference bit for bit."""
    from repro_torch.core import library
    from repro_torch.core.compile import compile_fn
    from repro_torch.core.engine import run_reference
    from repro_torch.testing import assert_same_result
    out = {}
    for name, bench in benches.items():
        if name in ("dot_prod_traced", "gcd"):
            continue
        fn, avals, kw = bench.program
        k = 40 if name in library.SINGLE_SHOT else 64
        feeds = library.random_feeds(name, bench, k,
                                     np.random.default_rng(3))
        want = run_reference(bench.graph, feeds, dtype=bench.dtype)
        routes = (("torch", False, False),) if bench.dtype != np.int32 \
            else (("cuda", False, False), ("cuda", "spec", True))
        for backend, opt, prof in routes:
            t0 = time.perf_counter()
            run = compile_fn(fn, *avals, backend=backend, block_cycles=64,
                             optimize=opt, profile=prof, device=dev, **kw)
            got = run(feeds)
            assert_same_result(got, want, (name, backend, opt),
                               dispatches=False)
            out[f"{name}/{backend}" + ("/spec+prof" if prof else "")] = \
                dict(cycles=int(got.cycles), fired=int(got.fired),
                     seconds=time.perf_counter() - t0)
    log(f"  compile_fn on the card == run_reference bit for bit: "
        f"{json.dumps(out)}")
    return out


def phase_traced(dev, served, stats5, small=None):
    """Phase 5c: traced programs on the card's main path.  Returns the
    summary and what check_phase_traced replays once the counts are
    read.  ``small`` (a CPU rehearsal) is ``(dag kwargs, gcd kwargs)``
    of smaller deployments."""
    dag_kw, gcd_kw = small or ({}, {})
    t0 = time.perf_counter()
    before = launch_counts()
    benches, secs = trace_benches()
    out = {"trace_s": secs}
    out["dag"], dag_runs = phase_traced_dag(
        dev, benches["dot_prod_traced"], served, stats5, **dag_kw)
    out["gcd"], gcd_run = phase_traced_gcd(dev, benches["gcd"], **gcd_kw)
    out["compile_fn"] = phase_traced_rest(dev, benches)
    out["launches_by_row"] = row_deltas(before)
    for k in BLOCK_ROWS:
        check(out["launches_by_row"][k] > 0,
              f"{k} was never launched by the traced programs")
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card_line()
    log(f"  phase 5c: launches by row {json.dumps(out['launches_by_row'])}")
    return out, (benches, dag_runs, gcd_run)


def check_phase_traced(dev, out, runs) -> None:
    """Phase 5c's sampled checks (their solo runs and replays go through
    the counted wrappers, so they come after the counts are read)."""
    benches, dag_runs, gcd_run = runs
    t0 = time.perf_counter()
    for reqs, results, cap, blocks, opt, prof in dag_runs:
        check_sampled(dev, benches["dot_prod_traced"], reqs, results, cap,
                      blocks, optimize=opt, profile=prof)
    check_traced_gcd(dev, benches["gcd"], gcd_run)
    out["check_seconds"] = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 5d: sharded serving (partition=)
# ---------------------------------------------------------------------------
MF_SOURCE = "src/repro_torch/kernels/csrc/multifabric.cu"
MF_REPLACES = "src/repro/core/multifabric.py:285"
MF_STATE = ("full", "val", "ptr", "out_last", "out_count")


def copy_slot_state(srv) -> dict:
    """A copy on the card of a partitioned server's slot state (the
    sharded block updates its state in place), with the engine's
    tables."""
    st = srv.state
    return dict(tabs=srv.engine._mf.tabs, fv=st.fv.clone(),
                fl=st.fl.clone(), active=st.active_dev.clone(),
                state=[getattr(st, k).clone() for k in MF_STATE],
                ch=[st.mf[k].clone() for k in ("chf", "chv")],
                prof=None if st.prof is None else
                [x.clone() for x in (*st.prof, *st.mf["chprof"])])


def same_as_solo(got, want, profile, graph, what) -> int:
    """The sharded deployment answered every request as phase 5's solo
    deployment: every EngineResult field (launch count and, profiled, the
    node and arc counters included) and every metric; the channel
    counters keep their bounds, and every channel pushed as many tokens
    as its producer fired (BRANCH producers aside).  Returns the channel
    records checked."""
    import dataclasses
    from repro_torch.testing import assert_same_result, check_channels
    check(len(got) == len(want), f"{what}: the runs answered differently")
    n = 0
    for g, w in zip(got, want):
        check(g.uid == w.uid and g.status == w.status, f"{what}: {g.uid}")
        assert_same_result(g.engine, w.engine, (what, g.uid),
                           profile=profile, channels=False)
        check(dataclasses.asdict(g.metrics) == dataclasses.asdict(w.metrics),
              f"{what}: request {g.uid}: metrics differ")
        if profile:
            n += check_channels(g.engine, graph)
    return n


def phase_sharded(dev, bench, reqs, lens, served, stats5, slots=1024):
    """Phase 5d's serving runs: phase 5's dot_prod deployment with
    ``partition=2`` and ``4``, dense and optimized+profiled, every request
    equal to phase 5's solo result of the same uid.  Returns the summary
    and each run's slot state after 8 heartbeats, for
    check_phase_sharded."""
    t0 = time.perf_counter()
    out, caps = {}, {}
    for P in (2, 4):
        for key, opt, prof in (("dot_prod", False, False),
                               ("dot_prod_opt_prof", True, True)):
            cap = {}
            stats, results, _, _ = phase_serving(
                dev, "dot_prod", bench, slots, reqs, lens, opt, prof,
                partition=P, capture=cap)
            n_ch = same_as_solo(results, served[key][0], prof, bench.graph,
                                f"P={P} {key}")
            check(stats["blocks"] == stats5[key]["blocks"],
                  f"P={P} {key}: {stats['blocks']} blocks, phase 5 "
                  f"{stats5[key]['blocks']}")
            mf = cap["tabs"]
            stats.update(P=P, channels=mf.C, regions_N2m=mf.N2m,
                         regions_A2m=mf.A2m,
                         phase5_wall_s=stats5[key]["wall_s"],
                         wall_vs_phase5=stats["wall_s"]
                         / stats5[key]["wall_s"],
                         phase5_reset_slots_s=stats5[key]["seconds_in"][
                             "reset_slots"])
            out[f"P{P}/{key}"] = stats
            caps[(P, opt)] = cap
            log(f"  dot_prod P={P} {key}: all {len(results)} requests == "
                f"phase 5's solo results in every field ({n_ch} channel "
                f"records within bounds, pushes == producer fires); "
                f"{stats['blocks']} blocks, {stats['launches']} launches, "
                f"wall {stats['wall_s']:.3f} s ({stats['req_per_s']:.1f} "
                f"requests/s) vs phase 5's {stats5[key]['wall_s']:.3f} s")
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card_line()
    return out, caps


def mf_counters(c, seed):
    """The captured state's counters, or random ones of the right shapes
    (high-water bits 0/1) for a state served without them."""
    import torch
    if c["prof"] is not None:
        return c["prof"]
    tabs, B = c["tabs"], c["fv"].shape[0]
    PN, PA = tabs.P * tabs.N2m, tabs.P * tabs.A2m
    Cp = c["ch"][0].shape[1]
    g = torch.Generator(device=c["fv"].device).manual_seed(seed)
    rnd = lambda n, hi: torch.randint(0, hi, (B, n), generator=g,  # noqa
                                      device=c["fv"].device,
                                      dtype=torch.int32)
    return [rnd(PN, 1000), rnd(PN, 1000), rnd(PN, 1000), rnd(PA, 1000),
            rnd(PA, 2), rnd(Cp, 1000), rnd(Cp, 2), rnd(Cp, 1000)]


def mf_pair(c, rows, K, prof):
    """Uncounted launches of each kernel variant and the plain version on
    copies of the captured state's ``rows``: {"plain" or the variant:
    (fired, last_prog, state, channels, counters)}."""
    from functools import partial
    from repro_torch.kernels import multifabric as kmf
    sub = lambda x: x[rows].contiguous()          # noqa: E731
    fv, fl, act = sub(c["fv"]), sub(c["fl"]), sub(c["active"])
    outs = {}
    for what, fn in (*((v, partial(kmf.launch_mf, variant=v))
                       for v in kmf.VARIANTS), ("plain", kmf.mf_block)):
        x = [sub(t).clone() for t in c["state"]]
        ch = [sub(t).clone() for t in c["ch"]]
        pr = None if prof is None else [sub(t).clone() for t in prof]
        f, lp = fn(c["tabs"], fv, fl, *x, *ch, n_cycles=K, active=act,
                   prof=None if pr is None else pr[:5],
                   chprof=None if pr is None else pr[5:])
        outs[what] = [f, lp, *x, *ch, *(pr or [])]
    return outs


def hold_mf(caps) -> tuple[int, int]:
    """Each kernel variant (warp, CTA) against the plain version, bit for
    bit, on every captured sharded serving state (P = 2 and 4, optimize
    off and on): B = 1 (the first active slot), 8 and 1024; K = 1, 16,
    64 and 65; with and without counters.  Returns the largest error and
    the cases (a case: every variant against one plain run)."""
    import torch
    err = n = 0
    for (P, opt), c in sorted(caps.items()):
        one = int(c["active"].nonzero()[0])
        counters = mf_counters(c, seed=P)
        for rows in (slice(one, one + 1), slice(0, 8), slice(None)):
            for K in (1, 16, 64, 65):
                for prof in (None, counters):
                    outs = mf_pair(c, rows, K, prof)
                    torch.cuda.synchronize()
                    want = outs.pop("plain")
                    n += 1
                    for v, got in outs.items():
                        e = max_abs_err(got, want)
                        err = max(err, e)
                        check(e == 0, f"mf_block {v} P={P} optimize={opt} "
                              f"rows={rows} K={K} prof={prof is not None}: "
                              f"kernel != plain (max |err| {e})")
                    if rows == slice(None) and K >= 16:
                        check(int(want[0].sum()) > 0,
                              "nothing fired in the captured state")
    return err, n


def mf_bound(c, K, prof, tokens) -> dict:
    """The least time the card could take for one sharded block: the
    bytes it must move (the packed tables, every state, channel and
    counter array read and written once, fl and active read, fired and
    last_prog written, and the feed tokens this block consumed) over HBM
    bandwidth, against one 32-bit operation per node row, arc slot, feed
    row, drain row and channel (and counter) per active stream per cycle
    over the scalar rate."""
    tabs = c["tabs"]
    B, n_in, _ = c["fv"].shape
    PN, PA = tabs.P * tabs.N2m, tabs.P * tabs.A2m
    n_out, Cp = c["state"][3].shape[1], c["ch"][0].shape[1]
    per_row = 2 * (2 * PA + n_in + 2 * n_out + 2 * Cp) + n_in + 1 + 2
    per_cycle = PN + PA + n_in + n_out + Cp
    if prof is not None:
        per_row += 2 * (3 * PN + 2 * PA + 3 * Cp)
        per_cycle += 3 * PN + 2 * PA + 3 * Cp
    nbytes = sum(w.numel() * 4 for w in tabs.words.values()) \
        + 4 * B * per_row + 4 * tokens
    ops = int(c["active"].sum()) * K * per_cycle
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, tokens=tokens)


def time_mf(c, K=64) -> dict:
    """Device ms per block of each kernel variant (profiler) on fresh
    copies of a captured full serving state (B = 1024) and on its first
    active stream alone (B = 1: the latency floor), µs per cycle, the
    plain version's ms per call (CUDA events) and the bound.  The tables'
    own variant's numbers are the row's."""
    from functools import partial
    from repro_torch.kernels import multifabric as kmf
    tabs = c["tabs"]
    one = int(c["active"].nonzero()[0])

    def run(fn, rows=slice(None)):
        sub = lambda x: x[rows].contiguous()      # noqa: E731
        x = [sub(t).clone() for t in c["state"]]
        ch = [sub(t).clone() for t in c["ch"]]
        pr = None if c["prof"] is None else [sub(t).clone()
                                             for t in c["prof"]]
        return fn(tabs, sub(c["fv"]), sub(c["fl"]), *x, *ch, n_cycles=K,
                  active=sub(c["active"]),
                  prof=None if pr is None else pr[:5],
                  chprof=None if pr is None else pr[5:]), x

    _, x = run(kmf.launch_mf)
    tokens = int((x[2] - c["state"][2]).sum())
    by = {}
    for v in kmf.VARIANTS:
        fn = partial(kmf.launch_mf, variant=v)
        ms = device_ms(lambda: run(fn), 20, "mf_block_kernel")
        floor = device_ms(lambda: run(fn, slice(one, one + 1)), 20,
                          "mf_block_kernel")
        by[v] = dict(ms=ms, us_per_cycle=ms * 1e3 / K, floor_ms=floor,
                     floor_us_per_cycle=floor * 1e3 / K)
    plain_ms = cuda_ms(lambda: run(kmf.mf_block), 2, warmup=1)
    own = by[tabs.variant]
    return dict(variant=tabs.variant, ms=own["ms"], ms_from="profiler",
                us_per_cycle=own["us_per_cycle"], floor_ms=own["floor_ms"],
                floor_us_per_cycle=own["floor_us_per_cycle"],
                by_variant=by, plain_ms=plain_ms,
                **mf_bound(c, K, c["prof"], tokens),
                shape=f"B={c['fv'].shape[0]} slots "
                f"({int(c['active'].sum())} active), K={K}, "
                f"L={c['fv'].shape[2]}, P={tabs.P}, N2m={tabs.N2m}, "
                f"A2m={tabs.A2m}, C={tabs.C}"
                + (", counters" if c["prof"] is not None else ""))


def sharded_torch_float(dev) -> dict:
    """One partitioned ``"torch"`` ``run_batch`` in float32 on the card
    (dot_prod n = 32, P = 2, K = 64, 8 streams of 64 edge-operand
    tokens) against ``run_reference``, every field, profile included."""
    import torch
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.testing import assert_same_result, edge_feeds
    bench = library.dot_product_graph(32)
    rng = np.random.default_rng(7)
    feeds = [edge_feeds(bench.graph, np.float32, 64, rng) for _ in range(8)]
    eng = DataflowEngine(bench.graph, backend="torch", block_cycles=64,
                         device=dev, partition=2, profile=True,
                         dtype=np.float32)
    t0 = time.perf_counter()
    got = eng.run_batch(feeds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, (g, f) in enumerate(zip(got, feeds)):
        want = run_reference(bench.graph, f, dtype=np.float32, profile=True)
        assert_same_result(g, want, ("torch float32", k), dispatches=False)
        np.testing.assert_array_equal(g.node_fires, want.node_fires)
        g.profile.check()
    return dict(streams=len(feeds), tokens=64, P=2, K=64, wall_s=wall,
                cycles=int(got[0].cycles), blocks=int(got[0].dispatches))


def check_phase_sharded(dev, out, caps) -> dict:
    """Phase 5d's kernel checks and times (uncounted launches, after the
    counts are read): the holds, the kernel's time at each full serving
    state, and the float32 ``"torch"`` run.  Returns row 11's fields."""
    t0 = time.perf_counter()
    err, n = hold_mf(caps)
    log(f"  mf_block (warp and CTA variants) == mf_block (plain) bit for "
        f"bit in {n} cases (P = 2, 4; optimize off, on; B = 1, 8, 1024; "
        "K = 1, 16, 64, 65; counters off, on)")
    out["times"] = {f"P{P}/opt={opt}": time_mf(c)
                    for (P, opt), c in sorted(caps.items())}
    for k, t in out["times"].items():
        log(f"  mf_block {k} ({t['variant']}): {t['ms']:.4f} ms a block ("
            f"{t['us_per_cycle']:.3f} µs/cycle; B = 1 floor "
            f"{t['floor_us_per_cycle']:.3f}), plain {t['plain_ms']:.2f} "
            f"ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}); "
            f"{t['shape']}")
        for v, b in t["by_variant"].items():
            log(f"    {v:4s}: {b['ms']:.4f} ms ({b['us_per_cycle']:.3f} "
                f"µs/cycle), B = 1 {b['floor_ms']:.4f} ms "
                f"({b['floor_us_per_cycle']:.3f} µs/cycle)")
    out["torch_float32"] = sharded_torch_float(dev)
    log(f"  partitioned torch run_batch in float32 == run_reference: "
        f"{json.dumps(out['torch_float32'])}")
    out["holds"] = n
    out["check_seconds"] = time.perf_counter() - t0
    main = out["times"]["P2/opt=False"]
    return dict(max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                us_per_cycle=main["us_per_cycle"], variant=main["variant"],
                floor_ms=main["floor_ms"],
                floor_us_per_cycle=main["floor_us_per_cycle"],
                cta_ms=main["by_variant"]["cta"]["ms"],
                cta_us_per_cycle=main["by_variant"]["cta"]["us_per_cycle"],
                shape=main["shape"], times=out["times"], cases_held=n)


# ---------------------------------------------------------------------------
# phase 7: the LM kernels against their plain versions
# ---------------------------------------------------------------------------
def attention_cases(B, S, max_len, G=2) -> dict:
    """The attention calls of the main path (the long wave's prefill and a
    decode step mid-cache), the Pallas case (q_offset 0, every key valid;
    odd lengths, causal and not), and the split decode's edge cases: one
    visible key, fewer keys than one split, kv_len past the cache, and
    16 // G queries (16 rows at G query heads a kv head) whose causal
    bounds leave the last split's keys all masked for the first query's
    rows (the first query before key 64, the first split's end)."""
    dec = dict(B=B, Sq=1, Skv=max_len, causal=True)
    mq = 16 // G
    return {"prefill": dict(B=B, Sq=S, Skv=max_len, causal=True, q_offset=0,
                            kv_len=S),
            "decode": dict(dec, q_offset=S + 15, kv_len=S + 16),
            "pallas_causal": dict(B=2, Sq=1031, Skv=1031, causal=True),
            "pallas_full": dict(B=2, Sq=333, Skv=1031, causal=False),
            "decode_kv_len_1": dict(dec, q_offset=0, kv_len=1),
            "decode_below_one_split": dict(dec, q_offset=39, kv_len=40),
            "decode_past_cache": dict(dec, q_offset=max_len + 40,
                                      kv_len=max_len + 41),
            "decode_masked_split": dict(dec, Sq=mq, q_offset=64 - mq // 2,
                                        kv_len=64 + mq - mq // 2)}


def visible_pairs(Sq, kv, causal, q_offset) -> int:
    """(query, key) pairs the mask lets through, per batch row and head."""
    if not causal:
        return Sq * kv
    rows = np.minimum(kv, q_offset + np.arange(Sq) + 1)
    return int(np.maximum(rows, 0).sum())


def attention_bound(q, k, c) -> dict:
    """Least time for one attention call on these inputs: q and the output
    once, the visible keys' K and V rows once, over HBM bandwidth; 4 * hd
    flops per visible (query, key) pair and head, over the card's dense
    rate for the inputs' type (bf16: the tensor cores' rate; f32: outside
    the tensor cores)."""
    import torch
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    kv = min(c.get("kv_len") or c["Skv"], c["Skv"])
    es = q.element_size()
    nbytes = es * (2 * B * Sq * H * hd + 2 * B * kv * Hkv * hd)
    flops = 4 * hd * B * H * visible_pairs(Sq, kv, c["causal"],
                                           c.get("q_offset", 0))
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 \
        else SCALAR_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, flops=flops)


def sdpa_call(q, k, v, c):
    """``F.scaled_dot_product_attention`` over the same function: the
    visible keys sliced (a view), causal only where the mask is the
    plain lower triangle (q_offset 0 over as many keys as queries);
    otherwise every sliced key is visible (decode) or the mask is given."""
    import torch
    import torch.nn.functional as F
    kv = min(c.get("kv_len") or c["Skv"], c["Skv"])
    off, Sq = c.get("q_offset", 0), q.shape[1]
    qt = q.transpose(1, 2)
    kt, vt = k[:, :kv].transpose(1, 2), v[:, :kv].transpose(1, 2)
    kw = dict(enable_gqa=True)
    if c["causal"] and off == 0 and Sq == kv:
        kw["is_causal"] = True
    elif c["causal"] and off < kv - 1:
        qpos = off + torch.arange(Sq, device=q.device)
        kw["attn_mask"] = torch.arange(kv, device=q.device)[None] <= \
            qpos[:, None]
    # [B, H, Sq, hd] back to q's layout (a view)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  **kw).transpose(1, 2)


def time_lm(run_k, run_p, run_lib, reps, kernel, bound, shape) -> dict:
    """Kernel, plain and library times of one LM kernel call, beside its
    bound: device time from the profiler, or CUDA events per call where
    the profiler recorded nothing or, for a call bound by operations,
    less than the bound (no cache lets the card do the arithmetic faster,
    so such a reading is a trace that lost events; a call bound by bytes
    may beat its bound when the previous repetition left part of its
    inputs in the 50 MB L2) or less than half the call's CUDA-events time
    (the device work of one long kernel is most of its call: a card run
    read 1.66 ms from a window that kept 3 of 5 launches of row 9 at 4 x
    4096, hd 112, against 3.53 per call; PERF.md)."""
    def lost(ms, call_ms=float("inf")):
        return bound["bound_by"] == "operations" and (
            ms < bound["bound_ms"] or 2 * ms < call_ms)
    t = timed(run_k, run_p, reps, kernel, plain_reps=2)
    if t["ms_from"] == "profiler" and lost(t["ms"], t["call_ms"]):
        t.update(ms=t["call_ms"], ms_from=f"cuda events (the profiler read "
                 f"{t['ms']:.4f} ms, below the bound or half the call)")
    lib = profiled_ms(run_lib, reps)
    lib_from = "profiler"
    if not lib or lost(lib):
        lib_from = "cuda events" + (f" (the profiler read {lib:.4f} ms, "
                                    "below the bound)" if lib else "")
        lib = cuda_ms(run_lib, reps)
    return dict(**t, library_ms=lib, library_from=lib_from, **bound,
                shape=shape)


def split_bounds(q, c, ranges, R, Hkv) -> tuple[dict, dict]:
    """Least times of the split kernel and of the combine pass alone: the
    split reads q and the visible K/V rows once and writes its f32
    partials (m, l, acc[hd] per row and split), with 4 * hd flops per
    visible pair; the combine reads the partials and writes the output."""
    B, hd = q.shape[0], q.shape[3]
    whole = attention_bound(q, q.new_empty((B, 1, Hkv, hd)), c)
    qo = q.element_size() * q.numel()
    parts = 4 * B * Hkv * len(ranges) * R * (2 + hd)
    out = []
    for nbytes, flops in ((whole["bytes"] - qo + parts, whole["flops"]),
                          (parts + qo, 0)):
        rate = BF16_FLOPS_PER_S if q.element_size() == 2 \
            else SCALAR_OPS_PER_S
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
        out.append(dict(bound_ms=max(t_b, t_o) * 1e3,
                        bound_by="bytes" if t_b >= t_o else "operations",
                        bytes=nbytes, flops=flops))
    return out[0], out[1]


def graph_ms(fns, reps: int = 20) -> float:
    """Device milliseconds per call of the callables ``fns``: CUDA events
    around replays of one CUDA graph holding one call of each, so no host
    work sits between the launches (a wrapper call's host time exceeds a
    decode kernel's).  Callers pass calls on distinct inputs whose bytes
    together exceed the 50 MB L2, so each call finds its inputs cold, as
    a decode step does after the other layers' weights."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:                # warm-up: builds, kernel attributes
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for f in fns:
            f()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps / len(fns)


def time_decode(q, k, v, c, kw, split, H, Hkv, shape, gen, copies=4) -> dict:
    """The decode call's times: device ms of the wrapper (split and
    combine), of each kernel alone and of SDPA from CUDA-graph replays
    over ``copies`` distinct input sets (K/V of all sets well beyond the
    L2, so every call reads cold K/V); ms per wrapper call from CUDA
    events (host work included); the plain versions' ms per call."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    sets = [(q, k, v)] + [tuple(torch.randn(x.shape, generator=gen,
                                            device=x.device).to(x.dtype)
                                for x in (q, k, v))
                          for _ in range(copies - 1)]
    parts = [fa.attention_partials(*s, split, **kw) for s in sets]
    outs = [torch.empty_like(q) for _ in sets]
    R = c["Sq"] * (H // Hkv)
    b_s, b_c = split_bounds(q, c, split, R, Hkv)
    out = dict(ms=graph_ms([lambda s=s: fa.flash_attention_cuda(*s, **kw)
                            for s in sets]),
               ms_from=f"cuda graph replay, {copies} input sets (cold L2)",
               call_ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                               50),
               plain_ms=cuda_ms(lambda: fa.attention(q, k, v, **kw), 3,
                                warmup=1),
               plain_device_ms=None,
               library_ms=graph_ms([sdpa_call(*s, c) for s in sets]),
               library_from=f"cuda graph replay, {copies} input sets",
               **attention_bound(q, k, c), shape=shape, n_split=len(split),
               split_ctas=len(split) * Hkv * c["B"])
    for part, runs, plain, bnd in (
            ("split", [lambda s=s: fa.decode_partials_cuda(*s, split, **kw)
                       for s in sets],
             lambda: fa.attention_partials(q, k, v, split, **kw), b_s),
            ("combine", [lambda p=p, o=o: fa.combine_cuda(*p, o)
                         for p, o in zip(parts, outs)],
             lambda: fa.combine_partials(*parts[0]), b_c)):
        out[part] = dict(ms=graph_ms(runs), ms_from=out["ms_from"]
                         if part == "split" else "cuda graph replay",
                         call_ms=cuda_ms(runs[0], 50),
                         plain_ms=cuda_ms(plain, 3, warmup=1), **bnd)
    return out


def time_norm_decode(dev, B, d, dt, gen, flush, copies=4) -> dict:
    """RMSNorm at a decode step's shape [B, 1, d] (model rounding), held
    against the plain version and timed beside ``F.rms_norm`` by the same
    two methods: CUDA events over replays of a CUDA graph holding one
    call on each of ``copies`` input sets, and CUDA events per call with
    a cold L2 (``flush`` written before each; kernel and library in
    turns, medians)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    sets = [((3 * torch.randn((B, 1, d), generator=gen, device=dev)).to(dt),
             1 + 0.3 * torch.randn((d,), generator=gen, device=dev))
            for _ in range(copies)]
    tol = LM_TOL["bfloat16" if dt == torch.bfloat16 else "float32"][
        "rmsnorm"]
    for x, w in sets:
        torch.testing.assert_close(
            rn.rmsnorm_cuda(x, w, model=True).float(),
            rn.rmsnorm(x, w, model=True).float(), rtol=tol, atol=tol)
    kern = [lambda s=s: rn.rmsnorm_cuda(s[0], s[1], model=True)
            for s in sets]
    libs = [lambda s=s, c=s[1].to(dt): F.rms_norm(s[0], (d,), c, eps=1e-5)
            for s in sets]
    nbytes = 2 * B * d * sets[0][0].element_size() + 4 * d
    ops_n = 4 * B * d
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_n / SCALAR_OPS_PER_S
    cold = cold_turns_ms(dict(kernel=kern[0], library=libs[0]), 50, flush)
    return dict(ms=graph_ms(kern, 50),
                ms_from=f"cuda graph replay, {copies} input sets",
                cold_ms=cold["kernel"],
                library_ms=graph_ms(libs, 50),
                library_cold_ms=cold["library"],
                call_ms=cuda_ms(kern[0], 50),
                variant=rn.norm_variant(d, sets[0][0].element_size()),
                bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, shape=f"[{B}, 1, {d}] model rounding")


def lm_errs() -> dict:
    """Largest |error| and share of the tolerance, per dtype and per LM
    kernel or attention variant, all 0 (filled by :func:`hold_lm`)."""
    from repro_torch.kernels import flash_attention as fa
    return {dt: {k: dict(max_abs_err=0.0, tol_ratio=0.0)
                 for k in (*LM_ROWS, *fa.VARIANTS)} for dt in LM_TOL}


def hold_lm(errs, dtn, name, got, want, what, keys=(), partial=False):
    """got within the tolerance of want (recorded in ``errs[dtn]`` under
    name and keys): attention outputs by ``fa.error_ratio``, the f32
    partials and RMSNorm as allclose (the largest |got - want| over tol *
    (1 + |want|) at most 1)."""
    from repro_torch.kernels import flash_attention as fa
    tol = LM_TOL["float32" if partial else dtn][name]
    diff = (got.float() - want.float()).abs()
    e = float(diff.max()) if diff.numel() else 0.0
    if name == "flash_attention" and not partial:
        ratio = fa.error_ratio(got, want, tol)
        rule = ATTN_RULE.format("tol")
    else:
        ratio = float((diff / (tol * (1 + want.float().abs()))).max()) \
            if diff.numel() else 0.0
        rule = "rtol = atol = tol"
    for key in (name, *keys):
        rec = errs[dtn][key]
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        rec["tol_ratio"] = max(rec["tol_ratio"], ratio)
    log(f"  {'/'.join((name, *keys)):30s} {dtn:8s} {what}: max |kernel - "
        f"plain| {e:.3g}, {ratio:.3f} of the tolerance ({rule}, tol = "
        f"{tol:g})")
    check(ratio <= 1, f"{name} {keys} {dtn} {what}: kernel != plain "
          f"({ratio} of {rule}, tol = {tol})")


def hold_split(errs, sms, dtn, q, k, v, kw, what, whole, planted):
    """The split kernel's partials and the combine pass, each against its
    plain version (:func:`hold_lm`); with ``planted``, the kernel's
    partials merged without their last split must be refused against
    ``whole`` (the plain version of the call): the check can see a lost
    split.  Returns the plan, the partials' -inf count and, with
    ``planted``, that reading's share of the tolerance."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    Sq, Hkv = q.shape[1], k.shape[2]
    vis = fa.visible_keys(Sq, k.shape[1], **kw)
    ranges = fa.decode_splits(vis, q.shape[0] * Hkv, sms)
    m, l, acc = fa.decode_partials_cuda(q, k, v, ranges, **kw)
    pm, pl, pacc = fa.attention_partials(q, k, v, ranges, **kw)
    inf = torch.isinf(pm)
    check(torch.equal(torch.isinf(m), inf), f"{what}: the split kernel's "
          "masked partials (m = -inf) differ from the plain version's")
    for got, want, part in ((m.masked_fill(inf, 0), pm.masked_fill(
            inf, 0), "m"), (l, pl, "l"), (acc, pacc, "acc")):
        hold_lm(errs, dtn, "flash_attention", got, want,
                f"{what} partial {part}", keys=("decode_split",),
                partial=True)
    out = fa.combine_cuda(pm, pl, pacc, torch.empty_like(q))
    want = fa.rows_to_heads(fa.combine_partials(pm, pl, pacc), Sq)
    hold_lm(errs, dtn, "flash_attention", out, want.to(q.dtype),
            f"{what} combine of the plain partials",
            keys=("decode_combine",))
    r = None
    if planted:
        cut = fa.rows_to_heads(fa.combine_partials(
            m[:, :, :-1], l[:, :, :-1], acc[:, :, :-1]), Sq).to(q.dtype)
        tol = LM_TOL[dtn]["flash_attention"]
        r = fa.error_ratio(cut, whole, tol)
        d = (cut.float() - whole.float()).abs()
        r_flat = float((d / (tol * (1 + whole.float().abs()))).max())
        log(f"  planted fault, {dtn} {what}: the last of {len(ranges)} "
            f"splits dropped gives {r:.3f} of the tolerance ("
            f"{ATTN_RULE.format('tol')}"
            f", tol = {tol:g}; max |error| {float(d.max()):.3g}); an "
            f"allclose with rtol = atol = {tol:g} would give "
            f"{r_flat:.3f}")
        check(r > 1, f"{what}: a decode without its last split passes "
              f"the check ({r} of the tolerance)")
    return ranges, int(inf.sum()), r


def attention_holds(dev, gen, sms, errs, dtn, H, Hkv, hd, cases,
                    timed=()) -> dict:
    """Row 9 in ``dtn`` at ``cases`` (:func:`attention_cases`) with H/Hkv
    heads of ``hd``: the wrapper against the plain version, the dispatch
    rule's variant and no other launched; a split decode's partials and
    combine on their own (:func:`hold_split`, the last split planted as
    lost in the case ``decode``).  The cases in ``timed`` ("prefill",
    "decode") are timed beside SDPA and their bound; a timed decode must
    launch more split CTAs than the card has SMs.  Returns the times and
    the planted readings."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt = torch.float32 if dtn == "float32" else torch.bfloat16
    times, planted = {}, {}
    for case, c in cases.items():
        q = torch.randn((c["B"], c["Sq"], H, hd), generator=gen,
                        device=dev).to(dt)
        k, v = (torch.randn((c["B"], c["Skv"], Hkv, hd), generator=gen,
                            device=dev).to(dt) for _ in range(2))
        kw = {x: c[x] for x in ("causal", "q_offset", "kv_len") if x in c}
        kwf = dict(kw, q_offset=c.get("q_offset", 0))
        variant = fa.variant_of(q, k)
        if case.startswith("pallas"):
            run_k = lambda: ops.flash_attention(q, k, v,  # noqa: E731
                                                causal=c["causal"])
        else:
            run_k = lambda: fa.flash_attention_cuda(q, k, v,  # noqa: E731
                                                    **kw)
        run_p = lambda: fa.attention(q, k, v, **kw)  # noqa: E731
        want = run_p()
        n0 = dict(fa.flash_attention_cuda.launches_by)
        what = (f"{case} {dict(kw, B=c['B'], Sq=c['Sq'], Skv=c['Skv'])} "
                f"H={H}/{Hkv} hd={hd}")
        hold_lm(errs, dtn, "flash_attention", run_k(), want, what,
                keys=(variant,) if variant != "decode_split" else
                ("decode_split", "decode_combine"))
        ran = {x for x, n in fa.flash_attention_cuda.launches_by.items()
               if n > n0[x]}
        check(ran == ({"decode_split", "decode_combine"} if variant ==
                      "decode_split" else {variant}),
              f"{what}: ran {sorted(ran)}, the dispatch rule names "
              f"{variant}")
        split = None
        if variant == "decode_split":
            split, n_inf, r = hold_split(errs, sms, dtn, q, k, v, kwf, what,
                                         want, planted=case == "decode")
            if r is not None:
                planted[case] = dict(n_split=len(split), tol_ratio=r)
            check(case != "decode_masked_split" or n_inf > 0,
                  f"{what}: no split had every key masked for a row")
            ctas = len(split) * Hkv * c["B"]
            check(case not in timed or case != "decode" or ctas > sms,
                  f"{what}: {ctas} split CTAs, not more than the card's "
                  f"{sms} SMs")
        if case in timed:
            lib = sdpa_call(q, k, v, c)
            e_lib = float((lib().float() - want.float()).abs().max())
            shape = (f"B={c['B']}, Sq={c['Sq']}, Skv={c['Skv']}, "
                     f"H={H}/{Hkv}, hd={hd}, q_offset={c['q_offset']}, "
                     f"kv_len={c['kv_len']}, {dtn}")
            if case == "prefill":
                t = dict(**time_lm(run_k, run_p, lib, 5, "flash_attention",
                                   attention_bound(q, k, c), shape),
                         library_vs_plain=e_lib, variant=variant)
            else:
                t = dict(**time_decode(q, k, v, c, kwf, split, H, Hkv,
                                       shape, gen),
                         library_vs_plain=e_lib, variant=variant)
            times[f"flash_attention {case} {dtn}"] = t
        del q, k, v, want
    return times, planted


def phase_lm_kernels(dev, cfg, B, S, max_len):
    """Both LM kernels against their plain versions on the card, in f32
    and bf16, at the main path's shapes, the Pallas case and the split
    decode's edge cases; every attention variant on its own (the tensor-
    core prefill, the f32 kernel, the split kernel's partials and the
    combine pass each against their plain versions); times of the bf16
    (main path) and f32 calls and of the split decode's two kernels.
    Returns the max |error| per dtype and kernel or variant, and the
    times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs, times = lm_errs(), {}
    for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        times.update(attention_holds(
            dev, gen, sms, errs, dtn, H, Hkv, hd,
            attention_cases(B, S, max_len, H // Hkv),
            timed=("prefill", "decode"))[0])
        x = (3 * torch.randn((B * S, d), generator=gen, device=dev)).to(dt)
        w = 1 + 0.3 * torch.randn((d,), generator=gen, device=dev)
        for model in (False, True):
            run_k = (lambda: rn.rmsnorm_cuda(x, w, model=True)) if model \
                else (lambda: ops.rmsnorm(x, w))
            run_p = lambda: rn.rmsnorm(x, w, model=model)
            hold_lm(errs, dtn, "rmsnorm", run_k(), run_p(),
                    f"[{B * S}, {d}] {'model' if model else 'pallas'} "
                    "rounding")
        wc = w.to(dt)
        run_k = lambda: rn.rmsnorm_cuda(x, w, model=True)
        run_p = lambda: rn.rmsnorm(x, w, model=True)
        lib = lambda: F.rms_norm(x, (d,), wc, eps=1e-5)
        e_lib = float((lib().float() - run_p().float()).abs().max())
        nbytes = 2 * x.numel() * x.element_size() + 4 * d
        ops_n = 4 * x.numel()
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_n / SCALAR_OPS_PER_S
        t = time_lm(run_k, run_p, lib, 20, "rmsnorm", dict(
            bound_ms=max(t_b, t_o) * 1e3,
            bound_by="bytes" if t_b >= t_o else "operations",
            bytes=nbytes, flops=ops_n),
            f"[{B * S}, {d}] model rounding, {dtn}")
        # the row's times: kernel, library and every variant (the wrapper
        # runs t["variant"]) by one method, cold L2, in turns
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        cold = cold_turns_ms(dict(
            kernel=run_k, library=lib,
            **{v: (lambda v=v: rn.launch_norm_variant(v, x, w, model=True))
               for v in rn.VARIANTS}), 20, flush)
        t.update(warm_ms=t["ms"], warm_ms_from=t["ms_from"],
                 warm_library_ms=t["library_ms"],
                 warm_library_from=t["library_from"],
                 ms=cold.pop("kernel"), library_ms=cold.pop("library"),
                 variants_cold_ms=cold)
        t["ms_from"] = t["library_from"] = (
            "cuda events per call, L2 flushed by a 256 MB write, kernel, "
            "library and variants in turns, median")
        t["variant"] = rn.norm_variant(d, x.element_size())
        t["decode"] = time_norm_decode(dev, B, d, dt, gen, flush)
        times[f"rmsnorm {dtn}"] = dict(**t, library_vs_plain=e_lib)
        del x, flush
    torch.cuda.empty_cache()
    for k, v in times.items():
        log(f"  {k:34s} kernel {v['ms']:.4f} ms ({v['ms_from']}; "
            f"{v['call_ms']:.4f} per call)  plain {v['plain_ms']:.3f} ms  "
            f"library {v['library_ms']:.4f} ms ({v['library_from']}; "
            f"|lib - plain| {v['library_vs_plain']:.3g})  bound "
            f"{v['bound_ms']:.5f} ms ({v['bound_by']}: {v['bytes']} B, "
            f"{v['flops']:.4g} flops)  [{v['shape']}]")
        if "variants_cold_ms" in v:
            log(f"    every variant, cold: " + ", ".join(
                f"{x} {y:.4f} ms" for x, y in v["variants_cold_ms"].items())
                + f" (the wrapper runs {v['variant']})")
        if "decode" in v:
            t = v["decode"]
            log(f"    decode [{B}, 1, {d}] ({t['variant']} variant): kernel "
                f"{t['ms']:.4f} ms ({t['ms_from']}), cold {t['cold_ms']:.4f}"
                f" ms; library {t['library_ms']:.4f} ms, cold "
                f"{t['library_cold_ms']:.4f} ms; bound {t['bound_ms']:.6f} "
                f"ms ({t['bound_by']})")
        if "warm_ms" in v:
            log(f"    warm L2: kernel {v['warm_ms']:.4f} ms "
                f"({v['warm_ms_from']}), library {v['warm_library_ms']:.4f} "
                f"ms ({v['warm_library_from']})")
        for part in ("split", "combine"):
            if part in v:
                t = v[part]
                log(f"    {part:8s} kernel {t['ms']:.4f} ms ({t['ms_from']}; "
                    f"{t['call_ms']:.4f} per call)  plain {t['plain_ms']:.3f}"
                    f" ms  bound {t['bound_ms']:.5f} ms ({t['bound_by']}: "
                    f"{t['bytes']} B)  [{v['n_split']} splits, "
                    f"{v['split_ctas']} CTAs]")
    return errs, times


# ---------------------------------------------------------------------------
# phase 8: LM serving at full width
# ---------------------------------------------------------------------------
class StepRecorder:
    """Wraps the model's ``prefill`` and ``decode_step`` (the module the
    serving engine calls them in) while a wave is served: each call's
    milliseconds (the card synchronised before and after), the part of
    them the host spent enqueuing the call's work (until the call returned,
    before the synchronisation), and its logits, copied to the host."""

    def __init__(self, tfm, dev):
        import torch
        self.tfm, self.real = tfm, (tfm.prefill, tfm.decode_step)
        self.ms = {"prefill": [], "decode": []}
        self.host_ms = {"prefill": [], "decode": []}
        self.logits = []

        def wrap(kind, fn):
            def call(*a, **kw):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.host_ms[kind].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize(dev)
                self.ms[kind].append((time.perf_counter() - t0) * 1e3)
                self.logits.append(out[0].cpu())
                return out
            return call
        tfm.prefill = wrap("prefill", tfm.prefill)
        tfm.decode_step = wrap("decode", tfm.decode_step)

    def close(self):
        self.tfm.prefill, self.tfm.decode_step = self.real


def check_tokens(results, n_tokens, vocab, what) -> None:
    for r in results:
        check(r.error is None and r.tokens is not None, f"{what} {r.uid}")
        check(len(r.tokens) == n_tokens, f"{what} {r.uid}: {len(r.tokens)} "
              f"tokens, want {n_tokens}")
        check(bool(((r.tokens >= 0) & (r.tokens < vocab)).all()),
              f"{what} {r.uid}: a token outside the vocabulary")


def phase_lm_serving(dev, cfg, long_lens, max_len, new_tokens, main_argv):
    """internlm2-1.8b on the card: seeded ``init_params``, the launcher
    with the JAX launcher's defaults, then one long wave recorded step by
    step.  Returns the stats, the engine and the long wave's requests,
    results and recorder."""
    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    stats = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                 vocab=cfg.vocab, n_params=tfm.count_params(params),
                 init_s=time.perf_counter() - t0,
                 params_bytes=torch.cuda.max_memory_allocated(dev))
    log(f"  init_params({cfg.name}, seed 0): {stats['n_params']} parameters "
        f"in {stats['init_s']:.2f} s; peak memory {stats['params_bytes']} B")
    t0 = time.perf_counter()
    out = launch_serve.main(main_argv)
    check(not out["reduced"] and out["requests"] == 8, "launcher: not the "
          "full-width default run")
    check_tokens(out["results"], 16, cfg.vocab, "launcher request")
    stats["launcher"] = {k: out[k] for k in ("requests", "tokens", "wall_s",
                                             "tokens_per_s")}
    stats["launcher"]["call_s"] = time.perf_counter() - t0
    del out
    rng = np.random.default_rng(11)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (int(n),))
                    .astype(np.int32), max_new_tokens=new_tokens)
            for i, n in enumerate(long_lens)]
    eng = ServeEngine(cfg, params, batch_size=len(reqs), max_len=max_len,
                      device=dev)
    del params
    torch.cuda.empty_cache()
    rec = StepRecorder(tfm, dev)
    try:
        t0 = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    check_tokens(results, new_tokens, cfg.vocab, "long-wave request")
    total = sum(len(r.tokens) for r in results)
    dec = rec.ms["decode"]
    stats["long_wave"] = dict(
        requests=len(reqs), prompt_lens=[int(n) for n in long_lens],
        max_len=max_len, new_tokens=new_tokens, tokens=total, wall_s=wall,
        tokens_per_s=total / wall, prefill_ms=rec.ms["prefill"][0],
        prefill_tokens_per_s=len(reqs) * max(long_lens)
        / rec.ms["prefill"][0] * 1e3,
        decode_steps=len(dec), decode_ms_mean=float(np.mean(dec)),
        decode_ms_p50=float(np.median(dec)), decode_ms_max=float(max(dec)),
        decode_host_enqueue_ms_mean=float(np.mean(rec.host_ms["decode"])),
        prefill_host_enqueue_ms=rec.host_ms["prefill"][0],
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    log(f"  long wave: {json.dumps(stats['long_wave'])}")
    return stats, eng, reqs, results, rec


class plain_kernels:
    """Within the block, the model's layers reach the kernels' plain
    versions instead of the kernels (the wrappers are swapped in their
    modules, and swapped back on exit)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rmsnorm as rn
        self.saved = (fa, fa.flash_attention_cuda, rn, rn.rmsnorm_cuda)
        fa.flash_attention_cuda = lambda q, k, v, **kw: fa.attention(
            q, k, v, **kw)
        rn.rmsnorm_cuda = lambda x, w, eps=1e-5, model=False: rn.rmsnorm(
            x, w, eps, model)
        return self

    def __exit__(self, *exc):
        fa, fa_fn, rn, rn_fn = self.saved
        fa.flash_attention_cuda, rn.rmsnorm_cuda = fa_fn, rn_fn
        return False


def trace_decode(dev, eng, reqs, steps=4,
                 want=("flash_attention_split_kernel",
                       "flash_attention_combine_kernel")) -> dict:
    """The long wave's prefill again, then ``steps`` decode steps under
    torch.profiler (CPU and CUDA): wall and device busy time per step,
    the card's idle share, device operations per step and per layer,
    device time by kernel name; each of ``want`` must be among the
    kernels.  Run after the main path's counts are read, or subtract
    its launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import pad_wave
    wave = sorted(reqs, key=lambda r: len(r.prompt))
    toks = torch.from_numpy(pad_wave(wave)).to(dev)
    with torch.inference_mode():
        logits, cache = tfm.prefill(eng.cfg, eng.params, {"tokens": toks},
                                    max_len=eng.max_len)
        tok = logits.argmax(-1)[:, None]
        logits, cache = tfm.decode_step(eng.cfg, eng.params, tok, cache)
        torch.cuda.synchronize(dev)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = logits.argmax(-1)[:, None]
                logits, cache = tfm.decode_step(eng.cfg, eng.params, tok,
                                                cache)
                tok.cpu()                         # the engine's host read
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    busy_us, per = device_busy_us(prof)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    ops = sum(getattr(e, "device_type", None) == DeviceType.CUDA
              for e in prof.events()) / steps
    out = dict(steps=steps, batch=toks.shape[0], prompt=toks.shape[1],
               traced_ms_per_step=wall * 1e3 / steps,
               device_ops_per_step=ops,
               device_ops_per_layer=ops / eng.cfg.n_layers,
               device_busy_ms_per_step=busy_us / 1e3 / steps,
               attention_ms_per_step=sum(
                   v for k, v in per.items() if "flash_attention" in k)
               / 1e3 / steps,
               idle_share=(1 - busy_us / 1e6 / wall) if busy_us else None,
               device_ms_per_step_by_name={k[:80]: v / 1e3 / steps
                                           for k, v in top})
    log(f"  decode trace: {json.dumps(out)}")
    for kern in want:
        check(any(kern in name for name in per),
              f"the decode trace shows no {kern}")
    return out


def serve_out_of_vocab(dev, eng) -> dict:
    """A prompt holding ids outside [0, V) served on the card (ROADMAP
    C7): no device assert, and the tokens of the same prompt with its ids
    mapped as the JAX package's gather maps them (``vocab_rows``)."""
    import torch
    from repro_torch.models.transformer import vocab_rows
    from repro_torch.serve.engine import Request
    V = eng.cfg.vocab
    raw = np.array([1, 2, V + 3, -5, -V - 7, 3 * V, 17], np.int32)
    rows = vocab_rows(torch.from_numpy(raw), V).numpy().astype(np.int32)
    res = [eng.run([Request(uid=0, prompt=p, max_new_tokens=4)])[0]
           for p in (raw, rows)]
    torch.cuda.synchronize(dev)
    check_tokens(res, 4, V, "out-of-vocabulary prompt")
    check(np.array_equal(res[0].tokens, res[1].tokens), "an out-of-"
          "vocabulary prompt answers otherwise than its mapped ids")
    out = dict(prompt=raw.tolist(), rows=rows.tolist(),
               tokens=res[0].tokens.tolist())
    log(f"  out-of-vocabulary prompt: {json.dumps(out)}")
    return out


def check_long_wave(dev, eng, reqs, results, rec) -> dict:
    """The long wave through the same engine's model on the plain
    versions, on the same card, teacher-forced with the kernel path's
    tokens: the logits at every step against the kernel path's
    (:func:`hold_wave`)."""
    wave = sorted(reqs, key=lambda r: len(r.prompt))    # the engine's order
    out = hold_wave(dev, eng, wave, results, rec.logits)
    log(f"  long wave vs the plain versions (teacher-forced, {out['steps']} "
        f"steps): {json.dumps(out)}")
    return out


def hold_wave(dev, eng, wave, results, logits, routes=None,
              tol=None) -> dict:
    """One wave (requests in the engine's order) through the same engine's
    model on the plain versions, on the same card, teacher-forced with the
    kernel path's tokens: the logits at every step (``logits``, recorded
    on the kernel path) against the plain path's.  A greedy token may
    differ from the plain path's only where the kernel path's top-2 margin
    is below twice the largest logit difference.  With ``tol`` every
    step's logits are held to the plain path's within rtol = atol =
    ``tol`` too (``tol_ratio``: the largest share of it).  An MoE
    model's wave passes the kernel path's routing (``routes``: its
    :class:`RouteRecorder`'s calls): the plain path records its own
    decisions and routes as the kernel path did, every step's logits are
    held to :data:`MOE_LOGIT_TOL` and every decision the plain path would
    have taken otherwise must be a near tie (:func:`compare_routes`)."""
    import contextlib
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import pad_wave
    by_uid = {r.uid: r for r in results}
    gen = np.stack([by_uid[r.uid].tokens for r in wave]).astype(np.int64)
    T = gen.shape[1]
    check(len(logits) == T, f"{len(logits)} recorded steps, want {T}")
    for t, lk in enumerate(logits):
        check(bool(torch.isfinite(lk).all()), f"step {t}: non-finite logits")
        check(np.array_equal(lk.argmax(-1).numpy(), gen[:, t]),
              f"step {t}: the engine's tokens are not its logits' argmax")
    if routes is not None:
        n_moe = eng.cfg.n_layers - eng.cfg.n_dense_layers
        check(len(routes) == T * n_moe, f"{len(routes)} routed calls, want "
              f"{T} x {n_moe}")
    n0 = launch_counts()
    t0 = time.perf_counter()
    plain = []
    rec = contextlib.nullcontext() if routes is None else \
        RouteRecorder(force=routes)
    with rec, plain_kernels(), torch.inference_mode():
        lp, cache = tfm.prefill(eng.cfg, eng.params,
                                {"tokens": torch.from_numpy(pad_wave(wave))
                                 .to(dev)}, max_len=eng.max_len)
        plain.append(lp.cpu())
        for t in range(T - 1):
            lp, cache = tfm.decode_step(
                eng.cfg, eng.params, torch.from_numpy(gen[:, t:t + 1]).to(dev),
                cache)
            plain.append(lp.cpu())
    torch.cuda.synchronize(dev)
    check(launch_counts() == n0, "the plain replay launched a kernel")
    diffs = [float((k - p).abs().max()) for k, p in zip(logits, plain)]
    worst = max(diffs)
    extra = {}
    if routes is not None:
        kern = on_host(routes)
        extra = dict(routing=compare_routes(kern, on_host(rec.calls),
                                            "the plain replay"),
                     dropped=[int((~c["keep"]).sum()) for c in kern])
        check(worst <= MOE_LOGIT_TOL, f"logits differ from the plain "
              f"path's by {worst} > {MOE_LOGIT_TOL}")
    if tol is not None:
        extra["tol"] = tol
        extra["tol_ratio"] = max(
            float(((k - p).abs() / (tol * (1 + p.abs()))).max())
            for k, p in zip(logits, plain))
        check(extra["tol_ratio"] <= 1, f"logits differ from the plain "
              f"path's by {extra['tol_ratio']} of rtol = atol = {tol}")
    differ = []
    for t, (lk, lp) in enumerate(zip(logits, plain)):
        top2 = lk.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).numpy()
        for b in np.nonzero(lp.argmax(-1).numpy() != gen[:, t])[0]:
            differ.append((t, int(b), float(margin[b])))
            check(margin[b] < 2 * worst, f"step {t} row {b}: the plain path's "
                  f"greedy token differs at a top-2 margin {margin[b]} >= "
                  f"2 x {worst}")
    return dict(steps=T, max_abs_logit_diff=worst,
                logit_diff_by_step=[round(x, 5) for x in diffs],
                logit_scale=float(max(lk.abs().max() for lk in logits)),
                greedy_tokens_differing=len(differ), differing=differ,
                plain_replay_s=time.perf_counter() - t0, **extra)


# ---------------------------------------------------------------------------
# phase 8b: LM training
# ---------------------------------------------------------------------------
JAX_LAYERS = "src/repro/models/layers.py"
# the backward kernels: (what they replace, the row they differentiate,
# CUDA source); the JAX package differentiates its jnp attention and
# RMSNorm with autodiff and has no backward kernel
TRAIN_ROWS = {
    "attention_bwd_dkdv": (f"{JAX_LAYERS}:72",
                           "row 9 (flash_attention): dK, dV",
                           "src/repro_torch/kernels/csrc/flash_attention.cu",
                           "flash_attention_bwd_dkdv_wgmma_kernel"),
    "attention_bwd_dq": (f"{JAX_LAYERS}:72",
                         "row 9 (flash_attention): dQ (and D)",
                         "src/repro_torch/kernels/csrc/flash_attention.cu",
                         "flash_attention_bwd_dq_wgmma_kernel"),
    "rmsnorm_bwd": (f"{JAX_LAYERS}:24",
                    "row 10 (rmsnorm): dx, dw with its reduction",
                    "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "rmsnorm_bwd"),
}
# kernel path against plain path (phase 8b c): the loss relative, each
# gradient leaf as a relative Frobenius error (bf16 compute: the kernels
# round P to bf16 before P.V, the plain path keeps it f32)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-2, 3e-2
# RMSNorm's dw in f32 sums thousands of rows in another order (per-CTA
# partials); in bf16 the model rounding rounds x^ to bf16 before the
# product, and a row factor r one f32 ulp off the plain one's flips that
# rounding now and then (one bf16 step), so dw takes the bf16 tolerance
NORM_DW_TOL = {"float32": 1e-4, "bfloat16": LM_TOL["bfloat16"]["rmsnorm"]}
# phase 8b (a) and (b)'s (batch, seq, steps) at full width in bf16: the
# JAX launcher's batch 4 x seq 128, then train_4k's seq 4096 with the
# batch cut to 1; (d) holds the tensor-core kernels at these shapes too
TRAIN_SHAPES = {"a": (4, 128, 30), "b": (1, 4096, 3)}
# phase 8b (e)'s (batch, seq): the loop's runs and the launcher's; (d)
# holds the kernels at these shapes too, the reduced width's head dim and
# dtype being builds of their own
LOOP_SHAPES = {"loop": (2, 32), "launcher": (4, 128)}
TRAIN_LAUNCH_KEYS = ("flash_attention_by", "attention_bwd_dkdv",
                     "attention_bwd_dq", "attention_bwd_by", "rmsnorm_by",
                     "rmsnorm_bwd", "rmsnorm_bwd_by")
# the f32 route of rows 12-13 (phase 8b e, the reduced width in f32) and
# its profiler names, timed beside the tensor-core kernels in (d)
F32_BWD = {"attention_bwd_dkdv": "flash_attention_bwd_dkdv_kernel",
           "attention_bwd_dq": "flash_attention_bwd_dq_kernel"}


def count_delta(before, after, keys=TRAIN_LAUNCH_KEYS) -> dict:
    """The launches of ``keys`` (by default the training kernels') between
    two ``launch_counts()``."""
    out = {}
    for k in keys:
        a, b = before[k], after[k]
        out[k] = {x: b[x] - a[x] for x in b} if isinstance(b, dict) \
            else b - a
    return out


def train_steps(dev, step, state, src, n) -> tuple:
    """``n`` steps of ``step`` on ``src``'s batches 0..n-1: each step's
    loss (``float``, the step's sync), wall ms (the card synchronised
    before) and host ms (until the step returned, before the sync)."""
    import torch
    losses, ms, host = [], [], []
    for i in range(n):
        batch = src.batch_for_step(i)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        host.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, dict(losses=losses, ms=ms, host_ms=host)


def trace_step(dev, step, state, batch, reps=2) -> tuple:
    """``reps`` train steps under torch.profiler (CPU and CUDA): wall and
    device busy ms per step, the card's idle share, device ms by kernel
    name (the 8 largest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize(dev)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            state, m = step(state, batch)
            float(m["loss"])
        wall = time.perf_counter() - t0
    busy_us, per = device_busy_us(prof)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    return state, dict(steps=reps, traced_ms_per_step=wall * 1e3 / reps,
                       device_busy_ms_per_step=busy_us / 1e3 / reps,
                       idle_share=(1 - busy_us / 1e6 / wall) if busy_us
                       else None,
                       device_ms_per_step_by_name={
                           k[:80]: v / 1e3 / reps for k, v in top})


def phase_train(dev, cfg) -> dict:
    """Phase 8b (a) and (b): ``make_train_step`` at full width and depth
    (f32 parameters, bf16 compute, remat on) with ``OptConfig(lr=3e-4,
    warmup_steps=20, total_steps=30)``, at :data:`TRAIN_SHAPES`; each with
    peak memory, ms per step, tokens/s and the forward and backward
    kernels' launches by variant."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.train import loop as train_loop
    check(cfg.remat and cfg.param_dtype == "float32" and
          cfg.compute_dtype == "bfloat16", f"{cfg.name}: not f32 parameters, "
          "bf16 compute, remat")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               n_params=tfm.count_params(state[0]),
               init_s=time.perf_counter() - t0,
               state_bytes=torch.cuda.max_memory_allocated(dev))
    step = train_loop.make_train_step(
        cfg, adamw.OptConfig(lr=3e-4, warmup_steps=20, total_steps=30))
    for key, (B, S, n) in TRAIN_SHAPES.items():
        n0 = launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        src = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
        state, rec = train_steps(dev, step, state, src, n)
        steady = rec["ms"][1:]
        rec.update(batch=B, seq=S, steps=n, first_step_ms=rec["ms"][0],
                   ms_per_step=float(np.median(steady)),
                   host_ms_per_step=float(np.median(rec["host_ms"][1:])),
                   tokens_per_s=B * S / float(np.median(steady)) * 1e3,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                   launches=count_delta(n0, launch_counts()))
        check(all(np.isfinite(rec["losses"])), f"8b ({key}): a loss is not "
              f"finite: {rec['losses']}")
        by = rec["launches"]["attention_bwd_by"]
        check(by["dq_mma"] == by["dkdv_mma"] > 0 and
              by["dq_f32"] == by["dkdv_f32"] == 0, f"8b ({key}): bf16 "
              f"training launched the backward kernels {json.dumps(by)}, "
              "want only dq_mma and dkdv_mma")
        if key == "a":
            first, last = (float(np.mean(rec["losses"][:5])),
                           float(np.mean(rec["losses"][-5:])))
            rec.update(mean_first_5=first, mean_last_5=last)
            check(last < first, f"8b (a): the loss did not fall ({first} -> "
                  f"{last})")
            state, rec["trace"] = trace_step(dev, step, state,
                                             src.batch_for_step(n))
        out[key] = rec
        log(f"  8b ({key}) batch {B} x seq {S}, {n} steps: "
            f"{rec['ms_per_step']:.1f} ms/step (median after the first; "
            f"first {rec['first_step_ms']:.0f} ms; host "
            f"{rec['host_ms_per_step']:.1f} ms), {rec['tokens_per_s']:.0f} "
            f"tokens/s, peak memory {rec['peak_memory_bytes']} B; losses "
            f"{[round(x, 4) for x in rec['losses']]}")
        log(f"    launches: {json.dumps(rec['launches'])}")
        if "trace" in rec:
            log(f"    trace: {json.dumps(rec['trace'])}")
    del state, step
    torch.cuda.empty_cache()
    return out


def phase_train_loop(dev, cfg) -> dict:
    """Phase 8b (e): ``train.loop.run`` at ``cfg.reduced()`` on the card
    (8 steps of batch 2 x seq 32, a checkpoint every 3 steps): a run that
    fails at step 5, its resume from step 3, final parameters byte-equal
    to a clean run's; then the launcher (``--reduced --steps 8``).  All
    into a temporary directory, deleted afterwards.  At reduced width
    because one full-width checkpoint holds 1.889e9 x 3 f32 arrays
    (parameters and two moments), 22.7 GB a save."""
    import shutil
    import tempfile
    import torch
    from repro_torch import pytree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.train import loop as train_loop
    rcfg = cfg.reduced()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    t0 = time.perf_counter()
    try:
        B, S = LOOP_SHAPES["loop"]
        src = SyntheticLM(vocab=rcfg.vocab, seq_len=S, global_batch=B,
                          seed=0)
        opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)

        def run(d, fail=None):
            return train_loop.run(rcfg, train_loop.LoopConfig(
                total_steps=8, ckpt_every=3, ckpt_dir=str(tmp / d),
                log_every=100, fail_at_step=fail), opt, src, seed=0,
                device=dev)
        failed = None
        try:
            run("a", fail=5)
        except train_loop.SimulatedFailure as e:
            failed = str(e)
        check(failed is not None, "8b (e): fail_at_step=5 did not raise")
        check(ckpt.latest_step(str(tmp / "a")) == 3, "8b (e): LATEST is "
              "not step 3 after the failure: "
              f"{ckpt.latest_step(str(tmp / 'a'))}")
        resumed = run("a")
        check(resumed["resumed"] and resumed["start_step"] == 3,
              f"8b (e): the resume started at {resumed['start_step']}")
        clean = run("b")
        check(not clean["resumed"], "8b (e): the clean run resumed")
        pairs = list(zip(pytree.leaves(resumed["state"]),
                         pytree.leaves(clean["state"])))
        check(all(a.device.type == "cuda" for a, _ in pairs),
              "8b (e): the state left the card")
        same = sum(torch.equal(a, b) for a, b in pairs)
        check(same == len(pairs), f"8b (e): {len(pairs) - same} of "
              f"{len(pairs)} leaves differ after the resume")
        check(resumed["losses"] == clean["losses"][3:], "8b (e): the "
              "resumed losses differ from the clean run's")
        B, S = LOOP_SHAPES["launcher"]        # the launcher's defaults
        launcher = launch_train.main(["--arch", LM_ARCH, "--reduced",
                                      "--steps", "8", "--batch", str(B),
                                      "--seq", str(S), "--ckpt-dir",
                                      str(tmp / "launcher")])
        check(launcher["reduced"] and not launcher["resumed"] and
              launcher["device"].startswith("cuda") and
              len(launcher["losses"]) == 8 and
              all(np.isfinite(launcher["losses"])), "8b (e): the launcher "
              "did not train 8 reduced steps on the card")
        check(ckpt.latest_step(str(tmp / "launcher")) == 8,
              "8b (e): the launcher left no step-8 checkpoint")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not tmp.exists(), f"8b (e): {tmp} was not deleted")
    out = dict(arch=rcfg.name, d_model=rcfg.d_model, n_layers=rcfg.n_layers,
               failure=failed, start_step=resumed["start_step"],
               resumed_losses=resumed["losses"],
               clean_losses=clean["losses"], leaves_equal=same,
               launcher_losses=launcher["losses"],
               seconds=time.perf_counter() - t0)
    log(f"  8b (e) loop at reduced width: {json.dumps(out)}")
    return out


class plain_training:
    """Within the block the model's layers run the plain versions of
    attention and RMSNorm (no Function, no kernel): autograd
    differentiates the plain forward."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rmsnorm as rn
        from repro_torch.models import layers
        self.saved = (layers, layers.flash_attention, layers.rmsnorm)
        layers.flash_attention = lambda q, k, v, *, causal, q_offset=0, \
            kv_len=None: fa.attention(q, k, v, causal=causal,
                                      q_offset=q_offset, kv_len=kv_len)
        layers.rmsnorm = lambda x, w, eps=1e-5: rn.rmsnorm(x, w, eps,
                                                           model=True)
        return self

    def __exit__(self, *exc):
        layers, fa_fn, rn_fn = self.saved
        layers.flash_attention, layers.rmsnorm = fa_fn, rn_fn
        return False


def phase_train_vs_plain(dev, cfg, S=TRAIN_SHAPES["b"][1],
                         tag="8b (c)", n_layers=2, planted=None) -> dict:
    """Phase 8b (c), and 8c's and 8e's for their attention families: at
    full width and ``n_layers`` layers, batch 1 x seq 4096, the loss and
    every gradient leaf through the kernels against the plain path
    (autograd of the plain versions) on the same card.  ``planted`` (a
    context manager) plants a fault in the kernel path: its gradients,
    taken again under it, must lie farther than :data:`TRAIN_GRAD_TOL`
    from the plain path's."""
    import dataclasses
    import torch
    from repro_torch import pytree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    params = tfm.init_params(cfg2, seed=1, device=dev)
    batch = SyntheticLM(vocab=cfg2.vocab, seq_len=S, global_batch=1,
                        seed=0).batch_for_step(0)
    flat, treedef = pytree.flatten(params)

    def loss_and_grads():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, _ = tfm.loss_fn(cfg2, pytree.unflatten(treedef, leaves), batch)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)
    n0 = launch_counts()
    lk, gk = loss_and_grads()
    used = count_delta(n0, launch_counts())
    # a hybrid's attention layers are its shared layer's sites; its Mamba
    # layers have two RMSNorms each (the layer's and the gated one)
    attn = n_layers // cfg2.attn_every if cfg2.family == "hybrid" \
        else n_layers
    norms = 2 * (n_layers + attn) + 1 if cfg2.family == "hybrid" else \
        2 * n_layers + 1 if cfg2.norm == "rmsnorm" else 0
    check(used["attention_bwd_dkdv"] == used["attention_bwd_dq"] == attn and
          used["rmsnorm_bwd"] == norms, f"{tag}: the kernel path launched "
          f"{json.dumps(used)}")
    n1 = launch_counts()
    with plain_training():
        lp, gp = loss_and_grads()
    check(launch_counts() == n1, f"{tag}: the plain path launched a kernel")

    def rel_to(xs):
        return [float((a.float() - b.float()).norm() / b.float().norm())
                for a, b in zip(xs, gp)]
    rel = rel_to(gk)
    out = dict(arch=cfg.name, n_layers=n_layers, seq=S, loss_kernel=lk,
               loss_plain=lp,
               loss_rel_err=abs(lk - lp) / abs(lp), grad_rel_err=rel,
               max_grad_rel_err=max(rel), loss_tol=TRAIN_LOSS_TOL,
               grad_tol=TRAIN_GRAD_TOL,
               leaf_shapes=[list(p.shape) for p in flat])
    if planted is not None:
        del gk
        with planted():
            _, gk = loss_and_grads()
        bad = rel_to(gk)
        out["planted"] = dict(fault=planted.__doc__.strip(),
                              grad_rel_err=bad, max_grad_rel_err=max(bad),
                              refused=max(bad) > TRAIN_GRAD_TOL)
    log(f"  {tag} kernel vs plain path: {json.dumps(out)}")
    check(out["loss_rel_err"] <= TRAIN_LOSS_TOL, f"{tag}: loss {lk} vs "
          f"plain {lp}")
    check(out["max_grad_rel_err"] <= TRAIN_GRAD_TOL, f"{tag}: a "
          f"gradient leaf is {max(rel)} off the plain path's")
    check(planted is None or out["planted"]["refused"], f"{tag}: the "
          f"planted fault passes {TRAIN_GRAD_TOL}: {out.get('planted')}")
    del params, gk, gp
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def dq_dims_zeroed():
    """dQ's dims 104-111 (the last 8 of hd 112) zeroed after rows 12-13."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    real = fa.FlashAttentionFn.backward

    def backward(ctx, do):
        dq, *rest = real(ctx, do)
        dims = torch.arange(104, 112, device=dq.device)
        return (dq.index_fill(-1, dims, 0), *rest)
    fa.FlashAttentionFn.backward = staticmethod(backward)
    try:
        yield
    finally:
        fa.FlashAttentionFn.backward = staticmethod(real)


def attn_bwd_bound(B, S, H, Hkv, hd, es, products, causal=True) -> dict:
    """Least time of ``products`` products of 2 hd flops per visible (query,
    key) pair and head at the bf16 tensor-core rate (f32: outside the
    tensor cores), or of the bytes: q, k, v, o, dO read once, the f32 lse
    and D, dQ, dK, dV written once."""
    flops = products * 2 * hd * B * H * visible_pairs(S, S, causal, 0)
    nbytes = es * (2 * 3 * B * S * H * hd + 3 * 2 * B * S * Hkv * hd) \
        + 4 * 2 * B * H * S
    rate = BF16_FLOPS_PER_S if es == 2 else SCALAR_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, flops=flops)


def library_ms(make_backward, reps, bound) -> tuple[float, str]:
    """Device ms of a library call's backward: CUDA events around replays
    of a CUDA graph that holds one backward, so no host work sits between
    its kernels and no profiler record can be lost.  ``make_backward()``
    runs the forward and returns the backward's callable; forward and
    capture run on one side stream, the stream autograd gives the
    backward's kernels.  A reading below the bound is an error."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run = make_backward()
        for _ in range(3):                 # warm-up: library plans
            run()
        side.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            run()
    torch.cuda.synchronize()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    check(ms >= bound["bound_ms"], f"a library backward read {ms} ms, below "
          f"its bound {bound['bound_ms']} ms")
    return ms, f"cuda graph replay, {reps} replays of one backward"


def attn_bwd_alone(q, k, v, o, lse, do, causal) -> dict:
    """``"dq"`` and ``"dkdv"`` -> a callable that launches that attention
    backward kernel (of q's dtype's variant) and nothing else (the wrapper's entry point and arguments, on buffers
    of its own; D from one dQ launch first), for times that need no
    profiler record."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    shape = (B, Sq, Skv, H, Hkv, hd, fa.DTYPE_CODES[q.dtype], int(causal))
    dq_v, dkdv_v = fa.bwd_variant_of(q)
    ptrs = {dq_v: (q, k, v, o, do, lse, D, dq),
            dkdv_v: (q, k, v, do, lse, D, dk, dv)}

    def launch(variant):
        err = getattr(lib, fa.BWD_ENTRY[variant])(
            *(x.data_ptr() for x in ptrs[variant]), *shape,
            torch.cuda.current_stream(q.device).cuda_stream)
        check(err == 0, f"the {variant} backward kernel did not launch")
    launch(dq_v)
    return {"dq": lambda: launch(dq_v), "dkdv": lambda: launch(dkdv_v)}


def rmsnorm_bwd_alone(x, w, dy, vpl=None, wpr=None) -> dict:
    """The RMSNorm backward's plan at these inputs (the wrapper's, or the
    rows kernel forced to ``vpl`` vectors a lane and ``wpr`` warps a row)
    and, under the profiler name of each of its kernels, a callable that
    launches that kernel and nothing else (the wrapper's entry points and
    arguments, on buffers of its own)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    lib = _build.load()
    d = x.shape[-1]
    w32, dx = w.float().contiguous(), torch.empty_like(x)
    plan = rn.card_plan(x, dx, dy, vpl, wpr)
    part = torch.empty((plan.n_cta, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def reduce():
        err = lib.rmsnorm_bwd_reduce_launch(part.data_ptr(), dw.data_ptr(),
                                            plan.n_cta, d, stream)
        check(err == 0, "the RMSNorm backward reduction did not launch")
    name = "rmsnorm_bwd_rows_kernel" if plan.variant == "rows" \
        else "rmsnorm_bwd_kernel"
    return plan, {name: lambda: rn.launch_backward(plan, x, w32, dy, dx,
                                                   part, None, 1e-5),
                  "rmsnorm_bwd_reduce_kernel": reduce}


def time_rmsnorm_bwd(x, w, dy, shapes=()) -> dict:
    """Row 14 at x's shape: device ms of the backward kernel and of its
    reduction, each under its own profiler name (one launch each a call),
    a wrapper call, the plain version, the backward of ``F.rms_norm``
    (CUDA-graph replay) and the bound; and the rows kernel at each forced
    (vectors a lane, warps a row) of ``shapes``, by CUDA events around
    lone launches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    rows, d = x.shape
    es = x.element_size()

    def rms_norm_backward():
        xl = x.detach().requires_grad_()
        wl = w.to(x.dtype).detach().requires_grad_()
        y_lib = F.rms_norm(xl, (d,), wl, eps=1e-5)
        return lambda: torch.autograd.grad(y_lib, (xl, wl), dy,
                                           retain_graph=True)
    run_k = lambda: rn.rmsnorm_backward_cuda(x, w, dy)      # noqa: E731
    nbytes = 3 * rows * d * es + 2 * 4 * d
    ops_n = 8 * rows * d
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_n / SCALAR_OPS_PER_S
    bound = dict(bound_ms=max(t_b, t_o) * 1e3,
                 bound_by="bytes" if t_b >= t_o else "operations",
                 bytes=nbytes, flops=ops_n)
    lib_ms, lib_from = library_ms(rms_norm_backward, 20, bound)
    plan, alone = rmsnorm_bwd_alone(x, w, dy)
    (bwd_name, bwd_fn), (_, red_fn) = alone.items()
    bwd_ms, bwd_from = kernel_ms(run_k, 20, bwd_name, bwd_fn)
    reduce_ms, reduce_from = kernel_ms(run_k, 20,
                                       "rmsnorm_bwd_reduce_kernel", red_fn)
    forced = {}
    for vpl, wpr in shapes:
        p, fns = rmsnorm_bwd_alone(x, w, dy, vpl, wpr)
        name, fn = next(iter(fns.items()))
        ms, ms_from = kernel_ms(fn, 20, name, fn)
        forced[f"vpl={vpl} wpr={wpr}"] = dict(
            ms=ms, ms_from=ms_from, n_cta=p.n_cta)
    return dict(
        ms=bwd_ms + reduce_ms, ms_from=f"the backward kernel ({bwd_from}) "
        f"and its reduction ({reduce_from}), each under its own name",
        bwd_kernel_ms=bwd_ms, reduce_kernel_ms=reduce_ms,
        variant=plan.variant, plan=plan._asdict(),
        call_ms=cuda_ms(run_k, 20), call_of="one wrapper call",
        plain_ms=cuda_ms(lambda: rn.rmsnorm_backward(x, w, dy, model=True),
                         5, warmup=1),
        plain_of="rmsnorm_backward", library_ms=lib_ms,
        library_from=lib_from, library_of="the backward of F.rms_norm",
        forced_shapes_ms=forced,
        shape=f"[{rows}, {d}] model rounding, {str(x.dtype)[6:]}", **bound)


def kernel_ms(fn, reps: int, kernel: str, alone) -> tuple[float, str]:
    """Device ms of ``kernel`` a call of fn(), and where it came from: the
    profiler, or, where the profiler recorded none of its launches in any
    window, CUDA events around calls of ``alone()``, which launch that
    kernel and nothing else."""
    ms = profiled_ms(fn, reps, kernel)
    if ms > 0:
        return ms, "profiler"
    log(f"  (the profiler recorded no launch of {kernel}: CUDA events "
        "around launches of it alone)")
    return cuda_ms(alone, reps), ("cuda events around launches of the "
                                  "kernel alone (the profiler recorded none)")


def phase_train_kernels(dev, cfg) -> tuple:
    """Phase 8b (d): each backward kernel against its plain version on the
    card — attention at (a) and (b)'s shapes (bf16: the tensor-core
    kernels, :data:`TRAIN_SHAPES`), at phase 8c's attention families'
    training shapes (:data:`FAMILY_TRAIN`: stablelm's 32/32 heads at hd
    64), at
    (e)'s shapes (the reduced width's heads, head dim and dtype, f32: the
    CUDA-core kernels, :data:`LOOP_SHAPES`) and at odd lengths (333; hd 64
    and 128 in f32 and bf16, hd 16 and 32 in bf16; causal and not, G = 1
    and 2), after the forward's output and lse against the plain ones, and
    two calls byte-equal; RMSNorm at [4096, 2048], [3, 130] (the generic
    route), [512, 2048] in f32 and bf16 and at (e)'s rows and width; then
    their device times at (b)'s shape beside their bounds, the plain
    versions' and the library's backward times, and the f32 route's times
    at the same shape in f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=dev).manual_seed(25)
    errs = {dtn: {k: dict(max_abs_err=0.0, tol_ratio=0.0)
                  for k in TRAIN_ROWS} for dtn in LM_TOL}

    def note(dtn, row, got, want, ratio, what):
        e = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        rec = errs[dtn][row]
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        rec["tol_ratio"] = max(rec["tol_ratio"], ratio)
        check(ratio <= 1, f"{row} {dtn} {what}: kernel != plain ({ratio} of "
              "the tolerance)")

    def rnd(shape, dt, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dt)
    rcfg = cfg.reduced()
    cases = [(B, Sq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True,
              (cfg.compute_dtype,)) for B, Sq, _ in TRAIN_SHAPES.values()] + [
        (B, Sq, fc.n_heads, fc.n_kv_heads, fc.head_dim, True,
         (fc.compute_dtype,))
        for fc, (B, Sq, _) in ((get_arch(n), v) for n, v in
                               FAMILY_TRAIN.items()) if not fc.rwkv] + [
        (B, Sq, rcfg.n_heads, rcfg.n_kv_heads, rcfg.head_dim, True,
         (rcfg.compute_dtype,)) for B, Sq in LOOP_SHAPES.values()] + [
        (1, 333, 2 * G, 2, hd, causal, ("float32", "bfloat16") if hd >= 64
         else ("bfloat16",))
        for hd in (16, 32, 64, 128) for causal in (True, False)
        for G in (1, 2)]
    for B, Sq, H, Hkv, hd, causal, dtns in cases:
        for dtn in dtns:
            dt = getattr(torch, dtn)
            q, do = rnd((B, Sq, H, hd), dt), rnd((B, Sq, H, hd), dt)
            k, v = rnd((B, Sq, Hkv, hd), dt), rnd((B, Sq, Hkv, hd), dt)
            what = f"B={B} S={Sq} H={H}/{Hkv} hd={hd} causal={causal}"
            out, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                               with_lse=True)
            pout, plse = fa.attention(q, k, v, causal=causal, with_lse=True)
            e_lse = float((lse - plse).abs().max())
            check(e_lse <= 1e-4, f"{what} {dtn}: forward lse off the plain "
                  f"one by {e_lse}")
            r_out = fa.error_ratio(out, pout, LM_TOL[dtn]["flash_attention"])
            check(r_out <= 1, f"{what} {dtn}: forward output {r_out} of the "
                  "tolerance off the plain one")
            got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                   causal=causal)
            again = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                     causal=causal)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{what} {dtn}: two backward calls differ (atomics?)")
            want = fa.attention_backward(q, k, v, out, lse, do,
                                         causal=causal)
            tol = LM_TOL[dtn]["flash_attention"]
            for g, w, row in zip(got, want, ("attention_bwd_dq",
                                             "attention_bwd_dkdv",
                                             "attention_bwd_dkdv")):
                note(dtn, row, g, w, fa.grad_error_ratio(g, w, tol), what)
            log(f"  attention backward {dtn:8s} {what}: lse {e_lse:.2g}, "
                "dq/dk/dv " + ", ".join(
                    f"{fa.grad_error_ratio(g, w, tol):.3f}"
                    for g, w in zip(got, want)) + f" of the tolerance "
                f"(rtol = {tol:g}, atol = {tol:g} x min(1, tensor RMS))")
            del q, k, v, do, out, lse, pout, plse, got, again, want
    for dtn in LM_TOL:
        dt = getattr(torch, dtn)
        tol = LM_TOL[dtn]["rmsnorm"]
        shapes = [(4096, 2048), (3, 130), (512, 2048)]
        if dtn == rcfg.compute_dtype:
            shapes += [(B * Sq, rcfg.d_model) for B, Sq in LOOP_SHAPES.values()]
        for rows, d in shapes:
            x, dy = rnd((rows, d), dt, 3.0), rnd((rows, d), dt)
            w = 1 + 0.3 * torch.randn((d,), generator=gen, device=dev)
            dx, dw = rn.rmsnorm_backward_cuda(x, w, dy)
            again = rn.rmsnorm_backward_cuda(x, w, dy)
            what = f"[{rows}, {d}]"
            check(torch.equal(dx, again[0]) and torch.equal(dw, again[1]),
                  f"rmsnorm backward {dtn} {what}: two calls differ")
            pdx, pdw = rn.rmsnorm_backward(x, w, dy, model=True)
            rx = float(((dx.float() - pdx.float()).abs()
                        / (tol * (1 + pdx.float().abs()))).max())
            rw = float(((dw - pdw).abs()
                        / (NORM_DW_TOL[dtn] * (1 + pdw.abs()))).max())
            note(dtn, "rmsnorm_bwd", dx, pdx, rx, what)
            note(dtn, "rmsnorm_bwd", dw, pdw, rw, what)
            log(f"  rmsnorm backward {dtn:8s} {what} "
                f"({rn.rmsnorm_backward_cuda.last_plan.variant}, byte-equal "
                f"twice): dx {rx:.3f} of "
                f"rtol = atol = {tol:g}, dw {rw:.3f} of rtol = atol = "
                f"{NORM_DW_TOL[dtn]:g}")
    torch.cuda.empty_cache()

    # times at (b)'s shape, bf16
    bf = torch.bfloat16
    B, S, _ = TRAIN_SHAPES["b"]
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    q, do = rnd((B, S, H, hd), bf), rnd((B, S, H, hd), bf)
    k, v = rnd((B, S, Hkv, hd), bf), rnd((B, S, Hkv, hd), bf)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    run_k = lambda: fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                     causal=True)
    run_p = lambda: fa.attention_backward(q, k, v, out, lse, do, causal=True)
    def sdpa_backward():
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        do_t = do.transpose(1, 2)
        return lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                           retain_graph=True)
    call_ms = cuda_ms(run_k, 5)
    plain_ms = cuda_ms(run_p, 2, warmup=1)
    both = attn_bwd_bound(B, S, H, Hkv, hd, 2, 5)
    lib_ms, lib_from = library_ms(sdpa_backward, 10, both)
    shape = f"B={B}, S={S}, H={H}/{Hkv}, hd={hd}, causal, bfloat16"
    alone = attn_bwd_alone(q, k, v, out, lse, do, True)
    times = {}
    for row, products in (("attention_bwd_dkdv", 4), ("attention_bwd_dq", 3)):
        ms, ms_from = kernel_ms(run_k, 5, TRAIN_ROWS[row][3],
                                alone[row.split("_")[-1]])
        times[row] = dict(
            ms=ms, ms_from=ms_from, call_ms=call_ms, call_of="both backward "
            "kernels (one wrapper call)", plain_ms=plain_ms, plain_of="attention_backward (both)",
            library_ms=lib_ms, library_from=lib_from, library_of="the "
            "backward of F.scaled_dot_product_attention (dq, dk, dv "
            "together)",
            shape=shape, **attn_bwd_bound(B, S, H, Hkv, hd, 2, products))
    total = sum(t["ms"] for t in times.values())
    for t in times.values():      # the whole backward beside its 5 products
        t.update(backward_ms=total, backward_bound_ms=both["bound_ms"])
    del q, k, v, do, out, lse, alone
    # the f32 route (CUDA cores) at the same shape, in f32
    q, do = rnd((B, S, H, hd), torch.float32), rnd((B, S, H, hd),
                                                   torch.float32)
    k, v = rnd((B, S, Hkv, hd), torch.float32), rnd((B, S, Hkv, hd),
                                                    torch.float32)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    run_f = lambda: fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                     causal=True)
    alone = attn_bwd_alone(q, k, v, out, lse, do, True)
    for row, name in F32_BWD.items():
        ms, ms_from = kernel_ms(run_f, 3, name, alone[row.split("_")[-1]])
        times[row].update(f32_ms=ms, f32_of=f"{name}, the f32 route at the "
                          f"same shape in float32 ({ms_from})")
    del q, k, v, do, out, lse, alone
    # row 14 at (b)'s rows and at (a)'s (batch 4 x seq 128), bf16; at (b)'s
    # the rows kernel also at other (vectors a lane, warps a row)
    for tag, rows in (("", B * S), ("_a", TRAIN_SHAPES["a"][0]
                                    * TRAIN_SHAPES["a"][1])):
        x, dy = rnd((rows, d), bf, 3.0), rnd((rows, d), bf)
        w = 1 + 0.3 * torch.randn((d,), generator=gen, device=dev)
        times[f"rmsnorm_bwd{tag}"] = time_rmsnorm_bwd(
            x, w, dy, ((2, 8), (4, 8)) if not tag else ())
        del x, dy
    times["rmsnorm_bwd"]["at_a"] = times.pop("rmsnorm_bwd_a")
    torch.cuda.empty_cache()
    for k, t in times.items():
        if "f32_ms" in t:
            log(f"  {k:20s} f32 route {t['f32_ms']:.4f} ms ({t['f32_of']})")
        log(f"  {k:20s} kernel {t['ms']:.4f} ms ({t['ms_from']}; "
            f"{t['call_ms']:.4f} per call: {t['call_of']})  plain "
            f"{t['plain_ms']:.3f} ms  library {t['library_ms']:.4f} ms "
            f"({t['library_from']})  "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}: {t['bytes']} B,"
            f" {t['flops']:.4g} flops)  [{t['shape']}]")
    t = times["rmsnorm_bwd"]
    a = t["at_a"]
    log(f"  rmsnorm_bwd at (a)'s rows: {a['ms']:.4f} ms ({a['bwd_kernel_ms']:.4f}"
        f" + {a['reduce_kernel_ms']:.4f}), {a['call_ms']:.4f} per call, "
        f"library {a['library_ms']:.4f} ms, bound {a['bound_ms']:.5f} ms "
        f"[{a['shape']}]; plans {t['plan']}, {a['plan']}; rows kernel at "
        f"other shapes {json.dumps(t['forced_shapes_ms'])}")
    return errs, times


# ---------------------------------------------------------------------------
# phase 8c: the LM families of the slice (LayerNorm, GELU, RWKV6)
# ---------------------------------------------------------------------------
FAMILY_ARCHS = ("stablelm-1.6b", "starcoder2-7b", "rwkv6-1.6b")
# (batch, seq, steps) of each family's training at full width and depth,
# at FAMILY_LR (warm-up over 2 steps): at phase 8b's 3e-4 the 10 losses of
# a first card run moved within the batches' spread (11.93-12.04) and the
# last 5 did not fall below the first 5
FAMILY_TRAIN = {"stablelm-1.6b": (4, 128, 10), "rwkv6-1.6b": (4, 128, 3)}
FAMILY_LR = 1e-3
# rwkv6's long wave: 4 prompts left-padded to 512 (16 chunks of 32 with
# the state carried), 32 new tokens; its state check prefills the first
# RWKV_SPLIT tokens and decodes the rest teacher-forced
RWKV_WAVE_LENS = (480, 493, 506, 512)
RWKV_SPLIT = 480
RWKV_NEW_TOKENS = 32
# the state check in f32 compute (the CPU tests' f32 logit tolerance):
# at 24 layers the two bf16 paths lie 0.42 apart on the card, beyond the
# CPU tests' 0.125, and the JAX package's own do too (0.16 at d 128 on the
# CPU, tests/rwkv_bf16_depth.py); the bf16 paths are held to the f32 one
# instead, the split path no farther than RWKV_BF16_RATIO x the
# one-prefill path.  That ratio reads 1.03-1.08 in both packages there and
# 1.17 on the card; the token shift lost at the boundary reads 3.6-4.2
RWKV_STATE_TOL = 2e-4
RWKV_BF16_RATIO = 1.5
# memory a family may find allocated when it starts (what an earlier one
# left behind)
FAMILY_LEFT_BYTES = 2e9
CARD_BYTES = 80e9               # starcoder2-7b's serving must fit under it
# row 9 at each attention family's prefill shapes, beside SDPA:
# (batch, queries, cache) — the launcher's second wave (27 tokens into
# its cache of 256) and a long prefill
FAMILY_ATTN_SHAPES = {"launcher": (4, 27, 256), "long": (4, 4096, 4096)}
FAMILY_LAUNCH_KEYS = ("flash_attention", "flash_attention_by",
                      "attention_bwd_by", "rmsnorm", "rmsnorm_bwd")


def serve_family(dev, cfg, tag="8c") -> tuple[dict, object, list]:
    """``launch.serve --arch <family> --full`` with the launcher's
    defaults, each prefill and decode step recorded (ms, logits); then
    each of its waves teacher-forced through the same engine on the plain
    versions (:func:`hold_wave`).  Returns the stats, the engine and the
    requests."""
    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tfm
    torch.cuda.reset_peak_memory_stats(dev)
    n0 = launch_counts()
    rec = StepRecorder(tfm, dev)
    try:
        t0 = time.perf_counter()
        out = launch_serve.main(["--arch", cfg.name, "--full"])
        call_s = time.perf_counter() - t0
    finally:
        rec.close()
    check(not out["reduced"] and out["requests"] == 8, f"{cfg.name}: the "
          "launcher's run is not the full-width default run")
    check_tokens(out["results"], 16, cfg.vocab, f"{cfg.name} launcher request")
    eng, reqs = out["engine"], out["reqs"]
    dec = rec.ms["decode"]
    stats = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                 heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
                 head_dim=cfg.head_dim, vocab=cfg.vocab,
                 n_params=tfm.count_params(eng.params),
                 requests=out["requests"], tokens=out["tokens"],
                 wall_s=out["wall_s"], tokens_per_s=out["tokens_per_s"],
                 call_s=call_s, prefill_ms=rec.ms["prefill"],
                 decode_steps=len(dec), decode_ms_mean=float(np.mean(dec)),
                 decode_ms_p50=float(np.median(dec)),
                 decode_host_ms_mean=float(np.mean(rec.host_ms["decode"])),
                 peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                 launches=count_delta(n0, launch_counts(),
                                      FAMILY_LAUNCH_KEYS))
    order = sorted(reqs, key=lambda r: len(r.prompt))      # the engine's
    waves = [order[i:i + eng.batch_size]
             for i in range(0, len(order), eng.batch_size)]
    stats["wave_lens"] = [max(len(r.prompt) for r in w) for w in waves]
    logits, stats["vs_plain"] = list(rec.logits), []
    for w in waves:
        T = max(len(r.tokens) for r in out["results"] if r.uid in
                {x.uid for x in w})
        stats["vs_plain"].append(hold_wave(dev, eng, w, out["results"],
                                           logits[:T]))
        logits = logits[T:]
    check(not logits, f"{cfg.name}: {len(logits)} recorded steps left over")
    worst = max(v["max_abs_logit_diff"] for v in stats["vs_plain"])
    log(f"  {tag} {cfg.name}: served {stats['requests']} requests, "
        f"{stats['tokens']} tokens at {stats['tokens_per_s']:.1f} tokens/s; "
        f"prefill {[round(x, 2) for x in stats['prefill_ms']]} ms (waves of "
        f"{stats['wave_lens']} tokens), decode {stats['decode_ms_mean']:.2f} "
        f"ms/step (mean of {len(dec)}; the host enqueuing "
        f"{stats['decode_host_ms_mean']:.2f} of it); peak memory "
        f"{stats['peak_memory_bytes']} B; logits vs the plain versions "
        f"(teacher-forced, every step): max |diff| {worst:.4g}")
    log(f"    launches: {json.dumps(stats['launches'])}")
    return stats, eng, reqs


def train_family(dev, cfg) -> dict:
    """``train.loop.make_train_step`` at full width and depth (f32
    parameters, bf16 compute, remat) for :data:`FAMILY_TRAIN`'s steps
    from ``SyntheticLM(seed=0)``: every loss finite; peak memory, ms per
    step, tokens/s and the launches by variant."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import loop as train_loop
    B, S, n = FAMILY_TRAIN[cfg.name]
    check(cfg.remat and cfg.param_dtype == "float32" and
          cfg.compute_dtype == "bfloat16", f"{cfg.name}: not f32 parameters, "
          "bf16 compute, remat")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    n0 = launch_counts()
    state = train_loop.init_state(cfg, seed=0, device=dev)
    step = train_loop.make_train_step(
        cfg, adamw.OptConfig(lr=FAMILY_LR, warmup_steps=2, total_steps=n))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
    state, rec = train_steps(dev, step, state, src, n)
    steady = rec["ms"][1:]
    rec.update(batch=B, seq=S, steps=n, first_step_ms=rec["ms"][0],
               ms_per_step=float(np.median(steady)),
               tokens_per_s=B * S / float(np.median(steady)) * 1e3,
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               launches=count_delta(n0, launch_counts(),
                                    FAMILY_LAUNCH_KEYS))
    del state, step
    torch.cuda.empty_cache()
    check(all(np.isfinite(rec["losses"])), f"8c {cfg.name}: a training "
          f"loss is not finite: {rec['losses']}")
    log(f"  8c {cfg.name} training, batch {B} x seq {S}, {n} steps: "
        f"{rec['ms_per_step']:.1f} ms/step (median after the first; first "
        f"{rec['first_step_ms']:.0f} ms), {rec['tokens_per_s']:.0f} tokens/s,"
        f" peak memory {rec['peak_memory_bytes']} B; losses "
        f"{[round(x, 4) for x in rec['losses']]}")
    return rec


def rwkv_split_and_full(cfg, params, toks, shift_lost=False) -> tuple:
    """The last logits of ``prefill`` over the first :data:`RWKV_SPLIT`
    tokens and teacher-forced ``decode_step``s over the rest, and of one
    ``prefill`` over all of ``toks``.  ``shift_lost`` zeroes the token
    shift's carried tokens at the boundary (a fault, to read what the bf16
    check separates)."""
    import torch
    from repro_torch.models import transformer as tfm
    with torch.inference_mode():
        full, _ = tfm.prefill(cfg, params, {"tokens": toks}, max_len=0)
        got, cache = tfm.prefill(cfg, params,
                                 {"tokens": toks[:, :RWKV_SPLIT]}, max_len=0)
        if shift_lost:
            cache["x_tm"].zero_()
            cache["x_cm"].zero_()
        for t in range(RWKV_SPLIT, toks.shape[1]):
            got, cache = tfm.decode_step(cfg, params, toks[:, t:t + 1],
                                         cache)
    return got, full


def rwkv_long_wave(dev, eng) -> dict:
    """rwkv6's long wave through the launcher's engine: 4 prompts
    left-padded to 512 tokens (16 chunks, the state carried), 32 new
    tokens, recorded; then the state across the prefill/decode boundary:
    the last logits of ``prefill`` over the 512 tokens against ``prefill``
    over the first 480 and 32 teacher-forced ``decode_step``s, in f32
    compute (the launcher's seed-0 parameters at f32) within
    :data:`RWKV_STATE_TOL`; the served bf16 paths against the f32 logits
    (:data:`RWKV_BF16_RATIO`)."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, pad_wave
    cfg = eng.cfg
    rng = np.random.default_rng(13)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (n,))
                    .astype(np.int32), max_new_tokens=RWKV_NEW_TOKENS)
            for i, n in enumerate(RWKV_WAVE_LENS)]
    wave = sorted(reqs, key=lambda r: len(r.prompt))
    toks = torch.from_numpy(pad_wave(wave)).to(dev)
    check(toks.shape == (4, 512), f"the rwkv6 wave is {tuple(toks.shape)}")
    rec = StepRecorder(tfm, dev)
    try:
        t0 = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    check_tokens(results, RWKV_NEW_TOKENS, cfg.vocab,
                 "rwkv6 long-wave request")
    total = sum(len(r.tokens) for r in results)
    dec = rec.ms["decode"]
    out = dict(prompt_lens=list(RWKV_WAVE_LENS), padded_to=512,
               chunks=512 // 32, new_tokens=RWKV_NEW_TOKENS, tokens=total,
               wall_s=wall, tokens_per_s=total / wall,
               prefill_ms=rec.ms["prefill"][0],
               prefill_tokens_per_s=4 * 512 / rec.ms["prefill"][0] * 1e3,
               decode_ms_mean=float(np.mean(dec)),
               decode_ms_p50=float(np.median(dec)))
    t0 = time.perf_counter()
    got_b, full_b = rwkv_split_and_full(cfg, eng.params, toks)
    fault_b, _ = rwkv_split_and_full(cfg, eng.params, toks, shift_lost=True)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = tfm.init_params(cfg, seed=0, device=dev)   # the launcher's
    check(torch.equal(p32["embed"].to(eng.params["embed"].dtype),
                      eng.params["embed"]), "rwkv6: seed 0 did not give the "
          "launcher's parameters")
    got_f, full_f = rwkv_split_and_full(cfg32, p32, toks)
    del p32
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()

    def dmax(a, b):
        return float((a - b).abs().max())
    st = dict(prefill=512, split=RWKV_SPLIT, decode_steps=512 - RWKV_SPLIT,
              f32_max_abs_logit_diff=dmax(got_f, full_f),
              f32_tolerance=RWKV_STATE_TOL,
              bf16_max_abs_logit_diff=dmax(got_b, full_b),
              bf16_prefill_vs_f32=dmax(full_b, full_f),
              bf16_split_vs_f32=dmax(got_b, full_f),
              bf16_ratio=dmax(got_b, full_f) / dmax(full_b, full_f),
              bf16_ratio_limit=RWKV_BF16_RATIO,
              fault_shift_lost_ratio=dmax(fault_b, full_f)
              / dmax(full_b, full_f),
              logit_scale=float(full_f.abs().max()),
              same_argmax_f32=bool(torch.equal(got_f.argmax(-1),
                                               full_f.argmax(-1))),
              seconds=time.perf_counter() - t0)
    out["state_check"] = st
    log(f"  8c rwkv6 long wave: {json.dumps(out)}")
    check(bool(torch.isfinite(got_b).all()) and bool(torch.isfinite(
        got_f).all()), "rwkv6: non-finite logits in the state check")
    check(bool(torch.allclose(got_f, full_f, rtol=RWKV_STATE_TOL,
                              atol=RWKV_STATE_TOL)),
          f"rwkv6 (f32): prefill over {RWKV_SPLIT} tokens and "
          f"{512 - RWKV_SPLIT} decode steps disagree with one prefill over "
          f"512 by {st['f32_max_abs_logit_diff']} (rtol = atol = "
          f"{RWKV_STATE_TOL})")
    check(st["bf16_split_vs_f32"] <= RWKV_BF16_RATIO *
          st["bf16_prefill_vs_f32"], f"rwkv6 (bf16): the split path lies "
          f"{st['bf16_split_vs_f32']} from the f32 logits, more than "
          f"{RWKV_BF16_RATIO} x the one-prefill path's "
          f"{st['bf16_prefill_vs_f32']}")
    return out


def family_attention_times(dev, cfg, tag="8c") -> dict:
    """Row 9 at the family's prefill shapes (:data:`FAMILY_ATTN_SHAPES`,
    bf16, causal, the cache filled to the queries): against its plain
    version at the main path's tolerance, and its device time beside the
    plain version's, SDPA's (timed only) and the bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(17)
    tol = LM_TOL["bfloat16"]["flash_attention"]
    out = {}
    for key, (B, S, max_len) in FAMILY_ATTN_SHAPES.items():
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((B, max_len, Hkv, hd), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        c = dict(B=B, Sq=S, Skv=max_len, causal=True, q_offset=0, kv_len=S)
        kw = dict(causal=True, q_offset=0, kv_len=S)
        variant = fa.variant_of(q, k)
        check(variant == "prefill_mma", f"{cfg.name} {key}: the dispatch "
              f"rule names {variant}, not prefill_mma")
        run_k = lambda: fa.flash_attention_cuda(q, k, v, **kw)  # noqa: E731
        run_p = lambda: fa.attention(q, k, v, **kw)             # noqa: E731
        got, want = run_k(), run_p()
        ratio = fa.error_ratio(got, want, tol)
        err = float((got.float() - want.float()).abs().max())
        check(ratio <= 1, f"{cfg.name} {key}: row 9 disagrees with its plain "
              f"version ({ratio} of {ATTN_RULE.format(tol)})")
        shape = (f"B={B}, Sq={S}, Skv={max_len}, H={H}/{Hkv}, hd={hd}, "
                 f"kv_len={S}, bfloat16")
        out[key] = dict(**time_lm(run_k, run_p, sdpa_call(q, k, v, c), 5,
                                  "flash_attention",
                                  attention_bound(q, k, c), shape),
                        max_abs_err=err, tol_ratio=ratio, variant=variant)
        log(f"  {tag} row 9 at {cfg.name}'s {key} prefill ({shape}): "
            f"{out[key]['ms']:.4f} ms ({out[key]['ms_from']}), SDPA "
            f"{out[key]['library_ms']:.4f} ms, plain "
            f"{out[key]['plain_ms']:.3f} ms, bound "
            f"{out[key]['bound_ms']:.4f} ms ({out[key]['bound_by']}); "
            f"{ratio:.3f} of the tolerance")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def phase_families(dev) -> dict:
    """Phase 8c: stablelm-1.6b served and trained, starcoder2-7b served,
    rwkv6-1.6b served (its long wave and state check) and trained, each at
    full width and depth; the launches of the main path (the counts set
    to 0 by the caller just before) read after the runs; then row 9 timed
    at the attention families' prefill shapes."""
    import torch
    from repro_torch.configs.base import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False    # as phase 7 sets it
    t0 = time.perf_counter()
    fam, traced = {}, []
    for name in FAMILY_ARCHS:
        cfg = get_arch(name)
        t1 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated(dev)
        check(left < FAMILY_LEFT_BYTES, f"8c {name}: {left} B still "
              "allocated when it starts")
        fam[name], eng, reqs = serve_family(dev, cfg)
        fam[name]["allocated_at_start_bytes"] = left
        if cfg.name == "starcoder2-7b":
            check(fam[name]["peak_memory_bytes"] < CARD_BYTES, f"{name}: "
                  f"peak memory {fam[name]['peak_memory_bytes']} B, not "
                  f"under {CARD_BYTES:.0f}")
        if cfg.rwkv:
            fam[name]["long_wave"] = rwkv_long_wave(dev, eng)
        n_t = launch_counts()          # one decode wave traced, not counted
        fam[name]["decode_trace"] = trace_decode(     # the longest wave
            dev, eng, sorted(reqs, key=lambda r: len(r.prompt))
            [-eng.batch_size:],
            want=() if cfg.rwkv else ("flash_attention",))
        traced.append(count_delta(n_t, launch_counts(), FAMILY_LAUNCH_KEYS))
        del eng, reqs
        torch.cuda.empty_cache()
        if name in FAMILY_TRAIN:
            fam[name]["train"] = train_family(dev, cfg)
        fam[name]["seconds"] = time.perf_counter() - t1
    launches = {k: v for k, v in launch_counts().items()
                if k in FAMILY_LAUNCH_KEYS}
    for d in traced:
        launches = count_delta(d, launches, FAMILY_LAUNCH_KEYS)
    fam["launches"] = launches
    log(f"  main-path launches (phase 8c; the traced decode steps taken "
        f"out): {json.dumps(fam['launches'])}")
    for name in ("stablelm-1.6b", "starcoder2-7b"):
        by = fam[name]["launches"]["flash_attention_by"]
        for k in MAIN_ATTENTION_VARIANTS:
            check(by[k] > 0, f"8c {name}: attention variant {k} was never "
                  "launched")
    check(fam["rwkv6-1.6b"]["launches"]["flash_attention"] == 0,
          "8c rwkv6-1.6b launched the attention kernel")
    st = fam["stablelm-1.6b"]["train"]
    by = st["launches"]["attention_bwd_by"]
    check(by["dq_mma"] == by["dkdv_mma"] > 0 and by["dq_f32"] ==
          by["dkdv_f32"] == 0, f"8c stablelm-1.6b training launched the "
          f"backward kernels {json.dumps(by)}, want only dq_mma and dkdv_mma")
    first, last = (float(np.mean(st["losses"][:5])),
                   float(np.mean(st["losses"][-5:])))
    st.update(mean_first_5=first, mean_last_5=last)
    check(last < first, f"8c stablelm-1.6b: the loss did not fall ({first} "
          f"-> {last})")
    fam["main_path_s"] = time.perf_counter() - t0
    fam["stablelm-1.6b"]["train"]["vs_plain"] = phase_train_vs_plain(
        dev, get_arch("stablelm-1.6b"), tag="8c stablelm-1.6b")
    fam["attention_times"] = {name: family_attention_times(dev,
                                                           get_arch(name))
                              for name in ("stablelm-1.6b", "starcoder2-7b")}
    fam["seconds"] = time.perf_counter() - t0
    return fam


# ---------------------------------------------------------------------------
# phase 8d: MoE at full width (llama4-scout, kimi-k2), the depth cut
# ---------------------------------------------------------------------------
MOE_ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b")
MOE_LAYERS = 2               # from 48 and 61: llama4's 2 MoE layers, kimi's
#                              dense layer and its first MoE layer
# kimi-k2's 2 layers hold 1.99e10 parameters: 79.7 GB at f32, 39.9 in bf16
MOE_PARAM_DTYPE = {"kimi-k2-1t-a32b": "bfloat16"}
# the long wave: 4 prompts of 4096 tokens (T = 16384: 32 MoE groups of
# 512) into a cache of 4104, 8 new tokens
MOE_LONG = dict(prompts=4, tokens=4096, cache=4104, new_tokens=8)
# teacher-forced against the plain path, routing taken into account: the
# plain replay records each MoE layer's own decisions and then follows the
# kernel path's (its top-k experts; gates renormalised from its own
# probabilities, queue places and capacity mask recomputed), so a near
# tie decided otherwise on the two paths does not carry into later
# layers and steps.  Every step's logits are then held to the CPU tests'
# bf16 tolerance, and every token whose expert set the plain path would
# have chosen otherwise must be a near tie: the gap between its k-th and
# (k+1)-th router logit on the kernel path below ROUTE_MARGIN (16 bf16
# steps of 2^-8: the two paths' router inputs differ in their last bits,
# and on the card that gap moved by at most 0.044 between them over 33k
# routed tokens, by 0.034 at the 99.9th percentile: PERF.md, phase 8d).
# What the two limits refuse is read from planted faults of row 9
# (moe_fault_readings): on the card kimi-k2 with dims 104-111 zeroed
# moved the logits by 2.44 and was routed otherwise at margins up to
# 0.22; with the long wave's last split lost, by 0.32 (margins below
# 0.05)
MOE_LOGIT_TOL = 0.125
ROUTE_MARGIN = 2 ** -4
MOE_TRAIN = (4, 128, 3)      # batch, seq, steps at reduced() in bf16
MOE_LAUNCH_KEYS = (*FAMILY_LAUNCH_KEYS, "rmsnorm_by")


class RouteRecorder:
    """Wraps ``moe.route`` (which ``moe.moe_block`` calls) while open and
    records each call's own decisions: the top-k experts (as chosen, and
    sorted) and the capacity mask (in the sorted order), each token's
    margin (the gap between its k-th and (k+1)-th router logit, ``log p_k
    - log p_k+1``), the two experts at that gap and the log-probabilities,
    on the card, in ``calls``.  ``force`` (another run's ``calls``) makes
    call i route as that run's call i did: ``moe.decide`` on this call's
    probabilities and that call's experts, in its order."""

    def __init__(self, force=None):
        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe.route, []

        def call(cfg, p, xg):
            r = self.real(cfg, p, xg)
            k = cfg.top_k
            logp = r.probs.detach().reshape(-1, cfg.n_experts).log()
            top = logp.topk(k + 1, dim=-1)
            idx, order = r.idx.reshape(-1, k).sort(dim=-1)
            self.calls.append(dict(
                chosen=r.idx, idx=idx,
                keep=r.keep.reshape(-1, k).gather(-1, order),
                margin=top.values[:, k - 1] - top.values[:, k],
                pair=top.indices[:, k - 1:k + 1], logp=logp, C=r.C))
            if force is None:
                return r
            idx = force[len(self.calls) - 1]["chosen"]
            check(idx.shape == r.idx.shape, f"forced routing "
                  f"{tuple(idx.shape)} for a call of {tuple(r.idx.shape)}")
            return moe.decide(cfg, r.probs, idx)
        moe.route = call

    def close(self):
        self.moe.route = self.real

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def on_host(calls) -> list:
    """A :class:`RouteRecorder`'s calls copied to the host."""
    return [{k: v.cpu() if hasattr(v, "cpu") else v for k, v in c.items()
             if k != "chosen"} for c in calls]


class AuxRecorder:
    """Wraps ``moe.moe_block`` while open: each call's aux loss (on the
    card)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.aux = moe, moe.moe_block, []

        def call(cfg, p, x):
            y, aux = self.real(cfg, p, x)
            self.aux.append(aux.detach())
            return y, aux
        moe.moe_block = call

    def close(self):
        self.moe.moe_block = self.real


def compare_routes(kern, plain, tag) -> dict:
    """The kernel path's recorded decisions against the plain path's own
    (that run forced to the kernel path's), call by call: every token
    whose expert set differs must have a kernel-side margin below
    :data:`ROUTE_MARGIN`; a call whose sets all agree must have equal
    capacity masks (the mask follows from the sets).  Returns the calls
    and tokens that differ, their margins, and how far the margin's gap
    moved between the two paths (the largest over every token, and its
    99.9th percentile)."""
    import torch
    check(len(kern) == len(plain), f"{tag}: {len(kern)} routed calls on "
          f"the kernel path, {len(plain)} on the plain path")
    flips, moved = [], []
    for c, (a, b) in enumerate(zip(kern, plain)):
        check(a["C"] == b["C"] and a["idx"].shape == b["idx"].shape,
              f"{tag}, call {c}: capacity {a['C']} / {b['C']}, shapes "
              f"{tuple(a['idx'].shape)} / {tuple(b['idx'].shape)}")
        la, lb = (x["logp"].gather(-1, a["pair"]) for x in (a, b))
        moved.append(((la[:, 0] - la[:, 1]) - (lb[:, 0] - lb[:, 1])).abs())
        rows = (a["idx"] != b["idx"]).any(-1)
        if bool(rows.any()):
            flips += [(c, int(t), float(a["margin"][t])) for t in
                      torch.nonzero(rows).flatten()]
        else:
            check(torch.equal(a["keep"], b["keep"]), f"{tag}, call {c}: "
                  "every expert set agrees with the plain path's but the "
                  "capacity masks differ")
    for c, t, m in flips:
        check(m < ROUTE_MARGIN, f"{tag}, call {c}, token {t}: the expert "
              f"set differs from the plain path's at a margin {m} >= "
              f"{ROUTE_MARGIN}")
    moved = torch.cat(moved) if moved else torch.zeros(1)
    return dict(calls=len(kern), tokens=int(moved.numel()),
                calls_differing=len({c for c, _, _ in flips}),
                tokens_differing=len(flips),
                margins=[round(m, 6) for _, _, m in flips][:40],
                max_margin=max((m for _, _, m in flips), default=None),
                gap_moved_max=float(moved.max()),
                gap_moved_p999=float(torch.quantile(moved.float(), 0.999))
                if moved.numel() <= 1 << 24 else None,
                margin_limit=ROUTE_MARGIN)


def serve_moe_wave(dev, eng, reqs, routed=True) -> tuple:
    """``eng.run(reqs)`` with each step (ms, logits) and, ``routed``, each
    MoE layer's routing recorded; returns the results, the wall seconds,
    the step recorder and the routing recorder's calls (None unrouted)."""
    import contextlib
    import torch
    from repro_torch.models import transformer as tfm
    rec = StepRecorder(tfm, dev)
    try:
        with RouteRecorder() if routed else contextlib.nullcontext() as rr:
            t0 = time.perf_counter()
            results = eng.run(reqs)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    finally:
        rec.close()
    return results, wall, rec, rr.calls if routed else None


def timed_moe_wave(dev, eng, reqs, results) -> dict:
    """``eng.run(reqs)`` again with no routing recorder (the step
    recorder's synchronisation before and after each step, as phase 8c
    times its families): wall seconds, tokens/s, prefill and decode ms a
    step and the host's share; whether its tokens equal ``results``'s
    (the recorded run's)."""
    again, wall, rec, _ = serve_moe_wave(dev, eng, reqs, routed=False)
    total = sum(len(r.tokens) for r in again)
    dec = rec.ms["decode"]
    return dict(wall_s=wall, tokens=total, tokens_per_s=total / wall,
                prefill_ms=rec.ms["prefill"], decode_steps=len(dec),
                decode_ms_mean=float(np.mean(dec)),
                decode_ms_p50=float(np.median(dec)),
                decode_host_ms_mean=float(np.mean(rec.host_ms["decode"])),
                tokens_equal_recorded=all(
                    np.array_equal(a.tokens, b.tokens)
                    for a, b in zip(again, results)))


def serve_moe(dev, name, keep=False) -> tuple[dict, dict | None]:
    """One MoE config at full width and :data:`MOE_LAYERS` layers (random
    parameters from seed 0): the launcher's default requests through a
    ``ServeEngine`` (8 prompts of 4-32 tokens, numpy seed 0, 16 new
    tokens, waves of 4, cache 256), then the long wave (:data:`MOE_LONG`)
    through an engine with its cache; every wave served twice, first
    with its routing recorded and teacher-forced against the plain
    versions (:func:`hold_wave`), then timed with no routing recorder
    (:func:`timed_moe_wave`).  Tokens/s, prefill and decode ms (of the
    timed runs; the recorded runs' beside), peak memory, dropped (token,
    choice) pairs and the launches of the served runs (the replays
    launch nothing).  With ``keep``, also the config, the engine's
    parameters and both sets of requests (for :func:`moe_fault_readings`);
    else None."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine
    base = get_arch(name)
    cfg = dataclasses.replace(base, n_layers=MOE_LAYERS,
                              param_dtype=MOE_PARAM_DTYPE.get(
                                  name, base.param_dtype))
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    check(left < FAMILY_LEFT_BYTES, f"8d {name}: {left} B still allocated "
          "when it starts")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    st = dict(arch=name, n_layers=cfg.n_layers, cut_from=base.n_layers,
              n_dense_layers=cfg.n_dense_layers, d_model=cfg.d_model,
              heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
              head_dim=cfg.head_dim, experts=cfg.n_experts, top_k=cfg.top_k,
              moe_d_ff=cfg.moe_d_ff, shared_expert=cfg.shared_expert,
              param_dtype=cfg.param_dtype, n_params=tfm.count_params(params),
              init_s=time.perf_counter() - t0,
              allocated_at_start_bytes=left)
    eng = ServeEngine(cfg, params, batch_size=4, max_len=256, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)                 # the launcher's requests
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (int(
        rng.integers(4, 32)),)).astype(np.int32), max_new_tokens=16)
        for i in range(8)]
    n0 = launch_counts()          # the replays between the runs launch none
    results, wall, rec, routes = serve_moe_wave(dev, eng, reqs)
    st["dropped_launcher"] = sum(int((~c["keep"]).sum()) for c in routes)
    check_tokens(results, 16, cfg.vocab, f"8d {name} request")
    total = sum(len(r.tokens) for r in results)
    dec = rec.ms["decode"]
    st["recorded"] = dict(
        wall_s=wall, tokens_per_s=total / wall, prefill_ms=rec.ms["prefill"],
        decode_ms_mean=float(np.mean(dec)),
        decode_host_ms_mean=float(np.mean(rec.host_ms["decode"])))
    st.update(requests=len(reqs), **timed_moe_wave(dev, eng, reqs, results))
    order = sorted(reqs, key=lambda r: len(r.prompt))      # the engine's
    waves = [order[i:i + 4] for i in range(0, len(order), 4)]
    st["wave_lens"] = [max(len(r.prompt) for r in w) for w in waves]
    n_moe = cfg.n_layers - cfg.n_dense_layers
    logits, st["vs_plain"] = list(rec.logits), []
    for w in waves:
        T = max(len(r.tokens) for r in results if r.uid in
                {x.uid for x in w})
        st["vs_plain"].append(hold_wave(dev, eng, w, results, logits[:T],
                                        routes[:T * n_moe]))
        logits, routes = logits[T:], routes[T * n_moe:]
    check(not logits and not routes, f"8d {name}: recorded steps left over")
    # the long wave
    L = MOE_LONG
    rng = np.random.default_rng(13)
    long_reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (
        L["tokens"],)).astype(np.int32), max_new_tokens=L["new_tokens"])
        for i in range(L["prompts"])]
    eng_long = ServeEngine(cfg, eng.params, batch_size=L["prompts"],
                           max_len=L["cache"], device=dev)
    del eng
    results, wall, rec, routes = serve_moe_wave(dev, eng_long, long_reqs)
    check_tokens(results, L["new_tokens"], cfg.vocab, f"8d {name} long-wave "
                 "request")
    total = sum(len(r.tokens) for r in results)
    pre = routes[:n_moe]
    tokens = L["prompts"] * L["tokens"]
    dropped = [int((~c["keep"]).sum()) for c in pre]
    dec = rec.ms["decode"]
    timed = timed_moe_wave(dev, eng_long, long_reqs, results)
    launches = count_delta(n0, launch_counts(), MOE_LAUNCH_KEYS)
    st["long_wave"] = dict(
        **L, tokens_served=timed["tokens"], wall_s=timed["wall_s"],
        tokens_per_s=timed["tokens_per_s"], prefill_ms=timed["prefill_ms"][0],
        prefill_tokens_per_s=tokens / timed["prefill_ms"][0] * 1e3,
        decode_steps=timed["decode_steps"],
        decode_ms_mean=timed["decode_ms_mean"],
        decode_ms_p50=timed["decode_ms_p50"],
        decode_host_ms_mean=timed["decode_host_ms_mean"],
        tokens_equal_recorded=timed["tokens_equal_recorded"],
        recorded=dict(wall_s=wall, tokens_per_s=total / wall,
                      prefill_ms=rec.ms["prefill"][0],
                      decode_ms_mean=float(np.mean(dec))),
        groups=tokens // min(cfg.moe_group_size, tokens),
        capacity=pre[0]["C"], choices=tokens * cfg.top_k,
        dropped_by_moe_layer=dropped,
        dropped_decode=sum(int((~c["keep"]).sum()) for c in routes[n_moe:]))
    st["long_wave"]["vs_plain"] = hold_wave(
        dev, eng_long, sorted(long_reqs, key=lambda r: len(r.prompt)),
        results, rec.logits, routes)
    st["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    st["launches"] = launches
    kept = dict(cfg=cfg, params=eng_long.params, reqs=reqs,
                long_reqs=long_reqs) if keep else None
    del eng_long, rec, routes
    gc.collect()
    torch.cuda.empty_cache()
    check(st["peak_memory_bytes"] < CARD_BYTES, f"8d {name}: peak memory "
          f"{st['peak_memory_bytes']} B, not under {CARD_BYTES:.0f}")
    vp = [*st["vs_plain"], st["long_wave"]["vs_plain"]]
    log(f"  8d {name} ({cfg.n_layers} of {base.n_layers} layers, "
        f"{st['n_params']} {cfg.param_dtype} parameters, init "
        f"{st['init_s']:.1f} s): served {st['requests']} requests, "
        f"{st['tokens']} tokens at {st['tokens_per_s']:.1f} tokens/s; "
        f"prefill {[round(x, 2) for x in st['prefill_ms']]} ms (waves of "
        f"{st['wave_lens']} tokens), decode {st['decode_ms_mean']:.2f} "
        f"ms/step; long wave prefill {st['long_wave']['prefill_ms']:.1f} ms, "
        f"decode {st['long_wave']['decode_ms_mean']:.2f} ms/step, dropped "
        f"{dropped} of {tokens * cfg.top_k} choices a layer (C = "
        f"{pre[0]['C']}); peak memory {st['peak_memory_bytes']} B (timed "
        "with no routing recorder; the recorded runs: "
        f"{st['recorded']['tokens_per_s']:.1f} tokens/s, decode "
        f"{st['recorded']['decode_ms_mean']:.2f} ms/step, long wave prefill "
        f"{st['long_wave']['recorded']['prefill_ms']:.1f} ms, decode "
        f"{st['long_wave']['recorded']['decode_ms_mean']:.2f} ms/step; tokens "
        f"equal {st['tokens_equal_recorded']}, "
        f"{st['long_wave']['tokens_equal_recorded']})")
    log(f"    vs the plain versions (teacher-forced and routed as the kernel "
        f"path, every step): max |diff| "
        f"{[round(v['max_abs_logit_diff'], 5) for v in vp]} (limit "
        f"{MOE_LOGIT_TOL}); tokens the plain path routes otherwise "
        f"{[v['routing']['tokens_differing'] for v in vp]} at margins "
        f"{[v['routing']['margins'] for v in vp]} (limit {ROUTE_MARGIN}); "
        f"the margin's gap moved by at most "
        f"{[round(v['routing']['gap_moved_max'], 5) for v in vp]}")
    log(f"    launches: {json.dumps(launches)}")
    return st, kept


def train_moe(dev, name) -> dict:
    """:data:`MOE_TRAIN`'s steps of ``train.loop.make_train_step`` at the
    config's reduced width in bf16 compute (hd 32; f32 parameters,
    remat), from ``SyntheticLM(seed=0)``: every loss finite, every step's
    aux loss (the MoE layers' sum, recorded in the step's forward) above
    0; ms per step, peak memory, launches."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import loop as train_loop
    cfg = dataclasses.replace(get_arch(name).reduced(),
                              compute_dtype="bfloat16")
    B, S, n = MOE_TRAIN
    n_moe = cfg.n_layers - cfg.n_dense_layers
    torch.cuda.reset_peak_memory_stats(dev)
    n0 = launch_counts()
    state = train_loop.init_state(cfg, seed=0, device=dev)
    step = train_loop.make_train_step(
        cfg, adamw.OptConfig(lr=FAMILY_LR, warmup_steps=2, total_steps=n))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
    rec = AuxRecorder()
    try:
        state, out = train_steps(dev, step, state, src, n)
    finally:
        rec.close()
    # a step's forward records its n_moe aux values first; the remat
    # recompute in its backward stops early, before the block returns
    per = len(rec.aux) // n
    check(per in (n_moe, 2 * n_moe) and per * n == len(rec.aux),
          f"8d {name} training: {len(rec.aux)} MoE calls in {n} steps")
    out.update(batch=B, seq=S, steps=n, head_dim=cfg.head_dim,
               aux=[float(sum(rec.aux[i * per:i * per + n_moe]))
                    for i in range(n)],
               ms_per_step=float(np.median(out["ms"][1:])),
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               launches=count_delta(n0, launch_counts(), MOE_LAUNCH_KEYS))
    del state, step
    torch.cuda.empty_cache()
    check(all(np.isfinite(out["losses"])), f"8d {name} training: a loss is "
          f"not finite: {out['losses']}")
    check(all(a > 0 for a in out["aux"]), f"8d {name} training: aux "
          f"{out['aux']}, want > 0")
    log(f"  8d {name} training at reduced() in bf16 (hd {cfg.head_dim}), "
        f"batch {B} x seq {S}: losses {[round(x, 4) for x in out['losses']]}"
        f", aux {[round(x, 4) for x in out['aux']]}, "
        f"{out['ms_per_step']:.1f} ms/step, peak {out['peak_memory_bytes']} B")
    return out


def train_moe_vs_plain(dev, name) -> dict:
    """At the config's reduced width in bf16 (seed 1, batch 0 of
    :data:`MOE_TRAIN`'s shape): the loss and every gradient leaf through
    the kernels against the plain path, each run's routing recorded (the
    forward and the remat recompute), the plain path routed as the kernel
    path was (:class:`RouteRecorder`'s ``force``): the loss and leaves
    held to phase 8b's tolerances, every decision the plain path would
    have taken otherwise a near tie (:func:`compare_routes`)."""
    import dataclasses
    import torch
    from repro_torch import pytree
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_arch(name).reduced(),
                              compute_dtype="bfloat16")
    B, S, _ = MOE_TRAIN
    params = tfm.init_params(cfg, seed=1, device=dev)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                        seed=0).batch_for_step(0)
    flat, treedef = pytree.flatten(params)

    def loss_and_grads(force=None):
        with RouteRecorder(force) as rec:
            leaves = [p.detach().requires_grad_(True) for p in flat]
            loss, m = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves),
                                  batch)
            grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), float(m["aux"].detach()), grads, \
            rec.calls
    n0 = launch_counts()
    lk, ak, gk, rk = loss_and_grads()
    used = count_delta(n0, launch_counts())
    check(used["attention_bwd_dkdv"] == used["attention_bwd_dq"] ==
          cfg.n_layers and used["rmsnorm_bwd"] == 2 * cfg.n_layers + 1,
          f"8d {name}: the kernel path launched {json.dumps(used)}")
    n1 = launch_counts()
    with plain_training():
        lp, ap, gp, rp = loss_and_grads(force=rk)
    check(launch_counts() == n1, f"8d {name}: the plain path launched a "
          "kernel")
    route = compare_routes(on_host(rk), on_host(rp), f"8d {name} training")
    rel = [float((a.float() - b.float()).norm() / b.float().norm())
           for a, b in zip(gk, gp)]
    out = dict(arch=name, reduced=True, head_dim=cfg.head_dim, batch=B,
               seq=S, loss_kernel=lk, loss_plain=lp,
               loss_rel_err=abs(lk - lp) / abs(lp), aux_kernel=ak,
               aux_plain=ap, max_grad_rel_err=max(rel), routing=route,
               loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL)
    log(f"  8d {name} gradients, kernels vs plain (reduced, bf16): "
        f"{json.dumps(out)}")
    check(out["loss_rel_err"] <= TRAIN_LOSS_TOL, f"8d {name}: loss {lk} vs "
          f"plain {lp}")
    check(out["max_grad_rel_err"] <= TRAIN_GRAD_TOL, f"8d {name}: a "
          f"gradient leaf is {max(rel)} off the plain path's")
    del params, gk, gp
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def refusals():
    """While open, :func:`check` notes each failing check's message in the
    list it yields instead of raising: what the checks refuse in a run
    with a planted fault."""
    global check
    real, seen = check, []

    def note(ok, what):
        if not ok:
            seen.append(what)
    check = note
    try:
        yield seen
    finally:
        check = real


def faulty_attention(fault, sms):
    """A stand-in for ``layers.flash_attention`` (which ``layers.attention``
    calls) that runs the kernels with a planted fault: ``"dims"`` zeroes
    output dims 104-111 of every call at hd 112 (the last 8 of the split
    kernel's 28-dim score quarter and of the padded prefill tile's stored
    columns); ``"split"`` merges a split decode's kernel partials without
    their last split (the most recent keys lost)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers
    real = layers.flash_attention

    def call(q, k, v, *, causal, q_offset=0, kv_len=None):
        if fault == "dims":
            o = real(q, k, v, causal=causal, q_offset=q_offset,
                     kv_len=kv_len)
            dims = torch.arange(o.shape[-1], device=o.device)
            return o.masked_fill((dims >= 104) & (dims < 112), 0)
        if fa.variant_of(q, k) != "decode_split":
            return real(q, k, v, causal=causal, q_offset=q_offset,
                        kv_len=kv_len)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
        ranges = fa.decode_splits(fa.visible_keys(q.shape[1], k.shape[1],
                                                  **kw),
                                  q.shape[0] * k.shape[2], sms)
        m, l, acc = fa.decode_partials_cuda(q, k, v, ranges, **kw)
        return fa.rows_to_heads(fa.combine_partials(
            m[:, :, :-1], l[:, :, :-1], acc[:, :, :-1]), q.shape[1]).to(
                q.dtype)
    return call


# planted faults read against phase 8d's model-level checks: (fault, wave)
MOE_FAULTS = (("dims", "launcher"), ("split", "long"))


def moe_fault_readings(dev, kept) -> list:
    """kimi-k2 served with a planted fault in row 9 (:func:`faulty_attention`:
    dims 104-111 zeroed over the launcher's first wave, the last split lost
    over the long wave), each wave teacher-forced against the plain
    versions as the served waves are (:func:`hold_wave`) with the checks'
    refusals noted (:func:`refusals`): the largest logit difference
    against :data:`MOE_LOGIT_TOL`, the tokens the plain path routes
    otherwise and their largest margin against :data:`ROUTE_MARGIN`.  The
    zeroed dims must be refused by the logit or the routing limit.  Run
    after the main path's counts are read (these runs launch row 9)."""
    import torch
    from repro_torch.models import layers
    from repro_torch.serve.engine import ServeEngine
    cfg, params = kept["cfg"], kept["params"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = {"launcher": (256, sorted(kept["reqs"], key=lambda r: len(
        r.prompt))[:4]), "long": (MOE_LONG["cache"], kept["long_reqs"])}
    out = []
    for fault, key in MOE_FAULTS:
        max_len, wave = waves[key]
        eng = ServeEngine(cfg, params, batch_size=4, max_len=max_len,
                          device=dev)
        real = layers.flash_attention
        layers.flash_attention = faulty_attention(fault, sms)
        try:
            results, _, rec, routes = serve_moe_wave(dev, eng, wave)
        finally:
            layers.flash_attention = real
        with refusals() as seen:
            v = hold_wave(dev, eng, sorted(wave, key=lambda r: len(r.prompt)),
                          results, rec.logits, routes)
        m = v["routing"]["max_margin"]
        by = [x for x, hit in (
            ("logits", v["max_abs_logit_diff"] > MOE_LOGIT_TOL),
            ("routing", m is not None and m >= ROUTE_MARGIN)) if hit]
        r = dict(fault=fault, wave=key, steps=v["steps"],
                 max_abs_logit_diff=v["max_abs_logit_diff"],
                 logit_limit=MOE_LOGIT_TOL,
                 tokens_routed_otherwise=v["routing"]["tokens_differing"],
                 max_margin=m, margin_limit=ROUTE_MARGIN, refused_by=by,
                 refusals=len(seen), first_refusals=seen[:3])
        out.append(r)
        log(f"  8d planted fault in row 9 ({fault}, {key} wave of "
            f"{len(wave)} requests, {v['steps']} steps): max |diff| "
            f"{v['max_abs_logit_diff']:.5f} (limit {MOE_LOGIT_TOL}), "
            f"{r['tokens_routed_otherwise']} tokens routed otherwise, "
            f"largest margin {m} (limit {ROUTE_MARGIN}); refused by "
            f"{by or 'neither limit'}; {len(seen)} checks failed: "
            f"{seen[:2]}")
        del eng, rec, routes, results
    check(out[0]["refused_by"], "8d: kimi-k2 served with row 9's dims "
          "104-111 zeroed passes the logit and routing limits")
    return out


# row 9 at a served model's heads (kimi-k2's 64/8 and zamba2's 32/32, hd
# 112): the launcher's cache of 256 (every case of attention_cases at B =
# 4, S = 27) and the long wave's 4104 (its decode cases; S = 4080 puts the
# case "decode" at 4096 keys, 16 splits at kimi's 8 kv heads and 5 at
# zamba2's 32, and "decode_past_cache" reads all 4104; the long prefill
# is timed on its own), f32 and bf16
SERVED_ATTN_CASES = {256: (4, 27), MOE_LONG["cache"]: (4, 4080)}


def served_attention_holds(dev, cfg, tag) -> dict:
    """Row 9 at ``cfg``'s heads and head dim against its plain version
    (:func:`attention_holds`) at :data:`SERVED_ATTN_CASES`: the wrapper,
    the split kernel's partials and the combine pass alone and the planted
    lost split (case ``decode``) at both caches, the bf16 decode mid the
    long cache timed beside SDPA and its bound.  Returns the errors by
    dtype and variant, that time and the planted readings."""
    import torch
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(19)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs, times, planted = lm_errs(), {}, {}
    for max_len, (B, S) in SERVED_ATTN_CASES.items():
        cases = attention_cases(B, S, max_len, H // Hkv)
        if max_len != 256:
            cases = {k: c for k, c in cases.items() if k.startswith("decode")}
        for dtn in LM_TOL:
            long_bf16 = max_len != 256 and dtn == "bfloat16"
            t, pl = attention_holds(dev, gen, sms, errs, dtn, H, Hkv, hd,
                                    cases, ("decode",) if long_bf16 else ())
            times.update(t)
            planted.update({f"{dtn} cache {max_len}": x
                            for x in pl.values()})
    torch.cuda.empty_cache()
    out = dict(errors={dtn: {k: errs[dtn][k] for k in (
        "flash_attention", "decode_split", "decode_combine", "prefill_mma",
        "tiled_f32")} for dtn in errs},
        decode=times["flash_attention decode bfloat16"], planted=planted)
    d = out["decode"]
    log(f"  {tag} row 9 at {cfg.name}'s decode ({d['shape']}): "
        f"{d['ms']:.4f} ms ({d['ms_from']}), SDPA {d['library_ms']:.4f} ms, "
        f"plain {d['plain_ms']:.3f} ms, bound {d['bound_ms']:.5f} ms "
        f"({d['bound_by']}); {d['n_split']} splits; errors "
        f"{json.dumps(out['errors'])}; planted lost split "
        f"{json.dumps(planted)}")
    return out


def moe_norm_widths(dev) -> list:
    """Row 10 at the MoE models' widths, d 5120 and 7168 (the decode
    step's 4 rows, a wave's 128, the long wave's 16384), every variant
    that takes them against the plain version (:func:`phase_norm_variants`;
    bf16 takes ``split``)."""
    from repro_torch.kernels import rmsnorm as rn
    for d in (5120, 7168):
        check(rn.norm_variant(d, 2) == "split", f"rmsnorm at d {d} bf16 "
              f"takes {rn.norm_variant(d, 2)}, not split")
    return phase_norm_variants(dev, rows_list=(4, 128, 16384),
                               ds=(5120, 7168))


def phase_moe(dev) -> dict:
    """Phase 8d: llama4-scout and kimi-k2 trained at their reduced width
    in bf16 (:func:`train_moe`), then served at full width and 2 layers
    (:func:`serve_moe`); the launches of the main path (the counts set to
    0 by the caller just before) read after them; then kimi-k2 served with
    planted faults (:func:`moe_fault_readings`), the training's kernels
    against the plain path, row 10 at the models' widths and row 9 at
    kimi-k2's shapes (hd 112): timed at its prefills, held at its cases
    (:func:`served_attention_holds`)."""
    import torch
    from repro_torch.configs.base import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False    # as phase 7 sets it
    t0 = time.perf_counter()
    out, kept, trained = {}, None, {}
    for name in MOE_ARCHS:
        trained[name] = train_moe(dev, name)
    for name in MOE_ARCHS:
        t1 = time.perf_counter()
        out[name], k = serve_moe(dev, name, keep=name == MOE_ARCHS[-1])
        kept = k or kept
        out[name]["seconds"] = time.perf_counter() - t1
        out[name]["train"] = trained[name]
    launches = {k: v for k, v in launch_counts().items()
                if k in MOE_LAUNCH_KEYS}
    out["launches"] = launches
    out["main_path_s"] = time.perf_counter() - t0
    log(f"  main-path launches (phase 8d): {json.dumps(launches)}")
    out["faults"] = moe_fault_readings(dev, kept)
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    for name in MOE_ARCHS:
        by = out[name]["launches"]["flash_attention_by"]
        for k in MAIN_ATTENTION_VARIANTS:
            check(by[k] > 0, f"8d {name}: attention variant {k} was never "
                  "launched")
        check(out[name]["launches"]["rmsnorm_by"]["split"] > 0, f"8d {name}:"
              " rmsnorm's split variant was never launched")
        by = out[name]["train"]["launches"]["attention_bwd_by"]
        check(by["dq_mma"] == by["dkdv_mma"] > 0, f"8d {name} training "
              f"launched the backward kernels {json.dumps(by)}")
    for name in MOE_ARCHS:
        out[name]["train"]["vs_plain"] = train_moe_vs_plain(dev, name)
    out["norm_widths"] = moe_norm_widths(dev)
    kimi = get_arch("kimi-k2-1t-a32b")
    check(kimi.head_dim == 112, f"kimi-k2's head dim is {kimi.head_dim}")
    out["attention_times"] = family_attention_times(dev, kimi, tag="8d")
    out["attention_hd112"] = served_attention_holds(dev, kimi, "8d")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 8e: the Mamba2 hybrid (zamba2-7b) at full width and depth
# ---------------------------------------------------------------------------
HYBRID_ARCH = "zamba2-7b"
# the long wave: 4 prompts of 4096 tokens (16 SSD chunks of 256, the state
# carried) into a cache of 4104, 8 new tokens
HYBRID_LONG = dict(prompts=4, tokens=4096, cache=4104, new_tokens=8)
# the state across the prefill/decode boundary, on the long wave's first
# prompt: a prefill over its first HYBRID_SPLIT tokens, then the rest
# teacher-forced through decode steps, every step's logits against the
# logits of one forward over the whole prompt at the same position (and
# the last against one prefill over it), in f32 compute within
# HYBRID_STATE_TOL (rtol = atol); bf16's drift (one bf16 forward against
# the f32 one) is read beside it.  The tolerance is the f32 arithmetic's
# at 81 layers, not RWKV6's 2e-4 at 24: on the card the prefill's own
# last logits (no state handed over yet: a prefill over 3840 tokens
# against one forward over 4096, at the same position) lay 2.4 x 2e-4
# apart and the decode steps up to 9.3 x (2.0e-3 at a logit scale of
# 5.3), while the planted faults (the conv tails or h zeroed at the
# boundary) read 16,000-22,000 x 2e-4 and must be refused within
# HYBRID_FAULT_STEPS decode steps: the random model's decays (A = -1, dt
# ~ 0.7) forget a fault in h within some tens of tokens, so one read at
# the prompt's end would not see it.  The first card reading is printed
# each run as ``noise_floor_ratio`` (step 0)
HYBRID_SPLIT = 3840
HYBRID_STATE_TOL = 5e-3
HYBRID_FAULT_STEPS = 8
# training at full width, its depth cut to 12 layers (2 attention sites):
# (batch, seq, steps) with a resume after HYBRID_RESUME_AT steps
HYBRID_TRAIN_LAYERS = 12
HYBRID_TRAIN = (4, 128, 12)
HYBRID_RESUME_AT = 6
# the kernels' gradients against the plain path's at batch 1 x seq 4096
# within phase 8b's TRAIN_GRAD_TOL, at 6 layers (the first attention
# site), with dQ's dims 104-111 zeroed refused: the two bf16 paths part
# with depth, their largest leaf 1.9 % apart at 6 layers, 5.2 % at 12 and
# 10.3 % at 18, while in f32 compute they lie 2.9e-5 / 4.9e-5 / 9.0e-5
# apart (scripts/hybrid_grad_depth.py on an H100 80GB HBM3 at 700 W)
HYBRID_GRAD_LAYERS = 6
HYBRID_NORM_ROWS = (4, 128, 16384)


class NormWidths:
    """Wraps ``layers.rmsnorm`` (the model's RMSNorm, which the Mamba
    block's gated norm also calls) while open and counts row 10's launches
    by the rows' width (the launches each call made; a plain replay's
    calls make none)."""

    def __init__(self):
        from repro_torch.kernels import rmsnorm as rn
        from repro_torch.models import layers
        self.layers, self.real, self.by = layers, layers.rmsnorm, {}
        kernel = rn.rmsnorm_cuda

        def call(x, w, eps=1e-5):
            n0 = kernel.launches
            y = self.real(x, w, eps)
            d = int(x.shape[-1])
            self.by[d] = self.by.get(d, 0) + kernel.launches - n0
            return y
        layers.rmsnorm = call

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.layers.rmsnorm = self.real
        return False


def hybrid_forward_logits(cfg, params, toks, start):
    """The logits of one forward over ``toks`` at positions start.. (the
    final norm and the unembedding of each position), f32 on the host."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tfm
    with torch.inference_mode():
        h, _ = tfm.forward(dataclasses.replace(cfg, remat=False), params,
                           {"tokens": toks})
        return tfm.unembed(cfg, params, h[:, start:]).float().cpu()


def hybrid_split(cfg, params, toks, faults=()):
    """The logits of a prefill over ``toks[:, :HYBRID_SPLIT]`` (its last
    position) and of each teacher-forced decode step after it, f32 on the
    host [B, n, V]; and for each of ``faults`` (``"conv"``, ``"h"``) the
    same from a copy of the prefill's cache with that part of every Mamba
    layer's state zeroed, over :data:`HYBRID_FAULT_STEPS` steps."""
    import torch
    from repro_torch import pytree
    from repro_torch.models import transformer as tfm

    def walk(lg, cache, n):
        out = [lg.cpu()]
        for t in range(HYBRID_SPLIT, HYBRID_SPLIT + n):
            lg, cache = tfm.decode_step(cfg, params, toks[:, t:t + 1], cache)
            out.append(lg.cpu())
        return torch.stack(out, dim=1)
    with torch.inference_mode():
        lg, cache = tfm.prefill(cfg, params,
                                {"tokens": toks[:, :HYBRID_SPLIT]},
                                max_len=toks.shape[1])
        bad = {}
        for f in faults:
            c = pytree.tree_map(lambda t: t.clone() if hasattr(t, "clone")
                                else t, cache)
            c[f].zero_()
            bad[f] = walk(lg, c, HYBRID_FAULT_STEPS)
            del c
        return walk(lg, cache, toks.shape[1] - HYBRID_SPLIT), bad


def hybrid_f32_wave(dev, cfg32, p32, wave, max_len) -> dict:
    """One of the launcher's waves served in f32 compute (its parameters
    at f32) through the kernels, every step teacher-forced on the plain
    versions (:func:`hold_wave`) within rtol = atol =
    :data:`HYBRID_STATE_TOL`; then again with row 9's dims 104-111 zeroed
    (:func:`faulty_attention`), which that limit must refuse.  In bf16
    the two paths part by rounding over 81 layers (the launcher's waves
    are held by the margin rule alone); in f32 they may part only by f32
    rounding."""
    import torch
    from repro_torch.models import layers
    from repro_torch.serve.engine import ServeEngine
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    eng32 = ServeEngine(cfg32, p32, batch_size=len(wave), max_len=max_len,
                        device=dev)
    results, wall, rec, _ = serve_moe_wave(dev, eng32, wave, routed=False)
    out = dict(hold_wave(dev, eng32, wave, results, rec.logits,
                         tol=HYBRID_STATE_TOL), wall_s=wall)
    real = layers.flash_attention
    layers.flash_attention = faulty_attention("dims", sms)
    try:
        bad, _, rec, _ = serve_moe_wave(dev, eng32, wave, routed=False)
    finally:
        layers.flash_attention = real
    with refusals() as seen:
        v = hold_wave(dev, eng32, wave, bad, rec.logits,
                      tol=HYBRID_STATE_TOL)
    out["planted_dims_zeroed"] = dict(
        max_abs_logit_diff=v["max_abs_logit_diff"], tol_ratio=v["tol_ratio"],
        greedy_tokens_differing=v["greedy_tokens_differing"],
        refusals=len(seen), first_refusals=seen[:2])
    del out["differing"]
    log(f"  8e f32 wave vs the plain versions ({out['steps']} steps, "
        f"{len(wave)} requests): {json.dumps(out)}")
    check(v["tol_ratio"] > 1, f"zamba2 (f32): row 9's dims 104-111 zeroed "
          f"pass the f32 limit ({v['tol_ratio']} of it)")
    return out


def hybrid_state_check(dev, eng, toks, wave) -> dict:
    """The state across the prefill/decode boundary on ``toks`` [1, S]:
    in f32 compute (the launcher's seed-0 parameters at f32), every
    step's logits of :func:`hybrid_split` against one forward's at the
    same position and the last against one prefill's, within
    :data:`HYBRID_STATE_TOL`; the conv tails, then ``h``, zeroed at the
    boundary, read over :data:`HYBRID_FAULT_STEPS` steps against the same
    limit (they must be refused); ``wave`` served in f32 against the
    plain versions (:func:`hybrid_f32_wave`); bf16's drift read beside:
    one forward on the served parameters against the f32 one."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    cfg = eng.cfg
    S = toks.shape[1]
    start = HYBRID_SPLIT - 1
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = tfm.init_params(cfg, seed=0, device=dev)       # the launcher's
    check(torch.equal(p32["embed"].to(eng.params["embed"].dtype),
                      eng.params["embed"]), "zamba2: seed 0 did not give the "
          "launcher's parameters")
    full32 = hybrid_forward_logits(cfg32, p32, toks, start)
    with torch.inference_mode():
        last32, _ = tfm.prefill(cfg32, p32, {"tokens": toks}, max_len=S)
    split32, faults = hybrid_split(cfg32, p32, toks, ("conv", "h"))
    f32_wave = hybrid_f32_wave(dev, cfg32, p32, wave, eng.max_len)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    full16 = hybrid_forward_logits(cfg, eng.params, toks, start)
    torch.cuda.synchronize(dev)

    def ratio(a, b):           # of the rule rtol = atol = HYBRID_STATE_TOL
        return float(((a - b).abs() / (HYBRID_STATE_TOL * (1 + b.abs())))
                     .max())

    def dmax(a, b):
        return float((a - b).abs().max())
    by_step = [ratio(split32[:, i], full32[:, i])
               for i in range(split32.shape[1])]
    out = dict(prompt=S, split=HYBRID_SPLIT, decode_steps=S - HYBRID_SPLIT,
               chunks_prefilled=HYBRID_SPLIT // min(cfg.ssm_chunk, S),
               f32_tol=HYBRID_STATE_TOL, f32_tol_ratio=max(by_step),
               noise_floor_ratio=by_step[0],
               f32_max_abs_logit_diff=dmax(split32, full32),
               f32_tol_ratio_by_step_max_of_16=[
                   round(max(by_step[i:i + 16]), 4)
                   for i in range(0, len(by_step), 16)],
               f32_last_vs_prefill=ratio(split32[:, -1], last32.cpu()),
               f32_forward_vs_prefill=ratio(full32[:, -1], last32.cpu()),
               logit_scale=float(full32.abs().max()),
               same_argmax_f32=bool(torch.equal(split32.argmax(-1),
                                                full32.argmax(-1))),
               faults={f: dict(tol_ratio_by_step=[
                   round(ratio(x[:, i], full32[:, i]), 3)
                   for i in range(x.shape[1])]) for f, x in faults.items()},
               bf16_forward_vs_f32=dmax(full16, full32),
               bf16_forward_vs_f32_by_16=[
                   round(dmax(full16[:, i:i + 16], full32[:, i:i + 16]), 4)
                   for i in range(0, full32.shape[1], 16)],
               bf16_same_argmax_share=float(
                   (full16.argmax(-1) == full32.argmax(-1)).float().mean()),
               f32_wave=f32_wave, seconds=time.perf_counter() - t0)
    for f, r in out["faults"].items():
        r["refused"] = max(r["tol_ratio_by_step"]) > 1
    log(f"  8e state across the boundary: {json.dumps(out)}")
    check(all(bool(torch.isfinite(x).all()) for x in (split32, full16)),
          "zamba2: non-finite logits in the state check")
    check(out["f32_tol_ratio"] <= 1 and out["f32_last_vs_prefill"] <= 1,
          f"zamba2 (f32): prefill over {HYBRID_SPLIT} tokens and "
          f"{S - HYBRID_SPLIT} decode steps disagree with one forward over "
          f"{S} by {out['f32_tol_ratio']} of rtol = atol = "
          f"{HYBRID_STATE_TOL} (with one prefill: "
          f"{out['f32_last_vs_prefill']})")
    for f, r in out["faults"].items():
        check(r["refused"], f"zamba2: the {f} state zeroed at the boundary "
              f"passes the f32 limit ({r['tol_ratio_by_step']})")
    return out


def hybrid_long_wave(dev, eng) -> tuple[dict, object]:
    """The long wave (:data:`HYBRID_LONG`) through an engine with its
    cache on the launcher's parameters, each step recorded, then
    teacher-forced on the plain versions (:func:`hold_wave`); returns its
    stats and the wave's tokens [4, 4096] on the card."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine, pad_wave
    L = HYBRID_LONG
    rng = np.random.default_rng(13)
    reqs = [Request(uid=i, prompt=rng.integers(0, eng.cfg.vocab, (
        L["tokens"],)).astype(np.int32), max_new_tokens=L["new_tokens"])
        for i in range(L["prompts"])]
    long_eng = ServeEngine(eng.cfg, eng.params, batch_size=L["prompts"],
                           max_len=L["cache"], device=dev)
    rec = StepRecorder(tfm, dev)
    try:
        t0 = time.perf_counter()
        results = long_eng.run(reqs)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    check_tokens(results, L["new_tokens"], eng.cfg.vocab,
                 "zamba2 long-wave request")
    total = sum(len(r.tokens) for r in results)
    dec = rec.ms["decode"]
    tokens = L["prompts"] * L["tokens"]
    out = dict(**L, chunks=L["tokens"] // eng.cfg.ssm_chunk,
               tokens_served=total, wall_s=wall, tokens_per_s=total / wall,
               prefill_ms=rec.ms["prefill"][0],
               prefill_host_ms=rec.host_ms["prefill"][0],
               prefill_tokens_per_s=tokens / rec.ms["prefill"][0] * 1e3,
               decode_steps=len(dec), decode_ms_mean=float(np.mean(dec)),
               decode_host_ms_mean=float(np.mean(rec.host_ms["decode"])))
    wave = sorted(reqs, key=lambda r: len(r.prompt))
    out["vs_plain"] = hold_wave(dev, long_eng, wave, results, rec.logits)
    shown = {k: v for k, v in out.items() if k != "vs_plain"}
    log(f"  8e long wave: {json.dumps(shown)}; "
        f"vs the plain versions (teacher-forced, every step): max |diff| "
        f"{out['vs_plain']['max_abs_logit_diff']:.5g}, greedy tokens "
        f"differing {out['vs_plain']['greedy_tokens_differing']}")
    toks = torch.from_numpy(pad_wave(wave)).to(dev)
    del long_eng, rec
    return out, toks


def hybrid_prefill_trace(dev, eng, toks) -> dict:
    """The long wave's prefill (``toks`` [4, 4096]) once under
    torch.profiler: wall, device busy time, idle share, device ms by
    kernel name; then one Mamba2 layer's block and its SSD scan alone at
    the same shapes (layer 0's parameters): ms a call by CUDA events,
    device ms (the profiler's, all kernels) and the host's enqueue ms, and
    the scan's share of the prefill as 81 layers' calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    cfg = eng.cfg
    with torch.inference_mode():
        torch.cuda.synchronize(dev)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tfm.prefill(cfg, eng.params, {"tokens": toks},
                        max_len=toks.shape[1])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        busy_us, per = device_busy_us(prof)
        del prof
        gen = torch.Generator(device=dev).manual_seed(31)
        x = torch.randn((*toks.shape, cfg.d_model), generator=gen,
                        device=dev).to(eng.params["embed"].dtype)
        lp = tfm.layer(eng.params, 0)["mamba"]
        d_in, H, N, _ = ssm.mamba2_dims(cfg)
        B, S = toks.shape
        xdt = torch.randn((B, S, H, cfg.ssm_head_dim), generator=gen,
                          device=dev)
        bc = torch.randn((2, B, S, N), generator=gen, device=dev)
        loga = -torch.rand((B, S, H), generator=gen, device=dev)
        Q = min(cfg.ssm_chunk, S)
        fns = {"block": lambda: ssm.mamba2_block(cfg, lp, x),
               "scan": lambda: ssm._ssd_scan(xdt, bc[0], bc[1], loga, Q)}
        alone = {}
        for k, fn in fns.items():
            ms = cuda_ms(fn, 3)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize(dev)
            alone[k] = dict(ms=ms, device_ms=profiled_ms(fn, 2),
                            host_enqueue_ms=host)
        del x, xdt, bc, loga
    torch.cuda.empty_cache()
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    L = cfg.n_layers
    out = dict(shape=f"B={B}, S={S}, chunks of {Q}", wall_ms=wall * 1e3,
               device_busy_ms=busy_us / 1e3,
               idle_share=(1 - busy_us / 1e6 / wall) if busy_us else None,
               device_ms_by_name={k[:80]: v / 1e3 for k, v in top},
               one_layer=alone,
               scan_share_of_prefill_wall=L * alone["scan"]["ms"]
               / (wall * 1e3),
               scan_share_of_prefill_device=L * alone["scan"]["device_ms"]
               / (busy_us / 1e3) if busy_us else None,
               block_share_of_prefill_wall=L * alone["block"]["ms"]
               / (wall * 1e3))
    log(f"  8e traced long-wave prefill and the SSD scan: {json.dumps(out)}")
    return out


def hybrid_attention(dev, cfg) -> dict:
    """Row 9 at zamba2's heads (32/32, hd 112) at the launcher's wave and
    at 4 x 4096 (:data:`FAMILY_ATTN_SHAPES`), bf16 and f32, against its
    plain version, timed beside SDPA and the bound; rows 12-13 at 1 x
    4096, causal, bf16 and f32, against the plain backward, two calls
    byte-equal, timed beside SDPA's backward and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    check(hd == 112 and hd in fa.BWD_HEAD_DIMS, f"zamba2's head dim {hd}")
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {"forward": {}, "backward": {}}

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    for dtn in ("bfloat16", "float32"):
        dt, tol = getattr(torch, dtn), LM_TOL[dtn]["flash_attention"]
        for key, (B, S, max_len) in FAMILY_ATTN_SHAPES.items():
            q = rnd((B, S, H, hd), dt)
            k, v = rnd((B, max_len, Hkv, hd), dt), rnd((B, max_len, Hkv, hd),
                                                       dt)
            c = dict(B=B, Sq=S, Skv=max_len, causal=True, q_offset=0,
                     kv_len=S)
            kw = dict(causal=True, q_offset=0, kv_len=S)
            run_k = lambda: fa.flash_attention_cuda(q, k, v, **kw)  # noqa
            run_p = lambda: fa.attention(q, k, v, **kw)             # noqa
            got, want = run_k(), run_p()
            r = fa.error_ratio(got, want, tol)
            check(r <= 1, f"8e row 9 {dtn} {key}: {r} of "
                  f"{ATTN_RULE.format(tol)}")
            shape = (f"B={B}, Sq={S}, Skv={max_len}, H={H}/{Hkv}, hd={hd}, "
                     f"kv_len={S}, {dtn}")
            t = time_lm(run_k, run_p, sdpa_call(q, k, v, c), 3,
                        "flash_attention", attention_bound(q, k, c), shape)
            out["forward"][f"{key} {dtn}"] = dict(
                **t, max_abs_err=float((got.float() - want.float()).abs()
                                       .max()), tol_ratio=r,
                variant=fa.variant_of(q, k))
            log(f"  8e row 9 at zamba2's {key} prefill ({shape}): "
                f"{t['ms']:.4f} ms ({t['ms_from']}), SDPA "
                f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); {r:.3f} of "
                "the tolerance")
            del q, k, v, got, want
        B, S = 1, 4096
        q, do = rnd((B, S, H, hd), dt), rnd((B, S, H, hd), dt)
        k, v = rnd((B, S, Hkv, hd), dt), rnd((B, S, Hkv, hd), dt)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
        run_k = lambda: fa.flash_attention_backward_cuda(  # noqa: E731
            q, k, v, o, lse, do, causal=True)
        got, again = run_k(), run_k()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"8e rows 12-13 {dtn}: two backward calls differ")
        want = fa.attention_backward(q, k, v, o, lse, do, causal=True)
        ratios = [fa.grad_error_ratio(g, w, tol) for g, w in zip(got, want)]
        check(max(ratios) <= 1, f"8e rows 12-13 {dtn}: dq/dk/dv {ratios} of "
              "the tolerance")
        es = q.element_size()

        def sdpa_backward():
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True)
            return lambda: torch.autograd.grad(o_lib, (qt, kt, vt),
                                               do.transpose(1, 2),
                                               retain_graph=True)
        both = attn_bwd_bound(B, S, H, Hkv, hd, es, 5)
        # SDPA's f32 backward may run on TF32 tensor cores, below the f32
        # bound: timed in bf16 only, as phase 8b (d) times it
        lib_ms, lib_from = library_ms(sdpa_backward, 5, both) \
            if dtn == "bfloat16" else (None, "not timed in f32")
        # CUDA events around lone launches: a profiler window that lost
        # one of three dK/dV records read 0.4526 ms against 0.9608 on the
        # card (PERF.md, §6)
        alone = attn_bwd_alone(q, k, v, o, lse, do, True)
        plain_ms = cuda_ms(lambda: fa.attention_backward(
            q, k, v, o, lse, do, causal=True), 2, warmup=1)
        shape = f"B={B}, S={S}, H={H}/{Hkv}, hd={hd}, causal, {dtn}"
        for row, products in (("attention_bwd_dkdv", 4),
                              ("attention_bwd_dq", 3)):
            ms = cuda_ms(alone[row.split("_")[-1]], 5)
            out["backward"][f"{row} {dtn}"] = dict(
                ms=ms, ms_from="cuda events around launches of the kernel "
                "alone", plain_ms=plain_ms,
                plain_of="attention_backward (both)", library_ms=lib_ms,
                library_from=lib_from, library_of="the backward of "
                "F.scaled_dot_product_attention (dq, dk, dv together)",
                tol_ratio=max(ratios), max_abs_err=max(
                    float((g.float() - w.float()).abs().max())
                    for g, w in zip(got, want)),
                shape=shape, **attn_bwd_bound(B, S, H, Hkv, hd, es,
                                              products))
        kv_ms = out["backward"][f"attention_bwd_dkdv {dtn}"]["ms"]
        q_ms = out["backward"][f"attention_bwd_dq {dtn}"]["ms"]
        log(f"  8e rows 12-13 at zamba2's heads ({shape}): dq/dk/dv "
            f"{[round(x, 3) for x in ratios]} of the tolerance, byte-equal "
            f"twice; dkdv {kv_ms:.4f} ms, dq {q_ms:.4f} ms, SDPA backward "
            f"{lib_ms} ms, plain {plain_ms:.2f} ms, "
            f"bound {both['bound_ms']:.4f} ms (5 products)")
        del q, k, v, do, o, lse, got, again, want, alone
        torch.cuda.empty_cache()
    return out


def hybrid_norms(dev, cfg) -> dict:
    """Row 10 at zamba2's widths, d 3584 and 7168, against its plain
    version (every variant that takes them, rows 4, 128 and 16384, f32
    and bf16), and row 14 (the backward) at [4096, d], bf16 and f32:
    against the plain version, two calls byte-equal, the variant named
    (bf16 7168: ``rows``, 896 vectors; f32 7168: ``generic``)."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    d_model, d_in = cfg.d_model, 2 * cfg.d_model
    fwd = phase_norm_variants(dev, rows_list=HYBRID_NORM_ROWS,
                              ds=(d_model, d_in))
    gen = torch.Generator(device=dev).manual_seed(29)
    bwd = []
    for dtn in ("bfloat16", "float32"):
        dt, tol = getattr(torch, dtn), LM_TOL[dtn]["rmsnorm"]
        for d in (d_model, d_in):
            x = (3 * torch.randn((4096, d), generator=gen, device=dev)).to(dt)
            dy = torch.randn((4096, d), generator=gen, device=dev).to(dt)
            w = 1 + 0.3 * torch.randn((d,), generator=gen, device=dev)
            dx, dw = rn.rmsnorm_backward_cuda(x, w, dy)
            variant = rn.rmsnorm_backward_cuda.last_plan.variant
            again = rn.rmsnorm_backward_cuda(x, w, dy)
            check(torch.equal(dx, again[0]) and torch.equal(dw, again[1]),
                  f"8e rmsnorm backward {dtn} d {d}: two calls differ")
            pdx, pdw = rn.rmsnorm_backward(x, w, dy, model=True)
            rx = float(((dx.float() - pdx.float()).abs()
                        / (tol * (1 + pdx.float().abs()))).max())
            rw = float(((dw - pdw).abs()
                        / (NORM_DW_TOL[dtn] * (1 + pdw.abs()))).max())
            check(max(rx, rw) <= 1, f"8e rmsnorm backward {dtn} [4096, {d}]"
                  f" ({variant}): dx {rx}, dw {rw} of the tolerance")
            bwd.append(dict(dtype=dtn, d=d, rows=4096, variant=variant,
                            dx_tol_ratio=rx, dw_tol_ratio=rw))
            del x, dy, dx, dw, again, pdx, pdw
    check([r["variant"] for r in bwd] == ["rows", "rows", "rows", "generic"],
          f"8e rmsnorm backward variants {[r['variant'] for r in bwd]}")
    log(f"  8e row 14 at zamba2's widths: {json.dumps(bwd)}")
    torch.cuda.empty_cache()
    return dict(forward=fwd, backward=bwd)


def hybrid_train(dev, cfg) -> dict:
    """``train.loop.make_train_step`` (the loop's step) at full width and
    :data:`HYBRID_TRAIN_LAYERS` layers (f32 parameters, bf16 compute,
    remat) for :data:`HYBRID_TRAIN`'s steps from ``SyntheticLM(seed=0)``:
    every loss finite and the last 4 below the first 4 on average; then
    the run again, stopped after :data:`HYBRID_RESUME_AT` steps, its state
    taken to the host as a checkpoint stores it, dropped, restored onto
    the card and resumed: every leaf and loss byte-equal to the straight
    run's (a checkpoint of this state on disk would be 16.5 GB; the loop's
    disk round trip is phase 8b (e)'s, at reduced width)."""
    import dataclasses
    import torch
    from repro_torch import pytree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import loop as train_loop
    B, S, n = HYBRID_TRAIN
    c12 = dataclasses.replace(cfg, n_layers=HYBRID_TRAIN_LAYERS)
    check(c12.remat and c12.param_dtype == "float32" and
          c12.compute_dtype == "bfloat16", "zamba2: not f32 parameters, bf16 "
          "compute, remat")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    n0 = launch_counts()
    step = train_loop.make_train_step(
        c12, adamw.OptConfig(lr=FAMILY_LR, warmup_steps=2, total_steps=n))
    src = SyntheticLM(vocab=c12.vocab, seq_len=S, global_batch=B, seed=0)
    with NormWidths() as widths:
        state, rec = train_steps(dev, step, train_loop.init_state(
            c12, seed=0, device=dev), src, n)
    steady = rec["ms"][1:]
    rec.update(n_layers=c12.n_layers, sites=c12.n_layers // c12.attn_every,
               n_params=sum(x.numel() for x in pytree.leaves(state[0])),
               batch=B, seq=S, steps=n, first_step_ms=rec["ms"][0],
               ms_per_step=float(np.median(steady)),
               tokens_per_s=B * S / float(np.median(steady)) * 1e3,
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               norm_calls_by_width=widths.by,
               launches=count_delta(n0, launch_counts(), MOE_LAUNCH_KEYS))
    t0 = time.perf_counter()
    part, first = train_steps(dev, step, train_loop.init_state(
        c12, seed=0, device=dev), src, HYBRID_RESUME_AT)
    leaves, treedef = pytree.flatten(part)
    snap = [ckpt._to_numpy(x) for x in leaves]   # as a checkpoint stores them
    del part, leaves
    gc.collect()
    resumed = pytree.unflatten(treedef, [ckpt._from_numpy(a, name).to(dev)
                                         for a, name in snap])
    del snap
    rest = []
    for i in range(HYBRID_RESUME_AT, n):
        resumed, m = step(resumed, src.batch_for_step(i))
        rest.append(float(m["loss"]))
    pairs = list(zip(pytree.leaves(resumed), pytree.leaves(state)))
    same, n_leaves = sum(torch.equal(a, b) for a, b in pairs), len(pairs)
    rec.update(resume=dict(at=HYBRID_RESUME_AT, leaves=n_leaves,
                           leaves_equal=same,
                           losses=first["losses"] + rest,
                           seconds=time.perf_counter() - t0))
    del state, resumed, step, pairs
    gc.collect()
    torch.cuda.empty_cache()
    losses = rec["losses"]
    first4, last4 = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    rec.update(mean_first_4=first4, mean_last_4=last4)
    log(f"  8e training, zamba2 at {c12.n_layers} layers ({rec['sites']} "
        f"sites, {rec['n_params']} parameters), batch {B} x seq {S}, {n} "
        f"steps: {rec['ms_per_step']:.1f} ms/step (median after the first; "
        f"first {rec['first_step_ms']:.0f} ms), {rec['tokens_per_s']:.0f} "
        f"tokens/s, peak memory {rec['peak_memory_bytes']} B; losses "
        f"{[round(x, 4) for x in losses]}; resumed after "
        f"{HYBRID_RESUME_AT}: {same} of {n_leaves} leaves byte-equal, "
        f"losses {[round(x, 4) for x in rec['resume']['losses']]}")
    check(all(np.isfinite(losses)), f"8e zamba2: a training loss is not "
          f"finite: {losses}")
    check(last4 < first4, f"8e zamba2: the loss did not fall ({first4} -> "
          f"{last4})")
    check(same == n_leaves and rec["resume"]["losses"] == losses,
          f"8e zamba2: the resumed run differs ({same} of {n_leaves} "
          "leaves equal)")
    return rec


def hybrid_serve(dev, cfg) -> tuple[dict, object, list]:
    """zamba2-7b at full width and depth through ``launch.serve --full``
    (:func:`serve_family`, each wave held against the plain versions),
    with row 10's calls counted by width."""
    with NormWidths() as widths:
        st, eng, reqs = serve_family(dev, cfg, tag="8e")
    st["norm_calls_by_width"] = widths.by
    check(st["n_params"] == 6_751_130_832, f"zamba2: {st['n_params']} "
          "parameters, want the JAX init's 6,751,130,832")
    check(st["peak_memory_bytes"] < CARD_BYTES, f"zamba2: peak memory "
          f"{st['peak_memory_bytes']} B")
    return st, eng, reqs


def phase_hybrid(dev) -> dict:
    """Phase 8e: zamba2-7b (81 Mamba2 layers, the shared attention layer
    at 13 sites, hd 112) served at full width and depth (the launcher's
    run, then the long wave, each held against the plain versions),
    trained at full width and 12 layers (the loss falls, a resume is
    byte-equal); the launches of the main path (the counts set to 0 by the
    caller just before) read after them, less those of the checks between
    them: the state across the prefill/decode boundary and the longest
    wave against the plain versions, both in f32 with planted faults
    (bf16's drift read beside), one traced decode step and one traced
    long-wave prefill with the SSD scan timed alone.  Then row 10 at d
    3584 and 7168, rows 9, 12 and 13 at zamba2's heads (row 9 also at the
    served caches' shapes) and the training's gradients against the plain
    path at 1 x 4096 and :data:`HYBRID_GRAD_LAYERS` layers, with dQ's
    dims 104-111 zeroed refused."""
    import torch
    from repro_torch.configs.base import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False    # as phase 7 sets it
    t0 = time.perf_counter()
    cfg = get_arch(HYBRID_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    check(left < FAMILY_LEFT_BYTES, f"8e: {left} B still allocated when it "
          "starts")
    out = {"allocated_at_start_bytes": left}
    out["serve"], eng, reqs = hybrid_serve(dev, cfg)
    t1 = time.perf_counter()
    with NormWidths() as widths:
        out["long_wave"], toks4 = hybrid_long_wave(dev, eng)
    toks = toks4[:1]
    out["long_wave"]["norm_calls_by_width"] = widths.by
    out["long_wave"]["seconds"] = time.perf_counter() - t1
    out["long_wave"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
        dev)
    n_t = launch_counts()
    out["serve"]["decode_trace"] = trace_decode(      # the longest wave
        dev, eng, sorted(reqs, key=lambda r: len(r.prompt))[-eng.batch_size:],
        want=("flash_attention",))
    out["state_check"] = hybrid_state_check(      # and the longest wave
        dev, eng, toks, sorted(reqs, key=lambda r: len(r.prompt))[
            -eng.batch_size:])
    out["long_wave"]["prefill_trace"] = hybrid_prefill_trace(dev, eng, toks4)
    state_launches = count_delta(n_t, launch_counts(), MOE_LAUNCH_KEYS)
    del eng, reqs, toks, toks4
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = hybrid_train(dev, cfg)
    launches = count_delta(state_launches, {
        k: v for k, v in launch_counts().items() if k in MOE_LAUNCH_KEYS},
        MOE_LAUNCH_KEYS)
    out["launches"] = launches
    out["main_path_s"] = time.perf_counter() - t0
    log(f"  main-path launches (phase 8e; the traced decode and the state "
        f"check taken out): {json.dumps(launches)}")
    by = launches["flash_attention_by"]
    for k in MAIN_ATTENTION_VARIANTS:
        check(by[k] > 0, f"8e: attention variant {k} was never launched")
    check(launches["rmsnorm_by"]["split"] > 0, "8e: rmsnorm's split variant "
          "was never launched")
    by = launches["attention_bwd_by"]
    check(by["dq_mma"] == by["dkdv_mma"] > 0 and by["dq_f32"] ==
          by["dkdv_f32"] == 0, f"8e training launched the backward kernels "
          f"{json.dumps(by)}, want only dq_mma and dkdv_mma")
    check(launches["rmsnorm_bwd"] > 0, "8e: row 14 was never launched")
    out["norms"] = hybrid_norms(dev, cfg)
    out["attention"] = hybrid_attention(dev, cfg)
    out["attention_served"] = served_attention_holds(dev, cfg, "8e")
    out["train"]["vs_plain"] = phase_train_vs_plain(
        dev, cfg, tag="8e zamba2", n_layers=HYBRID_GRAD_LAYERS,
        planted=dq_dims_zeroed)
    out["seconds"] = time.perf_counter() - t0
    return out


def train_rows(errs, times, launches) -> list:
    """The ``kernels`` line's rows 12-14: launches from phase 8b's main
    path ((a), (b), (e)), errors from (d) (bf16, the training dtype, and
    f32), times at (b)'s shape."""
    rows = []
    for k, (replaces, diff, source, _) in TRAIN_ROWS.items():
        b16, f32 = errs["bfloat16"][k], errs["float32"][k]
        attn = k.startswith("attention")
        rule = ("rtol = tolerance, atol = tolerance x min(1, the gradient's "
                "RMS)" if attn else "dx: allclose, rtol = atol = tolerance; "
                "dw: allclose, rtol = atol = tolerance in bf16, "
                f"{NORM_DW_TOL['float32']:g} in f32")
        name = "flash_attention" if attn else "rmsnorm"
        rows.append(dict(
            name=k, route="cuda", source=source, replaces=replaces,
            pallas="none: the JAX package differentiates its jnp "
            f"{name} with autodiff", differentiates=diff,
            launches=launches[k], max_abs_err=b16["max_abs_err"],
            tolerance=LM_TOL["bfloat16"][name], tolerance_rule=rule,
            tol_ratio=b16["tol_ratio"], max_abs_err_f32=f32["max_abs_err"],
            tolerance_f32=LM_TOL["float32"][name],
            tol_ratio_f32=f32["tol_ratio"],
            launches_by=launches["rmsnorm_bwd_by"] if not attn else {
                v: n for v, n in launches["attention_bwd_by"].items()
                if v.startswith(k.split("_")[-1] + "_")},
            **times[k]))
    return rows


def attention_variants(errs, times, launches) -> list:
    """Row 9's variants: main-path launches (phase 8), largest errors
    against the plain versions (phase 7, the variant's own dtype: bf16
    for the main path's kernels, f32 for the CUDA-core kernel) and times
    at the long wave's shapes."""
    pre_b, pre_f = (times[f"flash_attention prefill {d}"]
                    for d in ("bfloat16", "float32"))
    dec = times["flash_attention decode bfloat16"]
    rows = []
    for name, dtn, t, lib in (
            ("prefill_mma", "bfloat16", pre_b, pre_b["library_ms"]),
            ("tiled_f32", "float32", pre_f, pre_f["library_ms"]),
            ("decode_split", "bfloat16", dec["split"], None),
            ("decode_combine", "bfloat16", dec["combine"], None)):
        e = errs[dtn][name]
        rows.append(dict(
            name=name, dtype=dtn, launches=launches["flash_attention_by"][
                name], max_abs_err=e["max_abs_err"], tol_ratio=e["tol_ratio"],
            tolerance=LM_TOL[dtn]["flash_attention"],
            tolerance_rule=ATTN_RULE.format("tolerance") + (
                "; partials: allclose, rtol = atol = "
                f"{LM_TOL['float32']['flash_attention']:g}"
                if name == "decode_split" else ""), library_ms=lib,
            **{f: t[f] for f in ("ms", "ms_from", "call_ms", "plain_ms",
                                 "bound_ms", "bound_by")}))
    return rows


def lm_rows(errs, times, launches, norm_variants) -> list:
    """The ``kernels`` line's rows 9-10: launches from phase 8, errors
    from phase 7 (bf16, the main path's dtype, and f32), times at the
    long wave's prefill (attention; its decode step beside, and each
    attention variant) and at its [B*S, 2048] RMSNorm (its decode step's
    [4, 2048] beside, and each RMSNorm variant's errors from phase 3), in
    bf16."""
    fields = ("ms", "ms_from", "call_ms", "plain_ms", "plain_device_ms",
              "bound_ms", "bound_by", "library_ms", "library_from", "shape")
    rows = []
    for k, (replaces, pallas, source) in LM_ROWS.items():
        main_t = times[f"{k} prefill bfloat16" if k == "flash_attention"
                       else f"{k} bfloat16"]
        b16, f32 = errs["bfloat16"][k], errs["float32"][k]
        row = dict(name=k, route="cuda", source=source, replaces=replaces,
                   pallas=pallas, launches=launches[k],
                   max_abs_err=b16["max_abs_err"],
                   tolerance=LM_TOL["bfloat16"][k],
                   tolerance_rule=ATTN_RULE.format("tolerance")
                   if k == "flash_attention" else
                   "allclose, rtol = atol = tolerance",
                   tol_ratio=b16["tol_ratio"],
                   max_abs_err_f32=f32["max_abs_err"],
                   tolerance_f32=LM_TOL["float32"][k],
                   tol_ratio_f32=f32["tol_ratio"],
                   **{f: main_t[f] for f in fields})
        row.update({f: main_t[f] for f in (
            "warm_ms", "warm_ms_from", "warm_library_ms",
            "warm_library_from") if f in main_t})
        if k == "flash_attention":
            dec = times["flash_attention decode bfloat16"]
            row.update({f"decode_{f}": dec[f] for f in fields})
            row["variants"] = attention_variants(errs, times, launches)
        else:
            row.update({f"decode_{f}": v for f, v in
                        main_t["decode"].items()})
            row.update(launches_by=launches["rmsnorm_by"],
                       variant=main_t["variant"], variants=norm_variants,
                       variants_cold_ms=main_t["variants_cold_ms"])
        rows.append(row)
    return rows


def sched_run_extras(t, launches, cases) -> dict:
    """Row 7's extra fields: main-path launches by variant, the variant,
    warps a stream and window at full width, microseconds per cycle, each
    variant's time on the same inputs, the latency floor, the phase-4
    shape's times, and the cases phase 3 held per variant."""
    p4 = t["phase4"]
    return dict(launches_by=launches["sched_run_by"], variant=t["variant"],
                warps=t["warps"], window=t["window"], streams=t["streams"],
                us_per_cycle=t["us_per_cycle"], by_variant=t["by_variant"],
                cta_ms=t["by_variant"]["cta_ms"],
                floor_ms=t["floor"]["ms"],
                floor_us_per_cycle=t["floor"]["us_per_cycle"],
                phase4_shape=f"dot_prod B={p4['B']}, L={p4['L']}, "
                             f"{p4['cycles']} cycles",
                phase4_variant=p4["variant"], phase4_warps=p4["warps"],
                phase4_window=p4["window"],
                phase4_floor_ms=p4["floor"]["ms"],
                phase4_ms=p4["wrapper_ms"],
                phase4_call_ms=p4["wrapper_call_ms"],
                phase4_cta_ms=p4["cta_ms"],
                phase4_by_variant={k: v for k, v in p4.items()
                                   if k.endswith("_ms")},
                cases_held=cases)


def slot_step_extras(t, launches, cases) -> dict:
    """Row 8's extra fields: main-path launches by variant, the variant
    and plan at the scheduled serving state, microseconds per cycle, each
    variant's time and time per call on the same state, the floor (the
    first active slot alone on one warp), the patterns in the registry,
    and the cases phase 3 held per variant."""
    return dict(launches_by=launches["sched_slot_step_by"],
                variant=t["variant"], streams=t["streams"],
                us_per_cycle=t["ms"] * 1e3 / t["K"],
                by_variant=t["by_variant"], cta_ms=t["by_variant"]["cta_ms"],
                cta_call_ms=t["by_variant"]["cta_call_ms"],
                floor_ms=t["floor_ms"], floor_slot=t["floor_slot"],
                floor_cycles_run=t["floor_cycles_run"],
                patterns=t["patterns"], cases_held=cases)


def fire_step_extras(t, launches) -> dict:
    """Row 6's extra fields: main-path launches by variant (phase 4's
    ``run_fabric``), the variant, each variant's time and time per call,
    and the floor: an empty one-warp kernel launched and timed the same
    way."""
    return dict(launches_by=launches["fire_step_by"], variant=t["variant"],
                warp_ms=t["warp_ms"], warp_call_ms=t["warp_call_ms"],
                cta_ms=t["cta_ms"], cta_call_ms=t["cta_call_ms"],
                floor_ms=t["floor_ms"], floor_call_ms=t["floor_call_ms"],
                floor_of="an empty one-warp kernel")


def fire_block_extras(row, times, floor, launches) -> dict:
    """Rows 1-5's extra fields: main-path launches by variant of the
    row's entry (row 5: both entries), the timed variant and its
    microseconds per cycle, the latency floor at the row's K, and the
    CTA variant's time on the same state (rows 1 and 3)."""
    by = launches["fire_block_by"]
    if row == "fire_block_spec":
        launches_by = {v: sum(b[v] for b in by.values())
                       for v in by["fire_block"]}
    else:
        launches_by = by["fire_block_batched" if "batched" in row
                         else "fire_block"]
    t = times[row]
    out = dict(launches_by=launches_by, variant=t["variant"],
               us_per_cycle=t["us_per_cycle"], K=t["K"],
               floor_ms=floor["ms"][t["K"]],
               floor_us_per_cycle=floor["us_per_cycle"])
    cta = times.get(f"{row} cta")
    if cta is not None:
        out.update(cta_ms=cta["ms"], cta_call_ms=cta["call_ms"],
                   cta_us_per_cycle=cta["us_per_cycle"])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_arch
    from repro_torch.core import library
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("== phase 1: device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    log("== phase 2: build")
    lib = _build.load()
    log(f"  nvcc built {', '.join(f.name for f in _build.SOURCES)} into "
        f"one library in {lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line \
                or "Function properties" in line or "Compiling" in line:
            log("  " + line.strip())

    dot = library.dot_product_graph(32)
    dot_reqs, dot_lens = serving_workload("dot_prod", dot, 2048, seed=0)
    bub = library.bubble_sort_graph(8)
    bub_reqs, bub_lens = serving_workload("bubble_sort", bub, 256, seed=1)

    log("== phase 3: kernels vs plain on the card")
    errs = phase_kernel(dev)
    sched_cases = hold_sched_variants(dev, errs)
    slot_cases = hold_slot_variants(dev, errs)
    norm_variants = phase_norm_variants(dev)
    times, by_variant = phase_serving_states(dev, dot, dot_reqs, bub,
                                             bub_reqs, errs)
    floor = latency_floor(dev)
    sched_times, versus = phase_sched_states(dev, dot, dot_reqs, errs)
    times.update(sched_times)
    log(f"  phase 3 done at {time.perf_counter() - t_start:.1f} s")

    log("== phase 4: engine (main path: counts from here on)")
    reset_counts()
    phase_engine(dev)
    phase_engine_sched(dev)
    phase_passes(dev)
    table1 = phase_run_fabric(dev)
    log(f"  phase 4 done at {time.perf_counter() - t_start:.1f} s")

    log("== phase 4b: compile() and the torch backend (counts go on)")
    compiled = phase_compile(dev)
    log(f"  phase 4b done at {time.perf_counter() - t_start:.1f} s "
        f"({compiled['seconds']:.1f} s)")

    log("== phase 5: serving")
    deployments = (
        ("dot_prod", "dot_prod", dot, 1024, dot_reqs, dot_lens, False, False,
         False),
        ("dot_prod_opt_prof", "dot_prod", dot, 1024, dot_reqs, dot_lens,
         True, True, False),
        ("dot_prod_sched", "dot_prod", dot, 1024, dot_reqs, dot_lens, True,
         True, True),
        ("bubble_sort", "bubble_sort", bub, 256, bub_reqs, bub_lens, False,
         False, False))
    serve, served = {}, {}
    for key, name, bench, slots, reqs, lens, opt, prof, sch in deployments:
        serve[key], *served[key] = phase_serving(dev, name, bench, slots,
                                                 reqs, lens, opt, prof, sch)
    log("== phase 5b: hardened serving (counts go on)")
    hardened, hardened_runs = phase_hardened(dev, dot, dot_reqs,
                                             served["dot_prod_opt_prof"][0])
    log(f"  phase 5b's serving runs done at "
        f"{time.perf_counter() - t_start:.1f} s "
        f"({hardened['seconds']:.1f} s)")
    log("== phase 5c: traced programs (counts go on)")
    traced, traced_runs = phase_traced(dev, served, serve)
    log(f"  phase 5c's runs done at {time.perf_counter() - t_start:.1f} s "
        f"({traced['seconds']:.1f} s)")
    log("== phase 5d: sharded serving (counts go on)")
    sharded, sharded_caps = phase_sharded(dev, dot, dot_reqs, dot_lens,
                                          served, serve)
    log(f"  phase 5d's runs done at {time.perf_counter() - t_start:.1f} s "
        f"({sharded['seconds']:.1f} s)")
    launches = launch_counts()
    log(f"  main-path launches (phases 4-5c): "
        f"{json.dumps({k: launches[k] for k in ROWS})}; fire block by "
        f"variant {json.dumps(launches['fire_block_by'])}")
    for k in ROWS:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    mf_launches = launches["mf_block"] + launches["mf_block_prof"]
    log(f"  mf_block launches (phase 5d): {launches['mf_block']} unprofiled,"
        f" {launches['mf_block_prof']} profiled")
    for k in ("mf_block", "mf_block_prof"):
        check(launches[k] > 0, f"{k} was never launched on the main path")
    check(launches["mf_block_by"]["warp"] == mf_launches, "mf_block: a "
          "sharded block of phase 5d did not run the warp variant")
    check(mf_launches == sum(v["launches"] for k, v in sharded.items()
                             if k.startswith("P")),
          "a sharded block was not one mf_block launch")
    check(launches["sched_run_by"]["warp"] > 0, "sched_run: the warp "
          "variant never ran on the main path")
    check(launches["sched_slot_step_by"]["warp"] > 0, "sched_slot_step: the "
          "warp variant never ran on the main path")
    check(launches["fire_step_by"]["warp"] > 0, "fire_step: the warp "
          "variant never ran on the main path")
    for k, by in launches["fire_block_by"].items():
        check(by["warp"] > 0, f"{k}: the warp variant never ran on the "
              "main path")
    same_as_dynamic(served["dot_prod_sched"][0],
                    served["dot_prod_opt_prof"][0], serve["dot_prod_sched"],
                    serve["dot_prod_opt_prof"])
    for key, name, bench, slots, reqs, lens, opt, prof, sch in deployments:
        check_sampled(dev, bench, reqs, *served[key], optimize=opt,
                      profile=prof, schedule=sch)
    check_phase_hardened(dev, dot, hardened, hardened_runs,
                         served["dot_prod_opt_prof"][0],
                         served["dot_prod_opt_prof"][2])
    log(f"  phase 5b's checks took {hardened['check_seconds']:.1f} s")
    check_phase_traced(dev, traced, traced_runs)
    log(f"  phase 5c's checks took {traced['check_seconds']:.1f} s")
    mf_row = check_phase_sharded(dev, sharded, sharded_caps)
    for k in ("fire_block_batched", "fire_block_batched_prof"):
        log(f"  beside {k} (row {list(ROWS).index(k) + 1}): "
            f"{times[k]['us_per_cycle']:.3f} µs/cycle")
    log(f"  phase 5d's checks took {sharded['check_seconds']:.1f} s")
    del served, bub_reqs, hardened_runs, traced_runs, sharded_caps
    log(f"  phase 5 done at {time.perf_counter() - t_start:.1f} s")

    log("== phase 6: traces of the optimized, profiled dot_prod serving runs")
    for key, sch in (("dot_prod_opt_prof", False), ("dot_prod_sched", True)):
        serve[key]["trace"] = trace_serving(
            dev, dot, 1024, dot_reqs, serve[key]["wall_s"], optimize=True,
            profile=True, schedule=sch)
    del dot_reqs
    log(f"  phase 6 done at {time.perf_counter() - t_start:.1f} s")

    log("== phase 7: LM kernels vs plain on the card")
    t_lm = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 products in f32
    cfg = get_arch(LM_ARCH)
    long_lens = np.random.default_rng(5).integers(2048, 4097, 4)
    lm_errs, lm_times = phase_lm_kernels(dev, cfg, len(long_lens),
                                         int(long_lens.max()), 4160)
    log(f"  phase 7 done at {time.perf_counter() - t_start:.1f} s")

    log("== phase 8: LM serving at full width (main path: counts from here "
        "on)")
    reset_counts()
    lm_stats, eng, lm_reqs, lm_res, rec = phase_lm_serving(
        dev, cfg, long_lens, 4160, 32, ["--arch", LM_ARCH, "--full"])
    lm_launches = launch_counts()
    lm_stats["launches"] = {k: lm_launches[k]
                            for k in (*LM_ROWS, "flash_attention_by",
                                      "rmsnorm_by")}
    log(f"  main-path launches (phase 8): {json.dumps(lm_stats['launches'])}")
    for k in LM_ROWS:
        check(lm_launches[k] > 0, f"{k} was never launched on the main path")
    check(lm_launches["rmsnorm_by"]["split"] > 0, "rmsnorm: the split "
          "variant (decode steps and 4 KB rows) never ran on the main path")
    for k in MAIN_ATTENTION_VARIANTS:
        check(lm_launches["flash_attention_by"][k] > 0,
              f"attention variant {k} was never launched on the main path")
    lm_stats["vs_plain"] = check_long_wave(dev, eng, lm_reqs, lm_res, rec)
    lm_stats["decode_trace"] = trace_decode(dev, eng, lm_reqs)
    lm_stats["out_of_vocab"] = serve_out_of_vocab(dev, eng)
    del eng, rec, lm_res
    torch.cuda.empty_cache()
    lm_stats["phases_s"] = time.perf_counter() - t_lm
    log(f"  phase 8 done at {time.perf_counter() - t_start:.1f} s (LM phases "
        f"{lm_stats['phases_s']:.1f} s)")

    log("== phase 8b: LM training (main path: counts from here on)")
    t_train = time.perf_counter()
    reset_counts()
    train = phase_train(dev, cfg)
    train["e"] = phase_train_loop(dev, cfg)
    train_launches = launch_counts()
    train["launches"] = {k: train_launches[k] for k in TRAIN_LAUNCH_KEYS}
    log(f"  main-path launches (phase 8b a, b, e): "
        f"{json.dumps(train['launches'])}")
    for k in TRAIN_ROWS:
        check(train_launches[k] > 0, f"{k} was never launched on the main "
              "path")
    check(train_launches["rmsnorm_bwd_by"]["rows"] > 0, "training never "
          "launched the RMSNorm backward's rows variant")
    for k in ("prefill_mma", "tiled_f32"):
        check(train_launches["flash_attention_by"][k] > 0, f"training never "
              f"launched attention variant {k} (with its lse)")
    for k in fa.BWD_VARIANTS:      # bf16 (a, b) on the tensor cores, f32 (e)
        check(train_launches["attention_bwd_by"][k] > 0, f"training never "
              f"launched the attention backward's {k} kernel")
    train["c"] = phase_train_vs_plain(dev, cfg)
    train_errs, train_times = phase_train_kernels(dev, cfg)
    train["seconds"] = time.perf_counter() - t_train
    log(f"  phase 8b done at {time.perf_counter() - t_start:.1f} s "
        f"({train['seconds']:.1f} s)")

    log("== phase 8c: LM families at full width (main path: counts from "
        "here on)")
    reset_counts()
    families = phase_families(dev)
    log(f"  phase 8c done at {time.perf_counter() - t_start:.1f} s "
        f"({families['seconds']:.1f} s; its main path "
        f"{families['main_path_s']:.1f} s)")

    log("== phase 8d: MoE at full width (main path: counts from here on)")
    reset_counts()
    moe_out = phase_moe(dev)
    log(f"  phase 8d done at {time.perf_counter() - t_start:.1f} s "
        f"({moe_out['seconds']:.1f} s; its main path "
        f"{moe_out['main_path_s']:.1f} s)")

    log("== phase 8e: the Mamba2 hybrid at full width and depth (main path: "
        "counts from here on)")
    reset_counts()
    hybrid = phase_hybrid(dev)
    log(f"  phase 8e done at {time.perf_counter() - t_start:.1f} s "
        f"({hybrid['seconds']:.1f} s; its main path "
        f"{hybrid['main_path_s']:.1f} s)")

    log("== phase 9: summary")
    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=ROWS[k][0], pallas=ROWS[k][1],
                    launches=launches[k], max_abs_err=errs[k], tolerance=0,
                    library_ms=None, matches_plain=errs[k] == 0,
                    **{f: times[k][f] for f in (
                        "ms", "ms_from", "call_ms", "plain_ms",
                        "plain_device_ms", "bound_ms", "bound_by",
                        "shape")})
               for k in ROWS]
    for k in kernels:
        if k["name"].startswith("fire_block"):
            k.update(fire_block_extras(k["name"], times, floor, launches))
        if k["name"] == "sched_run":
            k.update(sched_run_extras(times["sched_run"], launches,
                                      sched_cases))
        if k["name"] == "sched_slot_step":
            k.update(slot_step_extras(times["sched_slot_step"], launches,
                                      slot_cases))
        if k["name"] == "fire_step":
            k.update(fire_step_extras(times["fire_step"], launches))
    kernels.append(dict(
        name="mf_block", route="cuda", source=MF_SOURCE,
        replaces=MF_REPLACES,
        pallas="none: MultiFabric._core_fn, a jnp program (vmap or "
        "shard_map, lax.psum a cycle) that XLA fuses into one dispatch a "
        "block", launches=mf_launches,
        launches_by=launches["mf_block_by"],
        launches_unprofiled=launches["mf_block"],
        launches_profiled=launches["mf_block_prof"],
        max_abs_err=mf_row["max_abs_err"], tolerance=0, library_ms=None,
        matches_plain=mf_row["max_abs_err"] == 0, ms=mf_row["ms"],
        ms_from="profiler", plain_ms=mf_row["plain_ms"],
        bound_ms=mf_row["bound_ms"], bound_by=mf_row["bound_by"],
        **{f: mf_row[f] for f in (
            "us_per_cycle", "variant", "floor_ms", "floor_us_per_cycle",
            "cta_ms", "cta_us_per_cycle", "shape", "cases_held")},
        row3_us_per_cycle=times["fire_block_batched"]["us_per_cycle"],
        by_state=mf_row["times"]))
    kernels += lm_rows(lm_errs, lm_times, lm_launches, norm_variants)
    for k in kernels:                  # phase 8d's MoE models beside
        if k["name"] in LM_ROWS:
            k["launches_moe"] = {
                name: dict(head_dim=moe_out[name]["head_dim"],
                           d_model=moe_out[name]["d_model"],
                           launches=moe_out[name]["launches"][k["name"]],
                           launches_by=moe_out[name]["launches"][
                               f"{k['name']}_by"])
                for name in MOE_ARCHS}
        if k["name"] == "flash_attention":
            k["hd112"] = {key: {f: t[f] for f in (
                "ms", "ms_from", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "tol_ratio", "shape")}
                for key, t in moe_out["attention_times"].items()}
            k["variants_hd112_launches"] = moe_out["kimi-k2-1t-a32b"][
                "launches"]["flash_attention_by"]
            h = moe_out["attention_hd112"]
            k["hd112"]["decode"] = {f: h["decode"][f] for f in (
                "ms", "ms_from", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")}
            k["hd112_errors"] = h["errors"]
            k["hd112_planted_lost_split"] = h["planted"]
        if k["name"] in LM_ROWS:       # phase 8e's hybrid beside
            k["launches_zamba2"] = dict(
                head_dim=112, d_model=3584, d_in=7168,
                launches=hybrid["launches"][k["name"]],
                launches_by=hybrid["launches"][f"{k['name']}_by"])
        if k["name"] == "flash_attention":
            k["zamba2"] = {key: {f: t[f] for f in (
                "ms", "ms_from", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "tol_ratio", "shape")}
                for key, t in hybrid["attention"]["forward"].items()}
            h = hybrid["attention_served"]
            k["zamba2"]["decode"] = {f: h["decode"][f] for f in (
                "ms", "ms_from", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")}
            k["zamba2_errors"] = h["errors"]
            k["zamba2_planted_lost_split"] = h["planted"]
        if k["name"] == "rmsnorm":
            k["zamba2_launches_by_width"] = {
                part: hybrid[part]["norm_calls_by_width"]
                for part in ("serve", "long_wave", "train")}
            k["zamba2_widths"] = hybrid["norms"]["forward"]
    kernels += train_rows(train_errs, train_times, train_launches)
    for k in kernels:                  # phase 8e's hybrid beside
        if k["name"].startswith("attention_bwd"):
            k["launches_zamba2"] = dict(
                head_dim=112, launches_by=hybrid["launches"][
                    "attention_bwd_by"])
            k["hd112_zamba2"] = {key.split(" ")[1]: t for key, t in
                                 hybrid["attention"]["backward"].items()
                                 if key.startswith(k["name"] + " ")}
        if k["name"] == "rmsnorm_bwd":
            k["launches_zamba2"] = hybrid["launches"]["rmsnorm_bwd"]
            k["zamba2_widths"] = hybrid["norms"]["backward"]
    for k in kernels:       # rows 1-8 and 11 bit for bit, 9-10, 12-14 allclose
        ok = k["max_abs_err"] == 0 if k["tolerance"] == 0 else \
            k["tol_ratio"] <= 1 and k["tol_ratio_f32"] <= 1 and all(
                x["tol_ratio"] <= 1 for x in k.get("variants", ()))
        check(ok, f"{k['name']} disagrees with plain beyond its tolerance")
    log(json.dumps({"serving": serve}))
    log(json.dumps({"hardened_serving": hardened}))
    log(json.dumps({"traced_programs": traced}))
    log(json.dumps({"sharded_serving": sharded}))
    log(json.dumps({"lm_serving": lm_stats}, default=str))
    log(json.dumps({"lm_kernel_times": lm_times}))
    log(json.dumps({"lm_training": train}))
    log(json.dumps({"lm_families": families}))
    log(json.dumps({"moe": moe_out}))
    log(json.dumps({"hybrid": hybrid}))
    log(json.dumps({"table1_us_per_cycle": table1}))
    log(json.dumps({"compile": compiled}))
    log(json.dumps({"sched_vs_fire_block": versus}))
    log(json.dumps({"latency_floor": floor}))
    log(json.dumps({"block_by_instantiation": {
        v: {f: t[f] for f in ("ms", "call_ms", "bound_ms", "shape")}
        for v, t in by_variant.items()}}))
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
