"""Public wrappers over the kernels: the fire block and fire step of the
fabric, and the LM's flash attention and RMSNorm (the entry points of
the JAX package's ``repro.kernels.ops``, same names and signatures).

On CUDA tensors they launch the hand-written kernels; on CPU tensors
(``device="cpu"``) they compute the plain PyTorch versions — the
wrappers in :mod:`repro_torch.kernels.dataflow_fire`,
:mod:`~repro_torch.kernels.flash_attention` and
:mod:`~repro_torch.kernels.rmsnorm` decide by the tensors' device alone.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dataflow_fire import (FireTables,
                                               block_plan_arrays,
                                               check_step_tables,
                                               device_tables,
                                               fire_block_batched_cuda,
                                               fire_block_cuda,
                                               fire_step_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda


def flash_attention(q, k, v, *, causal=True, bq=128, bk=128):
    """GQA attention of q [B, Sq, H, hd] over k, v [B, Skv, Hkv, hd], as
    ``flash_attention_pallas`` computes it.  ``bq``/``bk`` (the Pallas
    tiles) are accepted and unused: the CUDA kernel chooses its own tiles,
    so results agree with the Pallas kernel within float tolerance, not
    bit for bit."""
    del bq, bk
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal)


def rmsnorm(x, w, eps=1e-5, rows_blk=256):
    """RMSNorm of x [..., d] with weight w [d] in f32, rounded once to x's
    dtype, as ``rmsnorm_pallas`` computes it.  ``rows_blk`` is accepted
    and unused (the CUDA kernel takes one warp per row)."""
    del rows_blk
    return rmsnorm_cuda(x.contiguous(), w, eps)


def make_block_step(graph, n_cycles: int, batched: bool = False,
                    tables=None, device="cuda", optimize: bool = False,
                    profile: bool = False):
    """The fused K-cycle fire-block step for a fabric.

    Returns (tables, step).  Single-stream step signature:
      step(feed_vals, feed_len, full, val, ptr, out_last, out_count)
        -> (full', val', ptr', out_last', out_count', fired[1],
            last_prog[1])
    With batched=True every array gains a leading B axis (one CTA per
    stream, one launch for all B) and the step takes a trailing
    ``active`` int32[B] clock gate: slots with active == 0 skip the
    block entirely (state frozen, fired/last_prog 0).  ``tables`` may be
    a prior call's tables (numpy, from :func:`block_plan_arrays`) or
    device tables from :func:`device_tables`, reused as they are;
    ``optimize=True`` builds opcode-bucketed tables (ignored when
    ``tables`` is given: tables carry their own buckets).  With
    profile=True the step takes five trailing counter arrays (nf, si,
    so, ab, ahw — per-stream rows when batched) and returns them,
    accumulated inside the same launch, after last_prog."""
    if tables is None:
        tables = block_plan_arrays(graph, optimize=optimize)
    dt = tables if isinstance(tables, FireTables) \
        else device_tables(tables, device)

    if batched:
        def step(feed_vals, feed_len, full, val, ptr, out_last, out_count,
                 active, *prof):
            return fire_block_batched_cuda(
                dt, feed_vals, feed_len, full, val, ptr, out_last,
                out_count, n_cycles=n_cycles, active=active,
                prof=_prof_arg(prof, profile))
    else:
        def step(feed_vals, feed_len, full, val, ptr, out_last, out_count,
                 *prof):
            return fire_block_cuda(
                dt, feed_vals, feed_len, full, val, ptr, out_last,
                out_count, n_cycles=n_cycles, prof=_prof_arg(prof, profile))
    return tables, step


def _prof_arg(prof, profile):
    """The counters a step was given: five arrays on a profiled step,
    none on an unprofiled one."""
    if len(prof) != (5 if profile else 0):
        raise TypeError(f"a {'' if profile else 'un'}profiled step takes "
                        f"{5 if profile else 0} counter arrays, got "
                        f"{len(prof)}")
    return tuple(prof) if profile else None


def make_fire_step(graph, device="cuda"):
    """The one-cycle fire step for a fabric (dense rule, unoptimized
    plan); returns (tables, step(full, val) -> (full', val', fired[1]))
    on tensors on ``device``.  On a card the step's tables are checked
    here, once (:func:`~repro_torch.kernels.dataflow_fire
    .check_step_tables`), and each step checks only its registers."""
    tables = block_plan_arrays(graph)
    dt = device_tables(tables, device)
    if dt["opcode"].device.type == "cuda":
        check_step_tables(dt)

    def step(full, val):
        return fire_step_cuda(dt, full, val)
    return tables, step


def run_fabric(graph, feeds, max_cycles: int = 10_000, compiled=None,
               device="cuda"):
    """Drive a fabric to completion through the per-cycle fire-step
    kernel, with the environment (feed/drain) on the host: one launch
    and one device-to-host read per engine cycle.  The baseline the
    fused block engine is measured against (the paper's Table-1
    comparison).  Pass compiled=(tables, step) from
    :func:`make_fire_step` to reuse one across calls.  Returns an
    EngineResult with engine semantics (dispatches = cycles).

    Unlike the JAX package's ``run_fabric``, the fabric starts with its
    initial tokens (``graph.inits``) on their arcs, as every other
    executor and ``run_reference`` start it: without them a loop fabric
    never starts."""
    from repro_torch.core.engine import EngineResult, resolve_device
    dev = resolve_device(device)
    tables, step = compiled if compiled is not None \
        else make_fire_step(graph, dev)
    p = tables["plan"]
    A2 = p["A"] + 2
    full = np.zeros((A2,), np.int32)
    val = np.zeros((A2,), np.int32)
    full[p["FULL_PAD"]] = 1
    for a, v in (*graph.consts.items(), *graph.inits.items()):
        full[p["aidx"][a]] = 1
        val[p["aidx"][a]] = int(v)
    feeds = {a: np.asarray(v, np.int32).reshape(-1)
             for a, v in (feeds or {}).items()}
    ptr = {a: 0 for a in p["input_arcs"]}
    out_last = {a: np.int32(0) for a in p["output_arcs"]}
    out_count = {a: 0 for a in p["output_arcs"]}
    # host mirrors of the step's outputs (pinned on the card, so the
    # three copies are queued behind the launch and waited on once)
    pin = dev.type == "cuda"
    host = [torch.empty((n,), dtype=torch.int32, pin_memory=pin)
            for n in (A2, A2, 1)]
    cycles = fired = 0
    progress = True
    while progress and cycles < max_cycles:
        progress = False
        for a in p["input_arcs"]:
            i = p["aidx"][a]
            if not full[i] and a in feeds and ptr[a] < len(feeds[a]):
                val[i] = feeds[a][ptr[a]]
                full[i] = 1
                ptr[a] += 1
                progress = True
        res = step(torch.from_numpy(full).to(dev, non_blocking=pin),
                   torch.from_numpy(val).to(dev, non_blocking=pin))
        for h, r in zip(host, res):
            h.copy_(r, non_blocking=pin)
        if pin:
            torch.cuda.current_stream(dev).synchronize()
        full, val = host[0].numpy().copy(), host[1].numpy().copy()
        full[p["EMPTY_PAD"]] = 0
        full[p["FULL_PAD"]] = 1
        k = int(host[2][0])
        fired += k
        progress = progress or k > 0
        for a in p["output_arcs"]:
            i = p["aidx"][a]
            if full[i]:
                out_last[a] = val[i]
                out_count[a] += 1
                full[i] = 0
                progress = True
        cycles += 1
    return EngineResult(outputs=out_last, counts=out_count, cycles=cycles,
                        fired=fired, dispatches=cycles)
