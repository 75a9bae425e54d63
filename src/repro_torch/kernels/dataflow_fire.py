"""The fire-block kernel: K fused feed -> fire -> drain engine cycles.

One engine cycle of the paper's fabric, as the JAX package's Pallas
kernels compute it (``fire_block_pallas`` / ``fire_block_batched_pallas``
in ``repro/kernels/dataflow_fire.py``):

1. **feed** — every empty input arc is strobed with the next token of
   its stream (``feed_vals``/``feed_len`` with a per-arc pointer);
2. **fire** — every node whose rule holds on the post-feed registers
   fires at once (the dense rule of :func:`_ready_and_z`);
3. **drain** — output arcs are emptied into last-value and token-count
   accumulators.

The arc update is gather-only: each arc pulls its next state from its
unique producer and consumer (the paper's one-sender/one-receiver
channel rule).  ``last_prog`` is the 1-based index of the last cycle of
the block that made progress, 0 for a block idle throughout; a block
whose tail is idle means the fabric is quiescent (idle is absorbing).

This module holds, side by side:

* the table builders :func:`plan_arrays` / :func:`block_plan_arrays`
  (numpy, identical to the JAX package's);
* the **plain PyTorch versions** :func:`fire_block` and
  :func:`fire_block_batched` (B streams as an explicit leading
  dimension, with the per-stream ``active`` gate);
* the **kernel wrappers** :func:`fire_block_cuda` and
  :func:`fire_block_batched_cuda`.  On CUDA tensors they launch the
  hand-written kernel ``csrc/dataflow_fire.cu`` (built at first use, see
  :mod:`repro_torch.kernels._build`) and count the launch; on CPU
  tensors they compute the plain version and build nothing.

Tables (int32; A2 = arcs + 2 pad slots, N2 = nodes + 1 dummy SINK row):
  opcode[N2], in_idx[N2,3], out_idx[N2,2]            node table
  prod_node/prod_slot[A2], cons_node/cons_slot[A2]   arc adjacency
  const_mask[A2], env_row[A2], out_mask[A2]          environment maps
  in_arc_idx[n_in], out_arc_idx[n_out]               feed / drain rows
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.graph import Op

TABLE_KEYS = ("opcode", "in_idx", "out_idx", "prod_node", "prod_slot",
              "cons_node", "cons_slot", "const_mask", "env_row",
              "in_arc_idx", "out_arc_idx", "out_mask")

_INT_MIN = -(2 ** 31)


# ---------------------------------------------------------------------------
# Tables (numpy)
# ---------------------------------------------------------------------------
def plan_arrays(graph):
    """Static numpy tables incl. arc adjacency (dummy node N = never
    ready; dummy slots pad)."""
    from repro_torch.core.engine import _plan
    p = _plan(graph)
    A2 = p["A"] + 2
    N = len(graph.nodes)
    opcode = np.concatenate([p["opcode"], [int(Op.SINK)]]).astype(np.int32)
    in_idx = np.concatenate(
        [p["in_idx"], [[p["EMPTY_PAD"]] * 3]]).astype(np.int32)
    out_idx = np.concatenate(
        [p["out_idx"], [[p["EMPTY_PAD"]] * 2]]).astype(np.int32)
    prod_node = np.full((A2,), N, np.int32)
    prod_slot = np.zeros((A2,), np.int32)
    cons_node = np.full((A2,), N, np.int32)
    cons_slot = np.zeros((A2,), np.int32)
    for i, n in enumerate(graph.nodes):
        for s, arc in enumerate(n.outputs):
            prod_node[p["aidx"][arc]] = i
            prod_slot[p["aidx"][arc]] = s
        for s, arc in enumerate(n.inputs):
            if arc not in graph.consts:      # consts are never consumed
                cons_node[p["aidx"][arc]] = i
                cons_slot[p["aidx"][arc]] = s
    const_mask = p["const_mask"].astype(np.int32)
    return dict(opcode=opcode, in_idx=in_idx, out_idx=out_idx,
                prod_node=prod_node, prod_slot=prod_slot,
                cons_node=cons_node, cons_slot=cons_slot,
                const_mask=const_mask, plan=p)


def block_plan_arrays(graph):
    """plan_arrays + environment maps for in-kernel feed/drain.

    env_row[A2]     row into the feed table for input arcs, n_in (a pad
                    row with feed_len 0) otherwise — makes the input
                    strobe a pure gather.
    in_arc_idx[n_in]  arc slot of each feed row (EMPTY_PAD pad rows).
    out_arc_idx[n_out] arc slot of each output accumulator row.
    out_mask[A2]    1 on output arcs (drained unconditionally each cycle).
    n_in/n_out are padded to at least 1 so the kernel never sees a
    zero-length axis.
    """
    t = plan_arrays(graph)
    p = t["plan"]
    A2 = p["A"] + 2
    n_in = max(len(p["input_arcs"]), 1)
    n_out = max(len(p["output_arcs"]), 1)
    env_row = np.full((A2,), n_in, np.int32)
    in_arc_idx = np.full((n_in,), p["EMPTY_PAD"], np.int32)
    for r, a in enumerate(p["input_arcs"]):
        env_row[p["aidx"][a]] = r
        in_arc_idx[r] = p["aidx"][a]
    out_arc_idx = np.full((n_out,), p["EMPTY_PAD"], np.int32)
    out_mask = np.zeros((A2,), np.int32)
    for r, a in enumerate(p["output_arcs"]):
        out_arc_idx[r] = p["aidx"][a]
        out_mask[p["aidx"][a]] = 1
    t.update(env_row=env_row, in_arc_idx=in_arc_idx,
             out_arc_idx=out_arc_idx, out_mask=out_mask)
    return t


class FireTables(dict):
    """Device copies of the :data:`TABLE_KEYS` tables, bounds-checked on
    the host by :func:`device_tables` — the only tables the kernel
    takes, since it indexes shared memory with their values."""


def device_tables(tables, device) -> FireTables:
    """int32 tensors on ``device`` from :func:`block_plan_arrays` tables,
    after checking every index against the table sizes."""
    t = {k: np.asarray(tables[k], np.int32) for k in TABLE_KEYS}
    N2, A2 = t["opcode"].shape[0], t["prod_node"].shape[0]
    n_in = t["in_arc_idx"].shape[0]
    shapes = dict(opcode=(N2,), in_idx=(N2, 3), out_idx=(N2, 2),
                  in_arc_idx=(n_in,), out_arc_idx=(t["out_arc_idx"].size,))
    bounds = dict(in_idx=A2, out_idx=A2, prod_node=N2, prod_slot=2,
                  cons_node=N2, cons_slot=3, env_row=n_in + 1,
                  in_arc_idx=A2, out_arc_idx=A2)
    for k, x in t.items():
        if x.shape != shapes.get(k, (A2,)):
            raise ValueError(f"table {k}: shape {x.shape}, want "
                             f"{shapes.get(k, (A2,))}")
        if k in bounds and x.size and (x.min() < 0 or x.max() >= bounds[k]):
            raise ValueError(f"table {k}: index outside [0, {bounds[k]})")
    return FireTables({k: torch.tensor(x, device=device)
                       for k, x in t.items()})


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------
def _ready_and_z(opcode, in_idx, out_idx, full, val):
    """Dense firing rule on registers ``full``/``val`` [..., A2]: returns
    ready [..., N2] bool, z [..., N2] int32, consume [..., N2, 3] bool and
    produce [..., N2, 2] bool.  Mirrors the JAX package's
    ``_ready_and_z`` bit for bit: NDMERGE takes input a first, DMERGE
    selects by ``c != 0``, BRANCH needs only its chosen output empty,
    every other node needs all inputs full and all outputs empty."""
    inf = full[..., in_idx] > 0                   # [..., N, 3]
    oute = full[..., out_idx] == 0                # [..., N, 2]
    a = val[..., in_idx[:, 0]]
    b = val[..., in_idx[:, 1]]
    c = val[..., in_idx[:, 2]]
    in0, in1, in2 = inf.unbind(-1)
    oe0, oe1 = oute.unbind(-1)
    all_in = inf.all(-1)
    all_out = oute.all(-1)

    is_nd = opcode == int(Op.NDMERGE)
    is_dm = opcode == int(Op.DMERGE)
    is_br = opcode == int(Op.BRANCH)
    ctrl3 = c != 0
    ctrl2 = b != 0

    ready = all_in & all_out
    ready = torch.where(is_nd, (in0 | in1) & all_out, ready)
    ready = torch.where(is_dm, in2 & torch.where(ctrl3, in0, in1) & all_out,
                        ready)
    ready = torch.where(is_br, in0 & in1 & torch.where(ctrl2, oe0, oe1),
                        ready)

    i32 = torch.int32
    bs = b.clamp(0, 31)
    # floor division with the ALU's guards: x // 0 is 0, and
    # INT_MIN // -1 wraps to INT_MIN (divide by 1 instead)
    odd = (b == 0) | ((a == _INT_MIN) & (b == -1))
    quot = torch.div(a, torch.where(odd, torch.ones_like(b), b),
                     rounding_mode="floor")
    zs = {
        Op.ADD: a + b, Op.SUB: a - b, Op.MUL: a * b,
        Op.DIV: torch.where(b == 0, torch.zeros_like(a), quot),
        Op.AND: a & b, Op.OR: a | b, Op.XOR: a ^ b,
        Op.MAX: torch.maximum(a, b), Op.MIN: torch.minimum(a, b),
        Op.SHL: torch.bitwise_left_shift(a, bs),
        Op.SHR: torch.bitwise_right_shift(a, bs),
        Op.NOT: (a == 0).to(i32),
        Op.IFGT: (a > b).to(i32), Op.IFGE: (a >= b).to(i32),
        Op.IFLT: (a < b).to(i32), Op.IFLE: (a <= b).to(i32),
        Op.IFEQ: (a == b).to(i32), Op.IFDF: (a != b).to(i32),
        Op.NDMERGE: torch.where(in0, a, b),
        Op.DMERGE: torch.where(ctrl3, a, b),
    }
    z = a
    for op, r in zs.items():
        z = torch.where(opcode == int(op), r, z)

    # per-slot consume/produce masks
    consume = torch.ones_like(inf)
    nd_pick = torch.stack([in0, ~in0, torch.zeros_like(in0)], -1)
    dm_pick = torch.stack([ctrl3, ~ctrl3, torch.ones_like(ctrl3)], -1)
    consume = torch.where(is_nd[:, None], nd_pick, consume)
    consume = torch.where(is_dm[:, None], dm_pick, consume)
    consume = consume & ready[..., None]
    produce = torch.ones_like(oute)
    produce = torch.where(is_br[:, None], torch.stack([ctrl2, ~ctrl2], -1),
                          produce)
    produce = produce & ready[..., None]
    return ready, z, consume, produce


def _fire_parts(tab, full, val):
    """One fire step on [B, A2] registers: (full', val', ready[B, N2])."""
    ready, z, consume, produce = _ready_and_z(
        tab["opcode"], tab["in_idx"], tab["out_idx"], full, val)
    # arc-side gather (single producer / single consumer per channel)
    produced = produce[:, tab["prod_node"], tab["prod_slot"]]
    consumed = consume[:, tab["cons_node"], tab["cons_slot"]]
    new_full = ((full > 0) & ~consumed) | produced | (tab["const_mask"] > 0)
    new_val = torch.where(produced, z[:, tab["prod_node"]], val)
    return new_full.to(full.dtype), new_val, ready


def _block_body(tab, feed_vals, feed_len, full, val, ptr, out_last,
                out_count, n_cycles: int):
    """``n_cycles`` engine cycles over B streams (every array has a
    leading B axis).  Returns the five state arrays, then fired[B] (node
    firings in this block) and last_prog[B]."""
    B, L = full.shape[0], feed_vals.shape[2]
    zero = torch.zeros((B,), dtype=torch.int32, device=full.device)
    fired, last_prog = zero, zero
    no_row = torch.zeros((B, 1), dtype=torch.bool, device=full.device)
    for cyc in range(n_cycles):
        # 1. strobe environment input buses (pad row: feed_len 0)
        can_feed = (full[:, tab["in_arc_idx"]] == 0) & (ptr < feed_len)
        nxt = torch.gather(feed_vals, 2,
                           ptr.clamp(0, L - 1).long()[:, :, None])[:, :, 0]
        can_p = torch.cat([can_feed, no_row], 1)
        nxt_p = torch.cat([nxt, zero[:, None]], 1)
        fed_arc = can_p[:, tab["env_row"]]
        val = torch.where(fed_arc, nxt_p[:, tab["env_row"]], val)
        full = torch.where(fed_arc, torch.ones_like(full), full)
        ptr = ptr + can_feed.to(ptr.dtype)
        # 2. fire every ready node
        full, val, ready = _fire_parts(tab, full, val)
        n_fired = ready.sum(1, dtype=torch.int32)
        # 3. environment drains output buses
        got = full[:, tab["out_arc_idx"]] > 0
        out_last = torch.where(got, val[:, tab["out_arc_idx"]], out_last)
        out_count = out_count + got.to(out_count.dtype)
        full = torch.where(tab["out_mask"] > 0, torch.zeros_like(full), full)
        progress = can_feed.any(1) | (n_fired > 0) | got.any(1)
        fired = fired + n_fired
        last_prog = torch.where(progress, zero + (cyc + 1), last_prog)
    return full, val, ptr, out_last, out_count, fired, last_prog


def _long_tables(tables, device):
    return {k: torch.as_tensor(tables[k], device=device).long()
            for k in TABLE_KEYS}


def fire_block_batched(tables, feed_vals, feed_len, full, val, ptr,
                       out_last, out_count, *, n_cycles: int, active=None):
    """Plain PyTorch batched block step: B streams through one fabric.

    feed_vals[B, n_in, L], feed_len[B, n_in], full/val[B, A2],
    ptr[B, n_in], out_last/out_count[B, n_out], all int32.  ``active``
    (int32[B], default all ones) is the per-stream clock gate: a stream
    with active == 0 keeps its state and reports fired = last_prog = 0.
    Returns (full', val', ptr', out_last', out_count', fired[B, 1],
    last_prog[B, 1])."""
    tab = _long_tables(tables, full.device)
    res = _block_body(tab, feed_vals, feed_len, full, val, ptr, out_last,
                      out_count, n_cycles)
    if active is None:
        state, fired, lp = res[:5], res[5], res[6]
    else:
        keep = active != 0
        old = (full, val, ptr, out_last, out_count)
        state = tuple(torch.where(keep[:, None], n, o)
                      for n, o in zip(res[:5], old))
        fired = torch.where(keep, res[5], torch.zeros_like(res[5]))
        lp = torch.where(keep, res[6], torch.zeros_like(res[6]))
    return (*state, fired[:, None], lp[:, None])


def fire_block(tables, feed_vals, feed_len, full, val, ptr, out_last,
               out_count, *, n_cycles: int):
    """Plain PyTorch single-stream block step: feed_vals[n_in, L],
    feed_len[n_in], full/val[A2], ptr[n_in], out_last/out_count[n_out].
    Returns (full', val', ptr', out_last', out_count', fired[1],
    last_prog[1])."""
    res = fire_block_batched(
        tables, *(x[None] for x in (feed_vals, feed_len, full, val, ptr,
                                     out_last, out_count)),
        n_cycles=n_cycles)
    return (*(x[0] for x in res[:5]), res[5][0], res[6][0])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _vp(x):
    return ctypes.c_void_p(x.data_ptr())


@functools.cache
def _smem_limit(device_index: int) -> int:
    """Shared memory one CTA may opt in to on that card, in bytes."""
    from repro_torch.kernels import _build
    return _build.load().fire_block_smem_limit(device_index)


def _launch(tables, feed_vals, feed_len, state, active, n_cycles, batched):
    """Check the arguments and launch the CUDA kernel (grid = B);
    returns the freshly allocated outputs."""
    from repro_torch.kernels import _build
    if not isinstance(tables, FireTables):
        raise TypeError("the kernel takes tables from device_tables() only")
    if n_cycles < 0:
        raise ValueError(f"n_cycles must be >= 0, got {n_cycles}")
    full = state[0]
    dev = full.device
    B = full.shape[0] if batched else 1
    lead = (B,) if batched else ()
    N2 = tables["opcode"].shape[0]
    A2 = tables["prod_node"].shape[0]
    n_in = tables["in_arc_idx"].shape[0]
    n_out = tables["out_arc_idx"].shape[0]
    L = feed_vals.shape[-1]
    want = dict(feed_vals=(*lead, n_in, L), feed_len=(*lead, n_in),
                full=(*lead, A2), val=(*lead, A2), ptr=(*lead, n_in),
                out_last=(*lead, n_out), out_count=(*lead, n_out))
    if active is not None:
        want["active"] = (B,)
    args = dict(zip(want, (feed_vals, feed_len, *state, active)))
    for k, x in (*args.items(), *tables.items()):
        if x.device != dev:
            raise ValueError(f"{k} is on {x.device}, the state on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{k} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
    for k, shape in want.items():
        if tuple(args[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(args[k].shape)}, want "
                             f"{shape}")
    if B < 1 or L < 1:
        raise ValueError("the kernel needs B >= 1 and L >= 1")
    lib = _build.load()
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    # dynamic arrays + the kernel's one static counter
    smem = 4 * (2 * A2 + 2 * N2 + n_in + 2 * n_out + 1)
    if smem > _smem_limit(index):
        raise ValueError(f"fabric needs {smem} B of shared memory per "
                         f"stream; the card gives {_smem_limit(index)}")
    with torch.cuda.device(index):
        outs = [torch.empty_like(x) for x in state]
        fired = torch.empty((*lead, 1), dtype=torch.int32, device=dev)
        last_prog = torch.empty_like(fired)
        err = lib.fire_block_launch(
            *(_vp(tables[k]) for k in TABLE_KEYS),
            _vp(feed_vals), _vp(feed_len), *(_vp(x) for x in state),
            None if active is None else _vp(active),
            *(_vp(x) for x in outs), _vp(fired), _vp(last_prog),
            B, N2, A2, n_in, n_out, L, int(n_cycles),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError("fire_block kernel launch failed: "
                           + lib.fire_block_error_string(err).decode())
    return (*outs, fired, last_prog)


def _on_cpu(*xs) -> bool:
    devs = {x.device.type for x in xs if x is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed devices {sorted(devs)}")


def fire_block_cuda(tables, feed_vals, feed_len, full, val, ptr, out_last,
                    out_count, *, n_cycles: int):
    """Single-stream block step (the counterpart of ``fire_block_pallas``).
    CUDA tensors launch the kernel with B = 1 and count the launch in
    ``fire_block_cuda.launches``; CPU tensors take :func:`fire_block`."""
    state = (full, val, ptr, out_last, out_count)
    if _on_cpu(feed_vals, feed_len, *state):
        return fire_block(tables, feed_vals, feed_len, *state,
                          n_cycles=n_cycles)
    out = _launch(tables, feed_vals, feed_len, state, None, n_cycles,
                  batched=False)
    fire_block_cuda.launches += 1
    return out


def fire_block_batched_cuda(tables, feed_vals, feed_len, full, val, ptr,
                            out_last, out_count, *, n_cycles: int,
                            active=None):
    """Batched block step (the counterpart of
    ``fire_block_batched_pallas``): one CTA per stream, parked streams
    (active == 0) pass their state through.  CUDA tensors launch the
    kernel and count the launch in ``fire_block_batched_cuda.launches``;
    CPU tensors take :func:`fire_block_batched`."""
    state = (full, val, ptr, out_last, out_count)
    if _on_cpu(feed_vals, feed_len, *state, active):
        return fire_block_batched(tables, feed_vals, feed_len, *state,
                                  n_cycles=n_cycles, active=active)
    out = _launch(tables, feed_vals, feed_len, state, active, n_cycles,
                  batched=True)
    fire_block_batched_cuda.launches += 1
    return out


fire_block_cuda.launches = 0
fire_block_batched_cuda.launches = 0
