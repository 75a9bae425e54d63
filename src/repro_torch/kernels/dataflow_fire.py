"""The fire-block kernel: K fused feed -> fire -> drain engine cycles,
and the one-cycle fire step.

One engine cycle of the paper's fabric, as the JAX package's Pallas
kernels compute it (``fire_block_pallas`` / ``fire_block_batched_pallas``
in ``repro/kernels/dataflow_fire.py``):

1. **feed** — every empty input arc is strobed with the next token of
   its stream (``feed_vals``/``feed_len`` with a per-arc pointer);
2. **fire** — every node whose rule holds on the post-feed registers
   fires at once: the dense rule of :func:`_ready_and_z`, or, over an
   opcode-bucketed plan (``class_slices``), the specialized rule of
   :func:`_ready_and_z_spec` — bit-identical;
3. **drain** — output arcs are emptied into last-value and token-count
   accumulators.

The arc update is gather-only: each arc pulls its next state from its
unique producer and consumer (the paper's one-sender/one-receiver
channel rule).  ``last_prog`` is the 1-based index of the last cycle of
the block that made progress, 0 for a block idle throughout; a block
whose tail is idle means the fabric is quiescent (idle is absorbing).
A profiled block also carries five counters (``prof``: node fires,
stalls on input and on output per node row, busy cycles and high water
per arc slot) sampled after the fire and before the drain.
``fire_step`` is one fire alone, with no environment (the per-cycle
baseline ``fire_step_pallas``).

This module holds, side by side:

* the table builders :func:`plan_arrays` / :func:`block_plan_arrays`
  (numpy, identical to the JAX package's);
* the **plain PyTorch versions** :func:`fire_block`,
  :func:`fire_block_batched` (B streams as an explicit leading
  dimension, with the per-stream ``active`` gate) and :func:`fire_step`;
* :func:`fire_block_two_phase`, the same block computed in the CUDA
  kernel's own cycle order (two phases per cycle, feed and drain on the
  arc's lane through :func:`reverse_maps`, lane-local counts, staged
  feed windows), and :func:`fire_step_warp_order`, the fire step in its
  warp variant's order; the tests and ``chip_smoke.py`` hold them
  against the JAX package and the kernels, the main path never runs
  them;
* the **kernel wrappers** :func:`fire_block_cuda`,
  :func:`fire_block_batched_cuda` and :func:`fire_step_cuda`.  On CUDA
  tensors they launch the hand-written kernels of
  ``csrc/dataflow_fire.cu`` (built at first use, see
  :mod:`repro_torch.kernels._build`) and count the launch; on CPU
  tensors they compute the plain version and build nothing.  The block
  kernel comes in two variants, chosen by :func:`block_variant` from the
  fabric's size: ``"warp"`` (one warp per stream, tables in registers)
  and ``"cta"`` (one CTA per stream); so does the fire step
  (:func:`step_variant`: one warp, every load at entry, or one CTA).

Tables (int32; A2 = arcs + 2 pad slots, N2 = nodes + 1 dummy SINK row):
  opcode[N2], in_idx[N2,3], out_idx[N2,2]            node table
  prod_node/prod_slot[A2], cons_node/cons_slot[A2]   arc adjacency
  const_mask[A2], env_row[A2], out_mask[A2]          environment maps
  in_arc_idx[n_in], out_arc_idx[n_out]               feed / drain rows
  class_slices ((op, lo, hi), ...)                   opcode buckets
                                                     (optimized plans)
  feed_ptr[A2+1], feed_rows[n_in]                    arc -> its feed rows
  out_ptr[A2+1], out_rows[n_out]                     arc -> its output rows
                                                     (device_tables, CSR)
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.engine import _node_inputs_ready, _plan
from repro_torch.core.graph import Op

TABLE_KEYS = ("opcode", "in_idx", "out_idx", "prod_node", "prod_slot",
              "cons_node", "cons_slot", "const_mask", "env_row",
              "in_arc_idx", "out_arc_idx", "out_mask")
STEP_KEYS = TABLE_KEYS[:8]      # what one fire step reads
REVERSE_KEYS = ("feed_ptr", "feed_rows", "out_ptr", "out_rows")

_INT_MIN = -(2 ** 31)
_CTRL_OPS = (int(Op.NDMERGE), int(Op.DMERGE), int(Op.BRANCH))
# a plan has at most one bucket per opcode plus the trailing dummy row's
MAX_CLASSES = len(Op) + 1
# the block kernel's variants; the warp variant takes fabrics whose every
# table has at most WARP_ROWS rows (8 per lane: csrc kRows), packing up to
# MAX_STREAMS streams into a CTA
VARIANTS = ("warp", "cta")
WARP_ROWS = 32 * 8
# the fire step's variants: one warp (node and arc tables of at most
# WARP_ROWS rows) or one CTA
STEP_VARIANTS = ("warp", "cta")
MAX_STREAMS = 4
# cycles per staged feed window (fewer when shared memory is short)
STAGE_CYCLES = 64


# ---------------------------------------------------------------------------
# Tables (numpy)
# ---------------------------------------------------------------------------
def plan_arrays(graph, optimize: bool = False):
    """Static numpy tables incl. arc adjacency (dummy node N = never
    ready; dummy slots pad).  With ``optimize=True`` the node table is
    opcode-bucketed (see ``_plan``) and ``class_slices`` records each
    class's row range; the dummy node rides as a trailing one-row SINK
    bucket so the specialized rule covers all N+1 rows."""
    p = _plan(graph, optimize=optimize)
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
    node_row = p["node_inv"]    # original node index -> plan row
    for i, n in enumerate(graph.nodes):
        for s, arc in enumerate(n.outputs):
            prod_node[p["aidx"][arc]] = node_row[i]
            prod_slot[p["aidx"][arc]] = s
        for s, arc in enumerate(n.inputs):
            if arc not in graph.consts:      # consts are never consumed
                cons_node[p["aidx"][arc]] = node_row[i]
                cons_slot[p["aidx"][arc]] = s
    const_mask = p["const_mask"].astype(np.int32)
    class_slices = None
    if p["class_slices"] is not None:
        class_slices = (*p["class_slices"], (int(Op.SINK), N, N + 1))
    return dict(opcode=opcode, in_idx=in_idx, out_idx=out_idx,
                prod_node=prod_node, prod_slot=prod_slot,
                cons_node=cons_node, cons_slot=cons_slot,
                const_mask=const_mask, plan=p, class_slices=class_slices)


def block_plan_arrays(graph, optimize: bool = False):
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
    t = plan_arrays(graph, optimize=optimize)
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


def reverse_maps(in_arc_idx, out_arc_idx, A2: int) -> dict:
    """The kernel's reverse maps, as CSR int32 arrays: the feed rows
    whose ``in_arc_idx`` is arc a are ``feed_rows[feed_ptr[a]:
    feed_ptr[a + 1]]`` (pad rows included), the output rows whose
    ``out_arc_idx`` is a are ``out_rows[out_ptr[a]:out_ptr[a + 1]]``;
    rows keep their order within an arc.  Every row appears once."""
    out = {}
    for tag, idx in (("feed", in_arc_idx), ("out", out_arc_idx)):
        idx = np.asarray(idx, np.int64)
        out[f"{tag}_ptr"] = np.concatenate(
            [[0], np.cumsum(np.bincount(idx, minlength=A2))]).astype(np.int32)
        out[f"{tag}_rows"] = np.argsort(idx, kind="stable").astype(np.int32)
    return out


def window_ints(chunk: int) -> int:
    """Ints of shared memory per staged feed row for ``chunk`` cycles:
    the chunk's tokens plus the slack of a start rounded down to 16
    bytes, in whole 16-byte pieces."""
    return 4 * (((chunk + 2) >> 2) + 1)


class FireTables(dict):
    """Device copies of the :data:`TABLE_KEYS` tables, bounds-checked on
    the host by :func:`device_tables` — the only tables the kernels
    take, since they index shared memory with their values — and the
    :data:`REVERSE_KEYS` maps of :func:`reverse_maps`.  An optimized
    plan adds ``class_table`` (int32 [n_classes, 3] rows of op, lo, hi),
    with ``class_slices`` (the same buckets as a tuple) and
    ``control_free`` (no NDMERGE/DMERGE/BRANCH bucket) as attributes.
    ``variant`` is the block kernel's variant for the fabric
    (:func:`block_variant`) and ``step_variant`` the fire step's
    (:func:`step_variant`); bit k of ``ops`` is set when some node has
    opcode k.  ``step_words`` holds the fire step's warp variant's packed
    tables (:func:`step_words`; None for a fabric too large for it), and
    ``step_args`` what every fire-step launch on a card passes for the
    tables, per variant, set once by :func:`check_step_tables`."""
    class_slices = None
    control_free = False
    variant = "cta"
    step_variant = "cta"
    ops = (1 << len(Op)) - 1
    step_words = None
    step_args = None


def block_variant(tables) -> str:
    """The block kernel's variant for numpy or device tables: ``"warp"``
    when the node, arc, feed and output tables each have at most
    :data:`WARP_ROWS` rows and no arc is strobed by two feed rows (true
    of every fabric's tables: only hand-made ones repeat an input arc),
    ``"cta"`` otherwise."""
    sizes = (len(tables["opcode"]), len(tables["prod_node"]),
             len(tables["in_arc_idx"]), len(tables["out_arc_idx"]))
    rows = np.bincount(np.asarray(tables["in_arc_idx"], np.int64).ravel(),
                       minlength=1)
    return "warp" if max(sizes) <= WARP_ROWS and rows.max() <= 1 else "cta"


def step_words(tables) -> dict:
    """The fire step's warp variant's packed tables, from numpy step
    tables of at most :data:`WARP_ROWS` rows (indices below 2^16): one
    16-byte word per node row and one 8-byte word per arc row, so a lane
    loads a row in one instruction:

      node [N2, 4]   x = in0 | in1 << 16, y = in2 | out0 << 16,
                     z = out1 | opcode << 16, w = 0
      arc [A2, 2]    x = prod_node | prod_slot << 16,
                     y = cons_node | cons_slot << 16 | const << 24"""
    i, o = tables["in_idx"], tables["out_idx"]
    node = np.stack([i[:, 0] | i[:, 1] << 16, i[:, 2] | o[:, 0] << 16,
                     o[:, 1] | tables["opcode"] << 16,
                     np.zeros_like(o[:, 1])], 1)
    arc = np.stack([tables["prod_node"] | tables["prod_slot"] << 16,
                    tables["cons_node"] | tables["cons_slot"] << 16
                    | (tables["const_mask"] > 0).astype(np.int32) << 24], 1)
    return dict(node=node.astype(np.int32), arc=arc.astype(np.int32))


def step_variant(tables) -> str:
    """The fire step's variant for numpy or device tables, by
    :func:`block_variant`'s size rule on the tables the step reads:
    ``"warp"`` when the node and arc tables each have at most
    :data:`WARP_ROWS` rows, ``"cta"`` otherwise."""
    sizes = (len(tables["opcode"]), len(tables["prod_node"]))
    return "warp" if max(sizes) <= WARP_ROWS else "cta"


def _class_slices(tables):
    """The opcode buckets of numpy or device tables (None: dense)."""
    if isinstance(tables, FireTables):
        return tables.class_slices
    return tables.get("class_slices")


def device_tables(tables, device) -> FireTables:
    """int32 tensors on ``device`` from :func:`block_plan_arrays` tables,
    after checking every index against the table sizes and, for an
    optimized plan, that the buckets are contiguous, cover rows
    0..N2 and hold their opcode on every row."""
    t = {k: np.asarray(tables[k], np.int32) for k in TABLE_KEYS}
    N2, A2 = t["opcode"].shape[0], t["prod_node"].shape[0]
    n_in = t["in_arc_idx"].shape[0]
    shapes = dict(opcode=(N2,), in_idx=(N2, 3), out_idx=(N2, 2),
                  in_arc_idx=(n_in,), out_arc_idx=(t["out_arc_idx"].size,))
    bounds = dict(in_idx=A2, out_idx=A2, prod_node=N2, prod_slot=2,
                  cons_node=N2, cons_slot=3, env_row=n_in + 1,
                  in_arc_idx=A2, out_arc_idx=A2, opcode=len(Op))
    for k, x in t.items():
        if x.shape != shapes.get(k, (A2,)):
            raise ValueError(f"table {k}: shape {x.shape}, want "
                             f"{shapes.get(k, (A2,))}")
        if k in bounds and x.size and (x.min() < 0 or x.max() >= bounds[k]):
            raise ValueError(f"table {k}: index outside [0, {bounds[k]})")
    cs = tables.get("class_slices")
    if cs is not None:
        cs = tuple((int(op), int(lo), int(hi)) for op, lo, hi in cs)
        if not 1 <= len(cs) <= MAX_CLASSES:
            raise ValueError(f"{len(cs)} opcode buckets, want 1.."
                             f"{MAX_CLASSES}")
        edge = 0
        for op, lo, hi in cs:
            if lo != edge or hi <= lo or not 0 <= op < len(Op):
                raise ValueError(f"bucket {(op, lo, hi)} does not follow "
                                 f"row {edge}")
            if (t["opcode"][lo:hi] != op).any():
                raise ValueError(f"bucket {(op, lo, hi)}: opcode differs "
                                 "on its rows")
            edge = hi
        if edge != N2:
            raise ValueError(f"buckets cover rows 0..{edge}, want 0..{N2}")
        t["class_table"] = np.asarray(cs, np.int32)
    t.update(reverse_maps(t["in_arc_idx"], t["out_arc_idx"], A2))
    out = FireTables({k: torch.tensor(x, device=device)
                      for k, x in t.items()})
    out.variant = block_variant(t)
    out.step_variant = step_variant(t)
    if out.step_variant == "warp":
        out.step_words = {k: torch.tensor(x, device=device)
                          for k, x in step_words(t).items()}
    out.ops = int(np.bitwise_or.reduce(1 << t["opcode"].astype(np.int64)))
    if cs is not None:
        out.class_slices = cs
        out.control_free = not any(op in _CTRL_OPS for op, _, _ in cs)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------
def _alu_op(op, a, b):
    """One ALU opcode on int32 operands, as the JAX package's ``_alu_op``
    computes it: wrapping arithmetic, shifts clipped to 0..31, floor
    division with x // 0 == 0 and INT_MIN // -1 == INT_MIN (divided by 1
    instead, as jnp wraps it); COPY, BRANCH and SINK pass ``a``."""
    op = Op(op)
    if op in (Op.COPY, Op.BRANCH, Op.SINK):
        return a
    if op == Op.ADD:
        return a + b
    if op == Op.SUB:
        return a - b
    if op == Op.MUL:
        return a * b
    if op == Op.DIV:
        odd = (b == 0) | ((a == _INT_MIN) & (b == -1))
        quot = torch.div(a, torch.where(odd, torch.ones_like(b), b),
                         rounding_mode="floor")
        return torch.where(b == 0, torch.zeros_like(a), quot)
    if op == Op.AND:
        return a & b
    if op == Op.OR:
        return a | b
    if op == Op.XOR:
        return a ^ b
    if op == Op.MAX:
        return torch.maximum(a, b)
    if op == Op.MIN:
        return torch.minimum(a, b)
    if op == Op.SHL:
        return torch.bitwise_left_shift(a, b.clamp(0, 31))
    if op == Op.SHR:
        return torch.bitwise_right_shift(a, b.clamp(0, 31))
    cmp = {Op.NOT: lambda: a == 0, Op.IFGT: lambda: a > b,
           Op.IFGE: lambda: a >= b, Op.IFLT: lambda: a < b,
           Op.IFLE: lambda: a <= b, Op.IFEQ: lambda: a == b,
           Op.IFDF: lambda: a != b}.get(op)
    if cmp is None:
        raise AssertionError(op)
    return cmp().to(a.dtype)


_ALU_OPS = tuple(op for op in Op if int(op) not in _CTRL_OPS
                 and op not in (Op.COPY, Op.SINK))


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

    zs = {op: _alu_op(op, a, b) for op in _ALU_OPS}
    zs[Op.NDMERGE] = torch.where(in0, a, b)
    zs[Op.DMERGE] = torch.where(ctrl3, a, b)
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


def _ready_and_z_spec(class_slices, in_idx, out_idx, full, val):
    """Opcode-class-specialized firing rule over a bucketed node table
    (the JAX package's ``_ready_and_z_spec``): each bucket computes its
    own opcode's result on its rows; control-free fabrics keep the
    ready/consume/produce masks as whole-array ops.  Same returns as
    :func:`_ready_and_z`, bit-identical to it on the same tables."""
    inf = full[..., in_idx] > 0                   # [..., N, 3]
    oute = full[..., out_idx] == 0                # [..., N, 2]
    a = val[..., in_idx[:, 0]]
    b = val[..., in_idx[:, 1]]
    all_in = inf.all(-1)
    all_out = oute.all(-1)
    base = all_in & all_out
    if not any(op in _CTRL_OPS for op, _, _ in class_slices):
        z = torch.cat([_alu_op(op, a[..., lo:hi], b[..., lo:hi])
                       for op, lo, hi in class_slices], -1)
        return (base, z, base[..., None] & torch.ones_like(inf),
                base[..., None] & torch.ones_like(oute))
    r_p, z_p, c_p, p_p = [], [], [], []
    for op, lo, hi in class_slices:
        ak, bk = a[..., lo:hi], b[..., lo:hi]
        infk, outek = inf[..., lo:hi, :], oute[..., lo:hi, :]
        i0, i1, i2 = infk.unbind(-1)
        if op == Op.NDMERGE:
            rk = (i0 | i1) & all_out[..., lo:hi]
            zk = torch.where(i0, ak, bk)
            ck = torch.stack([i0, ~i0, torch.zeros_like(i0)], -1)
            pk = torch.ones_like(outek)
        elif op == Op.DMERGE:
            c3 = val[..., in_idx[lo:hi, 2]] != 0
            rk = i2 & torch.where(c3, i0, i1) & all_out[..., lo:hi]
            zk = torch.where(c3, ak, bk)
            ck = torch.stack([c3, ~c3, torch.ones_like(c3)], -1)
            pk = torch.ones_like(outek)
        elif op == Op.BRANCH:
            c2 = bk != 0
            rk = i0 & i1 & torch.where(c2, outek[..., 0], outek[..., 1])
            zk = ak
            ck = torch.ones_like(infk)
            pk = torch.stack([c2, ~c2], -1)
        else:
            rk = base[..., lo:hi]
            zk = _alu_op(op, ak, bk)
            ck = torch.ones_like(infk)
            pk = torch.ones_like(outek)
        r_p.append(rk)
        z_p.append(zk)
        c_p.append(rk[..., None] & ck)
        p_p.append(rk[..., None] & pk)
    return (torch.cat(r_p, -1), torch.cat(z_p, -1), torch.cat(c_p, -2),
            torch.cat(p_p, -2))


def _fire_parts(tab, full, val, class_slices=None):
    """One fire step on [B, A2] registers: (full', val', ready[B, N2])."""
    if class_slices is None:
        ready, z, consume, produce = _ready_and_z(
            tab["opcode"], tab["in_idx"], tab["out_idx"], full, val)
    else:
        ready, z, consume, produce = _ready_and_z_spec(
            class_slices, tab["in_idx"], tab["out_idx"], full, val)
    # arc-side gather (single producer / single consumer per channel)
    produced = produce[:, tab["prod_node"], tab["prod_slot"]]
    consumed = consume[:, tab["cons_node"], tab["cons_slot"]]
    new_full = ((full > 0) & ~consumed) | produced | (tab["const_mask"] > 0)
    new_val = torch.where(produced, z[:, tab["prod_node"]], val)
    return new_full.to(full.dtype), new_val, ready


def _block_body(tab, feed_vals, feed_len, full, val, ptr, out_last,
                out_count, n_cycles: int, class_slices=None, prof=None):
    """``n_cycles`` engine cycles over B streams (every array has a
    leading B axis).  Returns the five state arrays, then fired[B] (node
    firings in this block) and last_prog[B], then — when ``prof`` (the
    five counter arrays) is given — the counters accumulated over the
    block."""
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
        if prof is not None:
            ir = _node_inputs_ready(tab["opcode"], tab["in_idx"], full, val)
        full, val, ready = _fire_parts(tab, full, val, class_slices)
        n_fired = ready.sum(1, dtype=torch.int32)
        if prof is not None:
            # occupancy sample point: post-fire, pre-drain
            nf, si, so, ab, ahw = prof
            occ = (full > 0).to(torch.int32)
            prof = (nf + ready.to(torch.int32), si + (~ir).to(torch.int32),
                    so + (ir & ~ready).to(torch.int32), ab + occ,
                    torch.maximum(ahw, occ))
        # 3. environment drains output buses
        got = full[:, tab["out_arc_idx"]] > 0
        out_last = torch.where(got, val[:, tab["out_arc_idx"]], out_last)
        out_count = out_count + got.to(out_count.dtype)
        full = torch.where(tab["out_mask"] > 0, torch.zeros_like(full), full)
        progress = can_feed.any(1) | (n_fired > 0) | got.any(1)
        fired = fired + n_fired
        last_prog = torch.where(progress, zero + (cyc + 1), last_prog)
    return (full, val, ptr, out_last, out_count, fired, last_prog,
            *(prof or ()))


def _long_tables(tables, device):
    return {k: torch.as_tensor(tables[k], device=device).long()
            for k in TABLE_KEYS if k in tables}


def fire_block_batched(tables, feed_vals, feed_len, full, val, ptr,
                       out_last, out_count, *, n_cycles: int, active=None,
                       prof=None):
    """Plain PyTorch batched block step: B streams through one fabric.

    feed_vals[B, n_in, L], feed_len[B, n_in], full/val[B, A2],
    ptr[B, n_in], out_last/out_count[B, n_out], all int32.  ``active``
    (int32[B], default all ones) is the per-stream clock gate: a stream
    with active == 0 keeps its state (counters included) and reports
    fired = last_prog = 0.  ``prof``: optional five counter arrays
    (nf/si/so [B, N2], ab/ahw [B, A2]).  Returns (full', val', ptr',
    out_last', out_count', fired[B, 1], last_prog[B, 1]), then the
    counters when ``prof`` is given.  Tables with ``class_slices`` take
    the specialized rule."""
    tab = _long_tables(tables, full.device)
    old = (full, val, ptr, out_last, out_count, *(prof or ()))
    res = _block_body(tab, feed_vals, feed_len, full, val, ptr, out_last,
                      out_count, n_cycles, _class_slices(tables), prof)
    state = res[:5] + res[7:]
    fired, lp = res[5], res[6]
    if active is not None:
        keep = active != 0
        state = tuple(torch.where(keep[:, None], n, o)
                      for n, o in zip(state, old))
        fired = torch.where(keep, fired, torch.zeros_like(fired))
        lp = torch.where(keep, lp, torch.zeros_like(lp))
    return (*state[:5], fired[:, None], lp[:, None], *state[5:])


def fire_block(tables, feed_vals, feed_len, full, val, ptr, out_last,
               out_count, *, n_cycles: int, prof=None):
    """Plain PyTorch single-stream block step: feed_vals[n_in, L],
    feed_len[n_in], full/val[A2], ptr[n_in], out_last/out_count[n_out],
    optional counters ``prof`` (nf/si/so [N2], ab/ahw [A2]).  Returns
    (full', val', ptr', out_last', out_count', fired[1], last_prog[1]),
    then the counters when ``prof`` is given."""
    res = fire_block_batched(
        tables, *(x[None] for x in (feed_vals, feed_len, full, val, ptr,
                                     out_last, out_count)),
        n_cycles=n_cycles,
        prof=None if prof is None else tuple(x[None] for x in prof))
    return (*(x[0] for x in res[:5]), res[5][0], res[6][0],
            *(x[0] for x in res[7:]))


# stands where the kernel's shared memory holds no token of the row
_STALE = -1234567


def _stage(fv_flat, mis, ptr, fl, rows, chunk, L, W):
    """The windows the kernel stages at a chunk's start, as the device
    copies them: for each feed row in ``rows`` [R] of each stream, the
    16-byte pieces (from ``fv_flat``, the streams' tokens behind ``mis``
    ints of a 16-byte boundary) holding fv[r, clamp(ptr) ..
    clamp(min(ptr + chunk, fl) - 1)]; returns windows [B, R, W] (other
    slots stale) and the offsets that map a clamped index to its slot."""
    B, n_in = fl.shape
    p = ptr[:, rows].long()
    hi = torch.minimum(p + chunk, fl[:, rows].long())
    a, e = p.clamp(0, L - 1), (hi - 1).clamp(0, L - 1)
    row = mis + (torch.arange(B, device=p.device)[:, None] * n_in
                 + rows[None]) * L
    start = (row + a) & ~3
    pieces = ((row + e - start) >> 2) + 1
    k = torch.arange(W, device=p.device)
    idx = start[..., None] + k
    held = (k < 4 * pieces[..., None]) & (hi > p)[..., None]
    win = torch.where(held, fv_flat[idx.clamp(0, fv_flat.numel() - 1)],
                      torch.full_like(idx, _STALE, dtype=fv_flat.dtype))
    return win, row + a - start - a


def fire_block_two_phase(tables, feed_vals, feed_len, full, val, ptr,
                         out_last, out_count, *, n_cycles: int, active=None,
                         prof=None, chunk: int = STAGE_CYCLES,
                         misalign: int = 0):
    """The batched block in the CUDA kernel's own order (plain PyTorch,
    for the tests and ``chip_smoke.py``; the main path runs
    :func:`fire_block_batched`).  Same arguments and results as
    :func:`fire_block_batched`; the results must be equal.  The order:

    * cycle 0's feed is a prologue; each cycle is a node phase (the fire
      rule, counted per lane) and an arc phase in which each arc, on its
      own lane, takes its next state, samples the counters, drains into
      its output rows and is cleared under ``out_mask``, then is strobed
      for the next cycle from its feed rows (the last cycle feeds
      nothing): arcs reach their rows through :func:`reverse_maps`;
    * ``fired`` and ``last_prog`` are kept per lane (row % 32) and
      reduced once at the end;
    * feed tokens are read from windows staged every ``chunk`` cycles
      as the kernel stages them (``misalign``: ints between the tokens'
      start and a 16-byte boundary); a token read outside its window
      would come back as a stale value."""
    dev = full.device
    tab = _long_tables(tables, dev)
    rev = {k: torch.as_tensor(np.asarray(v), device=dev).long() for k, v in
           reverse_maps(tab["in_arc_idx"].cpu().numpy(),
                        tab["out_arc_idx"].cpu().numpy(),
                        full.shape[1]).items()}
    B, A2 = full.shape
    n_in, L = feed_vals.shape[1], feed_vals.shape[2]
    N2 = tab["opcode"].shape[0]
    W = window_ints(chunk)
    lanes = 32
    arc_lane = torch.arange(A2, device=dev) % lanes
    node_lane = torch.arange(N2, device=dev) % lanes
    # the reverse maps: each feed row's arc, and whether it writes it
    row_arc = torch.repeat_interleave(
        torch.arange(A2, device=dev), rev["feed_ptr"].diff())
    rows = rev["feed_rows"]
    row_arc = torch.empty_like(rows).scatter_(0, rows, row_arc)
    writer = tab["env_row"][row_arc] == torch.arange(n_in, device=dev)
    wrows = torch.nonzero(writer).flatten()
    drained = rev["out_ptr"].diff() > 0
    out_arc = torch.repeat_interleave(
        torch.arange(A2, device=dev), rev["out_ptr"].diff())
    row_of_out = torch.empty_like(rev["out_rows"]).scatter_(
        0, rev["out_rows"], out_arc)

    old = (full, val, ptr, out_last, out_count, *(prof or ()))
    fv_flat = torch.cat([
        torch.full((misalign,), _STALE, dtype=feed_vals.dtype, device=dev),
        feed_vals.reshape(-1),
        torch.full((W + 8,), _STALE, dtype=feed_vals.dtype, device=dev)])
    cls = _class_slices(tables)
    fl = feed_len
    fired_l = torch.zeros((B, lanes), dtype=torch.int32, device=dev)
    lp_l = torch.zeros_like(fired_l)
    gots = torch.zeros_like(full)
    last = torch.zeros_like(val)

    def mark(lp, hit, lane_of, cyc):
        """last_prog = cyc on the lanes of the rows where ``hit``
        [B, rows] holds."""
        on = torch.zeros_like(lp).index_add(1, lane_of, hit.to(lp.dtype))
        return torch.where(on > 0, torch.full_like(lp, cyc), lp)

    def strobe(full, val, ptr, lp, win, wofs, cyc):
        """Every feed row strobes its arc from its window."""
        can = (full[:, row_arc] == 0) & (ptr < fl)
        hit = can[:, wrows]
        slot = wofs + ptr[:, wrows].long().clamp(0, L - 1)
        inside = (slot >= 0) & (slot < W)
        tok = torch.gather(win, 2, slot.clamp(0, W - 1)[..., None])[..., 0]
        tok = torch.where(inside, tok, torch.full_like(tok, _STALE))
        arcs = row_arc[wrows]
        val, full = val.clone(), full.clone()
        val[:, arcs] = torch.where(hit, tok, val[:, arcs])
        full[:, arcs] = torch.where(hit, torch.ones_like(tok),
                                    full[:, arcs])
        return (full, val, ptr + can.to(ptr.dtype),
                mark(lp, can, arc_lane[row_arc], cyc))

    if n_cycles > 0:
        win, wofs = _stage(fv_flat, misalign, ptr, fl, wrows, chunk, L, W)
        full, val, ptr, lp_l = strobe(full, val, ptr, lp_l, win, wofs, 1)
    for cyc in range(n_cycles):
        if cyc % chunk == chunk - 1 and cyc + 1 < n_cycles:
            win, wofs = _stage(fv_flat, misalign, ptr, fl, wrows, chunk, L,
                               W)
        # node phase
        if prof is not None:
            ir = _node_inputs_ready(tab["opcode"], tab["in_idx"], full, val)
        full_f, val_f, ready = _fire_parts(tab, full, val, cls)
        fired_l = fired_l.index_add(1, node_lane, ready.to(torch.int32))
        lp_l = mark(lp_l, ready, node_lane, cyc + 1)
        # arc phase: sample, drain, clear, strobe the next cycle
        full, val = full_f, val_f
        if prof is not None:
            nf, si, so, ab, ahw = prof
            occ = (full > 0).to(torch.int32)
            prof = (nf + ready.to(torch.int32), si + (~ir).to(torch.int32),
                    so + (ir & ~ready).to(torch.int32), ab + occ,
                    torch.maximum(ahw, occ))
        got = (full > 0) & drained
        gots = gots + got.to(gots.dtype)
        last = torch.where(got, val, last)
        lp_l = mark(lp_l, got, arc_lane, cyc + 1)
        full = torch.where(tab["out_mask"] > 0, torch.zeros_like(full), full)
        if cyc + 1 < n_cycles:
            full, val, ptr, lp_l = strobe(full, val, ptr, lp_l, win, wofs,
                                          cyc + 2)
    got_r = gots[:, row_of_out]
    out_count = out_count + got_r
    out_last = torch.where(got_r > 0, last[:, row_of_out], out_last)
    fired = fired_l.sum(1, dtype=torch.int32)
    lp = lp_l.amax(1)
    state = (full, val, ptr, out_last, out_count, *(prof or ()))
    if active is not None:
        keep = active != 0
        state = tuple(torch.where(keep[:, None], n, o)
                      for n, o in zip(state, old))
        fired = torch.where(keep, fired, torch.zeros_like(fired))
        lp = torch.where(keep, lp, torch.zeros_like(lp))
    return (*state[:5], fired[:, None], lp[:, None], *state[5:])


def fire_step(tables, full, val):
    """Plain PyTorch fire step, no environment: registers full/val[A2]
    -> (full', val', fired[1]).  Always the dense rule (as
    ``fire_step_pallas``)."""
    tab = _long_tables(tables, full.device)
    nf, nv, ready = _fire_parts(tab, full[None], val[None])
    return nf[0], nv[0], ready.sum(1, dtype=torch.int32)


def fire_step_warp_order(tables, full, val):
    """The fire step in its warp variant's order (plain PyTorch, for the
    tests and ``chip_smoke.py``; the main path runs :func:`fire_step`).
    Same arguments and results as :func:`fire_step`; the results must be
    equal.  Lane l owns node and arc rows l + 32 j.  The registers are
    read once, at entry: into the lanes' own arc rows and into shared
    memory.  The node phase takes each node's operands from shared memory
    and stores its (z, cp) pair (cp: consume bits 0-2, produce bits 3-4,
    0 when the node does not fire); the arc phase computes each arc from
    its own row's registers, its producer's pair and its consumer's cp
    word; ``fired`` sums the lanes' counts."""
    dev = full.device
    tab = _long_tables(tables, dev)
    N2, A2 = tab["opcode"].shape[0], tab["prod_node"].shape[0]
    lanes = 32
    s_fv = torch.stack([full, val])             # the single state load
    z = torch.zeros((N2,), dtype=val.dtype, device=dev)
    cp = torch.zeros((N2,), dtype=torch.int32, device=dev)
    fired = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    shift_c = torch.arange(3, device=dev)
    shift_p = torch.arange(3, 5, device=dev)
    for j in range(-(-N2 // lanes)):                # node phase
        n = torch.arange(lanes * j, min(lanes * (j + 1), N2), device=dev)
        ready, zj, cons, prod = _ready_and_z(
            tab["opcode"][n], tab["in_idx"][n], tab["out_idx"][n],
            s_fv[0][None], s_fv[1][None])
        z[n] = zj[0]
        cp[n] = ((cons[0].to(torch.int32) << shift_c).sum(-1)
                 + (prod[0].to(torch.int32) << shift_p).sum(-1)).int()
        fired = fired.index_add(0, n % lanes, ready[0].to(torch.int32))
    full_o, val_o = torch.empty_like(full), torch.empty_like(val)
    for j in range(-(-A2 // lanes)):                # arc phase
        i = torch.arange(lanes * j, min(lanes * (j + 1), A2), device=dev)
        pn, cn = tab["prod_node"][i], tab["cons_node"][i]
        produced = ((cp[pn] >> (3 + tab["prod_slot"][i])) & 1) > 0
        consumed = ((cp[cn] >> tab["cons_slot"][i]) & 1) > 0
        full_o[i] = (((full[i] > 0) & ~consumed) | produced
                     | (tab["const_mask"][i] > 0)).to(full.dtype)
        val_o[i] = torch.where(produced, z[pn], val[i])
    return full_o, val_o, fired.sum(0, keepdim=True, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _vp(x):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _device_and_stream(dev):
    """(device index, a context that makes it the current device, its
    current stream as a pointer) for a launch on ``dev``; the context is a
    no-op when it is current already."""
    cur = torch.cuda.current_device()
    index = cur if dev.index is None else dev.index
    ctx = contextlib.nullcontext() if index == cur \
        else torch.cuda.device(index)
    return index, ctx, ctypes.c_void_p(
        torch.cuda.current_stream(index).cuda_stream)


@functools.cache
def _smem_limit(device_index: int) -> int:
    """Shared memory one CTA may opt in to on that card, in bytes."""
    from repro_torch.kernels import _build
    return _build.load().fire_block_smem_limit(device_index)


def _check_tensors(named, dev):
    """Every tensor on ``dev``, int32 and contiguous."""
    for k, x in named:
        if x.device != dev:
            raise ValueError(f"{k} is on {x.device}, the state on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{k} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{k} must be contiguous")


def _check_smem(index, nbytes, what):
    if nbytes > _smem_limit(index):
        raise ValueError(f"{what} needs {nbytes} B of shared memory per "
                         f"CTA; the card gives {_smem_limit(index)}")


def launch_plan(variant, N2, A2, n_in, B, n_cycles, prof, smem_bytes,
                smem_limit):
    """How a block launch runs: (chunk, window ints per staged row,
    streams per CTA).  The chunk is
    :data:`STAGE_CYCLES` cycles (at most the block's), halved until the
    CTA's shared memory fits the card's ``smem_limit``; the warp variant
    packs up to :data:`MAX_STREAMS` streams into a CTA while two such
    CTAs fit an SM.  ``smem_bytes`` is the library's
    ``fire_block_smem_bytes``."""
    code = VARIANTS.index(variant)
    chunk = max(1, min(STAGE_CYCLES, n_cycles))
    while True:
        window = window_ints(chunk)
        per = smem_bytes(N2, A2, n_in, int(prof), code, window)
        if per <= smem_limit or chunk == 1:
            break
        chunk = (chunk + 1) // 2
    if per > smem_limit:
        raise ValueError(f"the fabric needs {per} B of shared memory per "
                         f"CTA; the card gives {smem_limit}")
    streams = 1
    if variant == "warp":
        streams = max(1, min(MAX_STREAMS, B, smem_limit // 2 // per))
    return chunk, window, streams


def _launch(tables, feed_vals, feed_len, state, active, prof, n_cycles,
            batched, variant=None, chunk=None):
    """Check the arguments and launch the fire-block kernel: the
    variant ``variant`` (default the tables' own, from the fabric's
    size), the profiled instantiation when ``prof`` is given, the
    specialized one when the tables carry opcode buckets; feed windows
    staged every ``chunk`` cycles (default :func:`launch_plan`'s).
    Returns the freshly allocated outputs."""
    from repro_torch.kernels import _build
    if not isinstance(tables, FireTables):
        raise TypeError("the kernel takes tables from device_tables() only")
    if n_cycles < 0:
        raise ValueError(f"n_cycles must be >= 0, got {n_cycles}")
    variant = tables.variant if variant is None else variant
    if variant not in VARIANTS or (variant == "warp"
                                   and tables.variant != "warp"):
        raise ValueError(f"variant {variant!r} cannot run this fabric "
                         f"(its tables take {tables.variant!r})")
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
    prof_names = ("nf", "si", "so", "ab", "ahw")
    if prof is not None:
        if len(prof) != 5:
            raise ValueError(f"prof holds {len(prof)} arrays, want 5")
        for k, n in zip(prof_names, (N2, N2, N2, A2, A2)):
            want[k] = (*lead, n)
    args = dict(zip(want, (feed_vals, feed_len, *state,
                           *([active] if active is not None else []),
                           *(prof or ()))))
    _check_tensors((*args.items(), *tables.items()), dev)
    for k, shape in want.items():
        if tuple(args[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(args[k].shape)}, want "
                             f"{shape}")
    if B < 1 or L < 1:
        raise ValueError("the kernel needs B >= 1 and L >= 1")
    lib = _build.load()
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    plan_chunk, window, streams = launch_plan(
        variant, N2, A2, n_in, B, n_cycles, prof is not None,
        lib.fire_block_smem_bytes, _smem_limit(index))
    if chunk is not None:
        if not 1 <= chunk <= plan_chunk:
            raise ValueError(f"chunk must be in [1, {plan_chunk}], got "
                             f"{chunk}")
        window = window_ints(chunk)
    cls = tables.get("class_table")
    with torch.cuda.device(index):
        outs = [torch.empty_like(x) for x in state]
        fired = torch.empty((*lead, 1), dtype=torch.int32, device=dev)
        last_prog = torch.empty_like(fired)
        prof_out = [torch.empty_like(x) for x in prof or ()]
        none5 = [None] * 5
        err = lib.fire_block_launch(
            *(_vp(tables[k]) for k in TABLE_KEYS), _vp(cls),
            *(_vp(tables[k]) for k in REVERSE_KEYS),
            _vp(feed_vals), _vp(feed_len), *(_vp(x) for x in state),
            _vp(active), *(_vp(x) for x in prof or none5),
            *(_vp(x) for x in outs), _vp(fired), _vp(last_prog),
            *(_vp(x) for x in prof_out or none5),
            B, N2, A2, n_in, n_out, L, int(n_cycles),
            0 if cls is None else cls.shape[0], int(tables.control_free),
            tables.ops, VARIANTS.index(variant),
            chunk or plan_chunk, window, streams,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError("fire_block kernel launch failed: "
                           + lib.fire_block_error_string(err).decode())
    return (*outs, fired, last_prog, *prof_out)


def launch_variant(variant, tables, feed_vals, feed_len, full, val, ptr,
                   out_last, out_count, *, n_cycles: int, active=None,
                   prof=None, chunk=None, batched=True):
    """One launch of the block kernel's ``variant`` (``"warp"`` only for
    tables that take it) with feed windows staged every ``chunk`` cycles,
    on CUDA tensors, counted nowhere: the tests and ``chip_smoke.py``
    hold each variant against the plain versions and the other variant
    with it.  Arguments and results as :func:`fire_block_batched_cuda`
    (``batched=False``: :func:`fire_block_cuda`'s)."""
    return _launch(tables, feed_vals, feed_len,
                   (full, val, ptr, out_last, out_count), active, prof,
                   n_cycles, batched, variant, chunk)


def _on_cpu(*xs) -> bool:
    devs = {x.device.type for x in xs if x is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed devices {sorted(devs)}")


def _count(wrapper, tables, prof):
    """One launch on ``wrapper``'s counts: ``prof_launches`` for the
    profiled instantiation, else ``launches``; ``spec_launches`` also
    counts those of the specialized rule, and ``launches_by`` each
    launch under its variant."""
    if prof is None:
        wrapper.launches += 1
    else:
        wrapper.prof_launches += 1
    if tables.class_slices is not None:
        wrapper.spec_launches += 1
    wrapper.launches_by[tables.variant] += 1


def fire_block_cuda(tables, feed_vals, feed_len, full, val, ptr, out_last,
                    out_count, *, n_cycles: int, prof=None):
    """Single-stream block step (the counterpart of ``fire_block_pallas``,
    with ``prof`` of its profiled form).  CUDA tensors launch the kernel
    with B = 1 and count the launch (see :func:`_count`); CPU tensors
    take :func:`fire_block`."""
    state = (full, val, ptr, out_last, out_count)
    if _on_cpu(feed_vals, feed_len, *state, *(prof or ())):
        return fire_block(tables, feed_vals, feed_len, *state,
                          n_cycles=n_cycles, prof=prof)
    out = _launch(tables, feed_vals, feed_len, state, None, prof, n_cycles,
                  batched=False)
    _count(fire_block_cuda, tables, prof)
    return out


def fire_block_batched_cuda(tables, feed_vals, feed_len, full, val, ptr,
                            out_last, out_count, *, n_cycles: int,
                            active=None, prof=None):
    """Batched block step (the counterpart of
    ``fire_block_batched_pallas``, with ``prof`` of its profiled form):
    one warp (or, for a large fabric, one CTA) per stream, parked
    streams (active == 0) pass their state and counters through.  CUDA tensors launch the kernel and count the
    launch (see :func:`_count`); CPU tensors take
    :func:`fire_block_batched`."""
    state = (full, val, ptr, out_last, out_count)
    if _on_cpu(feed_vals, feed_len, *state, active, *(prof or ())):
        return fire_block_batched(tables, feed_vals, feed_len, *state,
                                  n_cycles=n_cycles, active=active,
                                  prof=prof)
    out = _launch(tables, feed_vals, feed_len, state, active, prof,
                  n_cycles, batched=True)
    _count(fire_block_batched_cuda, tables, prof)
    return out


def check_step_tables(tables) -> FireTables:
    """Check, once per upload, what every fire-step launch on ``tables``
    (:func:`device_tables` on a card) relies on: the step's eight tables
    int32, contiguous and on one card and, for the CTA variant, the
    shared memory of the fabric's registers.  Records the pointers the
    launches pass for the tables in ``tables.step_args`` (per variant:
    the eight tables for the CTA one, the packed words for the warp one).
    ``ops.make_fire_step`` calls it when it builds the tables, the first
    launch on other tables.  Returns the tables."""
    from repro_torch.kernels import _build
    if not isinstance(tables, FireTables):
        raise TypeError("the kernel takes tables from device_tables() only")
    dev = tables["opcode"].device
    if dev.type != "cuda":
        raise ValueError(f"the fire-step kernels take tables on a card, "
                         f"not on {dev}")
    _check_tensors(((k, tables[k]) for k in STEP_KEYS), dev)
    if tables.step_variant == "cta":
        N2, A2 = tables["opcode"].shape[0], tables["prod_node"].shape[0]
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        _check_smem(index, _build.load().fire_block_smem_bytes(
            N2, A2, 0, 0, 2, 0), "the fabric")
    args = dict(cta=[_vp(tables[k]) for k in STEP_KEYS])
    if tables.step_words is not None:
        args["warp"] = [_vp(tables.step_words[k]) for k in ("node", "arc")]
    tables.step_args = args
    return tables


def _launch_step(variant, tables, full, val):
    """Check ``full``/``val`` and launch the fire step's ``variant``
    (None: the tables' own; the tables checked once,
    :func:`check_step_tables`).  Returns (full', val', fired[1]), views
    of one fresh allocation."""
    from repro_torch.kernels import _build
    if not isinstance(tables, FireTables):
        raise TypeError("the kernel takes tables from device_tables() only")
    variant = tables.step_variant if variant is None else variant
    if variant not in STEP_VARIANTS or (variant == "warp"
                                        and tables.step_variant != "warp"):
        raise ValueError(f"fire-step variant {variant!r} cannot run this "
                         f"fabric (its tables take {tables.step_variant!r})")
    if tables.step_args is None:
        check_step_tables(tables)
    dev = tables["opcode"].device
    N2, A2 = tables["opcode"].shape[0], tables["prod_node"].shape[0]
    _check_tensors((("full", full), ("val", val)), dev)
    for k, x in (("full", full), ("val", val)):
        if tuple(x.shape) != (A2,):
            raise ValueError(f"{k}: shape {tuple(x.shape)}, want {(A2,)}")
    lib = _build.load()
    _, on_device, stream = _device_and_stream(dev)
    with on_device:
        out = torch.empty((2 * A2 + 1,), dtype=torch.int32, device=dev)
        full_o, val_o, fired = out[:A2], out[A2:2 * A2], out[2 * A2:]
        ptrs = (*tables.step_args[variant], _vp(full), _vp(val),
                _vp(full_o), _vp(val_o), _vp(fired))
        if variant == "warp":
            err = lib.fire_step_warp_launch(*ptrs, N2, A2, tables.ops,
                                            stream)
        else:
            err = lib.fire_step_launch(*ptrs, N2, A2, stream)
    if err:
        raise RuntimeError(f"fire_step kernel launch ({variant} variant) "
                           "failed: " + lib.fire_block_error_string(err)
                           .decode())
    return full_o, val_o, fired


def fire_step_cuda(tables, full, val):
    """One fire step, no environment (the counterpart of
    ``fire_step_pallas``): full/val[A2] -> (full', val', fired[1]).
    CUDA tensors launch the tables' variant (:func:`step_variant`: one
    warp, or one CTA for a large fabric) and count it in
    ``fire_step_cuda.launches`` and ``launches_by``; CPU tensors take
    :func:`fire_step`."""
    if _on_cpu(full, val):
        return fire_step(tables, full, val)
    out = _launch_step(None, tables, full, val)
    fire_step_cuda.launches += 1
    fire_step_cuda.launches_by[tables.step_variant] += 1
    return out


def launch_step_variant(variant, tables, full, val):
    """One launch of the fire step's ``variant`` (``"warp"`` only for
    tables that take it) on CUDA tensors, counted nowhere: the tests and
    ``chip_smoke.py`` hold each variant against the plain versions with
    it.  Arguments and results as :func:`fire_step_cuda`."""
    return _launch_step(variant, tables, full, val)


for _w in (fire_block_cuda, fire_block_batched_cuda):
    _w.launches = _w.prof_launches = _w.spec_launches = 0
    _w.launches_by = dict.fromkeys(VARIANTS, 0)
fire_step_cuda.launches = 0
fire_step_cuda.launches_by = dict.fromkeys(STEP_VARIANTS, 0)
