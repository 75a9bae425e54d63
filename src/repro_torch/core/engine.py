"""Static dataflow token engine (PyTorch port of ``repro.core.engine``).

Cycle-accurate reproduction of the paper's fabric:

* every arc is a register pair ``(full, value)`` — the 16-bit data
  register + 1-bit status register of paper Fig. 5;
* a node *fires* when all its input arcs are full and all its output
  arcs are empty (static dataflow: one token per arc);
* one engine cycle = every ready node fires simultaneously;
* environment buses: *input* arcs are strobed with the next token of
  their feed stream as soon as they drain; *const* arcs always present
  their value; *output* arcs are drained every cycle, with the last
  value and a token count recorded.

Backends:

* ``"cuda"`` (default) — a host loop over fused K-cycle blocks, each
  block one launch of the fire-block kernel
  (:mod:`repro_torch.kernels.dataflow_fire`); with ``device="cpu"`` the
  same loop runs the kernel's plain PyTorch version.  Scalar int32
  tokens.
* ``"torch"`` — the cycle body as PyTorch tensor code (the counterpart of
  the JAX package's ``"xla"`` backend): int32, uint32 or float32 tokens
  of any shape, a host loop over K-cycle blocks with one read of the
  progress flags per block.
* ``"reference"`` — :func:`run_reference`, the pure-numpy oracle.

Non-determinism note: ``ndmerge`` resolves same-cycle arrivals with a
fixed priority (input ``a`` wins).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.graph import Graph, Op

_MAX_IN = 3
_MAX_OUT = 2

# -- _plan memoization ------------------------------------------------------
# The plan depends only on the graph's asm signature and the optimize
# flag, so one process-wide LRU serves every engine and reference run of
# the same fabric.  The cached arrays are frozen read-only: sharing is
# safe because no consumer mutates a plan.
_PLAN_CACHE: collections.OrderedDict = collections.OrderedDict()
_PLAN_CACHE_MAX = 256


def _plan(graph: Graph, optimize: bool = False):
    """Memoized :func:`_plan_build` keyed on (asm signature, optimize):
    the signature is the full text (nodes, consts, inits), so a mutated
    Graph re-keys automatically."""
    from repro_torch.core import asm
    sig = hashlib.sha256(asm.emit(graph).encode()).hexdigest()
    key = (sig, bool(optimize))
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        _PLAN_CACHE.move_to_end(key)
        return hit
    p = _plan_build(graph, optimize)
    for v in p.values():
        if isinstance(v, np.ndarray):
            v.flags.writeable = False
    _PLAN_CACHE[key] = p
    if len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return p


def _plan_build(graph: Graph, optimize: bool = False):
    """Static (numpy) arrays describing the fabric: arc slots A (+ an
    always-full FULL_PAD and an always-empty EMPTY_PAD slot padding
    missing inputs and outputs) and the node table opcode[N],
    in_idx[N,3], out_idx[N,2].

    With ``optimize=True`` the plan is *opcode-class specialized*: arcs
    are permuted into role order (inputs, outputs, internal, consts)
    and nodes are stable-sorted by opcode, with each class's row range
    recorded in ``class_slices`` — the fire rule can then evaluate one
    opcode per bucket instead of the whole ALU for every node.  The
    permutation is pure layout, so results are bit-identical to the
    unoptimized plan.  ``node_perm``/``arc_perm`` map plan row ->
    original index and ``node_inv``/``arc_inv`` are the inverses."""
    graph.validate()
    arcs = graph.arcs
    input_arcs = graph.input_arcs()
    output_arcs = graph.output_arcs()
    if optimize:
        # environment buses first (inputs, then outputs), then internal
        # arcs, then consts
        ordered: dict[str, None] = {}
        for a in (*input_arcs, *output_arcs):
            ordered.setdefault(a, None)
        for a in arcs:
            if a not in graph.consts:
                ordered.setdefault(a, None)
        for a in arcs:
            ordered.setdefault(a, None)
        old_pos = {a: i for i, a in enumerate(arcs)}
        arcs = list(ordered)
        arc_perm = np.asarray([old_pos[a] for a in arcs], np.int32)
    else:
        arc_perm = np.arange(len(arcs), dtype=np.int32)
    arc_inv = np.empty_like(arc_perm)
    arc_inv[arc_perm] = np.arange(len(arcs), dtype=np.int32)
    aidx = {a: i for i, a in enumerate(arcs)}
    A = len(arcs)
    FULL_PAD = A        # dummy slot, always full (pads missing inputs)
    EMPTY_PAD = A + 1   # dummy slot, always empty (pads missing outputs)

    N = len(graph.nodes)
    opcode = np.zeros((N,), np.int32)
    in_idx = np.full((N, _MAX_IN), FULL_PAD, np.int32)
    out_idx = np.full((N, _MAX_OUT), EMPTY_PAD, np.int32)
    for i, n in enumerate(graph.nodes):
        opcode[i] = int(n.op)
        for k, a in enumerate(n.inputs):
            in_idx[i, k] = aidx[a]
        for k, a in enumerate(n.outputs):
            out_idx[i, k] = aidx[a]

    if optimize:
        node_perm = np.argsort(opcode, kind="stable").astype(np.int32)
        opcode = opcode[node_perm]
        in_idx = in_idx[node_perm]
        out_idx = out_idx[node_perm]
        class_slices = []
        s = 0
        while s < N:
            e = s
            while e < N and opcode[e] == opcode[s]:
                e += 1
            class_slices.append((int(opcode[s]), s, e))
            s = e
        class_slices = tuple(class_slices) or None
    else:
        node_perm = np.arange(N, dtype=np.int32)
        class_slices = None
    node_inv = np.empty_like(node_perm)
    node_inv[node_perm] = np.arange(N, dtype=np.int32)

    const_mask = np.zeros((A + 2,), bool)
    for a in graph.consts:
        const_mask[aidx[a]] = True

    return dict(
        arcs=arcs, aidx=aidx, A=A, FULL_PAD=FULL_PAD, EMPTY_PAD=EMPTY_PAD,
        opcode=opcode, in_idx=in_idx, out_idx=out_idx,
        const_mask=const_mask, input_arcs=input_arcs,
        output_arcs=output_arcs, class_slices=class_slices,
        node_perm=node_perm, node_inv=node_inv,
        arc_perm=arc_perm, arc_inv=arc_inv,
    )


def _node_inputs_ready(opcode, in_idx, full, val):
    """Per-node "all (selected) inputs present" on registers
    ``full``/``val`` [..., A2] — the stall-attribution predicate of the
    profile counters.  The fire rule implies it, so every profiled cycle
    puts each node in exactly one of fired / stalled on input
    (``~inputs_ready``) / stalled on output (``inputs_ready & ~ready``).
    BRANCH takes the generic all-inputs reduction (its third input is
    the always-full pad)."""
    inf = full[..., in_idx] > 0                  # [..., N, 3]
    in0, in1, in2 = inf.unbind(-1)
    ctrl3 = val[..., in_idx[:, 2]] != 0
    ir = inf.all(-1)
    ir = torch.where(opcode == int(Op.NDMERGE), in0 | in1, ir)
    return torch.where(opcode == int(Op.DMERGE),
                       in2 & torch.where(ctrl3, in0, in1), ir)


def _prof_zeros(n_nodes: int, n_arcs: int, batch: int | None = None,
                device="cpu"):
    """Fresh profile counters (nf, si, so, ab, ahw): int32 tensors over
    the kernel tables' node rows (dummy row included) and arc slots."""
    shp = () if batch is None else (batch,)
    z = lambda n: torch.zeros((*shp, n), dtype=torch.int32, device=device)
    return (z(n_nodes), z(n_nodes), z(n_nodes), z(n_arcs), z(n_arcs))


# ---------------------------------------------------------------------------
# Token dtypes and the torch ALU (the "torch" backend's and compile's)
# ---------------------------------------------------------------------------
# uint32 tokens ride in int64 tensors holding 0 .. 2^32 - 1: CPU torch
# raises on +, >>, maximum, //, % and < of torch.uint32, and nothing may
# rest on its arithmetic on the card either.  ADD, SUB, MUL and SHL mask
# their results to 32 bits; SHR is then logical and DIV, the compares and
# MAX/MIN unsigned, as for uint32.
TOKEN_DTYPES = ("int32", "uint32", "float32")
_CARRIER = {"int32": torch.int32, "uint32": torch.int64,
            "float32": torch.float32}
_U32 = 0xFFFFFFFF
_CMP = {Op.IFGT: torch.gt, Op.IFGE: torch.ge, Op.IFLT: torch.lt,
        Op.IFLE: torch.le, Op.IFEQ: torch.eq, Op.IFDF: torch.ne}


def token_dtype(dtype) -> np.dtype:
    """The numpy dtype of a fabric's tokens (numpy, string or torch
    dtypes accepted); one of :data:`TOKEN_DTYPES`."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    dt = np.dtype(dtype)
    if dt.name not in TOKEN_DTYPES:
        raise ValueError(f"token dtype {dt.name} not in {TOKEN_DTYPES}")
    return dt


def to_carrier(x, dtype, device) -> torch.Tensor:
    """Tokens of ``dtype`` (numpy, or a tensor already in the carrier's
    values) as a carrier tensor on ``device``."""
    dt = token_dtype(dtype)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_CARRIER[dt.name])
    x = np.asarray(x, dt)
    if dt.name == "uint32":
        x = x.astype(np.int64)
    return torch.as_tensor(x, device=device)


def from_carrier(t: torch.Tensor, dtype) -> np.ndarray:
    """A carrier tensor back as numpy tokens of ``dtype``."""
    return t.cpu().numpy().astype(token_dtype(dtype), copy=False)


def _alu_op(op, a, b, dtype):
    """One opcode's result on carrier tensors ``a``, ``b`` of tokens of
    ``dtype`` — the formulas of the JAX package's ``_alu_op`` and of
    :func:`alu_numpy`, bit for bit, with two rules torch needs spelled
    out: float MAX/MIN keep the signed-zero tie of the JAX ALUs
    (max(+0., -0.) is +0. and min is -0. in either order, where
    ``torch.maximum`` keeps the second operand's zero), and uint32 wraps
    by hand in its int64 carrier.  int32 DIV by -1 is a negation, so the
    INT_MIN // -1 wrap never reaches a hardware divide; float SHL/SHR
    take 2 ** b exactly at integral b (:func:`_exp2`)."""
    kind = np.dtype(dtype).name
    if op in (Op.COPY, Op.BRANCH, Op.SINK):
        return a
    if op == Op.NOT:
        return (a == 0).to(a.dtype)
    if op in _CMP:
        return _CMP[op](a, b).to(a.dtype)
    if kind == "float32":
        if op == Op.ADD:
            return a + b
        if op == Op.SUB:
            return a - b
        if op == Op.MUL:
            return a * b
        if op == Op.DIV:
            zero = b == 0
            return torch.where(zero, 0.0, a / torch.where(zero, 1.0, b))
        if op in (Op.AND, Op.OR, Op.XOR):
            f = {Op.AND: torch.logical_and, Op.OR: torch.logical_or,
                 Op.XOR: torch.logical_xor}[op]
            return f(a != 0, b != 0).to(a.dtype)
        if op == Op.MAX:
            return torch.where((a == 0) & (b == 0), a + b,
                               torch.maximum(a, b))
        if op == Op.MIN:
            return torch.where((a == 0) & (b == 0), -(-a + -b),
                               torch.minimum(a, b))
        if op == Op.SHL:
            return a * _exp2(b)
        if op == Op.SHR:
            two_b = _exp2(b)
            return a / torch.where(two_b == 0, 1.0, two_b)
        raise AssertionError(op)
    u32 = kind == "uint32"
    if op == Op.ADD:
        return (a + b) & _U32 if u32 else a + b
    if op == Op.SUB:
        return (a - b) & _U32 if u32 else a - b
    if op == Op.MUL:
        if not u32:
            return a * b
        # a * b mod 2^32 from 16-bit halves of a: every product < 2^49
        return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _U32
    if op == Op.DIV:
        if u32:
            zero = b == 0
            return torch.where(zero, 0, a // torch.where(zero, 1, b))
        q = a // torch.where((b == 0) | (b == -1), 1, b)
        return torch.where(b == 0, 0, torch.where(b == -1, -a, q))
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
        s = a << b.clamp(0, 31)
        return s & _U32 if u32 else s
    if op == Op.SHR:
        return a >> b.clamp(0, 31)
    raise AssertionError(op)


def _exp2(b):
    """2 ** b for float32 ``b``: built from its bits at every finite
    integral ``b`` (exactly numpy's ``exp2`` there, from -149 to 126;
    ``torch.exp2`` on the card is not exact at every integer), and
    ``torch.exp2`` at the others (ROADMAP C8)."""
    e = b.clamp(-150, 128).to(torch.int32)
    one = torch.ones_like(e)
    bits = torch.where(e >= -126, (e + 127).clamp(1, 254) << 23,
                       torch.where(e >= -149, one << (e + 149).clamp(0, 22),
                                   0))
    bits = torch.where(e >= 128, 0x7F800000, bits)
    whole = torch.isfinite(b) & (b == torch.round(b))
    return torch.where(whole, bits.view(torch.float32), torch.exp2(b))


def _alu(a, b, dtype, ops=tuple(Op)) -> dict:
    """Every value opcode's result among ``ops`` (the generic fire rule
    selects one per node)."""
    return {op: _alu_op(op, a, b, dtype) for op in ops
            if op not in (Op.DMERGE, Op.NDMERGE)}


def _truthy(v, nts: int):
    """Truth of control tokens ``v`` [..., *token_shape]: element 0."""
    if nts:
        v = v.reshape(*v.shape[:v.dim() - nts], -1)[..., 0]
    return v != 0


def _expand(mask, nts: int):
    return mask.reshape(*mask.shape, *([1] * nts))


@dataclasses.dataclass
class EngineResult:
    outputs: dict       # arc -> last token value (numpy scalar)
    counts: dict        # arc -> number of tokens drained
    cycles: int
    fired: int          # total node firings
    dispatches: int | None = None   # kernel launches (blocks) ridden;
                                    # on "torch" 1 a run of the loop
    node_fires: np.ndarray | None = None  # int64[N] per-node firings in
                                          # graph order (profile=True;
                                          # sums exactly to `fired`)
    profile: object | None = None   # FabricProfile (profile=True)


@dataclasses.dataclass
class SlotState:
    """Resumable state of B fabric *slots* (continuous batching).

    A slot is one stream's worth of arc registers, feed pointers, and
    output accumulators riding the shared fabric.  Slots have
    independent lifecycles: a quiesced slot can be harvested and
    refilled with a new request's feed stream while the other slots
    keep running — see
    :class:`repro_torch.serve.dataflow_server.DataflowServer`.

    Device tensors (int32; leading axis = B slots):
      fv[B, n_in, L], fl[B, n_in]   packed feed streams (L grows on
                                    demand, power-of-two)
      full/val[B, A2]               arc registers
      ptr[B, n_in]                  per-arc feed pointers
      out_last/out_count[B, n_out]  output-bus accumulators
      active_dev[B]                 device mirror of ``active``
                                    (refreshed on admission/harvest)

    Host arrays (numpy; the per-slot clock):
      active[B]     1 while a request occupies the slot (gates the
                    kernel's feed/fire/drain — inactive slots are
                    skipped, not stepped)
      base[B]       slot-local cycles simulated so far
      last[B]       slot-local cycle of last progress
      fired[B]      node firings of the resident request
      quiesced[B]   latest block had an idle tail (idle is absorbing,
                    so the resident request is finished)
      dispatches[B] block launches the resident request has ridden
      cap[B]        per-slot cycle cap (engine max_cycles unless the
                    admission overrode it via ``reset_slots(caps=)``)
      stalled[B]    consecutive blocks with zero progress while the
                    slot stayed active — the stall watchdog's counter

    Profiling (engine profile=True only; None otherwise):
      prof          tuple of the 5 counter tensors (node_fires,
                    stall_in, stall_out [B, N2]; arc_busy, arc_hw
                    [B, A2]; plan order) accumulated inside the kernel
                    alongside the block step — no extra launches
      prof_cycles[B] host tally of the cycles the resident request's
                    slot was simulated for (its profiled-cycle count)

    Scheduled engines (``schedule=``) carry no device counters:
      sched         :class:`~repro_torch.core.schedule.SlotSched` — each
                    slot's plan and schedule position, and (profiled) the
                    counters accrued on the host from the plan

    Partitioned engines (``partition=``, P > 1): ``full``/``val`` and the
    counters are the regions' flat register file ([B, P*A2m], node rows
    [B, P*N2m]; see :mod:`repro_torch.core.multifabric`), and
      mf            dict of the channel registers ``chf``/``chv`` [B, Cp]
                    and (profiled) the three channel counters ``chprof``
    """
    fv: torch.Tensor
    fl: torch.Tensor
    full: torch.Tensor
    val: torch.Tensor
    ptr: torch.Tensor
    out_last: torch.Tensor
    out_count: torch.Tensor
    active: np.ndarray
    base: np.ndarray
    last: np.ndarray
    fired: np.ndarray
    quiesced: np.ndarray
    dispatches: np.ndarray
    cap: np.ndarray
    stalled: np.ndarray
    active_dev: torch.Tensor
    prof: tuple | None = None
    prof_cycles: np.ndarray | None = None
    sched: object = None
    mf: dict | None = None

    @property
    def slots(self) -> int:
        return int(self.active.shape[0])

    def free_slots(self) -> list[int]:
        return [b for b in range(self.slots) if not self.active[b]]

    def quiesced_slots(self) -> list[int]:
        return [b for b in range(self.slots)
                if self.active[b] and self.quiesced[b]]


def pack_feeds(input_arcs, feeds, token_shape=(), dtype=np.int32,
               pad_rows: int | None = None, min_len: int = 1):
    """Dense (feed_vals[n_in, L, *ts], feed_len[n_in]) from an arc->stream
    mapping.  pad_rows forces at least that many stream rows (the kernel
    wants n_in >= 1); min_len floors L (so a stream axis always
    exists)."""
    feeds = dict(feeds or {})
    unknown = set(feeds) - set(input_arcs)
    if unknown:
        raise ValueError(f"feeds for non-input arcs: {sorted(unknown)}")
    ts = tuple(token_shape)
    n_in = max(len(input_arcs), pad_rows or 0)
    max_len = max((np.shape(v)[0] for v in feeds.values()), default=0)
    max_len = max(max_len, min_len)
    feed_vals = np.zeros((n_in, max_len, *ts), dtype)
    feed_len = np.zeros((n_in,), np.int32)
    for k, a in enumerate(input_arcs):
        if a in feeds:
            v = np.asarray(feeds[a], dtype)
            if v.shape[1:] != ts:
                v = np.broadcast_to(
                    v.reshape(v.shape[0], *([1] * len(ts))),
                    (v.shape[0], *ts)).astype(dtype)
            feed_vals[k, :v.shape[0]] = v
            feed_len[k] = v.shape[0]
    return feed_vals, feed_len


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a missing card is an error,
    never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; "
            "pass device=\"cpu\" to run the plain PyTorch versions of the "
            "kernels on the CPU")
    return dev


BACKENDS = ("torch", "cuda", "reference")


class DataflowEngine:
    """Cycle-accurate executor for a static dataflow :class:`Graph`.

    backend:
      * ``"cuda"``      — the fused fire-block kernel: K cycles +
        environment feed/drain per launch, arc registers in shared
        memory within a block.  Batched runs launch one CTA per stream.
        With ``device="cpu"`` the blocks run the kernel's plain PyTorch
        version instead.  Scalar int32 tokens only: anything else
        raises (never a quiet move to ``"torch"``).
      * ``"torch"``     — the cycle body as PyTorch tensor code, the
        counterpart of the JAX package's ``"xla"`` backend: tokens of
        any ``token_shape`` and of ``dtype`` int32, uint32 or float32.
        A host loop runs K-cycle blocks and reads the progress flags
        once per block; ``run_batch`` carries all B streams in one
        batched state and freezes each stream from the block its own
        loop condition fails, so every result (profile included) equals
        that stream's solo run.  ``dispatches`` counts runs of the block
        loop (1 per result, as ``"xla"`` counts its one dispatch), not
        kernel launches.  The resumable slot API is not offered.
      * ``"reference"`` — the pure-numpy oracle (:func:`run_reference`).

    ``token_shape`` and ``dtype`` are keyword arguments after the others,
    so that every positional call keeps its meaning; the JAX package
    takes them second and third.

    ``partition`` (None, an int P, ``"auto"`` or a
    :class:`~repro_torch.core.partition.Partition`; keyword-only, last)
    shards the fabric into P regions that run in lockstep through token
    channels (:mod:`repro_torch.core.multifabric`): on ``"cuda"`` each
    block is one launch of the sharded block kernel, on ``"torch"`` the
    stacked PyTorch program; every result field stays the solo fabric's.
    P = 1 is the solo engine.  Scalar tokens only; ``"reference"`` and
    ``schedule=True`` refuse it (``schedule="auto"`` lets the partition
    win), and the slot API stays ``"cuda"``'s.

    ``optimize=True`` builds the opcode-class-specialized plan (permuted
    node and arc tables, the spec fire rule); ``profile=True`` carries
    the five fabric counters through every block, inside the same
    launch, and attaches a :class:`~repro_torch.obs.FabricProfile` to
    each result.  ``schedule=True`` (or ``"auto"``) runs a control-free
    fabric from its static firing schedule
    (:mod:`repro_torch.core.schedule`): ``run`` is one launch of the
    scheduled-run kernel, ``step_block`` one launch of the scheduled
    slot-step kernel, and profiles are closed-form on the host.  None of
    the three changes a result: every backend and flag reports
    bit-identical outputs/counts/fired/cycles; ``cycles`` is
    reconstructed from the last progress cycle, so block-granular
    quiescence detection does not change the reported cycle count.
    """

    def __init__(self, graph: Graph, max_cycles: int = 100_000,
                 backend: str = "cuda", block_cycles: int = 1,
                 device="cuda", optimize: bool = False,
                 profile: bool = False, schedule: bool | str = False, *,
                 token_shape: tuple[int, ...] = (), dtype=np.int32,
                 partition=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if block_cycles < 1:
            raise ValueError("block_cycles must be >= 1")
        self.token_shape = tuple(int(x) for x in token_shape)
        self.dtype = token_dtype(dtype)
        if backend == "cuda" and (self.token_shape != ()
                                  or self.dtype != np.int32):
            raise ValueError(
                "the cuda backend supports scalar int32 tokens only, not "
                f"{self.dtype.name} tokens of shape {self.token_shape}; "
                'use backend="torch"')
        self.graph = graph
        self.max_cycles = max_cycles
        self.backend = backend
        self.block_cycles = int(block_cycles)
        self.device = resolve_device(device)
        # the reference backend is the oracle: it always runs the graph
        # as authored, whatever optimize says
        self.optimize = bool(optimize)
        self.profile = bool(profile)
        # schedule: False/None = dynamic interpreter; "auto" = run the
        # static firing schedule when the fabric is control-free, dynamic
        # otherwise; True = require the schedule (raise naming the
        # blockers if the fabric can't be scheduled).  A plan that fails
        # to lock onto a period in budget falls back to the dynamic run
        # path (a performance decision, never a semantic one).
        if schedule not in (False, None, True, "auto"):
            raise ValueError("schedule must be False, True, or 'auto', "
                             f"got {schedule!r}")
        self.schedule = schedule
        self._sched = None
        self._sched_on = False
        if schedule:
            from repro_torch.core.schedule import schedule_blockers
            blockers = schedule_blockers(graph)
            if blockers and schedule is True:
                raise ValueError(
                    "schedule=True needs a statically schedulable "
                    f"fabric, but this one has: {', '.join(blockers)} "
                    "(use schedule='auto' to fall back dynamically)")
            self._sched_on = not blockers
        # partition: None/1 = solo fabric; int P / "auto" / Partition =
        # shard the graph into P regions (DESIGN.md §14) that run as
        # communicating fabrics; every run and slot entry point goes
        # through core/multifabric.py when engaged
        self.partition = None
        self._mf = None             # the MultiFabric of a partitioned engine
        if partition is not None:
            from repro_torch.core.partition import resolve_partition
            self.partition = resolve_partition(graph, partition)
        self._part_on = (self.partition is not None
                         and self.partition.P > 1)
        if self._part_on:
            if backend == "reference":
                raise ValueError(
                    "partitioned execution needs a device backend "
                    "(cuda or torch), not 'reference' — the reference "
                    "oracle IS the solo fabric the shards are checked "
                    "against")
            if self.token_shape != ():
                raise ValueError(
                    "partitioned execution supports scalar tokens only")
            if schedule is True:
                raise ValueError(
                    "schedule=True cannot compose with partition > 1 "
                    "(regions run the dynamic cycle body; use "
                    "schedule='auto' to let partition win)")
            # regions execute the lockstep cycle body; the static firing
            # schedule is a whole-fabric program
            self._sched_on = False
        self.p = _plan(graph, optimize=self.optimize)
        self._steps: dict[tuple[int, bool], object] = {}
        self._tables = None
        self._fabric = None         # the "torch" backend's _TorchFabric
        if self._part_on:
            from repro_torch.core.multifabric import MultiFabric
            self._mf = MultiFabric(
                graph, self.partition, backend=backend, dtype=self.dtype,
                block_cycles=self.block_cycles, optimize=self.optimize,
                profile=self.profile, max_cycles=max_cycles,
                device=self.device)
        elif backend == "cuda":
            from repro_torch.kernels.dataflow_fire import (block_plan_arrays,
                                                           device_tables)
            self._tables = device_tables(
                block_plan_arrays(graph, optimize=self.optimize),
                self.device)

    def _sched_ctx(self):
        """Lazy per-engine schedule state."""
        if self._sched is None:
            from repro_torch.core.schedule import ScheduleContext
            self._sched = ScheduleContext(self.p, self.graph,
                                          self.token_shape, self.dtype)
        return self._sched

    # -- public ---------------------------------------------------------
    def run(self, feeds: Mapping[str, object] | None = None,
            max_cycles: int | None = None) -> EngineResult:
        """feeds: arc -> [k, *token_shape] stream of tokens (k may vary
        per arc; a [k] stream broadcasts over the token shape)."""
        max_cycles = max_cycles or self.max_cycles
        if self._part_on:
            return self._mf.run(feeds, max_cycles)
        if self._sched_on:
            from repro_torch.core import schedule as _sched
            try:
                return _sched.run_scheduled(self, feeds, max_cycles)
            except _sched.ScheduleBail:
                pass        # pathological period: dynamic path below
        if self.backend == "reference":
            return run_reference(self.graph, feeds, self.token_shape,
                                 self.dtype, max_cycles,
                                 profile=self.profile)
        if self.backend == "torch":
            fv, fl = pack_feeds(self.p["input_arcs"], feeds,
                                self.token_shape, self.dtype)
            return self._run_torch(fv[None], fl[None], max_cycles)[0]
        return self._run_cuda(feeds, max_cycles)

    def run_batch(self, feeds_batch, max_cycles: int | None = None
                  ) -> list[EngineResult]:
        """Execute B independent token streams through one fabric.

        feeds_batch: sequence of B feed dicts (streams may have unequal
        lengths — shorter streams quiesce early and idle harmlessly).
        Returns one EngineResult per stream, bit-identical to running
        each stream alone (a profile counts the cycles the whole batch
        was simulated for)."""
        max_cycles = max_cycles or self.max_cycles
        feeds_batch = list(feeds_batch)
        if not feeds_batch:
            raise ValueError(
                "run_batch: feeds_batch is empty — pass at least one "
                "feed dict (use run() for a single stream)")
        if self._part_on:
            return self._mf.run_batch(feeds_batch, max_cycles)
        if self._sched_on:
            from repro_torch.core import schedule as _sched
            try:
                res = _sched.run_batch_scheduled(self, feeds_batch,
                                                 max_cycles)
            except _sched.ScheduleBail:
                res = None
            if res is not None:     # None: mixed feed lengths — the
                return res          # schedule is per-length; the dynamic
                                    # path takes the ragged batch
        if self.backend == "reference":
            return [run_reference(self.graph, f, self.token_shape,
                                  self.dtype, max_cycles,
                                  profile=self.profile)
                    for f in feeds_batch]
        L = max((max((np.shape(v)[0] for v in (f or {}).values()),
                     default=0) for f in feeds_batch), default=0)
        torch_ = self.backend == "torch"
        packed = [pack_feeds(self.p["input_arcs"], f, self.token_shape,
                             self.dtype, pad_rows=None if torch_ else 1,
                             min_len=max(L, 1)) for f in feeds_batch]
        feed_vals = np.stack([fv for fv, _ in packed])
        feed_len = np.stack([fl for _, fl in packed])
        if torch_:
            return self._run_torch(feed_vals, feed_len, max_cycles)
        return self._run_cuda_batch(feed_vals, feed_len, max_cycles)

    def _result_from_state(self, out_last, out_count, cycles, fired,
                           dispatches, prof=None, chan=None):
        """Per-arc result dicts from flat (host) accumulators.

        prof: optional (nf, si, so, ab, ahw, profiled_cycles,
        dispatches) plan-order counters, turned into a graph-order
        :class:`~repro_torch.obs.FabricProfile`; a partitioned engine's
        are the regions' flat counters, with the channel counters
        ``chan``."""
        if self._part_on:
            return self._mf.result(
                out_last, out_count, cycles, fired, dispatches,
                None if prof is None else (prof[:5], chan, prof[5]))
        out_arcs = self.p["output_arcs"]
        profile = node_fires = None
        if prof is not None:
            from repro_torch.obs.profile import FabricProfile
            profile = FabricProfile.from_plan(self.graph, self.p, *prof[:5],
                                              cycles=prof[5],
                                              dispatches=prof[6])
            node_fires = profile.node_fires
        return EngineResult(
            outputs={a: out_last[i] for i, a in enumerate(out_arcs)},
            counts={a: int(out_count[i]) for i, a in enumerate(out_arcs)},
            cycles=cycles, fired=fired, dispatches=dispatches,
            node_fires=node_fires, profile=profile)

    # -- resumable slot API (continuous batching) ------------------------
    #
    # Lifecycle: init_state(B) -> all slots free; reset_slots() admits
    # requests into free slots; step_block() advances every *active*
    # slot by exactly block_cycles fabric cycles in one launch (inactive
    # slots are clock-gated out of feed/fire/drain); harvest() extracts
    # finished results and frees the slots.  Because admissions happen
    # only at block boundaries and each slot carries its own cycle
    # clock, a request's result is bit-identical to running it alone
    # via run().
    def _check_slot_api(self):
        if self.backend != "cuda":
            # on "torch" the slot step would be the slot kernel's plain
            # version, and a plain version never serves on the card
            raise ValueError("the resumable slot API needs "
                             'backend="cuda" (scalar int32 tokens through '
                             f"the slot kernels), not {self.backend!r}")

    def _state0_rows(self):
        """(full0[A2], val0[A2]) int32 rows of a freshly-reset slot (a
        partitioned engine's flat rows)."""
        if self._part_on:
            return self._mf.state0_rows()
        p = self.p
        full = np.zeros((p["A"] + 2,), np.int32)
        val = np.zeros((p["A"] + 2,), np.int32)
        full[p["FULL_PAD"]] = 1
        for a, v in self.graph.consts.items():
            full[p["aidx"][a]] = 1
            val[p["aidx"][a]] = int(v)
        for a, v in self.graph.inits.items():    # one-shot initial tokens
            full[p["aidx"][a]] = 1
            val[p["aidx"][a]] = int(v)
        return full, val

    def _dev(self, x):
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _prof0(self, batch: int | None = None):
        """Fresh counters over the kernel tables (N+1 node rows), or
        None on an unprofiled engine."""
        if not self.profile:
            return None
        if self._part_on:
            return self._mf.counters0(batch)
        return _prof_zeros(len(self.graph.nodes) + 1, self.p["A"] + 2,
                           batch=batch, device=self.device)

    def init_state(self, slots: int) -> SlotState:
        """Fresh B-slot state, every slot free (active == 0)."""
        self._check_slot_api()
        if slots < 1:
            raise ValueError("slots must be >= 1")
        p = self.p
        B = int(slots)
        n_in = max(len(p["input_arcs"]), 1)
        n_out = max(len(p["output_arcs"]), 1)
        full0, val0 = self._state0_rows()
        z64 = lambda: np.zeros((B,), np.int64)
        return SlotState(
            fv=self._zeros(B, n_in, 1), fl=self._zeros(B, n_in),
            full=self._dev(full0).repeat(B, 1),
            val=self._dev(val0).repeat(B, 1),
            ptr=self._zeros(B, n_in), out_last=self._zeros(B, n_out),
            out_count=self._zeros(B, n_out),
            active=np.zeros((B,), np.int32), base=z64(), last=z64(),
            fired=z64(), quiesced=np.zeros((B,), bool), dispatches=z64(),
            cap=np.full((B,), self.max_cycles, np.int64), stalled=z64(),
            active_dev=self._zeros(B),
            # scheduled engines reconstruct profiles on the host from the
            # plan (closed form): no device counters
            prof=None if self._sched_on else self._prof0(B),
            prof_cycles=z64() if self.profile else None,
            sched=self._make_slot_sched(B) if self._sched_on else None,
            mf=self._mf.channels0(B) if self._part_on else None)

    def _make_slot_sched(self, slots: int):
        from repro_torch.core.schedule import SlotSched
        return SlotSched(self._sched_ctx(), slots, self.profile)

    def reset_slots(self, state: SlotState, slot_ids,
                    new_feeds, caps=None) -> SlotState:
        """Admit one request per slot id: fresh arc registers + the new
        feed stream (and zeroed counters on a profiled engine).  Slots
        must be free (never-used or harvested); everything else keeps
        its state untouched.

        Only the admitted slots' rows travel to the device, and they are
        written into the state's buffers in place (a few indexed
        writes for the whole round, not launches per slot): continue
        from the returned state.

        caps: optional per-admission cycle caps (one entry per slot id;
        ``None`` entries fall back to the engine's ``max_cycles``) — a
        request-level budget the scheduler enforces by shortening
        blocks and ``harvest`` clamps cycle accounting to."""
        self._check_slot_api()
        slot_ids = list(slot_ids)
        new_feeds = list(new_feeds)
        if len(slot_ids) != len(new_feeds):
            raise ValueError(f"{len(slot_ids)} slot ids but "
                             f"{len(new_feeds)} feed dicts")
        if not slot_ids:
            return state
        if caps is None:
            caps = [None] * len(slot_ids)
        if len(caps) != len(slot_ids):
            raise ValueError(f"{len(slot_ids)} slot ids but "
                             f"{len(caps)} caps")
        for b, c in zip(slot_ids, caps):
            if c is not None and int(c) < 1:
                raise ValueError(f"slot {b}: cap must be >= 1, got {c}")
        busy = [b for b in slot_ids if state.active[b]]
        if busy:
            raise ValueError(f"slots {busy} still hold unharvested "
                             "requests (harvest before refilling)")
        p = self.p
        packed = [pack_feeds(p["input_arcs"], f, pad_rows=1)
                  for f in new_feeds]
        need = max(fv.shape[1] for fv, _ in packed)
        fv = state.fv
        L = fv.shape[2]
        if need > L:        # grow the stream buffer (power of two)
            L = 1 << (int(need) - 1).bit_length()
            grown = self._zeros(fv.shape[0], fv.shape[1], L)
            grown[:, :, :fv.shape[2]] = fv
            fv = grown
        rows = np.zeros((len(slot_ids), fv.shape[1], need), np.int32)
        for k, (f, _) in enumerate(packed):
            rows[k, :, :f.shape[1]] = f
        ids = torch.as_tensor(slot_ids, dtype=torch.long, device=self.device)
        fv.index_fill_(0, ids, 0)
        fv[ids, :, :need] = self._dev(rows)
        state.fl.index_copy_(0, ids, self._dev(np.stack([fl for _, fl
                                                         in packed])))
        full0, val0 = self._state0_rows()
        state.full[ids] = self._dev(full0)
        state.val[ids] = self._dev(val0)
        for x in (state.ptr, state.out_last, state.out_count,
                  *(state.prof or ())):
            x.index_fill_(0, ids, 0)
        if state.mf is not None:
            self._mf.reset_channels(state.mf, ids)
        active = state.active.copy()
        for host in (base := state.base.copy(), last := state.last.copy(),
                     fired := state.fired.copy(),
                     disp := state.dispatches.copy(),
                     stalled := state.stalled.copy()):
            host[slot_ids] = 0
        prof_cycles = state.prof_cycles
        if prof_cycles is not None:
            prof_cycles = prof_cycles.copy()
            prof_cycles[slot_ids] = 0
        cap = state.cap.copy()
        for b, c in zip(slot_ids, caps):
            cap[b] = self.max_cycles if c is None else int(c)
        quiesced = state.quiesced.copy()
        active[slot_ids] = 1
        quiesced[slot_ids] = False
        sched = state.sched
        if self._sched_on:
            from repro_torch.core.schedule import plan_key
            if sched is None:
                sched = self._make_slot_sched(state.slots)
            ctx = self._sched_ctx()
            for b, (_, fl) in zip(slot_ids, packed):
                sched.reset(b, ctx.plan_for(plan_key(self, fl)))
        return SlotState(fv, state.fl, state.full, state.val, state.ptr,
                         state.out_last, state.out_count, active, base,
                         last, fired, quiesced, disp, cap=cap,
                         stalled=stalled, active_dev=self._dev(active),
                         prof=state.prof, prof_cycles=prof_cycles,
                         sched=sched, mf=state.mf)

    def step_block(self, state: SlotState,
                   n_cycles: int | None = None) -> SlotState:
        """Advance every active slot by ``n_cycles`` (default
        ``block_cycles``) fabric cycles in ONE launch; free slots are
        clock-gated out.  Per-slot clocks (base/last/fired) advance on
        the host after one device-to-host read per block (a scheduled
        engine reads them off the plan: no read at all); a slot whose
        block had an idle tail is marked ``quiesced`` (idle is absorbing
        — the request is done)."""
        self._check_slot_api()
        nb = self.block_cycles if n_cycles is None else int(n_cycles)
        if nb < 1:
            raise ValueError("n_cycles must be >= 1")
        if not state.active.any():
            return state
        if self._sched_on:
            from repro_torch.core import schedule as _sched
            return _sched.step_block_sched(self, state, nb)
        if self._part_on:
            # the sharded block updates the state in place
            dev = (state.full, state.val, state.ptr, state.out_last,
                   state.out_count)
            prof = state.prof
            f, lp = self._mf.block(state.fv, state.fl, *dev, state.mf,
                                         state.active_dev, prof, nb)
        else:
            res = self._step(nb, True)(
                state.fv, state.fl, state.full, state.val, state.ptr,
                state.out_last, state.out_count, state.active_dev,
                *(state.prof or ()))
            dev, f, lp = res[:5], res[5], res[6]
            prof = tuple(res[7:]) or None
            f, lp = torch.cat([f, lp], 1).cpu().numpy().T  # one sync
        fired = state.fired + f
        last = np.where(lp > 0, state.base + lp, state.last)
        ran = np.where(state.active > 0, nb, 0)
        base = state.base + ran
        quiesced = np.where(state.active > 0, lp < nb, state.quiesced)
        disp = state.dispatches + (state.active > 0)
        # progress counter: an active slot whose whole block was idle
        # stalls by one more block; any progress resets it.  A healthy
        # idle slot is harvested as quiesced the same heartbeat, so a
        # *growing* stall count means the quiescence signal is being
        # withheld — the watchdog's trigger.
        stalled = np.where(state.active > 0,
                           np.where(lp > 0, 0, state.stalled + 1),
                           state.stalled)
        prof_cycles = state.prof_cycles
        if prof_cycles is not None:
            prof_cycles = prof_cycles + ran
        return SlotState(state.fv, state.fl, *dev, state.active.copy(),
                         base, last, fired, quiesced, disp,
                         cap=state.cap, stalled=stalled,
                         active_dev=state.active_dev, prof=prof,
                         prof_cycles=prof_cycles, sched=state.sched,
                         mf=state.mf)

    def harvest(self, state: SlotState, slot_ids
                ) -> tuple[SlotState, list[EngineResult]]:
        """Extract the resident requests' EngineResults from the given
        (active) slots and free them.  Results follow the same
        accounting as run(): cycles = last progress cycle + 1 trailing
        idle cycle, capped at the slot's cycle cap (per-request if the
        admission set one); dispatches = blocks the request rode.  Only
        the harvested rows leave the device, in one transfer."""
        self._check_slot_api()
        slot_ids = list(slot_ids)
        idle = [b for b in slot_ids if not state.active[b]]
        if idle:
            raise ValueError(f"slots {idle} are free — nothing to harvest")
        ids = torch.as_tensor(slot_ids, dtype=torch.long, device=self.device)
        chprof = () if state.mf is None else state.mf["chprof"] or ()
        cols = (state.out_last, state.out_count, *(state.prof or ()),
                *chprof)
        acc = torch.cat([x[ids] for x in cols], 1).cpu().numpy()
        bounds = np.cumsum([0] + [x.shape[1] for x in cols])
        parts = [acc[:, lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]

        def prof_row(k, b):
            # scheduled engines accrue the counters on the host from the
            # plan (closed form); dynamic engines read the device rows
            if self.profile and state.sched is not None:
                return (*state.sched.prof_row(b), int(state.prof_cycles[b]),
                        int(state.dispatches[b]))
            if state.prof is None:
                return None
            return (*(x[k] for x in parts[2:7]), int(state.prof_cycles[b]),
                    int(state.dispatches[b]))
        results = [self._result_from_state(
            parts[0][k], parts[1][k],
            int(min(state.last[b] + 1, state.cap[b])),
            int(state.fired[b]), int(state.dispatches[b]),
            prof=prof_row(k, b), chan=[x[k] for x in parts[7:]])
            for k, b in enumerate(slot_ids)]
        active = state.active.copy()
        quiesced = state.quiesced.copy()
        active[slot_ids] = 0
        quiesced[slot_ids] = False
        return dataclasses.replace(state, active=active, quiesced=quiesced,
                                   active_dev=self._dev(active)), results

    # -- cuda backend (host loop over fused blocks) ----------------------
    def _step(self, n_cycles: int, batched: bool):
        """Block step for a given size, made lazily and cached (the
        device tables are built once in __init__ and shared)."""
        key = (n_cycles, batched)
        step = self._steps.get(key)
        if step is None:
            from repro_torch.kernels import ops as _kops
            _, step = _kops.make_block_step(
                self.graph, n_cycles, batched=batched, tables=self._tables,
                device=self.device, profile=self.profile)
            self._steps[key] = step
        return step

    def _state0(self, batch: int | None = None):
        p = self.p
        n_in = max(len(p["input_arcs"]), 1)
        n_out = max(len(p["output_arcs"]), 1)
        full, val = self._state0_rows()
        lead = () if batch is None else (batch,)
        return (self._dev(full).repeat(*lead, 1),
                self._dev(val).repeat(*lead, 1),
                self._zeros(*lead, n_in), self._zeros(*lead, n_out),
                self._zeros(*lead, n_out))

    def _run_cuda(self, feeds, max_cycles: int) -> EngineResult:
        K = self.block_cycles
        fv, fl = pack_feeds(self.p["input_arcs"], feeds, pad_rows=1)
        fv, fl = self._dev(fv), self._dev(fl)
        state = self._state0()
        prof = self._prof0() or ()
        base = last = fired = dispatches = 0
        while True:
            nb = min(K, max_cycles - base)  # never simulate past the cap
            res = self._step(nb, False)(fv, fl, *state, *prof)
            state, f, lp, prof = res[:5], res[5], res[6], res[7:]
            f, lp = torch.cat([f, lp]).tolist()   # one sync per block
            dispatches += 1
            fired += f
            if lp > 0:
                last = base + lp
            base += nb
            if lp < nb or base >= max_cycles:
                break   # idle block tail => quiescent (idle is absorbing)
        cycles = min(last + 1, max_cycles)
        host = torch.cat([state[3], state[4], *prof]).cpu().numpy()
        n_out = state[3].shape[0]
        return self._result_from_state(
            host[:n_out], host[n_out:2 * n_out], cycles, fired, dispatches,
            prof=(*_split(host[2 * n_out:], prof), base, dispatches)
            if prof else None)

    def _run_cuda_batch(self, feed_vals, feed_len,
                        max_cycles: int) -> list[EngineResult]:
        K = self.block_cycles
        B = feed_vals.shape[0]
        fv, fl = self._dev(feed_vals), self._dev(feed_len)
        state = self._state0(batch=B)
        prof = self._prof0(B) or ()
        base = dispatches = 0
        last = np.zeros((B,), np.int64)
        fired = np.zeros((B,), np.int64)
        ones = torch.ones((B,), dtype=torch.int32, device=self.device)
        while True:
            nb = min(K, max_cycles - base)  # never simulate past the cap
            res = self._step(nb, True)(fv, fl, *state, ones, *prof)
            state, f, lp, prof = res[:5], res[5], res[6], res[7:]
            f, lp = torch.cat([f, lp], 1).cpu().numpy().T
            dispatches += 1
            fired += f
            last = np.where(lp > 0, base + lp, last)
            base += nb
            if (lp < nb).all() or base >= max_cycles:
                break
        host = torch.cat([state[3], state[4], *prof], 1).cpu().numpy()
        n_out = state[3].shape[1]
        return [self._result_from_state(
            host[b, :n_out], host[b, n_out:2 * n_out],
            int(min(last[b] + 1, max_cycles)), int(fired[b]), dispatches,
            prof=(*_split(host[b, 2 * n_out:], prof), base, dispatches)
            if prof else None)
            for b in range(B)]

    # -- torch backend (host loop over K-cycle blocks of tensor code) ------
    @torch.inference_mode()
    def _run_torch(self, feed_vals, feed_len,
                   max_cycles: int) -> list[EngineResult]:
        """The JAX package's ``_run_impl`` under ``vmap``, on B packed
        streams (feed_vals[B, n_in, L, *ts] of ``dtype``, feed_len[B,
        n_in]): blocks of K cycles while some stream's last cycle made
        progress and ``cycles + K <= max_cycles``, each stream frozen from
        the block its own condition fails; then ``max_cycles % K`` more
        cycles for every stream, whatever the loop ended on; reported
        cycles ``min(last_prog + 1, max_cycles)``.  The profile counts
        every simulated cycle, the idle tail and the remainder included,
        exactly as ``"xla"``'s does."""
        if self._fabric is None:
            self._fabric = _TorchFabric(self)
        fab = self._fabric
        K = self.block_cycles
        fv = to_carrier(feed_vals, self.dtype, self.device)
        fl = torch.as_tensor(np.asarray(feed_len, np.int32),
                             device=self.device)
        B = fv.shape[0]
        s = fab.state0(B)
        done = 0
        while done + K <= max_cycles:
            # only streams whose last cycle made progress take the block
            # (a frozen stream's own flag stays down); one read per block
            alive = s["progress"]
            if done and not bool(alive.any()):
                break
            new = s
            for _ in range(K):
                new = fab.cycle(new, fv, fl)
            s = new if B == 1 else {
                k: torch.where(_expand(alive, v.dim() - 1), new[k], v)
                for k, v in s.items()}
            done += K
        for _ in range(max_cycles % K):
            s = fab.cycle(s, fv, fl)
        cycles = torch.clamp(s["last_prog"] + 1, max=max_cycles).tolist()
        fired = s["fired"].tolist()
        out_last = from_carrier(s["out_last"], self.dtype)
        out_count = s["out_count"].cpu().numpy()
        prof = None
        if self.profile:
            prof = [x.cpu().numpy() for x in (s["nf"], s["si"], s["so"],
                                              s["ab"], s["ahw"])]
            simulated = s["cycles"].tolist()
        return [self._result_from_state(
            out_last[b], out_count[b], int(cycles[b]), int(fired[b]),
            dispatches=1, prof=None if prof is None else
            (*(x[b] for x in prof), int(simulated[b]), 1))
            for b in range(B)]


def _split(row, like):
    """Cut a concatenated host row back into arrays as wide as the last
    axes of the tensors ``like``."""
    bounds = np.cumsum([0] + [x.shape[-1] for x in like])
    return [row[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]


class _TorchFabric:
    """The ``"torch"`` backend's cycle body over one engine's plan, with
    its index tables on the engine's device.

    One cycle is the JAX package's: feed the empty input arcs, fire every
    ready node against the post-feed registers (the generic rule, or the
    opcode-bucketed one when the plan has ``class_slices``), restore the
    const buses, sample the profile, drain the output arcs.  Registers are
    updated by gathers, not scatters: each arc has at most one consuming
    (node, slot) and one producing (node, slot) outside the const buses
    and the pads, so ``consumed``/``produced``/the new value of every arc
    is read from its own slot, and no index repeats (a scatter with
    repeated indices picks an arbitrary writer on the card).  The pads
    are never consumed or produced, so FULL_PAD stays full, EMPTY_PAD
    empty and ``val`` there what the reset wrote (0).  On a control-free
    fabric a node consumes and produces on every slot when it fires, so
    ``consumed``/``produced`` are read from ``ready`` itself."""

    def __init__(self, eng: "DataflowEngine"):
        p, dev = eng.p, eng.device
        self.dtype = eng.dtype
        self.ts = eng.token_shape
        self.nts = len(self.ts)
        self.profile = eng.profile
        self.dev = dev
        A, N = p["A"], len(p["opcode"])
        A2 = A + 2
        self.N, self.A2 = N, A2
        tt = lambda x, dt=torch.long: torch.as_tensor(np.array(x),
                                                      dtype=dt, device=dev)
        opcode = np.asarray(p["opcode"])
        in_idx, out_idx = np.asarray(p["in_idx"]), np.asarray(p["out_idx"])
        self.in_idx, self.out_idx = tt(in_idx), tt(out_idx)
        self.in0, self.in1, self.in2 = (tt(in_idx[:, k]) for k in range(3))
        self.in_arc = tt([p["aidx"][a] for a in p["input_arcs"]])
        self.out_arc = tt([p["aidx"][a] for a in p["output_arcs"]])
        self.n_in = max(len(p["input_arcs"]), 1)
        self.n_out = max(len(p["output_arcs"]), 1)
        const_mask = np.asarray(p["const_mask"])
        # per-arc slot of its consumer in consume.reshape(N * 3) and of its
        # producer in produce.reshape(N * 2); pads, const buses (restored
        # every cycle) and open ends point at one always-False column
        # (and of its consumer and producer node in ready, column N)
        cons = np.full((A2,), N * _MAX_IN, np.int64)
        prod = np.full((A2,), N * _MAX_OUT, np.int64)
        cons_node = np.full((A2,), N, np.int64)
        prod_node = np.full((A2,), N, np.int64)
        for i in range(N):
            for k in range(_MAX_IN):
                a = in_idx[i, k]
                if a < A and not const_mask[a]:
                    cons[a], cons_node[a] = i * _MAX_IN + k, i
            for k in range(_MAX_OUT):
                a = out_idx[i, k]
                if a < A:
                    prod[a], prod_node[a] = i * _MAX_OUT + k, i
        self.cons, self.prod = tt(cons), tt(prod)
        self.cons_node, self.prod_node = tt(cons_node), tt(prod_node)
        self.prod_z = tt(np.minimum(prod_node, N - 1))   # a node's value
        onehot = lambda i: np.arange(A2) == i
        pads = onehot(p["FULL_PAD"]) | onehot(p["EMPTY_PAD"])
        # a const bus drained as an output arc is full again every cycle
        self.consts = tt(const_mask, torch.bool)
        self.not_pad = tt(~pads, torch.bool)
        out_mask = np.zeros((A2,), bool)
        out_mask[[p["aidx"][a] for a in p["output_arcs"]]] = True
        self.not_out = tt(~out_mask, torch.bool)
        present = {Op(int(o)) for o in opcode}
        self.has = {op: op in present for op in (Op.NDMERGE, Op.DMERGE,
                                                  Op.BRANCH)}
        self.is_ = {op: tt(opcode == int(op), torch.bool)
                    for op in self.has}
        # the generic rule selects among the opcodes present only (an
        # absent opcode's select is the identity)
        self.value_ops = {op: _expand(tt(opcode == int(op), torch.bool),
                                      self.nts)
                          for op in sorted(present) if op not in (
                              Op.COPY, Op.SINK, Op.BRANCH, Op.NDMERGE,
                              Op.DMERGE)}
        cs = p["class_slices"]
        self.class_slices = cs
        self.has_ctrl = any(self.has.values())
        # state0: FULL_PAD and the const buses full, consts' and inits'
        # values in place (np.full at the token dtype, as run_reference)
        full0 = const_mask | onehot(p["FULL_PAD"])
        val0 = np.zeros((A2, *self.ts), self.dtype)
        for a, v in {**eng.graph.consts, **eng.graph.inits}.items():
            full0[p["aidx"][a]] = True
            val0[p["aidx"][a]] = np.full(self.ts, v, self.dtype)
        self.full0 = tt(full0, torch.bool)
        self.val0 = to_carrier(val0, self.dtype, dev)
        self._zcol = {}

    def state0(self, B: int) -> dict:
        dev, ts = self.dev, self.ts
        i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        s = dict(full=self.full0.expand(B, -1).clone(),
                 val=self.val0.expand(B, *self.val0.shape).clone(),
                 ptr=torch.zeros((B, self.n_in), dtype=torch.long,
                                 device=dev),
                 out_last=torch.zeros((B, self.n_out, *ts),
                                      dtype=self.val0.dtype, device=dev),
                 out_count=i32(B, self.n_out), cycles=i32(B), fired=i32(B),
                 last_prog=i32(B),
                 progress=torch.ones((B,), dtype=torch.bool, device=dev))
        if self.profile:
            s.update(nf=i32(B, self.N), si=i32(B, self.N), so=i32(B, self.N),
                     ab=i32(B, self.A2), ahw=i32(B, self.A2))
        return s

    def _pad_col(self, B: int):
        z = self._zcol.get(B)
        if z is None:
            z = self._zcol[B] = torch.zeros((B, 1), dtype=torch.bool,
                                            device=self.dev)
        return z

    # -- fire rules: (ready[B,N], z[B,N,*ts], consume[B,N,3], produce[B,N,2]);
    # consume and produce None when every firing node takes every slot
    def _rule_generic(self, inf, oute, a, b, ctrl3):
        """Every present opcode's ALU result for every node, selected per
        node by opcode."""
        nts, has, is_ = self.nts, self.has, self.is_
        in0, in1, in2 = inf.unbind(-1)
        all_out = oute.all(-1)
        ready = inf.all(-1) & all_out
        if has[Op.NDMERGE]:
            ready = torch.where(is_[Op.NDMERGE], (in0 | in1) & all_out,
                                ready)
        if has[Op.DMERGE]:
            ready = torch.where(is_[Op.DMERGE], in2 & torch.where(
                ctrl3, in0, in1) & all_out, ready)
        if has[Op.BRANCH]:
            ctrl2 = _truthy(b, nts)
            ready = torch.where(is_[Op.BRANCH], in0 & in1 & torch.where(
                ctrl2, oute[..., 0], oute[..., 1]), ready)
        z = a                       # COPY / BRANCH route a; SINK ignores
        for op, r in _alu(a, b, self.dtype, self.value_ops).items():
            z = torch.where(self.value_ops[op], r, z)
        if has[Op.NDMERGE]:
            z = torch.where(_expand(is_[Op.NDMERGE], nts),
                            torch.where(_expand(in0, nts), a, b), z)
        if has[Op.DMERGE]:
            z = torch.where(_expand(is_[Op.DMERGE], nts),
                            torch.where(_expand(ctrl3, nts), a, b), z)
        if not self.has_ctrl:
            return ready, z, None, None
        r3 = ready[..., None]
        consume = r3.expand(*ready.shape, _MAX_IN)
        if has[Op.NDMERGE]:
            pick = torch.stack([in0, ~in0, torch.zeros_like(in0)], -1)
            consume = torch.where(is_[Op.NDMERGE][:, None], r3 & pick,
                                  consume)
        if has[Op.DMERGE]:
            pick = torch.stack([ctrl3, ~ctrl3, torch.ones_like(ctrl3)], -1)
            consume = torch.where(is_[Op.DMERGE][:, None], r3 & pick,
                                  consume)
        produce = r3.expand(*ready.shape, _MAX_OUT)
        if has[Op.BRANCH]:
            pick = torch.stack([ctrl2, ~ctrl2], -1)
            produce = torch.where(is_[Op.BRANCH][:, None], r3 & pick,
                                  produce)
        return ready, z, consume, produce

    def _rule_spec(self, inf, oute, a, b, ctrl3):
        """The opcode-bucketed rule: nodes are sorted by opcode, so each
        class's ALU result is computed on its own slice; control-free
        fabrics keep the uniform ready/consume/produce masks whole."""
        nts, dt = self.nts, self.dtype
        base = inf.all(-1) & oute.all(-1)
        if not self.has_ctrl:
            zs = [_alu_op(Op(op), a[:, lo:hi], b[:, lo:hi], dt)
                  for op, lo, hi in self.class_slices]
            return base, zs[0] if len(zs) == 1 else torch.cat(zs, 1), \
                None, None
        rs, zs, cs, ps = [], [], [], []
        for opi, lo, hi in self.class_slices:
            op = Op(opi)
            ak, bk = a[:, lo:hi], b[:, lo:hi]
            i0, i1, i2 = inf[:, lo:hi].unbind(-1)
            bk_ = base[:, lo:hi]
            if op == Op.NDMERGE:
                rk = (i0 | i1) & oute[:, lo:hi].all(-1)
                zk = torch.where(_expand(i0, nts), ak, bk)
                ck = rk[..., None] & torch.stack(
                    [i0, ~i0, torch.zeros_like(i0)], -1)
                pk = rk[..., None].expand(*rk.shape, _MAX_OUT)
            elif op == Op.DMERGE:
                c3 = ctrl3[:, lo:hi]
                rk = i2 & torch.where(c3, i0, i1) & oute[:, lo:hi].all(-1)
                zk = torch.where(_expand(c3, nts), ak, bk)
                ck = rk[..., None] & torch.stack(
                    [c3, ~c3, torch.ones_like(c3)], -1)
                pk = rk[..., None].expand(*rk.shape, _MAX_OUT)
            elif op == Op.BRANCH:
                c2 = _truthy(bk, nts)
                ok = oute[:, lo:hi]
                rk = i0 & i1 & torch.where(c2, ok[..., 0], ok[..., 1])
                zk = ak
                ck = rk[..., None].expand(*rk.shape, _MAX_IN)
                pk = rk[..., None] & torch.stack([c2, ~c2], -1)
            else:
                rk = bk_
                zk = _alu_op(op, ak, bk, dt)
                ck = rk[..., None].expand(*rk.shape, _MAX_IN)
                pk = rk[..., None].expand(*rk.shape, _MAX_OUT)
            rs.append(rk)
            zs.append(zk)
            cs.append(ck)
            ps.append(pk)
        return (torch.cat(rs, 1), torch.cat(zs, 1), torch.cat(cs, 1),
                torch.cat(ps, 1))

    def cycle(self, s: dict, fv, fl) -> dict:
        """One feed -> fire -> drain cycle of every stream of ``s``."""
        nts = self.nts
        full, val, ptr = s["full"], s["val"], s["ptr"]
        B = full.shape[0]
        # 1. strobe the environment's input buses
        if self.in_arc.numel():
            ia = self.in_arc
            fed = full[:, ia]
            can = ~fed & (ptr < fl)
            idx = ptr.clamp(max=fv.shape[2] - 1)
            idx = idx.reshape(*idx.shape, 1, *([1] * nts)).expand(
                *idx.shape, 1, *self.ts)
            nxt = fv.gather(2, idx).squeeze(2)
            val = val.index_copy(1, ia, torch.where(_expand(can, nts), nxt,
                                                    val[:, ia]))
            full = full.index_copy(1, ia, fed | can)
            ptr = ptr + can
            prog = can.any(1)
        else:
            prog = torch.zeros((B,), dtype=torch.bool, device=self.dev)
        # 2. fire every ready node against the post-feed registers
        inf = full[:, self.in_idx]                     # [B, N, 3]
        oute = ~full[:, self.out_idx]                  # [B, N, 2]
        a, b = val[:, self.in0], val[:, self.in1]
        ctrl3 = _truthy(val[:, self.in2], nts) if self.has[Op.DMERGE] \
            else None
        rule = self._rule_spec if self.class_slices else self._rule_generic
        ready, z, consume, produce = rule(inf, oute, a, b, ctrl3)
        col = self._pad_col(B)
        if consume is None:
            rp = torch.cat([ready, col], 1)
            consumed, produced = rp[:, self.cons_node], rp[:, self.prod_node]
        else:
            consumed = torch.cat([consume.reshape(B, -1), col],
                                 1)[:, self.cons]
            produced = torch.cat([produce.reshape(B, -1), col],
                                 1)[:, self.prod]
        val = torch.where(_expand(produced, nts), z[:, self.prod_z], val)
        # consumed and produced arcs are disjoint (a node takes full
        # arcs and fills empty ones)
        full = torch.where(consumed, False, full | produced) | self.consts
        out = {}
        if self.profile:
            # stall attribution on the post-feed registers the rule saw
            # (ready implies inputs-ready); occupancy post-fire, pre-drain
            in0, in1, in2 = inf.unbind(-1)
            ir = inf.all(-1)
            if self.has[Op.NDMERGE]:
                ir = torch.where(self.is_[Op.NDMERGE], in0 | in1, ir)
            if self.has[Op.DMERGE]:
                ir = torch.where(self.is_[Op.DMERGE],
                                 in2 & torch.where(ctrl3, in0, in1), ir)
            occ = (full & self.not_pad).int()
            out.update(nf=s["nf"] + ready.int(), si=s["si"] + (~ir).int(),
                       so=s["so"] + (ir & ~ready).int(), ab=s["ab"] + occ,
                       ahw=torch.maximum(s["ahw"], occ))
        # 3. the environment drains the output buses
        out_last, out_count = s["out_last"], s["out_count"]
        if self.out_arc.numel():
            got = full[:, self.out_arc]
            out_last = torch.where(_expand(got, nts), val[:, self.out_arc],
                                   out_last)
            out_count = out_count + got
            full = full & self.not_out
            prog = prog | got.any(1)
        n_fired = ready.sum(1, dtype=torch.int32)
        prog = prog | (n_fired > 0)
        cycles = s["cycles"] + 1
        return dict(full=full, val=val, ptr=ptr, out_last=out_last,
                    out_count=out_count, cycles=cycles,
                    fired=s["fired"] + n_fired,
                    last_prog=torch.where(prog, cycles, s["last_prog"]),
                    progress=prog, **out)


# ---------------------------------------------------------------------------
# Pure-numpy reference engine (the port's own oracle)
# ---------------------------------------------------------------------------
def alu_numpy(op, a, b, dtype):
    """Numpy mirror of the engine ALU.

    Integer overflow wraps two's-complement and float specials follow
    IEEE — numpy's over/invalid warnings are suppressed because that
    wrapping IS the contract.  :func:`run_reference` enters one errstate
    around the whole run and calls :func:`_alu_numpy` directly."""
    with np.errstate(all="ignore"):
        return _alu_numpy(op, a, b, dtype)


def _alu_numpy(op, a, b, dtype):
    is_int = np.issubdtype(dtype, np.integer)
    if op in (Op.COPY, Op.BRANCH, Op.SINK):
        return a
    if op == Op.ADD: return a + b
    if op == Op.SUB: return a - b
    if op == Op.MUL: return a * b
    if op == Op.DIV:
        return np.where(b == 0, 0, a // np.where(b == 0, 1, b)) if is_int \
            else np.where(b == 0, 0.0, a / np.where(b == 0, 1.0, b))
    if op == Op.AND:
        return (a & b) if is_int else ((a != 0) & (b != 0)).astype(dtype)
    if op == Op.OR:
        return (a | b) if is_int else ((a != 0) | (b != 0)).astype(dtype)
    if op == Op.XOR:
        return (a ^ b) if is_int else ((a != 0) ^ (b != 0)).astype(dtype)
    if op == Op.MAX:
        if is_int:
            return np.maximum(a, b)
        # signed-zero tie: max(+0., -0.) is +0. in either order, where
        # np.maximum keeps b's zero
        return np.where((a == 0) & (b == 0), a + b, np.maximum(a, b))
    if op == Op.MIN:
        if is_int:
            return np.minimum(a, b)
        # dually min(+0., -0.) is -0. in either order
        return np.where((a == 0) & (b == 0), -(-a + -b), np.minimum(a, b))
    if op == Op.SHL:
        return (a << np.clip(b, 0, 31)) if is_int else a * np.exp2(b)
    if op == Op.SHR:
        if is_int:
            return a >> np.clip(b, 0, 31)
        two_b = np.exp2(b)
        return a / np.where(two_b == 0, 1, two_b)
    if op == Op.NOT: return (a == 0).astype(dtype)
    if op == Op.IFGT: return (a > b).astype(dtype)
    if op == Op.IFGE: return (a >= b).astype(dtype)
    if op == Op.IFLT: return (a < b).astype(dtype)
    if op == Op.IFLE: return (a <= b).astype(dtype)
    if op == Op.IFEQ: return (a == b).astype(dtype)
    if op == Op.IFDF: return (a != b).astype(dtype)
    raise AssertionError(op)


def run_reference(graph: Graph, feeds=None, token_shape=(), dtype=np.int32,
                  max_cycles: int = 100_000,
                  profile: bool = False, *, trace=None) -> EngineResult:
    """Slow, obviously-correct mirror of :class:`DataflowEngine`, on the
    graph as authored (the unoptimized plan).  ``profile=True`` also
    counts the five fabric counters (the oracle for the engine's
    profiled runs).  ``trace`` (keyword-only, so that positional calls
    keep their meaning) is called with ``(cycle, node_index, value)`` for
    every firing — the 1-based cycle, the node's graph index, and element
    0 of the token it produced (of the token it consumed, for a node
    that produces none); :mod:`repro_torch.core.pipeline` reads schedules
    from it.  One errstate for the whole run: integer wraparound / float
    specials are the ALU contract (see :func:`alu_numpy`)."""
    with np.errstate(all="ignore"):
        return _run_reference(graph, feeds, token_shape, dtype, max_cycles,
                              profile, trace)


def _run_reference(graph, feeds, token_shape, dtype, max_cycles,
                   profile=False, trace=None) -> EngineResult:
    p = _plan(graph)
    feeds = {a: np.asarray(v, dtype).reshape(-1, *token_shape)
             if np.asarray(v).ndim == 1 and token_shape == ()
             else np.broadcast_to(
                 np.asarray(v, dtype).reshape(np.shape(v)[0],
                                              *([1] * len(token_shape))),
                 (np.shape(v)[0], *token_shape))
             if np.asarray(v).ndim == 1
             else np.asarray(v, dtype)
             for a, v in (feeds or {}).items()}
    full = {a: False for a in p["arcs"]}
    val = {a: np.zeros(token_shape, dtype) for a in p["arcs"]}
    for a, v in graph.consts.items():
        full[a] = True
        val[a] = np.full(token_shape, v, dtype)
    for a, v in graph.inits.items():    # one-shot initial tokens
        full[a] = True
        val[a] = np.full(token_shape, v, dtype)
    ptr = {a: 0 for a in p["input_arcs"]}
    out_last = {a: np.zeros(token_shape, dtype) for a in p["output_arcs"]}
    out_count = {a: 0 for a in p["output_arcs"]}

    def compute(op, a, b):
        return _alu_numpy(op, a, b, dtype)   # caller holds the errstate

    def truthy(v):
        return np.asarray(v).ravel()[0] != 0

    N = len(graph.nodes)
    if profile:
        nf = np.zeros((N,), np.int64)
        si = np.zeros((N,), np.int64)
        so = np.zeros((N,), np.int64)
        ab = np.zeros((len(p["arcs"]),), np.int64)
        ahw = np.zeros((len(p["arcs"]),), np.int64)

    def inputs_ready(n, sfull, sval):
        """Mirror of :func:`_node_inputs_ready` on the dict registers."""
        i = n.inputs
        if n.op == Op.NDMERGE:
            return sfull[i[0]] or sfull[i[1]]
        if n.op == Op.DMERGE:
            if not sfull[i[2]]:
                return False
            return sfull[i[0]] if truthy(sval[i[2]]) else sfull[i[1]]
        return all(sfull[x] for x in i)

    cycles = fired = 0
    progress = True
    while progress and cycles < max_cycles:
        progress = False
        # 1. feed
        for a in p["input_arcs"]:
            if not full[a] and a in feeds and ptr[a] < len(feeds[a]):
                val[a] = feeds[a][ptr[a]]
                full[a] = True
                ptr[a] += 1
                progress = True
        # 2. fire (simultaneous: snapshot)
        sfull = dict(full)
        sval = dict(val)
        plans = []
        for n_idx, n in enumerate(graph.nodes):
            i = n.inputs
            o = n.outputs
            if n.op == Op.NDMERGE:
                rdy = (sfull[i[0]] or sfull[i[1]]) and not sfull[o[0]]
                if rdy:
                    src = i[0] if sfull[i[0]] else i[1]
                    plans.append((n_idx, [src], [(o[0], sval[src])]))
            elif n.op == Op.DMERGE:
                if sfull[i[2]]:
                    src = i[0] if truthy(sval[i[2]]) else i[1]
                    if sfull[src] and not sfull[o[0]]:
                        plans.append((n_idx, [src, i[2]],
                                      [(o[0], sval[src])]))
            elif n.op == Op.BRANCH:
                if sfull[i[0]] and sfull[i[1]]:
                    dst = o[0] if truthy(sval[i[1]]) else o[1]
                    if not sfull[dst]:
                        plans.append((n_idx, list(i), [(dst, sval[i[0]])]))
            else:
                if all(sfull[x] for x in i) and not any(sfull[x] for x in o):
                    aop = sval[i[0]]
                    bop = sval[i[1]] if len(i) > 1 else aop
                    z = compute(n.op, aop, bop)
                    plans.append((n_idx, list(i), [(x, z) for x in o]))
        for n_idx, cons, prods in plans:
            for x in cons:
                full[x] = False
            for x, v in prods:
                full[x] = True
                val[x] = v
            if trace is not None:
                tv = prods[0][1] if prods else val.get(cons[0], 0)
                trace((cycles + 1, n_idx, int(np.asarray(tv).ravel()[0])))
            fired += 1
            progress = True
        for a in graph.consts:
            full[a] = True
        if profile:
            fired_set = {n_idx for n_idx, _, _ in plans}
            for n_idx, n in enumerate(graph.nodes):
                if n_idx in fired_set:
                    nf[n_idx] += 1
                elif inputs_ready(n, sfull, sval):
                    so[n_idx] += 1
                else:
                    si[n_idx] += 1
            # occupancy sample point: post-fire, pre-drain
            for k, a in enumerate(p["arcs"]):
                if full[a]:
                    ab[k] += 1
                    ahw[k] = 1
        # 3. drain
        for a in p["output_arcs"]:
            if full[a]:
                out_last[a] = val[a]
                out_count[a] += 1
                full[a] = False
                progress = True
        cycles += 1
    prof_obj = node_fires = None
    if profile:
        from repro_torch.obs.profile import FabricProfile
        node_names, arc_names = FabricProfile.names_for(graph)
        prof_obj = FabricProfile(
            node_names=node_names, arc_names=arc_names,
            node_fires=nf, stall_in=si, stall_out=so,
            arc_busy=ab, arc_hw=ahw, cycles=cycles, dispatches=0)
        node_fires = nf
    return EngineResult(outputs=out_last, counts=out_count, cycles=cycles,
                        fired=fired, node_fires=node_fires,
                        profile=prof_obj)
