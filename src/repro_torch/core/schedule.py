"""Static firing schedules: compile the interpreter away on control-free
fabrics (PyTorch port of ``repro.core.schedule``).

On a fabric whose token routing is value-independent — acyclic, no
BRANCH/NDMERGE/DMERGE, no one-shot init tokens — arc *presence* evolves
independently of arc *values*: whether a node fires on cycle t is a
function of the feed lengths alone.  This module simulates that boolean
presence automaton once on the host (numpy), detects its steady-state
period, and hands the resulting cycle-exact firing schedule (prologue +
steady-state period + epilogue) to two table-driven kernels with no
ready-mask reduction and no empty-output checks: each scheduled cycle
touches only the arcs that actually move.

The pieces, in dependency order:

* :func:`schedule_blockers` — the schedulability probe.
* :class:`CyclePattern` — one deduplicated cycle's worth of schedule:
  which feed rows load, which plan rows fire, which output rows drain,
  the post-cycle register occupancy, and the per-cycle profile
  increments.  Patterns are value-free and shared across every concrete
  plan of the fabric.
* :class:`ConcretePlan` — the schedule for one tuple of feed lengths: a
  run-length-encoded sequence of pattern ids, built lazily by stepping
  the presence automaton; when the automaton's state (arc occupancy +
  which feed rows still have tokens) repeats, the cycles between the
  two occurrences are a *period* fast-forwarded in closed form
  (``k = min_r floor(rem_r / c_r)`` whole periods, where ``c_r`` is the
  period's per-row feed consumption).
* run path — the plan's clipped segments, flattened into a program
  (segment offsets into a pid list, segment lengths, repetitions), run
  by one launch of the scheduled-run kernel
  (:func:`repro_torch.kernels.schedule_fire.sched_run_cuda`) over
  per-pattern tables: nothing is generated or compiled per schedule.
  On the ``"torch"`` backend the same program runs as PyTorch code
  (:func:`_run_torch_sched`), for int32, uint32 or float32 tokens of any
  shape; the ``"reference"`` backend interprets it in numpy.
* slot path — per-pattern gather tables indexed by a host-computed pid
  window, K table-driven cycles per launch
  (:func:`repro_torch.kernels.schedule_fire.sched_slot_step_cuda`);
  per-slot clocks advance on the host from the plan, with no device read
  per block.  Scalar int32 tokens (the ``"cuda"`` backend) only.

Results are bit-identical to :func:`repro_torch.core.engine.run_reference`
in every field (values, counts, cycles, node_fires, per-arc registers at
block boundaries).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import (_alu_numpy, _alu_op, from_carrier,
                                     pack_feeds, to_carrier)
from repro_torch.core.graph import Graph, Op

_CONTROL_OPS = (Op.BRANCH, Op.NDMERGE, Op.DMERGE)

# presence-automaton step budget per concrete plan: a plan that has not
# quiesced or locked onto a period within this many host-stepped cycles
# is pathological (the state space is finite but can be huge);
# construction bails and the caller falls back to the dynamic engine — a
# performance decision, never a correctness one.
BAIL_STEPS = 65536

_E32 = np.zeros((0,), np.int32)


class ScheduleBail(RuntimeError):
    """Schedule construction exceeded its step budget; the dynamic engine
    remains the executor for this (pathological) fabric."""


def schedule_blockers(graph: Graph) -> tuple[str, ...]:
    """Why this graph cannot be statically scheduled (empty = it can):
    value-dependent routing (BRANCH/DMERGE/NDMERGE), cycles, or one-shot
    init tokens make the firing pattern depend on token *values*, so the
    presence automaton would not be value-free."""
    why = []
    if graph.is_cyclic():
        why.append("cyclic fabric")
    ops = sorted({n.op.name for n in graph.nodes if n.op in _CONTROL_OPS})
    if ops:
        why.append(f"control ops {ops}")
    if graph.inits:
        why.append("one-shot init tokens")
    return tuple(why)


def schedulable(graph: Graph) -> bool:
    return not schedule_blockers(graph)


class CyclePattern:
    """One deduplicated scheduled cycle (value-free).

    fed        int32 rows into the plan's input_arcs that load a token
    fed_arcs   the matching arc indices
    fire       int32 plan node rows that fire this cycle
    drain      int32 rows into output_arcs that drain a token
    drain_arcs the matching arc indices
    busy       bool[A2] post-fire/pre-drain occupancy (the profile's
               sample point; pads cleared)
    full_after bool[A2] post-drain occupancy — the arc registers a block
               ending on this cycle must expose (FULL_PAD set)
    bundles    opcode-bucketed fire table: (op, in0[k], in1[k],
               out_flat[2k]) with missing outputs mapped to the
               out-of-range drop sentinel A2
    nf/si/so/ab/ahw _inc   per-cycle profile counter increments
    """

    __slots__ = ("pid", "fed", "fed_arcs", "fire", "drain", "drain_arcs",
                 "busy", "full_after", "bundles", "n_fires", "n_drains",
                 "nf_inc", "si_inc", "so_inc", "ab_inc", "ahw_inc")

    def __init__(self, pid, p, fed, fed_arcs, fire, drain, drain_arcs,
                 busy, ir, full_after):
        self.pid = pid
        self.fed = fed
        self.fed_arcs = fed_arcs
        self.fire = fire
        self.drain = drain
        self.drain_arcs = drain_arcs
        self.busy = busy
        self.full_after = full_after
        self.n_fires = int(fire.size)
        self.n_drains = int(drain.size)
        ready = np.zeros((len(p["opcode"]),), bool)
        ready[fire] = True
        # profile partition: fired / blocked on input / blocked on output
        self.nf_inc = ready.astype(np.int64)
        self.si_inc = (~ir).astype(np.int64)
        self.so_inc = (ir & ~ready).astype(np.int64)
        self.ab_inc = busy.astype(np.int64)
        self.ahw_inc = busy.astype(np.int64)
        # opcode buckets (plan rows are opcode-sorted under optimize; a
        # stable argsort covers the unoptimized layout too)
        A2 = p["A"] + 2
        rows = fire[np.argsort(p["opcode"][fire], kind="stable")]
        bundles = []
        s = 0
        while s < rows.size:
            e = s
            op = int(p["opcode"][rows[s]])
            while e < rows.size and int(p["opcode"][rows[e]]) == op:
                e += 1
            rr = rows[s:e]
            out = p["out_idx"][rr].copy()           # [k, 2]
            out[out == p["EMPTY_PAD"]] = A2         # drop sentinel
            bundles.append((Op(op), p["in_idx"][rr, 0].copy(),
                            p["in_idx"][rr, 1].copy(), out.reshape(-1)))
            s = e
        self.bundles = bundles


class ConcretePlan:
    """The cycle-exact schedule for one tuple of feed lengths.

    ``segments`` is a run-length-encoded pid sequence: ``[(pids, reps),
    ...]`` meaning the ``pids`` cycle tuple repeats ``reps`` times.
    ``total`` counts scheduled cycles including the one trailing idle
    cycle a quiescing fabric spends detecting its own quiescence
    (matching ``run_reference``'s cycle accounting).  The plan is
    cap-agnostic and lazily extended: ``ensure(t)`` grows it to cover at
    least ``t`` cycles (a no-op once quiesced)."""

    def __init__(self, ctx: "ScheduleContext", flen: tuple[int, ...]):
        self.ctx = ctx
        self.flen = flen
        p = ctx.p
        full = np.zeros((ctx.A2,), bool)
        full[p["FULL_PAD"]] = True
        full[ctx.const_rows] = True
        self._full = full
        self._rem = np.asarray(flen, np.int64).copy()
        self.segments: list[tuple[tuple[int, ...], int]] = []
        self.total = 0
        self.quiesced = False
        self.idle_pid = None
        self._free = None            # free-running period (never quiesces)
        self._tail: list[int] = []   # pids since the last segment close
        self._seen: dict = {}
        self._stepped = 0
        self._record()

    # -- construction -----------------------------------------------------
    def _state_key(self):
        return (self._full.tobytes(), (self._rem > 0).tobytes())

    def _record(self):
        self._seen[self._state_key()] = (len(self._tail), self._rem.copy())

    def ensure(self, want: int) -> None:
        want = int(want)
        while not self.quiesced and self.total < want:
            if self._free is not None:
                q = len(self._free)
                reps = -(-(want - self.total) // q)
                self.segments.append((self._free, reps))
                self.total += reps * q
                return
            self._step()

    def _step(self):
        self._stepped += 1
        if self._stepped > BAIL_STEPS:
            raise ScheduleBail(
                f"no period within {BAIL_STEPS} cycles for feed "
                f"lengths {self.flen}")
        pid, progress = self.ctx.observe(self._full, self._rem)
        self._tail.append(pid)
        self.total += 1
        if not progress:
            # idle is absorbing: state unchanged forever after
            self.idle_pid = pid
            self.quiesced = True
            self.segments.append((tuple(self._tail), 1))
            self._tail = []
            self._seen = {}
            return
        key = self._state_key()
        prev = self._seen.get(key)
        if prev is None:
            self._seen[key] = (len(self._tail), self._rem.copy())
            return
        i, rem_i = prev
        period = tuple(self._tail[i:])
        c = rem_i - self._rem        # per-row feed consumption / period
        if not c.any():
            # progress with zero feed consumption from a repeated state:
            # the period repeats forever (free-running fabric)
            if i > 0:
                self.segments.append((tuple(self._tail[:i]), 1))
            self.segments.append((period, 1))
            self._free = period
            self._tail = []
            self._seen = {}
            return
        # fast-forward: k more whole periods are valid as long as no feed
        # row runs dry mid-period — the last feed event of row r in
        # replay m needs rem_r - (m+1)*c_r >= 0, so
        # k = min_{c_r > 0} floor(rem_r / c_r)
        k = int((self._rem[c > 0] // c[c > 0]).min())
        if k <= 0:
            # can't jump; re-anchor the detection on this occurrence (the
            # regime diverges within one period)
            self._seen[key] = (len(self._tail), self._rem.copy())
            return
        if i > 0:
            self.segments.append((tuple(self._tail[:i]), 1))
        self.segments.append((period, 1 + k))
        self.total += k * len(period)
        self._rem -= k * c
        self._tail = []
        self._seen = {}
        self._record()

    # -- accounting -------------------------------------------------------
    @property
    def progress_total(self):
        """1-based count of progress cycles (None = unbounded)."""
        return self.total - 1 if self.quiesced else None

    def _iter_clipped(self, upto: int):
        """RLE segments covering exactly cycles [0, upto) — clipping the
        last segment and extending a quiesced plan with idle."""
        t = 0
        for pids, reps in self.segments:
            if t >= upto:
                return
            q = len(pids)
            span = q * reps
            if t + span <= upto:
                yield pids, reps
                t += span
            else:
                fr, part = divmod(upto - t, q)
                if fr:
                    yield pids, fr
                if part:
                    yield pids[:part], 1
                t = upto
        if t < upto and self._tail:
            # cycles explored past the last closed segment (a cap can land
            # before the first period locks or the fabric quiesces)
            n = min(len(self._tail), upto - t)
            yield tuple(self._tail[:n]), 1
            t += n
        if t < upto:
            assert self.quiesced, "ensure() the plan before slicing it"
            yield (self.idle_pid,), upto - t

    def trace_struct(self, upto: int):
        """(structure, reps) of cycles [0, upto): the segments as
        ``((pids, repeated), ...)`` and the trip counts of the repeated
        ones (``[0]`` when none repeats) — the run program the
        scheduled-run kernel takes once flattened
        (:func:`repro_torch.kernels.schedule_fire.flat_program`)."""
        segs = list(self._iter_clipped(upto))
        struct = tuple((tuple(pids), reps > 1) for pids, reps in segs)
        reps = np.asarray([r for _, r in segs if r > 1] or [0], np.int32)
        return struct, reps

    def counts_upto(self, t: int) -> dict[int, int]:
        c: dict[int, int] = {}
        for pids, reps in self._iter_clipped(t):
            for pid in pids:
                c[pid] = c.get(pid, 0) + reps
        return c

    def counts_between(self, lo: int, hi: int) -> dict[int, int]:
        hi_c = self.counts_upto(hi)
        if lo:
            for pid, n in self.counts_upto(lo).items():
                hi_c[pid] -= n
        return {pid: n for pid, n in hi_c.items() if n}

    def fires_between(self, lo: int, hi: int) -> int:
        reg = self.ctx.registry
        return sum(n * reg[pid].n_fires
                   for pid, n in self.counts_between(lo, hi).items())

    def pids_window(self, lo: int, hi: int) -> np.ndarray:
        """Dense pid sequence for cycles [lo, hi) (the slot path's
        per-block kernel operand)."""
        out = np.empty((hi - lo,), np.int32)
        w = 0
        t = 0
        for pids, reps in self._iter_clipped(hi):
            q = len(pids)
            span = q * reps
            if t + span <= lo:
                t += span
                continue
            arr = np.asarray(pids, np.int32)
            s = max(lo - t, 0)
            e = min(hi - t, span)
            out[w:w + e - s] = arr[np.arange(s, e) % q]
            w += e - s
            t += span
        assert w == hi - lo
        return out


class SlotSched:
    """Host side of scheduled slots: per-slot plan refs + schedule
    positions, and (profiled engines) the host-accumulated profile
    counters — scheduled profiles are closed-form, never device state."""

    def __init__(self, ctx: "ScheduleContext", slots: int, profile: bool):
        self.ctx = ctx
        self.plans: list[ConcretePlan | None] = [None] * slots
        self.pos = np.zeros((slots,), np.int64)
        self.profile = profile
        if profile:
            n, a2 = ctx.n_nodes, ctx.A2
            self.nf = np.zeros((slots, n), np.int64)
            self.si = np.zeros((slots, n), np.int64)
            self.so = np.zeros((slots, n), np.int64)
            self.ab = np.zeros((slots, a2), np.int64)
            self.ahw = np.zeros((slots, a2), np.int64)

    def reset(self, b: int, plan: ConcretePlan) -> None:
        self.plans[b] = plan
        self.pos[b] = 0
        if self.profile:
            for x in (self.nf, self.si, self.so, self.ab, self.ahw):
                x[b] = 0

    def accrue(self, b: int, counts: dict[int, int]) -> None:
        reg = self.ctx.registry
        for pid, n in counts.items():
            pat = reg[pid]
            self.nf[b] += n * pat.nf_inc
            self.si[b] += n * pat.si_inc
            self.so[b] += n * pat.so_inc
            self.ab[b] += n * pat.ab_inc
            np.maximum(self.ahw[b], pat.ahw_inc, out=self.ahw[b])

    def prof_row(self, b: int):
        return (self.nf[b], self.si[b], self.so[b], self.ab[b],
                self.ahw[b])


class ScheduleContext:
    """Per-engine schedule state: the pattern registry (shared across
    every concrete plan of the fabric), the plan cache keyed by feed
    lengths, and the per-pattern tables of both kernels."""

    def __init__(self, p, graph: Graph, token_shape=(), dtype=np.int32):
        self.p = p
        self.graph = graph
        # tokens of the "torch" and "reference" runs; the kernels' tables
        # and the slot path are scalar int32
        self.token_shape = tuple(token_shape)
        self.np_dtype = np.dtype(dtype)
        self.A2 = p["A"] + 2
        self.n_nodes = len(p["opcode"])
        self.in_arc = np.asarray(
            [p["aidx"][a] for a in p["input_arcs"]], np.int32)
        self.out_arc = np.asarray(
            [p["aidx"][a] for a in p["output_arcs"]], np.int32)
        self.const_rows = np.nonzero(p["const_mask"])[0].astype(np.int32)
        # padded arc-index rows matching the slot state's n_in/n_out (>= 1
        # each; pad feed rows never load, pad drain reads hit the
        # always-empty EMPTY_PAD register)
        self.ia_pad = np.zeros((max(self.in_arc.size, 1),), np.int32)
        self.ia_pad[:self.in_arc.size] = self.in_arc
        self.oa_pad = np.full((max(self.out_arc.size, 1),),
                              p["EMPTY_PAD"], np.int32)
        self.oa_pad[:self.out_arc.size] = self.out_arc
        self.registry: list[CyclePattern] = []
        self._pid_by_key: dict = {}
        self._plans: dict[tuple[int, ...], ConcretePlan] = {}
        self._tables = None
        self._tables_len = 0
        self.device_tables: dict = {}   # kernels.schedule_fire's uploads
        self._torch_pats: dict = {}     # (pid, device) -> _TorchPattern
        # reserved pid 0: the no-op filler inactive slots execute.  It is
        # registered under no key (a real all-quiet cycle must get its own
        # pattern: its full_after differs — FULL_PAD, consts, possibly
        # tokens stuck at quiescence) and its full_after is never applied
        # (fsel == -1 gates it).
        self._register(_E32, _E32, _E32, _E32, _E32,
                       np.zeros((self.A2,), bool),
                       np.zeros((self.n_nodes,), bool),
                       np.zeros((self.A2,), bool), key=None)

    # -- pattern registry -------------------------------------------------
    def _register(self, fed, fed_arcs, fire, drain, drain_arcs, busy, ir,
                  full_after, key):
        pid = len(self.registry)
        pat = CyclePattern(pid, self.p, fed, fed_arcs, fire, drain,
                           drain_arcs, busy, ir, full_after)
        self.registry.append(pat)
        if key is not None:
            self._pid_by_key[key] = pid
        return pid

    def observe(self, full: np.ndarray, rem: np.ndarray):
        """Advance the presence automaton one cycle in place; return
        (pattern id, progress).  Mirrors run_reference's cycle: feed ->
        simultaneous fire -> const restore -> occupancy sample -> drain."""
        p = self.p
        ia, oa = self.in_arc, self.out_arc
        fed = _E32
        if ia.size:
            can = (~full[ia]) & (rem > 0)
            fed = np.nonzero(can)[0].astype(np.int32)
            if fed.size:
                full[ia[fed]] = True
                rem[fed] -= 1
        inf = full[p["in_idx"]]                   # [N, 3]; pads full
        ir = inf.all(axis=1)
        ready = ir & ~full[p["out_idx"]].any(axis=1)
        fire = np.nonzero(ready)[0].astype(np.int32)
        if fire.size:
            full[p["in_idx"][fire].reshape(-1)] = False
            full[p["out_idx"][fire].reshape(-1)] = True
            full[p["FULL_PAD"]] = True
            full[p["EMPTY_PAD"]] = False
        full[self.const_rows] = True              # consts are sticky-full
        busy = full.copy()
        busy[p["FULL_PAD"]] = False
        busy[p["EMPTY_PAD"]] = False
        drain = _E32
        if oa.size:
            drain = np.nonzero(full[oa])[0].astype(np.int32)
            if drain.size:
                full[oa[drain]] = False
        progress = bool(fed.size or fire.size or drain.size)
        key = (fed.tobytes(), fire.tobytes(), drain.tobytes(),
               np.packbits(busy).tobytes())
        pid = self._pid_by_key.get(key)
        if pid is None:
            pid = self._register(fed, ia[fed], fire, drain, oa[drain],
                                 busy, ir, full.copy(), key=key)
        return pid, progress

    def plan_for(self, flen: tuple[int, ...]) -> ConcretePlan:
        plan = self._plans.get(flen)
        if plan is None:
            plan = ConcretePlan(self, flen)
            self._plans[flen] = plan
            if len(self._plans) > 512:       # bound serve-path growth
                self._plans.pop(next(iter(self._plans)))
        return plan

    # -- profile reconstruction ------------------------------------------
    def profile_counts(self, plan: ConcretePlan, lo: int, hi: int):
        """Closed-form profile counters over cycles [lo, hi) — bit-equal
        to what the reference oracle accumulates cycle by cycle."""
        nf = np.zeros((self.n_nodes,), np.int64)
        si = np.zeros((self.n_nodes,), np.int64)
        so = np.zeros((self.n_nodes,), np.int64)
        ab = np.zeros((self.A2,), np.int64)
        ahw = np.zeros((self.A2,), np.int64)
        for pid, n in plan.counts_between(lo, hi).items():
            pat = self.registry[pid]
            nf += n * pat.nf_inc
            si += n * pat.si_inc
            so += n * pat.so_inc
            ab += n * pat.ab_inc
            np.maximum(ahw, pat.ahw_inc, out=ahw)
        return nf, si, so, ab, ahw

    def state0_val(self) -> np.ndarray:
        """val[A2, *token_shape] of a fresh run: the const buses' values
        (int32 [A2] on the kernels' engines)."""
        val = np.zeros((self.A2, *self.token_shape), self.np_dtype)
        for a, v in self.graph.consts.items():
            val[self.p["aidx"][a]] = v
        return val

    def torch_pattern(self, pid: int, device) -> "_TorchPattern":
        """Pattern ``pid``'s index tables on ``device`` (built once)."""
        key = (pid, str(device))
        tp = self._torch_pats.get(key)
        if tp is None:
            tp = self._torch_pats[key] = _TorchPattern(
                self.registry[pid], self.A2, device)
        return tp

    # -- per-pattern tables -------------------------------------------------
    def slot_tables(self):
        """Per-pattern gather tables (numpy int32), rebuilt when the
        registry grows; P and F pad to powers of two.  In order: t_op,
        t_i0, t_i1, t_o0, t_o1 [P, F] (pad rows: COPY of FULL_PAD into the
        drop sentinel A2), t_feed [P, n_in], t_drain [P, n_out], t_full
        [P, A2]."""
        if self._tables is None or self._tables_len < len(self.registry):
            reg = self.registry
            np2 = lambda n: 1 << max(0, int(n - 1).bit_length())
            P = np2(len(reg))
            F = np2(max([p.n_fires for p in reg] + [1]))
            n_in_p = max(self.in_arc.size, 1)
            n_out_p = max(self.out_arc.size, 1)
            p = self.p
            t_op = np.full((P, F), int(Op.COPY), np.int32)
            t_i0 = np.full((P, F), p["FULL_PAD"], np.int32)
            t_i1 = np.full((P, F), p["FULL_PAD"], np.int32)
            t_o0 = np.full((P, F), self.A2, np.int32)   # drop sentinel
            t_o1 = np.full((P, F), self.A2, np.int32)
            t_feed = np.zeros((P, n_in_p), np.int32)
            t_drain = np.zeros((P, n_out_p), np.int32)
            t_full = np.zeros((P, self.A2), np.int32)
            for pat in reg:
                k = pat.n_fires
                if k:
                    rows = pat.fire
                    t_op[pat.pid, :k] = p["opcode"][rows]
                    t_i0[pat.pid, :k] = p["in_idx"][rows, 0]
                    t_i1[pat.pid, :k] = p["in_idx"][rows, 1]
                    out = p["out_idx"][rows].copy()
                    out[out == p["EMPTY_PAD"]] = self.A2
                    t_o0[pat.pid, :k] = out[:, 0]
                    t_o1[pat.pid, :k] = out[:, 1]
                t_feed[pat.pid, pat.fed] = 1
                t_drain[pat.pid, pat.drain] = 1
                t_full[pat.pid] = pat.full_after
            self._tables = (t_op, t_i0, t_i1, t_o0, t_o1, t_feed, t_drain,
                            t_full)
            self._tables_len = len(reg)
        return self._tables


# ---------------------------------------------------------------------------
# engine entry points (called from DataflowEngine; lazy — this module
# imports the engine, not the other way around at module scope)
# ---------------------------------------------------------------------------
def plan_key(eng, fl) -> tuple[int, ...]:
    """The plan key of packed feed lengths ``fl``: those of the fabric's
    real input rows (the port packs at least one row, a pad row on
    input-free fabrics)."""
    return tuple(int(x) for x in fl[:len(eng.p["input_arcs"])])


def run_scheduled(eng, feeds, max_cycles: int):
    """Scheduled run() path for any backend.  Raises ScheduleBail if the
    plan never locks onto a period in budget (the caller falls back to
    the dynamic engine)."""
    ctx = eng._sched_ctx()
    fv, fl = pack_feeds(eng.p["input_arcs"], feeds, eng.token_shape,
                        ctx.np_dtype, pad_rows=1)
    plan = ctx.plan_for(plan_key(eng, fl))
    plan.ensure(max_cycles)
    exec_ = min(plan.total, max_cycles)
    if eng.backend == "reference":
        return _run_reference_sched(eng, ctx, plan, fv, exec_)
    if eng.backend == "torch":
        return _run_torch_sched(eng, ctx, plan, fv[None], exec_)[0]
    return _run_device_sched(eng, ctx, plan, fv[None], exec_)[0]


def run_batch_scheduled(eng, feeds_batch, max_cycles: int):
    """Scheduled run_batch() path: one launch for every stream when they
    all share one feed-length tuple (so one schedule covers the batch).
    Returns None on mixed-length batches — the dynamic path handles
    those."""
    ctx = eng._sched_ctx()
    length = max((max((np.shape(v)[0] for v in (f or {}).values()),
                      default=0) for f in feeds_batch), default=0)
    packed = [pack_feeds(eng.p["input_arcs"], f, eng.token_shape,
                         ctx.np_dtype, pad_rows=1, min_len=max(length, 1))
              for f in feeds_batch]
    flens = {plan_key(eng, fl) for _, fl in packed}
    if len(flens) != 1:
        return None
    plan = ctx.plan_for(flens.pop())
    plan.ensure(max_cycles)
    exec_ = min(plan.total, max_cycles)
    if eng.backend == "reference":
        return [_run_reference_sched(eng, ctx, plan, fv, exec_)
                for fv, _ in packed]
    fvb = np.stack([fv for fv, _ in packed])
    if eng.backend == "torch":
        return _run_torch_sched(eng, ctx, plan, fvb, exec_)
    return _run_device_sched(eng, ctx, plan, fvb, exec_)


def _run_device_sched(eng, ctx, plan, fvb, exec_):
    """One launch of the scheduled-run kernel over B streams that share
    ``plan``; profiles are closed-form from the plan."""
    from repro_torch.kernels import schedule_fire as _ksf
    program = _ksf.flat_program(*plan.trace_struct(exec_))
    tables = _ksf.device_sched_tables(ctx, eng.device)
    fv = torch.as_tensor(fvb, device=eng.device)
    ol, oc = _ksf.sched_run_cuda(tables, program, fv)
    host = torch.cat([ol, oc], 1).cpu().numpy()
    n_out = ol.shape[1]
    fired = plan.fires_between(0, exec_)
    prof = None
    if eng.profile:
        prof = (*ctx.profile_counts(plan, 0, exec_), exec_, 1)
    return [eng._result_from_state(host[b, :n_out], host[b, n_out:], exec_,
                                   fired, 1, prof=prof)
            for b in range(fvb.shape[0])]


class _TorchPattern:
    """One :class:`CyclePattern`'s index tables as tensors on a device,
    and its cycle as PyTorch code (the ``"torch"`` scheduled run)."""

    def __init__(self, pat: CyclePattern, A2: int, device):
        t = lambda x: torch.as_tensor(np.array(x, np.int64), device=device)
        self.fed = t(pat.fed) if pat.fed.size else None
        self.fed_arcs = t(pat.fed_arcs)
        self.drain = t(pat.drain) if pat.drain.size else None
        self.drain_arcs = t(pat.drain_arcs)
        # per bundle: op, operand arcs, the arcs written (drop sentinels
        # left out) and the fire row each takes its value from
        self.bundles = []
        for op, i0, i1, out in pat.bundles:
            ok = np.nonzero(out < A2)[0]
            self.bundles.append((op, t(i0), t(i1), t(out[ok]), t(ok // 2)))

    def apply(self, val, fv, ptr, ol, dtype) -> None:
        """Feed, fire and drain in place on B streams' registers ``val``
        [B, A2, *ts], streams ``fv`` [B, n_in, L, *ts], pointers ``ptr``
        [n_in] (the same for every stream) and ``ol`` [B, n_out, *ts].
        Every bundle reads the registers before any writes: produced and
        consumed arcs are disjoint within a cycle."""
        if self.fed is not None:
            val[:, self.fed_arcs] = fv[:, self.fed, ptr[self.fed]]
            ptr[self.fed] += 1
        zs = [(out, src, _alu_op(op, val[:, i0], val[:, i1], dtype))
              for op, i0, i1, out, src in self.bundles]
        for out, src, z in zs:
            val[:, out] = z[:, src]
        if self.drain is not None:
            ol[:, self.drain] = val[:, self.drain_arcs]


@torch.inference_mode()
def _run_torch_sched(eng, ctx, plan, fvb, exec_):
    """The straight-line scheduled program as PyTorch code on the engine's
    device, over B streams that share ``plan``: the plan's clipped
    segments in order, a repeated period as a host loop over its
    repetitions, each cycle its pattern's feed gather, bucketed fire and
    drain.  Feed pointers and output counts are the same for every stream
    (one plan), so the counts stay on the host; profiles are closed-form
    from the plan, and ``dispatches`` is 1 as on the dynamic ``"torch"``
    run."""
    dev, ts = eng.device, ctx.token_shape
    struct, reps = plan.trace_struct(exec_)
    fv = to_carrier(fvb, ctx.np_dtype, dev)
    B = fv.shape[0]
    val0 = to_carrier(ctx.state0_val(), ctx.np_dtype, dev)
    val = val0.expand(B, *val0.shape).clone()
    ptr = torch.zeros((fv.shape[1],), dtype=torch.long, device=dev)
    n_out = ctx.out_arc.size
    ol = torch.zeros((B, max(n_out, 1), *ts), dtype=val.dtype, device=dev)
    oc = np.zeros((max(n_out, 1),), np.int64)
    r = 0
    for pids, dyn in struct:
        n = int(reps[r]) if dyn else 1
        r += dyn
        pats = [(ctx.torch_pattern(pid, dev), ctx.registry[pid].drain)
                for pid in pids]
        for _ in range(n):
            for tp, drain in pats:
                tp.apply(val, fv, ptr, ol, ctx.np_dtype)
                oc[drain] += 1
    olh = from_carrier(ol, ctx.np_dtype)
    fired = plan.fires_between(0, exec_)
    prof = None
    if eng.profile:
        prof = (*ctx.profile_counts(plan, 0, exec_), exec_, 1)
    return [eng._result_from_state(olh[b][:n_out], oc[:n_out], exec_,
                                   fired, 1, prof=prof)
            for b in range(B)]


def _run_reference_sched(eng, ctx, plan, fv, exec_):
    """Numpy schedule interpreter — the scheduled mirror of
    run_reference (same dispatches=None result shape, profile
    dispatches=0)."""
    with np.errstate(all="ignore"):
        val = ctx.state0_val()
        ptr = np.zeros((max(ctx.in_arc.size, 1),), np.int64)
        n_out = ctx.out_arc.size
        ol = np.zeros((n_out, *ctx.token_shape), ctx.np_dtype)
        oc = np.zeros((n_out,), np.int64)
        for pid in plan.pids_window(0, exec_):
            pat = ctx.registry[pid]
            if pat.fed.size:
                val[pat.fed_arcs] = fv[pat.fed, ptr[pat.fed]]
                ptr[pat.fed] += 1
            for op, i0, i1, out in pat.bundles:
                z2 = np.repeat(_alu_numpy(op, val[i0], val[i1],
                                          ctx.np_dtype), 2, axis=0)
                ok = out < ctx.A2
                val[out[ok]] = z2[ok]
            if pat.drain.size:
                ol[pat.drain] = val[pat.drain_arcs]
                oc[pat.drain] += 1
    fired = plan.fires_between(0, exec_)
    prof = None
    if eng.profile:
        prof = (*ctx.profile_counts(plan, 0, exec_), exec_, 0)
    return eng._result_from_state(ol, oc, exec_, fired, None, prof=prof)


def step_block_sched(eng, state, nb: int):
    """Scheduled step_block: host-computed pid windows drive one launch of
    the scheduled slot-step kernel; per-slot clocks (base/last/fired/
    quiesced/stalled) advance from the plan in closed form — no device
    read per block (the dynamic path needs one)."""
    from repro_torch.kernels import schedule_fire as _ksf
    ctx = eng._sched_ctx()
    sc = state.sched
    B = state.slots
    pidm = np.zeros((B, nb), np.int32)
    fsel = np.full((B,), -1, np.int32)
    f = np.zeros((B,), np.int64)
    lp = np.zeros((B,), np.int64)
    for b in range(B):
        if not state.active[b]:
            continue
        plan = sc.plans[b]
        pos0 = int(sc.pos[b])
        plan.ensure(pos0 + nb)
        pidm[b] = plan.pids_window(pos0, pos0 + nb)
        fsel[b] = pidm[b, -1]
        p_tot = plan.progress_total
        hi = pos0 + nb if p_tot is None else min(p_tot, pos0 + nb)
        lp[b] = max(0, hi - pos0)
        f[b] = plan.fires_between(pos0, pos0 + nb)
        if eng.profile:
            sc.accrue(b, plan.counts_between(pos0, pos0 + nb))
        sc.pos[b] = pos0 + nb
    tables = _ksf.device_sched_tables(ctx, eng.device)
    full, val, ptr, out_last, out_count = _ksf.sched_slot_step_cuda(
        tables, state.fv, pidm, fsel, state.full, state.val, state.ptr,
        state.out_last, state.out_count)
    # host clocks: identical formulas to the dynamic step_block, with
    # (f, lp) read off the plan instead of from the device
    fired = state.fired + f
    last = np.where(lp > 0, state.base + lp, state.last)
    base = state.base + np.where(state.active > 0, nb, 0)
    quiesced = np.where(state.active > 0, lp < nb, state.quiesced)
    disp = state.dispatches + (state.active > 0)
    stalled = np.where(state.active > 0,
                       np.where(lp > 0, 0, state.stalled + 1),
                       state.stalled)
    prof_cycles = state.prof_cycles
    if eng.profile and prof_cycles is not None:
        prof_cycles = prof_cycles + np.where(state.active > 0, nb, 0)
    return dataclasses.replace(
        state, full=full, val=val, ptr=ptr, out_last=out_last,
        out_count=out_count, active=state.active.copy(), base=base,
        last=last, fired=fired, quiesced=quiesced, dispatches=disp,
        stalled=stalled, prof_cycles=prof_cycles, sched=sc)
