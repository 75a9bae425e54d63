"""Helpers shared by the port's tests and ``chip_smoke.py``: random
fabrics, random mid-run inputs for the fire block (and its counters),
and one checker for engine results.
"""
from __future__ import annotations

import numpy as np

# operands at the edges of int32 arithmetic: overflow, the INT_MIN // -1
# wrap, shift counts beyond the clip, signs
EDGE_VALS = np.asarray([-(2 ** 31), 2 ** 31 - 1, -1, 0, 1, 31, 32, -32],
                       np.int64)

# the same edges for the other token dtypes (one entry for each of
# EDGE_VALS, so a seed draws the same graph shape in every dtype):
# unsigned wraparound, and float signed zeros, infinities and magnitudes
EDGE_VALS_BY_DTYPE = {
    "int32": EDGE_VALS,
    "uint32": np.asarray([2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1, 0, 1, 31, 32,
                          40], np.int64),
    "float32": np.asarray([-np.inf, 3.0e38, -1.5, -0.0, 0.0, 1.0, np.inf,
                           -200.0], np.float32),
}
# float SHL/SHR operands of the random graphs: integral, in [-149, 126],
# where numpy's and torch's exp2 agree bit for bit (ROADMAP C8)
FLOAT_SHIFTS = np.asarray([-149, -126, -13, -1, 0, 1, 13, 126], np.float32)

# sha256 of asm.emit of each traced bench of core/library.py, as torch
# 2.13's capture builds it (the same text as the JAX package's fabric):
# the CPU tests and chip_smoke.py hold every trace to these, so a capture
# that drifts with the torch version fails instead of running another
# fabric
TRACED_ASM_SHA256 = {
    "dot_prod_traced":
        "9a3d8b22c3f0cc8770e5410028d657d80b267201f59799fcaeca42bacfde83fa",
    "pop_count_traced":
        "a988a747b970d3f016372ae09841e2590c8207e8996f7babf942c2d2f865e516",
    "fir_traced":
        "ae4e0ce258fa21c5787dfbcbb9993fb3464cb6f8ba337d3b35853e1319350449",
    "horner":
        "4e39a2fa4899ee4bca78059d133fa71592edd6c6a18b4e0be2a4c0bb30f442c9",
    "saxpy":
        "f6eb5c2ce6ad564773f1319e4db54b82fc7119fadd531b78bef41304d779198e",
    "relu_chain":
        "a028b8d40f645dae97c07b50ca6fc5b3bfa5a4c00a41e80fd80218ca99d3ccaa",
    "gcd":
        "48651efbe7d9105cee124560ce0d8c23f69c12a32490391bec3fb9f5fe44f9c0",
    "fib":
        "ba15c3fead66ad04eead3cc38b15be9760cfa52ac1987f8492e43a0136b6e303",
    "newton_sqrt":
        "1ef6dd67ded2ee00b6ddcb2e1c130f264385d736545fadbb7954bfbd64483286",
    "horner_loop":
        "7f4b82a81aa73c11a0e0378dd6eaa973263e446da6d449f7dbac207032721b8b",
}


def asm_sha256(graph) -> str:
    """The digest :data:`TRACED_ASM_SHA256` pins: sha256 of asm.emit."""
    import hashlib
    from repro_torch.core import asm
    return hashlib.sha256(asm.emit(graph).encode()).hexdigest()


STATE_KEYS = ("full", "val", "ptr", "out_last", "out_count")
PROFILE_ARRAYS = ("node_fires", "stall_in", "stall_out", "arc_busy",
                  "arc_hw")


def random_block_inputs(tables, B: int, L: int, rng) -> dict:
    """Random mid-run inputs for a B-stream fire block over a fabric's
    :func:`~repro_torch.kernels.dataflow_fire.block_plan_arrays` tables,
    as int32 numpy arrays: register bits and values (a third of them
    edge operands), feed streams and pointers, accumulators, and an
    ``active`` gate with about a quarter of the streams parked.  The pad
    slots and const buses hold what a running fabric holds there."""
    p = tables["plan"]
    A2 = p["A"] + 2
    n_in = tables["in_arc_idx"].shape[0]
    n_out = tables["out_arc_idx"].shape[0]

    def i32(*shape):
        return rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)

    full = rng.integers(0, 2, (B, A2)).astype(np.int32)
    full[:, p["FULL_PAD"]] = 1
    full[:, p["EMPTY_PAD"]] = 0
    full[:, np.nonzero(p["const_mask"])[0]] = 1
    val = np.where(rng.random((B, A2)) < 0.3, rng.choice(EDGE_VALS, (B, A2)),
                   i32(B, A2)).astype(np.int32)
    feed_vals = np.where(rng.random((B, n_in, L)) < 0.3,
                         rng.choice(EDGE_VALS, (B, n_in, L)),
                         i32(B, n_in, L)).astype(np.int32)
    feed_len = rng.integers(0, L + 1, (B, n_in)).astype(np.int32)
    feed_len[:, len(p["input_arcs"]):] = 0          # pad rows feed nothing
    ptr = (rng.random((B, n_in)) * (feed_len + 1)).astype(np.int32)
    active = (rng.random(B) < 0.75).astype(np.int32)
    return dict(feed_vals=feed_vals, feed_len=feed_len, full=full, val=val,
                ptr=ptr, out_last=i32(B, n_out),
                out_count=rng.integers(0, 100, (B, n_out)).astype(np.int32),
                active=active)


def random_prof(tables, B: int, rng) -> tuple:
    """Random counters (nf, si, so [B, N2]; ab [B, A2]; ahw 0/1 [B, A2])
    as int32 numpy arrays: what a profiled block carries in mid-run."""
    N2 = tables["opcode"].shape[0]
    A2 = tables["prod_node"].shape[0]
    cnt = lambda n: rng.integers(0, 1000, (B, n)).astype(np.int32)
    return (cnt(N2), cnt(N2), cnt(N2), cnt(A2),
            rng.integers(0, 2, (B, A2)).astype(np.int32))


def random_graph(seed: int, nodes: int | None = None, dtype=np.int32):
    """A random well-formed acyclic fabric over the whole opcode set
    (control operators included), reading environment streams, open
    producer outputs and const buses holding edge values of ``dtype``
    (:data:`EDGE_VALS_BY_DTYPE`); 6-13 nodes, or ``nodes``.  In float32
    the shift count of every SHL/SHR is a const bus of its own, from
    :data:`FLOAT_SHIFTS`."""
    from repro_torch.core.graph import ARITY, Graph, Op
    kind = np.dtype(dtype).name
    edges = EDGE_VALS_BY_DTYPE[kind]
    as_const = int if kind != "float32" else float
    rng = np.random.default_rng(5000 + seed)
    g = Graph(name=f"random{seed}")
    open_arcs: list[str] = []
    n = {"a": 0, "x": 0, "c": 0}

    def fresh(tag):
        n[tag] += 1
        return f"{tag}{n[tag]}"

    def src(first):
        r = rng.random()
        if first:
            return fresh("x")
        if open_arcs and r < 0.55:
            return open_arcs.pop(int(rng.integers(len(open_arcs))))
        if r < 0.75:
            return g.const(fresh("c"), as_const(rng.choice(edges)))
        return fresh("x")

    ops = list(Op)
    for i in range(nodes if nodes is not None
                   else int(rng.integers(6, 14))):
        op = ops[seed % len(ops)] if i == 0 else ops[rng.integers(len(ops))]
        n_in, n_out = ARITY[op]
        ins = [src(i == 0 and k == 0) for k in range(n_in)]
        if kind == "float32" and op in (Op.SHL, Op.SHR):
            ins[1] = g.const(fresh("c"), float(rng.choice(FLOAT_SHIFTS)))
        outs = [fresh("a") for _ in range(n_out)]
        g.add(op, ins, outs)
        open_arcs.extend(outs)
    if not open_arcs:
        g.add(Op.ADD, [fresh("x"), g.const(fresh("c"), 1)], ["z_out"])
    g.validate()
    return g


def tokens_equal(got, want) -> bool:
    """Tokens (scalars or arrays, numpy or JAX) equal bit for bit: the same
    shape, and integers equal as integers; floats of one dtype with the
    same bits, except that a NaN need only meet a NaN (its payload is not
    compared: numpy, XLA and the card make different NaNs)."""
    g, w = np.atleast_1d(np.asarray(got)), np.atleast_1d(np.asarray(want))
    if g.shape != w.shape:
        return False
    if "f" not in (g.dtype.kind, w.dtype.kind):
        return bool((g.astype(np.int64) == w.astype(np.int64)).all())
    if g.dtype != w.dtype:
        return False
    nan = np.isnan(w)
    if (np.isnan(g) != nan).any():
        return False
    u = np.dtype(f"u{w.dtype.itemsize}")
    return bool((g.view(u)[~nan] == w.view(u)[~nan]).all())


CHANNEL_ARRAYS = ("ch_busy", "ch_hw", "ch_pushes")


def assert_same_result(got, want, tag, dispatches: bool = True,
                       profile: bool = False,
                       channels: bool = True) -> None:
    """Every EngineResult field of ``got`` equals ``want``'s: cycles,
    fired, counts, the last value of every arc that drained a token, and
    (unless ``dispatches=False``, for oracles that launch nothing) the
    launch count; token values as :func:`tokens_equal`.  With
    ``profile=True`` also ``node_fires`` and the
    FabricProfile: its names, its five counter arrays, its cycles and
    (with ``dispatches``) its launch count, and (unless
    ``channels=False``, for a partitioned run held against a solo one)
    its channel counters: names, depth and the three arrays, present on
    both or on neither.  Works across the two packages' result types."""
    assert got.cycles == want.cycles, (tag, "cycles", got.cycles, want.cycles)
    assert got.fired == want.fired, (tag, "fired", got.fired, want.fired)
    assert dict(got.counts) == dict(want.counts), (tag, "counts",
                                                   got.counts, want.counts)
    assert set(got.outputs) == set(want.outputs), (tag, "outputs")
    for a, c in want.counts.items():
        if c:
            assert tokens_equal(got.outputs[a], want.outputs[a]), (
                tag, "outputs", a, got.outputs[a], want.outputs[a])
    if dispatches:
        assert got.dispatches == want.dispatches, \
            (tag, "dispatches", got.dispatches, want.dispatches)
    if profile:
        np.testing.assert_array_equal(got.node_fires, want.node_fires,
                                      err_msg=f"{tag} node_fires")
        gp, wp = got.profile, want.profile
        assert (gp.node_names, gp.arc_names) == (wp.node_names,
                                                 wp.arc_names), tag
        for k in PROFILE_ARRAYS:
            np.testing.assert_array_equal(getattr(gp, k), getattr(wp, k),
                                          err_msg=f"{tag} profile.{k}")
        assert gp.cycles == wp.cycles, (tag, "profile.cycles", gp.cycles,
                                        wp.cycles)
        if dispatches:
            assert gp.dispatches == wp.dispatches, (tag,
                                                    "profile.dispatches")
        if channels:
            ch = lambda p, k: getattr(p, k, None)   # noqa: E731
            assert (ch(gp, "ch_names"), ch(gp, "ch_depth")) == (
                ch(wp, "ch_names"), ch(wp, "ch_depth")), (tag, "channels")
            for k in CHANNEL_ARRAYS:
                g, w = ch(gp, k), ch(wp, k)
                assert (g is None) == (w is None), (tag, k)
                if w is not None:
                    np.testing.assert_array_equal(
                        g, w, err_msg=f"{tag} profile.{k}")


def check_channels(result, graph) -> int:
    """A partitioned run's channel counters keep their bounds
    (``FabricProfile.check``), and every channel pushed as many tokens as
    its producer node fired (BRANCH producers aside: they fire into one
    of two arcs).  Returns the channels checked."""
    from repro_torch.core.graph import Op
    p = result.profile
    p.check()
    assert p.ch_names, "the profile has no channels"
    prod = {a: ns[0] for a, ns in graph.producers().items()}
    for k, a in enumerate(p.ch_names):
        if graph.nodes[prod[a]].op != Op.BRANCH:
            assert p.ch_pushes[k] == result.node_fires[prod[a]], (
                "channel", a, int(p.ch_pushes[k]))
    return len(p.ch_names)


def edge_feeds(graph, dtype, k: int, rng) -> dict:
    """A k-token stream of ``dtype`` for every input arc of ``graph``:
    about half edge values (:data:`EDGE_VALS_BY_DTYPE`), the rest random
    over the dtype's range (floats: a spread of magnitudes)."""
    kind = np.dtype(dtype).name
    edges = EDGE_VALS_BY_DTYPE[kind]
    out = {}
    for a in graph.input_arcs():
        if kind == "float32":
            rnd = (rng.standard_normal(k)
                   * 10.0 ** rng.integers(-3, 6, k)).astype(np.float32)
        else:
            lo, hi = (-2 ** 31, 2 ** 31) if kind == "int32" else (0, 2 ** 32)
            rnd = rng.integers(lo, hi, k)
        out[a] = np.where(rng.random(k) < 0.5, rng.choice(edges, k),
                          rnd).astype(dtype)
    return out


def edge_ints(rng, shape):
    """int32 values, a third of them edge operands."""
    return np.where(rng.random(shape) < 0.3, rng.choice(EDGE_VALS, shape),
                    rng.integers(-2 ** 31, 2 ** 31, shape)).astype(np.int32)


def random_sched_slot_inputs(ctx, B: int, K: int, L: int, rng) -> dict:
    """Random mid-run inputs for the scheduled slot step over a schedule
    context ``ctx`` (:class:`~repro_torch.core.schedule.ScheduleContext`),
    as int32 numpy arrays: each active slot's pid window at a random
    position of a plan with random, mixed feed lengths (past quiescence
    too), about a quarter of the slots parked (pid 0, fsel -1), random
    registers, streams, pointers and accumulators.  Registers pattern
    the slot may not really reach still test the kernel's arithmetic: a
    scheduled cycle is defined on any registers."""
    n_in, n_out = ctx.ia_pad.size, ctx.oa_pad.size
    pids = np.zeros((B, K), np.int32)
    fsel = np.full((B,), -1, np.int32)
    for b in np.nonzero(rng.random(B) < 0.75)[0]:
        plan = ctx.plan_for(tuple(int(x) for x in
                                  rng.integers(1, L + 1, ctx.in_arc.size)))
        plan.ensure(4 * L + 64)
        pos = int(rng.integers(0, plan.total + K))
        plan.ensure(pos + K)
        pids[b] = plan.pids_window(pos, pos + K)
        fsel[b] = pids[b, -1]
    full = rng.integers(0, 2, (B, ctx.A2)).astype(np.int32)
    return dict(fv=edge_ints(rng, (B, n_in, L)), pids=pids, fsel=fsel,
                full=full, val=edge_ints(rng, (B, ctx.A2)),
                ptr=rng.integers(0, L + 2, (B, n_in)).astype(np.int32),
                out_last=edge_ints(rng, (B, n_out)),
                out_count=rng.integers(0, 100, (B, n_out)).astype(np.int32))


def slot_plans(ctx, L: int, rng, n: int = 8) -> list:
    """``n`` plans of ``ctx`` for random, mixed feed lengths in 1..L,
    extended past quiescence (for :func:`random_slot_window_inputs`)."""
    plans = []
    for _ in range(n):
        plan = ctx.plan_for(tuple(int(x) for x in
                                  rng.integers(1, L + 1, ctx.in_arc.size)))
        plan.ensure(4 * L + 64)
        plans.append(plan)
    return plans


def random_slot_window_inputs(ctx, plans, B: int, K: int, L: int, rng,
                              parked: float = 0.25) -> dict:
    """Random inputs for the scheduled slot step over ``ctx``, as int32
    numpy arrays, for many slots from a few plans: each slot rides one of
    ``plans`` (:func:`slot_plans`) with the pid window
    ``ConcretePlan.pids_window`` gives at a random position (past the
    plan's end too), or is parked (pid 0, fsel -1) with probability
    ``parked``; random registers, streams and accumulators; pointers at
    L - 1, at L, past L (the clamp) or random below L."""
    n_in, n_out = ctx.ia_pad.size, ctx.oa_pad.size
    pids = np.zeros((B, K), np.int32)
    fsel = np.full((B,), -1, np.int32)
    for b in np.nonzero(rng.random(B) >= parked)[0]:
        plan = plans[int(rng.integers(len(plans)))]
        pos = int(rng.integers(0, plan.total + K))
        plan.ensure(pos + K)
        pids[b] = plan.pids_window(pos, pos + K)
        fsel[b] = pids[b, -1]
    pick = rng.random((B, n_in))
    ptr = np.select([pick < 0.15, pick < 0.25, pick < 0.3],
                    [L - 1, L, L + 5], rng.integers(0, L, (B, n_in)))
    return dict(fv=edge_ints(rng, (B, n_in, L)), pids=pids, fsel=fsel,
                full=rng.integers(0, 2, (B, ctx.A2)).astype(np.int32),
                val=edge_ints(rng, (B, ctx.A2)), ptr=ptr.astype(np.int32),
                out_last=edge_ints(rng, (B, n_out)),
                out_count=rng.integers(0, 100, (B, n_out)).astype(np.int32))


def random_sched_run_inputs(ctx, B: int, L: int, rng, cap: int = 1 << 20):
    """Random inputs for the scheduled run over ``ctx``: B streams
    (int32 numpy [B, n_in, L], a third edge operands) sharing one tuple
    of random, mixed feed lengths, and that tuple's plan, extended to
    quiescence or ``cap``."""
    plan = ctx.plan_for(tuple(int(x) for x in
                              rng.integers(1, L + 1, ctx.in_arc.size)))
    plan.ensure(cap)
    return edge_ints(rng, (B, ctx.ia_pad.size, L)), plan


def every_cycle_sched(n_in: int, L: int, cycles: int) -> tuple:
    """Host schedule tables and a program in which feed rows advance as
    fast as a schedule allows, one token a cycle (a fabric's handshake
    gives at most one every two), and every token fed shows in the
    result: row r feeds arc r, an ADD adds it into arc n_in + r, and the
    drain row reads that sum.  Pattern 1 runs every row, pattern 2 the
    even rows only; the program runs pattern 1 for L - 1 cycles, then 2
    and 1 in turn up to ``cycles`` (past L: the clamp is read).  Returns
    (host tables, program) for ``schedule_fire.upload_sched_tables`` and
    the run kernels: out_last is each row's sum of its tokens (int32,
    wrapping), out_count the tokens it took."""
    from repro_torch.core.graph import Op
    A2 = 2 * n_in + 2
    P, F = 4, n_in
    z = lambda *shape: np.zeros(shape, np.int32)
    host = dict(op=z(P, F), i0=z(P, F), i1=z(P, F),
                o0=np.full((P, F), A2, np.int32),
                o1=np.full((P, F), A2, np.int32), feed=z(P, n_in),
                drain=z(P, n_in), full=z(P, A2), nfire=z(P),
                ia=np.arange(n_in, dtype=np.int32),
                oa=np.arange(n_in, 2 * n_in, dtype=np.int32), val0=z(A2))
    for pid, rows in ((1, np.arange(n_in)), (2, np.arange(0, n_in, 2))):
        k = rows.size
        host["feed"][pid, rows] = host["drain"][pid, rows] = 1
        host["nfire"][pid] = k
        host["op"][pid, :k] = int(Op.ADD)
        host["i0"][pid, :k] = n_in + rows
        host["i1"][pid, :k] = rows
        host["o0"][pid, :k] = n_in + rows
    head = max(L - 1, 0)
    tail = max(cycles - head, 0)
    program = dict(seg_off=np.array([0, 1], np.int32),
                   seg_len=np.array([1, 2], np.int32),
                   seg_reps=np.array([head, tail // 2], np.int32),
                   pids=np.array([1, 2, 1], np.int32))
    return host, program
