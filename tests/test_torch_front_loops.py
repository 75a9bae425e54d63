"""The port's loop frontend held against the JAX package's, case for case
with tests/test_front_loops.py: ``front.while_loop`` / ``front.fori_loop``
(torch) and ``lax.while_loop`` / ``lax.fori_loop`` (JAX) must lower to
the same cyclic fabric — equal per-opcode node counts and asm text —
that gives equal ``outputs``/``counts``/``cycles``/``fired`` under each
package's ``run_reference``.  gcd's JAX side is written with
``lax.select`` (ROADMAP C3).  The port's executors then run the fabrics
on ``device="cpu"`` (the kernels' plain versions, nothing built).
"""
import collections
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import asm as jasm  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
from repro.core.engine import run_reference as jrun_reference  # noqa: E402
from repro.front import trace as jtrace  # noqa: E402
from repro_torch.core import asm, library, passes  # noqa: E402
from repro_torch.core.compile import (GraphTraits, compile,  # noqa: E402
                                      compile_fn)
from repro_torch.core.engine import (DataflowEngine,  # noqa: E402
                                     run_reference)
from repro_torch.front import (LoweringError, fori_loop, trace,  # noqa: E402
                               while_loop)
from repro_torch.front.tracer import _capture  # noqa: E402
from repro_torch.testing import assert_same_result  # noqa: E402

I32 = np.int32
T32 = torch.int32


def op_counts(graph) -> dict:
    return dict(collections.Counter(n.op.name for n in graph.nodes))


def same_fabric(tprog, jprog, tag) -> None:
    assert op_counts(tprog) == op_counts(jprog), tag
    assert asm.emit(tprog) == jasm.emit(jprog), tag
    assert tprog.has_loops == jprog.has_loops, tag


def same_runs(tprog, jprog, args, tag, dtype=np.int32):
    want = jrun_reference(jprog, jprog.make_feeds(*args), dtype=dtype)
    got = run_reference(tprog, tprog.make_feeds(*args), dtype=dtype)
    assert_same_result(got, want, tag, dispatches=False)
    return got


def t32(v):
    return torch.tensor(v, dtype=T32)


def _gcd_fn():
    def gcd(a, b):
        def body(c):
            x, y = c
            return (torch.where(x > y, x - y, x),
                    torch.where(x > y, y, y - x))
        return while_loop(lambda c: c[0] != c[1], body, (a, b))[0]
    return gcd


def _jgcd_fn():
    def gcd(a, b):
        def body(c):
            x, y = c
            return (lax.select(x > y, x - y, x),
                    lax.select(x > y, y, y - x))
        return lax.while_loop(lambda c: c[0] != c[1], body, (a, b))[0]
    return gcd


# ---------------------------------------------------------------------------
# acceptance: gcd through the single compile() entry point
# ---------------------------------------------------------------------------
def test_gcd_bit_identical_across_executors_and_jax():
    gcd = _gcd_fn()
    prog = trace(gcd, I32, I32, name="gcd")
    jprog = jtrace(_jgcd_fn(), I32, I32, name="gcd")
    assert prog.has_loops and prog.is_cyclic()
    same_fabric(prog, jprog, "gcd")
    cases = [(12, 18), (7, 7), (100, 64), (81, 27), (1, 99), (360, 84)]
    for a, b in cases:
        feeds = prog.make_feeds([a], [b])
        want = same_runs(prog, jprog, ([a], [b]), (a, b))
        # one initiation -> exactly one result token, equal to python AND
        # eager torch execution of the same function
        assert want.counts[prog.out_arc] == 1
        got = np.asarray(want.outputs[prog.out_arc]).item()
        assert got == math.gcd(a, b) == int(gcd(t32(a), t32(b)))
        for backend in ("reference", "torch", "cuda"):
            for K in (1, 16):
                run = compile(prog, backend=backend, block_cycles=K,
                              device="cpu")
                assert_same_result(run(feeds), want, (a, b, backend, K),
                                   dispatches=False)
        run = compile(prog, backend="unrolled", device="cpu")
        assert_same_result(run(feeds), want, (a, b, "unrolled"),
                           dispatches=False)


def test_loop_region_passes_win_without_changing_observables():
    """Region-scoped legality: >= 1 fold on a loop-bearing graph,
    outputs and token counts untouched, the same rewrite as JAX's."""
    def f(a, n, k):
        return fori_loop(0, n, lambda i, c: c + k, a + k * 2)

    def jf(a, n, k):
        return lax.fori_loop(0, n, lambda i, c: c + k, a + k * 2)

    prog = trace(f, I32, I32, I32, const_args={2: 5}, name="loopfold")
    jprog = jtrace(jf, I32, I32, I32, const_args={2: 5}, name="loopfold")
    same_fabric(prog, jprog, "loopfold")
    opt, report = passes.optimize_graph(prog)
    jopt, jreport = jpasses.optimize_graph(jprog)
    assert report.folded >= 1, report.summary()
    assert report.summary() == jreport.summary()
    assert asm.emit(opt) == jasm.emit(jopt)
    for a, n in [(3, 4), (0, 0), (7, 2)]:
        feeds = prog.make_feeds([a], [n])
        want = same_runs(prog, jprog, ([a], [n]), (a, n))
        assert np.asarray(want.outputs[prog.out_arc]).item() == \
            int(f(t32(a), t32(n), t32(5)))
        got = run_reference(opt, feeds)
        assert got.counts == want.counts, (a, n)
        eng = DataflowEngine(opt, backend="torch", block_cycles=4,
                             optimize=True, device="cpu")
        got = eng.run(feeds)
        assert got.counts == want.counts
        assert np.asarray(got.outputs[prog.out_arc]).item() == \
            np.asarray(want.outputs[prog.out_arc]).item()


def test_gcd_serves_with_exact_token_metrics():
    """End to end through DataflowServer.for_fn: one request per
    evaluation, data-dependent residency, exact tokens — and every
    result as the JAX server's for_fn gives it."""
    from repro.serve.dataflow_server import DataflowServer as JServer
    from repro_torch.serve.dataflow_server import DataflowServer
    srv = DataflowServer.for_fn(_gcd_fn(), I32, I32, name="gcd", slots=3,
                                block_cycles=8, device="cpu")
    jsrv = JServer.for_fn(_jgcd_fn(), I32, I32, name="gcd", slots=3,
                          block_cycles=8, backend="xla")
    cases = [(12, 18), (100, 64), (7, 7), (81, 27), (360, 84), (13, 9)]
    uids = [srv.submit_args(a, b) for a, b in cases]
    assert uids == [jsrv.submit_args(a, b) for a, b in cases]
    res = {r.uid: r for r in srv.drain()}
    jres = {r.uid: r for r in jsrv.drain()}
    assert srv.block == jsrv.block
    for uid, (a, b) in zip(uids, cases):
        r = res[uid]
        assert np.asarray(
            r.engine.outputs[srv.traced.out_arc]).item() == math.gcd(a, b)
        assert r.metrics.tokens_out == 1
        assert not r.metrics.truncated
        assert_same_result(r.engine, jres[uid].engine, (a, b),
                           dispatches=False)
        for f in ("slot", "queued_block", "admitted_block",
                  "finished_block", "queue_wait_blocks", "residency_blocks",
                  "residency_cycles", "tokens_out", "truncated"):
            assert getattr(r.metrics, f) == getattr(jres[uid].metrics, f), f
        # bit-identical to a solo engine run, whatever rode alongside
        solo = srv.engine.run(srv.make_feeds(a, b))
        assert_same_result(r.engine, solo, (a, b), dispatches=False)


def test_divergent_loop_is_truncated_not_wedged():
    """A loop whose predicate never goes false hits the max_cycles cap:
    the slot is force-harvested with metrics.truncated set, and
    co-resident healthy requests are unaffected."""
    from repro_torch.serve.dataflow_server import DataflowServer

    def diverge(a):
        return while_loop(lambda c: c > 0, lambda c: c + 1, a)

    srv = DataflowServer.for_fn(diverge, I32, slots=2, block_cycles=8,
                                device="cpu", max_cycles=64)
    u_bad = srv.submit_args(1)      # diverges
    u_ok = srv.submit_args(0)       # zero-trip, quiesces immediately
    res = {r.uid: r for r in srv.drain()}
    assert res[u_bad].metrics.truncated
    assert not res[u_ok].metrics.truncated
    assert np.asarray(
        res[u_ok].engine.outputs[srv.traced.out_arc]).item() == 0
    assert srv.pending == 0 and not bool(srv.state.active.any())


# ---------------------------------------------------------------------------
# schema coverage: fori / scan / invariants / nesting / edge cases
# ---------------------------------------------------------------------------
def test_fori_loop_traced_bound_synthetic_carry():
    """fori with a traced bound takes JAX's while form: (i, n, c)."""
    def fib(n):
        return fori_loop(0, n, lambda i, c: (c[1], c[0] + c[1]),
                         (t32(0), t32(1)))[0]

    def jfib(n):
        return lax.fori_loop(0, n, lambda i, c: (c[1], c[0] + c[1]),
                             (jnp.int32(0), jnp.int32(1)))[0]

    prog = trace(fib, I32, name="fib")
    same_fabric(prog, jtrace(jfib, I32, name="fib"), "fib")
    assert prog.has_loops and prog.inits   # compile-time carry inits
    for n in range(10):
        r = run_reference(prog, prog.make_feeds([n]))
        assert np.asarray(r.outputs[prog.out_arc]).item() == \
            int(fib(t32(n))), n


def test_static_fori_is_carry_only_scan():
    """Static bounds make a counted loop: the scan schema's synthetic
    counter + IFLT trip decider; the x carry, a pure pass-through, moves
    into the invariants as JAX's scan moves it."""
    def horner_loop(x):
        return fori_loop(0, 6, lambda i, c: (c[0] * c[1] + 1, c[1]),
                         (t32(1), x))[0]

    def jhorner_loop(x):
        return lax.fori_loop(0, 6, lambda i, c: (c[0] * c[1] + 1, c[1]),
                             (jnp.int32(1), x))[0]

    prog = trace(horner_loop, I32, name="hl")
    jprog = jtrace(jhorner_loop, I32, name="hl")
    same_fabric(prog, jprog, "hl")
    assert prog.has_loops and len(prog.inits) >= 1
    assert sum(n.op.name == "IFLT" for n in prog.nodes) == 1
    for x in (-3, 0, 1, 2, 4):
        r = same_runs(prog, jprog, ([x],), x)
        assert np.asarray(r.outputs[prog.out_arc]).item() == \
            int(horner_loop(t32(x))), x


def test_zero_trip_loops_exit_with_init_values():
    prog = trace(lambda a: fori_loop(0, 0, lambda i, c: c + 1, a), I32,
                 name="zero_trip")
    jprog = jtrace(lambda a: lax.fori_loop(0, 0, lambda i, c: c + 1, a),
                   I32, name="zero_trip")
    same_fabric(prog, jprog, "zero_trip")
    r = same_runs(prog, jprog, ([41],), "zero_trip")
    assert r.counts[prog.out_arc] == 1
    assert np.asarray(r.outputs[prog.out_arc]).item() == 41

    prog2 = trace(lambda a: while_loop(lambda c: c < 0, lambda c: c - 1,
                                       a), I32, name="zero_trip_while")
    jprog2 = jtrace(lambda a: lax.while_loop(lambda c: c < 0,
                                             lambda c: c - 1, a),
                    I32, name="zero_trip_while")
    same_fabric(prog2, jprog2, "zero_trip_while")
    r2 = same_runs(prog2, jprog2, ([5],), "zero_trip_while")
    assert np.asarray(r2.outputs[prog2.out_arc]).item() == 5


def test_nested_loops():
    def f(n):
        def outer(i, acc):
            return fori_loop(0, 3, lambda j, s: s + i + 1, acc)
        return fori_loop(0, n, outer, t32(0))

    def jf(n):
        def outer(i, acc):
            return lax.fori_loop(0, 3, lambda j, s: s + i + 1, acc)
        return lax.fori_loop(0, n, outer, jnp.int32(0))

    prog = trace(f, I32, name="nested")
    jprog = jtrace(jf, I32, name="nested")
    same_fabric(prog, jprog, "nested")
    for n in (0, 1, 2, 4):
        r = same_runs(prog, jprog, ([n],), n)
        assert np.asarray(r.outputs[prog.out_arc]).item() == \
            int(f(t32(n))), n


def test_literal_next_state_is_materialized_per_iteration():
    """A body returning a literal gets a DMERGE materializer gated on a
    streamy back value — the const bus must NOT free-run into the entry
    merge (that would re-initiate the loop after exit)."""
    def f(a):
        return while_loop(lambda c: c[0] != 0, lambda c: (0, c[1] + 1),
                          (a, t32(0)))[1]

    def jf(a):
        return lax.while_loop(lambda c: c[0] != 0,
                              lambda c: (jnp.int32(0), c[1] + 1),
                              (a, jnp.int32(0)))[1]

    prog = trace(f, I32, name="reset_count")
    jprog = jtrace(jf, I32, name="reset_count")
    same_fabric(prog, jprog, "reset_count")
    for a in (0, 1, 5):
        feeds = prog.make_feeds([a])
        r = same_runs(prog, jprog, ([a],), a)
        assert r.counts[prog.out_arc] == 1      # no re-initiation
        assert np.asarray(r.outputs[prog.out_arc]).item() == \
            int(f(t32(a))), a
        assert r.cycles < 100_000               # quiesces
        eng = DataflowEngine(prog, backend="cuda", block_cycles=4,
                             device="cpu")
        assert_same_result(eng.run(feeds), r, a, dispatches=False)


def test_all_const_next_state_uses_predicate_gate():
    """A loop whose EVERY next-state value is a literal is still
    data-dependent (the zero-trip path returns the inits), so it must
    lower — the const-token materializer gates off the predicate when
    no streamy back value exists."""
    def f(x, y):
        return while_loop(lambda c: c[0] == c[1], lambda c: (1, 2),
                          (x, y))[0]

    def jf(x, y):
        return lax.while_loop(lambda c: c[0] == c[1],
                              lambda c: (jnp.int32(1), jnp.int32(2)),
                              (x, y))[0]

    prog = trace(f, I32, I32, name="const_state")
    jprog = jtrace(jf, I32, I32, name="const_state")
    same_fabric(prog, jprog, "const_state")
    for x, y in [(5, 9), (5, 5), (1, 2), (2, 2)]:
        feeds = prog.make_feeds([x], [y])
        r = same_runs(prog, jprog, ([x], [y]), (x, y))
        assert r.counts[prog.out_arc] == 1, (x, y, r.counts)
        assert np.asarray(r.outputs[prog.out_arc]).item() == \
            int(f(t32(x), t32(y))), (x, y)
        eng = DataflowEngine(prog, backend="cuda", block_cycles=4,
                             device="cpu")
        assert_same_result(eng.run(feeds), r, (x, y), dispatches=False)


def test_const_args_invariants_ride_sticky_buses():
    """A const-bound loop invariant is a sticky const bus inside the
    cones — no synthetic carry, and the folder sees const-fed nodes."""
    def f(a, k):
        return fori_loop(0, 4, lambda i, c: c * k + 1, a)

    def jf(a, k):
        return lax.fori_loop(0, 4, lambda i, c: c * k + 1, a)

    prog = trace(f, I32, I32, const_args={1: 3}, name="inv_const")
    jprog = jtrace(jf, I32, I32, const_args={1: 3}, name="inv_const")
    same_fabric(prog, jprog, "inv_const")
    for a in (0, 1, 5):
        r = same_runs(prog, jprog, ([a],), a)
        assert np.asarray(r.outputs[prog.out_arc]).item() == \
            int(f(t32(a), t32(3))), a


def test_float_while_loop_matches_jax_bitwise():
    def newton(n):
        return fori_loop(0, 8, lambda i, x: 0.5 * (x + n / x),
                         n * 0.5 + 0.5)

    def jnewton(n):
        return lax.fori_loop(0, 8, lambda i, x: 0.5 * (x + n / x),
                             n * 0.5 + 0.5)

    prog = trace(newton, np.float32, name="newton")
    jprog = jtrace(jnewton, np.float32, name="newton")
    same_fabric(prog, jprog, "newton")
    for v in (2.0, 9.0, 81.0, 0.25):
        r = same_runs(prog, jprog, ([v],), v, dtype=np.float32)
        got = np.float32(np.asarray(r.outputs[prog.out_arc]))
        want = np.float32(jnewton(jnp.float32(v)))
        assert got.tobytes() == want.tobytes(), (v, got, want)
        assert got.tobytes() == \
            np.float32(newton(torch.tensor(v)).item()).tobytes()
        eng = DataflowEngine(prog, backend="torch", block_cycles=8,
                             device="cpu", dtype=np.float32)
        r2 = eng.run(prog.make_feeds([v]))
        assert np.float32(np.asarray(
            r2.outputs[prog.out_arc])).tobytes() == want.tobytes()


def test_loop_fabric_round_trips_through_asm():
    """Initial-token annotations survive emit -> parse -> emit (the
    serving signature cache hashes the emission)."""
    prog = trace(_gcd_fn(), I32, I32, name="gcd")
    hl = trace(lambda x: fori_loop(
        0, 5, lambda i, c: (c[0] + c[1], c[1]), (t32(0), x))[0],
        I32, name="hl")
    assert hl.inits            # scan counter + carry initial tokens
    for g in (prog, hl):
        text = asm.emit(g)
        g2 = asm.parse(text, name=g.name)
        assert asm.emit(g2) == text
        assert {a: float(v) for a, v in g2.inits.items()} == \
               {a: float(v) for a, v in g.inits.items()}
        feeds = {a: [7] for a in g.input_arcs()}
        assert_same_result(run_reference(g2, feeds), run_reference(g, feeds),
                           g.name, dispatches=False)


def test_single_initiation_feed_contract():
    prog = trace(_gcd_fn(), I32, I32, name="gcd")
    with pytest.raises(ValueError, match="initiate once"):
        prog.make_feeds([1, 2], [3, 4])
    feeds = prog.make_feeds(6, 4)
    assert all(len(v) == 1 for v in feeds.values())


# ---------------------------------------------------------------------------
# the GraphTraits probe + unified compile() routing
# ---------------------------------------------------------------------------
def test_traits_probe_classifies_fabrics():
    dag = library.vector_sum_graph(8).graph
    t = GraphTraits.probe(dag)
    assert t.tokens_out_static and not t.cyclic and not t.control_ops
    loop = trace(_gcd_fn(), I32, I32, name="gcd")
    t2 = GraphTraits.probe(loop)
    assert t2.cyclic and "NDMERGE" in t2.control_ops
    assert not t2.tokens_out_static
    fib_init = trace(lambda x: fori_loop(
        0, 3, lambda i, c: c + x * 0 + 1, x), I32, name="f")
    assert GraphTraits.probe(fib_init).has_inits


def test_dag_executor_refuses_token_presence_graphs_naming_trait():
    prog = trace(_gcd_fn(), I32, I32, name="gcd")
    with pytest.raises(ValueError, match="cyclic=True"):
        compile(prog, backend="dag", device="cpu")
    with pytest.raises(ValueError, match="control_ops"):
        compile(prog, backend="dag", device="cpu")
    sel = trace(lambda x, y: torch.where(x > y, x - y, y - x), I32, I32)
    with pytest.raises(ValueError, match="control_ops=.*DMERGE"):
        compile(sel, backend="dag", device="cpu")
    with pytest.raises(ValueError, match="cyclic=True"):
        compile_fn(_gcd_fn(), I32, I32, backend="dag", device="cpu")
    with pytest.raises(ValueError, match="backend 'bogus' not in"):
        compile(prog, backend="bogus", device="cpu")
    # auto + the engine default route loop fabrics correctly
    for backend in ("auto", "cuda"):
        run = compile_fn(_gcd_fn(), I32, I32, backend=backend, device="cpu")
        r = run(run.make_feeds([21], [14]))
        assert np.asarray(r.outputs[run.out_arcs[0]]).item() == 7
        assert run.traits.cyclic
    with pytest.raises(ValueError, match='backend="torch"'):
        compile_fn(lambda x: x * 0.5, np.float32, device="cpu")


# ---------------------------------------------------------------------------
# torch's capture: aliasing, stray closures, and the rejected programs
# ---------------------------------------------------------------------------
def test_pass_through_carry_needs_no_clone():
    """torch's own while_loop refuses a body that returns a carry
    unchanged; the trace names the fix, and front.while_loop applies it
    (the clone is an alias: the fabric is JAX's)."""
    from torch._higher_order_ops.while_loop import while_loop as raw

    def raw_fn(x):
        return raw(lambda i, a, b: i != 3,
                   lambda i, a, b: (i + 1, b, a + b),
                   (t32(0), t32(0), x))[1]

    with pytest.raises(LoweringError, match="front.while_loop"):
        trace(raw_fn, I32)

    def fn(x):
        return while_loop(lambda c: c[0] != 3,
                          lambda c: (c[0] + 1, c[2], c[1] + c[2]),
                          (t32(0), t32(0), x))[1]

    def jfn(x):
        return lax.while_loop(lambda c: c[0] != 3,
                              lambda c: (c[0] + 1, c[2], c[1] + c[2]),
                              (jnp.int32(0), jnp.int32(0), x))[1]

    prog = trace(fn, I32)
    same_fabric(prog, jtrace(jfn, I32), "pass-through")
    gm = _capture(fn, [np.dtype(I32)])
    body = next(m for k, m in gm.named_children() if "body" in k)
    assert any(n.target == torch.ops.aten.clone.default
               for n in body.graph.nodes)


def _lower(gm, name="p"):
    from repro_torch.front.lowering import _Ctx, lower_graph
    from repro_torch.front.tracer import TracedProgram
    prog = TracedProgram(name=name)
    ctx = _Ctx(prog, I32)
    lower_graph(ctx, gm, None)
    return prog


def test_stray_additional_inputs_are_dropped():
    """The capture can hand a loop Python ints that no graph reads (one
    torch 2.13 capture gave ``(3, 4, 3, 6, 3, 4, 3, 6)``, each a
    placeholder of both graphs with no user; whether they come depends
    on the capture's caches, so they are appended here).  They get no const bus and
    no arc: the same capture with such strays appended lowers to the
    same fabric, JAX's."""
    bench = library.horner_loop_graph()
    fn, avals, _ = bench.program
    gm = _capture(fn, [np.dtype(a) for a in avals])
    want = asm.emit(_lower(gm))
    (loop,) = [n for n in gm.graph.nodes if n.op == "call_function"
               and "while_loop" in str(n.target)]
    strays = (3, 4, 3, 6, 3, 4, 3, 6)
    cond, body, carries, extra = loop.args
    loop.args = (cond, body, carries, tuple(extra) + strays)
    for ref in (cond, body):
        sub = getattr(gm, ref.target).graph
        last = [n for n in sub.nodes if n.op == "placeholder"][-1]
        for k in range(len(strays)):
            with sub.inserting_after(last):
                last = sub.placeholder(f"stray{k}")
    got = _lower(gm)
    assert asm.emit(got) == want
    # the counter's start, the increment and the trip count: no stray
    assert set(got.consts.values()) == {0, 1, 8}
    assert asm.emit(bench.graph) == jasm.emit(jtrace(
        lambda x: lax.fori_loop(0, 8, lambda i, c: (c[0] * c[1] + 1, c[1]),
                                (jnp.int32(1), x))[0], I32,
        name=bench.graph.name))


def test_counted_while_takes_the_scan_schema():
    """Capture keeps no trace of fori_loop: a while_loop of the counted
    form (carry 0 from an int literal, ``lt(i, literal)``, ``i + 1``) IS
    a counted loop to the lowering, so it builds JAX's *fori_loop*
    fabric, where lax.while_loop of the same code builds the while
    schema: the same results in other cycles (ROADMAP Queue C 9)."""
    def fn(x):
        return while_loop(lambda c: c[0] < 4,
                          lambda c: (c[0] + 1, c[1] * 2 + c[0]),
                          (t32(0), x))[1]

    def jfori(x):
        return lax.fori_loop(0, 4, lambda i, a: a * 2 + i, x)

    def jwhile(x):
        return lax.while_loop(lambda c: c[0] < 4,
                              lambda c: (c[0] + 1, c[1] * 2 + c[0]),
                              (jnp.int32(0), x))[1]

    prog = trace(fn, I32, name="counted")
    same_fabric(prog, jtrace(jfori, I32, name="counted"), "counted")
    jw = jtrace(jwhile, I32, name="counted")
    assert op_counts(prog) != op_counts(jw)
    for x in (-3, 0, 5):
        got = run_reference(prog, prog.make_feeds([x]))
        want = jrun_reference(jw, jw.make_feeds([x]))
        assert got.counts[prog.out_arc] == want.counts[jw.out_arc] == 1
        assert np.asarray(got.outputs[prog.out_arc]).item() == \
            np.asarray(want.outputs[jw.out_arc]).item() == \
            int(fn(t32(x)))
        assert got.cycles != want.cycles


def test_loop_lowering_errors_name_the_problem():
    # non-scalar loop state (the zeros feeding it already cannot ride a
    # scalar-token arc)
    with pytest.raises(LoweringError, match="shape"):
        trace(lambda x: while_loop(
            lambda c: c.sum() < 5, lambda c: c + 1,
            torch.zeros(3, dtype=T32) + x)[0], I32)
    with pytest.raises(LoweringError, match="predicate"):
        trace(lambda x: while_loop(lambda c: False, lambda c: c + 1, x),
              I32)
    with pytest.raises(LoweringError, match="3 values for 2 carries"):
        trace(lambda x: while_loop(lambda c: c[0] < 3,
                                   lambda c: (c[0], c[1], c[1]),
                                   (x, x)), I32)
